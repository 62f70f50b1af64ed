"""Device meshes (mesh.py) and capacity planning (plan.py)."""
