"""Capacity planning (plan.py); meshes are not ported yet (ROADMAP.md)."""
