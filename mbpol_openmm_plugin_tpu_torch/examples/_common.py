"""Pieces the example applications share: the bulk examples' water256
potential, the fixture's replication, the example PDBs and the report edges'
probe (the device argument and the fixtures are utils/cli.py's)."""
from __future__ import annotations

import os

import numpy as np

from mbpol_openmm_plugin_tpu_torch.utils import cli

HERE = os.path.dirname(os.path.abspath(__file__))
# the fixture's copies along x, y, z for each replicated size
REPLICAS = {256: (1, 1, 1), 512: (2, 1, 1), 1024: (2, 2, 1), 2048: (2, 2, 2),
            4096: (2, 2, 4), 6912: (3, 3, 3), 8192: (2, 4, 4), 16384: (4, 4, 4),
            32768: (4, 4, 8)}
# the example PDBs and the fixtures they are written from
PDBS = ('water14_cluster', 'water256_bulk', 'water3')
# the spectral bands the IR and VDOS readings report (cm^-1)
BANDS = ((10, 1200, 'libration'), (1200, 2200, 'HOH bend'), (2800, 4400, 'OH stretch'))
# the bulk examples' MBPolConfig: PME 0.9 nm, SCF eps 1e-3, list skin 0.02 nm
CONFIG = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-3, max_iterations=200,
              nlist_skin=0.02)


def config(**fields):
    """The bulk examples' MBPolConfig with `fields` replaced."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPolConfig
    return MBPolConfig(**{**CONFIG, **fields})


def water_potential(device='cuda', isotope='H2O', positions=None, box=None, mbpol_config=None):
    """(system, MBPol after tune_capacities, positions with their virtual
    sites, box) of the waters at `positions` (numpy [4 n, 3], default the
    water256 fixture's) in `box` (default the fixture's) under
    `mbpol_config` (default `config()`)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
    box = [cli.BOX256] * 3 if box is None else list(box)
    positions = cli.water256_positions() if positions is None else positions
    sys_ = System.waters(len(positions) // 4, box=box, isotope=isotope)
    pot = MBPol(sys_, mbpol_config or config(), device=cli.device(device))
    pos = compute_virtual_sites(sys_, pot.as_positions(positions))
    pot.tune_capacities(pos)
    return sys_, pot, pos, box


def replicate(positions, box_edge, reps):
    """(positions copied reps = (nx, ny, nz) times along the axes of a cubic
    box of edge box_edge, the enlarged box [3]), copy (i, j, k) shifted by
    (i, j, k) x box_edge, in the order examples/water2048_scaling.py builds
    them."""
    b = float(box_edge)
    pos = np.concatenate([np.asarray(positions) + np.array([i * b, j * b, k * b])
                          for i in range(reps[0]) for j in range(reps[1])
                          for k in range(reps[2])])
    return pos, [reps[0] * b, reps[1] * b, reps[2] * b]


def replicated(n_waters):
    """(positions [4 n_waters, 3], box [3]) of the water256 fixture copied
    REPLICAS[n_waters] times."""
    return replicate(cli.water256_positions(), cli.BOX256, REPLICAS[n_waters])


def platform(dev):
    """The app layer's platform of a torch device: 'CPU' on the CPU, else
    None (the card)."""
    return 'CPU' if dev.type == 'cpu' else None


def write_pdb(fixture, path):
    """Write tests/fixtures/<fixture>.npz as a PDB (examples/make_inputs.py's
    writer)."""
    from mbpol_openmm_plugin_tpu_torch.app.pdbfile import Atom, Topology, write_pdb_frame
    d = cli.load_fixture(fixture)
    atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
             enumerate(zip(d['names'], d['resnames'], d['resids']))]
    with open(path, 'w') as fh:
        write_pdb_frame(fh, Topology(atoms), d['positions'])
    return path


def pdb_path(name, directory=None):
    """The path of the example PDB `name` in `directory` (default this
    package's directory), written from its fixture if it is not there."""
    path = os.path.join(HERE if directory is None else directory, name + '.pdb')
    if not os.path.exists(path):
        write_pdb(name, path)
    return path


def edge_share(sim, n_steps, wall):
    """(steps/s of n_steps of `sim` as one chunk without the health check,
    the share of `wall` (the same number of steps in short calls, each with
    its converged evaluations at the edges) that the edges take). `sim`'s
    graph captures so far were made in `wall` (its first call captures) and
    are taken out of it, as any the chunk makes are out of its time."""
    import time
    cap0 = sum(sim.capture_ms) / 1e3
    t0 = time.perf_counter()
    sim.step(n_steps, check_health=False)
    one = time.perf_counter() - t0 - (sum(sim.capture_ms) / 1e3 - cap0)
    return n_steps / one, max(0.0, 1.0 - one / (wall - cap0))


def example_mesh(n_shards, dev):
    """A parallel.mesh.Mesh of n_shards for the examples' --mesh: over
    n_shards distinct cards when that many are visible, else n_shards shards
    of the one device `dev` (repeats: each shard runs on `dev`)."""
    import torch

    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    if dev.type == 'cuda' and n_shards > 1 and torch.cuda.device_count() >= n_shards:
        return M.make_mesh(n_shards)
    return M.make_mesh(devices=[dev] * int(n_shards))


def sync(device):
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
