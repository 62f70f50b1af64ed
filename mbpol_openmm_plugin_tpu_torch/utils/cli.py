"""What the port's command-line entry points (examples/, tools/) share: the
device argument and the test fixtures they start from."""
from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')
# the water256 fixture's cubic box edge (nm)
BOX256 = 19.3996888399961804 / 10.0


def load_fixture(name):
    """The arrays of tests/fixtures/<name>.npz as a dict."""
    with np.load(os.path.join(FIXTURES, name + '.npz')) as z:
        return {k: np.array(z[k]) for k in z.files}


def water256_positions():
    """The water256 fixture's positions [1024, 3] (nm, float64)."""
    return load_fixture('water256_integration_test')['positions']


def device(name=None):
    """The torch device of an entry point: the card unless `name` says
    otherwise. A card that is not there raises; there is no fallback."""
    import torch
    dev = torch.device('cuda' if name is None else name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass --device cpu (device="cpu") to '
                           'run on the CPU')
    return dev


def add_device_argument(ap):
    ap.add_argument('--device', default='cuda',
                    help="torch device (default the card; 'cpu' runs float64 on the CPU)")


def to_numpy(x):
    """A tensor (any device) or array as a float64 numpy array."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
