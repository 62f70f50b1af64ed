"""Share (%) of the site pairs that the block-sparse direct space's active
tile pairs cover which lie inside the cutoff, at the profiled chunk's final
state: the in-cutoff pairs there (ctx['work']['n_in']) over the pairs that
the active tile pairs of the health check's converged evaluation of that
state cover (the program's counters elec_tile_pairs / elec_tile_reads,
read as harness/program_trace.py reads the others). None without those
counters, as a program that does not count them has none. Moves
nve_ns_per_day.dense.

Both are counted the same way, as unordered site pairs without self
pairs: the list holds (I, J) and (J, I) of two tiles and (I, I) once, so
a diagonal tile pair covers 256 x 255 / 2 pairs and two off-diagonal
entries cover 256 x 256. The diagonal entries are the row tiles (a tile
always comes within the cutoff of itself); a last tile partly of padding
is counted whole.
"""
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import _counters  # noqa: E402

TILE = 256


def covered_pairs(tile_pairs, n_sites):
    """Unordered site pairs covered by `tile_pairs` active entries of the
    symmetric list over n_sites sites."""
    n_tiles = math.ceil(n_sites / TILE)
    return n_tiles * TILE * (TILE - 1) / 2 + (tile_pairs - n_tiles) / 2 * TILE * TILE


def read(ctx):
    c, w = _counters(ctx), ctx.get('work')
    if c is None or not w or not c.get('elec_tile_reads'):
        return None
    tile_pairs = c['elec_tile_pairs'] / c['elec_tile_reads']
    return 100.0 * w['n_in'] / covered_pairs(tile_pairs, w['n_sites'])
