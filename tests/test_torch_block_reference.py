"""The port in the water4096 benchmark cell's modes against the benchmark's
plain reference (port_bench/reference: own tables, monomial PIPs, PME with
its own lists, explicit electrostatic forces) on the CPU in float64, on
upstream's water256 box jiggled by a seeded generator: MBPol built as
configs/water4096_bulk.json says (block-sparse PME direct space, water-pair
dispersion, tune_capacities, the triplet slots per centre left open); each
term within 1e-6 kJ/mol (electrostatics 1e-3), the forces within 1e-6 of
the largest force (the helpers and the reasons:
port_bench/tests/test_bench_block_reference.py, which holds the box
replicated (2, 1, 1) too).
"""
from port_bench.tests.test_bench_block_reference import check_against_reference


def test_block_cell_matches_the_reference():
    _, diag = check_against_reference((1, 1, 1))
    assert int(diag['elec_tile_pairs']) == 16      # 4 row tiles, all within the cutoff
