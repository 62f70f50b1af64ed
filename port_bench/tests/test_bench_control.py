"""The control (the reference in float32 with TF32 matrix products, the
precision below the configuration's) put in the program's place fails the
cell's limits where the program passes them, and so does each energy term
left out of the program's answer: on the card, at the water256 cell's own
size. On the CPU there is no TF32, so it skips."""
import pytest
import torch

from port_bench.control import readings_of_seed
from port_bench.harness import compare, spec, sut


@pytest.mark.cuda
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: TF32 products exist only there')
    sut.build_kernels()
    c = spec.cell('water256_bulk.nve_r50')
    r = readings_of_seed(c, 2 ** 31 + 99, 1, True)
    assert compare.judge(r['program'], c['limits'])[0] is True
    assert compare.judge(r['control'], c['limits'])[0] is False
    for term in compare.TERMS:
        assert compare.judge(r['term_left_out'][term], c['limits'])[0] is False, term
