"""Row gathers (port of mbpol_openmm_plugin_tpu/ops/gather.py).

On the card, table[idx] is a one-hot matmul: its backward is a GEMM, so
the gradient is the same bits on every run, while the backward of an
indexed gather is an index_add whose CUDA atomics sum in a varying order
(enough to move a 200-step f32 trajectory's energy by kJ/mol). The
one-hot rows select exactly: TF32 is off, so the fp32 products are exact.
On the CPU the indexed gather is used, as in the JAX package.
"""
import torch


def gather_rows(table, idx):
    """table: [n, d]; idx: [P] integer tensor; returns table[idx] ([P, d])."""
    if table.device.type == 'cpu':
        return torch.index_select(table, 0, idx)
    onehot = torch.nn.functional.one_hot(idx, table.shape[0]).to(table.dtype)
    return onehot @ table
