"""Row gathers (port of mbpol_openmm_plugin_tpu/ops/gather.py).

On the card, table[idx] with a backward that gives the same bits on every
run: the plain backward of an indexed gather is an index_add whose CUDA
atomics sum in a varying order (enough to move a 200-step f32
trajectory's energy by kJ/mol). Here the backward sorts the indices
(stable) and sums each row's gradients with torch.segment_reduce, which
reduces every segment in a fixed order without atomics, in O(P) memory (a
one-hot matmul would need a [P, n] matrix: ~6 GB per gather for the
3-body list of water4096).

Padded list entries all hold index 0, so row 0's segment would hold every
padded entry and be summed by one thread; callers pass the list mask and
the backward leaves the padded entries out (their gradient is zero: the
callers mask their energies).
"""
import torch


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, mask):
        n = table.shape[0]
        # padded entries sort after every real row and fall outside the offsets
        ctx.save_for_backward(idx if mask is None else torch.where(mask, idx, n))
        ctx.n_rows = n
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        sorted_idx, order = torch.sort(idx, stable=True)
        offsets = torch.searchsorted(
            sorted_idx, torch.arange(ctx.n_rows + 1, device=idx.device, dtype=idx.dtype))
        out = torch.segment_reduce(grad[order], 'sum', offsets=offsets, axis=0, unsafe=True)
        return out, None, None


def gather_rows(table, idx, mask=None):
    """table: [n, d]; idx: [P] integer tensor; returns table[idx] ([P, d]).
    mask: optional [P] bool, False on padded entries whose gradient the
    caller zeroes. On the CPU the plain indexed gather is used, as in the
    JAX package."""
    if table.device.type == 'cpu':
        return torch.index_select(table, 0, idx)
    return _GatherRows.apply(table, idx, mask)
