"""Sequence-parallel linear recurrence over the sequence group.

Port of ``tramba_tpu/parallel/seq_scan.py:36-105``.  Each rank of the group
holds the whole (..., L, C) inputs (the model runs replicated over the
group) and scans its own block of L rows; the blocks are then joined with
the carry algebra:

  h_t = a_t h_{t-1} + b_t.  Block j is summarized by A_j (the product of
  its a) and s_j (its local h at the block's end); the carry entering block
  i is c_i = sum_{j<i} (prod_{j<k<i} A_k) s_j, and each position corrects
  its local result: h_t = h_local_t + P_t c_i, with P_t the in-block
  cumulative product of a.

The local scan is kernel K14 on the card; the (A_j, s_j) summaries are
all-gathered in one collective, and h is all-gathered back to full L for the
cross merge.  The gradients follow :mod:`~tramba_tpu_torch.parallel.mesh`:
the blocks are taken with ``split`` (their gradients gathered back), the
summaries with ``gather_summed`` (each rank's carry uses them differently),
and h with ``gather`` (every rank holds the same cotangent of h, so its
backward keeps this rank's block rather than summing).

    with use_sequence_group(grid.seq):
        y = SS2D(..., backend="seq_parallel")(x)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from tramba_tpu_torch.ops.selective_scan import linear_scan
from tramba_tpu_torch.parallel.mesh import Axis, gather, gather_summed, split

__all__ = ["use_sequence_group", "current_sequence_group", "sequence_group_or_none",
           "sequence_parallel_linear_scan"]

_ctx = threading.local()


@contextlib.contextmanager
def use_sequence_group(axis: Axis, min_l: int = 4096):
    """Route ``backend="seq_parallel"`` SS2Ds through this sequence axis.
    ``min_l``: the least L that ``backend="hybrid_tp_sp"`` sends here (the
    JAX package's ``TRAMBA_HYBRID_SP_MIN_L``; 4096 puts the 64 px and larger
    maps of a 384 px image here)."""
    prev = getattr(_ctx, "cur", None)
    _ctx.cur = (axis, min_l)
    try:
        yield
    finally:
        _ctx.cur = prev


def sequence_group_or_none() -> Optional[Tuple[Axis, int]]:
    """(axis, min_l) of the ambient sequence group, or None."""
    return getattr(_ctx, "cur", None)


def current_sequence_group() -> Axis:
    cur = sequence_group_or_none()
    if cur is None:
        raise RuntimeError("backend='seq_parallel' needs a sequence group: wrap the call in "
                           "tramba_tpu_torch.parallel.seq_scan.use_sequence_group(grid.seq)")
    return cur[0]


def sequence_parallel_linear_scan(a: torch.Tensor, b: torch.Tensor,
                                  axis: Optional[Axis] = None) -> torch.Tensor:
    """h over axis -2 of (..., L, C), fp32, with L split over the sequence
    group (the ambient one unless ``axis`` is given); L must divide evenly.
    Returns the full (..., L, C) h on every rank."""
    axis = axis or current_sequence_group()
    if a.shape[-2] % axis.size:
        raise ValueError(f"L {a.shape[-2]} must divide over {axis.size} sequence ranks")
    a_blk = split(a.float(), -2, axis)
    h_local = linear_scan(a_blk, split(b.float(), -2, axis))
    cum_a = torch.cumprod(a_blk, dim=-2)
    # the (A_j, s_j) summaries of every block, one all-gather
    summ = gather_summed(torch.cat([cum_a[..., -1:, :], h_local[..., -1:, :]], dim=-1), -2, axis)
    A_all, s_all = summ.chunk(2, dim=-1)
    # the exclusive prefix over the blocks; every rank takes every block's
    # carry into its graph, so every rank's backward runs the same collectives
    carries = [torch.zeros_like(s_all[..., :1, :])]
    for j in range(axis.size - 1):
        carries.append(A_all[..., j:j + 1, :] * carries[-1] + s_all[..., j:j + 1, :])
    carry = torch.cat(carries, dim=-2)[..., axis.rank:axis.rank + 1, :]
    return gather(h_local + cum_a * carry, -2, axis)
