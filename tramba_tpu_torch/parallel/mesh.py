"""The (data, model, seq) grid of process groups, and the collectives that
run over it with their gradients.

Port of ``tramba_tpu/parallel/mesh.py`` and of what ``jax.shard_map`` does
for ``parallel/tp.py`` and ``parallel/seq_scan.py``.  JAX lays its devices
out as a ``Mesh`` with the axes ("data", "model", "seq"); here each process
drives one device, and ``make_grid`` lays the ranks of ``torch.distributed``'s
world out in the same order (rank = (d * model + m) * seq + s).  A rank's
group along an axis is the set of ranks that differ from it in that
coordinate only: its data group (same m, s), model group (same d, s) and
sequence group (same d, m).  Without ``torch.distributed`` every axis has
size 1 and no group, and the collectives are identities.

``shard_map`` transposes its collectives for the gradient; torch does not,
so each collective here is an ``autograd.Function`` with the adjoint the
parallel layer needs (Megatron's pattern):

* :func:`copy_to` -- identity forward, all-reduce backward: a replicated
  input that each rank of the group uses for its own part of the work;
* :func:`reduce_from` -- all-reduce forward (``psum``), identity backward:
  every rank goes on with the same sum and does the same work with it, so
  each holds the whole cotangent (the out projection's partials);
* :func:`reduce_shared` -- all-reduce forward and backward: every rank uses
  the sum for its own slice of the work, so the sum's cotangent is the sum
  of the ranks' (the Delta/B/C partials and the LayerNorm moments of the
  tensor-parallel core, whose channels differ by rank);
* :func:`split` -- this rank's block of a replicated tensor forward, the
  blocks all-gathered backward: the parameter slices of the tensor-parallel
  core and the L blocks of the sequence-parallel scan;
* :func:`gather` -- all-gather forward, this rank's block of the cotangent
  backward: every rank holds the same downstream cotangent, so summing it
  over the group (what ``torch.distributed.nn.all_gather`` does) would
  multiply the gradient by the group size;
* :func:`gather_summed` -- all-gather forward, the cotangents summed over the
  group backward: each rank's downstream uses the gathered values
  differently (the block summaries of the sequence-parallel scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Axis", "Grid", "make_grid", "batch_slice", "broadcast_parameters", "copy_to",
           "reduce_from", "reduce_shared", "split", "gather", "gather_summed"]


@dataclass(frozen=True)
class Axis:
    """One axis of the grid as this rank sees it: its process group (None
    without torch.distributed), this rank's index in it and its size."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


@dataclass(frozen=True)
class Grid:
    data: Axis
    model: Axis
    seq: Axis


_SOLO = Axis(None, 0, 1)


def make_grid(model: int = 1, seq: int = 1) -> Grid:
    """The (world / (model * seq), model, seq) grid over torch.distributed's
    world.  Every rank must call it, with the same sizes (the groups are made
    collectively)."""
    if not dist.is_initialized():
        if model != 1 or seq != 1:
            raise ValueError("a model or sequence axis above 1 needs torch.distributed")
        return Grid(_SOLO, _SOLO, _SOLO)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or seq < 1 or world % (model * seq):
        raise ValueError(f"world size {world} does not split into model {model} x seq {seq}")
    data = world // (model * seq)
    coords = [(r // (model * seq), r // seq % model, r % seq) for r in range(world)]
    shape = (data, model, seq)
    axes = []
    for a in range(3):
        # the fibres along axis a, each listed by the other two coordinates
        fibres = {}
        for r, c in enumerate(coords):
            fibres.setdefault(c[:a] + c[a + 1:], []).append(r)
        group, _ = dist.new_subgroups_by_enumeration(list(fibres.values()))
        axes.append(Axis(group, coords[rank][a], shape[a]))
    return Grid(*axes)


def batch_slice(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's contiguous slice of a global batch over ``axis`` (the data
    axis): equal slices, or a ValueError."""
    if x.shape[0] % axis.size:
        raise ValueError(f"batch {x.shape[0]} does not divide over {axis.size} data ranks")
    per = x.shape[0] // axis.size
    return x[axis.rank * per:(axis.rank + 1) * per]


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module) -> None:
    """Give every rank global rank 0's parameters and buffers (DDP does so
    only within its data group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in module.state_dict().values():
            dist.broadcast(t, 0)


def _all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=axis.group)
    return t


def _all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


def _block(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"size {n} of dim {dim} does not divide over {axis.size} ranks")
    per = n // axis.size
    return t.narrow(dim, axis.rank * per, per)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shared):
        ctx.axis, ctx.shared = axis, shared
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.axis) if ctx.shared else g), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, summed):
        ctx.dim, ctx.axis, ctx.summed = dim, axis, summed
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _all_reduce(g, ctx.axis)
        return _block(g, ctx.dim, ctx.axis).contiguous(), None, None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _Reduce.apply(x, axis, False)


def reduce_shared(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _Reduce.apply(x, axis, True)


def split(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _Split.apply(x, dim % x.dim(), axis)


def gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _Gather.apply(x, dim % x.dim(), axis, False)


def gather_summed(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _Gather.apply(x, dim % x.dim(), axis, True)
