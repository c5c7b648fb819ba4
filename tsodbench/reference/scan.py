"""The first-order recurrence h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis
-2, in fp64, by doubling steps (Hillis-Steele): log2(L) whole-tensor passes
instead of L steps, each exact to fp64 rounding.  Its adjoint is the same
scan run backwards: lam_t = g_t + a_{t+1} lam_{t+1}, da_t = lam_t h_{t-1},
db_t = lam_t.  Inputs and outputs are fp32; only a and h are saved.
"""

from __future__ import annotations

import torch


def _doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    L, o = a.shape[-2], 1
    while o < L:
        b = torch.cat([b[..., :o, :], b[..., o:, :] + a[..., o:, :] * b[..., :-o, :]], dim=-2)
        if 2 * o < L:
            a = torch.cat([a[..., :o, :], a[..., o:, :] * a[..., :-o, :]], dim=-2)
        o *= 2
    return b


def _shift(t: torch.Tensor, up: bool) -> torch.Tensor:
    z = torch.zeros_like(t[..., :1, :])
    return torch.cat([t[..., 1:, :], z] if up else [z, t[..., :-1, :]], dim=-2)


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _doubling(a, b).float()
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        lam = _doubling(_shift(a, up=True).flip(-2), g.flip(-2)).flip(-2).float()
        return lam * _shift(h, up=False), lam


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h over axis -2 of fp32 (..., L, C) tensors; differentiable."""
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    return _Scan.apply(a.float(), b.float())
