"""The linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0), plain fp32.

Port of ``tramba_tpu/ops/selective_scan.py:711`` ``linear_scan`` as a
step-by-step loop: the oracle inside the plain SS2D core
(``ops/fused_ss2d.ss2d_scan_ref``), differentiable by autograd (the steps
are stacked, not written in place).  The card path never runs it; the scan
there is kernel K1, its adjoint kernel K8.
"""

from __future__ import annotations

import torch

__all__ = ["linear_scan"]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h over axis -2 of (..., L, D) fp32 tensors."""
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    prev = torch.zeros_like(b[..., 0, :], dtype=torch.float32)
    hs = []
    for t in range(a.shape[-2]):
        prev = torch.addcmul(b[..., t, :], a[..., t, :], prev)
        hs.append(prev)
    return torch.stack(hs, dim=-2)
