"""The linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0): kernel K14
``linear_scan``, and the selective scan built on it.

Port of ``tramba_tpu/ops/selective_scan.py:617-789``:

* :func:`linear_scan_ref` is the plain version: a step-by-step fp32 loop,
  differentiable by autograd (the steps are stacked, not written in place).
  It is also the oracle inside K1's plain version
  (``ops/fused_ss2d.ss2d_scan_ref``), which never reaches K14.
* :func:`linear_scan` is ``linear_scan(backend=None)``: kernel K14
  (``csrc/scan.cu``, replacing ``_linear_scan_pallas``, :642: one pass over
  segments of up to 256 rows joined by a decoupled look-back, or one thread
  a column where the scan has many columns; its plan is
  :func:`linear_scan_plan`, mirrored by ``ops/scan_segments.py``) on CUDA
  tensors, :func:`linear_scan_ref` on CPU tensors; a build or launch error
  raises.  Its gradient is :class:`LinearScan`, JAX's ``_linear_scan_bwd``
  (:726-736): lam = the reversed scan of (a shifted up by one row, g),
  da = lam * h_{t-1}, db = lam; on the card that scan is K14 launched with
  ``reverse=True``.  Inputs of any float dtype are scanned in fp32 (:704).
* :func:`selective_scan` is the S6 op for any d_state N (:747-789); N > 1
  folds the state axis into channels.

The tensor-parallel SS2D core, the local scans of the sequence-parallel scan
and SS2D with d_state > 1 run :func:`linear_scan`; the default SS2D route
runs the scan inside kernel K1 instead.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import F32, check_args, needs_grad, on_card

__all__ = ["linear_scan", "linear_scan_ref", "linear_scan_plan", "SCAN_PLAN_FIELDS",
           "LinearScan", "dt_projection", "selective_scan"]


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """h over axis -2 of (..., L, C) tensors, in fp32; ``reverse`` runs from
    the last row back (h_t = a_t * h_{t+1} + b_t).  Each step is one
    ``addcmul``, which ``utils/profiling.analytic_model_flops`` counts as the
    scan handle's 9 operations an element."""
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    L = a.shape[-2]
    a, b = a.float(), b.float()
    prev = torch.zeros_like(b[..., 0, :])
    hs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        prev = torch.addcmul(b[..., t, :], a[..., t, :], prev)
        hs[t] = prev
    return torch.stack(hs, dim=-2)


def _scan(a: torch.Tensor, b: torch.Tensor, reverse: bool) -> torch.Tensor:
    """K14 on CUDA tensors, :func:`linear_scan_ref` on CPU tensors; no
    autograd."""
    if not on_card(a):
        return linear_scan_ref(a, b, reverse)
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(f"linear_scan: a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "equal shapes (..., L, C)")
    shape = a.shape
    L, C = shape[-2], shape[-1]
    a3 = a.float().reshape(-1, L, C).contiguous()
    b3 = b.float().reshape(-1, L, C).contiguous()
    check_args(a=(a3, F32), b=(b3, F32))
    h = torch.empty_like(a3)
    ints, head = _scan_scratch(a3.device.index, a3.shape[0], L, C)
    iptr = fptr = None  # the column route needs no scratch
    if ints:
        scratch = torch.empty(ints, device=a3.device, dtype=torch.int32)
        iptr = scratch.data_ptr()
        fptr = iptr + 4 * head
    _native.launch("linear_scan_launch", a3.data_ptr(), b3.data_ptr(), h.data_ptr(),
                   a3.shape[0], L, C, int(reverse), iptr, fptr, _native.stream_handle(a3))
    linear_scan.launches += 1
    return h.reshape(shape)


# the plan linear_scan_plan reports (``linear_scan_plan`` in csrc/scan.cu):
# the route (0 segments, 1 one thread a column), rows a segment, segments a
# column, channels a block, walkers a channel, blocks, shared bytes a block
SCAN_PLAN_FIELDS = ("route", "seg", "segments", "channels", "parts", "blocks", "smem")


@functools.lru_cache(maxsize=None)
def _scan_plan(device: int, R: int, L: int, C: int) -> tuple:
    out = (ctypes.c_int * len(SCAN_PLAN_FIELDS))()
    with torch.cuda.device(device):
        _native.launch("linear_scan_plan", R, L, C, out)
    return tuple(out)


def linear_scan_plan(R: int, L: int, C: int, device: int = 0) -> dict:
    """The plan the built library makes for a K14 call on (R, L, C) tensors
    on CUDA device ``device`` ({field: value} over
    :data:`SCAN_PLAN_FIELDS`); ``ops/scan_segments.linear_scan_plan`` is its
    plain mirror.  No launch."""
    return dict(zip(SCAN_PLAN_FIELDS, _scan_plan(device, R, L, C)))


@functools.lru_cache(maxsize=None)
def _scan_scratch(device: int, R: int, L: int, C: int) -> tuple:
    """(ints, head) of the one int32 scratch buffer a K14 call takes: none on
    the column route; on the segment route the ticket and the segments'
    flags (``head`` = 1 + blocks ints, zeroed by the launcher), then their
    summaries and inclusive end states (3 channels blocks floats)."""
    plan = linear_scan_plan(R, L, C, device)
    if plan["route"]:
        return 0, 0
    head = 1 + plan["blocks"]
    return head + 3 * plan["channels"] * plan["blocks"], head


def _shift(t: torch.Tensor, up: bool) -> torch.Tensor:
    """t moved one row along axis -2, up (row t takes row t + 1) or down,
    with zeros coming in."""
    z = torch.zeros_like(t[..., :1, :])
    return torch.cat([t[..., 1:, :], z] if up else [z, t[..., :-1, :]], dim=-2)


class LinearScan(torch.autograd.Function):
    """Forward: the scan (K14 on the card).  Backward: JAX's
    ``_linear_scan_bwd`` with the same scan run the other way."""

    @staticmethod
    def forward(ctx, a, b, reverse):
        h = _scan(a, b, reverse)
        ctx.save_for_backward(a, h)
        ctx.reverse, ctx.b_dtype = reverse, b.dtype
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        fwd = not ctx.reverse
        # forward: lam_t = g_t + a_{t+1} lam_{t+1}, a shifted up one row and
        # scanned back; a reversed scan's adjoint runs forward, a shifted down
        lam = _scan(_shift(a, up=fwd), g, fwd)
        return (lam * _shift(h, up=not fwd)).to(a.dtype), lam.to(ctx.b_dtype), None


def linear_scan(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """h over axis -2 of (..., L, C) tensors, in fp32 (``reverse``: from the
    last row back): kernel K14 on CUDA tensors, the plain version on CPU
    tensors; differentiable in both."""
    if needs_grad(a, b):
        return LinearScan.apply(a, b, reverse)
    return _scan(a, b, reverse)


linear_scan.launches = 0


def dt_projection(dts: torch.Tensor, dt_w: torch.Tensor) -> torch.Tensor:
    """Each direction's dt projection: dts (B, K, L, R) times dt_w (K, D, R)
    over R, giving (B, K, L, D) in the operands' dtype.  A matrix product
    at every rank: ``torch.einsum`` does rank 1 as a broadcast product,
    which ``utils/profiling.analytic_model_flops`` would not count (JAX
    counts its ``dot_general``)."""
    return torch.matmul(dts, dt_w.transpose(1, 2))


def selective_scan(u, dt, A, Bc, Cc, D, dt_bias=None,
                   scan: Callable = linear_scan) -> torch.Tensor:
    """y_t = C_t . h_t + D u_t with h_t = exp(delta_t A) h_{t-1} + delta_t
    B_t u_t and delta_t = softplus(dt_t + dt_bias), the state in fp32.

    u, dt (B, K, L, D); A (K, D, N), already negative; Bc, Cc (B, K, L, N);
    D (K, D); dt_bias (K, D) or None.  ``scan`` runs the recurrence
    (:func:`linear_scan` by default; the sequence-parallel scan passes its
    own).  Returns (B, K, L, D) in u's dtype."""
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()[None, :, None, :]
    delta = F.softplus(dtf)
    uf, Af, Bf, Cf = u.float(), A.float(), Bc.float(), Cc.float()
    du = delta * uf
    if A.shape[-1] == 1:
        h = scan(torch.exp(delta * Af[None, :, None, :, 0]), du * Bf)
        y = h * Cf
    else:
        # the state axis folded into channels
        Bsz, K, L, Dch = u.shape
        N = A.shape[-1]
        a = torch.exp(delta[..., None] * Af[None, :, None])  # (B, K, L, D, N)
        b = du[..., None] * Bf[:, :, :, None, :]
        h = scan(a.reshape(Bsz, K, L, Dch * N), b.reshape(Bsz, K, L, Dch * N))
        y = torch.einsum("bkldn,bkln->bkld", h.reshape(Bsz, K, L, Dch, N), Cf)
    y = y + uf * D.float()[None, :, None, :]
    return y.to(u.dtype)
