"""Upsamplers and final head: kernel K3 ``expand_ln`` and kernel K4 ``final_head``.

Port of ``tramba_tpu/ops/fused_expand.py``.  K3 is Dense C -> f*C, the x2
pixel shuffle in the reference's (p1, p2, c) channel order, then LayerNorm
(PatchExpand f=2, FreqExpand2D f=4).  K4 is Dense C -> 16C, a LayerNorm per
slot of C channels and the 1x1 seg conv, with the 16C-wide tensor kept out
of device memory.  Both run in ``csrc/expand.cu``, one launch a call: in
bf16 their products on ``wgmma`` from TMA-staged tiles with the LayerNorm
(K3) or the per-slot head (K4) in the accumulators' epilogue, in fp32 as
SIMT register micro-tiles from staged shared tiles.  :func:`expand_plan` and
:func:`head_plan` report the launchers' tiling, which
``ops/expand_stages.py`` mirrors in plain PyTorch.

The wrappers pick by the tensors' device as in ``ops/fused_ss2d.py``, and
count launches in ``<wrapper>.launches``.  Under autograd on the card the
kernel runs inside a ``torch.autograd.Function`` whose backward recomputes
the plain version and differentiates it, as ``_exp_bwd`` (:105) and
``_head_bwd`` (:218) differentiate the composed versions in XLA.  Weights are in torch.nn.Linear
layout (out_features, in_features).  ``x`` and the expand weight are both
fp32 or both bf16 (the output takes their dtype); the LayerNorm and head
parameters are fp32, and the LayerNorm runs in fp32 on the unrounded expand,
as ``_expand_pallas`` and ``_final_head_pallas`` do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import F32, F32_BF16, check_args, needs_grad, on_card
from tramba_tpu_torch.utils.profiling import span

__all__ = ["pixel_shuffle", "expand_ln", "expand_ln_ref", "final_head", "final_head_ref",
           "expand_plan", "head_plan"]

# fields of a plan, in the order the library reports them
PLAN_FIELDS = ("route", "rows", "wn", "split", "gpb", "sets", "tiles", "stages", "smem")


def pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC pixel shuffle, channel index = (p1, p2, c): the reference's
    '(p1 p2 c) h w -> c (h p1) (w p2)' (modules.py:213/247/691)."""
    B, H, W, C = x.shape
    c = C // (p * p)
    x = x.reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * p, W * p, c)


def expand_ln_ref(x, w, ln_w, ln_b):
    """x (B, H, W, C); w (f*C, C); ln_w, ln_b (f*C/4).  Mirrors
    composed_expand2 (fused_expand.py:83).  Returns (B, 2H, 2W, f*C/4)."""
    e = pixel_shuffle(x.float() @ w.float().t(), 2)
    return F.layer_norm(e, (e.shape[-1],), ln_w, ln_b, 1e-5).to(x.dtype)


def final_head_ref(x, w1, ln_w, ln_b, seg_w, seg_b):
    """x (B, h, w, C); w1 (16C, C); ln_w, ln_b, seg_w (C); seg_b (1).  Mirrors
    composed_final_head (fused_expand.py:197).  Returns (B, h, w, 16), slot
    s = 4 * p1 + p2."""
    B, h, w, C = x.shape
    e = (x.float() @ w1.float().t()).reshape(B, h, w, 16, C)
    y = F.layer_norm(e, (C,), ln_w, ln_b, 1e-5)
    return (y @ seg_w + seg_b.sum()).to(x.dtype)


def expand_plan(B: int, H: int, W: int, C: int, co: int, dtype: torch.dtype) -> dict:
    """K3's plan as the built library makes it (``plan_expand`` in
    ``csrc/expand.cu``; :func:`tramba_tpu_torch.ops.expand_stages.expand_plan`
    is its plain mirror), {field: value} over :data:`PLAN_FIELDS`.  No launch;
    raises for shapes the kernel does not take."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    _native.launch("expand_ln_plan", B, H, W, C, co, int(dtype == torch.bfloat16), out)
    return dict(zip(PLAN_FIELDS, out))


def head_plan(M: int, C: int, dtype: torch.dtype) -> dict:
    """K4's plan as the built library makes it (``plan_head``), as
    :func:`expand_plan`."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    _native.launch("final_head_plan", M, C, int(dtype == torch.bfloat16), out)
    return dict(zip(PLAN_FIELDS, out))


class _KernelWithPlainVjp(torch.autograd.Function):
    """Forward: a kernel launch; backward: the VJP of its plain version."""

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return launch(*args)

    @staticmethod
    def backward(ctx, g):
        grads = _native.recompute_vjp(ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], g)
        return (None, None, *grads)


def expand_ln(x, w, ln_w, ln_b):
    """Kernel K3 on CUDA tensors, :func:`expand_ln_ref` on CPU tensors."""
    with span("K3 expand_ln"):
        if not on_card(x):
            return expand_ln_ref(x, w, ln_w, ln_b)
        if needs_grad(x, w, ln_w, ln_b):
            return _KernelWithPlainVjp.apply(_expand_ln_launch, expand_ln_ref, x, w, ln_w, ln_b)
        return _expand_ln_launch(x, w, ln_w, ln_b)


def _expand_ln_launch(x, w, ln_w, ln_b):
    B, H, W, C = x.shape
    co = w.shape[0] // 4
    check_args(x=(x, F32_BF16), w=(w, (x.dtype,)), ln_w=(ln_w, F32), ln_b=(ln_b, F32))
    vec = 16 // x.element_size()  # one 16-byte load
    if C % vec or tuple(w.shape) != (4 * co, C) or ln_w.numel() != co or ln_b.numel() != co:
        raise ValueError(f"expand_ln: C={C} must be a multiple of {vec}, w (4*co, C), ln (co)")
    out = torch.empty(B, 2 * H, 2 * W, co, device=x.device, dtype=x.dtype)
    _native.launch("expand_ln_launch", x.data_ptr(), w.data_ptr(), ln_w.data_ptr(),
                   ln_b.data_ptr(), out.data_ptr(), B, H, W, C, co,
                   int(x.dtype == torch.bfloat16), _native.stream_handle(x))
    expand_ln.launches += 1
    return out


expand_ln.launches = 0


def final_head(x, w1, ln_w, ln_b, seg_w, seg_b):
    """Kernel K4 on CUDA tensors, :func:`final_head_ref` on CPU tensors."""
    with span("K4 final_head"):
        args = (x, w1, ln_w, ln_b, seg_w, seg_b)
        if not on_card(x):
            return final_head_ref(*args)
        if needs_grad(*args):
            return _KernelWithPlainVjp.apply(_final_head_launch, final_head_ref, *args)
        return _final_head_launch(*args)


def _final_head_launch(x, w1, ln_w, ln_b, seg_w, seg_b):
    B, h, w, C = x.shape
    check_args(x=(x, F32_BF16), w1=(w1, (x.dtype,)), ln_w=(ln_w, F32), ln_b=(ln_b, F32),
               seg_w=(seg_w, F32), seg_b=(seg_b, F32))
    vec = 16 // x.element_size()  # one 16-byte load
    if (C % vec or tuple(w1.shape) != (16 * C, C) or ln_w.numel() != C or ln_b.numel() != C
            or seg_w.numel() != C or seg_b.numel() != 1):
        raise ValueError(f"final_head: C={C} must be a multiple of {vec}, w1 (16C, C)")
    out = torch.empty(B, h, w, 16, device=x.device, dtype=x.dtype)
    _native.launch("final_head_launch", x.data_ptr(), w1.data_ptr(), ln_w.data_ptr(),
                   ln_b.data_ptr(), seg_w.data_ptr(), seg_b.data_ptr(), out.data_ptr(),
                   B * h * w, C, int(x.dtype == torch.bfloat16), _native.stream_handle(x))
    final_head.launches += 1
    return out


final_head.launches = 0
