"""Attention of the bf16 Tramba-P and Tramba-S encoders: kernels K12 ``sra``
and K13 ``window_attn``.

Port of ``tramba_tpu/ops/fused_attn.py``:

* K12 ``sra`` replaces ``_sra_pallas`` (:96, kernel :58), PVTv2's
  spatial-reduction attention: LN (eps 1e-6) -> q -> per head
  softmax(q_h k_hᵀ) v_h -> merged heads -> out projection, with the reduced
  keys and values (B, nh, Lk, hd) from the composed sr-conv path outside.
* K13 ``window_attn`` replaces ``_wattn_pallas`` (:254, kernel :204), Swin's
  window attention: LN (eps 1e-5) -> qkv -> per head softmax(q kᵀ + bias[h]
  (+ mask[window])) v -> merged heads -> out projection per w x w window of
  the (B, H, W, C) map, partition and reverse inside.  The cyclic shift and
  the gather of the relative-position bias stay outside, as in JAX.

Both run in ``csrc/attn.cu`` after the bf16 LayerNorm launch of
``csrc/mlp.cu``.  They round where the TPU kernels round: the LN output; q
after its bias and scale, k and v (K13: after their bias); the softmax
probabilities; the merged head outputs; the result.  The plain versions
(``*_ref``) do fp32 math on operands rounded to ``x``'s dtype at the same
points, so for fp32 inputs they are the composed fp32 functions.  The
wrappers pick by device (CPU tensors: the plain version; CUDA tensors: the
kernel or an error), count launches in ``<wrapper>.launches``, and under
autograd in bf16 (and on the card) run :class:`Sra` / :class:`WindowAttn`,
whose backward is the VJP of the plain version by recomputation, as
``_sra_bwd`` (:163) and ``_wattn_bwd`` (:343) differentiate the composed
versions (no gradient for the mask).  Weights are in torch layout: Linear
(out, in).
"""

from __future__ import annotations

import ctypes

import torch

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, F32, check_args, needs_grad, on_card
from tramba_tpu_torch.ops.fused_mlp import _linear, _ln_rounded, layer_norm_bf16

__all__ = ["sra", "sra_ref", "sra_fusable", "window_attn", "window_attn_ref",
           "window_attn_fusable", "Sra", "WindowAttn"]


def sra_fusable(N: int, C: int, nh: int, Lk: int, dtype) -> bool:
    """Where the JAX package runs ``_sra_pallas`` on a TPU (``sra_fusable``,
    fused_attn.py:34-45, whose VMEM budgets hold at every PVTv2-b4 width):
    bf16, N, Lk and the head width multiples of 8.  K12 takes every such shape
    with C, hd and Lk multiples of 16 (each 384 px stage)."""
    return (dtype == torch.bfloat16 and N % 8 == 0 and C % nh == 0 and (C // nh) % 8 == 0
            and Lk % 8 == 0)


def window_attn_fusable(H: int, W: int, C: int, nh: int, w: int, dtype) -> bool:
    """Where the JAX package runs ``_wattn_pallas`` on a TPU
    (``window_attn_fusable``, fused_attn.py:187-201, whose VMEM budgets hold
    at every Swin-B width): bf16, whole windows, head width and window size
    multiples of 8.  K13 takes every such shape with C, hd and w*w multiples
    of 16 (each 384 px stage)."""
    return (dtype == torch.bfloat16 and C % nh == 0 and (C // nh) % 8 == 0
            and (w * w) % 8 == 0 and H % w == 0 and W % w == 0)


def _scale(hd: int) -> float:
    return hd ** -0.5


# ---------------------------------------------------------------------------
# plain versions (mirror _sra_kernel, fused_attn.py:58-92, and _wattn_kernel,
# :204-250)
# ---------------------------------------------------------------------------


def _heads_out(q, k, v, cd, add=()):
    """q, k, v (G, nh, n, hd) fp32, already rounded; each tensor of ``add``
    is added in turn to the fp32 scores.  Returns the merged (G, n, nh*hd)
    head outputs rounded to cd, as fp32."""
    s = q @ k.transpose(-1, -2)
    for t in add:
        s = s + t
    p = torch.softmax(s, dim=-1).to(cd).float()
    o = p @ v
    G, nh, n, hd = o.shape
    return o.transpose(1, 2).reshape(G, n, nh * hd).to(cd).float()


def sra_ref(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6):
    """x (B, N, C); ln_w, ln_b, bq, bp (C); wq, wp (C, C); k, v (B, nh, Lk,
    hd).  Returns (B, N, C) in x's dtype."""
    cd = x.dtype
    B, N, C = x.shape
    hd = C // nh
    q = (_linear(_ln_rounded(x, ln_w, ln_b, eps), wq, cd) + bq.float()) * _scale(hd)
    q = q.reshape(B, N, nh, hd).transpose(1, 2).to(cd).float()
    o = _heads_out(q, k.to(cd).float(), v.to(cd).float(), cd)
    return (_linear(o, wp, cd) + bp.float()).to(cd)


def window_attn_ref(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps=1e-5):
    """x (B, H, W, C), already rolled for a shifted block; wqkv (3C, C);
    bqkv (3C); bias (nh, N, N) fp32 with N = w*w; mask (nW, N, N) fp32 or
    None; wp (C, C); bp (C).  Returns (B, H, W, C) in x's dtype."""
    cd = x.dtype
    B, H, W, C = x.shape
    N = bias.shape[-1]
    w = int(round(N ** 0.5))
    nWh, nWw = H // w, W // w
    hd = C // nh
    y = _ln_rounded(x, ln_w, ln_b, eps)
    win = y.reshape(B, nWh, w, nWw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, N, C)
    qkv = (_linear(win, wqkv, cd) + bqkv.float()).reshape(-1, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q = (qkv[0] * _scale(hd)).to(cd).float()
    k, v = qkv[1].to(cd).float(), qkv[2].to(cd).float()
    add = [bias.float()]
    if mask is not None:  # each window's mask on every head: (B * nW, 1, N, N)
        add.append(mask.float()[:, None].repeat(B, 1, 1, 1))
    o = _heads_out(q, k, v, cd, add)
    out = _linear(o, wp, cd) + bp.float()
    out = out.reshape(B, nWh, nWw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    return out.to(cd)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def sra(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6):
    """Kernel K12 on CUDA tensors, :func:`sra_ref` on CPU tensors; under
    autograd in bf16 (and on the card) :class:`Sra`."""
    args = (x, ln_w, ln_b, wq, bq, k, v, wp, bp)
    if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
        return Sra.apply(*args, nh, eps)
    return _sra_launch(*args, nh, eps) if on_card(x) else sra_ref(*args, nh, eps)


def _proj_in(y, w, b, nscale, scale):
    """Launch (1) of K12 / K13: bf16((y @ w^T + b) * s), s = scale on the
    first ``nscale`` columns."""
    M, K = y.numel() // y.shape[-1], y.shape[-1]
    out = torch.empty(*y.shape[:-1], w.shape[0], device=y.device, dtype=torch.bfloat16)
    _native.launch("attn_proj_in_launch", y.data_ptr(), w.data_ptr(), b.data_ptr(),
                   out.data_ptr(), M, K, w.shape[0], nscale, ctypes.c_float(scale),
                   _native.stream_handle(y))
    return out


def _attn_shapes(name, C, nh, hd, n, wp, bp):
    if C % 16 or hd % 16 or n % 16 or nh * hd != C or tuple(wp.shape) != (C, C) \
            or bp.numel() != C:
        raise ValueError(f"{name}: C={C}, head width {hd} and {n} keys must be multiples of "
                         "16, nh * hd == C, wp (C, C), bp (C)")


def _sra_launch(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps):
    cd = x.dtype
    wq, wp, k, v = wq.to(cd), wp.to(cd), k.to(cd).contiguous(), v.to(cd).contiguous()
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), wq=(wq, BF16), bq=(bq, F32),
               k=(k, BF16), v=(v, BF16), wp=(wp, BF16), bp=(bp, F32))
    B, N, C = x.shape
    hd = C // nh
    Lk = k.shape[2]
    _attn_shapes("sra", C, nh, hd, Lk, wp, bp)
    if tuple(k.shape) != (B, nh, Lk, hd) or v.shape != k.shape or tuple(wq.shape) != (C, C) \
            or bq.numel() != C:
        raise ValueError("sra: x (B, N, C), k and v (B, nh, Lk, C / nh), wq (C, C), bq (C)")
    q = _proj_in(layer_norm_bf16(x, ln_w, ln_b, eps), wq, bq, C, _scale(hd))
    out = torch.empty_like(x)
    _native.launch("sra_attn_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), wp.data_ptr(),
                   bp.data_ptr(), out.data_ptr(), B, N, C, nh, Lk, _native.stream_handle(x))
    sra.launches += 1
    return out


sra.launches = 0


def window_attn(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps=1e-5):
    """Kernel K13 on CUDA tensors, :func:`window_attn_ref` on CPU tensors;
    under autograd in bf16 (and on the card) :class:`WindowAttn`."""
    args = (x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp)
    if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
        return WindowAttn.apply(*args, nh, eps)
    return _window_attn_launch(*args, nh, eps) if on_card(x) else window_attn_ref(*args, nh, eps)


def _window_attn_launch(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps):
    cd = x.dtype
    wqkv, wp, bias = wqkv.to(cd), wp.to(cd), bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), wqkv=(wqkv, BF16),
               bqkv=(bqkv, F32), bias=(bias, F32), wp=(wp, BF16), bp=(bp, F32),
               **({} if mask is None else {"mask": (mask, F32)}))
    B, H, W, C = x.shape
    hd = C // nh
    N = bias.shape[-1]
    w = int(round(N ** 0.5))
    _attn_shapes("window_attn", C, nh, hd, N, wp, bp)
    nW = (H // w) * (W // w)
    if (w * w != N or H % w or W % w or tuple(bias.shape) != (nh, N, N)
            or tuple(wqkv.shape) != (3 * C, C) or bqkv.numel() != 3 * C
            or (mask is not None and tuple(mask.shape) != (nW, N, N))):
        raise ValueError("window_attn: x (B, H, W, C) in whole w x w windows, bias (nh, N, N), "
                         "mask (nW, N, N), wqkv (3C, C), bqkv (3C)")
    qkv = _proj_in(layer_norm_bf16(x, ln_w, ln_b, eps), wqkv, bqkv, C, _scale(hd))
    out = torch.empty_like(x)
    _native.launch("window_attn_launch", qkv.data_ptr(), bias.data_ptr(),
                   None if mask is None else mask.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                   out.data_ptr(), B, H, W, C, nh, w, _native.stream_handle(x))
    window_attn.launches += 1
    return out


window_attn.launches = 0


class Sra(torch.autograd.Function):
    """K12 forward (its plain version on CPU tensors); backward: the VJP of
    :func:`sra_ref` by recomputation (``_sra_bwd``, fused_attn.py:163-165)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wq, bq, k, v, wp, bp)
        ctx.nh, ctx.eps = nh, eps
        args = (x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps)
        return _sra_launch(*args) if on_card(x) else sra_ref(*args)

    @staticmethod
    def backward(ctx, g):
        grads = _native.recompute_vjp(lambda *a: sra_ref(*a, ctx.nh, ctx.eps), ctx.saved_tensors,
                                      ctx.needs_input_grad[:9], g)
        return (*grads, None, None)


class WindowAttn(torch.autograd.Function):
    """K13 forward (its plain version on CPU tensors); backward: the VJP of
    :func:`window_attn_ref` by recomputation, none for the mask
    (``_wattn_bwd``, fused_attn.py:343-350)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp)
        ctx.nh, ctx.eps = nh, eps
        args = (x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps)
        return _window_attn_launch(*args) if on_card(x) else window_attn_ref(*args)

    @staticmethod
    def backward(ctx, g):
        needs = list(ctx.needs_input_grad[:9])
        needs[6] = False  # the mask
        grads = _native.recompute_vjp(lambda *a: window_attn_ref(*a, ctx.nh, ctx.eps),
                                      ctx.saved_tensors, needs, g)
        return (*grads, None, None)
