"""SS2D prologue of the bf16 path: kernel K5 ``prologue``.

Port of ``tramba_tpu/ops/fused_prologue.py`` ``_prologue_pallas`` (:94,
kernel :57), which is also the front of ``_small_pallas``
(``fused_ss2d_small.py:103-131``): (LayerNorm ->) in_proj -> depthwise 3x3
-> SiLU, in ``csrc/prologue.cu``: one launch, the LayerNorm folded in, u
kept on chip.  The LayerNorm is optional: the encoder and decoder SS2Ds
fold their block's pre-norm in, the DFVSS guide SS2Ds have none
(``fused_prologue.py:162``).  :mod:`tramba_tpu_torch.ops.prologue_stages`
mirrors the kernel's tiles in plain PyTorch.

Rounding points of the TPU kernel: the LN output is rounded to bf16, the
in-projection (bf16 weight) accumulates in fp32 and stays fp32, the 3x3 taps
are rounded to bf16 and applied in fp32, and the SiLU output is rounded to
bf16.  The conv pads the in-projection, so a pixel outside the image adds 0.
The plain version rounds at the same points, in ``x``'s dtype.  The wrapper
picks by device and counts launches in ``prologue.launches``.  Under autograd
on the card it runs :class:`Prologue`: K5 forward, and as backward the VJP
of the plain version by recomputation, as JAX differentiates
``composed_prologue`` in XLA (``fused_prologue.py:154-156``, ``:172-176``,
``fused_ss2d_small.py:440-456``).  Weights are in torch layout: in_proj
(D, dm), conv (D, 1, 3, 3), cast to x's dtype at the call (the modules hand
over the fp32 parameters).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, F32, check_args, needs_grad, on_card
from tramba_tpu_torch.ops.fused_mlp import _linear, _ln_rounded

__all__ = ["prologue", "prologue_ref", "check_prologue_shape", "prologue_plan", "Prologue"]


def prologue_ref(x, ln_w, ln_b, w_in, conv_k):
    """x (B, H, W, dm); ln_w, ln_b (dm) or both None; w_in (D, dm);
    conv_k (D, 1, 3, 3).  Returns (B, H, W, D) in x's dtype."""
    cd = x.dtype
    D = w_in.shape[0]
    y = x.float() if ln_w is None else _ln_rounded(x, ln_w, ln_b)
    u = _linear(y, w_in, cd).permute(0, 3, 1, 2)
    u = F.conv2d(u, conv_k.to(cd).float(), padding=1, groups=D)
    return F.silu(u.permute(0, 2, 3, 1)).to(cd)


def prologue(x, ln_w, ln_b, w_in, conv_k):
    """Kernel K5 on CUDA tensors (under autograd :class:`Prologue`),
    :func:`prologue_ref` on CPU tensors."""
    args = (x, ln_w, ln_b, w_in, conv_k)
    if not on_card(x):
        return prologue_ref(*args)
    if needs_grad(*args):
        return Prologue.apply(*args)
    return _prologue_launch(*args)


def check_prologue_shape(B: int, H: int, W: int, dm: int, D: int) -> None:
    """Raise ValueError unless K5 takes a (B, H, W, dm) map into D channels:
    dm and D multiples of 16, dm from 16 to 1024 (a warp holds a pixel's row
    in four 16-byte groups a lane for its LayerNorm, and the block's A tile
    holds the halo rows' full width).  No launch: the tests hold every
    model's shapes to it on the CPU."""
    if min(B, H, W) < 1 or dm % 16 or D % 16 or not 16 <= dm <= 1024 or D < 16:
        raise ValueError(f"prologue: B={B}, H={H}, W={W} must be positive, dm={dm} and D={D} "
                         "multiples of 16, dm from 16 to 1024")


def prologue_plan(B: int, H: int, W: int, dm: int, D: int) -> tuple:
    """K5's plan as the built library makes it (``plan_prologue`` in
    ``csrc/prologue.cu``; :func:`tramba_tpu_torch.ops.prologue_stages.
    prologue_plan` is its plain mirror): (TH, TW, MT, groups, stages).  No
    launch; raises for shapes the kernel does not take."""
    out = (ctypes.c_int * 5)()
    _native.launch("prologue_plan", B, H, W, dm, D, out)
    return tuple(out)


def _prologue_launch(x, ln_w, ln_b, w_in, conv_k):
    w_in, conv_k = w_in.to(x.dtype), conv_k.to(x.dtype)
    B, H, W, dm = x.shape
    D = w_in.shape[0]
    check_args(x=(x, BF16), w_in=(w_in, BF16), conv_k=(conv_k, BF16))
    if (ln_w is None) != (ln_b is None):
        raise ValueError("prologue: give both LN parameters or neither")
    if tuple(w_in.shape) != (D, dm) or tuple(conv_k.shape) != (D, 1, 3, 3):
        raise ValueError("prologue: w_in (D, dm), conv_k (D, 1, 3, 3)")
    check_prologue_shape(B, H, W, dm, D)
    if ln_w is not None:
        check_args(ln_w=(ln_w, F32), ln_b=(ln_b, F32))
        if ln_w.numel() != dm or ln_b.numel() != dm:
            raise ValueError(f"prologue: LN parameters must have {dm} elements")
    out = torch.empty(B, H, W, D, device=x.device, dtype=torch.bfloat16)
    _native.launch("prologue_launch", x.data_ptr(), *(None if t is None else t.data_ptr()
                                                      for t in (ln_w, ln_b)),
                   w_in.data_ptr(), conv_k.data_ptr(), out.data_ptr(), B, H, W, dm, D,
                   _native.stream_handle(x))
    prologue.launches += 1
    return out


prologue.launches = 0


class Prologue(torch.autograd.Function):
    """K5 forward; backward: the VJP of :func:`prologue_ref` by recomputation."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_in, conv_k):
        ctx.save_for_backward(x, ln_w, ln_b, w_in, conv_k)
        return _prologue_launch(x, ln_w, ln_b, w_in, conv_k)

    @staticmethod
    def backward(ctx, g):
        return _native.recompute_vjp(prologue_ref, ctx.saved_tensors, ctx.needs_input_grad, g)
