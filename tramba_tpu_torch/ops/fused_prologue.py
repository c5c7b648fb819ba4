"""SS2D prologue of the bf16 path: kernel K5 ``prologue``.

Port of ``tramba_tpu/ops/fused_prologue.py`` ``_prologue_pallas`` (:94,
kernel :57), which is also the front of ``_small_pallas``
(``fused_ss2d_small.py:103-131``): (LayerNorm ->) in_proj -> depthwise 3x3
-> SiLU, in ``csrc/prologue.cu``.  The LayerNorm is optional: the encoder and
decoder SS2Ds fold their block's pre-norm in, the DFVSS guide SS2Ds have
none (``fused_prologue.py:162``).

Rounding points of the TPU kernel: the LN output is rounded to bf16, the
in-projection (bf16 weight) accumulates in fp32 and stays fp32, the 3x3 taps
are rounded to bf16 and applied in fp32, and the SiLU output is rounded to
bf16.  The conv pads the in-projection, so a pixel outside the image adds 0.
The plain version rounds at the same points, in ``x``'s dtype.  The wrapper
picks by device and counts launches in ``prologue.launches``.  Weights are
in torch layout: in_proj (D, dm), conv (D, 1, 3, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, check_args, on_card
from tramba_tpu_torch.ops.fused_mlp import _linear, _ln_rounded, layer_norm_bf16

__all__ = ["prologue", "prologue_ref"]


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
    """Kernel K5 on CUDA tensors, :func:`prologue_ref` on CPU tensors."""
    if not on_card(x):
        return prologue_ref(x, ln_w, ln_b, w_in, conv_k)
    B, H, W, dm = x.shape
    D = w_in.shape[0]
    check_args(x=(x, BF16), w_in=(w_in, BF16), conv_k=(conv_k, BF16))
    if (ln_w is None) != (ln_b is None):
        raise ValueError("prologue: give both LN parameters or neither")
    if dm % 16 or D % 16 or tuple(w_in.shape) != (D, dm) or tuple(conv_k.shape) != (D, 1, 3, 3):
        raise ValueError(f"prologue: dm={dm} and D={D} must be multiples of 16, "
                         "w_in (D, dm), conv_k (D, 1, 3, 3)")
    y = x if ln_w is None else layer_norm_bf16(x, ln_w, ln_b)
    out = torch.empty(B, H, W, D, device=x.device, dtype=torch.bfloat16)
    _native.launch("prologue_launch", y.data_ptr(), w_in.data_ptr(), conv_k.data_ptr(),
                   out.data_ptr(), B, H, W, dm, D, _native.stream_handle(x))
    prologue.launches += 1
    return out


prologue.launches = 0
