"""Shared building blocks, channels-last (B, H, W, C).

Port of ``tramba_tpu/nn/layers.py``.  Parameter names follow the reference
PyTorch modules (``Models/modules.py``, ``Models/vmamba.py``), so reference
state dicts load as they are.  Eval only: DropPath is the identity and is
left out.

Compute dtype: parameters stay fp32 whatever the model's dtype, as flax
keeps them; a module running in bf16 casts each matmul or conv weight at its
use (flax's ``w.astype(dtype)``), and LayerNorm computes in fp32 and returns
the input's dtype.  The FFNs take a ``dtype`` and in bf16 run kernels K6
(``Mlp``) and K7 (``DWMSMlp``) with the block's pre-norm fused in.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.ops import fused_mlp
from tramba_tpu_torch.ops.fused_expand import expand_ln, final_head, pixel_shuffle

__all__ = [
    "COMPUTE_DTYPES",
    "LayerNorm",
    "check_dtype",
    "conv_nhwc",
    "Mlp",
    "DWConv",
    "DWMSMlp",
    "PatchExpand",
    "FreqExpand2D",
    "FinalPatchExpandX4",
    "pixel_shuffle",
]


# the model dtypes the port runs: fp32, and bf16 (the kernels K5-K7 path)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype} is not supported; use one of {COMPUTE_DTYPES}")
    return dtype


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the channel axis with torch's eps, 1e-5: fp32 parameters
    and statistics, output in the input's dtype (flax ``LayerNorm(dtype=...)``)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor in x's dtype (weight and
    bias cast at use); returns NHWC."""
    b = conv.bias
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 None if b is None else b.to(x.dtype), conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return y.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """The block FFN with its pre-norm: LN -> fc1 -> exact GELU -> fc2
    (modules.py:134-153).  bf16: kernel K6 ``ln_mlp``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, norm: nn.LayerNorm):
        if self.dtype == torch.bfloat16:
            cd = self.dtype
            return fused_mlp.ln_mlp(x, norm.weight, norm.bias, self.fc1.weight.to(cd),
                                    self.fc1.bias, self.fc2.weight.to(cd), self.fc2.bias)
        return self.fc2(F.gelu(self.fc1(norm(x))))


class DWConv(nn.Module):
    """Depthwise k x k conv with SAME padding (vmamba.py:595-603)."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.dw_conv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)

    def forward(self, x):
        return conv_nhwc(self.dw_conv, x)


class DWMSMlp(nn.Module):
    """Multi-scale depthwise FFN with its pre-norm: LN -> fc1 -> h + dw3 + dw5
    + dw7 -> GELU -> fc2 (vmamba.py:606-629).  bf16: kernel K7
    ``ln_dwms_mlp``."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.fc1 = nn.Linear(dim, hidden)
        self.dwc3 = DWConv(hidden, 3)
        self.dwc5 = DWConv(hidden, 5)
        self.dwc7 = DWConv(hidden, 7)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, norm: nn.LayerNorm):
        if self.dtype == torch.bfloat16:
            cd = self.dtype
            convs = [t for m in (self.dwc3, self.dwc5, self.dwc7)
                     for t in (m.dw_conv.weight.to(cd), m.dw_conv.bias)]
            return fused_mlp.ln_dwms_mlp(x, norm.weight, norm.bias, self.fc1.weight.to(cd),
                                         self.fc1.bias, *convs, self.fc2.weight.to(cd),
                                         self.fc2.bias)
        h = self.fc1(norm(x))
        h = h + self.dwc3(h) + self.dwc5(h) + self.dwc7(h)
        return self.fc2(F.gelu(h))


class _Expand(nn.Module):
    """Dense dim -> factor*dim (no bias), x2 pixel shuffle, LayerNorm: kernel K3."""

    def __init__(self, dim: int, factor: int):
        super().__init__()
        self.expand = nn.Linear(dim, factor * dim, bias=False)
        self.norm = LayerNorm(factor * dim // 4)

    def forward(self, x):
        return expand_ln(x.contiguous(), self.expand.weight.to(x.dtype), self.norm.weight,
                         self.norm.bias)


class PatchExpand(_Expand):
    """x2 upsample, dim -> dim/2 channels (modules.py:183-221)."""

    def __init__(self, dim: int):
        super().__init__(dim, 2)


class FreqExpand2D(_Expand):
    """DFVSS x2 upsample, dim -> dim channels (modules.py:678-696)."""

    def __init__(self, dim: int):
        super().__init__(dim, 4)


class FinalPatchExpandX4(nn.Module):
    """x4 upsample (Dense dim -> 16dim, pixel shuffle, LN; modules.py:224-274)
    fused with the 1x1 seg conv that follows it: kernel K4 computes the 16
    logits of each coarse pixel, and they are laid out as its 4 x 4 patch."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x, seg: nn.Conv2d):
        B, h, w, C = x.shape
        seg16 = final_head(x.contiguous(), self.expand.weight.to(x.dtype), self.norm.weight,
                           self.norm.bias, seg.weight.reshape(C), seg.bias)
        seg16 = seg16.reshape(B, h, w, 4, 4, 1).permute(0, 1, 3, 2, 4, 5)
        return seg16.reshape(B, 4 * h, 4 * w, 1)
