"""Shared building blocks, channels-last (B, H, W, C).

Port of ``tramba_tpu/nn/layers.py``.  Parameter names follow the reference
PyTorch modules (``Models/modules.py``, ``Models/vmamba.py``), so reference
state dicts load as they are.  Eval only: DropPath is the identity and is
left out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.ops.fused_expand import expand_ln, final_head, pixel_shuffle

__all__ = [
    "LayerNorm",
    "conv_nhwc",
    "Mlp",
    "DWConv",
    "DWMSMlp",
    "PatchExpand",
    "FreqExpand2D",
    "FinalPatchExpandX4",
    "pixel_shuffle",
]


def LayerNorm(dim: int) -> nn.LayerNorm:
    """LayerNorm over the channel axis with torch's eps, 1e-5."""
    return nn.LayerNorm(dim, eps=1e-5)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor; returns NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (modules.py:134-153)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DWConv(nn.Module):
    """Depthwise k x k conv with SAME padding (vmamba.py:595-603)."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.dw_conv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)

    def forward(self, x):
        return conv_nhwc(self.dw_conv, x)


class DWMSMlp(nn.Module):
    """Multi-scale depthwise FFN: fc1 -> h + dw3 + dw5 + dw7 -> GELU -> fc2
    (vmamba.py:606-629)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwc3 = DWConv(hidden, 3)
        self.dwc5 = DWConv(hidden, 5)
        self.dwc7 = DWConv(hidden, 7)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = self.fc1(x)
        h = h + self.dwc3(h) + self.dwc5(h) + self.dwc7(h)
        return self.fc2(F.gelu(h))


class _Expand(nn.Module):
    """Dense dim -> factor*dim (no bias), x2 pixel shuffle, LayerNorm: kernel K3."""

    def __init__(self, dim: int, factor: int):
        super().__init__()
        self.expand = nn.Linear(dim, factor * dim, bias=False)
        self.norm = LayerNorm(factor * dim // 4)

    def forward(self, x):
        return expand_ln(x.contiguous(), self.expand.weight, self.norm.weight, self.norm.bias)


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
        seg16 = final_head(x.contiguous(), self.expand.weight, self.norm.weight,
                           self.norm.bias, seg.weight.reshape(C), seg.bias)
        seg16 = seg16.reshape(B, h, w, 4, 4, 1).permute(0, 1, 3, 2, 4, 5)
        return seg16.reshape(B, 4 * h, 4 * w, 1)
