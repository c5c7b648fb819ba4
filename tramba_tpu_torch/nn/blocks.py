"""Residual VSSM blocks, channels-last.

Port of ``tramba_tpu/nn/blocks.py``: ``VSSBlock`` (encoder, raster SS2D +
MLP; vmamba.py:327-396) and ``MultiScaleDecoderBlock`` (decoder, Helix SS2D
with K=8 line scans + the multi-scale depthwise FFN; vmamba.py:632-704).
Each block hands its pre-norms to the branches: ``norm`` / ``norm1`` to the
SS2D, ``norm2`` to the FFN, which in bf16 fuse them into kernels K5 and
K6 / K7 (state-dict names unchanged).  Both residual branches pass a
``DropPath`` of the block's rate (``tramba_tpu/nn/blocks.py:157-160``,
``:192-195``), active in ``train()`` mode only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tramba_tpu_torch.nn.layers import DropPath, DWMSMlp, LayerNorm, Mlp
from tramba_tpu_torch.nn.ssm import SS2D

__all__ = ["ffn_branch", "VSSBlock", "MultiScaleDecoderBlock"]


def ffn_branch(dim: int, mlp_ratio: float = 4.0, kind: str = "plain",
               dtype: torch.dtype = torch.float32) -> nn.Module:
    """The block FFN, called with its pre-norm (``mlp(x, norm2)``): ``plain``
    (Mlp; K6 in bf16) or ``dwms`` (DWMSMlp; K7 in bf16), hidden width
    ``dim * mlp_ratio`` (blocks.py:99)."""
    hidden = int(dim * mlp_ratio)
    if kind == "plain":
        return Mlp(dim, hidden, dtype)
    if kind == "dwms":
        return DWMSMlp(dim, hidden, dtype)
    raise ValueError(f"unknown FFN kind {kind!r}")


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))); x + DropPath(Mlp(LN(x)))."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="raster", k_group=4, dtype=dtype)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "plain", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.op(x, ln=(self.norm.weight, self.norm.bias)))
        return x + self.drop_path(self.mlp(x, self.norm2))


class MultiScaleDecoderBlock(nn.Module):
    """x + DropPath(HelixSS2D(LN(x))); x + DropPath(DWMSMlp(LN(x)))."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="line", k_group=8, dtype=dtype)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "dwms", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.op(x, ln=(self.norm1.weight, self.norm1.bias)))
        return x + self.drop_path(self.mlp(x, self.norm2))
