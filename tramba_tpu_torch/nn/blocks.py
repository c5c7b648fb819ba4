"""Residual VSSM blocks, channels-last.

Port of ``tramba_tpu/nn/blocks.py``: ``VSSBlock`` (encoder, raster SS2D +
MLP; vmamba.py:327-396) and ``MultiScaleDecoderBlock`` (decoder, Helix SS2D
with K=8 line scans + the multi-scale depthwise FFN; vmamba.py:632-704).
"""

from __future__ import annotations

import torch.nn as nn

from tramba_tpu_torch.nn.layers import DWMSMlp, LayerNorm, Mlp
from tramba_tpu_torch.nn.ssm import SS2D

__all__ = ["ffn_branch", "VSSBlock", "MultiScaleDecoderBlock"]


def ffn_branch(dim: int, mlp_ratio: float = 4.0, kind: str = "plain") -> nn.Module:
    """The block FFN applied after its pre-norm: ``plain`` (Mlp) or ``dwms``
    (DWMSMlp), hidden width ``dim * mlp_ratio`` (blocks.py:99)."""
    hidden = int(dim * mlp_ratio)
    if kind == "plain":
        return Mlp(dim, hidden)
    if kind == "dwms":
        return DWMSMlp(dim, hidden)
    raise ValueError(f"unknown FFN kind {kind!r}")


class VSSBlock(nn.Module):
    """x + SS2D(LN(x)); x + Mlp(LN(x))."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="raster", k_group=4)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "plain")

    def forward(self, x):
        x = x + self.op(x, ln=(self.norm.weight, self.norm.bias))
        return x + self.mlp(self.norm2(x))


class MultiScaleDecoderBlock(nn.Module):
    """x + HelixSS2D(LN(x)); x + DWMSMlp(LN(x))."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="line", k_group=8)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "dwms")

    def forward(self, x):
        x = x + self.op(x, ln=(self.norm1.weight, self.norm1.bias))
        return x + self.mlp(self.norm2(x))
