"""Residual VSSM blocks, channels-last.

Port of ``tramba_tpu/nn/blocks.py``: ``VSSBlock`` (encoder, raster SS2D +
MLP; vmamba.py:327-396), ``MultiScaleDecoderBlock`` (decoder, Helix SS2D
with K=8 line scans + the multi-scale depthwise FFN; vmamba.py:632-704) and
``VSSMDecoderBlock`` (BaseUMamba's decoder: an SS2D of any scan order, by
default the K=8 line order, + the plain MLP; blocks.py:199-230).
Each block hands its pre-norms to the branches: ``norm`` / ``norm1`` to the
SS2D, ``norm2`` to the FFN, which in bf16 fuse them into kernels K5 and
K6 / K7 (state-dict names unchanged).  Both residual branches pass a
``DropPath`` of the block's rate (``tramba_tpu/nn/blocks.py:157-160``,
``:192-195``, ``:226-229``), active in ``train()`` mode only.  ``ssm_backend`` and
``ssm_d_state`` go to the block's SS2D (``tramba_tpu/nn/blocks.py:133-191``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tramba_tpu_torch.nn.layers import DropPath, DWMSMlp, LayerNorm, Mlp
from tramba_tpu_torch.nn.ssm import SS2D

__all__ = ["ffn_branch", "VSSBlock", "MultiScaleDecoderBlock", "VSSMDecoderBlock"]


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
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0,
                 ssm_backend: Optional[str] = None, ssm_d_state: int = 1):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="raster", k_group=4, dtype=dtype,
                       d_state=ssm_d_state, backend=ssm_backend)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "plain", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.op(x, ln=(self.norm.weight, self.norm.bias)))
        return x + self.drop_path(self.mlp(x, self.norm2))


class MultiScaleDecoderBlock(nn.Module):
    """x + DropPath(HelixSS2D(LN(x))); x + DropPath(DWMSMlp(LN(x)))."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0,
                 ssm_backend: Optional[str] = None, ssm_d_state: int = 1):
        super().__init__()
        self.norm1 = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind="line", k_group=8, dtype=dtype,
                       d_state=ssm_d_state, backend=ssm_backend)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "dwms", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.op(x, ln=(self.norm1.weight, self.norm1.bias)))
        return x + self.drop_path(self.mlp(x, self.norm2))


class VSSMDecoderBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))); x + DropPath(Mlp(LN(x))), the SS2D over
    ``scan_kind`` (``scan_param``) in ``k_group`` directions."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0,
                 ssm_backend: Optional[str] = None, ssm_d_state: int = 1,
                 scan_kind: str = "line", scan_param: int = 0, k_group: int = 8):
        super().__init__()
        self.norm1 = LayerNorm(hidden_dim)
        self.op = SS2D(hidden_dim, scan_kind=scan_kind, scan_param=scan_param, k_group=k_group,
                       dtype=dtype, d_state=ssm_d_state, backend=ssm_backend)
        self.norm2 = LayerNorm(hidden_dim)
        self.mlp = ffn_branch(hidden_dim, mlp_ratio, "plain", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.op(x, ln=(self.norm1.weight, self.norm1.bias)))
        return x + self.drop_path(self.mlp(x, self.norm2))
