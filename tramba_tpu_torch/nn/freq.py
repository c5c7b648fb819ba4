"""Dual-Frequency Visual State Space (DFVSS) skip guides, channels-last.

Port of ``tramba_tpu/nn/freq.py:38-117`` (reference ``freq_mamba.py``): 2-D
DCT quadrants -> FreqExpand2D back to full resolution -> a ``window`` SS2D
on the high band and a ``dilation`` SS2D on the low band -> concat-dense ->
sigmoid gate on the input.  The DCT and the gate run in the model dtype
(``nn/freq.py:54-57``); in bf16 the guide SS2Ds run kernel K5 without a
LayerNorm, and the FFN kernel K6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tramba_tpu_torch.nn.blocks import ffn_branch
from tramba_tpu_torch.nn.layers import DropPath, FreqExpand2D, LayerNorm
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops.dct import dct2d_quadrants

__all__ = ["FreqSS2D", "FreqBlock"]


class FreqSS2D(nn.Module):
    """``window``: high-band window size (from the resolution);
    ``dilation``: low-band dilation rate."""

    def __init__(self, dim: int, window: int, dilation: int = 4,
                 dtype: torch.dtype = torch.float32, ssm_backend: Optional[str] = None):
        super().__init__()
        self.dim = dim
        self.h_expand = FreqExpand2D(dim)
        self.l_expand = FreqExpand2D(dim)
        self.h_ssm = SS2D(dim, k_group=4, scan_kind="window", scan_param=window, dtype=dtype,
                          backend=ssm_backend)
        self.l_ssm = SS2D(dim, k_group=4, scan_kind="dilation", scan_param=dilation,
                          dtype=dtype, backend=ssm_backend)
        self.concat_back_dim = nn.Linear(2 * dim, dim, bias=False)

    def forward(self, x):
        high, low = dct2d_quadrants(x)
        h_out = self.h_ssm(self.h_expand(high))
        l_out = self.l_ssm(self.l_expand(low))
        # concat + dense as two products on the weight's halves: the
        # (B, H, W, 2C) concat never materializes
        w = self.concat_back_dim.weight.to(x.dtype)
        attn = h_out @ w[:, : self.dim].t() + l_out @ w[:, self.dim:].t()
        return torch.sigmoid(attn) * x


class FreqBlock(nn.Module):
    """x + DropPath(FreqSS2D(LN(x))); x + DropPath(Mlp(LN(x)))
    (freq_mamba.py:60-82; ``tramba_tpu/nn/freq.py:112-116``).  The decoder
    builds its guides with rate 0, as the JAX package does.  ``ssm_backend``
    goes to both SS2Ds (``tramba_tpu/nn/freq.py:49-108``)."""

    def __init__(self, dim: int, window: int, dilation: int = 4, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0,
                 ssm_backend: Optional[str] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = FreqSS2D(dim, window, dilation, dtype, ssm_backend)
        self.norm2 = LayerNorm(dim)
        self.mlp = ffn_branch(dim, mlp_ratio, "plain", dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(x, self.norm2))
