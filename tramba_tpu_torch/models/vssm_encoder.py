"""VMamba-B encoder, channels-last.

Port of ``tramba_tpu/models/vssm_encoder.py`` (reference
``Models/vmamba.py:399-518``): a stem of two stride-2 3x3 convs (padding 1)
with LayerNorms and a GELU between, stages of VSSBlocks, and a stride-2 conv
+ LN downsample between stages.  Stochastic depth rises linearly from 0
to ``drop_path_rate`` over the blocks (``vssm_encoder.py:35``).  Module names follow the reference state
dict (``patch_embed.{0,2,5,7}``, ``layers.{s}.blocks.{d}``,
``downsample.{s}.{1,3}``).  The stem and downsample convs and LayerNorms run
in the input's dtype (cuDNN and torch ops, outside the kernels, as JAX runs
them outside Pallas); the blocks take the model dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.nn.blocks import VSSBlock
from tramba_tpu_torch.nn.layers import LayerNorm, conv_nhwc

__all__ = ["VSSMEncoder"]


class _Stage(nn.Module):
    def __init__(self, blocks: List[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class VSSMEncoder(nn.Module):
    def __init__(self, depths: Sequence[int] = (2, 2, 15, 2), dims: int = 128,
                 dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.6,
                 ssm_backend: Optional[str] = None):
        super().__init__()
        widths = [dims * 2 ** i for i in range(len(depths))]
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.patch_embed = nn.ModuleDict({
            "0": nn.Conv2d(3, widths[0] // 2, 3, stride=2, padding=1),
            "2": LayerNorm(widths[0] // 2),
            "5": nn.Conv2d(widths[0] // 2, widths[0], 3, stride=2, padding=1),
            "7": LayerNorm(widths[0]),
        })
        self.layers = nn.ModuleList(
            _Stage([VSSBlock(w, dtype=dtype, drop_path=float(dpr[sum(depths[:s]) + i]),
                             ssm_backend=ssm_backend)
                    for i in range(d)])
            for s, (w, d) in enumerate(zip(widths, depths)))
        self.downsample = nn.ModuleList(
            nn.ModuleDict({"1": nn.Conv2d(w, 2 * w, 3, stride=2, padding=1),
                           "3": LayerNorm(2 * w)})
            for w in widths[:-1])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> [x, f1 (H/4, C), f2 (H/8, 2C), f3 (H/16, 4C), f4 (H/32, 8C)]."""
        pe = self.patch_embed
        h = F.gelu(pe["2"](conv_nhwc(pe["0"], x)))
        h = pe["7"](conv_nhwc(pe["5"], h))
        skips = [x]
        for s, stage in enumerate(self.layers):
            h = stage(h)
            skips.append(h)
            if s < len(self.downsample):
                ds = self.downsample[s]
                h = ds["3"](conv_nhwc(ds["1"], h))
        return skips
