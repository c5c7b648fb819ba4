"""PVTv2 encoder, channels-last: the encoder of Tramba-P.

Port of ``tramba_tpu/models/pvt.py:65-237`` (reference
``Models/encoder/pvtv2_encoder.py``): overlapping patch embeds (7/4, then
3/2) with a LayerNorm (eps 1e-5), blocks of spatial-reduction attention and
a depthwise-conv FFN with pre-norms of eps 1e-6, a LayerNorm (eps 1e-6)
after each stage; the four stage maps come back deepest-first.
``pvt_v2_b4_config`` is the port's own copy of ``pvt.py:195``.

Routing follows the JAX package's on a TPU, block by block:

* bf16, where ``fused_attn.sra_fusable`` holds (every 384 px stage): the
  block's pre-norm, q, the attention and the out projection run kernel K12
  ``sra``; the reduced keys and values come from the composed path outside
  it (fp32 LN rounded to bf16 -> sr conv -> LN eps 1e-5 -> kv), as
  ``pvt.py:94-108`` computes them.
* bf16, where ``fused_mlp.dwmlp_fusable`` holds (stages 1-3): the pre-norm
  and the FFN run kernel K11 ``ln_dwmlp``.  Stage 4 (12 px, W % 8 != 0) runs
  the composed bf16 LayerNorm and DWConvMlp (``pvt.py:189-190``).
* fp32: every part composed, in plain PyTorch, as JAX runs it off the TPU
  and in fp32.

The composed parts round as flax's modules do in the compute dtype
(``nn.layers.flax_dense`` / ``flax_conv``).  Module names follow the
reference state dict (``patch_embed{i}.proj``, ``block{i}.{d}.attn.sr``,
``block{i}.{d}.mlp.dwconv.dwconv``, ``norm{i}``).  Stochastic depth rises
from 0 to ``drop_path_rate`` over the blocks, active in ``train()`` mode
only.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.nn.layers import DropPath, LayerNorm, LecunConv2d, flax_conv, flax_dense
from tramba_tpu_torch.ops import fused_attn, fused_mlp

__all__ = ["PVTv2Encoder", "PVTBlock", "SRAttention", "DWConvMlp", "pvt_v2_b4_config"]


def pvt_v2_b4_config() -> dict:
    """PVTv2-b4 (pvtv2_encoder.py:433-438; ``tramba_tpu/models/pvt.py:195``)."""
    return dict(embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                depths=(3, 8, 27, 3), sr_ratios=(8, 4, 2, 1), drop_path_rate=0.1)


class SRAttention(nn.Module):
    """Spatial-reduction attention (pvtv2_encoder.py:57-116), called with the
    block's pre-norm, which it applies itself (K12 fuses it)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            # flax's SAME padding is none for a stride equal to the kernel on
            # a map the ratio divides
            self.sr = LecunConv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim)

    def forward(self, x, H: int, W: int, norm1: LayerNorm):
        """x (B, N, C) in the compute dtype, the block's input."""
        B, N, C = x.shape
        cd, nh = x.dtype, self.num_heads
        hd = C // nh
        xn = norm1(x)
        if self.sr_ratio > 1:
            xr = flax_conv(self.sr, xn.reshape(B, H, W, C), cd).reshape(B, -1, C)
            xr = self.norm(xr)
        else:
            xr = xn
        kv = flax_dense(self.kv, xr, cd).reshape(B, -1, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        if fused_attn.sra_fusable(N, C, nh, k.shape[2], cd):
            return fused_attn.sra(x, norm1.weight, norm1.bias, self.q.weight, self.q.bias, k, v,
                                  self.proj.weight, self.proj.bias, nh, norm1.eps)
        q = flax_dense(self.q, xn, cd).reshape(B, N, nh, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return flax_dense(self.proj, out, cd)


class _DWConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dwconv = LecunConv2d(hidden, hidden, 3, padding=1, groups=hidden)


class DWConvMlp(nn.Module):
    """fc1 -> depthwise 3x3 -> exact GELU -> fc2 (pvtv2_encoder.py:19-54),
    called with the block's pre-norm: kernel K11 where ``dwmlp_fusable``
    holds, else composed."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = _DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, H: int, W: int, norm2: LayerNorm):
        B, N, C = x.shape
        cd, hid = x.dtype, self.fc1.out_features
        conv = self.dwconv.dwconv
        if fused_mlp.dwmlp_fusable(H, W, C, hid, cd):
            y = fused_mlp.ln_dwmlp(x.reshape(B, H, W, C), norm2.weight, norm2.bias, self.fc1.weight,
                                   self.fc1.bias, conv.weight, conv.bias, self.fc2.weight,
                                   self.fc2.bias, norm2.eps)
            return y.reshape(B, N, C)
        h = flax_dense(self.fc1, norm2(x), cd).reshape(B, H, W, hid)
        h = flax_conv(conv, h, cd).reshape(B, N, hid)
        return flax_dense(self.fc2, F.gelu(h), cd)


class PVTBlock(nn.Module):
    """x + DropPath(SRA(LN(x))); x + DropPath(DWConvMlp(LN(x)))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, sr_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = DWConvMlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, H: int, W: int):
        x = x + self.drop_path(self.attn(x, H, W, self.norm1))
        return x + self.drop_path(self.mlp(x, H, W, self.norm2))


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = LecunConv2d(cin, dim, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(dim)


class PVTv2Encoder(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 depths: Sequence[int] = (3, 8, 27, 3), sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 drop_path_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_stages = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cin = 3
        for s, (dim, depth) in enumerate(zip(embed_dims, depths)):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            setattr(self, f"patch_embed{s + 1}", _PatchEmbed(cin, dim, patch, stride))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                PVTBlock(dim, num_heads[s], mlp_ratios[s], sr_ratios[s],
                         float(dpr[sum(depths[:s]) + d])) for d in range(depth)))
            setattr(self, f"norm{s + 1}", LayerNorm(dim, eps=1e-6))
            cin = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> the four stage maps (B, h, w, C), deepest first."""
        outs = []
        for s in range(1, self.n_stages + 1):
            pe = getattr(self, f"patch_embed{s}")
            x = flax_conv(pe.proj, x, self.dtype)
            B, H, W, C = x.shape
            h = pe.norm(x.reshape(B, H * W, C))
            for blk in getattr(self, f"block{s}"):
                h = blk(h, H, W)
            x = getattr(self, f"norm{s}")(h).reshape(B, H, W, C)
            outs.append(x)
        return outs[::-1]
