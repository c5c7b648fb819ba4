"""Swin Transformer encoder, channels-last: the encoder of Tramba-S.

Port of ``tramba_tpu/models/swin.py:89-260`` (reference
``Models/encoder/swin_encoder.py``): a 4x4 patch embed with a LayerNorm,
stages of window attention with a relative-position bias (shifted windows
with a static mask on odd blocks) and an LN + MLP, and PatchMerging between
stages.  Tramba consumes each stage's *input* and discards the stage-4
output, so the stage-4 blocks are never built or run
(``run_last_stage=False``, ``swin.py:242``).  Where a stage's map is no
larger than the window, the window is the map and nothing is shifted
(``swin.py:151-152``).  ``relative_position_index``, ``shift_attn_mask`` and
``swin_b_384_config`` are the port's own copies of ``swin.py:49-74`` and
``:210``.

Routing follows the JAX package's on a TPU: in bf16, where
``fused_attn.window_attn_fusable`` holds (every stage at 384 px), the
block's pre-norm, qkv, the attention and the out projection run kernel K13
``window_attn`` on the rolled map; the FFN with its pre-norm runs kernel K6
(``nn.layers.Mlp``).  In fp32 every part is composed, in plain PyTorch.  The
cyclic shift (``torch.roll``), the gather of the bias table and the residual
stay outside the kernel, as in JAX.  Module names follow the reference state
dict (``patch_embed.proj``, ``layers.{s}.blocks.{d}.attn.qkv``,
``...attn.relative_position_bias_table``, ``layers.{s}.downsample.reduction``).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from tramba_tpu_torch.nn.layers import DropPath, LayerNorm, LecunConv2d, Mlp, flax_conv, flax_dense
from tramba_tpu_torch.ops import fused_attn

__all__ = ["SwinEncoder", "SwinBlock", "WindowAttention", "PatchMerging", "swin_b_384_config",
           "relative_position_index", "shift_attn_mask"]


def swin_b_384_config() -> dict:
    """Swin-B at 384 px (Trambav6_enc.py:169-175; ``tramba_tpu/models/swin.py:210``)."""
    return dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=12,
                drop_path_rate=0.1)


@functools.lru_cache(maxsize=None)
def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 bias table (swin_encoder.py:96-106)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))  # 2, w, w
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # N, N, 2
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask for shifted windows (swin_encoder.py:211-230)."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // window, window, W // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    B = windows.shape[0] // ((H // w) * (W // w))
    x = windows.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("_index", torch.from_numpy(
            relative_position_index(window).reshape(-1).astype(np.int64)), persistent=False)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        """The bias table: truncated normal, std 0.02 (``nn.init.init_weights``
        draws qkv and proj)."""
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    def bias(self) -> torch.Tensor:
        """(nh, N, N) fp32 relative-position bias, gathered from the table."""
        N = self.window ** 2
        return self.relative_position_bias_table[self._index].reshape(N, N, -1).permute(2, 0, 1)

    def composed(self, y, mask, dtype):
        """The unfused path on the LN'd (B, H, W, C) map: as flax, the fp32
        bias promotes the bf16 scores, so the softmax and p v run in fp32."""
        B, H, W, C = y.shape
        w, nh = self.window, self.num_heads
        hd, N = C // nh, w * w
        win = window_partition(y, w)
        qkv = flax_dense(self.qkv, win, dtype).reshape(-1, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = (q @ k.transpose(-1, -2)).float() + self.bias()[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(-1, nW, nh, N, N) + mask[None, :, None]).reshape(-1, nh, N, N)
        out = (torch.softmax(attn, dim=-1) @ v.float()).transpose(1, 2).reshape(-1, N, C)
        return window_reverse(flax_dense(self.proj, out, dtype), w, H, W)


class SwinBlock(nn.Module):
    """x + DropPath(W-MSA(LN(x))) on the (cyclically shifted) map;
    x + DropPath(Mlp(LN(x)))."""

    def __init__(self, dim: int, resolution: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolution <= window:
            window, shift = resolution, 0
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.drop_path = DropPath(drop_path)
        mask = shift_attn_mask(resolution, resolution, window, shift) if shift > 0 else None
        self.register_buffer("_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def forward(self, x):
        """x (B, L, C), L = resolution**2."""
        B, L, C = x.shape
        H = W = self.resolution
        s, a = self.shift, self.attn
        y = x.reshape(B, H, W, C)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        if fused_attn.window_attn_fusable(H, W, C, a.num_heads, self.window, x.dtype):
            y = fused_attn.window_attn(y, self.norm1.weight, self.norm1.bias, a.qkv.weight,
                                       a.qkv.bias, a.bias(), self._mask, a.proj.weight,
                                       a.proj.bias, a.num_heads, self.norm1.eps)
        else:
            y = a.composed(self.norm1(y), self._mask, x.dtype)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + self.drop_path(y.reshape(B, L, C))
        return x + self.drop_path(self.mlp(x, self.norm2))


class PatchMerging(nn.Module):
    """LN(4C) then Dense(4C -> 2C) on 2x2 neighbourhoods (swin_encoder.py:294-331)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        xr = x.reshape(B, H, W, C)
        parts = [xr[:, 0::2, 0::2], xr[:, 1::2, 0::2], xr[:, 0::2, 1::2], xr[:, 1::2, 1::2]]
        y = torch.cat(parts, dim=-1).reshape(B, L // 4, 4 * C)
        return flax_dense(self.reduction, self.norm(y), x.dtype)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = LecunConv2d(3, dim, patch, stride=patch)
        self.norm = LayerNorm(dim)


class _Layer(nn.Module):
    def __init__(self, blocks: List[nn.Module], downsample: nn.Module):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinEncoder(nn.Module):
    """Stages 1-3 run, stage 4's input is the last skip."""

    def __init__(self, img_size: int = 384, patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (4, 8, 16, 32),
                 window: int = 12, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.img_size = img_size
        self.patch_embed = _PatchEmbed(embed_dim, patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        res, dim, layers = img_size // patch_size, embed_dim, []
        for s in range(len(depths) - 1):
            blocks = [SwinBlock(dim, res, num_heads[s], window, 0 if d % 2 == 0 else window // 2,
                                drop_path=float(dpr[sum(depths[:s]) + d]), dtype=dtype)
                      for d in range(depths[s])]
            layers.append(_Layer(blocks, PatchMerging(dim)))
            res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, img, img, 3) -> the four stage inputs (B, h, w, C), shallow first."""
        if x.shape[1:3] != (self.img_size, self.img_size):
            raise ValueError(f"SwinEncoder built for {self.img_size} px, got {tuple(x.shape)}")
        x = flax_conv(self.patch_embed.proj, x, self.dtype)
        B, res, _, dim = x.shape
        h = self.patch_embed.norm(x.reshape(B, res * res, dim))
        skips = []
        for layer in self.layers:
            skips.append(h.reshape(B, res, res, dim))
            for blk in layer.blocks:
                h = blk(h)
            h = layer.downsample(h, res, res)
            res, dim = res // 2, dim * 2
        skips.append(h.reshape(B, res, res, dim))
        return skips
