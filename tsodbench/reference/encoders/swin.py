"""Encoder ``swin``: Swin-B of Tramba-S (swin_encoder.py), stages 1-3 of
(shifted) window attention.  A part of the plain reference (``model.part``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from tsodbench.reference import model as ref


@functools.lru_cache(maxsize=None)
def _rel_index(w, device):
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return torch.from_numpy(rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]).to(device)


@functools.lru_cache(maxsize=None)
def _shift_mask(res, w, s, device):
    img = np.zeros((res, res))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(res // w, w, res // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    m = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(m != 0, -100.0, 0.0)).float().to(device)


def _windows(x, w):
    B, H, W, C = x.shape
    return x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_attention(ctx, P, pre, y, heads, w, shift):
    """W-MSA with the relative-position bias, on an LN'd, rolled map."""
    B, H, W, C = y.shape
    N, hd = w * w, C // heads
    qkv = ref.linear(ctx, _windows(y, w), P[pre + "qkv.weight"], P[pre + "qkv.bias"])
    q, k, v = qkv.reshape(-1, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    attn = (ref.operand(ctx, q * hd ** -0.5) @ ref.operand(ctx, k).transpose(-1, -2))
    bias = P[pre + "relative_position_bias_table"][_rel_index(w, str(y.device))]
    attn = attn + bias.permute(2, 0, 1)[None]
    if shift:
        mask = _shift_mask(H, w, shift, str(y.device))
        attn = (attn.reshape(B, -1, heads, N, N) + mask[None, :, None]).reshape(-1, heads, N, N)
    o = ref.operand(ctx, torch.softmax(attn, dim=-1)) @ ref.operand(ctx, v)
    o = o.transpose(1, 2).reshape(-1, N, C)
    o = ref.linear(ctx, o, P[pre + "proj.weight"], P[pre + "proj.bias"])
    return o.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def encode(ctx, P, cfg, x):
    """Swin-B (swin_encoder.py): 4x4 patch embed + LN, stages 1-3 of
    (shifted) window attention and MLP blocks with PatchMerging.  Returns
    [x, the four stage inputs]; stage 4 feeds nothing and is not run."""
    e = "encoder."
    depths, heads, w0 = cfg["enc_depths"], cfg["num_heads"], cfg["window"]
    rates = np.linspace(0, cfg["enc_drop_path"], sum(depths))
    h = ref.conv(ctx, x, P[e + "patch_embed.proj.weight"], P[e + "patch_embed.proj.bias"], 4)
    h = ref.layer_norm(P, e + "patch_embed.norm", h)
    skips, i = [x], 0
    for s in range(len(depths) - 1):
        skips.append(h)
        res, C = h.shape[1], h.shape[-1]
        for d in range(depths[s]):
            pre = f"{e}layers.{s}.blocks.{d}."
            w, shift = (w0, 0 if d % 2 == 0 else w0 // 2) if res > w0 else (res, 0)
            r = float(rates[i])
            i += 1
            y = ref.layer_norm(P, pre + "norm1", h)
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            y = window_attention(ctx, P, pre + "attn.", y, heads[s], w, shift)
            if shift:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            h = h + ref.drop(ctx, y, r)
            y = ref.mlp(ctx, P, pre + "mlp.", ref.layer_norm(P, pre + "norm2", h))
            h = h + ref.drop(ctx, y, r)
        parts = [h[:, 0::2, 0::2], h[:, 1::2, 0::2], h[:, 0::2, 1::2], h[:, 1::2, 1::2]]
        ds = f"{e}layers.{s}.downsample."
        h = ref.linear(ctx, ref.layer_norm(P, ds + "norm", torch.cat(parts, dim=-1)),
                       P[ds + "reduction.weight"])
    skips.append(h)
    return skips


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of the encoder's parameters, under the reference state
    dict's names."""
    dims = cfg["dims"]
    chans = [dims * 2 ** i for i in range(4)]
    S = {}
    e = "encoder."
    S.update({e + "patch_embed.proj.weight": (dims, 3, 4, 4),
              e + "patch_embed.proj.bias": (dims,),
              **ref.norm_shapes(e + "patch_embed.norm", dims)})
    res = cfg["img_size"] // 4
    for s in range(3):
        c = chans[s]
        w = min(cfg["window"], res)
        for d in range(cfg["enc_depths"][s]):
            pre = f"{e}layers.{s}.blocks.{d}."
            S.update({**ref.norm_shapes(pre + "norm1", c),
                      **ref.dense_shapes(pre + "attn.qkv", 3 * c, c),
                      **ref.dense_shapes(pre + "attn.proj", c, c),
                      pre + "attn.relative_position_bias_table": ((2 * w - 1) ** 2,
                                                                 cfg["num_heads"][s]),
                      **ref.norm_shapes(pre + "norm2", c), **ref.mlp_shapes(pre + "mlp.", c)})
        S.update({**ref.norm_shapes(f"{e}layers.{s}.downsample.norm", 4 * c),
                  f"{e}layers.{s}.downsample.reduction.weight": (2 * c, 4 * c)})
        res //= 2
    return S
