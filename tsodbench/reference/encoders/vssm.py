"""Encoder ``vssm``: VMamba-B of Tramba-V (vmamba.py:399-518), its stages of
raster SS2D and MLP blocks.  A part of the plain reference (``model.part``)."""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from tsodbench.reference import model as ref


def encode(ctx, P, cfg, x):
    """VMamba-B (vmamba.py:399-518): conv stem, stages of raster SS2D + MLP
    blocks, conv + LN downsamples.  Returns [x, the four stage outputs]."""
    e = "vssm_encoder."
    depths = cfg["enc_depths"]
    rates = np.linspace(0, cfg["enc_drop_path"], sum(depths))
    h = ref.conv(ctx, x, P[e + "patch_embed.0.weight"], P[e + "patch_embed.0.bias"], 2, 1)
    h = F.gelu(ref.layer_norm(P, e + "patch_embed.2", h))
    h = ref.conv(ctx, h, P[e + "patch_embed.5.weight"], P[e + "patch_embed.5.bias"], 2, 1)
    h = ref.layer_norm(P, e + "patch_embed.7", h)
    skips, i = [x], 0
    for s, depth in enumerate(depths):
        for d in range(depth):
            pre = f"{e}layers.{s}.blocks.{d}."
            r = float(rates[i])
            i += 1
            y = ref.ss2d(ctx, P, pre + "op.", h, "raster", 0, ln=pre + "norm")
            h = h + ref.drop(ctx, y, r)
            y = ref.mlp(ctx, P, pre + "mlp.", ref.layer_norm(P, pre + "norm2", h))
            h = h + ref.drop(ctx, y, r)
        skips.append(h)
        if s < len(depths) - 1:
            ds = f"{e}downsample.{s}."
            h = ref.conv(ctx, h, P[ds + "1.weight"], P[ds + "1.bias"], 2, 1)
            h = ref.layer_norm(P, ds + "3", h)
    return skips


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of the encoder's parameters, under the reference state
    dict's names."""
    dims = cfg["dims"]
    chans = [dims * 2 ** i for i in range(4)]
    S = {}
    e = "vssm_encoder."
    S.update({e + "patch_embed.0.weight": (dims // 2, 3, 3, 3),
              e + "patch_embed.0.bias": (dims // 2,),
              **ref.norm_shapes(e + "patch_embed.2", dims // 2),
              e + "patch_embed.5.weight": (dims, dims // 2, 3, 3),
              e + "patch_embed.5.bias": (dims,), **ref.norm_shapes(e + "patch_embed.7", dims)})
    for s, depth in enumerate(cfg["enc_depths"]):
        c = chans[s]
        for d in range(depth):
            pre = f"{e}layers.{s}.blocks.{d}."
            S.update({**ref.norm_shapes(pre + "norm", c), **ref.ss2d_shapes(pre + "op.", c, 4),
                      **ref.norm_shapes(pre + "norm2", c), **ref.mlp_shapes(pre + "mlp.", c)})
        if s < 3:
            ds = f"{e}downsample.{s}."
            S.update({ds + "1.weight": (2 * c, c, 3, 3), ds + "1.bias": (2 * c,),
                      **ref.norm_shapes(ds + "3", 2 * c)})
    return S
