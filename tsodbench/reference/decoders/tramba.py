"""Decoder ``tramba``: Tramba's DFVSS guides and Helix-SS2D stages
(Trambav6.py), shared by Tramba-V and -S.  A part of the plain reference
(``model.part``)."""

from __future__ import annotations

import numpy as np
import torch

from tsodbench.reference import model as ref


def decode(ctx, P, cfg, skips):
    """Three stages of PatchExpand, guide, concat-dense and two Helix blocks,
    each with a 1x1 head, then the x4 expand and its head: 4 logit maps."""
    depths = cfg["dec_depths"]
    rates = np.linspace(cfg["dec_drop_path"], 0, 6)
    base = cfg["img_size"] // 16
    x, outs, i = skips[-1], [], 0
    for s in range(3):
        x = ref.expand(ctx, P, f"decoder.expand_layers.{s}.", x, 2)
        mid = ref.freq_block(ctx, P, f"decoder.guide_layers.{s}.", skips[-(s + 2)],
                             ref.window_for(base * 2 ** s))
        x = ref.linear(ctx, torch.cat([x, mid], dim=-1),
                       P[f"decoder.concat_back_dim.{s}.weight"],
                       P[f"decoder.concat_back_dim.{s}.bias"])
        for d in range(depths[s]):
            pre = f"decoder.stage_layers.{s}.blocks.{d}."
            r = float(rates[i]) if i < len(rates) else 0.0
            i += 1
            y = ref.ss2d(ctx, P, pre + "op.", x, "line", 0, ln=pre + "norm1")
            x = x + ref.drop(ctx, y, r)
            y = ref.dwms_mlp(ctx, P, pre + "mlp.", ref.layer_norm(P, pre + "norm2", x))
            x = x + ref.drop(ctx, y, r)
        seg = f"decoder.seg_layers.{s}."
        outs.append(ref.linear(ctx, x, P[seg + "weight"].reshape(1, -1), P[seg + "bias"]))
    e = ref.expand(ctx, P, "decoder.expand_layers.3.", x, 4)
    outs.append(ref.linear(ctx, e, P["decoder.seg_layers.3.weight"].reshape(1, -1),
                           P["decoder.seg_layers.3.bias"]))
    return outs


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of the decoder's parameters, under the reference state
    dict's names."""
    dims = cfg["dims"]
    chans = [dims * 2 ** i for i in range(4)]
    S = {}
    d = "decoder."
    for s in range(3):
        cs, c = chans[-(s + 1)], chans[-(s + 2)]
        S.update({f"{d}expand_layers.{s}.expand.weight": (2 * cs, cs),
                  **ref.norm_shapes(f"{d}expand_layers.{s}.norm", cs // 2)})
    S.update({f"{d}expand_layers.3.expand.weight": (16 * dims, dims),
              **ref.norm_shapes(f"{d}expand_layers.3.norm", dims)})
    for s in range(3):
        c = chans[-(s + 2)]
        g = f"{d}guide_layers.{s}."
        S.update({**ref.norm_shapes(g + "norm1", c), **ref.norm_shapes(g + "norm2", c),
                  **ref.mlp_shapes(g + "mlp.", c)})
        for band in ("h", "l"):
            S.update({f"{g}attn.{band}_expand.expand.weight": (4 * c, c),
                      **ref.norm_shapes(f"{g}attn.{band}_expand.norm", c),
                      **ref.ss2d_shapes(f"{g}attn.{band}_ssm.", c, 4)})
        S[g + "attn.concat_back_dim.weight"] = (c, 2 * c)
    for s in range(3):
        cs, c = chans[-(s + 1)], chans[-(s + 2)]
        S.update(ref.dense_shapes(f"{d}concat_back_dim.{s}", c, cs // 2 + c))
        for b in range(cfg["dec_depths"][s]):
            pre = f"{d}stage_layers.{s}.blocks.{b}."
            S.update({**ref.norm_shapes(pre + "norm1", c), **ref.ss2d_shapes(pre + "op.", c, 8),
                      **ref.norm_shapes(pre + "norm2", c),
                      **ref.mlp_shapes(pre + "mlp.", c, dwms=True)})
        S.update({f"{d}seg_layers.{s}.weight": (1, c, 1, 1), f"{d}seg_layers.{s}.bias": (1,)})
    S.update({f"{d}seg_layers.3.weight": (1, dims, 1, 1), f"{d}seg_layers.3.bias": (1,)})
    return S
