"""Reference checkpoints -> the port's state-dict entries, with no detour.

The port's own copy of what it needs from
``tramba_tpu/compat/torch_weights.py``: the weightless buffers a strict load
drops (``_IGNORABLE``, ``_ignorable``), and the graft of an upstream VMamba
classification checkpoint onto the encoder.  The port keeps the reference's
key names, so the graft is a key surgery on the checkpoint itself
(``load_pretrained_Base``, vmamba.py:707-732): drop ``classifier.*``, move
``layers.{i}.downsample.*`` to ``downsample.{i}.*``, keep the encoder's keys
under ``vssm_encoder.``.  As the JAX package's converter, it is strict: a
missing encoder weight or a leftover key that is not a weightless buffer
raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["graft_vmamba_encoder"]

# torch buffers / profiler bookkeeping that carry no learned weights, plus
# the reference's precomputed DCT cosine bases (DCT_2D.py:37-45), which the
# port computes (ops/dct.py) and never loads
_IGNORABLE = (
    "attn_mask", "relative_position_index", "num_batches_tracked",
    "total_ops", "total_params", "rope", "DCT2D",
)


def _ignorable(key: str, patterns) -> bool:
    """Match patterns against dotted key COMPONENTS (a pattern is a dotted
    component sequence; the final component may be a prefix, for indexed
    buffers like ``attn_mask0``) — not bare substring containment, so a
    learned parameter merely containing e.g. 'rope' inside a longer name is
    still surfaced by the strict leftover check."""
    parts = key.split(".")
    for p in patterns:
        pp = p.split(".")
        n = len(pp)
        for i in range(len(parts) - n + 1):
            seg = parts[i : i + n]
            if all(a == b or (j == n - 1 and a.startswith(b))
                   for j, (a, b) in enumerate(zip(seg, pp))):
                return True
    return False


def _encoder_keys(depths: Sequence[int]):
    """(required, optional) encoder keys of a VMamba checkpoint: a Linear's
    or Conv's bias is read where present, a LayerNorm's is required."""
    req, opt = [], []

    def linear(prefix):
        req.append(f"{prefix}.weight")
        opt.append(f"{prefix}.bias")

    def norm(prefix):
        req.extend((f"{prefix}.weight", f"{prefix}.bias"))

    linear("patch_embed.0")
    norm("patch_embed.2")
    linear("patch_embed.5")
    norm("patch_embed.7")
    for s, depth in enumerate(depths):
        for d in range(depth):
            b = f"layers.{s}.blocks.{d}"
            norm(f"{b}.norm")
            norm(f"{b}.norm2")
            for name in ("in_proj", "conv2d", "out_proj"):
                linear(f"{b}.op.{name}")
            req.extend(f"{b}.op.{name}" for name in ("x_proj_weight", "dt_projs_weight",
                                                     "dt_projs_bias", "A_logs", "Ds"))
            norm(f"{b}.op.out_norm")
            linear(f"{b}.mlp.fc1")
            linear(f"{b}.mlp.fc2")
        if s < len(depths) - 1:
            linear(f"downsample.{s}.1")
            norm(f"downsample.{s}.3")
    return req, opt


def graft_vmamba_encoder(ckpt_model: Mapping, depths: Sequence[int] = (2, 2, 15, 2)
                         ) -> Dict[str, torch.Tensor]:
    """Upstream VMamba ``ckpt['model']`` -> ``{"vssm_encoder.<key>": fp32
    CPU tensor}`` for an encoder of ``depths``."""
    sd = {}
    for k, v in ckpt_model.items():
        if "classifier" in k:
            continue
        m = re.match(r"layers\.(\d+)\.downsample\.(.*)", k)
        if m:
            k = f"downsample.{m.group(1)}.{m.group(2)}"
        sd[k] = v
    req, opt = _encoder_keys(depths)
    missing = [k for k in req if k not in sd]
    if missing:
        raise KeyError(f"VMamba checkpoint lacks {len(missing)} encoder weights, e.g. "
                       f"{missing[:5]}")
    wanted = set(req) | {k for k in opt if k in sd}
    left = [k for k in sd if k not in wanted and not _ignorable(k, _IGNORABLE)]
    if left:
        raise ValueError(f"converter left {len(left)} reference parameters unconsumed "
                         f"(first 10): {sorted(left)[:10]}")
    out = {}
    for k in sorted(wanted):
        v = sd[k]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        out[f"vssm_encoder.{k}"] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out
