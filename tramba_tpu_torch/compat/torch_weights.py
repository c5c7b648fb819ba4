"""Reference checkpoints -> the port's state-dict entries, with no detour.

The port's own copy of what it needs from
``tramba_tpu/compat/torch_weights.py``: the weightless buffers a strict load
drops (``_IGNORABLE``, ``_ignorable``), and the grafts of the released
encoder checkpoints onto each model's encoder, the port's numpy-only
counterparts of ``convert_vmamba_encoder_pretrained``,
``convert_swin_encoder``, ``convert_pvt_encoder`` and
``convert_resnet_encoder`` (``:251-379``).  The port keeps the reference's
key names, so a graft is a key surgery on the checkpoint itself:

* VMamba (Tramba-V; ``load_pretrained_Base``, vmamba.py:707-732): drop
  ``classifier.*``, move ``layers.{i}.downsample.*`` to ``downsample.{i}.*``,
  keep the encoder's keys under ``vssm_encoder.``;
* Swin-B (Tramba-S): keep the keys under ``encoder.``, drop the classifier
  (``norm.*``, ``head.*``) and the stage-4 blocks, which never run
  (``load_checkpoint`` drops them too);
* PVTv2-b4 (Tramba-P): keep the keys under ``encoder.``, drop ``head.*``;
* ResNet-50 (Tramba-R, torchvision's names): keep the keys under
  ``encoder.``, the BatchNorms' running statistics with them, drop ``fc.*``
  and ``num_batches_tracked`` (flax keeps no count).

As the JAX package's converters, they are strict: a missing encoder weight
or a leftover key that is neither dropped above nor a weightless buffer
raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["graft_vmamba_encoder", "graft_swin_encoder", "graft_pvt_encoder",
           "graft_resnet_encoder", "upstream_encoder_state_dict"]

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


def _graft(what: str, sd: Mapping, req, opt, prefix: str, drop=()) -> Dict[str, torch.Tensor]:
    """``{prefix + key: fp32 CPU tensor}`` for the required keys ``req`` and
    those of ``opt`` that ``sd`` has.  Raises on a missing required key and
    on a leftover key that neither starts with one of ``drop`` (whole dotted
    components) nor is a weightless buffer."""
    missing = [k for k in req if k not in sd]
    if missing:
        raise KeyError(f"{what} checkpoint lacks {len(missing)} encoder weights, e.g. "
                       f"{missing[:5]}")
    wanted = set(req) | {k for k in opt if k in sd}
    left = [k for k in sd if k not in wanted and not _ignorable(k, _IGNORABLE)
            and not any(k == d or k.startswith(d + ".") for d in drop)]
    if left:
        raise ValueError(f"converter left {len(left)} reference parameters unconsumed "
                         f"(first 10): {sorted(left)[:10]}")
    out = {}
    for k in sorted(wanted):
        v = sd[k]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def _key_lists():
    """(req, opt, linear, norm): two lists and the helpers that fill them --
    a Linear's or Conv's weight is required and its bias read where present,
    a LayerNorm's weight and bias are required."""
    req, opt = [], []

    def linear(prefix):
        req.append(f"{prefix}.weight")
        opt.append(f"{prefix}.bias")

    def norm(prefix):
        req.extend((f"{prefix}.weight", f"{prefix}.bias"))

    return req, opt, linear, norm


def _encoder_keys(depths: Sequence[int]):
    """(required, optional) encoder keys of a VMamba checkpoint."""
    req, opt, linear, norm = _key_lists()
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
    return _graft("VMamba", sd, *_encoder_keys(depths), "vssm_encoder.")


def graft_swin_encoder(ckpt_model: Mapping, depths: Sequence[int] = (2, 2, 18, 2)
                       ) -> Dict[str, torch.Tensor]:
    """Upstream Swin-B ``ckpt['model']`` -> ``{"encoder.<key>": fp32 CPU
    tensor}`` for an encoder of ``depths``, without the stage-4 blocks
    (``convert_swin_encoder``, ``tramba_tpu/compat/torch_weights.py:350``)."""
    req, opt, linear, norm = _key_lists()
    linear("patch_embed.proj")
    norm("patch_embed.norm")
    for s in range(len(depths) - 1):
        for d in range(depths[s]):
            b = f"layers.{s}.blocks.{d}"
            norm(f"{b}.norm1")
            linear(f"{b}.attn.qkv")
            linear(f"{b}.attn.proj")
            req.append(f"{b}.attn.relative_position_bias_table")
            norm(f"{b}.norm2")
            linear(f"{b}.mlp.fc1")
            linear(f"{b}.mlp.fc2")
        norm(f"layers.{s}.downsample.norm")
        req.append(f"layers.{s}.downsample.reduction.weight")
    return _graft("Swin", ckpt_model, req, opt, "encoder.",
                  drop=(f"layers.{len(depths) - 1}.blocks", "norm", "head"))


def graft_pvt_encoder(ckpt_model: Mapping, depths: Sequence[int] = (3, 8, 27, 3)
                      ) -> Dict[str, torch.Tensor]:
    """Upstream PVTv2 ``state_dict`` -> ``{"encoder.<key>": fp32 CPU tensor}``
    for an encoder of ``depths`` (``convert_pvt_encoder``,
    ``tramba_tpu/compat/torch_weights.py:320``: a block's spatial-reduction
    conv and norm are read where present)."""
    req, opt, linear, norm = _key_lists()
    for i, depth in enumerate(depths, start=1):
        linear(f"patch_embed{i}.proj")
        norm(f"patch_embed{i}.norm")
        for d in range(depth):
            b = f"block{i}.{d}"
            norm(f"{b}.norm1")
            for name in ("q", "kv", "proj"):
                linear(f"{b}.attn.{name}")
            opt.extend(f"{b}.attn.{n}" for n in ("sr.weight", "sr.bias", "norm.weight",
                                                 "norm.bias"))
            norm(f"{b}.norm2")
            for name in ("fc1", "dwconv.dwconv", "fc2"):
                linear(f"{b}.mlp.{name}")
        norm(f"norm{i}")
    return _graft("PVTv2", ckpt_model, req, opt, "encoder.", drop=("head",))


def graft_resnet_encoder(ckpt_model: Mapping, layers: Sequence[int] = (3, 4, 6, 3)
                         ) -> Dict[str, torch.Tensor]:
    """torchvision ResNet-50 ``state_dict`` -> ``{"encoder.<key>": fp32 CPU
    tensor}`` for an encoder of ``layers`` bottlenecks per stage, the running
    statistics included (``convert_resnet_encoder``,
    ``tramba_tpu/compat/torch_weights.py:298``)."""
    req = []

    def bn(prefix):
        req.extend(f"{prefix}.{n}" for n in ("weight", "bias", "running_mean", "running_var"))

    req.append("conv1.weight")
    bn("bn1")
    for i, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            p = f"layer{i}.{b}"
            for n in (1, 2, 3):
                req.append(f"{p}.conv{n}.weight")
                bn(f"{p}.bn{n}")
            if b == 0:
                req.append(f"{p}.downsample.0.weight")
                bn(f"{p}.downsample.1")
    return _graft("ResNet", ckpt_model, req, (), "encoder.", drop=("fc",))


def upstream_encoder_state_dict(model: torch.nn.Module, classes: int = 10) -> dict:
    """The inverse of the Swin, PVTv2 and ResNet grafts: a Tramba-S, -P or
    -R ``model``'s encoder as its released checkpoint holds it -- the
    upstream key names (the port's without ``encoder.``) and what the graft
    has to drop: Swin-B's classifier (``norm``, ``head``), a stage-4 block
    and weightless buffers, all under ``model``; PVTv2's ``head``;
    torchvision's ``fc`` and a ``num_batches_tracked`` per BatchNorm.  The
    classifier is zero, with ``classes`` outputs.  Grafting the result gives
    back the encoder's weights exactly."""
    sd = {k[len("encoder."):]: v.detach().cpu().clone() for k, v in model.state_dict().items()
          if k.startswith("encoder.")}
    if model.enc_type == "swin":
        dim = model.encoder.layers[-1].downsample.reduction.out_features
        sd.update({"norm.weight": torch.ones(dim), "norm.bias": torch.zeros(dim),
                   "head.weight": torch.zeros(classes, dim), "head.bias": torch.zeros(classes),
                   f"layers.{len(model.encoder.layers)}.blocks.0.norm1.weight": torch.ones(dim),
                   "layers.0.blocks.1.attn_mask": torch.zeros(4, 16, 16),
                   "layers.0.blocks.0.attn.relative_position_index": torch.zeros(16, 16)})
        return {"model": sd}
    if model.enc_type == "pvt":
        dim = model.encoder.norm4.normalized_shape[0]
        return {**sd, "head.weight": torch.zeros(classes, dim), "head.bias": torch.zeros(classes)}
    sd.update({k[:-len("running_var")] + "num_batches_tracked": torch.tensor(100)
               for k in list(sd) if k.endswith("running_var")})
    return {**sd, "fc.weight": torch.zeros(classes, 2048), "fc.bias": torch.zeros(classes)}
