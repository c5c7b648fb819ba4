"""flax Tramba-V / -S / -P / -R variables -> reference PyTorch state dict.

The exact inverse of ``tramba_tpu/compat/torch_weights.convert_tramba_v``
and, for Swin-B, PVTv2-b4 and ResNet-50, of ``convert_tramba_enc`` (its
``convert_swin_encoder`` :350, ``convert_pvt_encoder`` :320 and
``convert_resnet_encoder`` :298, whose ``batch_stats`` become the
BatchNorms' running statistics; numpy only, importable without jax):
``convert_tramba_v(params_from_jax(p))`` and
``convert_tramba_enc(params_from_jax(p), enc)`` give ``p`` back leaf for
leaf.  The result loads into the port's ``TrambaV`` / ``TrambaEnc`` with
``strict=True``, so both packages can run the same weights.

Layout rules (inverse of torch_weights.py:7-13): Dense kernel (in, out) ->
Linear weight (out, in); Conv kernel (kh, kw, in/g, out) -> Conv2d weight
(out, in/g, kh, kw); LayerNorm and BatchNorm scale/bias -> weight/bias,
BatchNorm mean/var -> running_mean/running_var; SS2D A_logs (K, D, N) ->
(K*D, N) and Ds (K, D) -> (K*D,).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "encoder_from_jax", "pvt_encoder_from_jax",
           "swin_encoder_from_jax", "resnet_encoder_from_jax", "ss2d_from_jax", "ss2d_to_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ss2d(sd, prefix, p):
    """Any SS2D configuration: A_logs (K, D, N) of any d_state, the optional
    in_proj and conv2d biases, no conv2d for d_conv 1, and JAX's
    ``out_proj_bias`` as ``out_proj.bias`` (the reference's name)."""
    _linear(sd, f"{prefix}.in_proj", p["in_proj"])
    if "conv2d" in p:
        _conv(sd, f"{prefix}.conv2d", p["conv2d"])
    for name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias"):
        sd[f"{prefix}.{name}"] = _t(p[name])
    K, D, N = np.shape(p["A_logs"])
    sd[f"{prefix}.A_logs"] = _t(np.reshape(p["A_logs"], (K * D, N)))
    sd[f"{prefix}.Ds"] = _t(np.reshape(p["Ds"], (K * D,)))
    _ln(sd, f"{prefix}.out_norm", p["out_norm"])
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])
    if "out_proj_bias" in p:
        sd[f"{prefix}.out_proj.bias"] = _t(p["out_proj_bias"])


def ss2d_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax SS2D variables -> the port's SS2D state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _ss2d(sd, "m", variables.get("params", variables))
    return {k[2:]: v for k, v in sd.items()}


def ss2d_to_jax(sd: Mapping[str, torch.Tensor], k_group: int) -> dict:
    """The port's SS2D state dict -> flax SS2D params: the inverse of
    :func:`ss2d_from_jax` (JAX's ``convert_tramba_v`` covers the SS2Ds of
    the models, which have neither biases nor d_state > 1)."""
    n = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    KD, N = n["A_logs"].shape
    p = {"in_proj": {"kernel": n["in_proj.weight"].T},
         "x_proj_weight": n["x_proj_weight"], "dt_projs_weight": n["dt_projs_weight"],
         "dt_projs_bias": n["dt_projs_bias"],
         "A_logs": n["A_logs"].reshape(k_group, KD // k_group, N),
         "Ds": n["Ds"].reshape(k_group, KD // k_group),
         "out_norm": {"scale": n["out_norm.weight"], "bias": n["out_norm.bias"]},
         "out_proj": {"kernel": n["out_proj.weight"].T}}
    if "in_proj.bias" in n:
        p["in_proj"]["bias"] = n["in_proj.bias"]
    if "conv2d.weight" in n:
        p["conv2d"] = {"kernel": n["conv2d.weight"].transpose(2, 3, 1, 0)}
        if "conv2d.bias" in n:
            p["conv2d"]["bias"] = n["conv2d.bias"]
    if "out_proj.bias" in n:
        p["out_proj_bias"] = n["out_proj.bias"]
    return p


def _mlp(sd, prefix, p):
    _linear(sd, f"{prefix}.fc1", p["fc1"])
    _linear(sd, f"{prefix}.fc2", p["fc2"])
    for k in (3, 5, 7):
        if f"dwc{k}" in p:
            _conv(sd, f"{prefix}.dwc{k}.dw_conv", p[f"dwc{k}"]["Conv_0"])


def _expand(sd, prefix, p):
    _linear(sd, f"{prefix}.expand", p["expand"])
    _ln(sd, f"{prefix}.norm", p["norm"])


def _block(sd, prefix, p):
    for norm in ("norm", "norm1", "norm2"):
        if norm in p:
            _ln(sd, f"{prefix}.{norm}", p[norm])
    _ss2d(sd, f"{prefix}.op", p["op"])
    _mlp(sd, f"{prefix}.mlp", p["mlp"])


def _freq_block(sd, prefix, p):
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    a = p["attn"]
    for name in ("h_expand", "l_expand"):
        _expand(sd, f"{prefix}.attn.{name}", a[name])
    for name in ("h_ssm", "l_ssm"):
        _ss2d(sd, f"{prefix}.attn.{name}", a[name])
    _linear(sd, f"{prefix}.attn.concat_back_dim", a["concat_back_dim"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])
    _mlp(sd, f"{prefix}.mlp", p["mlp"])


def _indexed(tree: Mapping, pattern: str):
    """Sorted (ints..., value) for the keys of ``tree`` matching ``pattern``."""
    out = []
    for k, v in tree.items():
        m = re.fullmatch(pattern, k)
        if m:
            out.append(tuple(int(g) for g in m.groups()) + (v,))
    return sorted(out, key=lambda t: t[:-1])


def encoder_from_jax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """flax VSSM encoder tree (what ``convert_vmamba_encoder_pretrained``
    returns) -> the port's ``vssm_encoder.*`` state-dict entries."""
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in ((0, "patch_embed_conv1"), (5, "patch_embed_conv2")):
        _conv(sd, f"vssm_encoder.patch_embed.{idx}", enc[name])
    for idx, name in ((2, "patch_embed_norm1"), (7, "patch_embed_norm2")):
        _ln(sd, f"vssm_encoder.patch_embed.{idx}", enc[name])
    for s, d, blk in _indexed(enc, r"layers_(\d+)_block_(\d+)"):
        _block(sd, f"vssm_encoder.layers.{s}.blocks.{d}", blk)
    for s, conv in _indexed(enc, r"downsample_(\d+)_conv"):
        _conv(sd, f"vssm_encoder.downsample.{s}.1", conv)
        _ln(sd, f"vssm_encoder.downsample.{s}.3", enc[f"downsample_{s}_norm"])
    return sd


def pvt_encoder_from_jax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """flax PVTv2 encoder tree -> the port's ``encoder.*`` entries (inverse of
    ``convert_pvt_encoder``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, pe in _indexed(enc, r"patch_embed(\d+)"):
        _conv(sd, f"encoder.patch_embed{i}.proj", pe)
        _ln(sd, f"encoder.patch_embed{i}.norm", enc[f"patch_norm{i}"])
    for i, d, blk in _indexed(enc, r"block(\d+)_(\d+)"):
        b = f"encoder.block{i}.{d}"
        a, m = blk["attn"], blk["mlp"]
        _ln(sd, f"{b}.norm1", blk["norm1"])
        for name in ("q", "kv", "proj"):
            _linear(sd, f"{b}.attn.{name}", a[name])
        if "sr" in a:
            _conv(sd, f"{b}.attn.sr", a["sr"])
            _ln(sd, f"{b}.attn.norm", a["norm"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _linear(sd, f"{b}.mlp.fc1", m["fc1"])
        _conv(sd, f"{b}.mlp.dwconv.dwconv", m["dwconv"])
        _linear(sd, f"{b}.mlp.fc2", m["fc2"])
    for i, n in _indexed(enc, r"norm(\d+)"):
        _ln(sd, f"encoder.norm{i}", n)
    return sd


def swin_encoder_from_jax(enc: Mapping) -> Dict[str, torch.Tensor]:
    """flax Swin encoder tree -> the port's ``encoder.*`` entries (inverse of
    ``convert_swin_encoder`` without its stage-4 blocks)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "encoder.patch_embed.proj", enc["patch_embed_proj"])
    _ln(sd, "encoder.patch_embed.norm", enc["patch_embed_norm"])
    for s, d, blk in _indexed(enc, r"layer(\d+)_block(\d+)"):
        b = f"encoder.layers.{s}.blocks.{d}"
        a = blk["attn"]
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _linear(sd, f"{b}.attn.qkv", a["qkv"])
        _linear(sd, f"{b}.attn.proj", a["proj"])
        sd[f"{b}.attn.relative_position_bias_table"] = _t(a["relative_position_bias_table"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _linear(sd, f"{b}.mlp.fc1", blk["mlp_fc1"])
        _linear(sd, f"{b}.mlp.fc2", blk["mlp_fc2"])
    for s, ds in _indexed(enc, r"layer(\d+)_downsample"):
        _ln(sd, f"encoder.layers.{s}.downsample.norm", ds["norm"])
        _linear(sd, f"encoder.layers.{s}.downsample.reduction", ds["reduction"])
    return sd


def resnet_encoder_from_jax(enc: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """flax ResNet-50 params and ``batch_stats`` trees -> the port's
    ``encoder.*`` entries under torchvision's names (inverse of
    ``convert_resnet_encoder``)."""
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, p, s):
        _ln(sd, prefix, p)
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])

    _conv(sd, "encoder.conv1", enc["conv1"])
    bn("encoder.bn1", enc["bn1"], stats["bn1"])
    for i, b, blk in _indexed(enc, r"layer(\d+)_(\d+)"):
        prefix, st = f"encoder.layer{i}.{b}", stats[f"layer{i}_{b}"]
        for n in (1, 2, 3):
            _conv(sd, f"{prefix}.conv{n}", blk[f"conv{n}"])
            bn(f"{prefix}.bn{n}", blk[f"bn{n}"], st[f"bn{n}"])
        if "downsample_conv" in blk:
            _conv(sd, f"{prefix}.downsample.0", blk["downsample_conv"])
            bn(f"{prefix}.downsample.1", blk["downsample_bn"], st["downsample_bn"])
    return sd


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax Tramba-V, Tramba-S, Tramba-P or Tramba-R variables ({"params":
    {...}[, "batch_stats": {...}]} or the params tree itself), leaves as
    numpy arrays -> reference state dict of fp32 CPU tensors.  Tramba-R's
    running statistics come from ``batch_stats``."""
    p = variables.get("params", variables)
    dec = p["decoder"]
    if "vssm_encoder" in p:
        sd = encoder_from_jax(p["vssm_encoder"])
    elif "patch_embed_proj" in p["encoder"]:
        sd = swin_encoder_from_jax(p["encoder"])
    elif "conv1" in p["encoder"]:
        sd = resnet_encoder_from_jax(p["encoder"], variables["batch_stats"]["encoder"])
    else:
        sd = pvt_encoder_from_jax(p["encoder"])
    for s, e in _indexed(dec, r"expand_(\d+)"):
        _expand(sd, f"decoder.expand_layers.{s}", e)
    for s, g in _indexed(dec, r"guide_(\d+)"):
        _freq_block(sd, f"decoder.guide_layers.{s}", g)
    for s, c in _indexed(dec, r"concat_back_dim_(\d+)"):
        _linear(sd, f"decoder.concat_back_dim.{s}", c)
    for s, d, blk in _indexed(dec, r"stage_(\d+)_block_(\d+)"):
        _block(sd, f"decoder.stage_layers.{s}.blocks.{d}", blk)
    for s, c in _indexed(dec, r"seg_(\d+)"):
        _conv(sd, f"decoder.seg_layers.{s}", c)
    return sd
