"""Weights and inputs drawn from ``--seed``, on the run's device, in a few
large calls: the same seed gives the same tensors on the same kind of card.

Weights are at fan-in scale, so that every product matters to the output
(with the std-0.02 init a wrong kernel can hide inside a tolerance):
products' weights N(0, 1 / fan_in), biases (LayerNorm shifts among them)
N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.2^2), Swin's relative-position bias
table N(0, 1).  An SS2D keeps its reference init where the scan's stability needs
it: dt bias = softplus^-1 of a log-uniform dt in [1e-3, 0.1], A_log = 0,
D = 1 (mamba_init.py:19-48), its projections N(0, 1 / fan_in).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

FAN_IN_LAST = ("x_proj_weight", "dt_projs_weight")  # (K, out, in) stacks


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("A_logs", "Ds", "dt_projs_bias"):
        return leaf
    if leaf in FAN_IN_LAST:
        return "stack"
    if leaf == "relative_position_bias_table":
        return "table"
    if leaf == "bias":
        return "bias"
    if len(shape) == 1:
        return "norm"
    return "weight"


def draw(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 tensors for every name of ``shapes`` (a state dict's names and
    shapes, in order)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        kind = _kind(name, shape)
        if kind == "stack":
            t = z / math.sqrt(shape[-1])
        elif kind == "weight":
            t = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "bias":
            t = 0.1 * z
        elif kind == "norm":
            t = 1.0 + 0.2 * z
        elif kind == "table":
            t = z
        elif kind == "dt_projs_bias":
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        elif kind == "A_logs":
            t = torch.zeros_like(z)
        else:  # Ds
            t = torch.ones_like(z)
        out[name] = t.contiguous()
    return out


def images(B: int, size: int, seed: int, device, pool: int) -> torch.Tensor:
    """``pool`` batches of B normalised RGB frames (B, size, size, 3), fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(pool, B, size, size, 3, generator=gen, device=device)


def masks(B: int, size: int, seed: int, device, pool: int) -> torch.Tensor:
    """``pool`` batches of binary masks of smooth random blobs (B, size, size, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(pool * B, 1, size, size, generator=gen, device=device)
    blobs = torch.nn.functional.avg_pool2d(noise, 31, stride=1, padding=15)
    return (blobs > 0).float().reshape(pool, B, 1, size, size).permute(0, 1, 3, 4, 2)
