"""Work counts of a configuration, worked out from its architecture: never
from the program's launches, so the same work is counted whatever runs it.

* :func:`forward_flops`: FLOPs of one image's forward, fvcore's accounting
  (2MNK for every matrix product and convolution) plus 9 operations per
  scanned state element (the reference's ``selective_scan_flops``,
  csms6s.py:772-793), counted over the plain reference on the meta device.
* :func:`ss2d_calls`: every SS2D of a forward as (B, K, L, D, d_model, kind).
* :func:`ops`, :func:`bound`, :func:`k1_bound`, :func:`k8_bound`: the least
  time one H100 could take for a kernel call, from its shapes: each input
  read once and each output written once over the HBM rate, or its
  operations over the peak rate of the pipes that can run them, whichever
  is longer (the tensor cores and the fp32 pipes run side by side: the
  longest pipe's time, not the sum).  Peaks from NVIDIA's H100 SXM data
  sheet (dense).
"""

from __future__ import annotations

import functools
import json
import math

import numpy as np
import torch

from tsodbench.reference import model as ref
from tsodbench.reference import orders

PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
SCAN_CHUNK = 64  # steps between the states K1's train variant saves for K8
SIZE = {"bf16": 2, "fp32": 4}


def ops(tensor: float, simt: float) -> dict:
    """Operations of a call by the pipes that can run them: ``tensor`` on the
    tensor cores at their bf16 rate (a product whose fp32 operands split into
    bf16 terms is exact there, as K1's projection runs it), ``simt`` on the
    fp32 pipes."""
    return {"bf16": tensor, "fp32": simt}


def bound(nbytes: float, flops: dict) -> tuple:
    """(seconds, "bytes" or "operations") of a call that moves ``nbytes``
    and does ``flops`` (:func:`ops`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in flops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _core_bytes(K, D, R):
    """x_proj_w (K, R+2, D), dt_w (K, D, R), dt_b, A_logs, Ds (K, D): fp32."""
    return 4 * (K * (R + 2) * D + K * D * R + 3 * K * D)


def dt_rank(d_model: int) -> int:
    return math.ceil(d_model / 16)


def k1_bound(B, K, L, D, d_model, x_dtype="bf16") -> tuple:
    """K1 ``ss2d_scan``: x (B, L, D) and the gather table in, ys (B, K, L, D)
    fp32 out; the x projection (C = R + 2 outputs of D, 2nC) on the tensor
    cores; the rank-R dt projection (2nR: one output of R a step) and about
    12 fp32 operations a step of the recurrence per (b, k, l, d) on the fp32
    pipes."""
    R = dt_rank(d_model)
    C = R + 2
    n = B * K * L * D
    nbytes = SIZE[x_dtype] * B * L * D + 4 * K * L + _core_bytes(K, D, R) + 4 * n
    return bound(nbytes, ops(2 * n * C, 2 * n * R + 12 * n))


@functools.lru_cache(maxsize=None)
def slots(kind: str, res: int, param: int) -> int:
    """The most times one direction of ``kind`` visits a pixel of a res x res
    map: the inverse table's slots."""
    idx = orders.order(kind, res, res, param)
    return int(max(np.bincount(row, minlength=res * res).max() for row in idx))


def k8_bound(B, K, L, D, d_model, kind, param, x_dtype="bf16") -> tuple:
    """K8 ``ss2d_scan_bwd``: x, the tables, the cotangent of the merged sum,
    the carries and projections of K1's train variant and the parameters
    in; dx and the parameters' gradients out; K1's projections recomputed,
    their two adjoints and the weight products (three times K1's: the x
    projection's on the tensor cores, the dt projection's on the fp32 pipes),
    and about 30 fp32 operations a step."""
    R = dt_rank(d_model)
    C = R + 2
    n = B * K * L * D
    res = int(round(math.sqrt(L)))
    nbytes = (3 * SIZE[x_dtype] * B * L * D  # x, g_y, dx
              + 4 * K * L * (1 + slots(kind, res, param))  # idx, inv
              + 4 * B * K * -(-L // SCAN_CHUNK) * D  # carries
              + 4 * B * L * K * C  # dbc
              + 2 * _core_bytes(K, D, R))  # parameters and their gradients
    return bound(nbytes, ops(6 * n * C, 6 * n * R + 30 * n))


def _meta_forward(model_cfg: dict, B: int = 1):
    """One forward of the reference on the meta device, with its SS2D and
    dropped-branch calls recorded: (calls, FLOP counts by op)."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {n: torch.empty(s, device="meta") for n, s in ref.param_shapes(model_cfg).items()}
    x = torch.empty(B, model_cfg["img_size"], model_cfg["img_size"], 3, device="meta")
    calls = []
    with FlopCounterMode(display=False) as counter:
        ref.forward(ref.Ctx(calls=calls), P, model_cfg, x)
    return calls, counter.get_flop_counts().get("Global", {})


@functools.lru_cache(maxsize=None)
def _counts(key: str):
    model_cfg = json.loads(key)
    calls, flops = _meta_forward(model_cfg)
    ss2d = tuple(c[1:] for c in calls if c[0] == "ss2d")
    products = int(sum(flops.values()))
    scans = sum(9 * B * K * L * D for B, K, L, D, *_ in ss2d)
    rates = tuple(c[1] for c in calls if c[0] == "drop")
    return products, scans, ss2d, rates


def _key(model_cfg: dict) -> str:
    return json.dumps(model_cfg, sort_keys=True)


def forward_flops(model_cfg: dict) -> dict:
    """{"products", "scans", "total"}: FLOPs of one image's forward."""
    products, scans, _, _ = _counts(_key(model_cfg))
    return {"products": products, "scans": scans, "total": products + scans}


def ss2d_calls(model_cfg: dict, B: int) -> list:
    """Every SS2D of a forward at batch B: (B, K, L, D, d_model, kind, param)."""
    return [(B, *c[1:]) for c in _counts(_key(model_cfg))[2]]


def drop_rates(model_cfg: dict) -> tuple:
    """The rate of every branch that stochastic depth may drop, in the
    order a training forward draws them (rate 0 draws nothing)."""
    return _counts(_key(model_cfg))[3]


def k1_bound_per_forward(model_cfg: dict, B: int) -> float:
    return sum(k1_bound(*c[:5])[0] for c in ss2d_calls(model_cfg, B))


def k8_bound_per_step(model_cfg: dict, B: int) -> float:
    return sum(k8_bound(*c)[0] for c in ss2d_calls(model_cfg, B))
