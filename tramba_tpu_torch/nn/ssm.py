"""SS2D: the 2-D selective-scan operator, channels-last.

Port of ``tramba_tpu/nn/ssm.py:133-301``.  Parameters stay fp32 and keep the
reference's stacked (K, ...) layout and names (``Models/vmamba.py:87-112``):
A_logs (K*D, N), Ds (K*D), ``out_proj.bias`` where JAX has ``out_proj_bias``.
The kernels' wrappers take them as they are and cast to the compute dtype.

Routes, chosen as ``SS2D.__call__`` chooses them (:158-262):

* default (``backend=None``, d_state 1, no out bias, and a dilation rate
  that divides L; ``use_folded``, :237-243): the scan is kernel K1 over the
  order's gather table and the merge, LayerNorm, exact GELU and out
  projection are kernel K2 (``ops/fused_ss2d.py``).  In front of them, in
  bf16 with a 3x3 depthwise conv and no conv bias, kernel K5 ``prologue``
  (``ops/fused_prologue.py``) runs the optional pre-norm, in_proj, the conv
  and SiLU, as ``_prologue_pallas`` and the front of ``_small_pallas`` do on
  a TPU; otherwise they are plain torch, as JAX runs them outside Pallas.
  Under autograd the same kernels run with their backwards (K5's recomputed
  VJP, K8).  Every scan order takes this route through its gather and
  inverse tables: JAX's TPU routing folds only raster / line / dilation /
  window and sends the spiral, Hilbert, diagonal, ``line4`` and ablation
  orders to ``fused_ss2d_core`` (ssm.py:256-291; Pallas ``_fused_pallas`` /
  ``_seq_bwd_pallas``, ``fused_ss2d.py:101`` / ``:747``), whose cross scan,
  core, cross merge, LayerNorm, GELU and projection are the same function.
* composed (any other configuration, or ``backend="seq_parallel"``, :279-300):
  cross scan -> the composed core (d_state 1) or the selective scan (d_state
  > 1), whose recurrence is kernel K14 ``linear_scan`` on the card -> cross
  merge -> LayerNorm (1e-5) -> exact GELU -> out_proj (+ its bias).  With
  ``"seq_parallel"`` the recurrence is the sequence-parallel scan over the
  ambient group (``parallel/seq_scan.py``).
* ``backend="tensor_parallel"``: d_inner sharded over the ambient model
  group (``parallel/tp.py``), the same parameters.
* ``backend="hybrid_tp_sp"``: per SS2D by its own L (:80-100): the
  sequence-parallel route where L reaches the sequence group's ``min_l`` and
  divides over it, else the tensor-parallel one.

JAX's ``"assoc"``, ``"seq"``, ``"fake"`` and ``"pallas"`` spellings choose a
TPU or debugging implementation of the same function and have no meaning in
the port (README, "What has no meaning in the port").
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.nn.layers import LayerNorm, check_dtype, flax_conv, flax_dense
from tramba_tpu_torch.ops import fused_prologue
from tramba_tpu_torch.ops.fused_ss2d import composed_ss2d_core, ss2d_full
from tramba_tpu_torch.ops.scan_orders import cross_merge, cross_scan
from tramba_tpu_torch.ops.selective_scan import dt_projection, linear_scan, selective_scan
from tramba_tpu_torch.parallel import seq_scan
from tramba_tpu_torch.parallel.tp import ss2d_tensor_parallel

__all__ = ["SS2D", "BACKENDS"]

BACKENDS = (None, "tensor_parallel", "seq_parallel", "hybrid_tp_sp")


def _resolve_hybrid_backend(L: int) -> str:
    """``hybrid_tp_sp``: the sequence-parallel route for an SS2D whose L
    reaches the ambient sequence group's ``min_l`` and divides over it, the
    tensor-parallel route for the rest (``_resolve_hybrid_backend``,
    ssm.py:80-100)."""
    cur = seq_scan.sequence_group_or_none()
    if cur is not None:
        axis, min_l = cur
        if L >= min_l and L % axis.size == 0:
            return "seq_parallel"
    return "tensor_parallel"


class SS2D(nn.Module):
    def __init__(self, d_model: int, ssm_ratio: float = 2.0, k_group: int = 4,
                 scan_kind: str = "raster", scan_param: int = 0,
                 dtype: torch.dtype = torch.float32, d_state: int = 1, bias: bool = False,
                 conv_bias: bool = False, d_conv: int = 3, backend: Optional[str] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"SS2D backend {backend!r} has no meaning in the port; use one "
                             f"of {BACKENDS} (ROADMAP.md Queue 1 item 8; README.md, 'What has "
                             "no meaning in the port')")
        if d_conv < 1 or d_conv % 2 == 0:
            raise ValueError(f"d_conv {d_conv}: the port takes odd depthwise conv sizes")
        self.dtype = check_dtype(dtype)
        self.d_model = d_model
        self.d_inner = D = int(ssm_ratio * d_model)
        self.dt_rank = R = math.ceil(d_model / 16)
        self.k_group = K = k_group
        self.d_state = N = d_state
        self.scan_kind = scan_kind
        self.scan_param = scan_param
        self.bias, self.conv_bias, self.d_conv = bias, conv_bias, d_conv
        self.backend = backend
        self.in_proj = nn.Linear(d_model, D, bias=bias)
        self.conv2d = (nn.Conv2d(D, D, d_conv, padding=(d_conv - 1) // 2, groups=D,
                                 bias=conv_bias) if d_conv > 1 else None)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.zeros(K * D, N))
        self.Ds = nn.Parameter(torch.ones(K * D))
        self.out_norm = LayerNorm(D)
        self.out_proj = nn.Linear(D, d_model, bias=bias)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator,
                             dt_min: float = 0.001, dt_max: float = 0.1,
                             dt_floor: float = 1e-4) -> None:
        """The reference's SS2D init (mamba_init.py:19-48): U(+-1/sqrt(fan_in))
        projections, dt bias = softplus^-1 of a log-uniform dt, A_log[:, n] =
        log(n + 1), D = 1."""
        D, R = self.d_inner, self.dt_rank
        nn.init.uniform_(self.x_proj_weight, -D ** -0.5, D ** -0.5, generator=generator)
        nn.init.uniform_(self.dt_projs_weight, -R ** -0.5, R ** -0.5, generator=generator)
        u = torch.rand(self.dt_projs_bias.shape, generator=generator)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = dt.clamp(min=dt_floor)
        self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_logs.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                          .expand_as(self.A_logs))
        self.Ds.fill_(1.0)

    def _core_params(self):
        K, D = self.k_group, self.d_inner
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias,
                self.A_logs.view(K, D, self.d_state), self.Ds.view(K, D))

    def _folded(self, L: int) -> bool:
        """Where JAX's TPU routing runs its direction-folded kernels
        (``use_folded``, ssm.py:237-243): K1 and K2 here."""
        return (self.d_state == 1 and not self.bias
                and not (self.scan_kind == "dilation" and L % (self.scan_param or 4)))

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        """x (B, H, W, d_model).  ``ln``: the block's pre-norm (weight, bias),
        applied first when given."""
        B, H, W, _ = x.shape
        backend = self.backend
        if backend == "hybrid_tp_sp":
            backend = _resolve_hybrid_backend(H * W)
        if backend == "tensor_parallel":
            if self.d_state != 1 or self.bias or self.conv_bias or self.d_conv != 3:
                raise ValueError("tensor_parallel supports the live SS2D configuration only "
                                 "(d_state 1, no in/out or conv bias, 3x3 depthwise conv)")
            return ss2d_tensor_parallel(x, ln, self.in_proj.weight, self.conv2d.weight,
                                        *self._core_params(), self.out_norm.weight,
                                        self.out_norm.bias, self.out_proj.weight,
                                        self.scan_kind, H, W, self.scan_param)
        if backend == "seq_parallel":
            return self._composed(x, ln, seq_scan.sequence_parallel_linear_scan)
        if not self._folded(H * W):
            return self._composed(x, ln, linear_scan)
        if self.dtype == torch.bfloat16 and self.d_conv == 3 and not self.conv_bias:
            ln_w, ln_b = ln if ln is not None else (None, None)
            x = fused_prologue.prologue(x, ln_w, ln_b, self.in_proj.weight, self.conv2d.weight)
        else:
            x = self._prologue(x, ln)
        D = self.d_inner
        y = ss2d_full(x.reshape(B, H * W, D).contiguous(), *self._core_params(),
                      self.out_norm.weight, self.out_norm.bias, self.out_proj.weight,
                      self.scan_kind, H, W, self.scan_param)
        return y.reshape(B, H, W, self.d_model)

    def _prologue(self, x, ln):
        """The optional pre-norm (fp32), in_proj, the depthwise conv and SiLU
        as JAX composes them (ssm.py:213-234), in the compute dtype."""
        cd = self.dtype
        if ln is not None:
            x = F.layer_norm(x.float(), (self.d_model,), ln[0].float(), ln[1].float(),
                             1e-5).to(x.dtype)
        x = flax_dense(self.in_proj, x, cd)
        if self.conv2d is not None:
            x = flax_conv(self.conv2d, x, cd)
        return F.silu(x)

    def _composed(self, x, ln, scan):
        """The composed route (ssm.py:225-300), its recurrence run by ``scan``."""
        B, H, W, _ = x.shape
        L, D, cd = H * W, self.d_inner, self.dtype
        xs = cross_scan(self._prologue(x, ln).reshape(B, L, D), self.scan_kind, H, W,
                        self.scan_param)
        wx, wdt, dt_b, A_logs, Ds = self._core_params()
        if self.d_state == 1:
            ys = composed_ss2d_core(xs, wx, wdt, dt_b, A_logs, Ds, scan=scan)
        else:
            R, N = self.dt_rank, self.d_state
            dbc = torch.einsum("bkld,kcd->bklc", xs.to(cd), wx.to(cd))
            dts, Bc, Cc = torch.split(dbc, [R, N, N], dim=-1)
            dts = dt_projection(dts, wdt.to(cd))
            ys = selective_scan(xs, dts, -torch.exp(A_logs.float()), Bc, Cc, Ds, dt_b, scan)
        y = cross_merge(ys, self.scan_kind, H, W, self.scan_param)
        y = F.layer_norm(y.float(), (D,), self.out_norm.weight, self.out_norm.bias, 1e-5)
        y = F.gelu(y).to(cd) @ self.out_proj.weight.to(cd).t()
        if self.out_proj.bias is not None:
            y = y + self.out_proj.bias  # fp32, as JAX adds out_proj_bias (promotes bf16)
        return y.reshape(B, H, W, self.d_model)
