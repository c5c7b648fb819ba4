"""SS2D: the 2-D selective-scan operator, channels-last.

Port of ``tramba_tpu/nn/ssm.py:133-301`` for d_state 1, no in/out bias and a
3x3 depthwise conv (the only configuration Tramba-V builds).  The scan is
kernel K1 over the order's gather table and the merge, LayerNorm, exact GELU
and out projection are kernel K2 (``ops/fused_ss2d.py``).  In front of them:

* fp32: the optional pre-norm, in_proj, the depthwise conv and SiLU are plain
  torch, as JAX runs them outside Pallas in fp32;
* bf16: kernel K5 ``prologue`` (``ops/fused_prologue.py``) runs them, as
  ``_prologue_pallas`` and the front of ``_small_pallas`` do on a TPU, and
  K1 reads its bf16 output; K2 returns bf16.

Parameters stay fp32 and keep the reference's stacked (K, ...) layout and
names (``Models/vmamba.py:87-112``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tramba_tpu_torch.nn.layers import LayerNorm, check_dtype, conv_nhwc
from tramba_tpu_torch.ops import fused_prologue
from tramba_tpu_torch.ops.fused_ss2d import ss2d_full

__all__ = ["SS2D"]


class SS2D(nn.Module):
    def __init__(self, d_model: int, ssm_ratio: float = 2.0, k_group: int = 4,
                 scan_kind: str = "raster", scan_param: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.d_model = d_model
        self.d_inner = D = int(ssm_ratio * d_model)
        self.dt_rank = R = math.ceil(d_model / 16)
        self.k_group = K = k_group
        self.scan_kind = scan_kind
        self.scan_param = scan_param
        self.in_proj = nn.Linear(d_model, D, bias=False)
        self.conv2d = nn.Conv2d(D, D, 3, padding=1, groups=D, bias=False)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.zeros(K * D, 1))
        self.Ds = nn.Parameter(torch.ones(K * D))
        self.out_norm = LayerNorm(D)
        self.out_proj = nn.Linear(D, d_model, bias=False)

    @torch.no_grad()
    def reset_ssm_parameters(self, generator: torch.Generator,
                             dt_min: float = 0.001, dt_max: float = 0.1,
                             dt_floor: float = 1e-4) -> None:
        """The reference's SS2D init (mamba_init.py:19-48): U(+-1/sqrt(fan_in))
        projections, dt bias = softplus^-1 of a log-uniform dt, A_log = log(1),
        D = 1."""
        D, R = self.d_inner, self.dt_rank
        nn.init.uniform_(self.x_proj_weight, -D ** -0.5, D ** -0.5, generator=generator)
        nn.init.uniform_(self.dt_projs_weight, -R ** -0.5, R ** -0.5, generator=generator)
        u = torch.rand(self.dt_projs_bias.shape, generator=generator)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = dt.clamp(min=dt_floor)
        self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_logs.zero_()
        self.Ds.fill_(1.0)

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        """x (B, H, W, d_model).  ``ln``: the block's pre-norm (weight, bias),
        applied first when given."""
        B, H, W, _ = x.shape
        w_out = self.out_proj.weight
        if self.dtype == torch.bfloat16:
            ln_w, ln_b = ln if ln is not None else (None, None)
            x = fused_prologue.prologue(x, ln_w, ln_b, self.in_proj.weight.to(self.dtype),
                                        self.conv2d.weight.to(self.dtype))
            w_out = w_out.to(self.dtype)
        else:
            if ln is not None:
                x = F.layer_norm(x, (self.d_model,), ln[0], ln[1], 1e-5)
            x = F.silu(conv_nhwc(self.conv2d, self.in_proj(x)))
        K, D = self.k_group, self.d_inner
        y = ss2d_full(x.reshape(B, H * W, D).contiguous(), self.x_proj_weight,
                      self.dt_projs_weight, self.dt_projs_bias, self.A_logs.view(K, D, 1),
                      self.Ds.view(K, D), self.out_norm.weight, self.out_norm.bias,
                      w_out, self.scan_kind, H, W, self.scan_param)
        return y.reshape(B, H, W, self.d_model)
