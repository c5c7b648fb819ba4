"""Plain fp32 reference of Tramba-V-TSOD and Tramba-S-TSOD, channels-last:
the blocks, and the entry (:func:`forward`, :func:`param_shapes`) that runs
the encoder and the decoder a configuration names, each a file of
``encoders/`` and ``decoders/`` found by its name (:func:`part`).

Written from the architecture of Tramba (arXiv 2503.16910; repo mj129/Tramba,
``Trambav6.py``, ``Trambav6_enc.py``, ``Models/vmamba.py``, ``freq_mamba.py``,
``Models/encoder/swin_encoder.py``) as plain torch operations over a flat
state dict ``P`` whose keys are the reference state dict's.  It imports no
module of the program under test: every table, basis and mask is worked out
here.  Every product and every scan runs in fp32 or above (the scan in fp64,
``scan.py``); set :func:`exact_fp32` around a call on the card so that cuBLAS
and cuDNN do not drop to TF32.

:class:`Ctx` carries what one call varies:

* ``quant``: a function every operand of a product passes through (None:
  fp32).  The control of the benchmark's comparison rounds them to fp8.
* ``drop``: the stochastic-depth multipliers of a training forward, one (B,)
  tensor per branch with a rate above 0, in call order; None in inference.
* ``calls``: where given, each SS2D appends ("ss2d", B, K, L, D, d_model,
  kind, param) and each branch stochastic depth may drop ("drop", rate):
  the work counts of ``tsodbench/counts.py``.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tsodbench import harness
from tsodbench.reference import orders
from tsodbench.reference.scan import linear_scan

# the high-band window of a DFVSS guide by map size (csms6s.py:107-111)
WINDOW_BY_RES = {12: 4, 24: 8, 48: 12, 96: 16}


def window_for(res: int) -> int:
    """The guide's window at ``res``; elsewhere (small test maps only) the
    divisor of res nearest res / 5."""
    if res in WINDOW_BY_RES:
        return WINDOW_BY_RES[res]
    divs = [d for d in range(2, res + 1) if res % d == 0]
    return min(divs, key=lambda d: abs(d - max(2, res // 5)))


class Ctx:
    def __init__(self, quant=None, drop: Optional[List[torch.Tensor]] = None, calls=None):
        self.quant = quant
        self.drop = None if drop is None else list(drop)
        self.calls = calls


@contextlib.contextmanager
def exact_fp32():
    """cuBLAS and cuDNN in full fp32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def operand(ctx, t):
    return t if ctx.quant is None else ctx.quant(t)


def linear(ctx, x, w, b=None):
    y = operand(ctx, x) @ operand(ctx, w).t()
    return y if b is None else y + b


def conv(ctx, x, w, b=None, stride=1, padding=0, groups=1):
    """NHWC x, NCHW-layout weight."""
    y = F.conv2d(operand(ctx, x).permute(0, 3, 1, 2), operand(ctx, w), b, stride, padding, 1,
                 groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(P, name, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def drop(ctx, x, rate):
    """Stochastic depth: the branch times its sample's multiplier."""
    if rate == 0.0:
        return x
    if ctx.calls is not None:
        ctx.calls.append(("drop", rate))
    if ctx.drop is None:
        return x
    m = ctx.drop.pop(0)
    return x * m.reshape((-1,) + (1,) * (x.ndim - 1))


def pixel_shuffle(x, p):
    """NHWC, channel index (p1, p2, c): '(p1 p2 c) h w -> c (h p1) (w p2)'."""
    B, H, W, C = x.shape
    c = C // (p * p)
    return x.reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(B, H * p, W * p, c)


@functools.lru_cache(maxsize=None)
def _table(kind, H, W, param, device):
    return torch.from_numpy(orders.order(kind, H, W, param)).to(device)


def ss2d(ctx, P, pre, x, kind, param=0, ln=None):
    """SS2D of d_state 1 (vmamba.py:87-300): [pre-norm] -> in_proj -> 3x3
    depthwise conv -> SiLU -> K directional selective scans -> scatter-add
    merge -> LayerNorm -> GELU -> out_proj."""
    B, H, W, dm = x.shape
    if ln is not None:
        x = layer_norm(P, ln, x)
    u = linear(ctx, x, P[pre + "in_proj.weight"])
    D = u.shape[-1]
    u = F.silu(conv(ctx, u, P[pre + "conv2d.weight"], padding=1, groups=D)).reshape(B, H * W, D)
    idx = _table(kind, H, W, param, str(u.device))
    K, L = idx.shape
    if ctx.calls is not None:
        ctx.calls.append(("ss2d", B, K, L, D, dm, kind, param))
    xs = u[:, idx]  # (B, K, L, D)
    wx, wdt = P[pre + "x_proj_weight"], P[pre + "dt_projs_weight"]
    R = wdt.shape[-1]
    dbc = torch.einsum("bkld,kcd->bklc", operand(ctx, xs), operand(ctx, wx))
    dts, Bc, Cc = torch.split(dbc, [R, 1, 1], dim=-1)
    dt = torch.matmul(operand(ctx, dts), operand(ctx, wdt).transpose(1, 2))
    delta = F.softplus(dt + P[pre + "dt_projs_bias"][None, :, None, :])
    A = -torch.exp(P[pre + "A_logs"]).reshape(K, 1, D)
    h = linear_scan(torch.exp(delta * A), delta * xs * Bc)
    ys = h * Cc + xs * P[pre + "Ds"].reshape(K, 1, D)
    y = ys.new_zeros(B, L, D).index_add(1, idx.reshape(-1), ys.reshape(B, K * L, D))
    y = F.gelu(layer_norm(P, pre + "out_norm", y))
    return linear(ctx, y, P[pre + "out_proj.weight"]).reshape(B, H, W, dm)


def mlp(ctx, P, pre, x):
    return linear(ctx, F.gelu(linear(ctx, x, P[pre + "fc1.weight"], P[pre + "fc1.bias"])),
                  P[pre + "fc2.weight"], P[pre + "fc2.bias"])


def dwms_mlp(ctx, P, pre, x):
    """fc1 -> h + dw3(h) + dw5(h) + dw7(h) -> GELU -> fc2 (vmamba.py:606-629)."""
    h = linear(ctx, x, P[pre + "fc1.weight"], P[pre + "fc1.bias"])
    a = h
    for k in (3, 5, 7):
        c = f"{pre}dwc{k}.dw_conv."
        a = a + conv(ctx, h, P[c + "weight"], P[c + "bias"], padding=k // 2, groups=h.shape[-1])
    return linear(ctx, F.gelu(a), P[pre + "fc2.weight"], P[pre + "fc2.bias"])


def expand(ctx, P, pre, x, p=2):
    """Dense -> pixel shuffle x``p`` -> LayerNorm (PatchExpand, FreqExpand2D)."""
    return layer_norm(P, pre + "norm", pixel_shuffle(linear(ctx, x, P[pre + "expand.weight"]), p))


@functools.lru_cache(maxsize=None)
def _dct_basis(n, device):
    j, v = np.arange(n)[None, :], np.arange(n)[:, None]
    b = np.cos(np.pi * (0.5 + j) * v / n) / np.sqrt(n)
    b[1:] *= np.sqrt(2.0)
    return torch.from_numpy(b).float().to(device)


def dct_quadrants(ctx, x):
    """(high, low): the last and first halves of the orthonormal 2-D DCT-II."""
    B, H, W, C = x.shape
    bh, bw = _dct_basis(H, str(x.device)), _dct_basis(W, str(x.device))
    xq = operand(ctx, x)
    low = torch.einsum("bhvc,kh->bkvc", operand(ctx, torch.einsum("bhwc,vw->bhvc", xq,
                                                             operand(ctx, bw[: W // 2]))),
                       operand(ctx, bh[: H // 2]))
    high = torch.einsum("bhvc,kh->bkvc", operand(ctx, torch.einsum("bhwc,vw->bhvc", xq,
                                                              operand(ctx, bw[W // 2:]))),
                        operand(ctx, bh[H // 2:]))
    return high, low


def freq_block(ctx, P, pre, x, window):
    """DFVSS guide (freq_mamba.py:60-82): x + gate(x); x + Mlp(LN(x))."""
    y = layer_norm(P, pre + "norm1", x)
    high, low = dct_quadrants(ctx, y)
    a = pre + "attn."
    h = ss2d(ctx, P, a + "h_ssm.", expand(ctx, P, a + "h_expand.", high, 2), "window", window)
    lo = ss2d(ctx, P, a + "l_ssm.", expand(ctx, P, a + "l_expand.", low, 2), "dilation", 4)
    gate = linear(ctx, torch.cat([h, lo], dim=-1), P[a + "concat_back_dim.weight"])
    x = x + torch.sigmoid(gate) * y
    return x + mlp(ctx, P, pre + "mlp.", layer_norm(P, pre + "norm2", x))


def part(kind: str, name: str):
    """The module ``reference/<kind>/<name>.py``: an encoder (``encode(ctx,
    P, cfg, x) -> [x, the four stage maps]``) or a decoder (``decode(ctx, P,
    cfg, skips) -> the logit maps``), each with ``param_shapes(cfg)``,
    found by the name a configuration's ``model`` gives it."""
    return harness.module(kind, name, os.path.dirname(os.path.abspath(__file__)))


def forward(ctx: Ctx, P: dict, cfg: dict, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3) fp32 -> the logit maps (B, h, w, 1), fp32, the last at
    full resolution.  ``cfg`` is a configuration file's ``model``: its
    ``encoder`` and ``decoder`` name the parts."""
    skips = part("encoders", cfg["encoder"]).encode(ctx, P, cfg, x.float())
    return part("decoders", cfg["decoder"]).decode(ctx, P, cfg, skips)


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter of the configuration, under the
    reference state dict's names: the encoder's, then the decoder's."""
    return {**part("encoders", cfg["encoder"]).param_shapes(cfg),
            **part("decoders", cfg["decoder"]).param_shapes(cfg)}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448), back in fp32: the control's operand rounding.  The
    gradient passes the rounding unchanged (a straight-through rounding)."""
    s = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (r - t.detach())


def ss2d_shapes(pre, dm, K):
    D, R = 2 * dm, -(-dm // 16)
    return {pre + "x_proj_weight": (K, R + 2, D), pre + "dt_projs_weight": (K, D, R),
            pre + "dt_projs_bias": (K, D), pre + "A_logs": (K * D, 1), pre + "Ds": (K * D,),
            pre + "in_proj.weight": (D, dm), pre + "conv2d.weight": (D, 1, 3, 3),
            pre + "out_norm.weight": (D,), pre + "out_norm.bias": (D,),
            pre + "out_proj.weight": (dm, D)}


def norm_shapes(pre, c):
    return {pre + ".weight": (c,), pre + ".bias": (c,)}


def dense_shapes(pre, cout, cin, bias=True):
    return {pre + ".weight": (cout, cin), **({pre + ".bias": (cout,)} if bias else {})}


def mlp_shapes(pre, c, dwms=False):
    out = dense_shapes(pre + "fc1", 4 * c, c)
    if dwms:
        for k in (3, 5, 7):
            out[f"{pre}dwc{k}.dw_conv.weight"] = (4 * c, 1, k, k)
            out[f"{pre}dwc{k}.dw_conv.bias"] = (4 * c,)
    return {**out, **dense_shapes(pre + "fc2", c, 4 * c)}


