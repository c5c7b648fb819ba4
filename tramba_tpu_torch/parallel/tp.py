"""Tensor (channel) parallelism for the SS2D core over the model group.

Port of ``tramba_tpu/parallel/tp.py:53-158``.  The S6 recurrence is diagonal
in d_inner, so each rank of the model group takes a slice of d_inner: in_proj
by output column, the depthwise conv and every per-direction parameter by
channel, the out-norm's scale and bias by channel, out_proj by input row.
The conv, the discretization, the scan (kernel K14 on the card) and the
gating stay local, and a block makes exactly three reductions, as the JAX
version's ``psum``s:

  1. the partial Delta/B/C projections (a contraction over d_inner);
  2. the out-norm's moments s1 = sum y and s2 = sum y^2, in one all-reduce;
  3. the partial out projections.

The variance is JAX's one-pass ``max(E[y^2] - mu^2, 0)`` (not the centred
form of the composed route).  The block's input is replicated over the group
(:func:`~tramba_tpu_torch.parallel.mesh.copy_to`: its gradient is summed
over the group); the parameters arrive whole, as the module holds them, and
each rank takes its slice with :func:`~tramba_tpu_torch.parallel.mesh.split`,
whose backward gathers the slices' gradients, so every rank ends with the
full gradient of every parameter.  The first two reductions feed each rank's
own channels, so their backward sums the ranks' cotangents
(:func:`~tramba_tpu_torch.parallel.mesh.reduce_shared`); the third feeds
work every rank repeats, so its backward passes the cotangent through
(:func:`~tramba_tpu_torch.parallel.mesh.reduce_from`).

    with use_tensor_group(grid.model):
        y = SS2D(..., backend="tensor_parallel")(x, ln=ln)
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops.scan_orders import cross_merge, cross_scan
from tramba_tpu_torch.ops.selective_scan import dt_projection, linear_scan
from tramba_tpu_torch.parallel.mesh import Axis, copy_to, reduce_from, reduce_shared, split

__all__ = ["use_tensor_group", "current_tensor_group", "ss2d_tensor_parallel"]

_ctx = threading.local()


@contextlib.contextmanager
def use_tensor_group(axis: Axis):
    """Route ``backend="tensor_parallel"`` SS2Ds through this model axis."""
    prev = getattr(_ctx, "axis", None)
    _ctx.axis = axis
    try:
        yield
    finally:
        _ctx.axis = prev


def current_tensor_group() -> Axis:
    axis = getattr(_ctx, "axis", None)
    if axis is None:
        raise RuntimeError("backend='tensor_parallel' needs a model group: wrap the call in "
                           "tramba_tpu_torch.parallel.tp.use_tensor_group(grid.model)")
    return axis


def ss2d_tensor_parallel(x, ln, w_in, conv_w, x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b,
                         w_out, scan_kind: str, H: int, W: int, scan_param: int):
    """Channel-sharded SS2D block: x (B, H, W, dm) -> (B, H, W, dm).  Weights
    in the module's layout: w_in (D, dm), conv_w (D, 1, 3, 3), x_proj_w
    (K, R+2, D), dt_w (K, D, R), dt_b (K, D), A_logs (K, D, 1), Ds (K, D),
    ln_w, ln_b (D), w_out (dm, D); ``ln`` the block's pre-norm or None."""
    axis = current_tensor_group()
    D = w_in.shape[0]
    R = x_proj_w.shape[1] - 2
    if A_logs.shape[-1] != 1:
        raise ValueError("tensor_parallel supports d_state 1")
    if D % axis.size:
        raise ValueError(f"d_inner {D} must divide over {axis.size} model ranks")
    B, L, eps = x.shape[0], H * W, 1e-5
    cd = x.dtype
    if ln is not None:  # over d_model, replicated: before the group's region
        x = F.layer_norm(x.float(), (x.shape[-1],), ln[0].float(), ln[1].float(), eps).to(cd)
    x = copy_to(x, axis)
    w_in, conv_w, ln_w, ln_b = (split(t, 0, axis) for t in (w_in, conv_w, ln_w, ln_b))
    x_proj_w = split(x_proj_w, 2, axis)
    dt_w, dt_b, A_logs, Ds = (split(t, 1, axis) for t in (dt_w, dt_b, A_logs, Ds))
    w_out = split(w_out, 1, axis)
    Dl = w_in.shape[0]

    u = x @ w_in.to(cd).t()  # (B, H, W, Dl): in_proj by column
    u = F.conv2d(u.permute(0, 3, 1, 2), conv_w.to(cd), padding=1, groups=Dl).permute(0, 2, 3, 1)
    xs = cross_scan(F.silu(u).reshape(B, L, Dl), scan_kind, H, W, scan_param)
    xf = xs.float()
    # Delta/B/C: a contraction over the sharded d_inner
    dbc = reduce_shared(torch.einsum("bkld,kcd->bklc", xf, x_proj_w.float()), axis)
    dts, Bc, Cc = torch.split(dbc, [R, 1, 1], dim=-1)
    dts = dt_projection(dts, dt_w.float())
    delta = F.softplus(dts + dt_b.float()[None, :, None, :])
    A = -torch.exp(A_logs.float())[..., 0]
    h = linear_scan(torch.exp(delta * A[None, :, None, :]), delta * xf * Bc)  # local
    ys = h * Cc + xf * Ds.float()[None, :, None, :]
    y = cross_merge(ys.to(cd), scan_kind, H, W, scan_param).float()
    # the out-norm over the full d_inner: both moments in one all-reduce
    s = reduce_shared(torch.cat([y.sum(-1, keepdim=True), (y * y).sum(-1, keepdim=True)], -1),
                      axis)
    mu = s[..., :1] / D
    var = torch.clamp(s[..., 1:] / D - mu * mu, min=0.0)
    y = (y - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    y = F.gelu(y).to(cd)
    out = reduce_from(y @ w_out.to(cd).t(), axis)  # out_proj by row
    return out.reshape(B, H, W, -1)
