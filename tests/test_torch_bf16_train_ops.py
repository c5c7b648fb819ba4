"""The bf16 training slice op by op: the port's plain adjoints against the JAX
package's custom VJPs on the CPU.

* ``ln_mlp_bwd_ref`` (K9's plain version) against ``_mlp_bwd_pallas`` and
  ``ln_dwms_mlp_bwd_ref`` (K10's) against ``_dwms_bwd_pallas`` (interpret
  mode, row_chunk 6) and, at d > 256, against ``jax.vjp`` of
  ``composed_ln_dwmsmlp``, which JAX runs there.
* The bf16 SS2D under autograd (K5 -> SS2DCore, the card's route with every
  launch replaced by its plain version) against ``jax.grad`` through
  ``fused_ss2d_small`` (its ``emit_train`` route) and through
  ``fused_prologue`` + ``fused_ss2d_full``.
* The loss's bilinear resize of a bf16 head and its backward against
  ``jax.image.resize``.

Tolerances: every output is compared after dividing both sides by the JAX
side's largest magnitude, at rtol / atol 1e-2 (about one bf16 ulp there, the
bf16 ops tolerance): the two sides round to bf16 at the same points but sum
in other orders, which may flip a rounding.  The composed VJP rounds at other
points (its bf16 matmuls round their outputs), so it is held at 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu.ops.fused_prologue import fused_prologue
from tramba_tpu.ops.fused_ss2d import fused_ss2d_full
from tramba_tpu.ops.fused_ss2d_small import fused_ss2d_small
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf

TOL = dict(rtol=1e-2, atol=1e-2)


def _r(rng, *shape, scale=0.2, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _bf(a):
    """a rounded to bf16, as a float32 numpy array (the same values on both sides)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _close_scaled(got, want, name, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, **tol, err_msg=name)


def _conv_t(k):
    """flax depthwise kernel (k, k, 1, C) -> torch Conv2d weight (C, 1, k, k)."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


# --- K9 (#19, fused_mlp.py:233) ----------------------------------------------


@pytest.mark.parametrize("d,hid", [(16, 64), (32, 128)])
def test_ln_mlp_bwd_ref_vs_pallas(d, hid):
    rng = np.random.default_rng(d)
    B, L = 2, 48
    x, g = _bf(_r(rng, B, L, d, scale=1.0)), _bf(_r(rng, B, L, d, scale=1.0))
    s, b = _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1)
    w1, b1, w2 = _r(rng, d, hid), _r(rng, hid, scale=0.1), _r(rng, hid, d)
    want = jm._mlp_bwd_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                              *map(jnp.asarray, (s, b, w1, b1, w2)), interpret=True)
    got = tm.ln_mlp_bwd_ref(_t(x, torch.bfloat16), _t(g, torch.bfloat16), _t(s), _t(b),
                            _t(w1.T), _t(b1), _t(w2.T))
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    names = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dw2", "db2")
    # JAX layout: dw1 (d, hid), dw2 (hid, d); the port's is torch's
    for name, a, w in zip(names, got, want):
        _close_scaled(a.t() if name in ("dw1", "dw2") else a, w, name)


# --- K10 (#22, fused_mlp.py:674) ---------------------------------------------


def _dwms_inputs(rng, B, H, W, d, hid):
    out = [_bf(_r(rng, B, H, W, d, scale=1.0)), _bf(_r(rng, B, H, W, d, scale=1.0)),
           _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1), _r(rng, d, hid),
           _r(rng, hid, scale=0.1)]
    for n in (3, 5, 7):
        out += [_r(rng, n, n, 1, hid, scale=0.3), _r(rng, hid, scale=0.1)]
    return out + [_r(rng, hid, d)]


def _dwms_port(args):
    x, g, s, b, w1, b1, k3, c3, k5, c5, k7, c7, w2 = args
    return tm.ln_dwms_mlp_bwd_ref(_t(x, torch.bfloat16), _t(g, torch.bfloat16), _t(s), _t(b),
                                  _t(w1.T), _t(b1), _t(_conv_t(k3)), _t(c3), _t(_conv_t(k5)),
                                  _t(c5), _t(_conv_t(k7)), _t(c7), _t(w2.T))


_DWMS_NAMES = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dk3", "dc3", "dk5", "dc5", "dk7", "dc7",
               "dw2", "db2")


def _to_jax_layout(name, a):
    if name in ("dw1", "dw2"):
        return a.t()
    if name in ("dk3", "dk5", "dk7"):  # (hid, 1, k, k) -> (k, k, 1, hid)
        return a.permute(2, 3, 1, 0)
    return a


@pytest.mark.parametrize("H,W", [(6, 8), (12, 6)])
def test_ln_dwms_mlp_bwd_ref_vs_pallas(H, W):
    """Rows in blocks of 6 with 6-row x halos and 3-row g halos from both
    neighbours (H = 12), hidden chunks of 64."""
    args = _dwms_inputs(np.random.default_rng(H), 2, H, W, 16, 64)
    x, g = (jnp.asarray(a, jnp.bfloat16) for a in args[:2])
    want = jm._dwms_bwd_pallas(x, g, *map(jnp.asarray, args[2:]), interpret=True, row_chunk=6)
    got = _dwms_port(args)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, w in zip(_DWMS_NAMES, got, want):
        _close_scaled(_to_jax_layout(name, a), w, name)


def test_ln_dwms_mlp_bwd_ref_vs_composed_vjp_wide():
    """d = 272 > 256: JAX's native kernel declines, the composed VJP runs."""
    args = _dwms_inputs(np.random.default_rng(7), 1, 5, 7, 272, 32)
    x = jnp.asarray(args[0], jnp.bfloat16)
    params = [jnp.asarray(a) for a in args[2:]]
    b2 = jnp.zeros(272, jnp.float32)
    _, vjp = jax.vjp(jm.composed_ln_dwmsmlp, x, *params, b2)
    want = vjp(jnp.asarray(args[1], jnp.bfloat16))
    got = _dwms_port(args)
    for name, a, w in zip(_DWMS_NAMES, got, want):
        _close_scaled(_to_jax_layout(name, a), w, name, tol=dict(rtol=2e-2, atol=2e-2))


# --- bf16 SS2D under autograd (#13 emit_train, #15 VJP, #1/#4 in bf16) -------


def _ss2d_inputs(rng, B, H, W, dm, D, K=4):
    R = -(-dm // 16)
    return dict(x=_bf(_r(rng, B, H * W, dm, scale=1.0)), ln1_s=_r(rng, dm, scale=0.1, shift=1.0),
                ln1_b=_r(rng, dm, scale=0.1), w_in=_r(rng, dm, D, scale=dm ** -0.5),
                conv_k=_r(rng, 3, 3, 1, D, scale=0.3),
                x_proj_w=_r(rng, K, R + 2, D, scale=1.6 * D ** -0.5),
                dt_w=_r(rng, K, D, R, scale=R ** -0.5), dt_b=_r(rng, K, D, scale=0.2, shift=-2.0),
                A_logs=_r(rng, K, D, 1, scale=0.3), Ds=_r(rng, K, D, scale=1.0),
                ln_s=_r(rng, D, scale=0.1, shift=1.0), ln_b=_r(rng, D, scale=0.1),
                w_out=_r(rng, D, dm, scale=D ** -0.5))


_SS2D_ORDER = ("x", "ln1_s", "ln1_b", "w_in", "conv_k", "x_proj_w", "dt_w", "dt_b", "A_logs",
               "Ds", "ln_s", "ln_b", "w_out")


def _port_ss2d_grads(p, cot, H, W):
    """The card's bf16 route on the CPU: K5's plain version under autograd
    (Prologue's backward is its VJP), then SS2DCore with every launch
    replaced by its plain version; returns {name: grad in the JAX layout}."""
    from tramba_tpu_torch.ops.scan_orders import order_tables

    B, L, dm = p["x"].shape
    D = p["w_in"].shape[1]
    t = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    x = _t(p["x"], torch.bfloat16).requires_grad_(True)
    w_in_t = t["w_in"].t()
    conv_t = t["conv_k"].permute(3, 2, 0, 1)
    u = tp.prologue_ref(x.reshape(B, H, W, dm), t["ln1_s"], t["ln1_b"], w_in_t, conv_t)
    idx, inv = order_tables("raster", H, W, 0, "cpu")
    out = tf.SS2DCore.apply(u.reshape(B, L, D), idx, inv, t["x_proj_w"], t["dt_w"], t["dt_b"],
                            t["A_logs"], t["Ds"], t["ln_s"], t["ln_b"], t["w_out"].t())
    assert out.dtype == torch.bfloat16
    names = [k for k in _SS2D_ORDER if k != "x"]
    grads = torch.autograd.grad(out, [x] + [t[k] for k in names], _t(cot, torch.bfloat16))
    return dict(zip(["x"] + names, grads))


def _jax_ss2d_grads(fn, p, cot):
    args = [jnp.asarray(p[k], jnp.bfloat16) if k == "x" else jnp.asarray(p[k])
            for k in _SS2D_ORDER]

    def f(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * jnp.asarray(cot))

    return dict(zip(_SS2D_ORDER, jax.grad(f, argnums=tuple(range(len(args))))(*args)))


@pytest.mark.parametrize("route", ["small", "prologue_full"])
def test_bf16_ss2d_adjoint_vs_jax(route):
    """d_model 64, d_inner 128, an 8 x 8 raster map, bf16: every input's
    gradient of <SS2D(x), cot> against jax.grad through the JAX bf16 route
    (``small``: fused_ss2d_small, whose train forward is emit_train;
    ``prologue_full``: fused_prologue + fused_ss2d_full, the 96 / 48 px
    route), Pallas in interpret mode."""
    H = W = 8
    p = _ss2d_inputs(np.random.default_rng(11), 2, H, W, 64, 128)
    cot = _bf(_r(np.random.default_rng(12), 2, H * W, 64, scale=1.0))

    def small(x, s1, b1, w_in, k, *core):
        return fused_ss2d_small(x, s1, b1, w_in, k, *core, H, W)

    def pro_full(x, s1, b1, w_in, k, *core):
        u = fused_prologue(x.reshape(2, H, W, 64), s1, b1, w_in, k)
        return fused_ss2d_full(u.reshape(2, H * W, 128), *core, "raster", H, W)

    want = _jax_ss2d_grads(small if route == "small" else pro_full, p, cot)
    got = _port_ss2d_grads(p, cot, H, W)
    assert got["x"].dtype == torch.bfloat16
    for name in _SS2D_ORDER:  # the port's leaves are in the JAX layouts here
        _close_scaled(got[name], want[name], name)


# --- the loss's bilinear resize of a bf16 head ---------------------------------


def test_bf16_resize_and_its_backward_match_jax():
    """A bf16 head 6 -> 96 px (each source pixel receives 256 weighted
    cotangents): the value and the cotangent of the head against jax.vjp of
    jax.image.resize on the bf16 array, which sums in fp32 and rounds once."""
    from tramba_tpu_torch.train.loss import resize_bilinear

    rng = np.random.default_rng(5)
    x, cot = _bf(_r(rng, 2, 6, 6, 1, scale=2.0)), _bf(_r(rng, 2, 96, 96, 1, scale=1.0))
    want, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, 96, 96, 1), "bilinear"),
                        jnp.asarray(x, jnp.bfloat16))
    (want_dx,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = _t(x, torch.bfloat16).requires_grad_(True)
    got = resize_bilinear(xt, 96, 96)
    (got_dx,) = torch.autograd.grad(got, xt, _t(cot, torch.bfloat16))
    assert got.dtype == got_dx.dtype == torch.bfloat16
    _close_scaled(got, want, "resized")
    _close_scaled(got_dx, want_dx, "cotangent of the head")
