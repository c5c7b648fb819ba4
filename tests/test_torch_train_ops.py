"""Plain versions of the training kernels (K1 / K2 train variants, K8) vs
autograd and vs the JAX package's custom VJPs.

fp32 throughout, at tiny shapes.  Tolerances: the explicit adjoint against
torch autograd through the same plain forward, rtol 1e-4, atol 1e-5 (the two
sum in other orders); against the JAX VJP of ``fused_ss2d_full`` /
``fused_ss2d_freq`` with the Pallas kernels (#4 ``_dirs_bwd_call``, #5
``_seq_bwd_pallas``) in interpret mode, rtol 1e-4, atol 1e-4 (associative vs
sequential scans, chunk carries recomputed on both sides).  Shapes cover L =
144 (three chunks of 64, the last ragged), L < 64 and line orders, whose
directions visit some pixels more than once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables
from tramba_tpu_torch.ops.selective_scan import linear_scan

TOL_AUTOGRAD = dict(rtol=1e-4, atol=1e-5)
TOL_JAX = dict(rtol=1e-4, atol=1e-4)
GRAD_NAMES = ("dx", "dx_proj_w", "ddt_w", "ddt_b", "dA_logs", "dDs")


def _inputs(kind, K, H, seed, D=16, R=3, dm=8, B=2):
    """x (B, L, D) and the SS2D parameters in the JAX layouts."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(B, H * H, D)).astype(f),
        wx=(rng.normal(size=(K, R + 2, D)) * 0.2).astype(f),
        wdt=(rng.normal(size=(K, D, R)) * 0.3).astype(f),
        bias=(rng.normal(size=(K, D)) * 0.2).astype(f),
        A_logs=(rng.normal(size=(K, D, 1)) * 0.3).astype(f),
        Ds=rng.normal(size=(K, D)).astype(f),
        scale=(rng.normal(size=(D,)) * 0.1 + 1).astype(f),
        lb=(rng.normal(size=(D,)) * 0.1).astype(f),
        w_out=(rng.normal(size=(D, dm)) * 0.2).astype(f),  # JAX layout (D, dm)
        g=rng.normal(size=(B, H * H, dm)).astype(f),
        g_y=rng.normal(size=(B, H * H, D)).astype(f),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _core(p):
    return [_t(p[k]) for k in ("wx", "wdt", "bias", "A_logs", "Ds")]


# (order, directions, map size, window / rate): L = 144, 64 < L, L = 9 and a
# line order at each
SHAPES = [("raster", 4, 12, 0), ("raster", 4, 7, 0), ("raster", 4, 3, 0), ("line", 8, 12, 0),
          ("line", 8, 6, 0), ("window", 4, 12, 4), ("window", 4, 4, 4), ("dilation", 4, 12, 4),
          ("dilation", 4, 4, 4)]


# ys and the projections dbc of K1's train variant against the inference
# plain version and an einsum in scan order: max abs difference over the
# largest magnitude.  The train variant projects every pixel once for all
# directions, the others each direction's rows, so fp32 rounding of those
# 16-term sums shows: on an AVX512 host with MKL, dbc 4.77e-7 at a largest
# value of 2.69 (a share of 1.8e-7) and ys 1.19e-6 at 13.9 (8.6e-8, 8,422 of
# 18,432 entries apart); bit-equal on other hosts.  1e-6 is about eight
# units in the last place of the largest value.
YS_SHARE = 1e-6


def _max_share(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_train_ref_carries_are_states_at_chunk_starts():
    """K1's train variant: ys equal the inference plain version, and dbc the
    projections in scan order, to within :data:`YS_SHARE` of their largest
    magnitude, a check that the plain version with dt_b moved by 1e-3 fails;
    and carries [:, :, c] is the state entering step 64c, read off an
    independent scan (rtol 1e-6, atol 1e-6: the projections are summed in
    another order)."""
    p = _inputs("raster", 4, 12, seed=0)
    x, core = _t(p["x"]), _core(p)
    idx, _ = order_tables("raster", 12, 12, 0, "cpu")
    ys, carries, dbc = tf.ss2d_scan_train_ref(x, idx, *core)
    want_ys = tf.ss2d_scan_ref(x, idx, *core)
    assert _max_share(ys, want_ys) <= YS_SHARE
    moved = core[:2] + [core[2] + 1e-3] + core[3:]
    assert _max_share(tf.ss2d_scan_ref(x, idx, *moved), want_ys) > YS_SHARE
    K, L = idx.shape
    R = core[1].shape[-1]
    assert carries.shape == (2, K, 3, 16) and dbc.shape == (2, L, K, R + 2)
    xs = x[:, idx.long()]
    want_dbc = torch.einsum("bkld,kcd->bklc", xs, core[0])
    got_dbc = torch.stack([dbc[:, idx[k].long(), k] for k in range(K)], dim=1)
    assert _max_share(got_dbc, want_dbc) <= YS_SHARE
    dts = torch.einsum("bklr,kdr->bkld", want_dbc[..., :R], core[1]) + core[2][:, None]
    delta = torch.nn.functional.softplus(dts)
    a = torch.exp(delta * -torch.exp(core[3][..., 0])[:, None])
    h = linear_scan(a, delta * want_dbc[..., R:R + 1] * xs)
    assert torch.equal(carries[:, :, 0], torch.zeros_like(carries[:, :, 0]))
    for c in (1, 2):
        torch.testing.assert_close(carries[:, :, c], h[:, :, 64 * c - 1], rtol=1e-6, atol=1e-6)


def test_merge_train_ref_returns_pre_ln_sum():
    p = _inputs("line", 8, 6, seed=1)
    idx, inv = order_tables("line", 6, 6, 0, "cpu")
    ys = tf.ss2d_scan_ref(_t(p["x"]), idx, *_core(p))
    tail = (_t(p["scale"]), _t(p["lb"]), _t(p["w_out"].T))
    out, y_sum = tf.ss2d_merge_train_ref(ys, inv, *tail)
    assert torch.equal(out, tf.ss2d_merge_ref(ys, inv, *tail))
    want = torch.zeros_like(y_sum)
    for k in range(8):
        want.index_add_(1, idx[k].long(), ys[:, k])  # the reference's scatter-add
    torch.testing.assert_close(y_sum, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,K,H,param", SHAPES)
def test_scan_bwd_ref_matches_autograd(kind, K, H, param):
    """The explicit adjoint (recomputing each chunk from its carry) vs torch
    autograd through ss2d_scan_ref and the merge sum."""
    p = _inputs(kind, K, H, seed=H + K)
    idx, inv = order_tables(kind, H, H, param, "cpu")
    leaves = [_t(p["x"]).requires_grad_(True)] + [c.requires_grad_(True) for c in _core(p)]
    y_sum = tf._merge_sum(tf.ss2d_scan_ref(leaves[0], idx, *leaves[1:]), inv)
    want = torch.autograd.grad(y_sum, leaves, _t(p["g_y"]))
    with torch.no_grad():
        _, carries, dbc = tf.ss2d_scan_train_ref(leaves[0], idx, *leaves[1:])
        got = tf.ss2d_scan_bwd_ref(leaves[0], idx, inv, _t(p["g_y"]), carries, dbc, *leaves[1:])
    for name, g, w in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(g.reshape(w.shape), w, **TOL_AUTOGRAD, msg=name)


def _jax_vjp(kind, H, param, p):
    args = [jnp.asarray(p[k]) for k in ("x", "wx", "wdt", "bias", "A_logs", "Ds", "scale", "lb",
                                        "w_out")]
    if kind in ("raster", "line"):
        fn = functools.partial(jf.fused_ss2d_full, kind=kind, H=H, W=H)
    else:
        fn = functools.partial(jf.fused_ss2d_freq, kind=kind, H=H, W=H, param=param)
    out, vjp = jax.vjp(lambda *a: fn(*a), *args)
    return out, vjp(jnp.asarray(p["g"]))


@pytest.mark.parametrize("kind,K,H,param", [("raster", 4, 12, 0), ("raster", 4, 7, 0),
                                             ("line", 8, 6, 0), ("window", 4, 12, 4),
                                             ("window", 4, 4, 4), ("dilation", 4, 12, 4),
                                             ("dilation", 4, 4, 4)])
def test_ss2d_core_matches_jax_vjp(kind, K, H, param):
    """SS2DCore on CPU tensors (K1 / K2 train variants' and K8's plain
    versions, the LN -> GELU -> out projection adjoint by autograd) vs the
    JAX custom VJP with its Pallas kernels in interpret mode: the output and
    all nine gradients."""
    p = _inputs(kind, K, H, seed=2 * H + K)
    want_out, want = _jax_vjp(kind, H, param, p)
    idx, inv = order_tables(kind, H, H, param, "cpu")
    leaves = [_t(p[k]).requires_grad_(True) for k in ("x", "wx", "wdt", "bias", "A_logs", "Ds",
                                                       "scale", "lb")]
    w_out = _t(p["w_out"].T.copy()).requires_grad_(True)
    out = tf.SS2DCore.apply(leaves[0], idx, inv, *leaves[1:], w_out)
    got = torch.autograd.grad(out, leaves + [w_out], _t(p["g"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL_JAX)
    names = GRAD_NAMES + ("dln_scale", "dln_bias", "dw_out")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy().T if name == "dw_out" else g.numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, **TOL_JAX, err_msg=name)


def test_full_autograd_on_cpu_matches_ss2d_core():
    """ss2d_full on CPU tensors (plain autograd) and SS2DCore give the same
    gradients: the card's custom backward and the CPU's autograd agree."""
    p = _inputs("line", 8, 6, seed=3)
    names = ("x", "wx", "wdt", "bias", "A_logs", "Ds", "scale", "lb")
    a = [_t(p[k]).requires_grad_(True) for k in names] + [_t(p["w_out"].T.copy())]
    b = [t.detach().clone().requires_grad_(True) for t in a]
    a[-1].requires_grad_(True)
    idx, inv = order_tables("line", 6, 6, 0, "cpu")
    ga = torch.autograd.grad(tf.ss2d_full(*a, "line", 6, 6), a, _t(p["g"]))
    gb = torch.autograd.grad(tf.SS2DCore.apply(b[0], idx, inv, *b[1:]), b, _t(p["g"]))
    for i, (x, y) in enumerate(zip(ga, gb)):
        torch.testing.assert_close(x, y, **TOL_AUTOGRAD, msg=f"input {i}")


def _scan_adjoint_f64(a, b, g):
    """float64 loops: h_t = a_t h_{t-1} + b_t forward, then lam_t = g_t +
    a_{t+1} lam_{t+1}; da_t = lam_t h_{t-1}, db_t = lam_t."""
    a, b, g = (np.asarray(v, np.float64) for v in (a, b, g))
    L = a.shape[-2]
    h = np.zeros_like(b)
    prev = np.zeros_like(b[..., 0, :])
    for t in range(L):
        prev = a[..., t, :] * prev + b[..., t, :]
        h[..., t, :] = prev
    lam = np.zeros_like(g)
    nxt = np.zeros_like(g[..., 0, :])
    for t in range(L - 1, -1, -1):
        nxt = g[..., t, :] + (a[..., t + 1, :] * nxt if t + 1 < L else 0.0)
        lam[..., t, :] = nxt
    h_prev = np.concatenate([np.zeros_like(h[..., :1, :]), h[..., :-1, :]], axis=-2)
    return h, lam * h_prev, lam


@pytest.mark.parametrize("L", [1, 37, 200])
def test_linear_scan_grads_match_float64_oracle(L):
    """linear_scan's value and autograd gradients vs a float64 sequential
    loop and its adjoint: rtol 1e-5, atol 1e-6 (fp32 rounding over L steps)."""
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, size=(2, 3, L, 8)).astype(np.float32)
    b = rng.normal(size=(2, 3, L, 8)).astype(np.float32)
    g = rng.normal(size=(2, 3, L, 8)).astype(np.float32)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    h = linear_scan(ta, tb)
    da, db = torch.autograd.grad(h, (ta, tb), _t(g))
    want_h, want_da, want_db = _scan_adjoint_f64(a, b, g)
    for got, want in ((h.detach(), want_h), (da, want_da), (db, want_db)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bf16_training_raises():
    """bf16 training is ported, so SS2DCore no longer refuses it (its bf16
    adjoint is held to JAX in test_torch_bf16_train_ops.py); what still
    raises is a compute dtype the port does not run: float16, at the model
    and at the training CLI."""
    from tramba_tpu_torch import run
    from tramba_tpu_torch.models.registry import build

    p = _inputs("raster", 4, 3, seed=4)
    idx, inv = order_tables("raster", 3, 3, 0, "cpu")
    x = _t(p["x"]).to(torch.bfloat16).requires_grad_(True)
    out = tf.SS2DCore.apply(x, idx, inv, *_core(p), _t(p["scale"]), _t(p["lb"]),
                            _t(p["w_out"].T.copy()))
    (dx,) = torch.autograd.grad(out.float().sum(), x)
    assert out.dtype == dx.dtype == torch.bfloat16 and torch.isfinite(dx.float()).all()
    with pytest.raises(ValueError, match="not supported"):
        build("Tramba-V-TSOD", 64, device="cpu", dtype=torch.float16, dims=16)
    with pytest.raises(SystemExit):
        run.main(["--method", "Tramba-V-TSOD", "--dtype", "float16"], device="cpu")
