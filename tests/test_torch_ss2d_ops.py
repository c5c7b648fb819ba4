"""Plain versions of kernels K1 (ss2d_scan) and K2 (ss2d_merge) vs the JAX package.

The same numpy inputs go through the JAX functions (composed oracles, and the
Pallas kernels in interpret mode on the CPU) and through the port.  fp32
throughout; tolerance rtol 1e-4, atol 1e-5: the two sides sum in other
orders (associative vs sequential scan, fused vs split products).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu.ops.scan_orders import cross_merge, cross_scan
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = [("raster", 4, 0), ("line", 8, 0), ("dilation", 4, 4), ("window", 4, 4)]


def _params(K, D, R, dm, rng):
    return dict(
        wx=(rng.normal(size=(K, R + 2, D)) * 0.2).astype(np.float32),
        wdt=(rng.normal(size=(K, D, R)) * 0.3).astype(np.float32),
        bias=(rng.normal(size=(K, D)) * 0.2).astype(np.float32),
        A_logs=(rng.normal(size=(K, D, 1)) * 0.3).astype(np.float32),
        Ds=rng.normal(size=(K, D)).astype(np.float32),
        scale=(rng.normal(size=(D,)) * 0.1 + 1).astype(np.float32),
        lb=(rng.normal(size=(D,)) * 0.1).astype(np.float32),
        w_out=(rng.normal(size=(D, dm)) * 0.2).astype(np.float32),  # JAX layout (D, dm)
    )


def _core(p):
    return [p[k] for k in ("wx", "wdt", "bias", "A_logs", "Ds")]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jit(fn, **static):
    """jax.jit of ``fn`` with keyword arguments bound: one compile instead of
    one per eager op."""
    return jax.jit(functools.partial(fn, **static))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def core_inputs():
    rng = np.random.default_rng(0)
    B, K, L, D, R = 2, 4, 72, 16, 3
    xs = rng.normal(size=(B, K, L, D)).astype(np.float32)
    return xs, _core(_params(K, D, R, 8, rng))


def test_core_ref_vs_composed(core_inputs):
    xs, core = core_inputs
    want = _jit(jf.composed_ss2d_core)(*_j(xs, *core))
    _close(tf.ss2d_core_ref(*_t(xs, *core)), want)


def test_core_ref_vs_fused_core_interpret(core_inputs):
    """fused_ss2d_core (Pallas _fused_pallas) in interpret mode on the CPU."""
    xs, core = core_inputs
    want = jf.fused_ss2d_core(*_j(xs, *core))
    _close(tf.ss2d_core_ref(*_t(xs, *core)), want)


def _full_inputs(kind, K, H, seed, D=16, R=3, dm=8, B=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H * H, D)).astype(np.float32)
    return x, _params(K, D, R, dm, rng)


def _port_full(x, p, kind, H, param):
    args = _t(x, *_core(p), p["scale"], p["lb"], p["w_out"].T)
    return tf.ss2d_full(*args, kind, H, H, param)


def _jax_args(x, p):
    return _j(x, *_core(p), p["scale"], p["lb"], p["w_out"])


@pytest.mark.parametrize("kind,K,param", KINDS)
def test_scan_ref_vs_composed(kind, K, param):
    """K1's plain version: gather through the order's table, then the core."""
    H = 12
    x, p = _full_inputs(kind, K, H, seed=H)
    xs = _jit(cross_scan, kind=kind, H=H, W=H, param=param)(jnp.asarray(x))
    want = _jit(jf.composed_ss2d_core)(xs, *_j(*_core(p)))
    idx, _ = order_tables(kind, H, H, param, "cpu")
    _close(tf.ss2d_scan_ref(*_t(x), idx, *_t(*_core(p))), want)


@pytest.mark.parametrize("kind,K,param", KINDS)
def test_merge_ref_vs_composed(kind, K, param):
    """K2's plain version: inverse-table merge, LN, GELU, out projection."""
    H = 12
    rng = np.random.default_rng(5)
    ys = rng.normal(size=(2, K, H * H, 16)).astype(np.float32)
    p = _params(K, 16, 3, 8, rng)
    y = _jit(cross_merge, kind=kind, H=H, W=H, param=param)(jnp.asarray(ys))
    want = _jit(jf._ln_gelu_proj, dtype=jnp.float32)(y, *_j(p["scale"], p["lb"], p["w_out"]))
    _, inv = order_tables(kind, H, H, param, "cpu")
    _close(tf.ss2d_merge_ref(*_t(ys), inv, *_t(p["scale"], p["lb"], p["w_out"].T)), want)


@pytest.mark.parametrize("kind,K,param", KINDS)
@pytest.mark.parametrize("H", [8, 12])
def test_full_vs_composed(kind, K, param, H):
    x, p = _full_inputs(kind, K, H, seed=2)
    if kind in ("raster", "line"):
        want = _jit(jf.composed_ss2d_full, kind=kind, H=H, W=H)(*_jax_args(x, p))
    else:
        want = _jit(jf.composed_ss2d_full_p, kind=kind, H=H, W=H, param=param)(*_jax_args(x, p))
    _close(_port_full(x, p, kind, H, param), want)


@pytest.mark.parametrize("kind,param", [("dilation", 4), ("window", 4)])
@pytest.mark.parametrize("H", [8, 12])
def test_full_vs_fused_freq_interpret(kind, param, H):
    """fused_ss2d_freq (_pair_phase1/_pair_carries/_pair_phase2_rows_plain and
    _freq_merge_pallas) in interpret mode on the CPU."""
    x, p = _full_inputs(kind, 4, H, seed=3)
    want = jf.fused_ss2d_freq(*_jax_args(x, p), kind, H, H, param)
    _close(_port_full(x, p, kind, H, param), want)


@pytest.mark.slow
@pytest.mark.parametrize("kind,K", [("raster", 4), ("line", 8)])
def test_full_vs_fused_full_interpret(kind, K):
    """fused_ss2d_full (the two-phase pair kernels and _line_pair_pallas) in
    interpret mode: slow on the CPU."""
    x, p = _full_inputs(kind, K, 8, seed=4)
    want = jf.fused_ss2d_full(*_jax_args(x, p), kind, 8, 8)
    _close(_port_full(x, p, kind, 8, 0), want)


def test_wrappers_dispatch_by_device(core_inputs):
    """CPU tensors take the plain version; a device with neither raises."""
    xs, core = core_inputs
    x = torch.from_numpy(xs[:, 0].copy())
    idx, inv = order_tables("raster", 8, 9, 0, "cpu")
    ys = tf.ss2d_scan(x, idx, *_t(*core))
    assert torch.equal(ys, tf.ss2d_scan_ref(x, idx, *_t(*core)))
    assert tf.ss2d_scan.launches == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        tf.ss2d_scan(x.to("meta"), idx, *_t(*core))
