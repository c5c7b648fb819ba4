"""Plain versions of kernels K1-K7 in bf16 (and K5-K7 in fp32) vs the JAX package.

The same numpy inputs, rounded to bf16 on both sides, go through the JAX
Pallas kernels in interpret mode on the CPU (``_prologue_pallas``,
``_mlp_pallas``, ``_dwms_pallas``, ``_fused_pallas``, ``_lgp_pallas``,
``_expand_pallas``, ``_final_head_pallas``, ``_small_pallas``) and through
the port's plain versions, which round where those kernels round.
Tolerances: bf16 rtol 1e-2, atol 1e-2, about one bf16 ulp at the output (the
two sides sum in other orders, which may flip a rounding); fp32 rtol 1e-4,
atol 1e-5.  The #13 chain (prologue -> raster scan -> merge) against
``_small_pallas`` rounds its direction sum elsewhere and is held at the JAX
package's own bf16 tolerance, 5e-2 (tests/test_ss2d_small.py:64).  Weights go
to the port in torch layout: Linear (out, in), Conv2d (C, 1, k, k).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_expand as je
from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu.ops.fused_prologue import _prologue_pallas
from tramba_tpu.ops.fused_ss2d_small import _lgp_pallas, _small_pallas
from tramba_tpu.ops.scan_orders import cross_scan
from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = {"bf16": dict(rtol=1e-2, atol=1e-2), "fp32": dict(rtol=1e-4, atol=1e-5)}
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}
DTYPES = ["bf16", "fp32"]


def _rng(seed):
    return np.random.default_rng(seed)


def _r(rng, *shape, scale=0.2, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _j(a, dt="fp32"):
    return jnp.asarray(a).astype(JDT[dt])


def _t(a, dt="fp32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def _close(got: torch.Tensor, want, dt):
    assert tuple(got.shape) == want.shape
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dt])


def _conv_t(k):
    """flax depthwise kernel (k, k, 1, C) -> torch Conv2d weight (C, 1, k, k)."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


# --- K5 prologue (#15, fused_prologue.py:94) --------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("with_ln", [True, False])
def test_prologue_ref_vs_pallas(dt, with_ln):
    """Rows chunked by 4 with a 1-row halo, in_proj chunked by 16 channels."""
    rng = _rng(1 + with_ln)
    B, H, W, dm, D = 2, 12, 8, 16, 32
    x, w_in, k = _r(rng, B, H, W, dm, scale=1.0), _r(rng, dm, D), _r(rng, 3, 3, 1, D, scale=0.3)
    s, b = _r(rng, dm, scale=0.1, shift=1.0), _r(rng, dm, scale=0.1)
    ln_j = (jnp.asarray(s), jnp.asarray(b)) if with_ln else (None, None)
    ln_t = (_t(s), _t(b)) if with_ln else (None, None)
    want = _prologue_pallas(_j(x, dt), *ln_j, jnp.asarray(w_in), jnp.asarray(k),
                            interpret=True, row_chunk=4, inner_chunk=16)
    got = tp.prologue_ref(_t(x, dt), *ln_t, _t(w_in.T, dt), _t(_conv_t(k), dt))
    _close(got, want, dt)


def test_prologue_pads_the_projection_not_the_input():
    """With an LN bias, in_proj of a zero-padded x is not 0: the border of the
    output must match a conv over the zero-padded projection."""
    rng = _rng(3)
    x, w_in, k = _r(rng, 1, 4, 4, 16, scale=1.0), _r(rng, 16, 16), _r(rng, 3, 3, 1, 16)
    s, b = np.ones(16, np.float32), np.full(16, 2.0, np.float32)
    want = _prologue_pallas(_j(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w_in),
                            jnp.asarray(k), interpret=True, row_chunk=2)
    got = tp.prologue_ref(_t(x), _t(s), _t(b), _t(w_in.T), _t(_conv_t(k)))
    _close(got, want, "fp32")


# --- K6 ln_mlp (#18, fused_mlp.py:130) ---------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
def test_ln_mlp_ref_vs_pallas(dt):
    rng = _rng(4)
    B, L, d, hid = 2, 96, 16, 64
    x = _r(rng, B, L, d, scale=1.0)
    s, b = _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1)
    w1, b1, w2, b2 = _r(rng, d, hid), _r(rng, hid, scale=0.1), _r(rng, hid, d), _r(rng, d, scale=0.1)
    want = jm._mlp_pallas(_j(x, dt), *map(jnp.asarray, (s, b, w1, b1, w2, b2)), interpret=True)
    got = tm.ln_mlp_ref(_t(x, dt), _t(s), _t(b), _t(w1.T, dt), _t(b1), _t(w2.T, dt), _t(b2))
    _close(got, want, dt)


# --- K7 ln_dwms_mlp (#20, fused_mlp.py:360) ----------------------------------


def _dwms_inputs(rng, B, H, W, d, hid):
    out = [_r(rng, B, H, W, d, scale=1.0), _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1),
           _r(rng, d, hid), _r(rng, hid, scale=0.1)]
    for n in (3, 5, 7):
        out += [_r(rng, n, n, 1, hid), _r(rng, hid, scale=0.1)]
    return out + [_r(rng, hid, d), _r(rng, d, scale=0.1)]


def _dwms_port_args(args, dt):
    """The JAX-layout numpy inputs as the port's tensors: x and the weights
    in ``dt``, LN parameters and biases fp32."""
    x, s, b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2 = args
    return (_t(x, dt), _t(s), _t(b), _t(w1.T, dt), _t(b1), _t(_conv_t(k3), dt), _t(c3),
            _t(_conv_t(k5), dt), _t(c5), _t(_conv_t(k7), dt), _t(c7), _t(w2.T, dt), _t(b2))


def _dwms_port(args, dt):
    return tm.ln_dwms_mlp_ref(*_dwms_port_args(args, dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H,W,row_chunk,hidden_chunk", [(12, 16, 4, 32), (8, 8, 8, 64)])
def test_ln_dwms_mlp_ref_vs_pallas(dt, H, W, row_chunk, hidden_chunk):
    """row_chunk 4: each row block takes its 3-row halos from both neighbours
    (7x7 taps cross the block edges); hidden chunks of 32 of 64 channels."""
    args = _dwms_inputs(_rng(H + W), 2, H, W, 16, 64)
    want = jm._dwms_pallas(_j(args[0], dt), *map(jnp.asarray, args[1:]), interpret=True,
                           row_chunk=row_chunk, hidden_chunk=hidden_chunk)
    _close(_dwms_port(args, dt), want, dt)


def test_ln_dwms_mlp_ref_vs_composed_fp32():
    args = _dwms_inputs(_rng(5), 1, 8, 12, 16, 32)
    want = jax.jit(jm.composed_ln_dwmsmlp)(*map(jnp.asarray, args))
    _close(_dwms_port(args, "fp32"), want, "fp32")


# --- K1 / K2 in bf16 (#13 rounding points, fused_ss2d_small.py:150-228) ------


def _ss2d_params(rng, K, D, R, dm):
    return dict(wx=_r(rng, K, R + 2, D), wdt=_r(rng, K, D, R, scale=0.3), bias=_r(rng, K, D),
                A_logs=_r(rng, K, D, 1, scale=0.3), Ds=_r(rng, K, D, scale=1.0),
                s=_r(rng, D, scale=0.1, shift=1.0), b=_r(rng, D, scale=0.1),
                w_out=_r(rng, D, dm))  # JAX layout (D, dm)


def _core(p):
    return [p[k] for k in ("wx", "wdt", "bias", "A_logs", "Ds")]


@pytest.mark.parametrize("kind,K,param", [("raster", 4, 0), ("window", 4, 4)])
def test_scan_ref_bf16_vs_fused_core(kind, K, param):
    """K1's plain version on a bf16 x: fp32 projections and state, fp32 ys,
    against _fused_pallas on the same bf16 sequences (its ys rounded to bf16)."""
    rng = _rng(6)
    H, D = 8, 32
    x = _r(rng, 2, H * H, D, scale=1.0)
    p = _ss2d_params(rng, K, D, 3, 8)
    xs = jax.jit(functools.partial(cross_scan, kind=kind, H=H, W=H, param=param))(_j(x, "bf16"))
    want = jf.fused_ss2d_core(xs, *map(jnp.asarray, _core(p)))
    idx, _ = order_tables(kind, H, H, param, "cpu")
    got = tf.ss2d_scan_ref(_t(x, "bf16"), idx, *map(_t, _core(p)))
    assert got.dtype == torch.float32 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.numpy(), np.asarray(want).astype(np.float32), **TOL["bf16"])


def test_merge_ref_bf16_vs_lgp():
    """K2's plain version with a bf16 w_out, K=4 raster: ys on a 1/8 grid, so
    the direction sum is exact in bf16 and _lgp_pallas on that sum has the
    same rounding points."""
    rng = _rng(7)
    H, D, dm = 8, 32, 16
    ys = (np.round(rng.normal(size=(2, 4, H * H, D)) * 8) / 8).astype(np.float32)
    p = _ss2d_params(rng, 4, D, 3, dm)
    _, inv = order_tables("raster", H, H, 0, "cpu")
    got = tf.ss2d_merge_ref(_t(ys), inv, _t(p["s"]), _t(p["b"]), _t(p["w_out"].T, "bf16"))
    pad = np.concatenate([ys, np.zeros((2, 4, 1, D), np.float32)], axis=2)
    inv_np = inv.numpy()
    ysum = sum(pad[:, k, inv_np[k, 0]] for k in range(4))
    want = _lgp_pallas(_j(ysum, "bf16"), jnp.asarray(p["s"]), jnp.asarray(p["b"]),
                       jnp.asarray(p["w_out"]), interpret=True)
    _close(got, want, "bf16")


@pytest.mark.parametrize("dt", DTYPES)
def test_merge_one_slot_identity_is_lgp(dt):
    """Queue 2 #14: _lgp_pallas (LN -> GELU -> out_proj) is K2 with K=1 and a
    one-slot identity inverse table."""
    rng = _rng(8)
    L, D, dm = 48, 32, 16
    y = _r(rng, 2, L, D, scale=1.0)
    y = torch.from_numpy(y).to(TDT[dt]).float().numpy()  # representable in dt
    s, b, w_out = _r(rng, D, scale=0.1, shift=1.0), _r(rng, D, scale=0.1), _r(rng, D, dm)
    inv = torch.arange(L, dtype=torch.int32).reshape(1, 1, L)
    got = tf.ss2d_merge_ref(_t(y[:, None]), inv, _t(s), _t(b), _t(w_out.T, dt))
    want = _lgp_pallas(_j(y, dt), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w_out),
                       interpret=True)
    _close(got, want, dt)


def test_small_chain_vs_small_pallas():
    """Queue 2 #13: prologue (LN) -> raster scan -> merge, the K5 -> K1 -> K2
    chain, against the whole-map _small_pallas, bf16."""
    rng = _rng(9)
    B, H, W, dm, D, R = 2, 8, 8, 16, 32, 3
    x = _r(rng, B, H * W, dm, scale=1.0)
    ln1 = (_r(rng, dm, scale=0.1, shift=1.0), _r(rng, dm, scale=0.1))
    w_in, k = _r(rng, dm, D), _r(rng, 3, 3, 1, D, scale=0.3)
    p = _ss2d_params(rng, 4, D, R, dm)
    want = _small_pallas(_j(x, "bf16"), tuple(map(jnp.asarray, ln1)), jnp.asarray(w_in),
                         jnp.asarray(k), *map(jnp.asarray, _core(p)), jnp.asarray(p["s"]),
                         jnp.asarray(p["b"]), jnp.asarray(p["w_out"]), H, W, interpret=True)
    u = tp.prologue_ref(_t(x.reshape(B, H, W, dm), "bf16"), *map(_t, ln1), _t(w_in.T, "bf16"),
                        _t(_conv_t(k), "bf16"))
    idx, inv = order_tables("raster", H, W, 0, "cpu")
    ys = tf.ss2d_scan_ref(u.reshape(B, H * W, D), idx, *map(_t, _core(p)))
    got = tf.ss2d_merge_ref(ys, inv, _t(p["s"]), _t(p["b"]), _t(p["w_out"].T, "bf16"))
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=5e-2, atol=5e-2)


# --- K3 / K4 in bf16 (#16, #17) ------------------------------------------------


@pytest.mark.parametrize("factor", [2, 4])
def test_expand_ln_ref_bf16_vs_pallas(factor):
    rng = _rng(10 + factor)
    C = 32
    co = factor * C // 4
    x, w = _r(rng, 2, 6, 8, C, scale=1.0), _r(rng, C, factor * C)
    s, b = _r(rng, co, scale=0.1, shift=1.0), _r(rng, co, scale=0.1)
    want = je._expand_pallas(_j(x, "bf16"), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b),
                             interpret=True)
    _close(te.expand_ln_ref(_t(x, "bf16"), _t(w.T, "bf16"), _t(s), _t(b)), want, "bf16")


def test_final_head_ref_bf16_vs_pallas():
    rng = _rng(13)
    C = 32
    x, w1 = _r(rng, 2, 4, 8, C, scale=1.0), _r(rng, C, 16 * C)
    s, b, wh, bh = _r(rng, C, shift=1.0), _r(rng, C), _r(rng, C), _r(rng, 1)
    want = je._final_head_pallas(_j(x, "bf16"), *map(jnp.asarray, (w1, s, b, wh, bh)),
                                 interpret=True)
    got = te.final_head_ref(_t(x, "bf16"), _t(w1.T, "bf16"), *map(_t, (s, b, wh, bh)))
    _close(got, want, "bf16")


# --- dispatch ----------------------------------------------------------------


def test_new_wrappers_take_plain_version_on_cpu():
    """CPU tensors take the plain version and count no launch; a device with
    neither a kernel nor a plain version raises."""
    rng = _rng(14)
    x = _t(_r(rng, 1, 8, 8, 16, scale=1.0), "bf16")
    s, b = _t(_r(rng, 16, shift=1.0)), _t(_r(rng, 16))
    w_in, k = _t(_r(rng, 32, 16), "bf16"), _t(_r(rng, 32, 1, 3, 3), "bf16")
    assert torch.equal(tp.prologue(x, s, b, w_in, k), tp.prologue_ref(x, s, b, w_in, k))
    assert torch.equal(tp.prologue(x, None, None, w_in, k),
                       tp.prologue_ref(x, None, None, w_in, k))
    mlp = (_t(_r(rng, 64, 16), "bf16"), _t(_r(rng, 64)), _t(_r(rng, 16, 64), "bf16"),
           _t(_r(rng, 16)))
    assert torch.equal(tm.ln_mlp(x, s, b, *mlp), tm.ln_mlp_ref(x, s, b, *mlp))
    args = _dwms_inputs(rng, 1, 8, 8, 16, 64)
    got = tm.ln_dwms_mlp(*_dwms_port_args(args, "bf16"))
    assert torch.equal(got, _dwms_port(args, "bf16"))
    assert tp.prologue.launches == tm.ln_mlp.launches == tm.ln_dwms_mlp.launches == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        tm.ln_mlp(x.to("meta"), s, b, *mlp)

