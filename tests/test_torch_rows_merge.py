"""Queue 2 rows #2, #3 and #21: the Pallas kernels that K1's and K2's train
variants and K7 stand for, held against the port's plain versions.

``_rows_pallas`` / ``_cols_pallas`` (``tramba_tpu/ops/fused_ss2d.py:294``,
``:344``) and ``_merge_pallas`` (``:426``) are the materialising SS2D train
forward, which JAX takes under ``TRAMBA_TWO_PHASE_TRAIN=0``
(``fused_ss2d.py:940-946``, ``:998-1001``).  They compute what K1's train
variant (``ss2d_scan_train_ref``) and K2's (``ss2d_merge_train_ref``)
compute, in another layout.  With raster directions 0 (row-major), 1
(column-major), 2 and 3 (the two reversed), L = H W, pixel p = h W + w and
column-major position q = w H + h:

* rows (chunks of Tr pixel rows, nT = H / Tr, carry stride Tr W):
  ``y02[b, 0]`` flattened to pixels is ``ys[b, 0, p]``;
  ``y02[b, 1]`` at pixel p is ``ys[b, 2, L - 1 - p]``;
  ``c02[b, 0, j]`` is ``carries[b, 0, j]`` and ``c02[b, 1, j]`` is
  ``carries[b, 2, nT - 1 - j]``: direction 2 visits image chunk j at its scan
  step (nT - 1 - j) Tr W;
* columns (chunks of Tc pixel columns, nT = W / Tc, carry stride H Tc):
  ``y13[b, 0, j, h, c]`` is ``ys[b, 1, q]`` with q = (j Tc + c) H + h, and
  ``y13[b, 1, j, h, c]`` is ``ys[b, 3, L - 1 - q]``; ``c13[b, 0, j]`` is
  ``carries[b, 1, j]`` and ``c13[b, 1, j]`` is ``carries[b, 3, nT - 1 - j]``;
* the merge sums the four maps (and ``y_line``, the line directions'
  pixel-order sum) -> LN -> GELU -> out projection, with the pre-LN sum
  ``y_sum``: K2's train variant over the order's inverse table.

The maps are 24 x 16 (two row chunks of 12, two column chunks of 8) and
24 x 24 (three of 8 each) at D 32, so every carry crosses a chunk boundary.
Tolerances: fp32 rtol 1e-5 / atol 1e-5; bf16 rtol / atol 1e-2.  In bf16
JAX rounds each direction's map to bf16 (``out_shape`` in ``ximg.dtype``,
``:307``) and K1 writes fp32 ``ys``; the merge rounds its output (and the
port's K2 the GELU output too, before the out projection) to bf16; the
carries are fp32 on both sides.  The whole SS2D, forward and every
gradient, is held against ``jax.vjp(fused_ss2d_full)`` on that route (its
``_full_bwd`` on the rows/cols carries) at the fp32 tolerance of
``tests/test_torch_train_ops.py`` (rtol / atol 1e-4).

Row #21, ``_dwms_pallas2`` (``tramba_tpu/ops/fused_mlp.py:457``, #20's
LN-DWMS-MLP with hidden chunks on a grid axis), is held against K7's plain
version at the shape of JAX's own test (``tests/test_fused_mlp.py:195``: B 2,
12 x 8, D 16, hidden 256, row chunk 6, hidden chunk 128): bf16 rtol / atol
1e-2, fp32 atol 2e-5 (JAX's own tolerance there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu.ops.scan_orders import cross_merge
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
TOL_VJP = dict(rtol=1e-4, atol=1e-4)
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
D, R, DM, B = 32, 4, 16, 2


def _rng(seed):
    return np.random.default_rng(seed)


def _params(rng, K):
    f = np.float32
    return dict(wx=(rng.normal(size=(K, R + 2, D)) * 0.2).astype(f),
                wdt=(rng.normal(size=(K, D, R)) * 0.3).astype(f),
                bias=(rng.normal(size=(K, D)) * 0.2).astype(f),
                A_logs=(rng.normal(size=(K, D, 1)) * 0.3).astype(f),
                Ds=rng.normal(size=(K, D)).astype(f),
                scale=(rng.normal(size=(D,)) * 0.1 + 1).astype(f),
                lb=(rng.normal(size=(D,)) * 0.1).astype(f),
                w_out=(rng.normal(size=(D, DM)) * 0.2).astype(f))  # JAX layout (D, dm)


def _t(a, dt="fp32"):
    return torch.from_numpy(np.array(a)).to(TDT[dt])


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rows_cols_from_ys(ys, H, W, Tr, Tc):
    """ys (B, 4, L, D) of the raster order in scan order -> (y02, y13) in the
    rows / columns kernels' layouts (the module doc's index maps)."""
    Bn, _, L, Dn = ys.shape
    y02 = np.stack([ys[:, 0], ys[:, 2, ::-1]], 1).reshape(Bn, 2, H // Tr, Tr, W, Dn)
    y13 = np.stack([ys[:, 1], ys[:, 3, ::-1]], 1).reshape(Bn, 2, W // Tc, Tc, H, Dn)
    return y02, np.ascontiguousarray(y13.transpose(0, 1, 2, 4, 3, 5))


def _chunks(H, W):
    Tr, Tc = jf._row_chunk(H, W, D), jf._col_chunk(W, H, D)
    assert H // Tr > 1 and W // Tc > 1, "the map must span more than one chunk each way"
    return Tr, Tc


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("H,W", [(24, 16), (24, 24)])
def test_rows_cols_pallas_match_k1_train_variant(H, W, dt):
    """_rows_pallas / _cols_pallas (emit_carries=True) against
    ss2d_scan_train_ref with the carry stride of each layout: every
    direction's map and every chunk carry."""
    rng = _rng(H + W + (dt == "bf16"))
    p = _params(rng, 4)
    x = rng.normal(size=(B, H * W, D)).astype(np.float32)
    xj = jnp.asarray(x).astype(JDT[dt])
    Tr, Tc = _chunks(H, W)
    A = -np.exp(p["A_logs"][..., 0])

    def pallas(fn, sel):
        return fn(xj.reshape(B, H, W, D), *(jnp.asarray(p[k][sel]) for k in ("wx", "wdt", "bias")),
                  jnp.asarray(A[sel]), jnp.asarray(p["Ds"][sel]), interpret=True,
                  emit_carries=True)

    y02, c02 = pallas(jf._rows_pallas, [0, 2])
    y13, c13 = pallas(jf._cols_pallas, [1, 3])
    assert y02.dtype == JDT[dt] and c02.dtype == jnp.float32
    idx, _ = order_tables("raster", H, W, 0, "cpu")
    core = [_t(p[k]) for k in ("wx", "wdt", "bias", "A_logs", "Ds")]
    xt = _t(x, dt)
    for chunk, (want_y, want_c), dirs, nT in (
            (Tr * W, (y02, c02), (0, 2), H // Tr), (H * Tc, (y13, c13), (1, 3), W // Tc)):
        ys, carries, _ = tf.ss2d_scan_train_ref(xt, idx, *core, chunk)
        assert ys.dtype == torch.float32 and carries.shape[2] == nT
        got_y = _rows_cols_from_ys(ys.numpy(), H, W, Tr, Tc)[0 if dirs == (0, 2) else 1]
        np.testing.assert_allclose(got_y, _np(want_y), **TOL[dt], err_msg=f"maps {dirs}")
        c = carries.numpy()
        got_c = np.stack([c[:, dirs[0]], c[:, dirs[1], ::-1]], 1)
        np.testing.assert_allclose(got_c, _np(want_c)[:, :, :, 0], **TOL[dt],
                                   err_msg=f"carries {dirs}")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kind,H,W", [("raster", 24, 16), ("line", 24, 24)])
def test_merge_pallas_matches_k2_train_variant(kind, H, W, dt):
    """_merge_pallas (emit_ysum=True) against ss2d_merge_train_ref over the
    order's inverse table: raster (the four maps alone) and line (the maps
    plus ``y_line``, directions 4-7 merged by JAX's own ``cross_merge``)."""
    rng = _rng(3 * H + W + (dt == "bf16"))
    p = _params(rng, 1)
    K = 8 if kind == "line" else 4
    ys = rng.normal(size=(B, K, H * W, D)).astype(np.float32)
    if dt == "bf16":  # the maps JAX merges are bf16
        ys = _np(jnp.asarray(ys).astype(jnp.bfloat16))
    Tr, Tc = _chunks(H, W)
    y02, y13 = _rows_cols_from_ys(ys[:, :4], H, W, Tr, Tc)
    y_line = None
    if kind == "line":
        only_line = ys.copy()
        only_line[:, :4] = 0
        y_line = cross_merge(jnp.asarray(only_line), "line", H, W, 0)
    w_out = jnp.asarray(p["w_out"]).astype(JDT[dt])
    out, y_sum = jf._merge_pallas(jnp.asarray(y02).astype(JDT[dt]),
                                  jnp.asarray(y13).astype(JDT[dt]), y_line,
                                  jnp.asarray(p["scale"]), jnp.asarray(p["lb"]), w_out, H=H, W=W,
                                  interpret=True, emit_ysum=True)
    _, inv = order_tables(kind, H, W, 0, "cpu")
    got_out, got_sum = tf.ss2d_merge_train_ref(
        _t(ys), inv, _t(p["scale"]), _t(p["lb"]), torch.from_numpy(_np(w_out).T.copy()).to(TDT[dt]))
    assert got_out.dtype == got_sum.dtype == TDT[dt]
    np.testing.assert_allclose(got_sum.float().numpy(), _np(y_sum), **TOL[dt], err_msg="y_sum")
    np.testing.assert_allclose(got_out.float().numpy(), _np(out), **TOL[dt], err_msg="out")


@pytest.fixture
def materialising_route(monkeypatch):
    """TRAMBA_TWO_PHASE_TRAIN=0 read at trace time in a fresh jit, JAX's
    caches cleared around the case; counts the route's Pallas calls."""
    calls = {}
    for name in ("_rows_pallas", "_cols_pallas", "_merge_pallas", "_pair_phase1"):
        fn = getattr(jf, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(jf, name, counted)
    monkeypatch.setenv("TRAMBA_TWO_PHASE_TRAIN", "0")
    jax.clear_caches()
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("kind,H,W", [("raster", 24, 16), ("line", 24, 24)])
def test_ss2d_core_matches_jax_vjp_on_the_rows_cols_route(kind, H, W, materialising_route):
    """SS2DCore on CPU tensors (K1 / K2 train variants' and K8's plain
    versions) against jax.vjp(fused_ss2d_full) with TRAMBA_TWO_PHASE_TRAIN=0:
    the output and all nine gradients; JAX's route runs _rows_pallas,
    _cols_pallas and _merge_pallas (and _full_bwd on their carries)."""
    K = 8 if kind == "line" else 4
    rng = _rng(5 * H + W)
    p = _params(rng, K)
    x = rng.normal(size=(B, H * W, D)).astype(np.float32)
    g = rng.normal(size=(B, H * W, DM)).astype(np.float32)
    names = ("wx", "wdt", "bias", "A_logs", "Ds", "scale", "lb", "w_out")
    fn = functools.partial(jf.fused_ss2d_full, kind=kind, H=H, W=W)

    @jax.jit
    def vjp(*args):
        out, back = jax.vjp(lambda *a: fn(*a), *args)
        return out, back(jnp.asarray(g))

    want_out, want = vjp(jnp.asarray(x), *(jnp.asarray(p[k]) for k in names))
    assert materialising_route == {"_rows_pallas": 1, "_cols_pallas": 1, "_merge_pallas": 1}
    idx, inv = order_tables(kind, H, W, 0, "cpu")
    leaves = [_t(x).requires_grad_(True)] + [_t(p[k]).requires_grad_(True) for k in names[:-1]]
    w_out = _t(p["w_out"].T).requires_grad_(True)
    out = tf.SS2DCore.apply(leaves[0], idx, inv, *leaves[1:], w_out)
    got = torch.autograd.grad(out, leaves + [w_out], _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL_VJP)
    for name, gt, w in zip(("x",) + names, got, want):
        w = np.asarray(w)
        gt = gt.numpy().T if name == "w_out" else gt.numpy().reshape(w.shape)
        np.testing.assert_allclose(gt, w, **TOL_VJP, err_msg=f"d{name}")


def _dwms_args(rng):
    """#21's inputs in JAX layouts (tests/test_fused_mlp.py:195-201)."""
    Bn, H, W, d, hid = 2, 12, 8, 16, 256
    t = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    args = [t(Bn, H, W, d), t(d) + 1.0, t(d), t(d, hid), t(hid)]
    for k in (3, 5, 7):
        args += [t(k, k, 1, hid), t(hid)]
    return args + [t(hid, d), t(d)]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_dwms_pallas2_matches_k7_plain(dt):
    """_dwms_pallas2 (two row blocks of 6, two hidden chunks of 128 on the
    grid) against K7's plain version ln_dwms_mlp_ref."""
    args = _dwms_args(_rng(13))
    want = jm._dwms_pallas2(jnp.asarray(args[0]).astype(JDT[dt]), *map(jnp.asarray, args[1:]),
                            interpret=True, row_chunk=6, hidden_chunk=128)
    x, s, b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2 = args
    conv = lambda k: _t(k.transpose(3, 2, 0, 1), dt)  # noqa: E731  (k, k, 1, C) -> (C, 1, k, k)
    got = tm.ln_dwms_mlp_ref(_t(x, dt), _t(s), _t(b), _t(w1.T, dt), _t(b1), conv(k3), _t(c3),
                             conv(k5), _t(c5), conv(k7), _t(c7), _t(w2.T, dt), _t(b2))
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    tol = TOL["bf16"] if dt == "bf16" else dict(rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
