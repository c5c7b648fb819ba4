"""The segment algebra of K1's and K8's scans (``ops/scan_segments.py``) on
the CPU, against the sequential plain versions and the JAX Pallas kernels.

K1 and K8 cut each direction's L steps into segments that run at once: a
segment's recurrence from a zero state gives its summary (end state or
outgoing lam, and its decay), a carry pass over the summaries gives each
segment its true entry, and the segment runs again from there.  The mirror
does the same in plain PyTorch, and here it is held

* against ``ss2d_scan_train_ref`` / ``ss2d_scan_bwd_ref`` (the sequential
  plain versions, which the card's phase 3 holds the kernels to): fp32
  rtol 1e-5 / atol 1e-5 forward and each gradient's max abs error <= 1e-5 x
  its largest magnitude (the carry pass regroups the products of decays);
* against ``_fused_pallas`` (K1's forward and chunk carries), ``_seq_bwd_pallas``
  (the line directions' adjoint) and ``_dirs_bwd_call`` (through
  ``_rows_bwd_pallas``: the raster rows' adjoint in the image layout) in
  interpret mode: fp32 rtol / atol 1e-4 (associative scans on the JAX side,
  as ``tests/test_torch_train_ops.py``), bf16 1e-2 (JAX rounds its outputs
  to bf16).

Cases: raster, line, window and dilation tables; L a multiple of the
segment or not; one segment; segments shorter than a chunk; fp32 and bf16
inputs; the main path's d_state 1 (the only one these kernels run).  With
the carry dropped between segments the mirror must miss, so the cases do
reach across segments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops import scan_segments as sm
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL_REF = dict(rtol=1e-5, atol=1e-5)
# max abs error / largest magnitude: fp32 outputs 1e-5; a bf16 dx may round
# one element the other way, 2^-8 of the largest at most
REL_REF = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
TOL_JAX = {"fp32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
CHUNK = 64
D, R, B = 16, 3, 2

# (order, map size, window / rate, segment steps, dtype): L = 144 cut into
# 64 + 64 + 16, one segment of 200 >= L, segments of 16 (shorter than a
# chunk) and of 48 (whose boundaries fall inside chunks), L = 49 in 16s
CASES = [("raster", 12, 0, 64, "fp32"), ("raster", 12, 0, 200, "fp32"),
         ("line", 12, 0, 16, "fp32"), ("window", 12, 4, 48, "bf16"),
         ("dilation", 12, 4, 64, "bf16"), ("raster", 7, 0, 16, "fp32")]


def _ids(cases):
    return [f"{k}{p or ''}-{h}px-seg{s}-{dt}" for k, h, p, s, dt in cases]


def _inputs(kind, H, seed):
    rng = np.random.default_rng(seed)
    K = 8 if kind == "line" else 4
    f = np.float32
    return dict(x=rng.normal(size=(B, H * H, D)).astype(f),
                wx=(rng.normal(size=(K, R + 2, D)) * 0.2).astype(f),
                wdt=(rng.normal(size=(K, D, R)) * 0.3).astype(f),
                bias=(rng.normal(size=(K, D)) * 0.2).astype(f),
                # decays near 1 so that a carry lasts across segments
                A_logs=(rng.normal(size=(K, D, 1)) * 0.3 - 2.0).astype(f),
                Ds=rng.normal(size=(K, D)).astype(f),
                g_y=rng.normal(size=(B, H * H, D)).astype(f))


def _t(a, dt="fp32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def _core(p):
    return [_t(p[k]) for k in ("wx", "wdt", "bias", "A_logs", "Ds")]


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_close(got, want, rel, name):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale, f"{name}: max abs error {err} > {rel} x {scale}"


@pytest.mark.parametrize("kind,H,param,seg,dt", CASES, ids=_ids(CASES))
def test_segmented_scan_matches_sequential(kind, H, param, seg, dt):
    """K1's decomposition (summaries, carry pass, each segment again from
    its entry) against the sequential train variant: ys, chunk carries and
    the projections."""
    p = _inputs(kind, H, seed=H + seg)
    idx, _ = order_tables(kind, H, H, param, "cpu")
    x, core = _t(p["x"], dt), _core(p)
    want = tf.ss2d_scan_train_ref(x, idx, *core, CHUNK)
    got = sm.ss2d_scan_segmented(x, idx, *core, seg=seg, chunk=CHUNK)
    for name, g, w in zip(("ys", "carries", "dbc"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, **TOL_REF, msg=name)


@pytest.mark.parametrize("kind,H,param,seg,dt", CASES, ids=_ids(CASES))
def test_segmented_adjoint_matches_sequential(kind, H, param, seg, dt):
    """K8's decomposition (lam summaries, reverse carry pass, each segment
    again from the lam entering it) against the sequential explicit
    adjoint, on the sequential forward's carries: all six outputs."""
    p = _inputs(kind, H, seed=2 * H + seg)
    idx, inv = order_tables(kind, H, H, param, "cpu")
    x, g_y, core = _t(p["x"], dt), _t(p["g_y"], dt), _core(p)
    _, carries, dbc = tf.ss2d_scan_train_ref(x, idx, *core, CHUNK)
    args = (x, idx, inv, g_y, carries, dbc, *core)
    want = tf.ss2d_scan_bwd_ref(*args, chunk=CHUNK)
    got = sm.ss2d_scan_bwd_segmented(*args, seg=seg, chunk=CHUNK)
    for name, g, w in zip(("dx", "dwx", "dwdt", "dbias", "dA_logs", "dDs"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _rel_close(g, w, REL_REF[g.dtype], name)


@pytest.mark.parametrize("adjoint", [False, True], ids=["scan", "adjoint"])
def test_dropped_carry_misses(adjoint):
    """The cases reach across segments: with the carry pass's entries set
    to 0 (h for K1, lam for K8) the mirror misses the sequential version by
    far more than the tolerance."""
    p = _inputs("raster", 12, seed=5)
    idx, inv = order_tables("raster", 12, 12, 0, "cpu")
    x, core = _t(p["x"]), _core(p)
    seg = 32
    if not adjoint:
        la, b, xs, dbcs, _ = sm.scan_terms(x, idx, *core)
        entries = sm.carry_in(*sm.scan_summaries(la, b, seg))
        assert entries[:, :, 1:].abs().max() > 0.1
        ys = sm.scan_outputs(sm.scan_from(la, b, torch.zeros_like(entries), seg), xs, dbcs,
                             core[4])[0]
        want = tf.ss2d_scan_train_ref(x, idx, *core)[0]
    else:
        _, carries, dbc = tf.ss2d_scan_train_ref(x, idx, *core)
        terms = sm.adjoint_terms(x, idx, _t(p["g_y"]), dbc, *core[1:4])
        E = sm.carry_back(*sm.adjoint_summaries(terms[0], terms[1], seg))
        assert E[:, :, :-1].abs().max() > 0.1
        lam = sm.adjoint_from(terms[0], terms[1], torch.zeros_like(E), seg)
        ys = sm.adjoint_outputs(lam, terms, inv, carries, x.dtype, core[0], core[1], core[4])[0]
        want = tf.ss2d_scan_bwd_ref(x, idx, inv, _t(p["g_y"]), carries, dbc, *core)[0]
    err = (ys - want).abs().max().item()
    assert err > 100 * REL_REF[torch.float32] * want.abs().max().item()


def test_carry_passes_compose_segment_maps():
    """carry_in / carry_back are the composition of the segments' affine
    maps h -> P h + e (and lam's, backwards), checked on random summaries
    against an explicit product in float64."""
    rng = np.random.default_rng(7)
    S = 5
    e = rng.normal(size=(1, 1, S, 3))
    la = -rng.random(size=(1, 1, S, 3))
    fwd = sm.carry_in(torch.from_numpy(e), torch.from_numpy(la)).numpy()
    back = sm.carry_back(torch.from_numpy(e), torch.from_numpy(la)).numpy()
    for s in range(S):
        want_f = sum(np.exp(la[..., j + 1:s, :].sum(-2)) * e[..., j, :] for j in range(s))
        want_b = sum(np.exp(la[..., s + 1:j, :].sum(-2)) * e[..., j, :] for j in range(s + 1, S))
        np.testing.assert_allclose(fwd[..., s, :], want_f + 0 * e[..., 0, :], rtol=1e-12)
        np.testing.assert_allclose(back[..., s, :], want_b + 0 * e[..., 0, :], rtol=1e-12)


def _jax_seq(p, idx, dt):
    """x and g_y gathered into JAX's (B K, L, D) scan-order rows (r = b K + k)
    and the parameters as ``_fused_pallas`` takes them."""
    il = idx.numpy()
    K = il.shape[0]
    xs = jnp.asarray(p["x"][:, il].reshape(B * K, -1, D)).astype(JDT[dt])
    gs = jnp.asarray(p["g_y"][:, il].reshape(B * K, -1, D)).astype(JDT[dt])
    A = -np.exp(p["A_logs"][..., 0])
    par = tuple(jnp.asarray(v) for v in (p["wx"], p["wdt"], p["bias"], A, p["Ds"]))
    return xs, gs, par


JAX_FWD = [("raster", 12, 0, 64, "fp32"), ("line", 12, 0, 16, "bf16"),
           ("window", 12, 4, 48, "fp32")]


@pytest.mark.parametrize("kind,H,param,seg,dt", JAX_FWD, ids=_ids(JAX_FWD))
def test_segmented_scan_matches_fused_pallas(kind, H, param, seg, dt):
    """_fused_pallas (emit_carries=True, chunks of 64) in interpret mode
    against the mirror: each direction's ys and its chunk carries."""
    p = _inputs(kind, H, seed=3 * H + seg)
    idx, _ = order_tables(kind, H, H, param, "cpu")
    K = idx.shape[0]
    xs, _, par = _jax_seq(p, idx, dt)
    ys, carries = jf._fused_pallas(xs, *par, K=K, R=R, chunk=CHUNK, interpret=True,
                                   emit_carries=True)
    got_ys, got_c, _ = sm.ss2d_scan_segmented(_t(p["x"], dt), idx, *_core(p), seg=seg,
                                              chunk=CHUNK)
    np.testing.assert_allclose(got_ys.reshape(B * K, -1, D).numpy(), _np(ys), **TOL_JAX[dt],
                               err_msg="ys")
    np.testing.assert_allclose(got_c.reshape(B * K, -1, D).numpy(), _np(carries)[:, :, 0],
                               **TOL_JAX["fp32"], err_msg="carries")


def _grads_from_partials(du, partials, inv, K, A):
    """JAX's per-direction du and per-row partials -> (dx, dwx, dwdt, dbias,
    dA_logs, dDs) as the plain versions return them."""
    p_wx_dt, p_wx_B, p_wx_C, p_wdt, p_bias, p_A, p_D = (
        np.asarray(v).reshape((B, K) + np.asarray(v).shape[1:]).sum(0) for v in partials)
    dx = tf._merge_sum(torch.from_numpy(np.array(du)), inv)
    dwx = np.concatenate([p_wx_dt, p_wx_B, p_wx_C], axis=1)
    return (dx, dwx, p_wdt, p_bias[:, 0], (p_A[:, 0] * A), p_D[:, 0])


JAX_BWD = [("line", 12, 0, 16, "fp32"), ("raster", 12, 0, 64, "bf16")]


@pytest.mark.parametrize("kind,H,param,seg,dt", JAX_BWD, ids=_ids(JAX_BWD))
def test_segmented_adjoint_matches_seq_bwd_pallas(kind, H, param, seg, dt):
    """_seq_bwd_pallas (chunks of 64, on _fused_pallas's carries) in
    interpret mode against the mirror on its own carries: dx (each
    direction's du merged through the inverse table) and the weight, bias,
    A and D gradients summed over the batch."""
    p = _inputs(kind, H, seed=4 * H + seg)
    idx, inv = order_tables(kind, H, H, param, "cpu")
    K = idx.shape[0]
    xs, gs, par = _jax_seq(p, idx, dt)
    _, carries = jf._fused_pallas(xs, *par, K=K, R=R, chunk=CHUNK, interpret=True,
                                  emit_carries=True)
    du, partials = jf._seq_bwd_pallas(xs, gs, carries, *par, K=K, R=R, chunk=CHUNK,
                                      interpret=True)
    A = -np.exp(p["A_logs"][..., 0])
    want = _grads_from_partials(_np(du).reshape(B, K, -1, D), partials, inv, K, A)
    x, g_y, core = _t(p["x"], dt), _t(p["g_y"], dt), _core(p)
    _, c, dbc = sm.ss2d_scan_segmented(x, idx, *core, seg=seg, chunk=CHUNK)
    got = sm.ss2d_scan_bwd_segmented(x, idx, inv, g_y, c, dbc, *core, seg=seg, chunk=CHUNK)
    for name, g, w in zip(("dx", "dwx", "dwdt", "dbias", "dA_logs", "dDs"), got, want):
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy() / scale, w / scale, **TOL_JAX[dt],
                                   err_msg=name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_segmented_adjoint_matches_dirs_bwd_call(dt):
    """_dirs_bwd_call through _rows_bwd_pallas (raster directions 0 and 2 of
    a 24 x 16 map in two row chunks of 12 rows, the reversed direction's
    chunks in the other order) in interpret mode, on _rows_pallas's carries,
    against the mirror over those two directions' tables with the carry
    stride 12 x 16 and segments of 80 steps: dx summed over both directions
    at each pixel, and the weight, bias, A and D gradients."""
    H, W = 24, 16
    rng = np.random.default_rng(11 + (dt == "bf16"))
    p = _inputs("raster", 4, seed=0)
    p["x"] = rng.normal(size=(B, H * W, D)).astype(np.float32)
    p["g_y"] = rng.normal(size=(B, H * W, D)).astype(np.float32)
    sel = [0, 2]
    for k in ("wx", "wdt", "bias", "A_logs", "Ds"):
        p[k] = p[k][sel]
    Tr = jf._row_chunk(H, W, D)
    assert H // Tr == 2
    A = -np.exp(p["A_logs"][..., 0])
    par = tuple(jnp.asarray(v) for v in (p["wx"], p["wdt"], p["bias"], A, p["Ds"]))
    ximg = jnp.asarray(p["x"]).astype(JDT[dt]).reshape(B, H, W, D)
    gimg = jnp.asarray(p["g_y"]).astype(JDT[dt]).reshape(B, H, W, D)
    _, c02 = jf._rows_pallas(ximg, *par, interpret=True, emit_carries=True)
    dx, partials = jf._rows_bwd_pallas(ximg, gimg, c02, *par, interpret=True)
    want_dx = _np(dx).sum(1).reshape(B, H * W, D)
    parts = [np.asarray(v).sum(0) for v in partials]  # (2, ...) over the batch
    want = (want_dx, np.concatenate(parts[:3], axis=1), parts[3], parts[4][:, 0],
            parts[5][:, 0] * A, parts[6][:, 0])
    idx = order_tables("raster", H, W, 0, "cpu")[0][sel].contiguous()
    inv = torch.argsort(idx, dim=1).to(torch.int32)[:, None]  # each pixel once per direction
    x, g_y, core = _t(p["x"], dt), _t(p["g_y"], dt), _core(p)
    _, c, dbc = sm.ss2d_scan_segmented(x, idx, *core, seg=80, chunk=Tr * W)
    np.testing.assert_allclose(c[:, 0].numpy(), _np(c02)[:, 0, :, 0], **TOL_JAX["fp32"])
    got = sm.ss2d_scan_bwd_segmented(x, idx, inv, g_y, c, dbc, *core, seg=80, chunk=Tr * W)
    for name, g, w in zip(("dx", "dwx", "dwdt", "dbias", "dA_logs", "dDs"), got, want):
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy() / scale, w / scale, **TOL_JAX[dt],
                                   err_msg=name)
