"""Plain versions of kernels K11 ``ln_dwmlp``, K12 ``sra`` and K13
``window_attn`` against the Pallas kernels they stand for, and their
autograd against ``jax.vjp`` of the composed oracles.

The Pallas kernels run in interpret mode on the CPU, as
``tests/test_fused_attn.py`` runs them.  The same numpy-seeded inputs go to
both sides; weights move from flax layout (in, out) to torch's (out, in).
Tolerances: fp32 atol 1e-5 (the same math, other summation orders); bf16
rtol/atol 1e-2 (the same rounding points, but another summation order can
flip a bf16 rounding).  Gradients (fp32): atol 1e-4, as the JAX package's
own fused-vs-composed gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.models.swin import _shift_attn_mask
from tramba_tpu.ops.fused_attn import (_sra_pallas, _wattn_pallas, composed_sra,
                                       composed_window_attn)
from tramba_tpu.ops.fused_mlp import _dwmlp_pallas, composed_ln_dwmlp
from tramba_tpu_torch.ops import fused_attn as ta
from tramba_tpu_torch.ops import fused_mlp as tm

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRAD_ATOL = 1e-4


def _rng_arrays(seed, *shapes, scale=0.2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), torch.from_numpy(np.asarray(want).astype(np.float32)),
                               **TOL[dtype])


# ---- K12 sra ----------------------------------------------------------------


def _sra_inputs(nh, B=2, N=64, C=64, Lk=16, seed=0):
    """flax-layout arrays: x, ln_s, ln_b, wq (in, out), bq, k, v, wp, bp."""
    hd = C // nh
    x, s, b, wq, bq, k, v, wp, bp = _rng_arrays(
        seed, (B, N, C), (C,), (C,), (C, C), (C,), (B, nh, Lk, hd), (B, nh, Lk, hd), (C, C), (C,))
    return [x * 5, s + 1.0, b, wq, bq, k * 5, v * 5, wp, bp]


def _sra_torch(a, dtype):
    x, s, b, wq, bq, k, v, wp, bp = a
    return [_t(x).to(dtype), _t(s), _t(b), _t(wq.T), _t(bq), _t(k).to(dtype), _t(v).to(dtype),
            _t(wp.T), _t(bp)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh", [1, 2, 4])
def test_sra_ref_matches_pallas(nh, dtype):
    a = _sra_inputs(nh)
    ja = [jnp.asarray(t) for t in a]
    for i in (0, 5, 6):
        ja[i] = ja[i].astype(JDT[dtype])
    want = _sra_pallas(*ja, nh=nh, eps=1e-6, interpret=True)
    got = ta.sra(*_sra_torch(a, dtype), nh)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


# ---- K13 window_attn --------------------------------------------------------


def _wattn_inputs(nh, masked, B=2, H=8, W=8, C=64, w=4, seed=1):
    N = w * w
    x, s, b, wqkv, bqkv, bias, wp, bp = _rng_arrays(
        seed, (B, H, W, C), (C,), (C,), (C, 3 * C), (3 * C,), (nh, N, N), (C, C), (C,))
    mask = _shift_attn_mask(H, W, w, w // 2) if masked else None
    return [x * 5, s + 1.0, b, wqkv, bqkv, bias * 5, mask, wp, bp], w


def _wattn_torch(a, dtype):
    x, s, b, wqkv, bqkv, bias, mask, wp, bp = a
    return [_t(x).to(dtype), _t(s), _t(b), _t(wqkv.T), _t(bqkv), _t(bias),
            None if mask is None else _t(mask), _t(wp.T), _t(bp)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,masked", [(1, False), (2, True), (4, True), (4, False)])
def test_window_attn_ref_matches_pallas(nh, masked, dtype):
    a, w = _wattn_inputs(nh, masked)
    ja = [None if t is None else jnp.asarray(t) for t in a]
    ja[0] = ja[0].astype(JDT[dtype])
    want = _wattn_pallas(*ja, nh=nh, w=w, eps=1e-5, interpret=True)
    got = ta.window_attn(*_wattn_torch(a, dtype), nh)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


# ---- K11 ln_dwmlp -----------------------------------------------------------


def _dwmlp_inputs(B=2, H=8, W=8, D=16, Hd=128, seed=2):
    x, s, b, w1, b1, k3, c3, w2, b2 = _rng_arrays(
        seed, (B, H, W, D), (D,), (D,), (D, Hd), (Hd,), (3, 3, 1, Hd), (Hd,), (Hd, D), (D,))
    return [x * 5, s + 1.0, b, w1, b1, k3, c3, w2, b2]


def _dwmlp_torch(a, dtype):
    x, s, b, w1, b1, k3, c3, w2, b2 = a
    return [_t(x).to(dtype), _t(s), _t(b), _t(w1.T), _t(b1), _t(k3.transpose(3, 2, 0, 1)),
            _t(c3), _t(w2.T), _t(b2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(8, 8), (6, 16)])
def test_ln_dwmlp_ref_matches_pallas(H, W, dtype):
    a = _dwmlp_inputs(H=H, W=W)
    ja = [jnp.asarray(t) for t in a]
    ja[0] = ja[0].astype(JDT[dtype])
    want = _dwmlp_pallas(*ja, eps=1e-6, interpret=True)
    got = tm.ln_dwmlp(*_dwmlp_torch(a, dtype))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


# ---- autograd vs jax.vjp of the composed oracles ------------------------------


def _check_grads(fn, targs, oracle, jargs, diff, seed):
    """fn's gradients (through its autograd Function) for a random cotangent
    against jax.vjp of ``oracle`` over the same inputs, in fp32."""
    leaves = [t.clone().requires_grad_(i in diff) if t is not None else None
              for i, t in enumerate(targs)]
    out = fn(*leaves)
    g = np.random.default_rng(seed).normal(size=tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad(out, [leaves[i] for i in diff], _t(g))
    _, vjp = jax.vjp(lambda *d: oracle(*[d[diff.index(i)] if i in diff else jargs[i]
                                         for i in range(len(jargs))]),
                     *[jargs[i] for i in diff])
    want = vjp(jnp.asarray(g))
    return got, want


def test_sra_autograd_matches_jax_vjp():
    a = _sra_inputs(2, seed=3)
    diff = list(range(9))
    got, want = _check_grads(lambda *t: ta.Sra.apply(*t, 2, 1e-6), _sra_torch(a, torch.float32),
                             lambda *j: composed_sra(*j, 2, 1e-6),
                             [jnp.asarray(t) for t in a], diff, 4)
    layout = [None, None, None, "T", None, None, None, "T", None]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).T if layout[i] else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=f"input {i}")


def test_window_attn_autograd_matches_jax_vjp():
    a, _ = _wattn_inputs(2, True, seed=5)
    diff = [0, 1, 2, 3, 4, 5, 7, 8]  # all but the mask (no gradient, _wattn_bwd)
    targs = _wattn_torch(a, torch.float32)
    got, want = _check_grads(lambda *t: ta.WindowAttn.apply(*t, 2, 1e-5), targs,
                             lambda *j: composed_window_attn(*j, 2, 1e-5),
                             [None if t is None else jnp.asarray(t) for t in a], diff, 6)
    for i, g, w in zip(diff, got, want):
        w = np.asarray(w).T if i in (3, 7) else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=f"input {i}")


def test_ln_dwmlp_autograd_matches_jax_vjp():
    a = _dwmlp_inputs(seed=7)
    diff = list(range(9))
    got, want = _check_grads(lambda *t: tm.LnDwMlp.apply(*t, 1e-6),
                             _dwmlp_torch(a, torch.float32),
                             lambda *j: composed_ln_dwmlp(*j, 1e-6),
                             [jnp.asarray(t) for t in a], diff, 8)
    to_torch = {3: lambda w: w.T, 5: lambda w: w.transpose(3, 2, 0, 1), 7: lambda w: w.T}
    for i, (g, w) in enumerate(zip(got, want)):
        w = to_torch.get(i, lambda v: v)(np.asarray(w))
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=f"input {i}")


def test_bf16_wrappers_record_their_functions():
    """Under autograd in bf16 on the CPU the wrappers run their Functions
    (the plain versions forward): the outputs keep a grad_fn of that class."""
    x = _sra_torch(_sra_inputs(2), torch.bfloat16)
    x[0].requires_grad_(True)
    assert type(ta.sra(*x, 2).grad_fn).__name__ == "SraBackward"
    w = _wattn_torch(_wattn_inputs(2, True)[0], torch.bfloat16)
    w[3].requires_grad_(True)
    assert type(ta.window_attn(*w, 2).grad_fn).__name__ == "WindowAttnBackward"
    d = _dwmlp_torch(_dwmlp_inputs(), torch.bfloat16)
    d[3].requires_grad_(True)
    assert type(tm.ln_dwmlp(*d).grad_fn).__name__ == "LnDwMlpBackward"


# ---- ROADMAP Queue 3 #12: every shape the gates admit reaches K12 / K13 ----


def test_gate_admitted_shapes_pass_the_kernel_shape_checks():
    """Walk the shapes ``sra_fusable`` / ``window_attn_fusable`` admit (C,
    head width and keys multiples of 8) through the wrappers' operand
    preparation, which launches nothing: none raises, and each hands the
    kernels heads padded to their widths (K12: multiples of 64, the keys as
    they are, or nothing padded where the shape takes its wide route; K13:
    multiples of 16)."""
    bf = torch.bfloat16
    seen = 0
    for C in range(8, 161, 8):
        for nh in (1, 2, 3, 4, 5, 8):
            hd = C // nh if C % nh == 0 else 0
            for Lk in range(8, 81, 8):
                if not ta.sra_fusable(16, C, nh, Lk, bf):
                    continue
                y = torch.zeros(1, 16, C)
                k = torch.zeros(1, nh, Lk, hd)
                (wq, bq, k2, v2, wp, bp), Cq = ta._sra_operands(
                    y, torch.zeros(C, C), torch.zeros(C), k, k.clone(), torch.zeros(C, C),
                    torch.zeros(C), nh)
                wide = ta.check_sra_shape(C, nh, Lk)[2]
                assert Cq == C if wide else Cq % 64 == 0 and Cq >= C
                assert tuple(k2.shape) == (1, nh, Lk, Cq // nh)
                assert tuple(wq.shape) == (Cq, C) and tuple(wp.shape) == (C, Cq)
                seen += 1
            for w in (4, 8, 12):
                if not ta.window_attn_fusable(2 * w, 2 * w, C, nh, w, bf):
                    continue
                N = w * w
                (wqkv, bqkv, wp, bp), Cq, w2 = ta._window_operands(
                    torch.zeros(1, 2 * w, 2 * w, C), torch.zeros(3 * C, C), torch.zeros(3 * C),
                    torch.zeros(nh, N, N), torch.zeros(4, N, N), torch.zeros(C, C),
                    torch.zeros(C), nh)
                assert Cq % 16 == 0 and tuple(wqkv.shape) == (3 * Cq, C) and w2 == w
                assert tuple(wp.shape) == (Cq, Cq) and bqkv.numel() == 3 * Cq
                seen += 1
    assert seen > 300


def _heads_fp32(q, k, v, nh, add=None):
    """fp32 attention over (G, n, nh * hd16) q and (G, m, nh * hd16) k, v."""
    G, n, _ = q.shape
    q, k, v = (t.reshape(G, t.shape[1], nh, -1).transpose(1, 2) for t in (q, k, v))
    s = q @ k.transpose(-1, -2)
    if add is not None:
        s = s + add
    return (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(G, n, -1)


def test_padded_operands_compute_the_plain_function():
    """At C = 40, head width 8 and 24 keys, the padded operands, run through
    the kernels' arithmetic in fp32 (K12: heads padded to 64, the keys to a
    tile of 64 with zeros masked from 24 on; K13: heads padded to 16), give
    the plain versions' outputs: the zero heads and masked keys change
    nothing."""
    rng = np.random.default_rng(12)
    C, nh, Lk, N = 40, 5, 24, 48
    f = np.float32
    x = _t(rng.normal(size=(2, N, C)).astype(f))
    ln_w, ln_b = _t(rng.normal(size=C).astype(f) * 0.1 + 1), _t(rng.normal(size=C).astype(f) * 0.1)
    wq, wp = (_t(rng.normal(size=(C, C)).astype(f) * C ** -0.5) for _ in range(2))
    bq, bp = (_t(rng.normal(size=C).astype(f) * 0.1) for _ in range(2))
    k, v = (_t(rng.normal(size=(2, nh, Lk, C // nh)).astype(f)) for _ in range(2))
    want = ta.sra_ref(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh)
    y = torch.nn.functional.layer_norm(x, (C,), ln_w, ln_b, 1e-6)
    (wq2, bq2, k2, v2, wp2, bp2), Cq = ta._sra_operands(y, wq, bq, k, v, wp, bp, nh)
    Lk64 = 64  # the kernel's key tile: zero keys past Lk, masked
    assert (Cq, tuple(k2.shape)) == (320, (2, nh, Lk, 64))
    q = (y @ wq2.t() + bq2) * (C // nh) ** -0.5
    mask = torch.zeros(Lk64)
    mask[Lk:] = float("-inf")
    merge = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, Lk64 - Lk)).transpose(1, 2).reshape(
        2, Lk64, Cq))
    o = _heads_fp32(q, merge(k2), merge(v2), nh, mask)
    torch.testing.assert_close(o @ wp2.t() + bp2, want, rtol=1e-5, atol=1e-5)

    w, H = 4, 8
    xw = _t(rng.normal(size=(2, H, H, C)).astype(f))
    wqkv, bqkv = _t(rng.normal(size=(3 * C, C)).astype(f) * C ** -0.5), _t(
        rng.normal(size=3 * C).astype(f) * 0.1)
    bias = _t(rng.normal(size=(nh, w * w, w * w)).astype(f))
    want = ta.window_attn_ref(xw, ln_w, ln_b, wqkv, bqkv, bias, None, wp, bp, nh)
    yw = torch.nn.functional.layer_norm(xw, (C,), ln_w, ln_b, 1e-5)
    (wqkv2, bqkv2, wp2, bp2), Cq, _ = ta._window_operands(xw, wqkv, bqkv, bias, None, wp, bp,
                                                          nh)
    qkv = yw @ wqkv2.t() + bqkv2
    win = qkv.reshape(2, 2, w, 2, w, 3 * Cq).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, 3 * Cq)
    q, kk, vv = win.split(Cq, -1)
    o = _heads_fp32(q * (C // nh) ** -0.5, kk, vv, nh, bias)
    out = (o @ wp2.t() + bp2)[..., :C]
    out = out.reshape(2, 2, 2, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(2, H, H, C)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
