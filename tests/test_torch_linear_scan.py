"""K14's plain version, the selective scan and SS2D's general route vs the JAX
package.

fp32 on the CPU at small ragged shapes, inputs from numpy seeds.  Tolerances:
``linear_scan_ref`` and its autograd against ``_linear_scan_pallas`` in
interpret mode and ``jax.vjp(linear_scan)``: 1e-5 (both scan in fp32, in
other orders: JAX's chunks run log-depth masked scans); the selective scan
and SS2D with d_state > 1 and biases against JAX's ``backend="assoc"``
(an associative scan): rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.nn.ssm import SS2D as JSS2D
from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu.ops import selective_scan as js
from tramba_tpu_torch.compat.jax_weights import ss2d_from_jax, ss2d_to_jax
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn import ssm as tssm
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops import selective_scan as ts
from tramba_tpu_torch.ops.scan_orders import order_tables

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ab(shape, seed):
    """a in (0.9, 1): carries that last hundreds of rows; b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.0, 0.1, shape)).astype(np.float32)
    return a, rng.normal(size=shape).astype(np.float32)


def _jax_scan(a, b, reverse, fn):
    if reverse:
        return jnp.flip(fn(jnp.flip(a, -2), jnp.flip(b, -2)), -2)
    return fn(a, b)


@pytest.mark.parametrize("shape,reverse", [((3, 300, 130), False), ((3, 300, 130), True),
                                           ((2, 9, 1), False), ((1, 513, 128), True)])
def test_linear_scan_ref_matches_pallas_kernel(shape, reverse):
    """The plain loop against ``_linear_scan_pallas`` (256-row chunks with a
    carry, interpret mode); reversed against JAX's flipped scan, which is
    how ``_linear_scan_bwd`` runs it."""
    a, b = _ab(shape, seed=sum(shape) + reverse)
    want = _jax_scan(jnp.asarray(a), jnp.asarray(b), reverse,
                     lambda x, y: js._linear_scan_pallas(x, y, interpret=True))
    got = ts.linear_scan_ref(_t(a), _t(b), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_scan_autograd_matches_jax_vjp(reverse):
    """``linear_scan``'s gradient (its autograd Function, the adjoint scan run
    the other way) against ``jax.vjp(linear_scan)`` at a ragged (3, 300,
    130), with a bf16 b whose gradient comes back in bf16."""
    a, b = _ab((3, 300, 130), seed=7 + reverse)
    g = np.random.default_rng(8).normal(size=a.shape).astype(np.float32)
    h, vjp = jax.vjp(jax.jit(lambda x, y: _jax_scan(x, y, reverse, js.linear_scan)),
                     jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    got = ts.linear_scan(ta, tb, reverse)
    assert isinstance(got.grad_fn, torch.autograd.function.BackwardCFunction)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(h), **SCAN_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(da), **SCAN_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db), **SCAN_TOL)
    tb16 = _t(b).to(torch.bfloat16).requires_grad_(True)
    ts.linear_scan(_t(a), tb16, reverse).backward(_t(g))
    assert tb16.grad.dtype == torch.bfloat16


def test_k1_plain_version_never_reaches_k14(monkeypatch):
    """K1's plain versions scan with ``linear_scan_ref``: the kernel they
    check and K14 stay independent of each other."""
    def no(*args, **kwargs):
        raise AssertionError("K1's plain version reached linear_scan")

    monkeypatch.setattr(tf, "linear_scan", no)
    monkeypatch.setattr(ts, "linear_scan", no)
    rng = np.random.default_rng(0)
    K, D, R = 4, 8, 2
    x = _t(rng.normal(size=(1, 16, D)).astype(np.float32))
    core = [_t((rng.normal(size=s) * 0.3).astype(np.float32))
            for s in ((K, R + 2, D), (K, D, R), (K, D), (K, D, 1), (K, D))]
    idx, _ = order_tables("raster", 4, 4, 0, "cpu")
    tf.ss2d_scan_ref(x, idx, *core)
    tf.ss2d_scan_train_ref(x, idx, *core)
    tf.ss2d_core_ref(x.reshape(1, 1, 16, D).expand(1, K, 16, D), *core)


@pytest.mark.parametrize("N", [1, 4])
def test_selective_scan_matches_jax(N):
    """The S6 op with N = 4 folded into channels (and N = 1), its output and
    the gradients of every input against JAX's assoc backend."""
    rng = np.random.default_rng(N)
    B, K, L, D = 2, 3, 37, 5
    f = np.float32
    ins = dict(u=rng.normal(size=(B, K, L, D)).astype(f),
               dt=(rng.normal(size=(B, K, L, D)) * 0.5).astype(f),
               A=-np.exp(rng.normal(size=(K, D, N)) * 0.3).astype(f),
               Bc=rng.normal(size=(B, K, L, N)).astype(f),
               Cc=rng.normal(size=(B, K, L, N)).astype(f),
               D=rng.normal(size=(K, D)).astype(f),
               dt_bias=(rng.normal(size=(K, D)) * 0.2).astype(f))
    g = rng.normal(size=(B, K, L, D)).astype(f)
    want, vjp = jax.vjp(jax.jit(lambda *a: js.selective_scan(*a, backend="assoc")),
                        *(jnp.asarray(v) for v in ins.values()))
    wgrads = vjp(jnp.asarray(g))
    targs = [_t(v).requires_grad_(True) for v in ins.values()]
    got = ts.selective_scan(*targs)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, t, w in zip(ins, targs, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_composed_core_matches_jax():
    """``composed_ss2d_core`` (fp32 projections -> softplus -> exp -> K14's
    plain version -> y = h C + D u) against JAX's."""
    rng = np.random.default_rng(3)
    K, L, D, R = 4, 50, 6, 2
    f = np.float32
    xs = rng.normal(size=(2, K, L, D)).astype(f)
    core = [(rng.normal(size=s) * 0.3).astype(f)
            for s in ((K, R + 2, D), (K, D, R), (K, D), (K, D, 1), (K, D))]
    want = jax.jit(lambda *a: jf.composed_ss2d_core(*a, backend="assoc"))(
        *(jnp.asarray(v) for v in [xs] + core))
    got = tf.composed_ss2d_core(*(_t(v) for v in [xs] + core))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (JAX SS2D keywords, scan order, directions, map): d_state > 1 and the biases
# take the composed route; d_conv 1 has no conv at all
GENERAL = [
    (dict(d_state=4, bias=True, conv_bias=True), "raster", 4, (5, 6)),
    (dict(d_state=4), "line", 8, (6, 6)),
    (dict(d_state=1, bias=True), "window", 4, (8, 8)),
    (dict(d_state=2, conv_bias=True, d_conv=5), "raster", 4, (4, 7)),
    (dict(d_state=3, d_conv=1), "dilation", 4, (6, 6)),
]


@pytest.mark.parametrize("kw,kind,K,hw", GENERAL)
def test_ss2d_general_route_matches_jax(kw, kind, K, hw):
    """SS2D with d_state > 1 and biases, the weights of JAX's init carried
    across with ``ss2d_from_jax``: the output and every parameter's
    gradient (and the input's) against JAX's ``SS2D(backend="assoc")``
    with the block's pre-norm."""
    H, W = hw
    rng = np.random.default_rng(K + H * W)
    dm = 16
    x = rng.normal(size=(2, H, W, dm)).astype(np.float32)
    ln = [(rng.normal(size=(dm,)) * 0.1 + 1).astype(np.float32),
          (rng.normal(size=(dm,)) * 0.1).astype(np.float32)]
    param = {"window": 4, "dilation": 2}.get(kind, 0)
    jm = JSS2D(d_model=dm, k_group=K, scan_kind=kind, scan_param=param, backend="assoc", **kw)
    jln = tuple(jnp.asarray(v) for v in ln)
    variables = jax.jit(lambda k, a: jm.init(k, a, ln=jln))(jax.random.key(0), jnp.asarray(x))
    if kw.get("bias"):  # JAX draws the out-projection bias as zeros
        variables["params"]["out_proj_bias"] = jnp.asarray(
            rng.normal(size=(dm,)).astype(np.float32) * 0.1)
    g = rng.normal(size=(2, H, W, dm)).astype(np.float32)

    def jfn(v, a):
        return jm.apply(v, a, ln=jln)

    want, vjp = jax.vjp(jax.jit(jfn), variables, jnp.asarray(x))
    wv, wx = vjp(jnp.asarray(g))
    tm = SS2D(dm, k_group=K, scan_kind=kind, scan_param=param, **kw)
    tm.load_state_dict(ss2d_from_jax(jax.tree.map(np.asarray, variables)))
    tx = _t(x).requires_grad_(True)
    got = tm(tx, ln=tuple(_t(v) for v in ln))
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-4)
    wgrads = ss2d_from_jax(jax.tree.map(np.asarray, wv))
    for name, p in tm.named_parameters():
        w = wgrads[name]
        rel = (p.grad - w).norm().item() / max(w.norm().item(), 1e-30)
        assert rel <= 1e-4, f"{name}: relative grad error {rel}"


@pytest.mark.parametrize("kw", [dict(d_state=4, bias=True, conv_bias=True), dict(d_conv=1),
                                dict()])
def test_ss2d_weights_round_trip_through_jax(kw):
    """``ss2d_to_jax`` inverts ``ss2d_from_jax``: JAX's tree comes back leaf
    for leaf, the port's state dict key for key."""
    x = jnp.zeros((1, 4, 4, 8))
    variables = jax.tree.map(np.asarray, jax.jit(JSS2D(d_model=8, backend="assoc", **kw).init)(
        jax.random.key(1), x))
    sd = ss2d_from_jax(variables)
    back = ss2d_to_jax(sd, k_group=4)
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    assert sd.keys() == SS2D(8, **kw).state_dict().keys()


def test_ss2d_routes_as_jax(monkeypatch):
    """backend None: the K1/K2 route where JAX's ``use_folded`` holds (d_state
    1, no out bias, a dilation rate that divides L; a conv bias or another
    conv size only moves the prologue out of K5), the composed route with K14
    otherwise; JAX's TPU and debug spellings are refused naming ROADMAP item
    8."""
    seen = []
    real_full, real_comp = tssm.ss2d_full, tssm.SS2D._composed
    monkeypatch.setattr(tssm, "ss2d_full", lambda *a: seen.append("K1/K2") or real_full(*a))
    monkeypatch.setattr(tssm.SS2D, "_composed",
                        lambda self, *a: seen.append("composed") or real_comp(self, *a))
    x = torch.randn(1, 5, 5, 8)
    for kw, kind, param, want in [(dict(), "raster", 0, "K1/K2"),
                                  (dict(conv_bias=True, d_conv=5), "raster", 0, "K1/K2"),
                                  (dict(d_state=2), "raster", 0, "composed"),
                                  (dict(bias=True), "line", 0, "composed"),
                                  (dict(), "dilation", 4, "composed"),  # 4 does not divide 25
                                  (dict(), "dilation", 5, "K1/K2")]:
        seen.clear()
        SS2D(8, scan_kind=kind, scan_param=param, k_group=8 if kind == "line" else 4, **kw)(x)
        assert seen == [want], (kw, kind, param, seen)
    for bad in ("assoc", "seq", "fake", "pallas"):
        with pytest.raises(ValueError, match="item 8"):
            SS2D(8, backend=bad)


@pytest.mark.parametrize("method", ["Tramba-V-TSOD", "Tramba-S-TSOD"])
def test_registry_threads_ssm_backend(method):
    """``build(..., ssm_backend=)`` reaches every SS2D of the model; the
    parameters do not depend on the backend, so a state dict moves between
    backends unchanged."""
    cut = (dict(dims=8, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
           if method.startswith("Tramba-V") else
           dict(enc_config=dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 1)),
                dec_depths=(1, 1, 1, 1)))
    ref = build(method, 64, device="cpu", seed=0, **cut).state_dict()
    for backend in tssm.BACKENDS:
        model = build(method, 64, device="cpu", seed=0, ssm_backend=backend, **cut)
        ss2ds = [m for m in model.modules() if isinstance(m, SS2D)]
        assert ss2ds and all(m.backend == backend for m in ss2ds)
        sd = model.state_dict()
        assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in ref)
