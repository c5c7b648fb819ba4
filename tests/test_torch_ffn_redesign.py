"""K7 ``ln_dwms_mlp`` and K9 ``ln_mlp_bwd`` as their Hopper kernels split the
work (``tramba_tpu_torch/ops/ffn_stages.py`` mirrors the split in plain
PyTorch), against the JAX package on the CPU.

* (i) The merged-tap stencil: h computed once, zero outside the image, one
  7x7 stencil with taps k7 + pad(k5) + pad(k3) + identity, GELU, fc2,
  against ``_dwms_pallas`` (``tramba_tpu/ops/fused_mlp.py:360``) in
  interpret mode and against ``composed_ln_dwmsmlp``, on maps whose halo
  crosses both edges: 12 x 8 (Queue 2 #21's), 5 x 5 and 9 x 9.  fp32 rtol
  1e-4 / atol 1e-5 (the merged taps reassociate fp32 sums); bf16 rtol / atol
  1e-2 (about one bf16 ulp at the output: the sums run in another order),
  2e-2 against the composed version in bf16 (it rounds fc1's output to
  bf16, where the kernels keep h in fp32).
* (ii) K9's stage split: the front without fp32 maps, and stage (c) in two
  column groups whose shares of the LN adjoint's row sums are added in a
  fixed order, against ``jax.vjp(composed_ln_mlp)`` and ``_mlp_bwd_pallas``
  (``fused_mlp.py:233``) in interpret mode, on 100 rows (not a multiple of
  the kernel's 64-row tiles).  Tolerances as
  ``tests/test_torch_bf16_train_ops.py``: each output divided by the JAX
  side's largest magnitude, rtol / atol 1e-2 against the Pallas kernel (the
  same rounding points, another summation order), 2e-2 against the composed
  VJP (its bf16 products round their outputs).  Each planted fault of the
  mirrors (``DWMS_FAULTS``, ``MLP_BWD_FAULTS``) fails those checks.
* (iii) Without a launch: every full-width (B, H, W, d, hid) of K7 and
  every (M, d, hid) of K9 and K10 that Tramba-V, -S, -P and -R build, at
  batch 1, 4 and 16, passes the wrappers' shape checks
  (``check_ln_dwms_mlp_shape``, ``check_ln_mlp_bwd_shape``); shapes the
  kernels do not take raise; and the column groups of stage (c) at the
  main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.layers import DWMSMlp, Mlp
from tramba_tpu_torch.ops import ffn_stages as fs
from tramba_tpu_torch.ops import fused_mlp as tm

TOL = {"bf16": dict(rtol=1e-2, atol=1e-2), "fp32": dict(rtol=1e-4, atol=1e-5)}
# the composed oracle rounds its bf16 fc1 product's output (the kernels keep h
# fp32): in bf16 it is held at 2e-2, as the composed VJP is below
TOL_COMPOSED = {"bf16": dict(rtol=2e-2, atol=2e-2), "fp32": TOL["fp32"]}
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}
BWD_TOL = dict(rtol=1e-2, atol=1e-2)
BWD_TOL_COMPOSED = dict(rtol=2e-2, atol=2e-2)


def _r(rng, *shape, scale=0.2, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _bf(a):
    """a rounded to bf16, as a float32 numpy array (the same values on both sides)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _conv_t(k):
    """flax depthwise kernel (k, k, 1, C) -> torch Conv2d weight (C, 1, k, k)."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


# --- (i) K7's merged-tap stencil ----------------------------------------------


def _dwms_inputs(rng, B, H, W, d, hid):
    """JAX-layout inputs: x, LN, w1 (d, hid), b1, (k, c) per size, w2 (hid, d), b2."""
    out = [_r(rng, B, H, W, d, scale=1.0), _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1),
           _r(rng, d, hid), _r(rng, hid, scale=0.1)]
    for n in (3, 5, 7):
        out += [_r(rng, n, n, 1, hid), _r(rng, hid, scale=0.1)]
    return out + [_r(rng, hid, d), _r(rng, d, scale=0.1)]


def _dwms_port_args(args, dt):
    x, s, b, w1, b1, k3, c3, k5, c5, k7, c7, w2, b2 = args
    return (_t(x, dt), _t(s), _t(b), _t(w1.T, dt), _t(b1), _t(_conv_t(k3), dt), _t(c3),
            _t(_conv_t(k5), dt), _t(c5), _t(_conv_t(k7), dt), _t(c7), _t(w2.T, dt), _t(b2))


def _close(got, want, dt, tol=None):
    want = want.float() if torch.is_tensor(want) else torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want, **(tol or TOL[dt]))


MAPS = [(12, 8), (5, 5), (9, 9)]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{h}x{w}" for h, w in MAPS])
def test_merged_stencil_vs_dwms_pallas(dt, H, W):
    """One row block of the TPU kernel (its row halos are the image's edges)."""
    args = _dwms_inputs(np.random.default_rng(H * W), 2, H, W, 16, 64)
    want = jm._dwms_pallas(jnp.asarray(args[0], JDT[dt]), *map(jnp.asarray, args[1:]),
                           interpret=True, row_chunk=H)
    got = fs.dwms_merged_ref(*_dwms_port_args(args, TDT[dt]))
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{h}x{w}" for h, w in MAPS])
def test_merged_stencil_vs_composed(dt, H, W):
    args = _dwms_inputs(np.random.default_rng(H + W), 1, H, W, 16, 32)
    want = jax.jit(jm.composed_ln_dwmsmlp)(jnp.asarray(args[0], JDT[dt]),
                                           *map(jnp.asarray, args[1:]))
    got = fs.dwms_merged_ref(*_dwms_port_args(args, TDT[dt]))
    _close(got, want, dt, TOL_COMPOSED[dt])
    # and the port's plain version, which runs the three convs apart
    _close(got, tm.ln_dwms_mlp_ref(*_dwms_port_args(args, TDT[dt])), dt)


@pytest.mark.parametrize("fault", fs.DWMS_FAULTS)
def test_merged_stencil_faults_fail_the_check(fault):
    """12 x 8, bf16, two hidden chunks: each planted fault fails the bf16
    check that the mirror passes."""
    args = _dwms_port_args(_dwms_inputs(np.random.default_rng(3), 2, 12, 8, 16, 128),
                           torch.bfloat16)
    want = tm.ln_dwms_mlp_ref(*args).float()
    assert torch.allclose(fs.dwms_merged_ref(*args).float(), want, **TOL["bf16"])
    assert not torch.allclose(fs.dwms_merged_ref(*args, fault=fault).float(), want,
                              **TOL["bf16"])


# --- (ii) K9's stage split ----------------------------------------------------


def _bwd_inputs(rng, M, d, hid):
    x, g = _bf(_r(rng, 1, M, d, scale=1.0)), _bf(_r(rng, 1, M, d, scale=1.0))
    s, b = _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1)
    w1, b1, w2 = _r(rng, d, hid, scale=d ** -0.5), _r(rng, hid, scale=0.1), \
        _r(rng, hid, d, scale=hid ** -0.5)
    return x, g, s, b, w1, b1, w2


def _bwd_port(args, **kw):
    x, g, s, b, w1, b1, w2 = args
    return fs.mlp_bwd_split_ref(_t(x, torch.bfloat16), _t(g, torch.bfloat16), _t(s), _t(b),
                                _t(w1.T), _t(b1), _t(w2.T), **kw)


NAMES = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dw2", "db2")


def _close_scaled(got, want, name, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, **tol, err_msg=name)


def _jax_layout(name, a):
    return a.t() if name in ("dw1", "dw2") else a  # JAX: dw1 (d, hid), dw2 (hid, d)


@pytest.mark.parametrize("oracle", ["pallas", "composed"])
def test_split_adjoint_vs_jax(oracle):
    """d 128 (two 64-column groups in stage (c)), 100 rows, hidden 256."""
    args = _bwd_inputs(np.random.default_rng(11), 100, 128, 256)
    x, g = (jnp.asarray(a, jnp.bfloat16) for a in args[:2])
    params = list(map(jnp.asarray, args[2:]))
    if oracle == "pallas":
        want, tol = jm._mlp_bwd_pallas(x, g, *params, interpret=True), BWD_TOL
    else:
        _, vjp = jax.vjp(jm.composed_ln_mlp, x, *params, jnp.zeros(128, jnp.float32))
        want, tol = vjp(g)[:7], BWD_TOL_COMPOSED
    got = _bwd_port(args, groups=2)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, w in zip(NAMES, got, want):
        _close_scaled(_jax_layout(name, a), w, name, tol)


@pytest.mark.parametrize("fault", fs.MLP_BWD_FAULTS)
def test_split_adjoint_faults_fail_the_check(fault):
    """dx of each planted fault fails the check that the mirror passes."""
    args = _bwd_inputs(np.random.default_rng(12), 100, 128, 256)
    want = jm._mlp_bwd_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in args[:2]),
                              *map(jnp.asarray, args[2:]), interpret=True)[0]
    _close_scaled(_bwd_port(args, groups=2)[0], want, "dx", BWD_TOL)
    with pytest.raises(AssertionError):
        _close_scaled(_bwd_port(args, groups=2, fault=fault)[0], want, "dx", BWD_TOL)


def test_split_adjoint_is_the_plain_adjoint():
    """The mirror at the kernel's own column groups and at 1, 2 and 4 against
    ln_mlp_bwd_ref (fp32 sums reassociated: 1e-5 of each output's scale)."""
    args = [_t(a) for a in _bwd_inputs(np.random.default_rng(13), 150, 256, 512)]
    x, g = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    params = (args[2], args[3], args[4].t(), args[5], args[6].t())
    want = tm.ln_mlp_bwd_ref(x, g, *params)
    for groups in (None, 1, 2, 4):
        got = fs.mlp_bwd_split_ref(x, g, *params, groups=groups)
        for name, a, w in zip(NAMES, got, want):
            _close_scaled(a, w.float().numpy(), name, dict(rtol=1e-5, atol=1e-5) if name != "dx"
                          else BWD_TOL)


# --- (iii) shapes ---------------------------------------------------------------

FULL = ["Tramba-V-TSOD", "Tramba-S-TSOD", "Tramba-P-TSOD", "Tramba-R-TSOD"]


def _ffn_shapes(method):
    """({(B, H, W, d, hid)} of every DWMSMlp, {(M, d, hid)} of every Mlp and
    DWMSMlp) on every map the model's stages run (96 down to 12 px), at
    batch 1, 4 and 16: the shapes K7, K9 and K10 would get on the card."""
    with torch.device("meta"):
        model = build(method, 384, device="meta", seed=None, dtype=torch.bfloat16)
    maps = [384 >> s for s in (2, 3, 4, 5)]
    dwms, rows = set(), set()
    for m in model.modules():
        if isinstance(m, (Mlp, DWMSMlp)):
            d, hid = m.fc1.in_features, m.fc1.out_features
            for H in maps:
                for B in (1, 4, 16):
                    rows.add((B * H * H, d, hid))
                    if isinstance(m, DWMSMlp):
                        dwms.add((B, H, H, d, hid))
    return dwms, rows


@pytest.mark.parametrize("method", FULL)
def test_model_ffn_shapes_pass_the_kernel_checks(method):
    dwms, rows = _ffn_shapes(method)
    assert dwms and rows
    for shape in dwms:
        tm.check_ln_dwms_mlp_shape(*shape)
    for shape in rows:
        tm.check_ln_mlp_bwd_shape(*shape)
        tm.check_ln_mlp_bwd_shape(*shape, name="ln_dwms_mlp_bwd")
        assert 1 <= fs.column_groups(shape[0], shape[1]) <= 8


@pytest.mark.parametrize("B,H,W,d,hid", [(1, 8, 8, 1024, 4096), (1, 8, 8, 40, 160),
                                         (1, 8, 8, 64, 72), (0, 8, 8, 64, 256),
                                         (1, 8, 8, 8, 32)])
def test_ln_dwms_mlp_check_refuses(B, H, W, d, hid):
    with pytest.raises(ValueError, match="ln_dwms_mlp"):
        tm.check_ln_dwms_mlp_shape(B, H, W, d, hid)


@pytest.mark.parametrize("M,d,hid", [(10, 2048, 8192), (10, 576, 2304), (10, 704, 2816),
                                     (10, 40, 160), (10, 64, 72), (0, 64, 256)])
def test_ln_mlp_bwd_check_refuses(M, d, hid):
    with pytest.raises(ValueError, match="ln_mlp_bwd"):
        tm.check_ln_mlp_bwd_shape(M, d, hid)


@pytest.mark.parametrize("M,d,G", [(2 * 96 * 96, 128, 1), (2 * 48 * 48, 256, 2),
                                   (2 * 24 * 24, 512, 8), (2 * 12 * 12, 1024, 8),
                                   (2 * 24 * 24, 320, 5), (16 * 12 * 12, 1024, 4),
                                   (4 * 24 * 24, 512, 4), (2 * 96 * 96, 64, 1)])
def test_column_groups_at_main_path_shapes(M, d, G):
    """Stage (c)'s column groups: a wave of 132 blocks where the row tiles
    allow, else as many groups (a cluster holds at most 8) as d splits into."""
    assert fs.column_groups(M, d) == G
