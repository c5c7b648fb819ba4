"""K5 ``prologue`` and K10 ``ln_dwms_mlp_bwd`` as their Hopper kernels split
the work (``tramba_tpu_torch/ops/prologue_stages.py`` and
``ops/ffn_stages.py`` mirror the splits in plain PyTorch), against the JAX
package on the CPU.

* (i) K10's merged adjoint (``dwms_bwd_merged_ref``): one merged 7x7
  stencil for acc, dh as the correlation of dacc with the flipped merged
  taps, and the three tap gradients cut from one 49-offset correlation,
  against ``_dwms_bwd_pallas`` (``tramba_tpu/ops/fused_mlp.py:674``) in
  interpret mode and ``jax.vjp(composed_ln_dwmsmlp)`` (what JAX runs at
  d > 256), on maps whose 3-px halo crosses both edges and one smaller than
  the 7x7 window.  Each output is divided by the JAX side's largest
  magnitude: fp32 at rtol 1e-4 / atol 1e-5 (fp32 sums reassociated), bf16 at
  1e-2 against the Pallas kernel (the same rounding points, another
  summation order) and at 2e-2 against the composed VJP (its bf16 products
  round their outputs), as ``tests/test_torch_bf16_train_ops.py`` and
  ``tests/test_torch_ffn_redesign.py``.
* (ii) K5's tiles (``prologue_tiled_ref``): the halo rows normalised and
  projected per tile, u zero outside the image, the 3x3 taps and SiLU,
  against ``_prologue_pallas`` (``fused_prologue.py:94``) in interpret mode,
  with and without the LayerNorm, on a square and a non-square map, at the
  kernel's own tile and at a small one that cuts the map into many:
  fp32 rtol 1e-4 / atol 1e-5, bf16 rtol / atol 1e-2
  (``tests/test_torch_bf16_ops.py``).
* Each planted fault of the mirrors (``DWMS_BWD_FAULTS``,
  ``PROLOGUE_FAULTS``) fails the check that the mirror passes.
* (iii) Without a launch: every K5 and K10 shape that Tramba-V, -S, -P and
  -R build passes the wrappers' shape checks, shapes the kernels do not
  take raise, and K5's tile and channel-group plan at the main path's
  shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu.ops.fused_prologue import _prologue_pallas
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.layers import DWMSMlp
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops import ffn_stages as fs
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import prologue_stages as ps

TOL = {"bf16": dict(rtol=1e-2, atol=1e-2), "fp32": dict(rtol=1e-4, atol=1e-5)}
TOL_COMPOSED = {"bf16": dict(rtol=2e-2, atol=2e-2), "fp32": TOL["fp32"]}
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _r(rng, *shape, scale=0.2, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _conv_t(k):
    """flax depthwise kernel (k, k, 1, C) -> torch Conv2d weight (C, 1, k, k)."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _close_scaled(got, want, name, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, **tol, err_msg=name)


# --- (i) K10's merged adjoint -------------------------------------------------

NAMES = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dk3", "dc3", "dk5", "dc5", "dk7", "dc7", "dw2",
         "db2")


def _dwms_inputs(rng, B, H, W, d, hid, dt):
    """JAX-layout inputs: x, g, LN, w1 (d, hid), b1, (k, c) per size, w2
    (hid, d); x and g rounded to ``dt`` (the same values on both sides)."""
    rnd = lambda a: np.array(jnp.asarray(a).astype(JDT[dt]).astype(jnp.float32))  # noqa: E731
    out = [rnd(_r(rng, B, H, W, d, scale=1.0)), rnd(_r(rng, B, H, W, d, scale=1.0)),
           _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1), _r(rng, d, hid, scale=d ** -0.5),
           _r(rng, hid, scale=0.1)]
    for n in (3, 5, 7):
        out += [_r(rng, n, n, 1, hid, scale=0.2), _r(rng, hid, scale=0.1)]
    return out + [_r(rng, hid, d, scale=hid ** -0.5)]


def _port_args(args, dt):
    x, g, s, b, w1, b1, k3, c3, k5, c5, k7, c7, w2 = args
    return (_t(x, TDT[dt]), _t(g, TDT[dt]), _t(s), _t(b), _t(w1.T), _t(b1), _t(_conv_t(k3)),
            _t(c3), _t(_conv_t(k5)), _t(c5), _t(_conv_t(k7)), _t(c7), _t(w2.T))


def _jax_layout(name, a):
    if name in ("dw1", "dw2"):
        return a.t()
    if name in ("dk3", "dk5", "dk7"):  # (hid, 1, k, k) -> (k, k, 1, hid)
        return a.permute(2, 3, 1, 0)
    return a


def _check_all(got, want, tol):
    for name, a, w in zip(NAMES, got, want):
        _close_scaled(_jax_layout(name, a), w, name, tol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("H,W", [(6, 8), (12, 6)])
def test_merged_adjoint_vs_dwms_bwd_pallas(dt, H, W):
    """Rows in blocks of 6 (halos from both neighbours at H = 12), hidden
    chunks of 64."""
    args = _dwms_inputs(np.random.default_rng(H + W), 2, H, W, 16, 64, dt)
    want = jm._dwms_bwd_pallas(*(jnp.asarray(a, JDT[dt]) for a in args[:2]),
                               *map(jnp.asarray, args[2:]), interpret=True, row_chunk=6)
    got = fs.dwms_bwd_merged_ref(*_port_args(args, dt))
    assert got[0].dtype == TDT[dt] and all(t.dtype == torch.float32 for t in got[1:])
    _check_all(got, want, TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,d,hid", [(1, 5, 7, 272, 32), (2, 4, 3, 16, 48)],
                         ids=["d272", "map4x3"])
def test_merged_adjoint_vs_composed_vjp(dt, B, H, W, d, hid):
    """d 272 > 256 (where JAX runs the composed VJP), and a 4 x 3 map, smaller
    than the 7x7 window."""
    args = _dwms_inputs(np.random.default_rng(d + H), B, H, W, d, hid, dt)
    x = jnp.asarray(args[0], JDT[dt])
    _, vjp = jax.vjp(jm.composed_ln_dwmsmlp, x, *map(jnp.asarray, args[2:]),
                     jnp.zeros(d, jnp.float32))
    want = vjp(jnp.asarray(args[1], JDT[dt]))
    _check_all(fs.dwms_bwd_merged_ref(*_port_args(args, dt)), want, TOL_COMPOSED[dt])


@pytest.mark.parametrize("H,W", [(9, 9), (3, 2)])
def test_merged_adjoint_is_the_plain_adjoint(H, W):
    """fp32: the merged adjoint against ln_dwms_mlp_bwd_ref, which runs the
    three convs apart (1e-5 of each output's scale)."""
    args = _port_args(_dwms_inputs(np.random.default_rng(H * W), 2, H, W, 32, 80, "fp32"),
                      "fp32")
    for name, a, w in zip(NAMES, fs.dwms_bwd_merged_ref(*args), tm.ln_dwms_mlp_bwd_ref(*args)):
        _close_scaled(a, w.numpy(), name, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("fault", fs.DWMS_BWD_FAULTS)
def test_merged_adjoint_faults_fail_the_check(fault):
    """bf16, 12 x 8: each planted fault fails the per-output check (1e-2 of
    each output's scale) that the mirror passes."""
    args = _port_args(_dwms_inputs(np.random.default_rng(5), 2, 12, 8, 16, 64, "bf16"), "bf16")
    want = [w.float().numpy() for w in tm.ln_dwms_mlp_bwd_ref(*args)]
    for name, a, w in zip(NAMES, fs.dwms_bwd_merged_ref(*args), want):
        _close_scaled(a, w, name, TOL["bf16"])
    with pytest.raises(AssertionError):
        for name, a, w in zip(NAMES, fs.dwms_bwd_merged_ref(*args, fault=fault), want):
            _close_scaled(a, w, name, TOL["bf16"])


# --- (ii) K5's tiles ----------------------------------------------------------

PROLOGUE_MAPS = [(2, 12, 8, 16, 32), (1, 8, 8, 32, 48)]


def _prologue_inputs(rng, B, H, W, dm, D):
    return (_r(rng, B, H, W, dm, scale=1.0), _r(rng, dm, scale=0.1, shift=1.0),
            _r(rng, dm, scale=0.1, shift=0.5), _r(rng, dm, D, scale=dm ** -0.5),
            _r(rng, 3, 3, 1, D, scale=0.3))


@pytest.mark.parametrize("tile", [None, (3, 5)], ids=["kernel_tile", "tile3x5"])
@pytest.mark.parametrize("with_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,dm,D", PROLOGUE_MAPS, ids=["12x8", "8x8"])
def test_prologue_tiles_vs_pallas(B, H, W, dm, D, dt, with_ln, tile):
    x, s, b, w_in, k = _prologue_inputs(np.random.default_rng(H * W + dm), B, H, W, dm, D)
    ln_j = (jnp.asarray(s), jnp.asarray(b)) if with_ln else (None, None)
    ln_t = (_t(s), _t(b)) if with_ln else (None, None)
    want = _prologue_pallas(jnp.asarray(x, JDT[dt]), *ln_j, jnp.asarray(w_in), jnp.asarray(k),
                            interpret=True, row_chunk=4)
    got = ps.prologue_tiled_ref(_t(x, TDT[dt]), *ln_t, _t(w_in.T), _t(_conv_t(k)), tile=tile)
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dt])


@pytest.mark.parametrize("fault", ps.PROLOGUE_FAULTS)
def test_prologue_tile_faults_fail_the_check(fault):
    """bf16 with the LayerNorm, 12 x 8 cut into 3 x 5 tiles: each planted
    fault fails the bf16 check that the mirror passes."""
    x, s, b, w_in, k = _prologue_inputs(np.random.default_rng(9), 2, 12, 8, 16, 32)
    args = (_t(x, torch.bfloat16), _t(s), _t(b), _t(w_in.T), _t(_conv_t(k)))
    want = tp.prologue_ref(*args).float()
    assert torch.allclose(ps.prologue_tiled_ref(*args, tile=(3, 5)).float(), want, **TOL["bf16"])
    assert not torch.allclose(ps.prologue_tiled_ref(*args, tile=(3, 5), fault=fault).float(),
                              want, **TOL["bf16"])


# --- (iii) shapes and plans ---------------------------------------------------

FULL = ["Tramba-V-TSOD", "Tramba-S-TSOD", "Tramba-P-TSOD", "Tramba-R-TSOD"]


@pytest.mark.parametrize("method", FULL)
def test_model_k5_k10_shapes_pass_the_kernel_checks(method):
    """Every default-route SS2D's (dm, D) and every DWMSMlp's (d, hid) on
    every map the stages run (96 down to 12 px) at batch 1, 4 and 16: K5's
    shape check and plan, K10's shape check."""
    with torch.device("meta"):
        model = build(method, 384, device="meta", seed=None, dtype=torch.bfloat16)
    k5, k10 = set(), set()
    for m in model.modules():
        for H in (96, 48, 24, 12):
            for B in (1, 4, 16):
                if isinstance(m, SS2D) and m.backend is None and m.d_state == 1:
                    k5.add((B, H, H, m.in_proj.in_features, m.in_proj.out_features))
                elif isinstance(m, DWMSMlp):
                    k10.add((B * H * H, m.fc1.in_features, m.fc1.out_features))
    assert k5 and k10
    for shape in k5:
        tp.check_prologue_shape(*shape)
        plan = ps.prologue_plan(*shape)
        assert plan["stages"] >= 3 and 1 <= plan["mt"] <= 4
    for shape in k10:
        tm.check_ln_mlp_bwd_shape(*shape, name="ln_dwms_mlp_bwd")


@pytest.mark.parametrize("B,H,W,dm,D", [(1, 8, 8, 2048, 4096), (1, 8, 8, 40, 80),
                                        (1, 8, 8, 64, 72), (0, 8, 8, 64, 128),
                                        (1, 8, 8, 8, 16)])
def test_prologue_check_refuses(B, H, W, dm, D):
    with pytest.raises(ValueError, match="prologue"):
        tp.check_prologue_shape(B, H, W, dm, D)
    with pytest.raises(ValueError, match="prologue"):
        ps.prologue_plan(B, H, W, dm, D)


@pytest.mark.parametrize("B,H,dm,tile,mt,groups", [
    (1, 96, 128, (12, 16), 4, 2), (2, 96, 128, (12, 16), 4, 1), (16, 96, 128, (12, 16), 4, 1),
    (2, 48, 256, (12, 16), 4, 4), (2, 24, 512, (6, 14), 2, 8), (16, 24, 512, (6, 14), 2, 1),
    (2, 12, 1024, (6, 6), 1, 16), (16, 12, 1024, (6, 6), 1, 2), (2, 24, 320, (5, 24), 3, 10),
    (2, 48, 512, (7, 12), 2, 2)])
def test_prologue_plan_at_main_path_shapes(B, H, dm, tile, mt, groups):
    """K5's tile: the fewest 64-row M tiles over the map (12 x 16 outputs on
    a 14 x 18 halo at 96 px: 1.33x the outputs' rows, where 8 x 8 tiles on
    112 padded rows took 1.75x); where the tiles fill less than a wave of
    132 blocks, the most channel groups that keep the grid inside one wave."""
    plan = ps.prologue_plan(B, H, H, dm, 2 * dm)
    assert (plan["tile"], plan["mt"], plan["groups"]) == (tile, mt, groups)
    th, tw = tile
    blocks = B * plan["tiles"]
    assert (th + 2) * (tw + 2) <= 64 * mt
    assert blocks * groups <= max(132, blocks)
