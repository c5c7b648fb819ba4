"""K3 ``expand_ln`` and K4 ``final_head`` as their Hopper kernels tile the
work (``tramba_tpu_torch/ops/expand_stages.py`` mirrors the tiling in plain
PyTorch), against the plain versions and the JAX package on the CPU.

* The block mirrors (``expand_tiled_ref``, ``head_tiled_ref``) at their own
  plans -- the wgmma route's (bf16: a block's padded columns, the pair of
  shuffle groups where co <= 128, the columns split over two warpgroups
  where the block is wider than 256) and the SIMT route's (fp32: column
  chunks, a cluster's partial sums) -- against ``expand_ln_ref`` /
  ``final_head_ref`` and against ``fused_expand2`` / ``fused_final_head``
  (``tramba_tpu/ops/fused_expand.py``, the Pallas kernels in interpret mode)
  on the same numpy-seeded inputs: K3 at f 2 and 4, co 12 / 40 / 128 (and
  512, the split), K4 at C 36 / 40 / 64 / 192.  fp32 rtol 1e-4 / atol 1e-5
  (fp32 sums reassociated); bf16 rtol / atol 1e-2 (the same rounding points:
  the one rounding of the output may flip), as
  ``tests/test_torch_bf16_ops.py``.
* Each planted fault of the mirrors fails the bf16 tolerance: p1 and p2
  swapped in the store, the padded columns left in the statistics (which
  only co 12 and 40, C 40 and 192 have: a zero column adds (0 - m)^2 to the
  variance), the last K chunk left out, K4's mean left out of sum (h - m) u.
* Without a launch: the plans cover every K3 / K4 shape of ``chip_smoke.py``
  (``EXPAND_SHAPES``, ``_P``, ``_R``, the heads at C 128 / 64 / 256) and the
  card tests' ragged shapes, at B1, B2 and B16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tramba_tpu.ops import fused_expand as je
from tramba_tpu_torch.ops import expand_stages as es
from tramba_tpu_torch.ops import fused_expand as te

TOL = {"bf16": dict(rtol=1e-2, atol=1e-2), "fp32": dict(rtol=1e-4, atol=1e-5)}
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the check a kernel must pass on the card (chip_smoke.KERNEL_TOL_BF16)
CARD_BF16 = dict(rtol=1.6e-2, atol=1e-2)


def _expand_inputs(B, H, W, C, f, seed):
    rng = np.random.default_rng(seed)
    co = f * C // 4
    return (rng.normal(size=(B, H, W, C)).astype(np.float32),
            (rng.normal(size=(C, f * C)) * C ** -0.5).astype(np.float32),
            (rng.normal(size=co) * 0.1 + 1).astype(np.float32),
            (rng.normal(size=co) * 0.1).astype(np.float32))


def _head_inputs(B, h, w, C, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.2: (rng.normal(size=s) * scale).astype(np.float32)
    return (r(B, h, w, C, scale=1.0), r(C, 16 * C, scale=C ** -0.5), r(C, scale=0.1) + 1,
            r(C, scale=0.1), r(C), r(1))


def _torch(arrays, dt):
    """numpy (x, w in JAX layout, fp32 params...) -> torch (x, w^T in dt, ...)."""
    x, w, *rest = arrays
    return (torch.from_numpy(x).to(dt), torch.from_numpy(np.ascontiguousarray(w.T)).to(dt),
            *[torch.from_numpy(a) for a in rest])


def _jax(arrays, dt):
    x, w, *rest = arrays
    return (jnp.asarray(x, JDT[dt]), jnp.asarray(w, JDT[dt]), *[jnp.asarray(a) for a in rest])


# (B, H, W, C, f): co = f C / 4 = 12, 40, 128 (pair), 128 (single group), 512 (split)
EXPAND_CASES = [(2, 3, 5, 24, 2), (1, 4, 4, 40, 4), (1, 3, 2, 256, 2), (2, 2, 3, 128, 4),
                (1, 2, 2, 1024, 2)]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,f", EXPAND_CASES)
def test_expand_mirror_matches_plain_and_jax(dt, B, H, W, C, f):
    arrays = _expand_inputs(B, H, W, C, f, seed=C + f)
    args = _torch(arrays, TDT[dt])
    got = es.expand_tiled_ref(*args)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (B, 2 * H, 2 * W, f * C // 4)
    np.testing.assert_allclose(got.float().numpy(), te.expand_ln_ref(*args).float().numpy(),
                               **TOL[dt])
    want = je.fused_expand2(*_jax(arrays, dt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dt])


@pytest.mark.parametrize("B,H,W,C,f", EXPAND_CASES)
def test_expand_mirror_at_the_other_route(B, H, W, C, f):
    """fp32 inputs through the wgmma route's blocks (bf16's plan) and bf16
    inputs through the SIMT route's (fp32's plan): the tiling, not the dtype,
    is what the mirror follows."""
    arrays = _expand_inputs(B, H, W, C, f, seed=C)
    for dt, other in (("fp32", torch.bfloat16), ("bf16", torch.float32)):
        args = _torch(arrays, TDT[dt])
        plan = es.expand_plan(B * H * W, C, f * C // 4, other)
        np.testing.assert_allclose(es.expand_tiled_ref(*args, plan=plan).float().numpy(),
                                   te.expand_ln_ref(*args).float().numpy(), **TOL[dt])


# (B, h, w, C, dtypes): C 36 only in fp32 (bf16 rows are 16-byte multiples)
HEAD_CASES = [(2, 3, 5, 36, ("fp32",)), (1, 4, 3, 40, ("fp32", "bf16")),
              (2, 3, 3, 64, ("fp32", "bf16")), (1, 2, 3, 192, ("fp32", "bf16"))]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,h,w,C,dts", HEAD_CASES)
def test_head_mirror_matches_plain_and_jax(dt, B, h, w, C, dts):
    if dt not in dts:
        with pytest.raises(ValueError, match="multiple of 8"):
            es.head_plan(B * h * w, C, TDT[dt])
        return
    arrays = _head_inputs(B, h, w, C, seed=C)
    args = _torch(arrays, TDT[dt])
    got = es.head_tiled_ref(*args)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (B, h, w, 16)
    np.testing.assert_allclose(got.float().numpy(), te.final_head_ref(*args).float().numpy(),
                               **TOL[dt])
    want = je.fused_final_head(*_jax(arrays, dt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dt])


def _fails(got, want):
    return bool((~torch.isclose(got.float(), want.float(), **CARD_BF16)).any())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,f", EXPAND_CASES[:4])
def test_expand_planted_faults_fail(dt, B, H, W, C, f):
    args = _torch(_expand_inputs(B, H, W, C, f, seed=f), TDT[dt])
    co = f * C // 4
    plan = es.expand_plan(B * H * W, C, co, TDT[dt])
    faults = es.expand_faults(plan, co)
    # the padded columns exist where the wgmma block is wider than its groups
    assert ("pad columns in the variance" in faults) == (dt == "bf16" and co in (12, 40))
    want = te.expand_ln_ref(*args)
    assert not _fails(es.expand_tiled_ref(*args), want)
    for fault in faults:
        assert _fails(es.expand_tiled_ref(*args, fault=fault), want), fault


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,h,w,C", [(1, 4, 3, 40), (2, 3, 3, 64), (1, 2, 3, 192)])
def test_head_planted_faults_fail(dt, B, h, w, C):
    args = _torch(_head_inputs(B, h, w, C, seed=C + 1), TDT[dt])
    plan = es.head_plan(B * h * w, C, TDT[dt])
    faults = es.head_faults(plan, C)
    assert ("pad columns in the variance" in faults) == (dt == "bf16" and C in (40, 192))
    want = te.final_head_ref(*args)
    assert not _fails(es.head_tiled_ref(*args), want)
    for fault in faults:
        assert _fails(es.head_tiled_ref(*args, fault=fault), want), fault


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_head_mean_fault_fails_on_every_draw(dt, C):
    """``chip_smoke.head_inputs`` (seg_w positive) at Tramba-P's, -V's and
    -R's head widths: on each of eight draws of a small map the planted "no
    mean in the head sum" fails the card's check and the fault-free mirror
    passes it."""
    for seed in range(8):
        args = chip_smoke.head_inputs("cpu", torch.Generator().manual_seed(seed), TDT[dt], C,
                                      B=1, H=4)
        want = te.final_head_ref(*args)
        assert not _fails(es.head_tiled_ref(*args), want), seed
        assert _fails(es.head_tiled_ref(*args, fault="no mean in the head sum"), want), seed


def test_pad_fault_counts_zero_columns():
    """co 12 paired: the block's 64 columns hold 24 of the two groups and 40
    TMA zeros past 4 co = 48 (group set 1) or the next groups' rows (set 0);
    the fault counts them in group 1's statistics, the kernel masks them."""
    args = _torch(_expand_inputs(1, 2, 2, 24, 2, seed=3), torch.float32)
    plan = es.expand_plan(4, 24, 12, torch.bfloat16)
    assert (plan["route"], plan["gpb"], plan["wn"], plan["split"]) == (0, 2, 64, 0)
    want = te.expand_ln_ref(*args)
    bad = es.expand_tiled_ref(*args, plan=plan, fault="pad columns in the variance")
    ok = torch.isclose(bad, want, rtol=1e-4, atol=1e-5)
    assert ok[:, :, 0::2].all() and not ok[:, :, 1::2].any()  # p2 = 0 masked, p2 = 1 not


def _expand_shapes():
    ragged = [(2, 5, 7, 24, 2), (1, 6, 6, 40, 4), (1, 3, 3, 1024, 2)]
    models = [(B, H, H, C, f) for B in (1, 2, 16)
              for H, C, f in chip_smoke.EXPAND_SHAPES + chip_smoke.EXPAND_SHAPES_P
              + chip_smoke.EXPAND_SHAPES_R]
    return ragged + models


def test_plans_cover_every_shape():
    """Every K3 / K4 shape the card runs has a plan that fits a block; bf16
    takes the wgmma route at every model shape; a wgmma block covers the
    four shuffle groups over grid y, a SIMT cluster stays within 8 blocks."""
    smem_block = 227 * 1024
    for B, H, W, C, f in _expand_shapes():
        co, M = f * C // 4, B * H * W
        for dt in (torch.float32, torch.bfloat16):
            p = es.expand_plan(M, C, co, dt)
            assert p["smem"] <= smem_block and p["tiles"] * p["rows"] >= M, (B, H, C, f, dt, p)
            if dt == torch.bfloat16:
                assert p["route"] == 0 and p["gpb"] * p["sets"] == 4 and p["stages"] >= 3, p
                width = 2 * p["wn"] if p["split"] else p["wn"]
                assert p["gpb"] * co <= width <= 512 and p["wn"] <= 256, p
            else:
                assert p["route"] == 1 and p["sets"] % 4 == 0 and p["sets"] // 4 <= 8, p
                assert p["sets"] // 4 * p["wn"] >= co, p
    for B in (1, 2, 16):
        for C in (128, 64, 256, 36, 40):
            for dt in (torch.float32, torch.bfloat16):
                if dt == torch.bfloat16 and C % 8:
                    continue
                p = es.head_plan(B * 96 * 96, C, dt)
                assert p["smem"] <= smem_block and 16 % p["sets"] == 0, (B, C, dt, p)
                assert p["route"] == (0 if dt == torch.bfloat16 else 1), p


def test_plan_choices():
    """The plans the design notes describe: Tramba-V's 12 px f2 (co 512) on
    64 rows whose columns the warpgroups split; its 48 px f2 (co 128) on the
    pair of groups; K4 at C 128 on 128 rows in four slot groups at B2 (144
    row tiles alone fill 1.09 waves) and one at B16; fp32 K3 at 12 px as
    clusters of four 128-column chunks."""
    bf, f32 = torch.bfloat16, torch.float32
    p = es.expand_plan(2 * 144, 1024, 512, bf)
    assert (p["rows"], p["wn"], p["split"], p["gpb"], p["sets"]) == (64, 256, 1, 1, 4)
    p = es.expand_plan(2 * 48 * 48, 256, 128, bf)
    assert (p["rows"], p["wn"], p["split"], p["gpb"], p["sets"]) == (128, 256, 0, 2, 2)
    assert es.head_plan(2 * 96 * 96, 128, bf)["sets"] == 4
    assert es.head_plan(16 * 96 * 96, 128, bf)["sets"] == 1
    p = es.expand_plan(16 * 144, 1024, 512, f32)
    assert (p["route"], p["rows"], p["wn"], p["sets"]) == (1, 64, 128, 16)


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        es.expand_plan(4, 36, 18, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        es.expand_plan(4, 18, 9, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        es.head_plan(4, 64, torch.float64)
    with pytest.raises(ValueError, match="no plan"):
        es.expand_plan(4, 8192, 8192, torch.float32)  # a cluster of 64 chunks
