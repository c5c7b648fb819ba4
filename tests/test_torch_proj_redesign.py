"""K1's projection launch as its Hopper kernel tiles and splits the work
(``tramba_tpu_torch/ops/proj_stages.py`` mirrors it in plain PyTorch), and
the PyTorch chains ``chip_smoke.py`` times beside every kernel, on the CPU.

* The mirror (``proj_tiled_ref``: the fp32 weight split into three bf16
  terms, an fp32 x too, the products summed per column tile) against
  ``jnp.einsum("bkld,kcd->bklc", ...)`` at ``Precision.HIGHEST`` and against
  the port's plain projection in ``ss2d_scan_train_ref``, with bf16 and fp32
  x, at its own plan and at forced plans (rows 128 or 64, several column
  tiles): max abs difference <= 1e-6 x max |dbc|, the kernel's accuracy bar
  on the card (an fp32 product reads 2-4e-7 there).
* The split sums exactly back to the fp32 weight.
* Each planted fault of the mirror fails the bar.
* Without a launch: the plan of every SS2D shape of the five full-width
  models (built on the meta device) at batch 1, 2, 4 and 16, of the eight
  other scan orders at 48 px and of Tramba-P's decoder widths covers its
  rows and columns within the block's shared memory.
* Each chain of ``chip_smoke.py`` (``proj_lib``, ``merge_lib``,
  ``expand_lib``, ``head_lib``, ``prologue_lib``, ``ln_mlp_lib``,
  ``ln_dwms_mlp_lib``, ``ln_mlp_bwd_lib``, ``ln_dwms_mlp_bwd_lib``) equals
  its kernel's plain version in fp32 at atol 1e-5: every yardstick computes
  its kernel's function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops import proj_stages as ps
from tramba_tpu_torch.ops.scan_orders import get_order, order_tables

BAR = 1e-6  # max abs difference <= BAR x max |dbc|
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _inputs(B, L, D, K, R, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    x = x / (1 + np.exp(-x))  # silu, as the SS2D's conv output
    wx = (rng.normal(size=(K, R + 2, D)) * D ** -0.5).astype(np.float32)
    return x, wx


def _share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_dbc(x, wx):
    """(B, L, K, R+2) from JAX's per-direction einsum at HIGHEST precision."""
    K = wx.shape[0]
    xs = jnp.broadcast_to(jnp.asarray(x)[:, None], (x.shape[0], K, *x.shape[1:]))
    out = jnp.einsum("bkld,kcd->bklc", xs, jnp.asarray(wx),
                     precision=jax.lax.Precision.HIGHEST)
    return np.transpose(np.asarray(out), (0, 2, 1, 3))


# (B, L, D, K, R): 2-3 row tiles of 128; N = 24, 176 (one column tile), 272
# (two at rows 128); D a multiple of 8 but not of 64
CASES = [(2, 150, 40, 4, 4), (1, 300, 64, 8, 20), (1, 260, 136, 4, 66)]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,L,D,K,R", CASES)
def test_mirror_matches_jax_and_plain(dt, B, L, D, K, R):
    x, wx = _inputs(B, L, D, K, R, seed=D + K)
    xt = torch.from_numpy(x).to(TDT[dt])
    wt = torch.from_numpy(wx)
    x_exact = xt.float().numpy()  # the x the kernel sees (bf16 values in bf16)
    want = _jax_dbc(x_exact, wx)
    exact = np.einsum("bld,kcd->blkc", x_exact.astype(np.float64), wx.astype(np.float64))
    got = ps.proj_tiled_ref(xt, wt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, K, R + 2)
    assert _share(got, exact) <= BAR
    assert _share(want, exact) <= BAR
    assert _share(got, want) <= BAR
    idx, _ = order_tables("raster", 1, L, 0, "cpu")
    core = (wt, torch.zeros(K, D, R), torch.zeros(K, D), torch.zeros(K, D, 1), torch.zeros(K, D))
    plain = tf.ss2d_scan_train_ref(xt, idx[:1].expand(K, L), *core)[2]
    assert _share(got, plain) <= BAR
    torch.testing.assert_close(tf.ss2d_proj(xt, wt), plain, rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rows,wn", [(128, 32), (64, 32), (128, 144), (64, 96)])
def test_mirror_at_forced_plans(dt, rows, wn):
    """The tiling does not move the sum: three column tiles of 32 (rows 128)
    or of 64 (rows 64), and one wide tile."""
    B, L, D, K, R = 1, 300, 64, 8, 10
    x, wx = _inputs(B, L, D, K, R, seed=rows + wn)
    xt, wt = torch.from_numpy(x).to(TDT[dt]), torch.from_numpy(wx)
    cols = ps.proj_cols(rows, wn)
    plan = dict(rows=rows, wn=wn, ctiles=-(-K * (R + 2) // cols), tiles=-(-B * L // rows),
                stages=2, smem=0)
    exact = np.einsum("bld,kcd->blkc", xt.double().numpy(), wx.astype(np.float64))
    assert _share(ps.proj_tiled_ref(xt, wt, plan), exact) <= BAR


def test_split_sums_exactly_to_the_weight():
    """Exact for every normal fp32 value down to about 2^-110 (below, the
    last term would fall under bf16's subnormals; no weight comes near)."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-20, 20, 4000),
                        [0.0, 1.0, -1.0, 1.0e-30, 1.0 + 2.0 ** -23, 65504.0, -2.0 ** 100]])
    w = torch.from_numpy(w.astype(np.float32))
    h, m, l = ps.split3(w)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    assert torch.equal(h.double() + m.double() + l.double(), w.double())
    # each term is the bf16 rounding of what the terms before it leave
    assert torch.equal(h, w.to(torch.bfloat16))
    assert torch.equal(m, (w - h.float()).to(torch.bfloat16))
    assert torch.equal(l.float(), w - h.float() - m.float())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("fault", ps.PROJ_FAULTS)
@pytest.mark.parametrize("B,L,D,K,R", CASES)
def test_each_planted_fault_fails_the_bar(dt, fault, B, L, D, K, R):
    x, wx = _inputs(B, L, D, K, R, seed=D + K)
    xt, wt = torch.from_numpy(x).to(TDT[dt]), torch.from_numpy(wx)
    exact = np.einsum("bld,kcd->blkc", xt.double().numpy(), wx.astype(np.float64))
    assert _share(ps.proj_tiled_ref(xt, wt, fault=fault), exact) > BAR


def _ss2d_shapes():
    """{(M, D, N)} of every SS2D of the five full-width models on each map it
    tiles (96 down to 12 px) at batch 1, 2, 4 and 16, of the eight other scan
    orders and Tramba-P's decoder widths (chip_smoke's tables) at batch 2
    and 16."""
    shapes = set()
    for method in chip_smoke.MODELS:
        with torch.device("meta"):
            model = build(method, 384, device="meta", seed=None, dtype=torch.bfloat16)
        for m in model.modules():
            if not isinstance(m, SS2D):
                continue
            K, C, D = m.x_proj_weight.shape
            for H in (96, 48, 24, 12):
                try:
                    order_tables(m.scan_kind, H, H, m.scan_param, "cpu")
                except ValueError:  # an order that does not tile this map never runs there
                    continue
                shapes.update((B * H * H, D, K * C) for B in (1, 2, 4, 16))
    for kind, H, dm, param in (*chip_smoke.NEW_ORDER_SHAPES, *chip_smoke.SS2D_SHAPES_P,
                               *chip_smoke.SS2D_SHAPES_R):
        K, R = get_order(kind, H, H, param).K, -(-dm // 16)
        shapes.update((B * H * H, 2 * dm, K * (R + 2)) for B in (2, 16))
    return shapes


def test_plans_cover_every_model_shape():
    shapes = _ss2d_shapes()
    assert {N for _, _, N in shapes} >= {24, 40, 48, 72, 80, 88, 136, 144, 176, 264, 272}
    for M, D, N in shapes:
        for dt in (torch.float32, torch.bfloat16):
            p = ps.proj_plan(M, D, N, dt)
            assert p["wn"] in ps.PROJ_WNS and p["rows"] in (64, 128)
            assert p["tiles"] * p["rows"] >= M > (p["tiles"] - 1) * p["rows"]
            cols = ps.proj_cols(p["rows"], p["wn"])
            assert p["ctiles"] * cols >= N > (p["ctiles"] - 1) * cols
            f32x = dt == torch.float32
            assert 2 <= p["stages"] <= 4 and p["smem"] <= 227 * 1024
            assert p["smem"] == (ps.proj_fixed(p["rows"], f32x)
                                 + p["stages"] * ps.proj_stage(p["rows"], cols, f32x))


def test_plans_of_tramba_v_at_b16():
    """The 24 px encoder block (15 of Tramba-V's 33 SS2Ds) takes one column
    tile of 144 over 72 row tiles of 128; the 12 px one splits its 264
    columns over a 64-row tile's warpgroups."""
    bf = torch.bfloat16
    assert ps.proj_plan(9216, 1024, 136, bf) == dict(rows=128, wn=144, ctiles=1, tiles=72,
                                                     stages=3, smem=217088)
    p = ps.proj_plan(2304, 2048, 264, bf)
    assert p["rows"] == 64 and p["ctiles"] * 2 * p["wn"] >= 264


@pytest.mark.parametrize("M,D,N,dt", [(0, 64, 24, torch.float32), (10, 66, 24, torch.float32),
                                      (10, 68, 24, torch.bfloat16), (10, 64, 0, torch.bfloat16)])
def test_plan_refuses(M, D, N, dt):
    with pytest.raises(ValueError, match="ss2d_proj"):
        ps.proj_plan(M, D, N, dt)


# --- the chains chip_smoke.py times beside the kernels --------------------------

def _r(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(np.float32))


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,param", [("raster", 0), ("line", 0), ("window", 4)])
def test_proj_and_merge_chains(kind, param):
    rng = np.random.default_rng(len(kind))
    idx, inv = order_tables(kind, 8, 8, param, "cpu")
    K = idx.shape[0]
    x, wx = _r(rng, 2, 64, 32), _r(rng, K, 6, 32, scale=0.2)
    _close(chip_smoke.proj_lib(x, wx), tf.ss2d_proj_ref(x, wx))
    ys = _r(rng, 2, K, 64, 16)
    tail = (_r(rng, 16, scale=0.1, shift=1.0), _r(rng, 16, scale=0.1), _r(rng, 8, 16, scale=0.25))
    _close(chip_smoke.merge_lib(ys, idx, *tail), tf.ss2d_merge_ref(ys, inv, *tail))


def test_expand_head_and_prologue_chains():
    rng = np.random.default_rng(1)
    x = _r(rng, 2, 3, 4, 16)
    ln = (_r(rng, 8, scale=0.1, shift=1.0), _r(rng, 8, scale=0.1))
    w = _r(rng, 32, 16, scale=0.25)
    _close(chip_smoke.expand_lib(x, w, *ln), te.expand_ln_ref(x, w, *ln))
    head = (_r(rng, 256, 16, scale=0.25), _r(rng, 16, scale=0.1, shift=1.0), _r(rng, 16, scale=0.1),
            _r(rng, 16), _r(rng, 1))
    _close(chip_smoke.head_lib(x, *head), te.final_head_ref(x, *head))
    xp = _r(rng, 2, 5, 6, 16)
    w_in, conv = _r(rng, 32, 16, scale=0.25), _r(rng, 32, 1, 3, 3, scale=0.3)
    for norm in (head[1:3], (None, None)):
        _close(chip_smoke.prologue_lib(xp, *norm, w_in, conv), tp.prologue_ref(xp, *norm, w_in, conv))


def _ffn(rng, d, hid, dwms):
    taps = [t for k in (3, 5, 7) for t in (_r(rng, hid, 1, k, k, scale=1 / k),
                                            _r(rng, hid, scale=0.1))] if dwms else []
    return [_r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1), _r(rng, hid, d, scale=0.25),
            _r(rng, hid, scale=0.1), *taps, _r(rng, d, hid, scale=hid ** -0.5), _r(rng, d, scale=0.1)]


@pytest.mark.parametrize("dwms", [False, True], ids=["ln_mlp", "ln_dwms_mlp"])
def test_ffn_chains_and_their_adjoints(dwms):
    rng = np.random.default_rng(2 + dwms)
    params = _ffn(rng, 16, 64, dwms)
    x, g = _r(rng, 2, 5, 6, 16), _r(rng, 2, 5, 6, 16)
    if dwms:
        fwd, ref, bwd, bwd_ref = (chip_smoke.ln_dwms_mlp_lib, tm.ln_dwms_mlp_ref,
                                  chip_smoke.ln_dwms_mlp_bwd_lib, tm.ln_dwms_mlp_bwd_ref)
    else:
        fwd, ref, bwd, bwd_ref = (chip_smoke.ln_mlp_lib, tm.ln_mlp_ref, chip_smoke.ln_mlp_bwd_lib,
                                  tm.ln_mlp_bwd_ref)
    _close(fwd(x, *params), ref(x, *params))
    _close(bwd(x, g, *params[:-1]), bwd_ref(x, g, *params[:-1]))
