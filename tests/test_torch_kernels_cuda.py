"""Kernels K1-K14 vs their plain versions on the card, at small ragged shapes.

CUDA kernels have no CPU mode, so every test here is marked ``cuda``, needs a
CUDA device and skips without one.  Run on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest sets JAX up, which these tests do not
use).  Tolerance for fp32 outputs rtol 1e-4, atol 1e-4: the kernels sum in
another order than the plain versions and use CUDA's expf/log1pf/erff.  For
bf16 outputs rtol 1.6e-2 (torch's bf16 default) and atol 1e-2: the same
rounding points, but another summation order may flip a rounding.  The bf16
adjoints (K9, K10, bf16 K8, and the bf16 train step's autograd) round dh or
g_y to bf16 before long sums, so a flipped rounding moves a whole sum: each
output's max abs error is held to 1e-2 x its largest magnitude.
"""

import pytest
import torch

from tramba_tpu_torch.ops import fused_attn as ta
from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops import selective_scan as ts
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(*shape, generator=gen) * scale + shift


def _ss2d_params(gen, K, D, R, dm):
    return dict(wx=_rand(gen, K, R + 2, D, scale=0.2), wdt=_rand(gen, K, D, R, scale=0.3),
                bias=_rand(gen, K, D, scale=0.2), A_logs=_rand(gen, K, D, 1, scale=0.3),
                Ds=_rand(gen, K, D), ln_w=_rand(gen, D, scale=0.1, shift=1.0),
                ln_b=_rand(gen, D, scale=0.1), w_out=_rand(gen, dm, D, scale=0.2))


@pytest.mark.parametrize("kind,K,H,param,D,R", [
    ("raster", 4, 9, 0, 64, 5), ("line", 8, 10, 0, 64, 3), ("window", 4, 12, 4, 96, 2),
    ("dilation", 4, 8, 4, 32, 1), ("spiral8", 8, 10, 0, 64, 3), ("hilbert", 4, 9, 0, 64, 5)])
def test_scan_and_merge_match_plain(dev, kind, K, H, param, D, R):
    gen = torch.Generator().manual_seed(H)
    x = _rand(gen, 2, H * H, D)
    p = _ss2d_params(gen, K, D, R, 40)
    core = [p[k] for k in ("wx", "wdt", "bias", "A_logs", "Ds")]
    idx, inv = order_tables(kind, H, H, param, "cpu")
    ys_ref = tf.ss2d_scan_ref(x, idx, *core)
    out_ref = tf.ss2d_merge_ref(ys_ref, inv, p["ln_w"], p["ln_b"], p["w_out"])
    n_scan, n_merge = tf.ss2d_scan.launches, tf.ss2d_merge.launches
    idx_d, inv_d = order_tables(kind, H, H, param, dev)
    ys = tf.ss2d_scan(x.to(dev), idx_d, *[c.to(dev) for c in core])
    out = tf.ss2d_merge(ys_ref.contiguous().to(dev), inv_d, p["ln_w"].to(dev), p["ln_b"].to(dev),
                        p["w_out"].to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(ys.cpu(), ys_ref, **TOL)
    torch.testing.assert_close(out.cpu(), out_ref, **TOL)
    assert (tf.ss2d_scan.launches, tf.ss2d_merge.launches) == (n_scan + 1, n_merge + 1)


@pytest.mark.parametrize("factor,B,H,W,C", [(2, 2, 5, 7, 24), (4, 1, 6, 6, 40), (2, 1, 3, 3, 1024)])
def test_expand_ln_matches_plain(dev, factor, B, H, W, C):
    gen = torch.Generator().manual_seed(C)
    co = factor * C // 4
    x, w = _rand(gen, B, H, W, C), _rand(gen, factor * C, C, scale=0.2)
    s, b = _rand(gen, co, scale=0.1, shift=1.0), _rand(gen, co, scale=0.1)
    want = te.expand_ln_ref(x, w, s, b)
    got = te.expand_ln(*(t.to(dev) for t in (x, w, s, b)))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.parametrize("B,h,w,C", [(2, 5, 3, 36), (1, 4, 4, 128)])
def test_final_head_matches_plain(dev, B, h, w, C):
    gen = torch.Generator().manual_seed(C)
    args = [_rand(gen, B, h, w, C), _rand(gen, 16 * C, C, scale=0.2),
            _rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1),
            _rand(gen, C, scale=0.2), _rand(gen, 1)]
    want = te.final_head_ref(*args)
    got = te.final_head(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_kernels_refuse_other_dtypes(dev):
    x = torch.zeros(1, 2, 2, 8, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        te.expand_ln(x, torch.zeros(16, 8, device=dev, dtype=torch.float64),
                     torch.ones(4, device=dev), torch.zeros(4, device=dev))
    with pytest.raises(TypeError, match="bfloat16"):
        tm.ln_mlp(torch.zeros(1, 4, 16, device=dev), torch.ones(16, device=dev),
                  torch.zeros(16, device=dev), *_mlp_params(torch.Generator(), 16, 32, dev))


# ---- bf16: K1-K4 at the shapes above, K5-K7 at ragged ones ------------------


def _bf(t, dev):
    return t.to(dev, torch.bfloat16)


@pytest.mark.parametrize("kind,K,H,param,D,R", [
    ("raster", 4, 9, 0, 64, 5), ("line", 8, 10, 0, 64, 3), ("window", 4, 12, 4, 96, 2),
    ("diagonal8", 8, 12, 0, 64, 4), ("ab2", 4, 7, 0, 32, 2)])
def test_scan_and_merge_bf16_match_plain(dev, kind, K, H, param, D, R):
    """K1 on a bf16 x (fp32 ys: the fp32 tolerance holds); K2 with a bf16
    w_out (bf16 out)."""
    gen = torch.Generator().manual_seed(H + 1)
    x = _rand(gen, 2, H * H, D).to(torch.bfloat16)
    p = _ss2d_params(gen, K, D, R, 40)
    core = [p[k] for k in ("wx", "wdt", "bias", "A_logs", "Ds")]
    w_out = p["w_out"].to(torch.bfloat16)
    idx, inv = order_tables(kind, H, H, param, "cpu")
    ys_ref = tf.ss2d_scan_ref(x, idx, *core)
    out_ref = tf.ss2d_merge_ref(ys_ref, inv, p["ln_w"], p["ln_b"], w_out)
    idx_d, inv_d = order_tables(kind, H, H, param, dev)
    ys = tf.ss2d_scan(x.to(dev), idx_d, *[c.to(dev) for c in core])
    out = tf.ss2d_merge(ys_ref.contiguous().to(dev), inv_d, p["ln_w"].to(dev),
                        p["ln_b"].to(dev), w_out.to(dev))
    torch.cuda.synchronize()
    assert ys.dtype == torch.float32 and out.dtype == torch.bfloat16
    torch.testing.assert_close(ys.cpu(), ys_ref, **TOL)
    torch.testing.assert_close(out.cpu().float(), out_ref.float(), **TOL_BF16)


def test_merge_one_slot_identity_bf16(dev):
    """K2 as _lgp_pallas: K=1, one-slot identity inverse table."""
    gen = torch.Generator().manual_seed(3)
    L, D = 50, 64
    ys = _rand(gen, 2, 1, L, D).to(torch.bfloat16).float()
    inv = torch.arange(L, dtype=torch.int32).reshape(1, 1, L)
    p = _ss2d_params(gen, 1, D, 2, 24)
    args = (p["ln_w"], p["ln_b"], p["w_out"].to(torch.bfloat16))
    want = tf.ss2d_merge_ref(ys, inv, *args)
    got = tf.ss2d_merge(ys.to(dev), inv.to(dev), *(a.to(dev) for a in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


@pytest.mark.parametrize("factor,B,H,W,C", [(2, 2, 5, 7, 24), (4, 1, 6, 6, 40)])
def test_expand_ln_bf16_matches_plain(dev, factor, B, H, W, C):
    gen = torch.Generator().manual_seed(C + 1)
    co = factor * C // 4
    x, w = _rand(gen, B, H, W, C).to(torch.bfloat16), _rand(gen, factor * C, C, scale=0.2)
    w = w.to(torch.bfloat16)
    s, b = _rand(gen, co, scale=0.1, shift=1.0), _rand(gen, co, scale=0.1)
    want = te.expand_ln_ref(x, w, s, b)
    got = te.expand_ln(*(t.to(dev) for t in (x, w, s, b)))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


def test_final_head_bf16_matches_plain(dev):
    gen = torch.Generator().manual_seed(5)
    B, h, w, C = 2, 5, 3, 40
    args = [_rand(gen, B, h, w, C).to(torch.bfloat16),
            _rand(gen, 16 * C, C, scale=0.2).to(torch.bfloat16),
            _rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1),
            _rand(gen, C, scale=0.2), _rand(gen, 1)]
    want = te.final_head_ref(*args)
    got = te.final_head(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


# Tramba-V's K3 shapes (map, C, factor) and its K4 (96 px, C 128: factor 16)
V_EXPAND_SHAPES = [(12, 1024, 2), (24, 512, 2), (48, 256, 2), (12, 512, 4), (24, 256, 4),
                   (48, 128, 4), (96, 128, 16)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("H,C,f", V_EXPAND_SHAPES)
def test_expand_and_head_main_path_shapes(dev, H, C, f, B, dt):
    """K3 and K4 (one native launch a call: wgmma in bf16, SIMT micro-tiles
    in fp32) at Tramba-V's shapes at B2 and at B16, the timed forward's
    batch, against their plain versions on the card; two launches give the
    same bits."""
    from tramba_tpu_torch.ops import _native

    gen = torch.Generator().manual_seed(H + C + f + B)
    if f == 16:
        kern, ref = te.final_head, te.final_head_ref
        args = [_rand(gen, B, H, H, C).to(dt), _rand(gen, 16 * C, C, scale=C ** -0.5).to(dt),
                _rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1),
                _rand(gen, C, scale=0.1), _rand(gen, 1)]
    else:
        kern, ref = te.expand_ln, te.expand_ln_ref
        co = f * C // 4
        args = [_rand(gen, B, H, H, C).to(dt), _rand(gen, f * C, C, scale=C ** -0.5).to(dt),
                _rand(gen, co, scale=0.1, shift=1.0), _rand(gen, co, scale=0.1)]
    args = [t.to(dev) for t in args]
    n0 = _native.native_launch_count()
    got = kern(*args)
    assert _native.native_launch_count() - n0 == 1
    assert got.dtype == dt and torch.equal(got, kern(*args))
    torch.testing.assert_close(got.float(), ref(*args).float(),
                               **(TOL_BF16 if dt == torch.bfloat16 else TOL))


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("B,H,W,dm,D", [(2, 9, 11, 48, 80), (1, 12, 12, 320, 128)])
def test_prologue_matches_plain(dev, with_ln, B, H, W, dm, D):
    """Ragged 8x8 tiles; dm 320 stages its input in two chunks of 160."""
    gen = torch.Generator().manual_seed(dm + with_ln)
    x = _rand(gen, B, H, W, dm).to(torch.bfloat16)
    ln = (_rand(gen, dm, scale=0.1, shift=1.0), _rand(gen, dm, scale=0.1, shift=0.5))
    ln = ln if with_ln else (None, None)
    w_in = _rand(gen, D, dm, scale=dm ** -0.5).to(torch.bfloat16)
    k = _rand(gen, D, 1, 3, 3, scale=0.3).to(torch.bfloat16)
    want = tp.prologue_ref(x, *ln, w_in, k)
    n = tp.prologue.launches
    got = tp.prologue(x.to(dev), *(None if t is None else t.to(dev) for t in ln), w_in.to(dev),
                      k.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tp.prologue.launches == n + 1
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


def _mlp_params(gen, d, hid, dev):
    return [_bf(_rand(gen, hid, d, scale=d ** -0.5), dev), _rand(gen, hid, scale=0.1).to(dev),
            _bf(_rand(gen, d, hid, scale=hid ** -0.5), dev), _rand(gen, d, scale=0.1).to(dev)]


@pytest.mark.parametrize("B,L,d,hid", [(2, 37, 48, 80), (1, 40, 1024, 4096), (3, 700, 128, 512)])
def test_ln_mlp_matches_plain(dev, B, L, d, hid):
    """Ragged row blocks; d 1024 / hid 4096 is the 12 px encoder MLP."""
    gen = torch.Generator().manual_seed(d)
    x = _rand(gen, B, L, d).to(torch.bfloat16)
    ln = [_rand(gen, d, scale=0.1, shift=1.0).to(dev), _rand(gen, d, scale=0.1).to(dev)]
    params = _mlp_params(gen, d, hid, dev)
    want = tm.ln_mlp_ref(x, *(t.cpu() for t in ln + params))
    n = tm.ln_mlp.launches
    got = tm.ln_mlp(x.to(dev), *ln, *params)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tm.ln_mlp.launches == n + 1
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


# ---- K2 and K6 at the redesign's ragged and odd shapes ----------------------
#
# K2 takes a tile of 16 to 64 pixels and 128 output columns per column tile,
# a lane up to 16 groups of 4 channels; K6 64 rows, 64-column output tiles
# (d 320 padded to 384, d 1024 in two column groups) and hidden chunks of
# 64 or 128, split over blocks at small M.  These shapes leave every edge
# ragged: pixels past the last tile, dm and hid not multiples of the tiles,
# a table of many slots, one direction, the widest D.


@pytest.mark.parametrize("kind,H,param,D,dm,B,emit", [
    ("line", 24, 0, 640, 320, 1, False), ("line", 13, 0, 96, 72, 2, True),
    ("raster", 11, 0, 2048, 1000, 1, False), ("raster", 12, 0, 2048, 1024, 1, True),
    ("window", 16, 8, 1024, 512, 1, False), ("identity", 7, 0, 40, 24, 2, False)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_merge_redesign_shapes(dev, dt, kind, H, param, D, dm, B, emit):
    """K2 vs ss2d_merge_ref / ss2d_merge_train_ref; two launches give the
    same bits."""
    gen = torch.Generator().manual_seed(D + dm)
    L = H * H
    if kind == "identity":  # _lgp_pallas: K = 1, one slot
        inv = torch.arange(L, dtype=torch.int32).reshape(1, 1, L)
    else:
        inv = order_tables(kind, H, H, param, "cpu")[1]
    ys = _rand(gen, B, inv.shape[0], L, D)
    p = _ss2d_params(gen, 1, D, 2, dm)
    tail = (p["ln_w"], p["ln_b"], (p["w_out"] * D ** -0.5).to(dt))
    ref = tf.ss2d_merge_train_ref if emit else tf.ss2d_merge_ref
    want = ref(ys, inv, *tail)
    args = (ys.to(dev), inv.to(dev), *(t.to(dev) for t in tail))
    got, again = (tf.ss2d_merge(*args, emit_ysum=emit) for _ in range(2))
    torch.cuda.synchronize()
    want, got, again = ((o if emit else (o,)) for o in (want, got, again))
    for g, a, w in zip(got, again, want):
        assert g.dtype == dt and torch.equal(g, a)
        torch.testing.assert_close(g.cpu().float(), w.float(),
                                   **(TOL_BF16 if dt == torch.bfloat16 else TOL))


@pytest.mark.parametrize("M,d,hid", [(144, 64, 256), (144, 320, 1280), (300, 1024, 4096),
                                     (77, 256, 1024), (1000, 512, 2048), (576, 512, 2048),
                                     (129, 128, 512)])
def test_ln_mlp_redesign_shapes(dev, M, d, hid):
    """K6 (LayerNorm folded in) vs ln_mlp_ref at the guides' widths, a 12 px
    map at batch 1 (144 rows), ragged row tiles and split hidden chunks; two
    launches give the same bits, and no separate LayerNorm launch is made."""
    gen = torch.Generator().manual_seed(M + d)
    x = _rand(gen, M, d).to(torch.bfloat16)
    ln = [_rand(gen, d, scale=0.1, shift=1.0).to(dev), _rand(gen, d, scale=0.1).to(dev)]
    params = _mlp_params(gen, d, hid, dev)
    want = tm.ln_mlp_ref(x, *(t.cpu() for t in ln + params))
    xd = x.to(dev)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tm.ln_mlp(xd, *ln, *params)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.self_device_time_total > 0]
    assert not any("ln_rows_kernel" in n for n in names), names
    assert torch.equal(got, tm.ln_mlp(xd, *ln, *params))
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


@pytest.mark.parametrize("B,H,W,d,hid", [(2, 11, 13, 48, 80), (1, 9, 9, 512, 2048),
                                         (1, 16, 16, 128, 512)])
def test_ln_dwms_mlp_matches_plain(dev, B, H, W, d, hid):
    """Ragged 8x8 tiles with 3-px halos across tile edges; d 512 stages its
    input in chunks of 64 channels."""
    gen = torch.Generator().manual_seed(d + H)
    x = _rand(gen, B, H, W, d).to(torch.bfloat16)
    ln = [_rand(gen, d, scale=0.1, shift=1.0), _rand(gen, d, scale=0.1)]
    w1, b1, w2, b2 = _mlp_params(gen, d, hid, "cpu")
    convs = []
    for n in (3, 5, 7):
        convs += [_rand(gen, hid, 1, n, n, scale=0.2).to(torch.bfloat16),
                  _rand(gen, hid, scale=0.1)]
    args = ln + [w1, b1] + convs + [w2, b2]
    want = tm.ln_dwms_mlp_ref(x, *args)
    n = tm.ln_dwms_mlp.launches
    got = tm.ln_dwms_mlp(x.to(dev), *(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tm.ln_dwms_mlp.launches == n + 1
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


# ---- training: K1 / K2 train variants, K8, autograd through the kernels -----

# K8 sums over whole sequences and batches in another order than the plain
# version: max abs error <= 1e-4 x the largest magnitude of each output
BWD_REL = 1e-4


def _bwd_close(got, want, name):
    err = (got.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= BWD_REL * scale, f"{name}: max abs error {err} > {BWD_REL} x {scale}"


def _core_inputs(gen, kind, K, H, param, D, R, B=2, dm=40):
    """Projections at the scale of the model's init, 1.6 / sqrt(D) and
    1 / sqrt(R) (0.2 at D = 64), so that dt stays O(1) at D = 2048."""
    x = _rand(gen, B, H * H, D)
    p = _ss2d_params(gen, K, D, R, dm)
    p["wx"] = _rand(gen, K, R + 2, D, scale=1.6 * D ** -0.5)
    p["wdt"] = _rand(gen, K, D, R, scale=R ** -0.5)
    core = [p[k] for k in ("wx", "wdt", "bias", "A_logs", "Ds")]
    idx, inv = order_tables(kind, H, H, param, "cpu")
    return x, p, core, idx, inv


# (order, map, window/rate, D, R): L = 144 and L < 64, a line order (pixels in
# several slots of one direction), R = 64 at D = 2048 (the 12 px encoder), and
# two of the spiral / Hilbert orders (K = 8 and K = 4)
TRAIN_SHAPES = [("raster", 4, 12, 0, 64, 5), ("raster", 4, 7, 0, 32, 3),
                ("raster", 4, 3, 0, 2048, 64), ("line", 8, 10, 0, 64, 3),
                ("window", 4, 12, 4, 96, 2), ("dilation", 4, 8, 4, 32, 1),
                ("line", 8, 12, 0, 256, 16), ("spiral8", 8, 12, 0, 64, 4),
                ("hilbert", 4, 9, 0, 32, 2)]


@pytest.mark.parametrize("kind,K,H,param,D,R", TRAIN_SHAPES)
def test_train_variants_match_plain(dev, kind, K, H, param, D, R):
    """K1 with carries and dbc, K2 with the pre-LN sum."""
    gen = torch.Generator().manual_seed(D + H)
    x, p, core, idx, inv = _core_inputs(gen, kind, K, H, param, D, R)
    want = tf.ss2d_scan_train_ref(x, idx, *core, tf.scan_chunk())
    idx_d, inv_d = order_tables(kind, H, H, param, dev)
    n = tf.ss2d_scan.launches
    got = tf.ss2d_scan(x.to(dev), idx_d, *[c.to(dev) for c in core], emit=True)
    tail = (p["ln_w"], p["ln_b"], p["w_out"])
    want_m = tf.ss2d_merge_train_ref(want[0], inv, *tail)
    got_m = tf.ss2d_merge(want[0].to(dev), inv_d, *(t.to(dev) for t in tail), emit_ysum=True)
    torch.cuda.synchronize()
    assert tf.ss2d_scan.launches == n + 1
    for g, w in zip(got + got_m, want + want_m):
        torch.testing.assert_close(g.cpu(), w, **TOL)


@pytest.mark.parametrize("kind,K,H,param,D,R", TRAIN_SHAPES)
def test_scan_bwd_matches_plain(dev, kind, K, H, param, D, R):
    """K8 vs ss2d_scan_bwd_ref on the same carries, dbc and cotangent."""
    gen = torch.Generator().manual_seed(D + H + 1)
    x, p, core, idx, inv = _core_inputs(gen, kind, K, H, param, D, R)
    chunk = tf.scan_chunk()
    _, carries, dbc = tf.ss2d_scan_train_ref(x, idx, *core, chunk)
    g_y = _rand(gen, *x.shape)
    want = tf.ss2d_scan_bwd_ref(x, idx, inv, g_y, carries, dbc, *core, chunk)
    idx_d, inv_d = order_tables(kind, H, H, param, dev)
    n = tf.ss2d_scan_bwd.launches
    got = tf.ss2d_scan_bwd(*(t.to(dev) for t in (x,)), idx_d, inv_d,
                           *(t.to(dev) for t in (g_y, carries, dbc, *core)))
    torch.cuda.synchronize()
    assert tf.ss2d_scan_bwd.launches == n + 1
    for name, g, w in zip(("dx", "dwx", "dwdt", "dbias", "dA_logs", "dDs"), got, want):
        _bwd_close(g, w, name)


def test_ss2d_core_autograd_on_card(dev):
    """SS2DCore (K1, K2 forward; K8 backward) vs CPU autograd through the plain
    versions: every input's gradient."""
    gen = torch.Generator().manual_seed(7)
    K, H, D, R = 8, 10, 64, 4
    x, p, core, idx, inv = _core_inputs(gen, "line", K, H, 0, D, R)
    cpu = [x, *core, p["ln_w"], p["ln_b"], p["w_out"]]
    card = [t.to(dev).requires_grad_(True) for t in cpu]
    cpu = [t.clone().requires_grad_(True) for t in cpu]
    g = _rand(gen, 2, H * H, p["w_out"].shape[0])
    out = tf.ss2d_merge_ref(tf.ss2d_scan_ref(cpu[0], idx, *cpu[1:6]), inv, *cpu[6:])
    want = torch.autograd.grad(out, cpu, g)
    counts = (tf.ss2d_scan.launches, tf.ss2d_merge.launches, tf.ss2d_scan_bwd.launches)
    got_out = tf.ss2d_full(*card, "line", H, H)
    got = torch.autograd.grad(got_out, card, g.to(dev))
    torch.cuda.synchronize()
    assert (tf.ss2d_scan.launches, tf.ss2d_merge.launches,
            tf.ss2d_scan_bwd.launches) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(got_out.detach().cpu(), out.detach(), **TOL)
    for i, (a, b) in enumerate(zip(got, want)):
        _bwd_close(a, b, f"input {i}")


def test_expand_and_head_carry_gradients(dev):
    """K3 / K4 under autograd: the output has a grad_fn and the gradients of
    every input match the plain versions' on the CPU."""
    gen = torch.Generator().manual_seed(11)
    for fn, ref, args in (
            (te.expand_ln, te.expand_ln_ref,
             [_rand(gen, 2, 5, 7, 24), _rand(gen, 48, 24, scale=0.2),
              _rand(gen, 12, scale=0.1, shift=1.0), _rand(gen, 12, scale=0.1)]),
            (te.final_head, te.final_head_ref,
             [_rand(gen, 2, 5, 3, 36), _rand(gen, 16 * 36, 36, scale=0.2),
              _rand(gen, 36, scale=0.1, shift=1.0), _rand(gen, 36, scale=0.1),
              _rand(gen, 36, scale=0.2), _rand(gen, 1)])):
        cpu = [a.clone().requires_grad_(True) for a in args]
        card = [a.to(dev).requires_grad_(True) for a in args]
        out = ref(*cpu)
        got = fn(*card)
        assert got.grad_fn is not None
        g = _rand(gen, *out.shape)
        want = torch.autograd.grad(out, cpu, g)
        have = torch.autograd.grad(got, card, g.to(dev))
        for a, b in zip(have, want):
            torch.testing.assert_close(a.cpu(), b, **TOL)


# ---- bf16 training: K9, K10, bf16 K1 / K2 / K8, autograd through K5-K7 ------

BF16_BWD_REL = 1e-2


def _bf16_bwd_close(got, want, name):
    got, want = got.detach().cpu().float(), want.detach().float()
    assert got.shape == want.shape, name
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= BF16_BWD_REL * scale, f"{name}: max abs error {err} > {BF16_BWD_REL} x {scale}"


def _dwms_args(gen, d, hid):
    ln = [_rand(gen, d, scale=0.1, shift=1.0), _rand(gen, d, scale=0.1)]
    w1, b1, w2, b2 = (t.cpu() for t in _mlp_params(gen, d, hid, "cpu"))
    convs = []
    for n in (3, 5, 7):
        convs += [_rand(gen, hid, 1, n, n, scale=0.2), _rand(gen, hid, scale=0.1)]
    return ln, [w1.float(), b1], convs, [w2.float(), b2]


@pytest.mark.parametrize("B,L,d,hid", [(2, 37, 48, 80), (1, 40, 1024, 4096), (3, 700, 128, 512)])
def test_ln_mlp_bwd_matches_plain(dev, B, L, d, hid):
    """K9 vs ln_mlp_bwd_ref: ragged row blocks, the 12 px encoder MLP."""
    gen = torch.Generator().manual_seed(d + 1)
    x, g = _rand(gen, B, L, d).to(torch.bfloat16), _rand(gen, B, L, d).to(torch.bfloat16)
    ln, (w1, b1), _, (w2, _) = _dwms_args(gen, d, hid)
    args = (*ln, w1, b1, w2)
    want = tm.ln_mlp_bwd_ref(x, g, *args)
    n = tm.ln_mlp_bwd.launches
    got = tm.ln_mlp_bwd(x.to(dev), g.to(dev), *(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert tm.ln_mlp_bwd.launches == n + 1 and got[0].dtype == torch.bfloat16
    for name, a, b in zip(("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dw2", "db2"), got, want):
        _bf16_bwd_close(a, b, name)


@pytest.mark.parametrize("B,H,W,d,hid", [(2, 11, 13, 48, 80), (1, 9, 9, 512, 2048),
                                         (1, 16, 16, 128, 512)])
def test_ln_dwms_mlp_bwd_matches_plain(dev, B, H, W, d, hid):
    """K10 vs ln_dwms_mlp_bwd_ref, including the 3 tap gradients."""
    gen = torch.Generator().manual_seed(d + H + 1)
    x, g = _rand(gen, B, H, W, d).to(torch.bfloat16), _rand(gen, B, H, W, d).to(torch.bfloat16)
    ln, fc1, convs, (w2, _) = _dwms_args(gen, d, hid)
    args = (*ln, *fc1, *convs, w2)
    want = tm.ln_dwms_mlp_bwd_ref(x, g, *args)
    n = tm.ln_dwms_mlp_bwd.launches
    got = tm.ln_dwms_mlp_bwd(x.to(dev), g.to(dev), *(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert tm.ln_dwms_mlp_bwd.launches == n + 1 and got[0].dtype == torch.bfloat16
    names = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dk3", "dc3", "dk5", "dc5", "dk7", "dc7",
             "dw2", "db2")
    for name, a, b in zip(names, got, want):
        _bf16_bwd_close(a, b, name)


# (map, d) of every main-path K7 (Tramba-V's, -P's and -R's decoder FFNs;
# Tramba-S's are Tramba-V's) and K9 (the encoders' and guides' LN-MLPs)
K7_SHAPES = [(96, 128), (48, 256), (24, 512), (96, 64), (48, 128), (24, 320), (96, 256),
             (48, 512)]
K9_SHAPES = K7_SHAPES + [(12, 1024)]


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("H,d", K7_SHAPES)
def test_ln_dwms_mlp_main_path_shapes(dev, H, d, B):
    """K7 (h written once, the merged 7x7 stencil, fc2 on wgmma) at every
    main-path shape at B1 and B16 against its plain version on the card;
    two launches give the same bits."""
    gen = torch.Generator().manual_seed(H + d + B)
    hid = 4 * d
    ln, (w1, b1), convs, (w2, b2) = _dwms_args(gen, d, hid)
    args = [t.to(dev) for t in (*ln, w1, b1, *convs, w2, b2)]
    x = _rand(gen, B, H, H, d).to(dev, torch.bfloat16)
    got = tm.ln_dwms_mlp(x, *args)
    assert torch.equal(got, tm.ln_dwms_mlp(x, *args))
    want = tm.ln_dwms_mlp_ref(x, *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("H,d", K9_SHAPES)
def test_ln_mlp_bwd_main_path_shapes(dev, H, d, B):
    """K9 (fused front, column-grouped (c), one-launch sums) at every
    main-path shape at B1 and B16 against its plain adjoint on the card;
    two launches give the same bits."""
    gen = torch.Generator().manual_seed(H + d + B + 1)
    hid = 4 * d
    ln, (w1, b1), _, (w2, _) = _dwms_args(gen, d, hid)
    args = [t.to(dev) for t in (*ln, w1, b1, w2)]
    x, g = (_rand(gen, B, H * H, d).to(dev, torch.bfloat16) for _ in range(2))
    got = tm.ln_mlp_bwd(x, g, *args)
    again = tm.ln_mlp_bwd(x, g, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tm.ln_mlp_bwd_ref(x, g, *args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dw2", "db2"), got, want):
        _bf16_bwd_close(a, b.cpu(), name)


@pytest.mark.parametrize("B", [1, 2, 4, 16])
@pytest.mark.parametrize("H,d", K9_SHAPES)
def test_column_groups_mirror_the_kernel_plan(dev, H, d, B):
    """The plain mirror's column groups of stage (c)
    (``ffn_stages.column_groups``) are those the built library plans for K9
    and K10 at every main-path shape."""
    from tramba_tpu_torch.ops import ffn_stages as fs

    M = B * H * H
    assert fs.column_groups(M, d) == tm.mlp_bwd_column_groups(M, d, 4 * d)


@pytest.mark.parametrize("B,H,d", [(1, 24, 512), (2, 48, 256), (1, 24, 320), (4, 96, 128)])
def test_ln_dwms_mlp_bwd_new_tail(dev, B, H, d):
    """K10 through K9's new (c) - (e), where (c) splits d into column groups
    (a cluster) and where it does not, against its plain adjoint."""
    gen = torch.Generator().manual_seed(H + d + 5)
    hid = 4 * d
    ln, fc1, convs, (w2, _) = _dwms_args(gen, d, hid)
    args = [t.to(dev) for t in (*ln, *fc1, *convs, w2)]
    x, g = (_rand(gen, B, H, H, d).to(dev, torch.bfloat16) for _ in range(2))
    got = tm.ln_dwms_mlp_bwd(x, g, *args)
    want = tm.ln_dwms_mlp_bwd_ref(x, g, *args)
    torch.cuda.synchronize()
    names = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dk3", "dc3", "dk5", "dc5", "dk7", "dc7",
             "dw2", "db2")
    for name, a, b in zip(names, got, want):
        _bf16_bwd_close(a, b.cpu(), name)


@pytest.mark.parametrize("B,H,W,d,hid", [(1, 3, 5, 32, 128), (2, 6, 6, 64, 256),
                                         (1, 1, 1, 16, 64), (3, 9, 17, 48, 80)])
def test_ln_dwms_mlp_bwd_small_and_odd_maps(dev, B, H, W, d, hid):
    """K10's stencils on maps smaller than the 7x7 window (1 x 1, 3 x 5, 6 x 6:
    every halo pixel but the map's own arrives as a TMA zero) and on ragged 8x8
    tiles with a hidden width that ends inside a 64-channel chunk (hid 80);
    six native launches a call; two launches give the same bits."""
    gen = torch.Generator().manual_seed(H * W + d)
    ln, fc1, convs, (w2, _) = _dwms_args(gen, d, hid)
    args = [t.to(dev) for t in (*ln, *fc1, *convs, w2)]
    x, g = (_rand(gen, B, H, W, d).to(dev, torch.bfloat16) for _ in range(2))
    from tramba_tpu_torch.ops import _native

    n0 = _native.native_launch_count()
    got = tm.ln_dwms_mlp_bwd(x, g, *args)
    assert _native.native_launch_count() - n0 == 6  # front, two stencils, K9's (c)-(e)
    assert all(torch.equal(a, b) for a, b in zip(got, tm.ln_dwms_mlp_bwd(x, g, *args)))
    want = tm.ln_dwms_mlp_bwd_ref(x, g, *args)
    torch.cuda.synchronize()
    names = ("dx", "d_ln_w", "d_ln_b", "dw1", "db1", "dk3", "dc3", "dk5", "dc5", "dk7", "dc7",
             "dw2", "db2")
    for name, a, b in zip(names, got, want):
        _bf16_bwd_close(a, b.cpu(), name)


# (map, dm, with LN) of every main-path K5: Tramba-V's (and -S's decoder)
# encoder and decoder SS2Ds with their block's LN and the guides without,
# Tramba-P's and -R's decoders
K5_SHAPES = [(96, 128, True), (48, 256, True), (24, 512, True), (12, 1024, True),
             (96, 128, False), (48, 256, False), (24, 512, False), (96, 64, True),
             (24, 320, True), (24, 320, False), (96, 256, True), (48, 512, False)]


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("H,dm,with_ln", K5_SHAPES)
def test_prologue_main_path_shapes(dev, H, dm, with_ln, B):
    """K5 (one native launch, LN folded in, in_proj on wgmma) at the main
    path's shapes at B1 and B16 against its plain version on the card; two
    launches give the same bits; the tile mirror's plan is the kernel's."""
    from tramba_tpu_torch.ops import prologue_stages as ps

    gen = torch.Generator().manual_seed(H + dm + B + with_ln)
    D = 2 * dm
    x = _rand(gen, B, H, H, dm).to(dev, torch.bfloat16)
    ln = ((_rand(gen, dm, scale=0.1, shift=1.0).to(dev), _rand(gen, dm, scale=0.1).to(dev))
          if with_ln else (None, None))
    w_in = _rand(gen, D, dm, scale=dm ** -0.5).to(dev, torch.bfloat16)
    k = _rand(gen, D, 1, 3, 3, scale=0.3).to(dev, torch.bfloat16)
    from tramba_tpu_torch.ops import _native

    n0 = _native.native_launch_count()
    got = tp.prologue(x, *ln, w_in, k)
    assert _native.native_launch_count() - n0 == 1  # the LayerNorm folded in
    assert torch.equal(got, tp.prologue(x, *ln, w_in, k))
    torch.testing.assert_close(got.float(), tp.prologue_ref(x, *ln, w_in, k).float(), **TOL_BF16)
    plan = ps.prologue_plan(B, H, H, dm, D)
    assert tp.prologue_plan(B, H, H, dm, D) == (*plan["tile"], plan["mt"], plan["groups"],
                                                 plan["stages"])


@pytest.mark.parametrize("kind,K,H,param,D,R", TRAIN_SHAPES)
def test_bf16_train_variants_and_scan_bwd_match_plain(dev, kind, K, H, param, D, R):
    """#13's emit_train in bf16: K1 on a bf16 x with carries and dbc, K2 with
    a bf16 w_out and a bf16 pre-LN sum, K8 on bf16 x and g_y."""
    gen = torch.Generator().manual_seed(D + H + 2)
    x, p, core, idx, inv = _core_inputs(gen, kind, K, H, param, D, R)
    x = x.to(torch.bfloat16)
    chunk = tf.scan_chunk()
    want = tf.ss2d_scan_train_ref(x, idx, *core, chunk)
    idx_d, inv_d = order_tables(kind, H, H, param, dev)
    got = tf.ss2d_scan(x.to(dev), idx_d, *[c.to(dev) for c in core], emit=True)
    tail = (p["ln_w"], p["ln_b"], p["w_out"].to(torch.bfloat16))
    want_m = tf.ss2d_merge_train_ref(want[0], inv, *tail)
    got_m = tf.ss2d_merge(want[0].to(dev), inv_d, *(t.to(dev) for t in tail), emit_ysum=True)
    g_y = _rand(gen, *x.shape).to(torch.bfloat16)
    want_b = tf.ss2d_scan_bwd_ref(x, idx, inv, g_y, *want[1:], *core, chunk)
    n = tf.ss2d_scan_bwd.launches
    got_b = tf.ss2d_scan_bwd(x.to(dev), idx_d, inv_d, g_y.to(dev),
                             *(t.to(dev) for t in (*want[1:], *core)))
    torch.cuda.synchronize()
    assert tf.ss2d_scan_bwd.launches == n + 1
    assert got_m[1].dtype == got_b[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)
    for g, w in zip(got_m, want_m):
        torch.testing.assert_close(g.cpu().float(), w.float(), **TOL_BF16)
    for name, g, w in zip(("dx", "dwx", "dwdt", "dbias", "dA_logs", "dDs"), got_b, want_b):
        _bf16_bwd_close(g, w, name)


def test_bf16_kernels_carry_gradients(dev):
    """K5 (Prologue), K6/K9 (LnMlp), K7/K10 (LnDwmsMlp) and bf16 SS2DCore
    under autograd on the card: the outputs keep a grad_fn, each backward
    kernel launches once, and every input's gradient matches the plain
    adjoint on the CPU (K5's backward is the plain version's VJP)."""
    gen = torch.Generator().manual_seed(17)
    bf = torch.bfloat16
    x = _rand(gen, 2, 9, 11, 48).to(bf)
    ln, fc1, convs, fc2 = _dwms_args(gen, 48, 80)
    g = _rand(gen, 2, 9, 11, 48).to(bf)
    cases = [
        (tm.ln_mlp, tm.ln_mlp_bwd, [x, *ln, *fc1, *fc2],
         lambda a: tm.ln_mlp_bwd_ref(a[0], g, *a[1:6])),
        (tm.ln_dwms_mlp, tm.ln_dwms_mlp_bwd, [x, *ln, *fc1, *convs, *fc2],
         lambda a: tm.ln_dwms_mlp_bwd_ref(a[0], g, *a[1:12]))]
    for fn, bwd, args, plain_bwd in cases:
        card = [a.to(dev).requires_grad_(True) for a in args]
        n = bwd.launches
        out = fn(*card)
        assert out.grad_fn is not None and out.dtype == bf
        got = torch.autograd.grad(out, card, g.to(dev))
        assert bwd.launches == n + 1
        want = plain_bwd(args)
        for i, (a, b) in enumerate(zip(got, want)):
            _bf16_bwd_close(a, b, f"{fn.__name__} input {i}")
        _bf16_bwd_close(got[-1], g.float().sum((0, 1, 2)), f"{fn.__name__} db2")
    w_in, k = _rand(gen, 96, 48, scale=0.15), _rand(gen, 96, 1, 3, 3, scale=0.3)
    cpu = [a.clone().requires_grad_(True) for a in (x, *ln, w_in, k)]
    card = [a.to(dev).requires_grad_(True) for a in (x, *ln, w_in, k)]
    out = tp.prologue(*card)
    gu = _rand(gen, *out.shape).to(bf)
    got = torch.autograd.grad(out, card, gu.to(dev))
    want = torch.autograd.grad(tp.prologue_ref(*cpu), cpu, gu)
    for i, (a, b) in enumerate(zip(got, want)):
        _bf16_bwd_close(a, b, f"prologue input {i}")


# ---- Tramba-P / Tramba-S: K11 ln_dwmlp, K12 sra, K13 window_attn -------------


@pytest.mark.parametrize("B,H,W,d,hid", [(2, 11, 13, 48, 128), (1, 24, 24, 320, 1280),
                                         (2, 16, 16, 64, 512), (16, 24, 24, 320, 1280),
                                         (1, 12, 20, 128, 1024), (16, 9, 30, 64, 512),
                                         (2, 16, 16, 384, 1536), (1, 16, 16, 512, 2048),
                                         (16, 16, 16, 512, 2048), (2, 11, 13, 400, 512)])
def test_ln_dwmlp_matches_plain(dev, B, H, W, d, hid):
    """Ragged 8x8 tiles with 1-px halos (maps whose sides are no multiple of
    8); d 320 / hid 1280 is PVT stage 3 (three warpgroup tiles of fc2's
    columns), at B1 (the hidden chunks split over blocks) and B16; d 384 the
    widest one-launch shape; d 512 / hid 2048 PVT stage 4 at 512 px and d 400
    on a ragged map, on the wide route (K7's two launches).  One native
    launch a call, two on the wide route, one more where the plan splits the
    chunks; the plan is the mirror's (ops/encoder_stages.py)."""
    from tramba_tpu_torch.ops import _native
    from tramba_tpu_torch.ops import encoder_stages as es

    gen = torch.Generator().manual_seed(d + H + 3)
    x = _rand(gen, B, H, W, d).to(torch.bfloat16)
    ln = [_rand(gen, d, scale=0.1, shift=1.0), _rand(gen, d, scale=0.1)]
    w1, b1, w2, b2 = _mlp_params(gen, d, hid, "cpu")
    conv = [_rand(gen, hid, 1, 3, 3, scale=0.3), _rand(gen, hid, scale=0.1)]
    args = ln + [w1, b1] + conv + [w2, b2]
    want = tm.ln_dwmlp_ref(x, *args)
    n = tm.ln_dwmlp.launches
    card = [x.to(dev), *(t.to(dev) for t in args)]
    n0 = _native.native_launch_count()
    got = tm.ln_dwmlp(*card)
    plan = tm.dwmlp_plan(B, H, W, d, hid)
    assert plan == es.dwmlp_plan(B, H, W, d, hid) and plan["wide"] == (d > 384)
    assert _native.native_launch_count() - n0 == 1 + plan["wide"] + (plan["splits"] > 1)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tm.ln_dwmlp.launches == n + 1
    assert torch.equal(got, tm.ln_dwmlp(*card))
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


def _attn_weights(gen, C, nqkv):
    return [_rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1),
            _rand(gen, nqkv * C, C, scale=C ** -0.5), _rand(gen, nqkv * C, scale=0.1),
            _rand(gen, C, C, scale=C ** -0.5), _rand(gen, C, scale=0.1)]


@pytest.mark.parametrize("B,N,C,nh,Lk", [(2, 100, 64, 1, 16), (1, 576, 320, 5, 144),
                                         (2, 144, 512, 8, 144), (1, 1024, 128, 2, 64),
                                         (2, 96, 40, 5, 24), (2, 1024, 320, 5, 256),
                                         (1, 400, 64, 1, 400), (2, 256, 256, 2, 200),
                                         (16, 144, 512, 8, 144), (1, 200, 96, 3, 20),
                                         (2, 100, 1024, 16, 144), (1, 64, 256, 32, 24),
                                         (2, 40, 256, 1, 200), (1, 48, 2048, 1, 8),
                                         (1, 36, 3584, 28, 64)])
def test_sra_matches_plain(dev, B, N, C, nh, Lk):
    """Ragged row tiles (N = 100, 200, 400); the PVT stage 3 and 4 widths, at
    B16 in clusters of 8 blocks; C = 40, head width 8, and C 96 over 3 heads
    (32 wide, a cluster of 3), heads padded to 64 in the wrapper, with 24
    and 20 keys (the key tile masked past them); PVT stage 3 at 512 px (256
    keys: four key tiles in one pass); 400 keys (PVT stage 1 at 640 px: two
    passes); heads 128 wide (two 64-column chunks a head, two passes over
    200 keys).  The wide route (three launches): C 1024 over 16 heads, 32
    heads of 8, a head 256 wide (four key chunks of 64), a head 2,048 wide
    (chunks of 8 keys) and C 3,584 over 28 heads of 128.  One native launch
    a call (three on the wide route), two launches give the same bits, and
    the plan is the mirror's (ops/encoder_stages.py)."""
    from tramba_tpu_torch.ops import _native
    from tramba_tpu_torch.ops import encoder_stages as es

    gen = torch.Generator().manual_seed(C + N)
    x = _rand(gen, B, N, C, scale=2.0).to(torch.bfloat16)
    ln_w, ln_b, wq, bq, wp, bp = _attn_weights(gen, C, 1)
    k, v = (_rand(gen, B, nh, Lk, C // nh).to(torch.bfloat16) for _ in range(2))
    args = (x, ln_w, ln_b, wq, bq, k, v, wp, bp)
    want = ta.sra_ref(*args, nh)
    n = ta.sra.launches
    card = [t.to(dev) for t in args]
    n0 = _native.native_launch_count()
    got = ta.sra(*card, nh)
    plan = ta.sra_plan(B, N, C, nh, Lk)
    assert plan == es.sra_plan(B, N, C, nh, Lk)
    assert _native.native_launch_count() - n0 == 1 + 2 * plan["wide"]
    assert plan["wide"] == (C > 768 or C // nh > 128 or nh == 32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and ta.sra.launches == n + 1
    assert torch.equal(got, ta.sra(*card, nh))
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


@pytest.mark.parametrize("B,H,W,C,nh,w,masked", [
    (2, 24, 24, 128, 4, 12, True), (1, 24, 24, 512, 16, 12, False), (1, 8, 8, 64, 2, 4, True),
    (2, 8, 8, 40, 5, 4, True), (16, 24, 24, 512, 16, 12, True), (1, 24, 48, 256, 8, 12, True),
    (2, 16, 8, 64, 8, 8, False)])
def test_window_attn_matches_plain(dev, B, H, W, C, nh, w, masked):
    """Swin stage widths with their 12 x 12 windows, shifted (masked) or not,
    at B1, B2 and B16, and on a 24 x 48 map; C = 40 (head width 8) and C 64
    over 8 heads, padded to 16 in the wrapper; windows of 4 and 8; two
    native launches a call (no LayerNorm launch)."""
    from tramba_tpu_torch.models.swin import shift_attn_mask
    from tramba_tpu_torch.ops import _native

    gen = torch.Generator().manual_seed(C + H + W + masked)
    x = _rand(gen, B, H, W, C, scale=2.0).to(torch.bfloat16)
    ln_w, ln_b, wqkv, bqkv, wp, bp = _attn_weights(gen, C, 3)
    bias = _rand(gen, nh, w * w, w * w)
    mask = torch.from_numpy(shift_attn_mask(H, W, w, w // 2)) if masked else None
    args = (x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp)
    want = ta.window_attn_ref(*args, nh)
    n = ta.window_attn.launches
    card = [None if t is None else t.to(dev) for t in args]
    n0 = _native.native_launch_count()
    got = ta.window_attn(*card, nh)
    assert _native.native_launch_count() - n0 == 2
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and ta.window_attn.launches == n + 1
    assert torch.equal(got, ta.window_attn(*card, nh))
    torch.testing.assert_close(got.cpu().float(), want.float(), **TOL_BF16)


def test_encoder_kernels_carry_gradients(dev):
    """K11-K13 under autograd on the card: the outputs keep a grad_fn, and
    every input's gradient (the plain versions' VJP, recomputed on the card)
    matches the CPU's."""
    from tramba_tpu_torch.models.swin import shift_attn_mask

    gen = torch.Generator().manual_seed(23)
    bf = torch.bfloat16
    C, nh = 64, 2
    ln_w, ln_b, wq, bq, wp, bp = _attn_weights(gen, C, 1)
    _, _, wqkv, bqkv, _, _ = _attn_weights(gen, C, 3)
    w1, b1, w2, b2 = (t.float() for t in _mlp_params(gen, C, 128, "cpu"))
    cases = [
        (lambda *a: ta.sra(*a, nh), [_rand(gen, 2, 64, C).to(bf), ln_w, ln_b, wq, bq,
                                      _rand(gen, 2, nh, 16, C // nh).to(bf),
                                      _rand(gen, 2, nh, 16, C // nh).to(bf), wp, bp]),
        (lambda *a: ta.window_attn(*a[:6], torch.from_numpy(shift_attn_mask(8, 8, 4, 2)).to(
            a[0].device), *a[6:], nh), [_rand(gen, 2, 8, 8, C).to(bf), ln_w, ln_b, wqkv, bqkv,
                                        _rand(gen, nh, 16, 16), wp, bp]),
        (tm.ln_dwmlp, [_rand(gen, 2, 8, 8, C).to(bf), ln_w, ln_b, w1, b1,
                       _rand(gen, 128, 1, 3, 3, scale=0.3), _rand(gen, 128, scale=0.1), w2, b2]),
    ]
    for fn, args in cases:
        cpu = [a.clone().requires_grad_(True) for a in args]
        card = [a.to(dev).requires_grad_(True) for a in args]
        out = fn(*card)
        assert out.grad_fn is not None and out.dtype == bf
        g = _rand(gen, *out.shape).to(bf)
        got = torch.autograd.grad(out, card, g.to(dev))
        want = torch.autograd.grad(fn(*cpu), cpu, g)
        for i, (a, b) in enumerate(zip(got, want)):
            _bf16_bwd_close(a, b, f"input {i}")


# ---- K14 linear_scan ------------------------------------------------------------


@pytest.mark.parametrize("R,L,C,reverse", [(3, 300, 130, False), (3, 300, 130, True),
                                           (2, 9, 1, False), (5, 1000, 33, True),
                                           (1, 2, 4096, False), (4, 513, 256, True),
                                           (2, 9216, 64, True), (1, 5000, 7, False)])
def test_linear_scan_matches_plain(dev, R, L, C, reverse):
    """Any L and C: no multiple of 16, 128 or 256 asked for (L over one
    segment of 256 rows and under, C no multiple of the block's 32 channels
    nor of 4); a decay near 1 so a carry lost anywhere shows.  fp32 at TOL
    (the kernel's fmaf and its segments' summaries against the plain
    version's multiply-add).  One native launch a call, two give the same
    bits, and the plan is the mirror's (ops/scan_segments.py)."""
    from tramba_tpu_torch.ops import _native
    from tramba_tpu_torch.ops import scan_segments as sm

    gen = torch.Generator().manual_seed(R * L + C)
    a = torch.exp(-torch.rand(R, L, C, generator=gen) * 0.02)
    b = _rand(gen, R, L, C)
    want = ts.linear_scan_ref(a, b, reverse)
    n = ts.linear_scan.launches
    n0 = _native.native_launch_count()
    got = ts.linear_scan(a.to(dev), b.to(dev), reverse)
    assert _native.native_launch_count() - n0 == 1
    assert ts.linear_scan_plan(R, L, C) == sm.linear_scan_plan(R, L, C)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and ts.linear_scan.launches == n + 1
    assert torch.equal(got, ts.linear_scan(a.to(dev), b.to(dev), reverse))
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_linear_scan_gradient_is_k14_reversed(dev):
    """Under autograd on the card the backward is K14 reversed (one launch
    each way), its gradients those of the plain loop's autograd; a bf16 b
    is scanned in fp32 and gets a bf16 gradient."""
    gen = torch.Generator().manual_seed(5)
    a = torch.exp(-torch.rand(2, 3, 200, 40, generator=gen) * 0.05)
    b = _rand(gen, 2, 3, 200, 40).to(torch.bfloat16)
    g = _rand(gen, 2, 3, 200, 40)
    cpu = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    card = [t.to(dev).requires_grad_(True) for t in (a, b)]
    n = ts.linear_scan.launches
    h = ts.linear_scan(*card)
    got = torch.autograd.grad(h, card, g.to(dev))
    torch.cuda.synchronize()
    assert ts.linear_scan.launches == n + 2 and h.dtype == torch.float32
    want = torch.autograd.grad(ts.linear_scan(*cpu), cpu, g)
    assert got[1].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].cpu(), want[0], **TOL)
    torch.testing.assert_close(got[1].cpu().float(), want[1].float(), **TOL_BF16)


# K1's projection launch (ss2d_proj): N = K (R + 2) of the main path's SS2Ds
# (24 Tramba-P 96 px, 40 / 48 96 px, 72 / 80 48 px, 88 / 176 Tramba-P 24 px,
# 136 / 144 24 px, 264 12 px, 272 the 24 px line), each as (K, R), at a D of
# the main path and a ragged M (no multiple of a row tile)
PROJ_SHAPES = [(24, 4, 4, 128), (40, 4, 8, 256), (48, 8, 4, 128), (72, 4, 16, 512),
               (80, 8, 8, 256), (88, 4, 20, 640), (136, 4, 32, 1024), (144, 8, 16, 512),
               (176, 8, 20, 640), (264, 4, 64, 2048), (272, 8, 32, 1024)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N,K,R,D", PROJ_SHAPES)
def test_proj_matches_fp64_product(dev, dt, N, K, R, D):
    """Within 1e-6 x max |dbc| of an fp64 product; two launches give the same
    bits; one native launch at the mirror's plan (the weight's terms split
    before); K1's train variant's dbc is that launch's, and K1 adds one
    native launch to its scans."""
    from tramba_tpu_torch.ops import _native
    from tramba_tpu_torch.ops import proj_stages as ps

    gen = torch.Generator().manual_seed(N + D)
    B, L = 3, 277
    x = torch.nn.functional.silu(_rand(gen, B, L, D)).to(dt)
    wx = _rand(gen, K, R + 2, D, scale=D ** -0.5)
    assert K * (R + 2) == N
    xd, wd = x.to(dev), wx.to(dev)
    tf.proj_weight_terms(wd)  # the weight's terms, split once for the calls below
    n = tf.ss2d_proj.launches
    n0 = _native.native_launch_count()
    got = tf.ss2d_proj(xd, wd)
    assert _native.native_launch_count() - n0 == 1 and tf.ss2d_proj.launches == n + 1
    assert tf.ss2d_proj_plan(B * L, D, N, dt) == ps.proj_plan(B * L, D, N, dt)
    assert torch.equal(got, tf.ss2d_proj(xd, wd))
    ref = torch.einsum("bld,kcd->blkc", x.double(), wx.double())
    err = (got.cpu().double() - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item(), err / ref.abs().max().item()
    p = _ss2d_params(gen, K, D, R, 16)
    core = [wd] + [p[k].to(dev) for k in ("wdt", "bias", "A_logs", "Ds")]
    idx, _ = order_tables("raster", 1, L, 0, dev)
    idx = idx[:1].expand(K, L).contiguous()
    n0 = _native.native_launch_count()
    ys, carries, dbc = tf.ss2d_scan(xd, idx, *core, emit=True)
    steps = tf.scan_segment_steps(B, L, D, K)
    assert _native.native_launch_count() - n0 == 1 + (1 if steps < L else 0) + 1
    assert torch.equal(dbc, got)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_proj_takes_odd_widths(dev, dt):
    """D not a multiple of 64 (a zero-filled last slab; fp32 D % 8 == 4), N
    odd, one row: the plain product."""
    gen = torch.Generator().manual_seed(3)
    for B, L, D, K, C in ((1, 1, 8 if dt == torch.bfloat16 else 4, 1, 3), (2, 65, 200, 3, 7),
                          (1, 130, 36 if dt == torch.float32 else 40, 5, 41)):
        x, wx = _rand(gen, B, L, D).to(dt), _rand(gen, K, C, D)
        got = tf.ss2d_proj(x.to(dev), wx.to(dev)).cpu().double()
        ref = torch.einsum("bld,kcd->blkc", x.double(), wx.double())
        assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def test_proj_weight_terms_follow_the_weight(dev):
    """The weight's split terms are made by one launch for a new weight and
    again after an in-place update (its version counter moves), and kept
    otherwise: each call's dbc is the fp64 product of the weight it saw."""
    from tramba_tpu_torch.ops import _native

    gen = torch.Generator().manual_seed(11)
    x = _rand(gen, 2, 100, 64).to(dev)
    w = _rand(gen, 4, 6, 64, scale=0.2).to(dev)

    def launches_and_error():
        n0 = _native.native_launch_count()
        got = tf.ss2d_proj(x, w)
        n = _native.native_launch_count() - n0
        ref = torch.einsum("bld,kcd->blkc", x.double(), w.double())
        return n, ((got.double() - ref).abs().max() / ref.abs().max()).item()

    assert launches_and_error()[0] == 2  # a new weight: its terms, then the projection
    assert launches_and_error()[0] == 1
    with torch.no_grad():
        w.mul_(-3.0)
    n, err = launches_and_error()
    assert n == 2 and err <= 1e-6
    assert launches_and_error() == (1, err)
