"""Kernels K1-K7 vs their plain versions on the card, at small ragged shapes.

CUDA kernels have no CPU mode, so every test here is marked ``cuda``, needs a
CUDA device and skips without one.  Run on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest sets JAX up, which these tests do not
use).  Tolerance for fp32 outputs rtol 1e-4, atol 1e-4: the kernels sum in
another order than the plain versions and use CUDA's expf/log1pf/erff.  For
bf16 outputs rtol 1.6e-2 (torch's bf16 default) and atol 1e-2: the same
rounding points, but another summation order may flip a rounding.
"""

import pytest
import torch

from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
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
    ("dilation", 4, 8, 4, 32, 1)])
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
    ("raster", 4, 9, 0, 64, 5), ("line", 8, 10, 0, 64, 3), ("window", 4, 12, 4, 96, 2)])
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
