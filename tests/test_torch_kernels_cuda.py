"""Kernels K1-K4 vs their plain versions on the card, at small ragged shapes.

CUDA kernels have no CPU mode, so every test here is marked ``cuda``, needs a
CUDA device and skips without one.  Run on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest sets JAX up, which these tests do not
use).  Tolerance rtol 1e-4, atol 1e-4: the kernels sum in another order than
the plain versions and use CUDA's expf/log1pf/erff.
"""

import pytest
import torch

from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = dict(rtol=1e-4, atol=1e-4)

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
    with pytest.raises(TypeError, match="float32"):
        te.expand_ln(x, torch.zeros(16, 8, device=dev, dtype=torch.float64),
                     torch.ones(4, device=dev), torch.zeros(4, device=dev))
