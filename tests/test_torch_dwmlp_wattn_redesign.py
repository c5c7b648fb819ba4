"""The redesigned K11 ``ln_dwmlp`` and K13 ``window_attn``, through the plain
mirror of how they split their work (``tramba_tpu_torch/ops/encoder_stages.py``).

The mirrors are held to the plain versions (``fused_mlp.ln_dwmlp_ref``,
``fused_attn.window_attn_ref``) and to the JAX package's Pallas kernels
(``_dwmlp_pallas``, ``_wattn_pallas``) in interpret mode and its composed
oracles (``composed_ln_dwmlp``, ``composed_window_attn``), on the same
numpy-seeded inputs: in bf16 against the plain versions and the Pallas kernels
at bf16's tolerance (rtol/atol 1e-2: the same rounding points, another
summation order can flip a bf16 rounding), in fp32 (where the mirrors round
nowhere) against the composed oracles too, at rtol/atol 1e-4 (the same
function in other summation orders; the composed oracles round elsewhere in
bf16).  Each planted fault must fail the bf16 check.  The plans are held to one block's 227 KB (113 KB
where a plan puts two blocks on an SM) at every Tramba-P and Tramba-S shape
at B1, B2 and B16.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.models.swin import _shift_attn_mask
from tramba_tpu.ops.fused_attn import _wattn_pallas, composed_window_attn
from tramba_tpu.ops.fused_mlp import _dwmlp_pallas, composed_ln_dwmlp
from tramba_tpu_torch.models.pvt import pvt_v2_b4_config
from tramba_tpu_torch.models.swin import swin_b_384_config
from tramba_tpu_torch.ops import encoder_stages as es
from tramba_tpu_torch.ops import fused_attn as ta
from tramba_tpu_torch.ops import fused_mlp as tm

TOL = dict(rtol=1e-2, atol=1e-2)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
BF = torch.bfloat16


def _arrays(seed, *shapes, scale=0.2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    want = want if torch.is_tensor(want) else torch.from_numpy(np.array(want, np.float32))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _fails(got, want):
    return bool((~torch.isclose(got.float(), want.float(), **TOL)).any())


# ---- K11 -------------------------------------------------------------------


def _dwmlp_case(B=2, H=16, W=16, d=16, hid=128, seed=31):
    """flax-layout arrays (x, ln_s, ln_b, w1 (in, out), b1, k3 (3, 3, 1, hid),
    c3, w2, b2) and the same as the port's bf16 arguments."""
    x, s, b, w1, b1, k3, c3, w2, b2 = _arrays(
        seed, (B, H, W, d), (d,), (d,), (d, hid), (hid,), (3, 3, 1, hid), (hid,), (hid, d), (d,))
    a = [x * 5, s + 1.0, b, w1, b1, k3 * 2, c3, w2, b2]
    t = [_t(a[0]).to(BF), _t(a[1]), _t(a[2]), _t(a[3].T), _t(a[4]),
         _t(a[5].transpose(3, 2, 0, 1)), _t(a[6]), _t(a[7].T), _t(a[8])]
    return a, t


@pytest.mark.parametrize("splits", [1, 2])
def test_dwmlp_mirror_matches_plain_and_pallas(splits):
    """16 x 16 map, d 16, hid 128: the tiled mirror against the plain
    version and ``_dwmlp_pallas`` in interpret mode (bf16), and against
    ``composed_ln_dwmlp`` (fp32)."""
    a, t = _dwmlp_case()
    got = es.dwmlp_tiled_ref(*t, splits=splits)
    _close(got, tm.ln_dwmlp_ref(*t))
    ja = [jnp.asarray(v) for v in a]
    _close(es.dwmlp_tiled_ref(_t(a[0]), *t[1:], splits=splits),
           composed_ln_dwmlp(*ja, 1e-6), TOL_F32)
    ja[0] = ja[0].astype(jnp.bfloat16)
    _close(got, _dwmlp_pallas(*ja, eps=1e-6, interpret=True))


@pytest.mark.parametrize("B,H,W,d,hid,splits", [(1, 11, 13, 48, 192, 3), (2, 24, 24, 32, 256, 4)])
def test_dwmlp_mirror_on_ragged_and_split_maps(B, H, W, d, hid, splits):
    """Tiles past the image's edge (11 x 13) and a 24 px map of 3 x 3 tiles,
    the hidden chunks split over blocks."""
    _, t = _dwmlp_case(B, H, W, d, hid, seed=B + H + d)
    _close(es.dwmlp_tiled_ref(*t, splits=splits), tm.ln_dwmlp_ref(*t))


@pytest.mark.parametrize("fault", es.DWMLP_FAULTS)
def test_dwmlp_faults_fail(fault):
    _, t = _dwmlp_case(1, 12, 12, 32, 192, seed=5)
    assert _fails(es.dwmlp_tiled_ref(*t, splits=3, fault=fault), tm.ln_dwmlp_ref(*t))


# ---- K13 -------------------------------------------------------------------


def _wattn_case(masked, B=2, H=16, C=32, nh=2, w=4, seed=41):
    N = w * w
    x, s, b, wqkv, bqkv, bias, wp, bp = _arrays(
        seed, (B, H, H, C), (C,), (C,), (C, 3 * C), (3 * C,), (nh, N, N), (C, C), (C,))
    mask = _shift_attn_mask(H, H, w, w // 2) if masked else None
    a = [x * 5, s + 1.0, b, wqkv * 2, bqkv, bias * 5, mask, wp, bp]
    t = [_t(a[0]).to(BF), _t(a[1]), _t(a[2]), _t(a[3].T), _t(a[4]), _t(a[5]),
         None if mask is None else _t(mask), _t(a[7].T), _t(a[8])]
    return a, t


@pytest.mark.parametrize("masked", [False, True])
def test_window_mirror_matches_plain_and_pallas(masked):
    """Windows of 4, C 32, 2 heads, shifted (masked) or not: the split mirror
    against the plain version and ``_wattn_pallas`` in interpret mode
    (bf16), and against ``composed_window_attn`` (fp32)."""
    a, t = _wattn_case(masked)
    got = es.window_tiled_ref(*t, 2)
    _close(got, ta.window_attn_ref(*t, 2))
    ja = [None if v is None else jnp.asarray(v) for v in a]
    _close(es.window_tiled_ref(_t(a[0]), *t[1:], 2), composed_window_attn(*ja, 2, 1e-5),
           TOL_F32)
    ja[0] = ja[0].astype(jnp.bfloat16)
    _close(got, _wattn_pallas(*ja, nh=2, w=4, eps=1e-5, interpret=True))


@pytest.mark.parametrize("masked,C,nh", [(True, 32, 2), (False, 40, 5)])
def test_window_mirror_on_whole_swin_windows(masked, C, nh):
    """12 x 12 windows (three groups of 48 query rows a window); C 40 with
    head width 8, padded to 16."""
    _, t = _wattn_case(masked, B=1, H=24, C=C, nh=nh, w=12, seed=C)
    _close(es.window_tiled_ref(*t, nh), ta.window_attn_ref(*t, nh))


@pytest.mark.parametrize("fault", es.WINDOW_FAULTS)
def test_window_faults_fail(fault):
    _, t = _wattn_case(True, B=1, H=24, C=32, nh=2, w=12, seed=7)
    assert fault in es.window_faults(144, 4, True)
    assert _fails(es.window_tiled_ref(*t, 2, fault=fault), ta.window_attn_ref(*t, 2))


# ---- the plans at every Tramba-P / Tramba-S shape ----------------------------


def _pvt_shapes():
    cfg = pvt_v2_b4_config()
    out = []
    for i, (d, r) in enumerate(zip(cfg["embed_dims"], cfg["mlp_ratios"])):
        H = 384 // (4 << i)
        if tm.dwmlp_fusable(H, H, d, d * r, BF):
            out.append((H, d, d * r))
    return out


def _swin_shapes():
    cfg = swin_b_384_config()
    out = []
    for i, nh in enumerate(cfg["num_heads"]):
        H, C = 96 >> i, cfg["embed_dim"] << i
        w = min(cfg["window"], H)
        if ta.window_attn_fusable(H, H, C, nh, w, BF):
            out.append((H, C, nh, w))
    return out


def test_model_shapes_are_the_phase_3_shapes():
    assert _pvt_shapes() == [(96, 64, 512), (48, 128, 1024), (24, 320, 1280)]
    assert [s[:3] for s in _swin_shapes()][:3] == [(96, 128, 4), (48, 256, 8), (24, 512, 16)]


@pytest.mark.parametrize("B", [1, 2, 16])
def test_plans_fit_one_block(B):
    for H, d, hid in _pvt_shapes():
        tm.check_ln_dwmlp_shape(B, H, H, d, hid)
        p = es.dwmlp_plan(B, H, H, d, hid)
        assert p["smem"] <= (es.HALF_SM if p["per_sm"] == 2 else es.SMEM_BLOCK), (H, p)
        assert 1 <= p["splits"] <= p["nchunks"] and p["stages"] >= 2 * -(-d // 64)
    for H, C, nh, w in _swin_shapes():
        ta.check_window_attn_shape(B, H, H, C, nh, w)
        p = es.window_plan(B, H, H, C, nh, w)
        assert p["front_smem"] <= es.SMEM_BLOCK and p["smem"] <= es.SMEM_BLOCK, (H, p)
        assert p["blocks"] == p["row_groups"] * B * (H // w) ** 2


def test_plans_take_the_shapes_the_wrappers_admit():
    """The mirrors' plans exist exactly where the wrappers' shape checks
    pass: K11 for d from 16 to 512 (the wide route above 384), K13 for heads
    up to 64 wide, windows of up to 144 tokens and C up to 512."""
    for d in range(16, 641, 16):
        ok = 16 <= d <= 512
        with contextlib.nullcontext() if ok else pytest.raises(ValueError):
            tm.check_ln_dwmlp_shape(2, 24, 24, d, 4 * d)
        with contextlib.nullcontext() if ok else pytest.raises(ValueError):
            assert es.dwmlp_plan(2, 24, 24, d, 4 * d)["wide"] == (d > 384)
    for C, nh, w in ((64, 1, 12), (80, 1, 12), (96, 2, 8), (40, 5, 4), (128, 4, 16),
                     (1024, 32, 12), (512, 8, 12)):
        try:
            ta.check_window_attn_shape(2, 48, 48, C, nh, w)
        except ValueError:
            with pytest.raises(ValueError):
                es.window_plan(2, 48, 48, C, nh, w)
        else:
            assert es.window_plan(2, 48, 48, C, nh, w)["smem"] <= es.SMEM_BLOCK



def test_every_fusable_k11_shape_has_a_plan():
    """Every shape ``dwmlp_fusable`` routes to K11 passes the wrapper's shape
    check and has a plan within one block, at B1, B2 and B16: the PVTv2-b4
    stages at 224-640 px (stage 4 at 512 px is 16 px, d 512, hid 2048) and a
    grid of maps and widths around them."""
    cfg = pvt_v2_b4_config()
    shapes = {(img // (4 << i), img // (4 << i), d, d * r)
              for img in range(224, 641, 32)
              for i, (d, r) in enumerate(zip(cfg["embed_dims"], cfg["mlp_ratios"]))}
    shapes |= {(H, W, d, hid) for H in (2, 6, 12, 16, 24, 48, 96) for W in (8, 16, 24, 40, 96)
               for d in range(8, 1025, 8) for hid in (128, 384, 1280, 2048, 4096)}
    assert (16, 16, 512, 2048) in shapes
    admitted = 0
    for H, W, d, hid in sorted(shapes):
        if not tm.dwmlp_fusable(H, W, d, hid, BF):
            continue
        admitted += 1
        for B in (1, 2, 16):
            tm.check_ln_dwmlp_shape(B, H, W, d, hid)
            p = es.dwmlp_plan(B, H, W, d, hid)
            assert p["smem"] <= (es.HALF_SM if p["per_sm"] == 2 else es.SMEM_BLOCK), p
            assert 1 <= p["splits"] <= p["nchunks"] and p["wide"] == (d > 384)
    assert admitted > 1000


@pytest.mark.parametrize("B,splits", [(1, 8), (2, 8), (16, 2)])
def test_wide_route_plan(B, splits):
    """Tramba-P's stage 4 at 512 px (16 px, d 512, hid 2048): K7's tile
    kernel, four output tiles a warpgroup, five ring slots, one block an SM;
    its hidden chunks split only below one wave of 132 blocks (K7's rule)."""
    p = es.dwmlp_plan(B, 16, 16, 512, 2048)
    assert (p["wide"], p["NT"], p["stages"], p["per_sm"], p["tiles"]) == (1, 4, 5, 1, 4)
    assert p["smem"] <= es.SMEM_BLOCK and p["splits"] == splits
    assert es.wave_splits(4 * B, 132, 32) == splits


def test_split_rules():
    """K6's and K11's cost rule splits a sub-wave grid and leaves a full one
    whole; K7's wave rule never splits a grid of a wave or more."""
    assert es.cheapest_splits(18, 132, 20, 1e-4, 1152, 320) > 1
    assert es.cheapest_splits(1320, 132, 20, 1e-4, 9216 * 10, 320) == 1
    assert es.wave_splits(132, 132, 32) == 1 and es.wave_splits(200, 132, 32) == 1
    assert es.wave_splits(18, 132, 20) > 1
