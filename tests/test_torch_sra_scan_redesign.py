"""The redesigned K12 ``sra`` and K14 ``linear_scan``, through the plain
mirrors of how they tile their work (``ops/encoder_stages.py``:
``sra_plan``, ``sra_tiled_ref``; ``ops/scan_segments.py``:
``linear_scan_plan``, ``linear_scan_segmented``), and the entry points'
default device.

The mirrors are held to the plain versions (``fused_attn.sra_ref``,
``selective_scan.linear_scan_ref``) and to the JAX package's Pallas kernels
(``_sra_pallas``, ``_linear_scan_pallas``) in interpret mode, on the same
numpy-seeded inputs.  Tolerances: K12 in bf16 at rtol/atol 1e-2 (the same
rounding points; another summation order, and on the two-pass route the
rescaled row sums, can flip a bf16 rounding); K14 in fp32 at rtol 1e-5,
atol 1e-5 (the same recurrence composed through segment summaries: a few
fp32 roundings apart).  Each planted fault must fail that check on every
shape it bears on, over several seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import selective_scan as js
from tramba_tpu.ops.fused_attn import _sra_pallas
from tramba_tpu_torch.models.pvt import pvt_v2_b4_config
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.ops import encoder_stages as es
from tramba_tpu_torch.ops import fused_attn as ta
from tramba_tpu_torch.ops import scan_segments as sm
from tramba_tpu_torch.ops import selective_scan as ts

TOL = dict(rtol=1e-2, atol=1e-2)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fails(got, want, tol):
    return bool((~torch.isclose(got.float(), want.float(), **tol)).any())


# ---- K12 -------------------------------------------------------------------


def _sra_case(B, N, C, nh, Lk, seed):
    """flax-layout arrays (x, ln_s, ln_b, wq (in, out), bq, k, v, wp, bp),
    weights at fan-in scale so that the scores are O(1)."""
    rng = np.random.default_rng(seed)
    hd = C // nh
    f = np.float32

    def n(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(f)

    return [n(B, N, C, scale=2.0), n(C, scale=0.1) + 1, n(C, scale=0.1), n(C, C, scale=C ** -0.5),
            n(C, scale=0.1), n(B, nh, Lk, hd), n(B, nh, Lk, hd), n(C, C, scale=C ** -0.5),
            n(C, scale=0.1)]


def _sra_torch(a):
    x, s, b, wq, bq, k, v, wp, bp = a
    return [_t(x).to(BF), _t(s), _t(b), _t(wq.T), _t(bq), _t(k).to(BF), _t(v).to(BF), _t(wp.T),
            _t(bp)]


# (B, N, C, nh, Lk): nh 1 / 2 / 5; head width 8 (padded to 64); 144, 256
# and 400 keys over a small C (400: the two-pass route); clusters of 2 and
# 5 blocks splitting the heads; ragged row tiles (N 200 over 128 rows); the
# wide route: 32 heads of 8 (padded, they would overflow the block), a head
# 256 wide over 80 keys (two passes over chunks of 64), C 832 over 4 heads
SRA_CASES = [(2, 200, 32, 1, 144), (1, 96, 64, 2, 256), (1, 64, 40, 5, 144),
             (1, 128, 80, 5, 400), (2, 72, 128, 2, 144), (1, 64, 320, 5, 24),
             (1, 40, 256, 32, 24), (2, 24, 256, 1, 80), (1, 16, 832, 4, 16)]


@pytest.mark.parametrize("B,N,C,nh,Lk", SRA_CASES)
def test_sra_mirror_matches_pallas_and_plain(B, N, C, nh, Lk):
    a = _sra_case(B, N, C, nh, Lk, seed=N + C + Lk)
    ja = [jnp.asarray(t) for t in a]
    for i in (0, 5, 6):
        ja[i] = ja[i].astype(jnp.bfloat16)
    pallas = _sra_pallas(*ja, nh=nh, eps=1e-6, interpret=True)
    args = _sra_torch(a)
    plan = es.sra_plan(B, N, C, nh, Lk)
    got = es.sra_tiled_ref(*args, nh, plan=plan)
    assert got.dtype == BF and tuple(got.shape) == (B, N, C)
    torch.testing.assert_close(got.float(), _t(np.asarray(pallas, np.float32)), **TOL)
    torch.testing.assert_close(got.float(), ta.sra_ref(*args, nh).float(), **TOL)


def test_sra_cases_cover_the_routes():
    """The cases above reach a cluster (of 2 and of 5), the two-pass route,
    a padded head, a ragged last row tile and the wide route (with two key
    passes on it too)."""
    plans = {c: es.sra_plan(c[0], c[1], c[2], c[3], c[4]) for c in SRA_CASES}
    assert {p["cluster"] for p in plans.values()} >= {1, 2, 5}
    assert any(p["chunks"] > 1 and not p["wide"] for p in plans.values())
    assert sum(p["wide"] for p in plans.values()) == 3
    assert any(p["chunks"] > 1 and p["wide"] for p in plans.values())
    assert any(c[2] // c[3] % 64 for c in SRA_CASES)
    assert any(c[1] % p["rows"] for c, p in plans.items())


@pytest.mark.parametrize("fault", es.SRA_FAULTS)
def test_sra_faults_fail_where_they_bear(fault):
    bears = 0
    for B, N, C, nh, Lk in SRA_CASES:
        plan = es.sra_plan(B, N, C, nh, Lk)
        if fault not in es.sra_faults(plan, N, nh, Lk):
            continue
        for seed in range(3):
            args = _sra_torch(_sra_case(B, N, C, nh, Lk, seed=seed))
            want = ta.sra_ref(*args, nh)
            assert _fails(es.sra_tiled_ref(*args, nh, plan=plan, fault=fault), want, TOL), (
                fault, (B, N, C, nh, Lk), seed)
            bears += 1
    assert bears >= 3


def test_sra_operands_pad_heads_to_64():
    """The wrapper's operands: each head zero-padded to a multiple of 64
    (q k^T and p v are unchanged by zero columns), the keys left as they
    are, the output projection (C, Cq)."""
    C, nh, Lk = 40, 5, 24
    x = torch.zeros(1, 16, C)
    k = torch.randn(1, nh, Lk, C // nh)
    (wq, bq, k2, v2, wp, bp), Cq = ta._sra_operands(
        x, torch.randn(C, C), torch.randn(C), k, k.clone(), torch.randn(C, C), torch.randn(C), nh)
    assert Cq == nh * 64 and tuple(wq.shape) == (Cq, C) and tuple(wp.shape) == (C, Cq)
    assert tuple(k2.shape) == (1, nh, Lk, 64) and bq.numel() == Cq and bp.numel() == C
    torch.testing.assert_close(k2[..., :C // nh], k)
    assert not k2[..., C // nh:].any() and not wq.reshape(nh, 64, C)[:, C // nh:].any()


def _pvt_sra_shapes(img):
    """(N, C, nh, Lk) of each PVTv2-b4 stage at ``img`` px: 7x7 stride-4 patch
    embed, then 3x3 stride-2, the reduction conv's stride sr."""
    cfg = pvt_v2_b4_config()
    res, out = (img + 2 * 3 - 7) // 4 + 1, []
    for i, (C, nh, sr) in enumerate(zip(cfg["embed_dims"], cfg["num_heads"], cfg["sr_ratios"])):
        if i:
            res = (res + 2 - 3) // 2 + 1
        out.append((res * res, C, nh, (res // sr) ** 2))
    return out


def test_every_pvt_b4_shape_the_parent_took_has_a_plan():
    """Every PVTv2-b4 stage at 224-640 px that the JAX gate admits (bf16; N,
    Lk and the head width multiples of 8: the shapes the parent's K12 took)
    is admitted by ``sra_fusable`` and planned at B1, B2 and B16, within one
    block's 227 KB: every stage at 256, 384, 512 and 640 px (64, 144, 256
    and 400 keys; 400 takes the two-pass route), and none of the other
    sizes, whose maps give key counts no multiple of 8."""
    admitted, keys = 0, set()
    for img in range(224, 641, 32):
        for N, C, nh, Lk in _pvt_sra_shapes(img):
            if not (N % 8 == 0 and (C // nh) % 8 == 0 and Lk % 8 == 0):
                assert not ta.sra_fusable(N, C, nh, Lk, BF)
                continue
            assert ta.sra_fusable(N, C, nh, Lk, BF), (img, N, C, nh, Lk)
            admitted += 1
            keys.add(Lk)
            for B in (1, 2, 16):
                p = es.sra_plan(B, N, C, nh, Lk)
                assert p["smem"] <= es.SMEM_BLOCK and p["stages"] >= p["kt"] * p["nq"] + 1, p
                assert nh % p["cluster"] == 0 and p["blocks"] == B * p["tiles"] * p["cluster"]
    assert admitted == 16 and keys == {64, 144, 256, 400}


def test_sra_plans_at_the_384px_stages():
    """The plans phase 3 holds the library to: 128 rows a block at C 64 and
    128, 64 above; the heads split over clusters where the row tiles fill
    under a wave; one pass over 144 keys (three tiles of 64)."""
    want = {(96, 2): (128, 1), (96, 16): (128, 1), (48, 2): (128, 2), (48, 16): (128, 2),
            (24, 2): (64, 5), (24, 16): (64, 5), (12, 2): (64, 8), (12, 16): (64, 8)}
    for (H, B), (rows, cluster) in want.items():
        C, nh = {96: (64, 1), 48: (128, 2), 24: (320, 5), 12: (512, 8)}[H]
        p = es.sra_plan(B, H * H, C, nh, 144)
        assert (p["rows"], p["cluster"], p["kt"], p["chunks"], p["nq"]) == (rows, cluster, 3, 1,
                                                                             1), p


def test_sra_gate_refuses_what_the_kernel_cannot_take():
    """Wider than 768 channels, heads wider than 128, or padded heads that
    would overflow the one-launch block take the wide route; refused before
    any launch only where no route takes the shape: heads wider than the
    wide route's block holds (2,064 columns), or not bf16."""
    assert ta.sra_fusable(64, 512, 8, 144, BF)
    assert not es.sra_plan(2, 64, 512, 8, 144)["wide"]
    for C, nh in ((1024, 16), (256, 1), (512, 32), (2064, 1)):
        assert ta.sra_fusable(64, C, nh, 144, BF)
        assert es.sra_plan(2, 64, C, nh, 144)["wide"] == 1
    assert not ta.sra_fusable(64, 2072, 1, 144, BF)
    with pytest.raises(ValueError):
        es.sra_plan(2, 64, 2072, 1, 144)
    assert not ta.sra_fusable(64, 64, 1, 144, torch.float32)


def _earlier_k12_takes(C, nh, Lk):
    """Whether the earlier three-launch K12 (a LayerNorm launch,
    ``proj_in_kernel``, ``attn_kernel``) ran a shape its gate admitted: at
    16 query rows a block its attention launch's shared tiles (the merged
    heads, then either one head's q, k, v, scores, p and output, or the fp32
    output rows; each 128-byte aligned, heads and keys padded to 16) and
    its q projection's 16 rows within 227 KB."""
    def al(n):
        return -(-n // 128) * 128

    hd, Lk16 = -(-(C // nh) // 16) * 16, -(-Lk // 16) * 16
    Cq, QM = nh * hd, 16
    heads = (al(QM * (Cq + 8) * 2) + al(QM * (hd + 8) * 2) + 2 * al(Lk16 * (hd + 8) * 2)
             + al(QM * (Lk16 + 4) * 4) + al(QM * (Lk16 + 8) * 2) + al(QM * (hd + 4) * 4))
    nc = next(n for n in (128, 64, 32, 16) if Cq % n == 0)
    return (max(heads, al(QM * (Cq + 4) * 4)) <= es.SMEM_BLOCK
            and QM * ((-(-C // 16) * 16 + 8) * 2 + (nc + 4) * 4) <= es.SMEM_BLOCK)


def test_every_shape_the_earlier_kernel_took_is_admitted():
    """Every shape the gate admits (head widths multiples of 8) that the
    earlier three-launch K12 ran, over head widths 8-1,440, 1-256 heads up
    to C 3,616 and 8-576 keys, is admitted by ``sra_fusable`` and planned at
    B1 and B16 within one block's shared memory."""
    taken = wide = 0
    for hd in (8, 16, 24, 32, 48, 64, 72, 96, 128, 136, 192, 256, 320, 512, 1024, 1440):
        for nh in range(1, 257):
            C = hd * nh
            if C > 3616:
                break
            for Lk in (8, 64, 144, 256, 400, 576):
                if not _earlier_k12_takes(C, nh, Lk):
                    continue
                taken += 1
                assert ta.sra_fusable(64, C, nh, Lk, BF), (C, nh, Lk)
                for B in (1, 16):
                    p = es.sra_plan(B, 64, C, nh, Lk)
                    assert p["smem"] <= es.SMEM_BLOCK, (C, nh, Lk, p)
                wide += p["wide"]
    assert taken > 2000 and 0 < wide < taken


# ---- K14 -------------------------------------------------------------------


def _ab(shape, seed):
    """a in (0.9, 1): carries that last hundreds of rows; b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.0, 0.1, shape)).astype(np.float32)
    return a, rng.normal(size=shape).astype(np.float32)


def _pallas_scan(a, b, reverse):
    fn = lambda x, y: js._linear_scan_pallas(x, y, interpret=True)  # noqa: E731
    if reverse:
        return jnp.flip(fn(jnp.flip(a, -2), jnp.flip(b, -2)), -2)
    return fn(a, b)


# (R, L, C, seg): L no multiple of the segment (600 = 2 x 256 + 88); L
# shorter than one segment; a small segment so that many segments chain
SCAN_CASES = [(2, 600, 40, None), (3, 100, 7, None), (2, 77, 33, 16)]


def test_scan_column_route_is_the_sequential_scan():
    """The column route (one segment of L rows, one walker) is the plain
    recurrence, and no segment fault bears on it."""
    a, b = (_t(t) for t in _ab((2, 300, 5), seed=4))
    for reverse in (False, True):
        got = sm.linear_scan_segmented(a, b, reverse, 300, 1)
        np.testing.assert_allclose(got.numpy(), ts.linear_scan_ref(a, b, reverse).numpy(),
                                   **SCAN_TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R,L,C,seg", SCAN_CASES)
def test_scan_mirror_matches_pallas_and_plain(R, L, C, seg, reverse):
    a, b = _ab((R, L, C), seed=L + C + reverse)
    got = sm.linear_scan_segmented(_t(a), _t(b), reverse, seg)
    np.testing.assert_allclose(got.numpy(), ts.linear_scan_ref(_t(a), _t(b), reverse).numpy(),
                               **SCAN_TOL)
    want = _pallas_scan(jnp.asarray(a), jnp.asarray(b), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("fault", sm.LINEAR_SCAN_FAULTS)
def test_scan_faults_fail_where_they_bear(fault):
    bears = 0
    for R, L, C, seg in SCAN_CASES:
        if fault not in sm.linear_scan_faults(L, seg):
            continue
        for seed in range(3):
            for reverse in (False, True):
                a, b = (_t(t) for t in _ab((R, L, C), seed))
                want = ts.linear_scan_ref(a, b, reverse)
                got = sm.linear_scan_segmented(a, b, reverse, seg, fault=fault)
                assert _fails(got, want, SCAN_TOL), (fault, (R, L, C, seg), seed, reverse)
                bears += 1
    assert bears >= 6


def test_scan_plans():
    """One segment up to 256 rows, then segments of 256; 32 channels a block;
    the 96 px tensor-parallel shape makes 4,608 blocks."""
    assert sm.linear_scan_plan(16, 9216, 256) == dict(route=0, seg=256, segments=36, channels=32,
                                                      parts=8, blocks=4608, smem=65536)
    assert sm.linear_scan_plan(3, 100, 7) == dict(route=0, seg=100, segments=1, channels=32,
                                                  parts=8, blocks=3, smem=25600)
    assert sm.linear_scan_plan(2, 1000, 203)["segments"] == 4
    # from 16,384 columns one thread a column walks all L rows
    assert sm.linear_scan_plan(16, 576, 1024) == dict(route=1, seg=576, segments=1, channels=128,
                                                      parts=1, blocks=128, smem=0)
    assert sm.linear_scan_faults(100) == ("prod a over the whole segment",)
    assert sm.linear_scan_faults(600) == sm.LINEAR_SCAN_FAULTS
    assert sm.linear_scan_faults(576, 576, 1) == ()
    with pytest.raises(ValueError):
        sm.linear_scan_plan(1, 0, 4)


# ---- entry points default to the card ----------------------------------------


def test_build_without_a_device_asks_for_the_card():
    """``build`` without ``device`` puts the model on the card: on a machine
    with no card it raises instead of returning a CPU model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the model would build there")
    with pytest.raises((RuntimeError, AssertionError)):
        build("Tramba-V-TSOD", 64, dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
    model = build("Tramba-V-TSOD", 64, device="cpu", dims=16, enc_depths=(1, 1, 1, 1),
                  dec_depths=(1, 1, 1, 1))
    assert next(model.parameters()).device.type == "cpu"


def test_spawn_defaults_to_the_card():
    import inspect

    from tramba_tpu_torch.parallel.distributed import spawn

    assert inspect.signature(spawn).parameters["device"].default == "cuda"
