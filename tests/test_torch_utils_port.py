"""The port's remaining library modules vs the JAX package: the FLOP count,
the scoring of dumped maps, the frequency features, the debug guards, the
trace, and the SOD dump.

On the CPU at tiny sizes, seeded with numpy.  ``analytic_model_flops`` equals
JAX's count on its own op cases (``tests/test_profiling.py``) and on a
raster-only VSSM encoder; on BaseUMamba and Tramba-V it differs by exactly
the one-hot selector products with which JAX spells the line orders'
gathers (``tramba_tpu/ops/scan_orders.py:447-530``), which the port does
as gathers.  Scores equal JAX's to 1e-12, rows as strings, PR curves byte
for byte; frequency features and statistics to 1e-5.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tramba_tpu.data import freq as jfreq
from tramba_tpu.data import pipeline as jpipeline
from tramba_tpu.eval import dump as jdump
from tramba_tpu.models.tramba import BaseUMamba as JBaseUMamba
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu.models.vssm_encoder import VSSMEncoder as JVSSMEncoder
from tramba_tpu.ops import selective_scan as jss
from tramba_tpu.ops.scan_orders import cross_merge, cross_scan
from tramba_tpu.utils import profiling as jprof
from tramba_tpu_torch import dump_sod
from tramba_tpu_torch.data import freq as tfreq
from tramba_tpu_torch.data import pipeline as tpipeline
from tramba_tpu_torch.eval import dump as tdump
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.models.vssm_encoder import VSSMEncoder
from tramba_tpu_torch.ops.selective_scan import linear_scan
from tramba_tpu_torch.utils import debug
from tramba_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
# dims 32 for the FLOP counts: every SS2D's dt rank (ceil(d_model / 16)) is
# then 2 or more; torch's einsum does a dt projection of rank 1 as a product
# of broadcast operands, which is no matrix product (JAX counts its
# dot_general)
FLOPS_CUT = dict(TINY, dims=32)
IMG = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


# --- analytic_model_flops -------------------------------------------------


def test_flops_of_a_product():
    a, b = _rng().normal(size=(64, 32)), _rng(1).normal(size=(32, 16))
    want = jprof.analytic_model_flops(lambda p, q: p @ q, jnp.asarray(a), jnp.asarray(b))
    got = tprof.analytic_model_flops(lambda p, q: p @ q, torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert got == want == {"matmul_conv_flops": 2 * 64 * 32 * 16, "scan_handle_flops": 0,
                           "total_flops": 2 * 64 * 32 * 16}


@pytest.mark.parametrize("groups", [1, 8])
def test_flops_of_a_grouped_convolution(groups):
    """A 3x3 convolution of 8 channels, dense and depthwise."""
    x = _rng(2).normal(size=(2, 8, 8, 8)).astype(np.float32)
    jconv = fnn.Conv(8, (3, 3), padding=1, feature_group_count=groups)
    p = jconv.init(jax.random.key(0), jnp.asarray(x))
    want = jprof.analytic_model_flops(lambda p, a: jconv.apply(p, a), p, jnp.asarray(x))
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, groups=groups)
    got = tprof.analytic_model_flops(lambda a: conv(a.permute(0, 3, 1, 2)), torch.from_numpy(x))
    assert got == want and got["matmul_conv_flops"] == 2 * 2 * 8 * 8 * 8 * 9 * 8 // groups


def test_flops_of_the_scan_handle():
    """The reference's 9 operations per scanned element (csms6s.py:772)."""
    a = _rng(3).uniform(size=(2, 4, 64, 16)).astype(np.float32)
    want = jprof.analytic_model_flops(lambda p, q: jss.linear_scan(p, q, "seq"),
                                      jnp.asarray(a), jnp.asarray(a))
    t = torch.from_numpy(a)
    got = tprof.analytic_model_flops(lambda p, q: linear_scan(p, q), t, t)
    assert got == want and got["scan_handle_flops"] == 9 * 2 * 4 * 64 * 16


def test_flops_refuse_card_tensors():
    with pytest.raises(ValueError, match="CPU"):
        tprof.analytic_model_flops(lambda a: a, torch.zeros(1, device="meta"))


def test_flops_of_a_raster_vssm_encoder_equal_jax():
    """A tiny VSSM encoder (raster orders only, no gathers spelled as
    products): the port's count equals JAX's on its composed route."""
    x = _rng(4).normal(size=(1, IMG, IMG, 3)).astype(np.float32)
    jenc = JVSSMEncoder(depths=(1, 1, 1, 1), dims=32, ssm_backend="seq")
    p = jax.eval_shape(jenc.init, jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), p)
    want = jprof.analytic_model_flops(lambda p, a: jenc.apply(p, a), p, jnp.asarray(x))
    got = tprof.analytic_model_flops(VSSMEncoder((1, 1, 1, 1), 32).eval(), torch.from_numpy(x))
    assert got == want and got["scan_handle_flops"] > 0


def _line_selector_flops(model, B):
    """The products JAX's composed route spends on the one-hot line gathers
    of every K=8 line SS2D of ``model`` (the port's, for its shapes): its
    cross scan and cross merge alone, counted by JAX's own counter."""
    from tramba_tpu_torch.nn.ssm import SS2D

    total = 0
    for name, m in model.named_modules():
        if isinstance(m, SS2D) and m.scan_kind == "line":
            stage = int(name.split(".")[2])  # decoder.stage_layers.<s>.blocks...
            H = IMG // 2 ** (len(model.decoder.stage_layers) + 1 - stage)
            x = jnp.zeros((B, H * H, m.d_inner))
            ys = jnp.zeros((B, 8, H * H, m.d_inner))
            for fn, arg in ((lambda a: cross_scan(a, "line", H, H), x),
                            (lambda a: cross_merge(a, "line", H, H), ys)):
                total += jprof.analytic_model_flops(fn, arg)["matmul_conv_flops"]
    return total


@pytest.mark.parametrize("method,jcls", [("BaseUMamba-SOD", JBaseUMamba),
                                         ("Tramba-V-TSOD", JTrambaV)])
def test_flops_of_a_model_differ_by_jax_line_selectors(method, jcls):
    """On a tiny BaseUMamba and Tramba-V the port counts JAX's products less
    the one-hot selectors of its line gathers, and the same scan handle."""
    x = _rng(5).normal(size=(1, IMG, IMG, 3)).astype(np.float32)
    model = build(method, IMG, device="cpu", seed=0, **FLOPS_CUT)
    jm = jcls(img_size=IMG, ssm_backend="seq", **FLOPS_CUT)
    p = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), p)
    want = jprof.analytic_model_flops(lambda p, a: jm.apply(p, a), p, jnp.asarray(x))
    got = tprof.analytic_model_flops(model, torch.from_numpy(x))
    selectors = _line_selector_flops(model, 1)
    assert selectors > 0
    assert got["matmul_conv_flops"] + selectors == want["matmul_conv_flops"]
    assert got["scan_handle_flops"] == want["scan_handle_flops"]


def test_selective_scan_flops_and_count_params():
    for args in ((2, 64, 16, 1), (1, 9216, 256, 4, False, True)):
        assert tprof.selective_scan_flops(*args) == jprof.selective_scan_flops(*args)
    lin = torch.nn.Linear(5, 3)
    assert tprof.count_params(lin) == 18


# --- scoring of dumped maps -----------------------------------------------


def _maps(root, rng, n=5, miss=("m2.png",)):
    """Saliency maps in ``root/maps`` and GT masks in ``root/gt``; the GT of
    ``miss`` is absent (only the intersection is scored) and one map has no
    mask at all."""
    for sub in ("maps", "gt"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        h, w = 30 + i, 40 + 2 * i
        gt = np.zeros((h, w), np.uint8)
        gt[5:20, 8 + i:30] = 255
        sal = np.clip(gt * 0.7 + rng.integers(0, 90, (h, w)), 0, 255).astype(np.uint8)
        Image.fromarray(sal, "L").save(os.path.join(root, "maps", f"m{i}.png"))
        if f"m{i}.png" not in miss:
            Image.fromarray(gt, "L").save(os.path.join(root, "gt", f"m{i}.png"))
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(os.path.join(root, "maps", "x.png"))


def test_evaluate_maps_and_rows_equal_jax(tmp_path):
    _maps(str(tmp_path), _rng(6))
    out = {}
    for name, mod in (("jax", jdump), ("port", tdump)):
        os.makedirs(tmp_path / name)
        out[name] = mod.evaluate_maps(str(tmp_path / "maps"), str(tmp_path / "gt"),
                                      save_pr_dir=str(tmp_path / name))
    want, got = out["jax"], out["port"]
    assert got.keys() == want.keys() and got["count"] == want["count"] == 4
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert tdump.format_results_row("M", "D", got) == jdump.format_results_row("M", "D", want)
    for f in ("precision.npy", "recall.npy"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _run(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, check=True).stdout


def test_scoring_entry_points(tmp_path):
    """``evaluate_sod`` reads ``<dataset_path>/<model>/SOD``, ``evaluate_tsod``
    ``<dataset_path>/<model>/<dataset>``: each prints JAX's results row for
    the same files and writes the PR curves beside the maps."""
    _maps(str(tmp_path), _rng(7))
    want = jdump.evaluate_maps(str(tmp_path / "maps"), str(tmp_path / "gt"))
    res = tmp_path / "results"
    os.makedirs(res / "M")
    for sub in ("SOD", "TSOD"):
        os.symlink(tmp_path / "maps", res / "M" / sub)
    out = _run("tramba_tpu_torch.evaluate_sod", "--dataset_path", str(res), "--models", "M",
               "--test_datasets", f"D={tmp_path / 'gt'}")
    assert jdump.format_results_row("M", "D", want) in out.splitlines()
    out = _run("tramba_tpu_torch.evaluate_tsod", "--dataset_path", str(res), "--models", "M",
               "--test_datasets", "TSOD", "--gt_root", str(tmp_path / "gt"))
    assert jdump.format_results_row("M", "TSOD", want) in out.splitlines()
    assert f"Wmeasure_r: {round(want['wFmeasure'], 4)}  fnr_r: {round(want['fnr'], 4)}" in out
    assert (res / "M" / "precision.npy").exists() and (res / "M" / "recall.npy").exists()


def test_sod_dump_writes_every_dataset_to_one_folder(tmp_path):
    """``dump_sod.dump_datasets`` on the CPU: two datasets' maps in
    ``<image_save_path>/<method>/SOD``, each at its image's size."""
    rng = _rng(8)
    sizes = {}
    for ds in ("A", "B"):
        for sub in ("image", "mask"):
            os.makedirs(tmp_path / ds / "Test" / sub)
        for i in range(2):
            w, h = 40 + 7 * i + (ds == "B"), 33 + 5 * i
            name = f"{ds.lower()}{i}"
            sizes[name] = (w, h)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(
                tmp_path / ds / "Test" / "image" / f"{name}.jpg")
            Image.fromarray((rng.random((h, w)) > 0.5).astype(np.uint8) * 255, "L").save(
                tmp_path / ds / "Test" / "mask" / f"{name}.png")
    model = build("BaseUMamba-SOD", IMG, device="cpu", seed=0, **TINY)
    datasets = dump_sod.parse_datasets([f"A={tmp_path / 'A'}", f"B={tmp_path / 'B'}"])
    written = dump_sod.dump_datasets(model, datasets, str(tmp_path / "out"), "BaseUMamba-SOD",
                                     img_size=IMG, batch_size=3)
    assert written == {"A": 2, "B": 2}
    out = tmp_path / "out" / "BaseUMamba-SOD" / "SOD"
    assert sorted(os.listdir(out)) == sorted(f"{n}.png" for n in sizes)
    for name, size in sizes.items():
        with Image.open(out / f"{name}.png") as im:
            assert im.size == size and im.mode == "L"
    assert dump_sod.parse_datasets(["DUTS"]) == {"DUTS": "DUTS"}


# --- frequency features ---------------------------------------------------


def test_freq_features_and_stats_equal_jax(tmp_path):
    """Block-DCT features and their halves at 1e-5; stats computed by both
    packages at 1e-5, and a stats file written by each read by the other."""
    rng = _rng(9)
    images = [rng.integers(0, 256, (32, 48, 3)).astype(np.float32) for _ in range(3)]
    for img in images:
        want, got = jfreq.block_dct_features(img), tfreq.block_dct_features(img)
        assert got.shape == want.shape == (4, 6, 192)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for g, w in zip(tfreq.freq_decompose(got), jfreq.freq_decompose(want)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    js, ts = jfreq.compute_freq_stats(images), tfreq.compute_freq_stats(images)
    keys = ("high_mean", "high_std", "low_mean", "low_std")
    for k in keys:
        np.testing.assert_allclose(getattr(ts, k), getattr(js, k), rtol=1e-5, atol=1e-5)
    js.save(str(tmp_path / "j.pkl"))
    ts.save(str(tmp_path / "t.pkl"))
    for a, b in ((tfreq.FreqStats.load(str(tmp_path / "j.pkl")), js),
                 (jfreq.FreqStats.load(str(tmp_path / "t.pkl")), ts)):
        for k in keys:
            assert np.array_equal(getattr(a, k), getattr(b, k))
    high, low = tfreq.freq_decompose(got)
    for g, w in zip(ts.normalize(high, low), js.normalize(high, low)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_dataset_freq_samples_equal_jax(tmp_path):
    """``SODDataset(freq_stats=<path>)`` gives 'high' / 'low' samples, and the
    loader stacks them, as the JAX package's does (1e-5)."""
    rng = _rng(10)
    for sub in ("image", "mask"):
        os.makedirs(tmp_path / "Test" / sub)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8), "RGB").save(
            tmp_path / "Test" / "image" / f"s{i}.jpg")
        Image.fromarray((rng.random((40 + i, 50)) > 0.5).astype(np.uint8) * 255, "L").save(
            tmp_path / "Test" / "mask" / f"s{i}.png")
    tfreq.FreqStats(*(rng.uniform(0.5, 2.0, 96).astype(np.float32) for _ in range(4))).save(
        str(tmp_path / "stats.pkl"))
    batches = []
    for mod in (jpipeline, tpipeline):
        ds = mod.SODDataset(str(tmp_path), ["Test"], 32, mode="test",
                            freq_stats=str(tmp_path / "stats.pkl"))
        batches.append(next(iter(mod.BatchLoader(ds, batch_size=3, num_threads=1))))
    want, got = batches
    for key in ("high", "low"):
        assert got[key].shape == want[key].shape == (3, 4, 4, 96)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


# --- debug guards and the trace -------------------------------------------


def test_debug_guards_catch_a_nan(capsys):
    x = torch.ones(3, 4)
    assert debug.check_nan_inf("x", x) is x
    x[1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="x: 1 non-finite values"):
        debug.check_nan_inf("x", x)
    assert debug.check_nan_inf("x", x, raise_on_bad=False) is x
    lin = torch.nn.Linear(4, 2)
    assert debug.tree_check_finite(lin) and debug.tree_check_finite({"w": torch.zeros(2)})
    with torch.no_grad():
        lin.bias[0] = float("inf")
    assert not debug.tree_check_finite(lin)
    assert not debug.tree_check_finite({"w": x}, prefix="state")
    out = capsys.readouterr().out
    assert "params.bias: non-finite values" in out and "state.w: non-finite values" in out


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
