"""The port stands alone: it imports neither jax nor the JAX package, and its
copies of the JAX package's numpy-only modules (data pipeline, metrics, the
VMamba encoder graft) give what the originals give."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tramba_tpu.compat.torch_weights import convert_vmamba_encoder_pretrained
from tramba_tpu.data import pipeline as jpipeline
from tramba_tpu.eval import metrics as jmetrics
from tramba_tpu.models import pvt as jpvt
from tramba_tpu.models import swin as jswin
from tramba_tpu_torch.compat.jax_weights import encoder_from_jax
from tramba_tpu_torch.compat.torch_weights import graft_vmamba_encoder
from tramba_tpu_torch.data import pipeline as tpipeline
from tramba_tpu_torch.eval import metrics as tmetrics
from tramba_tpu_torch.models import pvt as tpvt
from tramba_tpu_torch.models import swin as tswin
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.train import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = """
import importlib, pkgutil, sys
import tramba_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tramba_tpu_torch.__path__, "tramba_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "tramba_tpu" or m.startswith("tramba_tpu."))
print(",".join(names))
print(len(names), bad)
"""

# the parallel layer's modules and the encoders, which the walk must reach
PARALLEL = {"tramba_tpu_torch.parallel.mesh", "tramba_tpu_torch.parallel.distributed",
            "tramba_tpu_torch.parallel.tp", "tramba_tpu_torch.parallel.seq_scan",
            "tramba_tpu_torch.dryrun"}
ENCODERS = {"tramba_tpu_torch.models.vssm_encoder", "tramba_tpu_torch.models.swin",
            "tramba_tpu_torch.models.pvt", "tramba_tpu_torch.models.resnet"}
# the SOD dump, the scoring entry points and the library modules of the last
# slice of Queue 1 (items 6b, 11)
ENTRY_AND_LIBRARY = {"tramba_tpu_torch.dump_sod", "tramba_tpu_torch.evaluate_sod",
                     "tramba_tpu_torch.evaluate_tsod", "tramba_tpu_torch.utils.debug",
                     "tramba_tpu_torch.utils.profiling", "tramba_tpu_torch.data.freq"}


def test_port_and_chip_smoke_import_no_jax():
    """Every module of tramba_tpu_torch (the parallel layer, the dry run,
    the ResNet-50 encoder, the SOD dump and scoring entry points included),
    and chip_smoke, imported in a fresh
    interpreter: no jax and no tramba_tpu module is loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    *_, names, last = res.stdout.strip().splitlines()
    count, bad = last.split(" ", 1)
    assert int(count) > 30 and bad == "[]", res.stdout
    assert PARALLEL | ENCODERS | ENTRY_AND_LIBRARY <= set(names.split(",")), names


_LAYERS = """
import importlib, pkgutil, sys
import tramba_tpu_torch.nn, tramba_tpu_torch.ops, tramba_tpu_torch.parallel
for pkg in (tramba_tpu_torch.nn, tramba_tpu_torch.ops, tramba_tpu_torch.parallel):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.startswith("tramba_tpu_torch.models")))
"""


def test_layers_import_no_model():
    """``tramba_tpu_torch.nn``, ``.ops`` (the seeded init included) and
    ``.parallel`` import nothing of ``tramba_tpu_torch.models``: a model owns
    its own draws, and the parallel layer works on SS2D's parameters."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", _LAYERS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def _write_split(root, split, n, rng):
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(root, split, sub))
    for i in range(n):
        w, h = 50 + 7 * i, 40 + 3 * i
        mask = (rng.random((h, w)) > 0.6).astype(np.uint8) * 255
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img, "RGB").save(os.path.join(root, split, "image", f"im{i}.jpg"))
        Image.fromarray(mask, "L").save(os.path.join(root, split, "mask", f"im{i}.png"))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_copied_loader_gives_byte_equal_batches(tmp_path, mode):
    """One seed, one folder: every batch of the port's SODDataset /
    BatchLoader equals the JAX package's byte for byte (augmentation draws
    included in train mode)."""
    _write_split(str(tmp_path), "Train", 5, np.random.default_rng(0))
    batches = []
    for mod in (jpipeline, tpipeline):
        ds = mod.SODDataset(str(tmp_path), ["Train"], 32, mode=mode)
        loader = mod.BatchLoader(ds, batch_size=2, shuffle=mode == "train", seed=1026,
                                 num_threads=2)
        batches.append([b for _ in range(2) for b in loader])  # two epochs
    assert len(batches[0]) == len(batches[1]) == 6
    for want, got in zip(*batches):
        assert want["name"] == got["name"] and want["shape"] == got["shape"]
        for key in ("image", "gt"):
            assert want[key].dtype == got[key].dtype and want[key].tobytes() == got[key].tobytes()


def test_copied_metrics_equal_the_jax_package():
    """SODMetrics over the same maps: every score equal."""
    scores = []
    for mod in (jmetrics, tmetrics):
        m = mod.SODMetrics()
        for i in range(3):
            r = np.random.default_rng(i)
            gt = (r.random((37, 41)) > 0.7).astype(np.float32)
            pred = np.clip(gt * 0.6 + r.random((37, 41)) * 0.5, 0, 1).astype(np.float32)
            m.append(mod.SODMetrics.compute_one(pred, gt))
        scores.append(m.results())
    assert scores[0].keys() == scores[1].keys()
    for k in scores[0]:
        np.testing.assert_array_equal(np.asarray(scores[1][k]), np.asarray(scores[0][k]), k)


def _vmamba_checkpoint(depths, seed):
    """An upstream-VMamba-style classification checkpoint: the encoder of a
    tiny model, downsamples under layers.{i}.downsample, optional biases on
    some Linears, a classifier and a weightless buffer."""
    model = build("Tramba-V-TSOD", 64, device="cpu", seed=seed, dims=16, enc_depths=depths,
                  dec_depths=(1, 1, 1, 1))
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith("vssm_encoder."):
            continue
        k = k[len("vssm_encoder."):]
        if k.startswith("downsample."):
            _, i, rest = k.split(".", 2)
            k = f"layers.{i}.downsample.{rest}"
        sd[k] = v.clone()
    g = torch.Generator().manual_seed(seed)
    sd["layers.0.blocks.0.op.in_proj.bias"] = torch.randn(32, generator=g)
    sd["layers.1.blocks.0.op.out_proj.bias"] = torch.randn(32, generator=g)
    sd["classifier.head.weight"] = torch.zeros(10, 128)
    sd["layers.0.blocks.0.op.total_ops"] = torch.zeros(1)
    return sd


def test_graft_equals_the_round_trip_through_flax():
    """graft_vmamba_encoder(sd) == encoder_from_jax(convert_vmamba_encoder_
    pretrained(sd)): the same keys and equal tensors; a leftover learned key
    and a missing weight both raise, as in the JAX converter."""
    depths = (1, 2, 1, 1)
    sd = _vmamba_checkpoint(depths, seed=5)
    want = encoder_from_jax(convert_vmamba_encoder_pretrained(sd, depths))
    got = graft_vmamba_encoder(sd, depths)
    assert got.keys() == want.keys() and "vssm_encoder.layers.0.blocks.0.op.in_proj.bias" in got
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="unconsumed"):
        graft_vmamba_encoder({**sd, "layers.0.blocks.0.op.extra": torch.zeros(1)}, depths)
    with pytest.raises(KeyError):
        graft_vmamba_encoder({k: v for k, v in sd.items() if not k.endswith("A_logs")}, depths)


def test_training_refuses_a_missing_card(monkeypatch):
    """training(..., device="cuda") raises on a host without CUDA instead of
    falling back to the CPU, before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(loop, "build", lambda *a, **k: pytest.fail("built a model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.training(object())


@pytest.mark.parametrize("w,H,shift", [(12, 96, 6), (12, 24, 6), (4, 16, 2), (7, 14, 3)])
def test_copied_swin_tables_equal_the_jax_package(w, H, shift):
    """The port's relative-position index and shift mask (copies of
    models/swin.py:49-74) equal the JAX package's, element for element."""
    np.testing.assert_array_equal(tswin.relative_position_index(w),
                                  jswin._relative_position_index(w))
    got, want = tswin.shift_attn_mask(H, H, w, shift), jswin._shift_attn_mask(H, H, w, shift)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_copied_encoder_configs_equal_the_jax_package():
    assert tpvt.pvt_v2_b4_config() == jpvt.pvt_v2_b4_config()
    assert tswin.swin_b_384_config() == jswin.swin_b_384_config()
