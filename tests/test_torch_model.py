"""The port's slice end to end: tiny Tramba-V vs JAX, weights, dump, imports."""

import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tramba_tpu_torch
from tramba_tpu.compat.torch_weights import convert_tramba_v, state_dict_to_numpy
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.models.registry import build

TINY = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
IMG = 64
HEADS = [(2, 4, 4, 1), (2, 8, 8, 1), (2, 16, 16, 1), (2, 64, 64, 1)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    return build("Tramba-V-TSOD", IMG, seed=0, **TINY)


def test_tiny_trambav_matches_jax(tiny):
    """All four deep-supervision heads of the same weights and image, fp32:
    port plain path vs the JAX composed CPU path, atol 1e-4 on the logits."""
    params = convert_tramba_v(state_dict_to_numpy(tiny.state_dict()),
                              enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    x = np.random.default_rng(0).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(JTrambaV(img_size=IMG, **TINY).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tiny(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"head {i}")


def test_weights_round_trip_and_strict_load():
    """convert_tramba_v(params_from_jax(p)) == p leaf by leaf, for a tree
    shaped like the flax model's own init; the state dict loads strictly."""
    shapes = jax.eval_shape(JTrambaV(img_size=IMG, **TINY).init, jax.random.key(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = params_from_jax(p)
    back = convert_tramba_v(sd, enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    want = dict(jax.tree_util.tree_leaves_with_path(p))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    model = build("Tramba-V-TSOD", IMG, seed=None, **TINY)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.state_dict()["decoder.seg_layers.3.weight"],
                       sd["decoder.seg_layers.3.weight"])


def test_load_checkpoint_reads_reference_pth(tiny, tmp_path):
    """The dump CLI's .pth loader: strict, apart from the weightless buffers
    the converter also skips (here a DCT basis)."""
    from tramba_tpu_torch.dump import load_checkpoint

    sd = dict(tiny.state_dict())
    sd["decoder.guide_layers.0.attn.DCT2D.weight"] = torch.zeros(4, 4)
    torch.save(sd, tmp_path / "ref.pth")
    model = build("Tramba-V-TSOD", IMG, seed=None, **TINY)
    load_checkpoint(model, str(tmp_path / "ref.pth"))
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in tiny.state_dict().items())


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """The TSOD10K layout of tests/test_end_to_end.py: {root}/Test/{image,mask}."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    for sub in ("image", "mask"):
        os.makedirs(root / "Test" / sub)
    for i in range(4):
        w, h = 50 + i, 44 + i
        mask = np.zeros((h, w), np.uint8)
        mask[10:30, 8:35] = 255
        img = np.clip(np.stack([mask] * 3, -1) + rng.integers(0, 60, (h, w, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8), "RGB").save(root / "Test" / "image" / f"i{i}.png")
        Image.fromarray(mask, "L").save(root / "Test" / "mask" / f"i{i}.png")
    return str(root)


def test_dump_writes_maps_at_original_size(tiny, tiny_dataset, tmp_path):
    from tramba_tpu_torch.eval.dump import dump_saliency_maps

    n = dump_saliency_maps(tiny, tiny_dataset, str(tmp_path), img_size=IMG, batch_size=3)
    assert n == 4 and len(os.listdir(tmp_path)) == 4
    for i in range(4):
        with Image.open(tmp_path / f"i{i}.png") as im:
            assert im.size == (50 + i, 44 + i) and im.mode == "L"


def test_every_module_imports_without_jax():
    names = [m.name for m in pkgutil.walk_packages(tramba_tpu_torch.__path__, "tramba_tpu_torch.")]
    assert "tramba_tpu_torch.dump" in names and len(names) > 15
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
            " if v is not None)")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_unported_methods_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        build("BaseUMamba-SOD")
    with pytest.raises(ValueError):
        build("Tramba-X")


def test_card_only_entry_points_refuse_the_cpu(monkeypatch):
    from tramba_tpu_torch import dump
    from tramba_tpu_torch.utils.profiling import measure_inference_speed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dump.main(["--data_root", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_inference_speed(lambda a: a, (torch.zeros(1),))
