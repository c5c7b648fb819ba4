"""BaseUMamba-SOD, the ablation baseline, in the port vs the JAX package.

A tiny BaseUMamba (64 px, depths 1) on the CPU: weights from JAX through
``params_from_jax``, fp32 heads at atol 1e-4 (as Tramba-V's), bf16 heads at
the bf16 model gate of ``tests/test_torch_bf16_model.py`` (mean abs 2e-2,
the JAX side on its Pallas kernels in interpret mode), one train step's
loss at rtol 1e-4 and gradients at 1e-3 relative norm; its state dict
through JAX's ``convert_base_umamba`` with every key consumed;
``VSSMDecoderBlock`` over two of the new scan orders at rtol 1e-4 / atol
1e-5; and ``python -m tramba_tpu_torch.run --method BaseUMamba-SOD``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tramba_tpu.compat.torch_weights import convert_base_umamba, state_dict_to_numpy
from tramba_tpu.models.tramba import BaseUMamba as JBaseUMamba
from tramba_tpu.nn.blocks import VSSMDecoderBlock as JVSSMDecoderBlock
from tramba_tpu.train import loss as jloss
from tramba_tpu.utils.profiling import count_params as jcount_params
from tramba_tpu_torch import run
from tramba_tpu_torch.compat.jax_weights import _block, params_from_jax
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.models.tramba import BaseUMamba
from tramba_tpu_torch.nn.blocks import VSSMDecoderBlock
from tramba_tpu_torch.train import loop
from tramba_tpu_torch.train import loss as tloss
from tramba_tpu_torch.utils.profiling import count_params

TINY = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
TINY_BF16 = dict(TINY, dims=64)  # d_inner 128, FFN hidden 256: JAX's kernel gates hold
IMG = 64
HEADS = [(2, 4, 4, 1), (2, 8, 8, 1), (2, 16, 16, 1), (2, 64, 64, 1)]
BF16_HEAD_MEAN_ABS_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cut, seed=0):
    """JAX's BaseUMamba and a flax tree for it: a seeded port model's weights
    through JAX's ``convert_base_umamba``, which must consume every key."""
    seeded = build("BaseUMamba-SOD", IMG, device="cpu", seed=seed, **cut)
    params = convert_base_umamba(state_dict_to_numpy(seeded.state_dict()),
                                 enc_depths=cut["enc_depths"], dec_depths=cut["dec_depths"])
    return JBaseUMamba(img_size=IMG, **cut), params


def _port_from_jax(params, cut, dtype=torch.float32):
    model = build("BaseUMamba-SOD", IMG, device="cpu", seed=None, dtype=dtype, **cut)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its flax tree, the port's model loaded from that tree)."""
    jm, params = _jax_params(TINY)
    return jm, params, _port_from_jax(params, TINY)


def _image(seed=0):
    return np.random.default_rng(seed).normal(size=(2, IMG, IMG, 3)).astype(np.float32)


def test_tiny_base_umamba_matches_jax(tiny):
    """The flax tree carried over by ``params_from_jax``; the four heads of
    the same image, fp32, atol 1e-4 on the logits."""
    jm, params, model = tiny
    assert not hasattr(model.decoder, "guide_layers")
    x = _image()
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"head {i}")


def test_tiny_bf16_base_umamba_matches_jax_pallas():
    """bf16 against JAX's bf16 model on its Pallas kernels (interpret mode),
    held to the bf16 model gate: mean abs logit difference 2e-2 a head."""
    _, params = _jax_params(TINY_BF16, seed=1)
    model = _port_from_jax(params, TINY_BF16, torch.bfloat16)
    x = _image(1)
    jbf16 = JBaseUMamba(img_size=IMG, dtype=jnp.bfloat16, ssm_backend="pallas", **TINY_BF16)
    want = jax.jit(jbf16.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        assert np.isfinite(g).all()
        diff = np.abs(g - w).mean()
        assert diff <= BF16_HEAD_MEAN_ABS_TOL, f"head {i}: mean abs {diff}"


def test_state_dict_converts_through_convert_base_umamba(tiny):
    """JAX's converter consumes every key of the port's state dict strictly
    (the reference's names) and gives the flax tree back leaf for leaf."""
    _, params, model = tiny
    back = convert_base_umamba(state_dict_to_numpy(model.state_dict()),
                               enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    assert count_params(model) == jcount_params(params)


def test_full_width_parameter_count():
    """BaseUMamba at 384 px holds 101,070,212 parameters (the JAX model's
    count by ``jax.eval_shape``), built on the meta device: no memory."""
    with torch.device("meta"):
        assert count_params(BaseUMamba(384)) == 101_070_212


@pytest.mark.parametrize("kind", ["spiral8", "hilbert"])
def test_vssm_decoder_block_matches_jax(kind):
    """One VSSMDecoderBlock over a K=8 (spiral8) and a K=4 (hilbert) order,
    12 x 12 map, fp32: rtol 1e-4, atol 1e-5."""
    k = 8 if kind == "spiral8" else 4
    jblk = JVSSMDecoderBlock(hidden_dim=16, scan_kind=kind, k_group=k)
    x = np.random.default_rng(3).normal(size=(2, 12, 12, 16)).astype(np.float32)
    params = jax.jit(jblk.init)(jax.random.key(3), jnp.asarray(x))
    want = jax.jit(jblk.apply)(params, jnp.asarray(x))
    blk = VSSMDecoderBlock(16, scan_kind=kind, k_group=k).eval()
    sd = {}
    _block(sd, "blk", jax.tree.map(np.asarray, params["params"]))  # params_from_jax's, per block
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_tiny_train_step_loss_and_grads_match_jax(tiny):
    """The deep-supervision loss (rtol 1e-4) and every parameter's gradient
    (||port - jax|| <= 1e-3 ||jax||) against jax.value_and_grad through the
    flax model (deterministic: no stochastic depth, as the port's eval())."""
    jm, params, _ = tiny
    model = _port_from_jax(params, TINY)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    gt = (rng.random((2, IMG, IMG, 1)) > 0.5).astype(np.float32)

    def jloss_fn(p):
        return jloss.deep_supervision_loss(jm.apply(p, jnp.asarray(x), deterministic=True),
                                           jnp.asarray(gt))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss_fn))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        rel = (got[name].grad - w).norm().item() / max(w.norm().item(), 1e-30)
        assert rel <= 1e-3, f"{name}: relative grad error {rel}"


def _write_split(root, split, n, rng):
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(root, split, sub))
    for i in range(n):
        w, h = 70 + i, 60 + i
        mask = np.zeros((h, w), np.uint8)
        mask[10 + i:40, 12:50 - i] = 255
        img = np.clip(np.stack([mask] * 3, -1) + rng.integers(0, 80, (h, w, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8), "RGB").save(
            os.path.join(root, split, "image", f"s{i}.jpg"))
        Image.fromarray(mask, "L").save(os.path.join(root, split, "mask", f"s{i}.png"))


def test_run_cli_trains_base_umamba(tmp_path, monkeypatch, capsys):
    """``tramba_tpu_torch.run --method BaseUMamba-SOD`` with the model cut
    to TINY: one epoch with the in-loop eval and its best-MAE file; the
    optimizer labels the VSSM encoder's parameters ``encoder``."""
    monkeypatch.setattr(loop, "build", functools.partial(build, **TINY))
    data = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    _write_split(data, "Train", 4, rng)
    _write_split(data, "Test", 2, rng)
    model, opt = run.main(["--method", "BaseUMamba-SOD", "--data_root", data,
                           "--evaluation_root", data, "--img_size", str(IMG), "--batch_size", "2",
                           "--save_model", str(tmp_path / "res"), "--tf_log_path", "",
                           "--pretrained_path", "", "--see", "1", "--train_epochs", "1"],
                          device="cpu")
    out = capsys.readouterr().out
    assert "Model:BaseUMamba-SOD" in out and "Epoch [001/001] loss" in out and "MAE:" in out
    assert isinstance(model, BaseUMamba)
    assert any("_MAE_" in f for f in os.listdir(tmp_path / "res" / "BaseUMamba-SOD"))
    assert opt.count == {"encoder": 2, "rest": 2}
