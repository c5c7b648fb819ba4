"""Tramba-R (ResNet-50 with BatchNorm) in fp32 against the JAX package:
inference, training with the running statistics, the weight converters,
the torchvision graft, checkpoints and the optimizer's groups.

The JAX side is ``tramba_tpu/models/resnet.py``'s ``ResNetEncoder`` and
``TrambaDecoder`` with ``TrambaEnc``'s Tramba-R skip assembly
(``tramba_tpu/models/tramba.py:236-240``; ``TrambaEnc`` fixes the full
depth).  The cut: 64 px images, one bottleneck per stage (the widths stay
ResNet-50's: the decoder runs at 512 and 256 on 8 and 16 px maps), the
decoder at depth 1.  Training runs JAX with ``deterministic=False`` and a
mutable ``batch_stats`` (``tramba_tpu/train/step.py:61-67``) and the port in
``train()`` mode, every drop-path rate 0 on both sides, so that BatchNorm
takes batch statistics and the two runs draw nothing.  Tolerances: the
heads at atol 1e-4, the loss rtol 1e-5, each parameter's gradient
||port - jax|| <= 1e-4 ||jax||, the updated running mean and variance rtol /
atol 1e-5 (flax moves them with the biased batch variance, which the port
follows; ``torch.nn.BatchNorm2d``'s unbiased one differs by n / (n - 1),
0.8% at the 16 px stage-1 map of this batch, and the test shows it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tramba_tpu.compat.torch_weights import (convert_resnet_encoder, convert_tramba_decoder,
                                             convert_tramba_enc, state_dict_to_numpy)
from tramba_tpu.models import resnet as jresnet
from tramba_tpu.models.tramba import TrambaDecoder as JDecoder
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.compat.torch_weights import graft_resnet_encoder, upstream_encoder_state_dict
from tramba_tpu_torch.models.registry import METHODS, build
from tramba_tpu_torch.nn.layers import BatchNorm
from tramba_tpu_torch.train import checkpoint as ckpt
from tramba_tpu_torch.train import loss as tloss
from tramba_tpu_torch.train.loop import init_model
from tramba_tpu_torch.train.optim import make_optimizer

IMG = 64
LAYERS = (1, 1, 1, 1)
DEC = (1, 1, 1)
HEADS = [(2, 8, 8, 1), (2, 16, 16, 1), (2, 64, 64, 1)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JTrambaR(fnn.Module):
    """TrambaEnc's Tramba-R assembly at the cut configuration, drop path 0."""

    dtype: jnp.dtype = jnp.float32
    ssm_backend: str = None

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        outs = jresnet.ResNetEncoder(layers=LAYERS, dtype=self.dtype, name="encoder")(
            x, deterministic)
        skips = [x] + outs[1:-1][::-1]
        return JDecoder(features_per_stage=[256, 512, 1024], depths=DEC, drop_path_rate=0.0,
                        img_size=IMG, ssm_backend=self.ssm_backend, dtype=self.dtype,
                        name="decoder")(skips, deterministic)


def tiny(dtype=torch.float32, seed=0):
    return build("Tramba-R-TSOD", IMG, seed=seed, dtype=dtype, enc_config={"layers": LAYERS},
                 dec_depths=DEC, dec_drop_path=0.0)


def randomise_batchnorms(model, seed=5):
    """BatchNorm scales, biases and running statistics away from their init,
    so that a BatchNorm left out or mis-converted shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(1 + 0.5 * torch.rand(n, generator=g))
    return model


def jax_variables(sd):
    """The port's state dict -> the flax variables of JTrambaR, through the
    JAX package's own converters."""
    sd = state_dict_to_numpy(sd)
    enc, stats = convert_resnet_encoder(sd, "encoder.", LAYERS)
    return {"params": {"encoder": enc, "decoder": convert_tramba_decoder(sd, "decoder.", 3, DEC)},
            "batch_stats": {"encoder": stats}}


def batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    return x, (rng.random((2, IMG, IMG, 1)) > 0.7).astype(np.float32)


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def test_tiny_model_fp32_matches_jax():
    """Eval mode / deterministic=True (running statistics): the three heads
    at atol 1e-4.  Stage 4, whose output feeds no head, does not run (XLA
    drops it from JAX's jitted forward)."""
    model = randomise_batchnorms(tiny())
    x, _ = batch(0)
    want = jax.jit(JTrambaR().apply)(jax_variables(model.state_dict()), jnp.asarray(x))
    ran = []
    model.encoder.layer4.register_forward_hook(lambda *_: ran.append(1))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert not ran
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"head {i}")


def test_tiny_model_training_matches_jax_with_batch_stats():
    """train() / deterministic=False with a mutable batch_stats: the loss,
    every gradient and every updated running statistic.  Stage 4 runs for
    its statistics; its output feeds no head, so its parameters are frozen
    and get no gradient (JAX's are 0)."""
    model = randomise_batchnorms(tiny())
    variables = jax_variables(model.state_dict())
    x, gt = batch(1)
    jmodel = JTrambaR()

    def f(p):
        outs, new = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), deterministic=False, mutable=["batch_stats"])
        return jloss.deep_supervision_loss(outs, jnp.asarray(gt)), new

    (want_loss, new), want_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"])
    want = params_from_jax({"params": jax.tree.map(np.asarray, want_grads),
                            "batch_stats": jax.tree.map(np.asarray, new["batch_stats"])})
    stats_before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.train()
    loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(model.named_parameters())
    assert set(want) == set(got) | set(stats_before)
    for name, p in got.items():
        if name.startswith("encoder.layer4."):
            assert not p.requires_grad and p.grad is None and not want[name].any(), name
            continue
        assert p.grad is not None, name
        rel = _rel(p.grad, want[name])
        assert rel <= 1e-4, f"{name}: relative grad error {rel}"
    state = model.state_dict()
    for name, before in stats_before.items():
        assert not torch.equal(state[name], before), name
        torch.testing.assert_close(state[name], want[name], rtol=1e-5, atol=1e-5, msg=name)
    # torch.nn.BatchNorm2d's unbiased update misses flax's by n / (n - 1)
    bn = model.encoder.layer1[0].bn1
    h = torch.randn(2, 16, 16, bn.weight.numel())
    flax_like, torch_like = BatchNorm(bn.weight.numel()), torch.nn.BatchNorm2d(
        bn.weight.numel(), momentum=0.1)
    flax_like.train()(h)
    torch_like.train()(h.permute(0, 3, 1, 2))
    ratio = (torch_like.running_var - 0.9) / (flax_like.running_var - 0.9)
    torch.testing.assert_close(ratio, torch.full_like(ratio, 512 / 511), rtol=1e-4, atol=0)


def test_params_from_jax_round_trips_convert_tramba_enc_exactly():
    """At full width (no forward): the port's state dict, running statistics
    included, is what convert_tramba_enc(..., "resnet") reads (its strict
    leftover check passes), and params_from_jax inverts it leaf for leaf,
    batch_stats included.  Each entry is filled with distinct values."""
    model = build("Tramba-R-TSOD", 384, seed=None)
    with torch.no_grad():
        for i, t in enumerate(model.state_dict().values()):
            t.copy_(torch.arange(t.numel(), dtype=torch.float32).view_as(t) * 1e-6 + i)
    sd = model.state_dict()
    v = convert_tramba_enc(state_dict_to_numpy(sd), "resnet")
    assert set(v) == {"params", "batch_stats"}
    back = params_from_jax(v)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert jax.tree_util.tree_all(jax.tree.map(np.array_equal,
                                               convert_tramba_enc(back, "resnet"), v))


def test_init_model_grafts_torchvision_resnet_with_running_stats(tmp_path):
    """Weights and running statistics land under the port's names, nothing
    else moves; a missing or unknown key raises; a checkpoint of other
    depths is fatal unless --allow_random_init."""
    src = randomise_batchnorms(tiny(seed=3))
    ref = upstream_encoder_state_dict(src)
    torch.save(ref, tmp_path / "resnet50.pth")
    model = tiny()
    dec_before = model.state_dict()["decoder.seg_layers.0.weight"].clone()
    args = type("A", (), dict(pretrained_path=str(tmp_path / "resnet50.pth"),
                              allow_random_init=False, method="Tramba-R-TSOD"))()
    init_model(args, model)
    got = model.state_dict()
    for k, v in src.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(got[k], v), k
    assert torch.equal(got["decoder.seg_layers.0.weight"], dec_before)
    with pytest.raises(KeyError, match="lacks 1 encoder weights"):
        graft_resnet_encoder({k: v for k, v in ref.items() if k != "bn1.running_var"}, LAYERS)
    with pytest.raises(ValueError, match="unconsumed"):
        graft_resnet_encoder({**ref, "layer5.0.conv1.weight": torch.zeros(2)}, LAYERS)
    deeper = build("Tramba-R-TSOD", IMG, seed=0, enc_config={"layers": (1, 2, 1, 1)},
                   dec_depths=DEC)
    with pytest.raises(RuntimeError, match="allow_random_init"):
        init_model(args, deeper)
    args.allow_random_init = True
    init_model(args, deeper)


def test_checkpoints_carry_the_running_statistics(tmp_path):
    """save_params / load_checkpoint round-trip the BatchNorm buffers
    exactly; a reference state dict with num_batches_tracked loads strictly
    (the count is dropped: flax keeps none), and so does the resume dict."""
    model = randomise_batchnorms(tiny())
    path = str(tmp_path / "w.pth")
    ckpt.save_params(path, model)
    assert not any("num_batches_tracked" in k for k in torch.load(path))
    other = tiny(seed=1)
    ckpt.load_checkpoint(other, path)
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                 model.state_dict().values()))
    ref = dict(model.state_dict())
    ref.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(7)
                for k in model.state_dict() if k.endswith("running_var")})
    torch.save({"state_dict": ref}, tmp_path / "ref.pth")
    other = tiny(seed=2)
    ckpt.load_checkpoint(other, str(tmp_path / "ref.pth"))
    assert all(torch.equal(other.state_dict()[k], v) for k, v in model.state_dict().items())
    opt = make_optimizer(model.named_parameters(), 1e-3, [60], [0.2], 1)
    ckpt.save_resume(str(tmp_path / "r.pth"), model, opt, 4)
    other = tiny(seed=2)
    opt2 = make_optimizer(other.named_parameters(), 1e-3, [60], [0.2], 1)
    assert ckpt.load_resume(str(tmp_path / "r.pth"), other, opt2) == 5
    assert all(torch.equal(other.state_dict()[k], v) for k, v in model.state_dict().items())


def test_every_resnet_parameter_trains_in_the_encoder_group():
    """encoder_label sends every ResNet parameter (BatchNorm scale and bias
    included) to the 0.1x group, every decoder parameter to the other, and
    no BatchNorm buffer to either."""
    model = tiny()
    opt = make_optimizer(model.named_parameters(), 1e-3, [60], [0.2], 1)
    groups = {label: {n for n, _ in named} for label, (_, named) in opt.groups.items()}
    params = dict(model.named_parameters())
    assert groups["encoder"] == {n for n in params if n.startswith("encoder.")}
    assert groups["rest"] == {n for n in params if n.startswith("decoder.")}
    buffers = {n for n, _ in model.named_buffers()}
    assert buffers and all("running_" in n for n in buffers)
    assert not buffers & (groups["encoder"] | groups["rest"])


def test_registry_and_dump_build_tramba_r(tmp_path):
    """Both Tramba-R methods build with ResNet-50's 47.0 M parameters at full
    width (flax's BatchNorm init: scale 1, bias 0, statistics 0 / 1); the
    dump's path writes one map per image at its original size."""
    from PIL import Image

    from tramba_tpu_torch.eval.dump import dump_saliency_maps

    assert {"Tramba-R-TSOD", "Tramba-R-SOD"} <= set(METHODS)
    full = build("Tramba-R-SOD", 384, seed=None)
    assert sum(p.numel() for p in full.parameters()) == 46_991_427
    model = tiny(torch.bfloat16)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert not (m.weight - 1).any() and not m.bias.any()
            assert not m.running_mean.any() and not (m.running_var - 1).any()
    rng = np.random.default_rng(0)
    for sub in ("image", "mask"):
        (tmp_path / "data" / "Test" / sub).mkdir(parents=True)
    for i, (w, h) in enumerate(((50, 44), (33, 61))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(
            tmp_path / "data" / "Test" / "image" / f"i{i}.png")
        Image.fromarray((rng.random((h, w)) > 0.5).astype(np.uint8) * 255, "L").save(
            tmp_path / "data" / "Test" / "mask" / f"i{i}.png")
    assert dump_saliency_maps(model, str(tmp_path / "data"), str(tmp_path / "out"),
                              img_size=IMG, batch_size=2) == 2
    for i, size in enumerate(((50, 44), (33, 61))):
        with Image.open(tmp_path / "out" / f"i{i}.png") as im:
            assert im.size == size and im.mode == "L"
