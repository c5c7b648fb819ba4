"""The port's training slice vs the JAX package: loss, optimizer, stochastic
depth, tiny-model gradients, checkpoints and the ``tramba_tpu_torch.run`` CLI.

fp32 on the CPU (plain versions of the kernels), tiny shapes.  Tolerances are
stated in each test.
"""

import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from test_torch_encoders import CUT as ENC_CUT
from tramba_tpu.compat.torch_weights import convert_tramba_v, state_dict_to_numpy
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu.nn.layers import DropPath as JDropPath
from tramba_tpu.train import loss as jloss
from tramba_tpu.train import optim as joptim
from tramba_tpu_torch import run
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.compat.torch_weights import upstream_encoder_state_dict
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.layers import DropPath, set_drop_path_generator
from tramba_tpu_torch.ops import fused_expand as te
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables
from tramba_tpu_torch.train import checkpoint as ckpt
from tramba_tpu_torch.train import loss as tloss
from tramba_tpu_torch.train import loop
from tramba_tpu_torch.train import optim as toptim
from tramba_tpu_torch.train.loop import init_model
from tramba_tpu_torch.train.step import eval_step, train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny, so their ops are small: on one thread they
    run as fast, and they do not stall when pytest's worker processes put more
    torch threads on the machine than it has cores (OpenMP barriers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
IMG = 64


def _heads(rng, B=3):
    sizes = (4, 8, 16, 64)
    return [rng.normal(size=(B, s, s, 1)).astype(np.float32) * 3 for s in sizes]


@pytest.mark.parametrize("with_valid", [False, True])
def test_deep_supervision_loss_matches_jax(with_valid):
    """Heads upsampled to the mask's size, BCE + IoU per head, with and
    without a valid mask: rtol 1e-6, atol 1e-6."""
    rng = np.random.default_rng(int(with_valid))
    heads = _heads(rng)
    gt = (rng.random((3, 64, 64, 1)) > 0.5).astype(np.float32)
    valid = np.asarray([1, 1, 0], np.float32) if with_valid else None
    want = jloss.deep_supervision_loss([jnp.asarray(h) for h in heads], jnp.asarray(gt),
                                       None if valid is None else jnp.asarray(valid))
    got = tloss.deep_supervision_loss([torch.from_numpy(h) for h in heads], torch.from_numpy(gt),
                                      None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if with_valid:  # a padded row changes nothing
        no_pad = tloss.deep_supervision_loss([torch.from_numpy(h[:2]) for h in heads],
                                             torch.from_numpy(gt[:2]))
        np.testing.assert_allclose(got.item(), no_pad.item(), rtol=1e-6)


@pytest.mark.parametrize("h,H", [(4, 64), (8, 64), (24, 384), (5, 7)])
def test_bilinear_upsample_matches_jax_image_resize(h, H):
    """F.interpolate(bilinear, align_corners=False, antialias=False) is
    jax.image.resize(..., "bilinear") when upsampling: atol 1e-5."""
    x = np.random.default_rng(h).normal(size=(2, h, h, 1)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, H, H, 1), method="bilinear")
    got = tloss.resize_bilinear(torch.from_numpy(x), H, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_edge_weighted_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 40, 40, 1)).astype(np.float32) * 2
    mask = (rng.random((2, 40, 40, 1)) > 0.6).astype(np.float32)
    for jfn, tfn in ((jloss.structure_loss, tloss.structure_loss),
                     (jloss.weighted_bce, tloss.weighted_bce),
                     (jloss.bce_with_logits, tloss.bce_with_logits),
                     (jloss.iou_loss, tloss.iou_loss)):
        want = float(jfn(jnp.asarray(logits), jnp.asarray(mask)))
        got = tfn(torch.from_numpy(logits), torch.from_numpy(mask)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=jfn.__name__)


def _adam_pair(mu_dtype, rng, steps_per_epoch=1, decay=(2,), factors=(0.2,)):
    """The same parameters under optax (make_optimizer) and the port."""
    shapes = {"vssm_encoder": {"a": (3, 5), "b": (7,)}, "decoder": {"c": (4, 2)}}
    jparams = {g: {k: jnp.asarray(rng.normal(size=s).astype(np.float32)) for k, s in d.items()}
               for g, d in shapes.items()}
    tparams = {f"{g}.{k}": torch.nn.Parameter(torch.from_numpy(np.array(v)))
               for g, d in jparams.items() for k, v in d.items()}
    tx = joptim.make_optimizer(1e-2, list(decay), list(factors), steps_per_epoch,
                               mu_dtype=mu_dtype)
    opt = toptim.make_optimizer(tparams.items(), 1e-2, list(decay), list(factors),
                                steps_per_epoch, mu_dtype=getattr(torch, mu_dtype))
    return jparams, tparams, tx, opt


def _steps(jparams, tparams, tx, jstate, opt, rng, n):
    for _ in range(n):
        grads = {g: {k: rng.normal(size=v.shape).astype(np.float32) for k, v in d.items()}
                 for g, d in jparams.items()}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for g, d in grads.items():
            for k, v in d.items():
                tparams[f"{g}.{k}"].grad = torch.from_numpy(v)
        opt.step()
    return jparams, jstate


def _close_params(jparams, tparams, rtol):
    for g, d in jparams.items():
        for k, v in d.items():
            np.testing.assert_allclose(tparams[f"{g}.{k}"].detach().numpy(), np.asarray(v),
                                       rtol=rtol, atol=1e-7, err_msg=f"{g}.{k}")


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_adam_matches_optax_over_three_steps(mu_dtype):
    """optax.multi_transform of optax.adam(mu_dtype) with the encoder group at
    0.1x and a x0.2 decay at epoch 2 (the third step): parameters and moments
    after each step, rtol 1e-6."""
    rng = np.random.default_rng(0)
    jparams, tparams, tx, opt = _adam_pair(mu_dtype, rng)
    jstate = tx.init(jparams)
    for _ in range(3):
        jparams, jstate = _steps(jparams, tparams, tx, jstate, opt, rng, 1)
        _close_params(jparams, tparams, rtol=1e-6)
    assert opt.lr("encoder") == pytest.approx(1e-2 * 0.1 * 0.2) and opt.lr("rest") == \
        pytest.approx(1e-2 * 0.2)
    inner = jstate.inner_states["encoder"].inner_state[0]
    assert opt.mu["vssm_encoder.a"].dtype == getattr(torch, mu_dtype)
    np.testing.assert_allclose(opt.mu["vssm_encoder.a"].float().numpy(),
                               np.asarray(inner.mu["vssm_encoder"]["a"], np.float32), rtol=1e-6)
    np.testing.assert_allclose(opt.nu["vssm_encoder.b"].numpy(),
                               np.asarray(inner.nu["vssm_encoder"]["b"]), rtol=1e-6)


def test_fast_forward_schedule_matches_optax():
    """Weights-only resume at epoch 3 of a schedule decaying at epoch 2:
    fresh moments, schedule counters at 3 * steps_per_epoch, so the first
    resumed steps train at the decayed LR (rtol 1e-6)."""
    rng = np.random.default_rng(1)
    jparams, tparams, tx, opt = _adam_pair("bfloat16", rng, steps_per_epoch=2)
    jstate = joptim.fast_forward_schedule(tx.init(jparams), 6)
    toptim.fast_forward_schedule(opt, 6)
    assert opt.count == {"encoder": 0, "rest": 0}
    assert opt.lr("rest") == pytest.approx(1e-2 * 0.2)
    jparams, jstate = _steps(jparams, tparams, tx, jstate, opt, rng, 2)
    _close_params(jparams, tparams, rtol=1e-6)


def test_step_decay_factors_are_absolute():
    sched = toptim.step_decay_schedule(1.0, [2, 4], [0.5, 0.1], 3)
    assert [float(sched(s)) for s in (0, 5, 6, 11, 12, 100)] == pytest.approx(
        [1.0, 1.0, 0.5, 0.5, 0.1, 0.1])


def _jax_drop_rates(depths, dec_depths):
    """{block path: rate} of every DropPath the flax model calls."""
    rates = {}

    def icpt(next_fun, args, kwargs, context):
        m = context.module
        if isinstance(m, JDropPath) and context.method_name == "__call__":
            rates[".".join(m.scope.path[:-1])] = m.rate
        return next_fun(*args, **kwargs)

    model = JTrambaV(img_size=IMG, dims=16, enc_depths=depths, dec_depths=dec_depths)
    with fnn.intercept_methods(icpt):
        jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    return rates


def test_drop_path_rates_match_jax():
    """Every block's rate: encoder 0 -> 0.6 over (2, 2, 15, 2), decoder
    blocks 0.2 -> 0 by running index, guides 0."""
    depths, dec = (2, 2, 15, 2), (2, 2, 2, 2)
    want = _jax_drop_rates(depths, dec)
    model = build("Tramba-V-TSOD", IMG, seed=None, dims=16, enc_depths=depths, dec_depths=dec)
    got = {}
    for name, m in model.named_modules():
        if isinstance(m, DropPath):
            parts = name.split(".")[:-1]
            if parts[0] == "vssm_encoder":
                key = f"vssm_encoder.layers_{parts[2]}_block_{parts[4]}"
            elif parts[1] == "stage_layers":
                key = f"decoder.stage_{parts[2]}_block_{parts[4]}"
            else:
                key = f"decoder.guide_{parts[2]}"
            got[key] = m.rate
    assert got.keys() == want.keys() and len(got) == 21 + 6 + 3
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_drop_path_keep_rate_and_scaling():
    """train(): each sample kept with probability 1 - rate (within 4 sigma
    over 20000 samples) and scaled by 1 / (1 - rate); eval(): identity; the
    same generator seed draws the same mask."""
    m = DropPath(0.25)
    x = torch.ones(20000, 3, 2)
    gen = torch.Generator().manual_seed(1026)
    m.generator = gen
    y = m(x)
    kept = (y[:, 0, 0] != 0).float()
    assert abs(kept.mean().item() - 0.75) < 4 * (0.75 * 0.25 / 20000) ** 0.5
    assert torch.all((y == 0) | torch.isclose(y, torch.tensor(1 / 0.75)))
    assert torch.all(y == y[:, :1, :1])  # one draw per sample
    m.generator = torch.Generator().manual_seed(1026)
    assert torch.equal(m(x), y)
    m.eval()
    assert m(x) is x
    assert DropPath(0.0)(x) is x


def test_tiny_model_loss_and_grads_match_jax():
    """One tiny Tramba-V (dims 16, depths 1, 64 px), the same weights, image
    and mask: the deep-supervision loss (rtol 1e-5) and every parameter's
    gradient against jax.value_and_grad through the flax model
    (deterministic), per leaf ||port - jax|| <= 1e-4 ||jax||."""
    model = build("Tramba-V-TSOD", IMG, seed=0, **TINY)
    params = convert_tramba_v(state_dict_to_numpy(model.state_dict()),
                              enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    gt = (rng.random((2, IMG, IMG, 1)) > 0.5).astype(np.float32)
    jmodel = JTrambaV(img_size=IMG, **TINY)

    def jloss_fn(p):
        return jloss.deep_supervision_loss(jmodel.apply(p, jnp.asarray(x), deterministic=True),
                                           jnp.asarray(gt))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss_fn))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    model.eval()  # stochastic depth off, as deterministic=True
    loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        rel = (g - w).norm().item() / max(w.norm().item(), 1e-30)
        assert rel <= 1e-4, f"{name}: relative grad error {rel}"


def test_train_step_updates_and_eval_step_maps():
    model = build("Tramba-V-TSOD", IMG, seed=0, **TINY)
    set_drop_path_generator(model, torch.Generator().manual_seed(0))
    opt = toptim.make_optimizer(model.named_parameters(), 1e-3, [60], [0.2], 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, gts = torch.randn(2, IMG, IMG, 3), (torch.rand(2, IMG, IMG, 1) > 0.5).float()
    loss = train_step(model, opt, images, gts)
    assert loss.ndim == 0 and not loss.requires_grad and torch.isfinite(loss)
    assert model.training
    # every parameter gets a finite gradient; a branch that stochastic depth
    # dropped for every sample gets zeros and stays where it was
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) > len(before) // 2
    maps = eval_step(model, images)
    assert maps.shape == (2, IMG, IMG, 1) and not model.training
    assert float(maps.min()) >= 0 and float(maps.max()) <= 1


def test_checkpoint_round_trip(tmp_path):
    """Weights and the resume dict (weights, both Adam moments, counters,
    epoch) come back exactly; the best-MAE name parses back to its epoch."""
    model = build("Tramba-V-TSOD", IMG, seed=0, **TINY)
    opt = toptim.make_optimizer(model.named_parameters(), 1e-3, [60], [0.2], 1,
                                mu_dtype=torch.bfloat16)
    loss = tloss.deep_supervision_loss(model(torch.randn(1, IMG, IMG, 3)),
                                       torch.ones(1, IMG, IMG, 1))
    loss.backward()
    opt.step()
    path = ckpt.best_mae_path(str(tmp_path), "Tramba-V-TSOD", 0.123456, 6)
    assert os.path.basename(path) == "Tramba-V-TSOD_MAE_0.1235_7.pth"
    assert ckpt.epoch_from_filename(path) == 7
    ckpt.save_params(path, model)
    other = build("Tramba-V-TSOD", IMG, seed=1, **TINY)
    ckpt.load_checkpoint(other, path)
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                 model.state_dict().values()))
    ckpt.save_resume(str(tmp_path / "r.pth"), model, opt, 4)
    other = build("Tramba-V-TSOD", IMG, seed=1, **TINY)
    opt2 = toptim.make_optimizer(other.named_parameters(), 1e-3, [60], [0.2], 1,
                                 mu_dtype=torch.bfloat16)
    assert ckpt.load_resume(str(tmp_path / "r.pth"), other, opt2) == 5
    assert opt2.count == opt.count and opt2.sched_count == opt.sched_count
    for name in opt.mu:
        assert torch.equal(opt2.mu[name], opt.mu[name]) and torch.equal(opt2.nu[name],
                                                                        opt.nu[name])
        assert opt2.mu[name].dtype == torch.bfloat16


def _vmamba_checkpoint(model):
    """An upstream-VMamba-style classification checkpoint of the model's
    encoder: downsamples under layers.{i}.downsample, plus a classifier."""
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith("vssm_encoder."):
            continue
        k = k[len("vssm_encoder."):]
        if k.startswith("downsample."):
            _, i, rest = k.split(".", 2)
            k = f"layers.{i}.downsample.{rest}"
        sd[k] = v.clone()
    sd["classifier.head.weight"] = torch.zeros(10, 8)
    return {"model": sd}


def test_init_model_grafts_vmamba_encoder(tmp_path):
    """The encoder of a VMamba checkpoint lands on the port's names through
    the shared converter; a checkpoint that does not fit is fatal unless
    --allow_random_init."""
    src = build("Tramba-V-TSOD", IMG, seed=3, **TINY)
    torch.save(_vmamba_checkpoint(src), tmp_path / "vmamba.pth")
    model = build("Tramba-V-TSOD", IMG, seed=0, **TINY)
    dec_before = model.state_dict()["decoder.seg_layers.0.weight"].clone()
    args = type("A", (), dict(pretrained_path=str(tmp_path / "vmamba.pth"),
                              allow_random_init=False, method="Tramba-V-TSOD"))()
    init_model(args, model)
    for k, v in src.state_dict().items():
        if k.startswith("vssm_encoder."):
            assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.state_dict()["decoder.seg_layers.0.weight"], dec_before)
    big = build("Tramba-V-TSOD", IMG, seed=0, dims=32, enc_depths=(1, 1, 1, 1),
                dec_depths=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="allow_random_init"):
        init_model(args, big)
    args.allow_random_init = True
    init_model(args, big)


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


def test_run_cli_trains_evaluates_saves_and_resumes(tmp_path, monkeypatch, capsys):
    """``tramba_tpu_torch.run`` on a synthetic 4-image dataset, with the model
    cut to TINY: two epochs, in-loop eval at epoch 2 with the record and the
    best-MAE file; a weights-only ``--resume <best-MAE file>`` to epoch 5,
    which writes the rolling resume dict (every 5 epochs, as the reference);
    then ``--resume last`` continues from epoch 6."""
    monkeypatch.setattr(loop, "build", functools.partial(build, **TINY))
    data = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    _write_split(data, "Train", 4, rng)
    _write_split(data, "Test", 3, rng)
    flags = ["--method", "Tramba-V-TSOD", "--data_root", data, "--evaluation_root", data,
             "--img_size", str(IMG), "--batch_size", "2", "--save_model", str(tmp_path / "res"),
             "--tf_log_path", "", "--pretrained_path", "", "--see", "2"]
    run.main(flags + ["--train_epochs", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "Epoch [002/002] loss" in out and "MAE:" in out
    save_dir = tmp_path / "res" / "Tramba-V-TSOD"
    best = [f for f in os.listdir(save_dir) if "_MAE_" in f]
    assert len(best) == 1 and best[0].endswith("_2.pth")
    assert not (save_dir / "Tramba-V-TSOD_resume.pth").exists()
    record = (tmp_path / "res" / "Record_Tramba-V-TSOD.txt").read_text()
    assert "Epoch:2||train_loss" in record and "End Training Record." in record

    # fresh Adam moments, the schedule fast-forwarded to epoch 2 (2 steps each)
    model, opt = run.main(flags + ["--train_epochs", "5", "--resume", str(save_dir / best[0])],
                          device="cpu")
    assert opt.count == {"encoder": 6, "rest": 6} and opt.sched_count == {"encoder": 10,
                                                                          "rest": 10}
    assert (save_dir / "Tramba-V-TSOD_resume.pth").exists()
    model, opt = run.main(flags + ["--train_epochs", "6", "--resume", "last"], device="cpu")
    assert "starting from epoch 6" in capsys.readouterr().out
    assert opt.count == {"encoder": 8, "rest": 8} and opt.sched_count == {"encoder": 12,
                                                                          "rest": 12}


# the encoder variants cut to size (tests/test_torch_encoders.py, test_torch_resnet.py),
# a graft checkpoint of each under the upstream names, and one that does not fit
VARIANTS = {
    "S": dict(file="swin_base_patch4_window12_384_22k.pth",
              cut=dict(enc_config=ENC_CUT["swin"], dec_depths=(1, 1, 1, 1)),
              misfit=dict(ENC_CUT["swin"], embed_dim=96)),
    "P": dict(file="pvt_v2_b4.pth",
              cut=dict(enc_config=ENC_CUT["pvt"], dec_depths=(1, 1, 1, 1)),
              misfit=dict(ENC_CUT["pvt"], embed_dims=(64, 64, 128, 192))),
    "R": dict(file="resnet50.pth",
              cut=dict(enc_config={"layers": (1, 1, 1, 1)}, dec_depths=(1, 1, 1)),
              misfit={"layers": (1, 2, 1, 1)}),
}


def _graft_file(method, seed, **cut):
    return upstream_encoder_state_dict(build(method, IMG, seed=seed, **cut))


@pytest.mark.parametrize("letter", ["S", "P", "R"])
def test_run_cli_grafts_each_encoder_variant(letter, tmp_path, monkeypatch, capsys):
    """``--pretrained_path auto`` resolves to the variant's released file
    under --pretrained_model and warns when it is missing; with the file
    there (a synthetic graft under the upstream key names) the CLI grafts it
    and trains the cut model an epoch on the CPU; a graft that does not fit
    is fatal unless --allow_random_init."""
    variant, method = VARIANTS[letter], f"Tramba-{letter}-TSOD"
    monkeypatch.setattr(loop, "build", functools.partial(build, **variant["cut"]))
    pre = tmp_path / "pretrained"
    pre.mkdir()
    args = run.parser().parse_args(["--method", method, "--pretrained_model", str(pre)])
    run.resolve_pretrained(args)
    assert args.pretrained_path is None and args.allow_random_init
    assert f"{pre / variant['file']} not found" in capsys.readouterr().out

    torch.save(_graft_file(method, 3, **variant["cut"]), pre / variant["file"])
    data = str(tmp_path / "data")
    _write_split(data, "Train", 4, np.random.default_rng(1))
    flags = ["--method", method, "--data_root", data, "--img_size", str(IMG), "--batch_size",
             "2", "--save_model", str(tmp_path / "res"), "--tf_log_path", "",
             "--pretrained_model", str(pre), "--see", "2", "--train_epochs", "1"]
    run.main(flags, device="cpu")
    out = capsys.readouterr().out
    assert f"Loaded pretrained encoder for {method} from {pre / variant['file']}" in out
    assert "Epoch [001/001] loss" in out

    misfit = dict(variant["cut"], enc_config=variant["misfit"])
    torch.save(_graft_file(method, 4, **misfit), pre / variant["file"])
    with pytest.raises(RuntimeError, match="allow_random_init"):
        run.main(flags, device="cpu")
    run.main(flags + ["--allow_random_init"], device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: could not load pretrained encoder" in out and "Epoch [001/001] loss" in out


def _detached(fn):
    """A stand-in for a CUDA launch: the plain result with no grad_fn, as a
    kernel that writes its output through ctypes returns it."""
    def launch(*args, **kwargs):
        launch.calls += 1
        out = fn(*args, **kwargs)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()

    launch.calls = 0
    return launch


def test_card_branch_carries_gradients(monkeypatch):
    """On the card, ss2d_full under autograd runs SS2DCore (K1 / K2 train
    variants forward, K8 backward) and K3 / K4 run inside autograd Functions:
    with the launches stubbed by detached plain results, the outputs keep a
    grad_fn and every input's gradient equals plain autograd's (rtol 1e-5)."""
    monkeypatch.setattr(tf, "on_card", lambda t: True)
    monkeypatch.setattr(te, "on_card", lambda t: True)
    stubs = {"ss2d_scan": _detached(tf.ss2d_scan_train_ref),
             "ss2d_merge": _detached(tf.ss2d_merge_train_ref),
             "ss2d_scan_bwd": _detached(tf.ss2d_scan_bwd_ref)}
    monkeypatch.setattr(tf, "ss2d_scan", lambda *a, emit: stubs["ss2d_scan"](*a))
    monkeypatch.setattr(tf, "ss2d_merge", lambda *a, emit_ysum: stubs["ss2d_merge"](*a))
    monkeypatch.setattr(tf, "ss2d_scan_bwd", stubs["ss2d_scan_bwd"])
    g = torch.Generator().manual_seed(0)
    K, H, D, R, dm = 8, 6, 16, 2, 8
    args = [torch.randn(2, H * H, D, generator=g), torch.randn(K, R + 2, D, generator=g) * 0.2,
            torch.randn(K, D, R, generator=g) * 0.3, torch.randn(K, D, generator=g) * 0.2,
            torch.randn(K, D, 1, generator=g) * 0.3, torch.randn(K, D, generator=g),
            1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g),
            0.2 * torch.randn(dm, D, generator=g)]
    card = [a.clone().requires_grad_(True) for a in args]
    plain = [a.clone().requires_grad_(True) for a in args]
    out = tf.ss2d_full(*card, "line", H, H)
    assert out.grad_fn is not None
    idx, inv = order_tables("line", H, H, 0, "cpu")
    want_out = tf.ss2d_merge_ref(tf.ss2d_scan_ref(plain[0], idx, *plain[1:6]), inv, *plain[6:])
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, card, cot)
    want = torch.autograd.grad(want_out, plain, cot)
    assert [s.calls for s in stubs.values()] == [1, 1, 1]
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=f"input {i}")

    launch = _detached(te.expand_ln_ref)
    monkeypatch.setattr(te, "_expand_ln_launch", launch)
    x = torch.randn(2, 3, 3, 8, generator=g, requires_grad=True)
    w = torch.randn(16, 8, generator=g, requires_grad=True)
    ln_w, ln_b = torch.ones(4, requires_grad=True), torch.zeros(4, requires_grad=True)
    y = te.expand_ln(x, w, ln_w, ln_b)
    assert y.grad_fn is not None and launch.calls == 1
    got = torch.autograd.grad(y.sum(), (x, w, ln_w, ln_b))
    want = torch.autograd.grad(te.expand_ln_ref(x, w, ln_w, ln_b).sum(), (x, w, ln_w, ln_b))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
