"""The bf16 training slice end to end on the CPU: a tiny bf16 Tramba-V's loss
and gradients against the JAX package, the card's autograd plumbing with the
launches stubbed, and the training CLI in bf16.

The whole-model gate is set by JAX alone: per parameter, ||port - jax|| <=
tol ||jax|| with tol = max(2e-2, 1.25 x sqrt(2) x JAX's own bf16-vs-fp32 gap
for that parameter), and the same rule for the loss.  In fp32 the two models
agree to 1e-4 relative norm per gradient (``tests/test_torch_train.py``),
so their bf16 distance is rounding noise.  The port and JAX round to bf16 at
other places in the unfused parts (the expands, the head, the DCT guides,
the prologue's backward) and sum in other orders, so each bf16 gradient is
its own draw of noise of about the size of JAX's gap, and two independent
draws of that size lie about sqrt(2) x one gap apart.  The port's own
bf16-vs-fp32 gap takes no part in the limit: a wrong bf16 gradient cannot
widen its own gate.  The test prints every parameter's rel / limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.compat.torch_weights import convert_tramba_v, state_dict_to_numpy
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch import run
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_prologue as tp
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables
from tramba_tpu_torch.train import loop
from tramba_tpu_torch.train import loss as tloss

TINY = dict(dims=64, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
IMG = 64
GATE, NOISE_FACTOR = 2e-2, 1.25 * 2 ** 0.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny, so their ops are small: on one thread they
    run as fast, and they do not stall when pytest's worker processes put more
    torch threads on the machine than it has cores (OpenMP barriers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def test_tiny_bf16_model_loss_and_grads_match_jax():
    """Dims 64 (d_inner 128, FFN hidden 256: the JAX kernels' shape gates
    pass), depths 1, 64 px, eval mode (no stochastic depth, as
    deterministic=True): the port's plain bf16 autograd against
    jax.value_and_grad of TrambaV(dtype=bfloat16, ssm_backend="pallas")."""
    model = build("Tramba-V-TSOD", IMG, device="cpu", seed=0, dtype=torch.bfloat16, **TINY)
    params = convert_tramba_v(state_dict_to_numpy(model.state_dict()),
                              enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    gt = (rng.random((2, IMG, IMG, 1)) > 0.5).astype(np.float32)

    def value_and_grads(jmodel):
        def f(p):
            return jloss.deep_supervision_loss(jmodel.apply(p, jnp.asarray(x), deterministic=True),
                                               jnp.asarray(gt))

        loss, grads = jax.jit(jax.value_and_grad(f))(params)
        return float(loss), params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                         grads))

    want_loss, want = value_and_grads(
        JTrambaV(img_size=IMG, dtype=jnp.bfloat16, ssm_backend="pallas", **TINY))
    fp32_loss, fp32 = value_and_grads(JTrambaV(img_size=IMG, **TINY))
    loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    loss_tol = max(GATE, NOISE_FACTOR * abs(want_loss - fp32_loss) / abs(fp32_loss))
    assert abs(loss.item() - want_loss) <= loss_tol * abs(want_loss), (loss.item(), want_loss)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    rows = []
    for name, w in want.items():
        g = got[name].grad
        assert g is not None and g.dtype == torch.float32, name
        tol = max(GATE, NOISE_FACTOR * _rel(w, fp32[name]))
        rel = _rel(g, w)
        rows.append((rel / tol, name, rel, tol))
    rows.sort(reverse=True)
    print("rel/tol  rel norm  limit  parameter")
    for ratio, name, rel, tol in rows:
        print(f"{ratio:.3f}  {rel:.3e}  {tol:.3e}  {name}")
    assert rows[0][0] <= 1.0, f"worst gradients (rel/tol, name, rel, tol): {rows[:5]}"

def _detached(fn):
    """A stand-in for a CUDA launch: the plain result with no grad_fn, as a
    kernel that writes its output through ctypes returns it."""
    def launch(*args, **kwargs):
        launch.calls += 1
        out = fn(*args, **kwargs)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()

    launch.calls = 0
    return launch


def test_card_branch_carries_bf16_gradients(monkeypatch):
    """On the card, K5-K7 under autograd run Prologue, LnMlp and LnDwmsMlp,
    and the bf16 SS2D runs SS2DCore.  With every launch stubbed by its
    detached plain version: the outputs keep a grad_fn, each backward runs
    once, the FFNs' gradients are exactly the plain adjoints' (K9 / K10's
    stand-ins), K5's exactly plain autograd's, and the SS2D's match plain
    autograd within bf16 (1e-2 of each gradient's largest magnitude: the
    adjoint rounds y_sum and g_y to bf16 and keeps w_out fp32, as JAX's)."""
    for mod in (tm, tp, tf):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
    stubs = {"_ln_mlp_launch": _detached(tm.ln_mlp_ref),
             "_ln_dwms_mlp_launch": _detached(tm.ln_dwms_mlp_ref),
             "ln_mlp_bwd": _detached(tm.ln_mlp_bwd_ref),
             "ln_dwms_mlp_bwd": _detached(tm.ln_dwms_mlp_bwd_ref)}
    for name, stub in stubs.items():
        monkeypatch.setattr(tm, name, stub)
    pro = _detached(tp.prologue_ref)
    monkeypatch.setattr(tp, "_prologue_launch", pro)
    ss2d = {"ss2d_scan": _detached(tf.ss2d_scan_train_ref),
            "ss2d_merge": _detached(tf.ss2d_merge_train_ref),
            "ss2d_scan_bwd": _detached(tf.ss2d_scan_bwd_ref)}
    monkeypatch.setattr(tf, "ss2d_scan", lambda *a, emit: ss2d["ss2d_scan"](*a))
    monkeypatch.setattr(tf, "ss2d_merge", lambda *a, emit_ysum: ss2d["ss2d_merge"](*a))
    monkeypatch.setattr(tf, "ss2d_scan_bwd", ss2d["ss2d_scan_bwd"])

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    d, hid = 16, 32

    def rnd(*shape, scale=0.3, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).requires_grad_(True)

    x = rnd(2, 5, 6, d, scale=1.0).detach().to(bf).requires_grad_(True)
    ln = [rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1)]
    fc = [rnd(hid, d), rnd(hid, scale=0.1)]
    convs = [t for n in (3, 5, 7) for t in (rnd(hid, 1, n, n), rnd(hid, scale=0.1))]
    fc2 = [rnd(d, hid), rnd(d, scale=0.1)]
    g = torch.randn(2, 5, 6, d, generator=gen).to(bf)
    for fn, ref, bwd_ref, stub, args in (
            (tm.ln_mlp, tm.ln_mlp_ref, tm.ln_mlp_bwd_ref, "ln_mlp_bwd", [x, *ln, *fc, *fc2]),
            (tm.ln_dwms_mlp, tm.ln_dwms_mlp_ref, tm.ln_dwms_mlp_bwd_ref, "ln_dwms_mlp_bwd",
             [x, *ln, *fc, *convs, *fc2])):
        out = fn(*args)
        assert out.grad_fn is not None and out.dtype == bf
        got = torch.autograd.grad(out, args, g)
        assert stubs[stub].calls == 1
        want = bwd_ref(args[0].detach(), g, *(a.detach() for a in args[1:-1]))
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == args[i].dtype and torch.equal(a, b.to(a.dtype)), f"{fn.__name__} {i}"

    w_in, k = rnd(32, d), rnd(32, 1, 3, 3)
    u = tp.prologue(x, *ln, w_in, k)
    assert u.grad_fn is not None and pro.calls == 1
    gu = torch.randn(u.shape, generator=gen).to(bf)
    got = torch.autograd.grad(u, (x, *ln, w_in, k), gu)
    want = torch.autograd.grad(tp.prologue_ref(x, *ln, w_in, k), (x, *ln, w_in, k), gu)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    K, H, D, R, dm = 8, 6, 32, 2, 16
    core = [rnd(K, R + 2, D, scale=0.2), rnd(K, D, R), rnd(K, D, scale=0.2),
            rnd(K, D, 1), rnd(K, D, scale=1.0), rnd(D, scale=0.1, shift=1.0),
            rnd(D, scale=0.1), rnd(dm, D, scale=0.2)]
    xs = torch.randn(2, H * H, D, generator=gen).to(bf).requires_grad_(True)
    out = tf.ss2d_full(xs, *core, "line", H, H)
    assert out.grad_fn is not None and out.dtype == bf
    cot = torch.randn(out.shape, generator=gen).to(bf)
    got = torch.autograd.grad(out, [xs, *core], cot)
    assert [s.calls for s in ss2d.values()] == [1, 1, 1]
    idx, inv = order_tables("line", H, H, 0, "cpu")
    plain = tf.ss2d_merge_ref(tf.ss2d_scan_ref(xs, idx, *core[:5]), inv, *core[5:7],
                              core[7].to(bf))
    want = torch.autograd.grad(plain, [xs, *core], cot)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-2 * b.float().abs().max().item(), f"SS2D input {i}: {err}"


def _write_split(root, split, n, rng):
    import os

    from PIL import Image

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


def test_run_cli_trains_bf16_evaluates_and_resumes(tmp_path, monkeypatch, capsys):
    """``tramba_tpu_torch.run --dtype bfloat16`` on the CPU (device="cpu"),
    the model cut to dims 16, depths 1: the model is bf16 with fp32
    parameters; two epochs with the in-loop eval and the best-MAE file, a
    weights-only resume to epoch 5 (which writes the resume dict), then
    ``--resume last``."""
    import os

    built = []

    def tiny_build(*a, **k):
        built.append(k["dtype"])
        return build(*a, **k, dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))

    monkeypatch.setattr(loop, "build", tiny_build)
    data = str(tmp_path / "data")
    rng = np.random.default_rng(1)
    _write_split(data, "Train", 4, rng)
    _write_split(data, "Test", 2, rng)
    flags = ["--method", "Tramba-V-TSOD", "--data_root", data, "--evaluation_root", data,
             "--img_size", str(IMG), "--batch_size", "2", "--save_model", str(tmp_path / "res"),
             "--tf_log_path", "", "--pretrained_path", "", "--see", "2", "--dtype", "bfloat16"]
    model, opt = run.main(flags + ["--train_epochs", "2"], device="cpu")
    out = capsys.readouterr().out
    assert built == [torch.bfloat16] and "Epoch [002/002] loss" in out and "MAE:" in out
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in model.parameters())
    save_dir = tmp_path / "res" / "Tramba-V-TSOD"
    best = [f for f in os.listdir(save_dir) if "_MAE_" in f]
    assert len(best) == 1 and best[0].endswith("_2.pth")
    model, opt = run.main(flags + ["--train_epochs", "5", "--resume", str(save_dir / best[0])],
                          device="cpu")
    assert opt.count == {"encoder": 6, "rest": 6}
    assert (save_dir / "Tramba-V-TSOD_resume.pth").exists()
    model, opt = run.main(flags + ["--train_epochs", "6", "--resume", "last"], device="cpu")
    assert "starting from epoch 6" in capsys.readouterr().out
    assert opt.count == {"encoder": 8, "rest": 8}
