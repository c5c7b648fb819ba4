"""The port's parallel layer on gloo worlds of 2 and 4 CPU processes, against
the JAX package.

Each world size is one set of processes (``parallel.distributed.spawn``)
that runs every check of that size (``torch_parallel_cases.run_all``); the
JAX references run here, on the 8-device virtual CPU mesh of
``conftest.py``.  Inputs come from numpy seeds.  Tolerances:

* the sequence-parallel scan against the single plain scan (and its
  autograd): 1e-5, the carry algebra reorders fp32 products;
* ``ss2d_tensor_parallel`` against JAX's tensor-parallel SS2D on a mesh of
  4 (``tests/test_parallel.py:124-146``'s cases): 2e-5, the all-reduces and
  psums sum the partials in other orders; its gradients against JAX's VJP
  there: 1e-4 (x), 1e-4 relative norm per parameter;
* a tiny Tramba-V on each backend against JAX's composed model: 2e-4;
* the loss (rtol 1e-5) and every parameter's gradient of one step of each
  dry-run grid against ``jax.value_and_grad``: 1e-4 relative norm;
* the training CLI over two processes against one: 1e-5 on every weight;
* one data-parallel ``train()`` step of a tiny Tramba-R over two processes
  against one process's step on the whole batch (BatchNorm on the global
  batch's statistics, as JAX's SPMD step): the loss at rtol 1e-5, every
  running statistic at 1e-4 relative norm, every gradient at 1e-4 or, where
  the gradient's own fp32 spread is larger (the same step on the batch in
  another order moves the encoder's by up to ~1.5e-2), 1.25 x that spread.
"""

import concurrent.futures
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_cases as cases
from tramba_tpu.compat.torch_weights import convert_tramba_v, state_dict_to_numpy
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu.nn.ssm import SS2D as JSS2D
from tramba_tpu.parallel.tp import use_tensor_mesh
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch import run
from tramba_tpu_torch.compat.jax_weights import params_from_jax, ss2d_from_jax, ss2d_to_jax
from tramba_tpu_torch import dryrun
from tramba_tpu_torch.dryrun import PHASES, phase_grids
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.init import init_weights
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops.selective_scan import linear_scan_ref
from tramba_tpu_torch.parallel.distributed import spawn
from tramba_tpu_torch.train import loop
from tramba_tpu_torch.train.loss import deep_supervision_loss

# (order, rate / window, directions) of tests/test_parallel.py:124-146
TP_KINDS = (("raster", 0, 4), ("window", 4, 4), ("line", 0, 8))
PHASE_NAMES = [name for name, _ in PHASES]


def _model_cfgs(world):
    """(name, backend, (model, seq)) of the dry run's four grids at ``world``."""
    return [(name, backend, shape) for (name, backend), shape in zip(PHASES, phase_grids(world))]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    return (got - want).norm().item() / max(want.norm().item(), 1e-30)


def _scan_inputs(world):
    rng = np.random.default_rng(world)
    shape = (2, 3, 48, 20)
    a = np.exp(-rng.uniform(0.0, 0.1, shape)).astype(np.float32)
    return [_t(a)] + [_t(rng.normal(size=shape).astype(np.float32)) for _ in range(2)]


def _ss2d_state(kw, rng):
    """An SS2D's weights: its own parameters as the seeded init draws them
    (A, D, dt), the projections, conv and out-norm from ``rng`` at fan-in
    scale, so that every parameter's gradient is exercised."""
    m = init_weights(SS2D(**kw), torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    sd = m.state_dict()
    for name in ("in_proj.weight", "conv2d.weight", "out_proj.weight"):
        w = sd[name]
        bound = w[0].numel() ** -0.5
        sd[name] = _t(rng.uniform(-bound, bound, w.shape).astype(np.float32))
    sd["out_norm.weight"] = _t((rng.normal(size=sd["out_norm.weight"].shape) * 0.1 + 1)
                               .astype(np.float32))
    sd["out_norm.bias"] = _t((rng.normal(size=sd["out_norm.bias"].shape) * 0.1)
                             .astype(np.float32))
    return sd


def _tp_inputs():
    """Each order's SS2D keywords, weights, input, pre-norm and cotangent."""
    rng = np.random.default_rng(5)
    out = []
    for kind, param, K in TP_KINDS:
        x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
        ln = [(rng.normal(size=(16,)) * 0.1 + 1).astype(np.float32),
              (rng.normal(size=(16,)) * 0.1).astype(np.float32)]
        g = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
        kw = dict(d_model=16, scan_kind=kind, scan_param=param, k_group=K)
        out.append((kw, _ss2d_state(kw, rng), _t(x), tuple(_t(v) for v in ln), _t(g)))
    return out


def _tp_want(inputs):
    """JAX's tensor-parallel SS2D output and VJP on a mesh of 4 for each case,
    which both world sizes are held to (a mesh of 2 differs from it by the
    order of the psums' sums only)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    want = []
    for kw, sd, x, ln, g in inputs:
        jln = tuple(jnp.asarray(v.numpy()) for v in ln)
        tp = JSS2D(backend="tensor_parallel", **kw)

        def fwd_bwd(v, a, ct):
            y, vjp = jax.vjp(lambda v, a: tp.apply(v, a, ln=jln), v, a)
            return (y,) + vjp(ct)

        with use_tensor_mesh(mesh, "model"):
            y, dv, dx = jax.jit(fwd_bwd)({"params": ss2d_to_jax(sd, kw["k_group"])},
                                         jnp.asarray(x.numpy()), jnp.asarray(g.numpy()))
        want.append((np.asarray(y), np.asarray(dx), ss2d_from_jax(jax.tree.map(np.asarray, dv))))
    return want


def _tiny_inputs():
    """The tiny Tramba-V's seed-0 weights and a batch of 4.  The masks are
    30% foreground: at 50% the head biases' gradients (sums of
    sigmoid(logit) - mask over every pixel) cancel to ~1e-4 of their terms,
    and fp32 summation noise alone then reaches 1e-4 of their norm."""
    sd = build("Tramba-V-TSOD", cases.IMG, device="cpu", seed=0, **cases.TINY).state_dict()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, cases.IMG, cases.IMG, 3)).astype(np.float32)
    gt = (rng.random((4, cases.IMG, cases.IMG, 1)) > 0.7).astype(np.float32)
    return dict(sd=sd, x=_t(x), gt=_t(gt))


def _tiny_want(tiny):
    """JAX's heads, loss and gradients (composed route, deterministic) of the
    tiny Tramba-V on the whole batch."""
    params = convert_tramba_v(state_dict_to_numpy(tiny["sd"]),
                              enc_depths=cases.TINY["enc_depths"],
                              dec_depths=cases.TINY["dec_depths"])
    x, gt = jnp.asarray(tiny["x"].numpy()), jnp.asarray(tiny["gt"].numpy())
    jmodel = JTrambaV(img_size=cases.IMG, ssm_backend="assoc", **cases.TINY)

    def loss_fn(p):
        heads = jmodel.apply(p, x, deterministic=True)
        return jloss.deep_supervision_loss(heads, gt), heads

    (loss, heads), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(loss=float(loss), heads=[np.asarray(h) for h in heads],
                grads=params_from_jax(jax.tree.map(np.asarray, grads)))


def _resnet_inputs():
    """A batch of 4 and a tiny Tramba-R's seed-0 weights, as numpy arrays:
    sent to a process, each tensor of a state dict this long would pass the
    fork server one file descriptor, past its limit."""
    sd = {k: v.numpy() for k, v in
          build("Tramba-R-TSOD", cases.IMG_R, device="cpu", seed=0, **cases.TINY_R).state_dict().items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, cases.IMG_R, cases.IMG_R, 3)).astype(np.float32)
    gt = (rng.random((4, cases.IMG_R, cases.IMG_R, 1)) > 0.7).astype(np.float32)
    return _t(x), _t(gt), sd


def _resnet_step(x, gt, sd):
    """One process's ``train()`` step of the tiny Tramba-R on the batch
    ``x``: its loss, every parameter's gradient and the BatchNorms' running
    statistics after it.  It runs on one torch thread, as each process
    does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = build("Tramba-R-TSOD", cases.IMG_R, device="cpu", seed=None, **cases.TINY_R).train()
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    loss = deep_supervision_loss(model(x), gt)
    loss.backward()
    torch.set_num_threads(threads)
    stats = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, stats


def _resnet_want(x, gt, sd):
    """JAX's global-batch ``train()`` step, which DDP over two processes must
    compute: one process's step on the whole batch of 4 (BatchNorm on the
    statistics of all four images).  Stage 4's parameters, frozen, get no
    gradient.  Also each gradient's spread in fp32: its largest relative
    change when the same step takes the batch in two other orders.  In
    ``train()`` the encoder's gradients are small sums of large terms that
    nearly cancel (BatchNorm makes the loss blind to each conv's scale), and
    a reordered batch moves them by up to ~1.5e-2 of their norm at these
    inputs; any other summation order, the all-reduce's among them, may
    move them as far."""
    loss, grads, stats = _resnet_step(x, gt, sd)
    spread = dict.fromkeys(grads, 0.0)
    for perm in ([2, 3, 0, 1], [1, 0, 3, 2]):
        _, other, _ = _resnet_step(x[perm], gt[perm], sd)
        for n, g in grads.items():
            if g is not None:
                spread[n] = max(spread[n], _rel(other[n], g))
    return loss, grads, stats, spread


@pytest.fixture(scope="module")
def runs():
    """A gloo world of 2 processes (the scan and the tensor-parallel SS2Ds)
    and one of 4 (those, and the tiny model in each dry-run grid), each
    started once, in a thread while this process computes JAX's references
    for them."""
    tp_inputs, tiny, resnet = _tp_inputs(), _tiny_inputs(), _resnet_inputs()
    # sending a tensor to a process moves its storage into shared memory, in
    # place: the worlds get copies, so JAX here never reads a storage that
    # the thread is moving
    sent_tp, sent_tiny, sent_resnet = copy.deepcopy(
        (tp_inputs, (tiny["sd"], tiny["x"], tiny["gt"]), resnet))

    def both_worlds():
        return {n: spawn(cases.run_all, n, "cpu", _scan_inputs(n), sent_tp, cfgs, sent_tiny,
                         sent_resnet if n == 2 else None)
                for n, cfgs in ((2, []), (4, _model_cfgs(4)))}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(both_worlds)
        tp_want = _tp_want(tp_inputs)
        tiny.update(_tiny_want(tiny))
        resnet_want = _resnet_want(*resnet)
        got = got.result()
    return dict(worlds={n: dict(n=n, got=g, tp_want=tp_want) for n, g in got.items()}, tiny=tiny,
                resnet_want=resnet_want)


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def tiny(runs):
    return runs["tiny"]


@pytest.fixture(params=[2, 4])
def world(request, worlds):
    return worlds[request.param]


def test_sequence_parallel_scan_matches_single_scan(world):
    """L split over the world: every rank holds the full h and the full
    gradients of a and b, equal to the single plain scan's."""
    a, b, g = _scan_inputs(world["n"])
    a, b = a.requires_grad_(True), b.requires_grad_(True)
    h = linear_scan_ref(a, b)
    h.backward(g)
    for rank, res in enumerate(world["got"]):
        got_h, got_da, got_db, launches = res["seq"]
        assert launches == 0  # CPU tensors: the plain version, no K14 launch
        for name, got, want in (("h", got_h, h), ("da", got_da, a.grad), ("db", got_db, b.grad)):
            torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"rank {rank} {name}: {m}")


@pytest.mark.parametrize("case", range(len(TP_KINDS)), ids=[k for k, _, _ in TP_KINDS])
def test_ss2d_tensor_parallel_matches_jax(world, case):
    """d_inner over the world: each rank's output equals JAX's tensor-parallel
    SS2D on the virtual mesh, and so do the gradients of x and of
    every parameter, which the split's backward gathers whole on every
    rank."""
    y, dx, dparams = world["tp_want"][case]
    for rank, res in enumerate(world["got"]):
        got_y, got_dx, got_dp = res["tp"][case]
        np.testing.assert_allclose(got_y.numpy(), y, rtol=2e-5, atol=2e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got_dx.numpy(), dx, rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {rank}")
        assert got_dp.keys() == dparams.keys()
        for name, w in dparams.items():
            assert _rel(got_dp[name], w) <= 1e-4, f"rank {rank} {name}"


@pytest.mark.parametrize("name", PHASE_NAMES[1:])
def test_tiny_model_backends_match_jax(worlds, tiny, name):
    """Every SS2D of a tiny Tramba-V on ``tensor_parallel``, ``seq_parallel``
    or ``hybrid_tp_sp`` (8 x 8 maps sequence-parallel, the rest tensor-
    parallel) in the dry run's grid at 4 processes: each rank's heads for
    its slice of the batch against JAX's."""
    _, _, (n_model, n_seq) = next(c for c in _model_cfgs(4) if c[0] == name)
    per = n_model * n_seq  # images per data rank: 4 over 4 / (model x seq)
    for rank, res in enumerate(worlds[4]["got"]):
        d = rank // (n_model * n_seq)
        for i, (got, want) in enumerate(zip(res["models"][name][0], tiny["heads"])):
            np.testing.assert_allclose(got.numpy(), want[d * per:(d + 1) * per], rtol=2e-4,
                                       atol=2e-4, err_msg=f"{name} rank {rank} head {i}")


@pytest.mark.parametrize("name", PHASE_NAMES)
def test_train_step_grads_match_jax(worlds, tiny, name):
    """One step in each dry-run grid at 4 processes (DDP over the data group;
    parameter slices gathered over the model group): the global loss and, on
    every rank, every parameter's gradient against jax.value_and_grad on the
    whole batch."""
    for rank, res in enumerate(worlds[4]["got"]):
        _, loss, grads = res["models"][name]
        np.testing.assert_allclose(loss, tiny["loss"], rtol=1e-5)
        assert grads.keys() == tiny["grads"].keys()
        for pname, w in tiny["grads"].items():
            assert grads[pname] is not None, pname
            rel = _rel(grads[pname], w)
            assert rel <= 1e-4, f"{name} rank {rank} {pname}: relative grad error {rel}"


def test_tramba_r_data_parallel_step_matches_one_process(runs):
    """A tiny Tramba-R through DDP over two processes against one process's
    step on the whole batch (JAX's global-batch step): its BatchNorms
    all-reduce their moments over the data group, so the global loss, every
    gradient (to 1e-4 of its norm, or 1.25 x its own spread under a
    reordered batch where that is larger) and every running statistic
    match; its stage 4, which feeds no
    head, is frozen and stays out of DDP's reducer, and a second step runs (a
    parameter the reducer waits for in vain makes DDP's next forward raise)."""
    want_loss, want, want_stats, spread = runs["resnet_want"]
    assert {n for n, g in want.items() if g is None} == {
        n for n in want if n.startswith("encoder.layer4.")}
    for rank, res in enumerate(runs["worlds"][2]["got"]):
        losses, grads, stats = res["resnet"]
        np.testing.assert_allclose(losses[0], want_loss, rtol=1e-5)
        assert np.isfinite(losses[1])
        assert grads.keys() == want.keys() and stats.keys() == want_stats.keys()
        for name, w in want.items():
            if w is None:
                assert grads[name] is None, name
                continue
            rel, tol = _rel(grads[name], w), max(1e-4, 1.25 * spread[name])
            assert rel <= tol, f"rank {rank} {name}: relative grad error {rel} > {tol}"
        for name, w in want_stats.items():
            rel = _rel(stats[name], w)
            assert rel <= 1e-4, f"rank {rank} {name}: relative running-statistic error {rel}"


def _write_split(root, split, n, rng):
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


def test_run_cli_data_parallel_matches_one_process(tmp_path, monkeypatch):
    """``tramba_tpu_torch.run`` over two gloo processes (TRAMBA_NUM_PROCESSES,
    TRAMBA_PROCESS_ID, ``--init_method file://``), 2 epochs of a global batch
    of 2 on 4 images, trains the weights one process trains."""
    data = str(tmp_path / "data")
    _write_split(data, "Train", 4, np.random.default_rng(0))
    flags = ["--method", "Tramba-V-TSOD", "--data_root", data, "--img_size", str(cases.IMG),
             "--batch_size", "2", "--tf_log_path", "", "--pretrained_path", "", "--see", "99",
             "--train_epochs", "2", "--parallel"]
    monkeypatch.setattr(loop, "build", functools.partial(
        build, enc_drop_path=0.0, dec_drop_path=0.0, **cases.TINY))
    one, _ = run.main(flags + ["--save_model", str(tmp_path / "one")], device="cpu")
    out = str(tmp_path / "dp.pt")
    torch.multiprocessing.start_processes(
        cases.run_cli, nprocs=2, join=True, start_method="forkserver",
        args=(2, f"file://{tmp_path}/rendezvous", flags + ["--save_model", str(tmp_path / "dp")],
              out))
    dp = torch.load(out)
    for k, v in one.state_dict().items():
        torch.testing.assert_close(dp[k], v, rtol=1e-5, atol=1e-5, msg=lambda m: f"{k}: {m}")


def test_training_refuses_a_batch_that_does_not_divide(monkeypatch):
    """--batch_size is the global batch: 3 over 2 data-parallel processes
    raises before any work (JAX falls back to one device there)."""
    from tramba_tpu_torch.parallel import mesh

    solo = mesh.Axis(None, 0, 1)
    monkeypatch.setattr(loop, "make_grid", lambda: mesh.Grid(mesh.Axis(None, 0, 2), solo, solo))
    with pytest.raises(ValueError, match="global batch"):
        loop.training(type("Args", (), dict(batch_size=3))(), device="cpu")


def test_dryrun_cli_runs_every_phase(capsys):
    """``python -m tramba_tpu_torch.dryrun --n 4 --device cpu`` (its main, in
    this process; the four ranks are new processes): one step in each of the
    four grids, as ``__graft_entry__.dryrun_multichip`` shapes them."""
    phases = dryrun.main(["--n", "4", "--device", "cpu"])
    grids = [(r["name"], r["data"], r["model"], r["seq"]) for r in phases]
    assert grids == [("dp", 4, 1, 1), ("dp x tp", 2, 2, 1), ("dp x sp", 2, 1, 2),
                     ("dp x tp x sp", 1, 2, 2)]
    assert all(np.isfinite(r["loss"]) for r in phases)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun(4, cpu)")]
    assert len(lines) == 4
