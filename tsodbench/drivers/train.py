"""Driver ``train``: closed-loop ``train_step`` with the Adam of
``train/optim.make_optimizer`` as ``train/loop.fit`` builds it, DropPath
drawing from a generator the benchmark seeds.

Set-up builds the model and the optimizer once and warms them up; then it
starts them again from the seed on the same objects (the weights loaded in
place, the optimizer's state as it stood before its first step, the
DropPath generator seeded again), so that the window's own first
``check_steps`` steps, on batches that all differ, are the ones the
reference follows: their losses, the first gradient as the optimizer's
state holds it after one step, and the parameters after the last of them.

Traffic keys: ``batch``, ``pool`` (distinct device batches, in turn),
``warmup_steps``, ``check_steps``, ``lr``, ``encoder_lr_scale``, ``mu_dtype``,
``decay_epochs``, ``decay_factors``, ``steps_per_epoch``, ``ref_rows``.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Sequence

import torch

from tsodbench import counts, runner, weights
from tsodbench.harness import Cell, verdict
from tsodbench.reference import model as ref
from tsodbench.reference import train as ref_train
from tsodbench.runner import Run, Window, sub
from tsodbench.trace import Spans

OPTIM_RANGE = "tsodbench.optim_step"


def leaf_gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def train_readings(prog: dict, want: dict, P0: dict) -> dict:
    """The numbers a train cell compares: the first step's loss gap over the
    reference's loss, the worst leaf's gap of the first gradient's norm, and
    the worst leaf's gap of the parameters' change over the steps, leaving
    out leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone).  ``loss_gap``, the worst step's,
    is read but not compared: after Adam's first, sign-like updates it
    swings from seed to seed in sound runs (PERF.md, PR 20)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"])]
    g = want["grad_norm"]
    med = statistics.median(g.values())
    moved = [n for n in g if g[n] >= 1e-3 * med]
    change = lambda ps: {n: (ps[n].double().to(P0[n].device) - P0[n].double()).norm().item()
                         for n in moved}
    return {"loss_gap_first_step": gaps[0], "loss_gap": max(gaps), "loss_gap_steps": gaps,
            "grad_norm_gap": leaf_gap(prog["grad_norm"], g, list(g)),
            "param_change_gap": leaf_gap(change(prog["params"]), change(want["params"]), moved)}


def reference_steps(cell: Cell, P0: dict, batches, seed: int, quant=None, keep_rows=None,
                    frozen: Sequence[str] = ()):
    tr = cell.traffic
    return ref_train.run(cell.config["model"], P0, batches, tr["check_steps"],
                         counts.drop_rates(cell.config["model"]), sub(seed, 3), tr["lr"],
                         tr["encoder_lr_scale"], tr["ref_rows"], quant, keep_rows, frozen)


def _copy(state, device):
    """A copy of a nested state (dicts, lists, tensors, numbers) with every
    tensor on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device, copy=True)
    if isinstance(state, dict):
        return {k: _copy(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_copy(v, device) for v in state)
    return state


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Run:
    from tramba_tpu_torch.nn.layers import set_drop_path_generator
    from tramba_tpu_torch.train import optim, step as step_mod

    tr, m = cell.traffic, cell.config["model"]
    B, n_pool, checked = tr["batch"], tr["pool"], tr["check_steps"]
    model = runner.build(cell, device)
    shapes = ref.param_shapes(m)
    model.load_state_dict(weights.draw(shapes, sub(seed, 0), device), strict=True)
    opt = optim.make_optimizer(model.named_parameters(), tr["lr"], tr["decay_epochs"],
                               tr["decay_factors"], tr["steps_per_epoch"],
                               tr["encoder_lr_scale"], mu_dtype=getattr(torch, tr["mu_dtype"]))
    fresh = _copy(opt.state_dict(), "cpu")  # the optimizer before its first step
    adam_step, spans = opt.step, Spans()

    def timed_step():
        with spans(OPTIM_RANGE):
            adam_step()

    opt.step = timed_step
    drop_gen = torch.Generator(device=device).manual_seed(sub(seed, 3))
    set_drop_path_generator(model, drop_gen)
    images = weights.images(B, m["img_size"], sub(seed, 1), device, n_pool)
    gts = weights.masks(B, m["img_size"], sub(seed, 2), device, n_pool)
    valid = torch.ones(B, device=device)
    for s in range(tr["warmup_steps"]):
        step_mod.train_step(model, opt, images[s % n_pool], gts[s % n_pool], valid)
    # start again from the seed, on the same objects
    model.load_state_dict(weights.draw(shapes, sub(seed, 0), device), strict=True)
    opt.load_state_dict(_copy(fresh, device))
    drop_gen.manual_seed(sub(seed, 3))
    named = list(model.named_parameters())
    flat = torch.empty(sum(p.numel() for _, p in named), pin_memory=device.type == "cuda")
    after, at = {}, 0
    for n, p in named:
        after[n] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    runner.sync(device)
    runner.reset_peak(device)
    setup_s = time.perf_counter() - t0
    losses, enqueue_s = [], []
    with Window(traced, device) as w:
        w.spans = spans
        while True:
            it = len(losses)
            t = time.perf_counter()
            with spans("tsodbench.train.step"):
                losses.append(step_mod.train_step(model, opt, images[it % n_pool],
                                                  gts[it % n_pool], valid))
            enqueue_s.append(time.perf_counter() - t)
            # queued behind the step on the card's stream, before the next step
            if it == 0:  # nu = (1 - b2) g^2 after one step
                nu = opt.state_dict()["nu"]
                nu_names = list(nu)
                nu_sums = torch.stack(torch._foreach_norm([nu[n] for n in nu_names], 1))
            if it == checked - 1:
                for n, p in named:
                    after[n].copy_(p.detach(), non_blocking=True)
            if it + 1 >= checked and time.perf_counter() - w.t0 >= seconds:
                break
        window_s = w.close()
        trace = w.trace(ranges=(OPTIM_RANGE,))
    peak = runner.peak(device)
    steps = len(losses)
    values = torch.stack(losses).float().cpu()
    failed = int((~torch.isfinite(values)).sum())
    result = Run(cell, seconds, window_s, steps * B, steps,
                 {"setup_s": setup_s, "train_img_per_s": steps * B / window_s,
                  "peak_mem_gib": peak / 2 ** 30},
                 {"enqueue": enqueue_s}, runner.device_info(device, peak), steps, failed,
                 trace=trace)
    print(f"tsodbench: {steps} steps of {B} in {window_s:.3f} s", flush=True)
    grad_norm = (nu_sums.double().cpu() / (1 - ref_train.B2)).sqrt().tolist()
    prog = {"loss": values[:checked].tolist(), "grad_norm": dict(zip(nu_names, grad_norm)),
            "params": after}
    del model, opt, adam_step, losses, nu
    runner.free(device)
    t = time.perf_counter()
    P0 = weights.draw(shapes, sub(seed, 0), device)
    batches = [(images[s], gts[s]) for s in range(checked)]
    want = reference_steps(cell, P0, batches, seed)
    result.readings, result.check_s = train_readings(prog, want, P0), time.perf_counter() - t
    result.reference = {"P0": P0, "batches": batches, "want": want}
    result.correct, result.checks = verdict(result.readings, cell.limits)
    result.correct = result.correct and failed == 0
    return result


def controls(cell: Cell, result: Run, seed: int, device):
    """The control (the reference with every product operand rounded to fp8)
    and three faults planted in the reference put in the program's place:
    each step's loss altered by 5% where it is produced; half of the batch
    left out, the mean over the rest; Adam leaving every 1-D leaf (norms,
    biases) unchanged."""
    r = result.reference
    ctrl = reference_steps(cell, r["P0"], r["batches"], seed, quant=ref.fp8)
    yield "control fp8", train_readings(ctrl, r["want"], r["P0"])
    got = dict(r["want"], loss=[1.05 * v for v in r["want"]["loss"]])
    yield "fault loss altered", train_readings(got, r["want"], r["P0"])
    half = torch.arange(cell.traffic["batch"] // 2, device=device)
    got = reference_steps(cell, r["P0"], r["batches"], seed, keep_rows=half)
    yield "fault half batch", train_readings(got, r["want"], r["P0"])
    flat = [n for n, p in r["P0"].items() if p.ndim == 1]
    got = reference_steps(cell, r["P0"], r["batches"], seed, frozen=flat)
    yield "fault Adam skips 1-D leaves", train_readings(got, r["want"], r["P0"])
