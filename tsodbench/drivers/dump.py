"""Driver ``dump``: a closed loop of one caller, as ``eval/dump.py:52-54``
runs a batch: the batch's host frames copied in, ``model(images)``, the
full-resolution head ``.float()`` to the host.  The output check holds a
sample, drawn from the seed, of the window's batches to the reference.

Traffic keys: ``batch``, ``pool`` (distinct pinned host batches, in turn),
``warmup`` (batches), ``check_batches`` (the sample), ``ref_rows`` (the
reference's block of rows).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from tsodbench import runner, weights
from tsodbench.harness import Cell, verdict
from tsodbench.reference import model as ref
from tsodbench.runner import Run, Window, sub


def head_readings(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers a dump cell compares, from the program's full-resolution
    head ``got`` and the reference's ``want`` (B, H, W): the gap's L2 norm
    over the reference's, and its largest magnitude over the reference's
    standard deviation."""
    d = (got.double() - want.double())
    return {"head_rel_l2": (d.norm() / want.double().norm()).item(),
            "head_max_over_std": (d.abs().max() / want.double().std()).item()}


def reference_heads(cell: Cell, P: dict, images: torch.Tensor, quant=None) -> torch.Tensor:
    """The reference's full-resolution head (B, H, W) of ``images``, in blocks
    of ``ref_rows`` rows."""
    rows = cell.traffic["ref_rows"]
    out = []
    with torch.no_grad(), ref.exact_fp32():
        for i in range(0, images.shape[0], rows):
            out.append(ref.forward(ref.Ctx(quant), P, cell.config["model"],
                                   images[i:i + rows])[-1][..., 0].cpu())
    return torch.cat(out)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Run:
    tr, m = cell.traffic, cell.config["model"]
    B, n_pool = tr["batch"], tr["pool"]
    model = runner.build(cell, device)
    shapes = ref.param_shapes(m)
    model.load_state_dict(weights.draw(shapes, sub(seed, 0), device), strict=True)
    frames = weights.images(B, m["img_size"], sub(seed, 1), device, n_pool).cpu()
    pool = [f.pin_memory() if device.type == "cuda" else f.clone() for f in frames]
    del frames

    def step(host_frames):
        images = host_frames.to(device)
        heads = model(images)
        enqueued = time.perf_counter()
        return heads[-1][..., 0].float().cpu(), enqueued

    with torch.no_grad():
        for i in range(tr["warmup"]):
            step(pool[i % n_pool])
        runner.sync(device)
        runner.reset_peak(device)
        setup_s = time.perf_counter() - t0
        rng = random.Random(sub(seed, 4))
        kept, frame_s, enqueue_s = [], [], []
        with Window(traced, device) as w:
            while True:
                i = len(frame_s)
                t = time.perf_counter()
                with w.spans("tsodbench.dump.batch"):
                    out, enq = step(pool[i % n_pool])
                done = time.perf_counter()
                frame_s.append(done - t)
                enqueue_s.append(enq - t)
                # a uniform sample of the window's batches (reservoir)
                if len(kept) < tr["check_batches"]:
                    kept.append((i % n_pool, out))
                else:
                    j = rng.randrange(i + 1)
                    if j < tr["check_batches"]:
                        kept[j] = (i % n_pool, out)
                if done - w.t0 >= seconds:
                    break
            window_s = w.close()
            trace = w.trace()
    peak = runner.peak(device)
    n = len(frame_s)
    result = Run(cell, seconds, window_s, n * B, n,
                 {"setup_s": setup_s, "infer_img_per_s": n * B / window_s,
                  "frame_ms_p95": 1e3 * runner.p95(frame_s), "peak_mem_gib": peak / 2 ** 30},
                 {"frame": frame_s, "enqueue": enqueue_s}, runner.device_info(device, peak), n,
                 0, trace=trace)
    q = np.percentile(np.asarray(frame_s) * 1e3, [50, 90, 95, 99, 100])
    print(f"tsodbench: {n} batches of {B} in {window_s:.3f} s; frame ms p50 {q[0]:.3f} p90 "
          f"{q[1]:.3f} p95 {q[2]:.3f} (over {n} samples) p99 {q[3]:.3f} max {q[4]:.3f}",
          flush=True)
    del model
    runner.free(device)
    t = time.perf_counter()
    P = weights.draw(shapes, sub(seed, 0), device)
    worst, result.reference = {}, {"P": P, "frames": {}, "heads": {}}
    for p, got in kept:
        frames = pool[p].to(device)
        want = reference_heads(cell, P, frames)
        result.reference["frames"][p], result.reference["heads"][p] = frames, want
        for k, v in head_readings(got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    result.readings, result.check_s = worst, time.perf_counter() - t
    result.correct, result.checks = verdict(worst, cell.limits)
    return result


def controls(cell: Cell, result: Run, seed: int, device):
    """The control: the reference with every product operand rounded to fp8,
    in the program's place, on the batches the run compared."""
    r, worst = result.reference, {}
    for p, frames in r["frames"].items():
        got = reference_heads(cell, r["P"], frames, quant=ref.fp8)
        for k, v in head_readings(got, r["heads"][p]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    yield "control fp8", worst
