"""Accounting and timing: parameters, FLOPs, the inference-speed harness,
device traces and the device time of a forward by kernel.

Port of ``tramba_tpu/utils/profiling.py``.  ``count_params`` and the
reference's analytic FLOP model: ``selective_scan_flops`` (csms6s.py:772-793)
and ``analytic_model_flops``, fvcore's accounting (2MNK for every matrix
product and convolution) plus 9 operations per scanned state element, as
the JAX package counts them from a jaxpr; here ``torch.utils.flop_counter``
counts the products of a forward of the plain versions on the CPU, and the
plain scan's one ``addcmul`` per step stands for the scan handle.
``measure_inference_speed`` (:134, test_TSOD.py:71-108) times on the card
with CUDA events; a call whose inputs are not on a CUDA device raises, since
its number would not be the card's.  ``trace`` writes a ``torch.profiler``
trace.  ``device_time_by_kernel`` sums the device time of each kernel name
that ``torch.profiler`` records over a few calls, telling apart the launches
made inside the ``record_function`` ranges it is given.  XLA's own cost
model (``cost_analysis``) has no meaning here.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import torch

__all__ = ["count_params", "selective_scan_flops", "analytic_model_flops",
           "measure_inference_speed", "trace", "device_time_by_kernel"]


def count_params(model: torch.nn.Module) -> int:
    """The number of parameter elements of ``model`` (buffers not counted,
    as flax keeps BatchNorm statistics out of ``params``)."""
    return sum(p.numel() for p in model.parameters())


def selective_scan_flops(B: int, L: int, D: int, N: int = 1, with_D: bool = True,
                         with_Z: bool = False) -> int:
    """The reference's analytic scan FLOP model: 9*B*L*D*N (csms6s.py:772-793)."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L * 3
    return flops


def _scan_step_flops(b_shape, a_shape, h_shape, *args, out_shape=None, **kwargs) -> int:
    # one step of the plain recurrence h_t = a_t h_{t-1} + b_t: the
    # reference's 9 operations per scanned state element
    return 9 * math.prod(out_shape)


def _mv_flops(a_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    # a matrix-vector product (torch's counter has no formula for it): the
    # plain K4 head's per-slot sum over C, JAX's 1x1 convolution
    return 2 * a_shape[0] * a_shape[1]


@torch.no_grad()
def analytic_model_flops(fn: Callable, *args) -> dict:
    """fvcore-style required-FLOP count of ``fn(*args)``: 2MNK for every
    matrix product and convolution (``matmul_conv_flops``) plus 9 operations
    per scanned state element of every recurrence (``scan_handle_flops``;
    9 B K L D N for an SS2D), as ``tramba_tpu/utils/profiling.py:115``
    counts them.  ``fn`` runs once on the CPU, where every wrapper takes its
    plain version, so no product hides in a native kernel and none is
    launched: ``args`` and ``fn``'s parameters must be CPU tensors.
    Elementwise work is not counted (fvcore's accounting), and neither are
    gathers: the JAX package spells the line orders' gathers as one-hot
    products and counts those too."""
    from torch.utils.flop_counter import FlopCounterMode

    if any(torch.is_tensor(a) and a.device.type != "cpu" for a in args):
        raise ValueError("analytic_model_flops counts a forward of the plain versions: "
                         "pass CPU tensors")
    step = torch.ops.aten.addcmul
    formulas = {step: _scan_step_flops, torch.ops.aten.mv: _mv_flops}
    with FlopCounterMode(display=False, custom_mapping=formulas) as counter:
        fn(*args)
    counts = counter.get_flop_counts().get("Global", {})
    scans = int(counts.get(step, 0))
    dots = int(sum(counts.values())) - scans
    return {"matmul_conv_flops": dots, "scan_handle_flops": scans, "total_flops": dots + scans}


@torch.no_grad()
def measure_inference_speed(fn: Callable, args: Sequence[torch.Tensor], max_iter: int = 200,
                            num_warmup: int = 5, log_interval: int = 50,
                            batch: int = 1) -> float:
    """Runs ``fn(*args)`` ``max_iter`` times and returns img/s over the
    iterations after the first ``num_warmup``."""
    if not all(a.is_cuda for a in args):
        raise RuntimeError("measure_inference_speed times the CUDA device; "
                           "its inputs must be CUDA tensors")
    start = torch.cuda.Event(enable_timing=True)
    mark = torch.cuda.Event(enable_timing=True)
    fn(*args)
    for i in range(max_iter):
        if i == num_warmup:
            start.record()
        fn(*args)
        if (i + 1) % log_interval == 0 and i >= num_warmup:
            mark.record()
            mark.synchronize()
            fps = batch * (i + 1 - num_warmup) / (start.elapsed_time(mark) / 1e3)
            print(f"Done image [{i + 1:<3}/ {max_iter}], fps: {fps:.1f} img / s", flush=True)
    mark.record()
    mark.synchronize()
    fps = batch * (max_iter - num_warmup) / (start.elapsed_time(mark) / 1e3)
    print(f"Overall fps: {fps:.1f} img / s, times per image: {1000 / fps:.2f} ms / img")
    return fps


class trace:
    """Context manager: a ``torch.profiler`` trace of the host and, where
    there is one, the card, written to ``<logdir>/trace.json`` (Chrome trace
    format) on exit."""

    def __init__(self, logdir: str = "tramba_trace"):
        self.logdir = logdir
        self.profiler = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.profiler.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
        return False


def device_time_by_kernel(fn: Callable, iters: int = 3, warmup: int = 2,
                          grad: bool = False, ranges: Sequence[str] = ()) -> dict:
    """{kernel name: (device microseconds, launches)} summed over ``iters``
    calls of ``fn()`` after ``warmup`` calls, from ``torch.profiler``'s CUDA
    events, with autograd off unless ``grad`` (a train step).  A kernel
    that runs inside the device span of a ``record_function`` range named
    in ``ranges`` is keyed ``"<kernel name> @ <range>"``, so that one kernel
    that two wrappers share is counted per wrapper; the spans themselves,
    and any other range's, are not counted as kernels.  Empty when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_time_by_kernel profiles the CUDA device; none is available")
    with torch.set_grad_enabled(grad):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # a record_function range also appears on the device, spanning the
    # kernels launched in it; it is no kernel itself
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cuda if e.name in ranges]
    out = {}
    for e in cuda:
        if e.name in ranges or getattr(e, "is_user_annotation", False):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        r = next((name for s, t, name in spans if s <= t0 and t1 <= t), None)
        key = f"{e.name} @ {r}" if r else e.name
        us, n = out.get(key, (0.0, 0))
        out[key] = (us + e.time_range.elapsed_us(), n + 1)
    return out
