"""Inference-speed harness (test_TSOD.py:71-108 semantics), timed on the card,
and the device time of a forward by kernel.

Port of ``tramba_tpu/utils/profiling.py:134`` ``measure_inference_speed``.
Time comes from CUDA events around the timed iterations; a call whose inputs
are not on a CUDA device raises, since its number would not be the card's.
``device_time_by_kernel`` sums the device time of each kernel name that
``torch.profiler`` records over a few calls, telling apart the launches
made inside the ``record_function`` ranges it is given.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["measure_inference_speed", "device_time_by_kernel"]


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
