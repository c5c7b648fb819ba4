"""Inference-speed harness (test_TSOD.py:71-108 semantics), timed on the card,
and the device time of a forward by kernel.

Port of ``tramba_tpu/utils/profiling.py:134`` ``measure_inference_speed``.
Time comes from CUDA events around the timed iterations; a call whose inputs
are not on a CUDA device raises, since its number would not be the card's.
``device_time_by_kernel`` sums the device time of each kernel name that
``torch.profiler`` records over a few calls.
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


@torch.no_grad()
def device_time_by_kernel(fn: Callable, iters: int = 3, warmup: int = 2) -> dict:
    """{kernel name: (device microseconds, launches)} summed over ``iters``
    calls of ``fn()`` after ``warmup`` calls, from ``torch.profiler``'s CUDA
    events.  Empty when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_time_by_kernel profiles the CUDA device; none is available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out
