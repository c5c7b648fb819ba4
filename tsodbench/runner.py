"""What every driver (``drivers/<driver>.py``) shares: the result of a run,
the program built from a configuration, the measured window and its
device readings.

A driver's ``run(cell, seed, seconds, traced, device, t0) -> Run`` builds the
program (``tramba_tpu_torch``) through its normal path
(``models.registry.build`` with the configuration's ``build`` overrides,
``load_state_dict`` of weights drawn from the seed), warms up the cell's own
shapes, measures a window of ``seconds``, and then, with the window closed,
its memory peak read and the program's state freed, holds what the timed
path produced to the plain reference (``reference/``), which is handed the
same weights and inputs and works out everything else again.  Its
``controls(cell, run, seed, device)`` yields (who, readings) of the control
and of the planted faults on the same inputs, for ``calibrate.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import statistics
import subprocess
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tsodbench.harness import Cell
from tsodbench.trace import WINDOW, Spans, Trace


def sub(seed: int, k: int) -> int:
    """The seed of the run's k-th stream (weights 0, inputs 1, masks 2,
    stochastic depth 3, sampling 4)."""
    return (seed * 8 + k) % (2 ** 63)


@dataclasses.dataclass
class Run:
    cell: Cell
    seconds: float
    window_s: float
    images: int  # images whose work the window completed
    calls: int  # batches or steps
    e2e: Dict[str, float]
    host_s: Dict[str, List[float]]  # the benchmark's host spans, per call
    device: dict
    attempted: int
    failed: int
    correct: bool = False
    checks: dict = dataclasses.field(default_factory=dict)
    readings: dict = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    reference: Optional[dict] = None  # what the reference computed, for the control's readings
    check_s: float = 0.0  # seconds the output check took


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else (
        {k: _tuples(x) for k, x in v.items()} if isinstance(v, dict) else v)


def build(cell: Cell, device):
    """The program's model, built as its CLIs build it, with the
    configuration's ``build`` overrides as they stand (JSON lists as
    tuples); the weights are the benchmark's, loaded after."""
    from tramba_tpu_torch.models import registry

    cfg = cell.config
    with torch.device(device):
        return registry.build(cfg["method"], cfg["model"]["img_size"], device=device, seed=None,
                              dtype=getattr(torch, cfg["dtype"]), **_tuples(cfg["build"]))


def device_info(device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CardLog:
    """The card's SM clock, power and temperature read by ``nvidia-smi``
    (no CUDA context of its own) about once a second beside the window, from
    a thread; the summary is printed on an earlier line than the result."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self, device):
        self.rows, self.done, self.thread = [], threading.Event(), None
        smi = shutil.which("nvidia-smi")
        if device.type == "cuda" and smi:
            cmd = [smi, f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                   "-i", str(device.index or 0)]
            self.thread = threading.Thread(target=self._sample, args=(cmd,), daemon=True)
            self.thread.start()

    def _sample(self, cmd):
        while not self.done.is_set():
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
            try:
                self.rows.append([float(v) for v in out.strip().split(",")])
            except ValueError:
                pass
            self.done.wait(1.0)

    def stop(self) -> None:
        if self.thread is None:
            return
        self.done.set()
        self.thread.join(timeout=60)
        if self.rows:
            cols = list(zip(*self.rows))
            text = ", ".join(
                f"{name} min {min(c):g} median {statistics.median(c):g} max {max(c):g}"
                for name, c in zip(self.QUERY.split(","), cols))
            print(f"tsodbench: card beside the window ({len(self.rows)} samples): {text}",
                  flush=True)


class Window:
    """The measured window, under ``torch.profiler`` (CUDA activity) when
    traced; ``spans`` times the benchmark's host ranges in it."""

    def __init__(self, traced: bool, device):
        self.traced, self.device, self.prof = traced, device, None
        self.spans = Spans()

    def __enter__(self):
        sync(self.device)
        # what set-up made lives on: later collections need not scan it
        gc.freeze()
        gc.callbacks.append(self._gc)
        self.gc_n, self.gc_s, self._gc_t = [0, 0, 0], 0.0, 0.0
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            act = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
            self.prof = profile(activities=[act])
            self.prof.__enter__()
        self.card = CardLog(self.device)
        self.ns0 = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def close(self):
        """End the window after the device has finished its work."""
        sync(self.device)
        self.t1 = time.perf_counter()
        self.spans.spans.append((WINDOW, self.ns0, time.time_ns()))
        self.card.stop()
        gc.callbacks.remove(self._gc)
        gc.unfreeze()
        print(f"tsodbench: garbage collections in the window by generation {self.gc_n}, "
              f"{1e3 * self.gc_s:.3f} ms", flush=True)
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        return self.t1 - self.t0

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_n[info["generation"]] += 1
            self.gc_s += time.perf_counter() - self._gc_t

    def __exit__(self, *exc):
        return False

    def trace(self, ranges=()):
        if self.prof is None:
            return None
        return Trace(self.prof.profiler.kineto_results.events(), self.spans, ranges)


def p95(xs):
    return float(np.percentile(np.asarray(xs), 95))


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
