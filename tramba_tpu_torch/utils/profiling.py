"""Accounting and timing: parameters, FLOPs, the inference-speed harness,
the port's spans and launch counts, device traces and the device time of a
forward by kernel.

Port of ``tramba_tpu/utils/profiling.py``.  ``count_params`` and the
reference's analytic FLOP model: ``selective_scan_flops`` (csms6s.py:772-793)
and ``analytic_model_flops``, fvcore's accounting (2MNK for every matrix
product and convolution) plus 9 operations per scanned state element, as
the JAX package counts them from a jaxpr; here ``torch.utils.flop_counter``
counts the products of a forward of the plain versions on the CPU, and the
plain scan's one ``addcmul`` per step stands for the scan handle.
``measure_inference_speed`` (:134, test_TSOD.py:71-108) times on the card
with CUDA events; a call whose inputs are not on a CUDA device raises, since
its number would not be the card's.  XLA's own cost model
(``cost_analysis``) has no meaning here.

Spans.  :func:`span`, a context manager, marks the port's host work: the
train step and its parts (``train.step``, ``train.loss``,
``train.backward``, ``optim.step``), the model
(``model.forward``, ``model.encoder``, ``model.decoder``), each public kernel
wrapper, named by its kernel (``K1 ss2d_scan`` ... ``K14 linear_scan``), and
the dump loop (``dump.load``, ``dump.copy_in``, ``dump.to_host``,
``dump.write``).  They record only while a ``torch.profiler`` session
records (``torch.autograd.profiler._is_profiler_enabled``); otherwise a span
costs one global read and an empty context manager.  A recorded span is its
name, its start and end on ``time.time_ns()`` (the clock of the profiler's
raw events) and its thread (autograd's backward thread records too), kept
in one flat integer array (no object a span for the garbage collector);
``model.forward`` and ``train.step`` also read the kernel library's launch
counter (``tramba_native_launches``) at entry and exit, where the library
is loaded.  :func:`recorded` returns the record, :func:`reset` clears it.

``time_by_span`` attributes the profiler's device activity to the spans:
each kernel, copy or set to the innermost span open when its launch call
began, and each idle gap of the card to the innermost span open when the
gap began.  ``trace`` is the exporter: a profiler session (the card's
activity where there is one, the host's operators where there is not)
written to ``<logdir>/trace.json`` with the spans as a host track of their
own on the same time axis, and ``<logdir>/spans.json``, the summary of
``time_by_span``.  ``device_time_by_kernel`` sums the device time of each
kernel name over a few calls, keying a kernel launched inside a span it is
given as ``"<kernel name> @ <span>"``.
"""

from __future__ import annotations

import array
import heapq
import json
import math
import os
import struct
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _autograd_profiler

from tramba_tpu_torch.ops import _native

__all__ = ["count_params", "selective_scan_flops", "analytic_model_flops",
           "measure_inference_speed", "span", "Span", "recorded", "reset",
           "OUTSIDE", "time_by_span", "trace", "device_time_by_kernel"]


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


# --- spans ------------------------------------------------------------------

# spans that read the kernel library's launch counter at entry and exit
COUNTED = ("model.forward", "train.step")
# a recorded span: name id, t0, t1, thread, launches at entry and at exit
# (-1: not read), one row of _FIELDS integers in _ROWS
_FIELDS = 6
_ROWS = array.array("q")
_put = _ROWS.frombytes  # with _row: one call, so a row stays whole beside another thread's
_row = struct.Struct(f"{_FIELDS}q").pack
_now = time.time_ns
_thread = threading.get_ident
_NAMES: List[str] = []
_IDS: dict = {}


class Span(NamedTuple):
    """A recorded span: times in ns of ``time.time_ns()``; ``thread``, the
    thread's ``threading.get_ident()``; ``depth`` and ``parent`` (an index
    into the list that :func:`recorded` returns, -1 for none) on its own
    thread; ``launches``, the kernels the library launched between entry and
    exit (on any thread), for the spans of :data:`COUNTED`, else None."""
    name: str
    t0_ns: int
    t1_ns: int
    thread: int
    depth: int
    parent: int
    launches: Optional[int]


def _launch_count() -> int:
    """The library's launch counter where it is loaded, else 0; never builds
    or loads it."""
    if _native.library.cache_info().currsize == 0:
        return 0
    return _native.library().tramba_native_launches()


def _name_id(name: str) -> int:
    i = _IDS.get(name)
    if i is None:
        i = _IDS[name] = len(_NAMES)
        _NAMES.append(name)
    return i


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):  # named: no tuple a call
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "t0", "n0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.n0 = _launch_count() if self.name in COUNTED else -1
        self.t0 = _now()

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        _put(_row(_name_id(self.name), self.t0, t1, _thread(), self.n0,
                  _launch_count() if self.n0 >= 0 else -1))
        return False


def span(name: str):
    """A context manager that records the host time of its block as the span
    ``name`` while a profiler session records, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def reset() -> None:
    """Clear the record (the port's profiling entry points call it first)."""
    del _ROWS[:]


def recorded() -> List[Span]:
    """The spans that have ended since the last :func:`reset`, by start
    time; depth and parent from how the spans of a thread nest."""
    flat = _ROWS.tolist()
    rows = sorted((flat[i:i + _FIELDS] for i in range(0, len(flat), _FIELDS)),
                  key=lambda r: (r[3], r[1], -r[2]))
    nest, stack, thread = [], [], None
    for i, (_, t0, t1, th, _, _) in enumerate(rows):
        if th != thread:
            stack, thread = [], th
        while stack and rows[stack[-1]][2] <= t0:
            stack.pop()
        nest.append((len(stack), stack[-1] if stack else -1))
        stack.append(i)
    order = sorted(range(len(rows)), key=lambda i: (rows[i][1], nest[i][0]))
    at = {i: k for k, i in enumerate(order)}
    return [Span(_NAMES[rows[i][0]], rows[i][1], rows[i][2], rows[i][3], nest[i][0],
                 at[nest[i][1]] if nest[i][1] >= 0 else -1,
                 rows[i][5] - rows[i][4] if rows[i][4] >= 0 else None) for i in order]


# --- device time and idle by span ---------------------------------------------

OUTSIDE = "outside any span"


def _innermost(spans: Sequence[Span], times: Sequence[int]) -> List[int]:
    """For each time, the index of the innermost span open then (the latest
    to start among those with t0 <= t <= t1, on any thread), or -1."""
    order = sorted(range(len(times)), key=times.__getitem__)
    starts = sorted(range(len(spans)), key=lambda i: (spans[i].t0_ns, spans[i].depth))
    out, heap, j = [-1] * len(times), [], 0
    for q in order:
        t = times[q]
        while j < len(starts) and spans[starts[j]].t0_ns <= t:
            i = starts[j]
            heapq.heappush(heap, (-spans[i].t0_ns, -spans[i].depth, i))
            j += 1
        while heap and spans[heap[0][2]].t1_ns < t:
            heapq.heappop(heap)
        if heap:
            out[q] = heap[0][2]
    return out


def _device_work(events):
    """(kernels, copies and sets as (name, t0, t1, correlation id); launch
    calls' start by correlation id) from the profiler's raw events.  A
    launch call is a host event of the CUDA runtime or driver API
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)
    with a correlation id."""
    work, launched = [], {}
    for e in events:
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation():
                work.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    return work, launched


def time_by_span(events, spans: Sequence[Span], window=None) -> dict:
    """Device and idle time by span from the profiler's raw events
    (``prof.profiler.kineto_results.events()``) and :func:`recorded` spans:
    {"window_ms", "busy_ms", "idle_ms", "spans": {name: {"calls", "host_ms",
    "device_ms", "idle_ms"}}}.  A kernel, copy or set counts for the
    innermost span open when its launch call began, an idle gap (the window
    less the union of the device's work) for the innermost span open when
    it began; either is :data:`OUTSIDE` where no span was open.  ``window``:
    (t0, t1) in ns, by default from the first start to the last end."""
    work, launched = _device_work(events)
    if window is None:
        ends = [(s.t0_ns, s.t1_ns) for s in spans] + [(t0, t1) for _, t0, t1, _ in work]
        window = (min(a for a, _ in ends), max(b for _, b in ends)) if ends else (0, 0)
    w0, w1 = window
    work = [(max(t0, w0), min(t1, w1), c) for _, t0, t1, c in work if t1 > w0 and t0 < w1]
    out = {}

    def entry(name):
        if name not in out:
            out[name] = {"calls": 0, "host_ms": 0.0, "device_ms": 0.0, "idle_ms": 0.0}
        return out[name]

    for s in spans:
        e = entry(s.name)
        e["calls"] += 1
        e["host_ms"] += (s.t1_ns - s.t0_ns) / 1e6
    owners = _innermost(spans, [launched.get(c, -1) for _, _, c in work])
    for (t0, t1, c), i in zip(work, owners):
        name = spans[i].name if i >= 0 and c in launched else OUTSIDE
        entry(name)["device_ms"] += (t1 - t0) / 1e6
    busy, gaps, at = 0, [], w0
    for t0, t1 in sorted((t0, t1) for t0, t1, _ in work):
        if t0 > at:
            gaps.append((at, t0))
        busy += max(0, t1 - max(t0, at))
        at = max(at, t1)
    if w1 > at:
        gaps.append((at, w1))
    for (g0, g1), i in zip(gaps, _innermost(spans, [g0 for g0, _ in gaps])):
        entry(spans[i].name if i >= 0 else OUTSIDE)["idle_ms"] += (g1 - g0) / 1e6
    return {"window_ms": (w1 - w0) / 1e6, "busy_ms": busy / 1e6,
            "idle_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e6, "spans": out}


# trace.json's thread ids of the span tracks, clear of the host's own ids
_SPAN_TID = 1_000_000_000


class trace:
    """Context manager: a ``torch.profiler`` session around its block, of
    the card's activity where there is a card (kernels, copies, sets and
    their launch calls: recording the host's operators too would slow the
    host down), else of the host's operators.  On exit, after the card has
    finished, it writes ``<logdir>/trace.json`` (Chrome trace format) with
    the port's spans added as a track of their own on the same time axis,
    and ``<logdir>/spans.json``: :func:`time_by_span` over the block
    (``summary`` holds it too)."""

    def __init__(self, logdir: str = "tramba_trace"):
        self.logdir = logdir
        self.profiler = None
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
        self.profiler = profile(activities=[act])
        self.profiler.__enter__()
        reset()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self.profiler.__exit__(*exc)
        spans = recorded()
        self.summary = time_by_span(self.profiler.profiler.kineto_results.events(), spans,
                                    (self.t0, t1))
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.profiler.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
        tids = {th: _SPAN_TID + n for n, th in enumerate(dict.fromkeys(s.thread for s in spans))}
        events = doc.setdefault("traceEvents", [])
        events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"tramba_tpu_torch spans, thread {th}"}}
                   for th, tid in tids.items()]
        events += [{"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tids[s.thread],
                    "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
                    "args": {} if s.launches is None else {"launches": s.launches}}
                   for s in spans]
        with open(path, "w") as f:
            json.dump(doc, f)
        with open(os.path.join(self.logdir, "spans.json"), "w") as f:
            json.dump(self.summary, f, indent=1)
        print(f"profiler trace written to {path}")
        return False


def device_time_by_kernel(fn: Callable, iters: int = 3, warmup: int = 2,
                          grad: bool = False, ranges: Sequence[str] = ()) -> dict:
    """{kernel name: (device microseconds, launches)} summed over ``iters``
    calls of ``fn()`` after ``warmup`` calls, from ``torch.profiler``'s CUDA
    events, with autograd off unless ``grad`` (a train step).  A kernel
    whose launch call began inside a span named in ``ranges`` (the innermost
    such span) is keyed ``"<kernel name> @ <span>"``, so that one kernel
    that two wrappers share is counted per wrapper.  Empty when the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_time_by_kernel profiles the CUDA device; none is available")
    with torch.set_grad_enabled(grad):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    work, launched = _device_work(prof.profiler.kineto_results.events())
    spans = [s for s in recorded() if s.name in ranges]
    owners = _innermost(spans, [launched.get(c, -1) for _, _, _, c in work])
    out = {}
    for (name, t0, t1, c), i in zip(work, owners):
        key = f"{name} @ {spans[i].name}" if i >= 0 and c in launched else name
        us, n = out.get(key, (0.0, 0))
        out[key] = (us + (t1 - t0) / 1e3, n + 1)
    return out
