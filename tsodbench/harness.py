"""The benchmark's harness: finds a cell's files by name, checks the card,
runs the cell's driver and prints the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run: the
  program's ``method``, ``dtype`` and ``build`` overrides, and the
  reference's ``model``, whose ``encoder`` and ``decoder`` name its parts
  (``reference/encoders/<encoder>.py``, ``reference/decoders/<decoder>.py``);
* ``traffic/<traffic>.json``: the mix's parameters, and the ``driver``
  (``drivers/<driver>.py``) that reads them;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, of one
  per-layer metric;
* ``limits/<workload>.json``: the limit of each number the cell's output
  check compares.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# modules no process of the benchmark may hold: JAX and the JAX package,
# compared by the whole top-level name (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tramba_tpu")
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (from /proc; the first call's reading where /proc has none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def _json(base, *parts) -> dict:
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _for(metrics: list, name: str) -> list:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def resolve(name: str, bench: Optional[dict] = None, base: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), its files
    from the benchmark's directory (or ``base``)."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(name, w["chips"], _json(base, "configs", w["config"] + ".json"),
                _json(base, "traffic", w["traffic"] + ".json"),
                _json(base, "limits", name + ".json"),
                _for(bench["end_to_end"], name), _for(bench["per_layer"], name))


_MODULES: dict = {}


def module(kind: str, name: str, base: str = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark's directory (or
    ``base``), loaded once."""
    path = os.path.join(base, kind, name + ".py")
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(f"tsodbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(metric: str, base: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric, base).read


def driver(name: str, base: str = BENCH_DIR):
    """The module ``drivers/<name>.py``: ``run(cell, seed, seconds, traced,
    device, t0)`` and ``controls(cell, run, seed, device)`` (``runner.py``)."""
    return module("drivers", name, base)


def steady_host_allocator() -> None:
    """glibc keeps freed host memory in its heap and serves large blocks from
    it: without this, a dump batch's 9.4 MB host map came from pages the
    allocator had returned to the kernel in some runs and not in others, and
    their faults put ~4 ms on 5-15% of the frames of a run (PERF.md, PR 20)."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD


def use_checkout_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels into ``tramba_tpu_torch/_build/`` itself)."""
    base = os.path.join(ROOT, ".tsodbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(run, cell: Cell, traced: bool) -> dict:
    """The last line's object: the cell's end-to-end metrics, or with
    ``traced`` its per-layer ones (a reader that finds nothing is left out)."""
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    device = dict(run.device)
    if traced:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if traced:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = run.checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    steady_host_allocator()
    args = parse(argv)
    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tsodbench: {cell.name} needs {cell.chips} CUDA device(s), found {have}; "
              "the benchmark measures the card and does not fall back to the CPU",
              file=sys.stderr)
        return 2
    use_checkout_caches()
    run = driver(cell.traffic["driver"]).run(cell, args.seed, args.seconds, bool(args.trace),
                                             torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"tsodbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    line = result_line(run, cell, bool(args.trace))
    for k, c in run.checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
