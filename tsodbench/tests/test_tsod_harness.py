"""The harness: cells found by name, new files picked up, names and units
in bounds, the last line's keys, and no fall back to the CPU."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from tsodbench import harness
from tsodbench.reference import model as ref

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_workload_resolves_to_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"], bench)
        drive = harness.driver(cell.traffic["driver"])
        assert callable(drive.run) and callable(drive.controls)
        model = cell.config["model"]
        assert callable(ref.part("encoders", model["encoder"]).encode)
        assert callable(ref.part("decoders", model["decoder"]).decode)
        assert isinstance(cell.config["build"], dict) and cell.config["method"]
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(harness.BENCH_DIR, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "configs" / "new-model.json").write_text(json.dumps({"model": {"dims": 8}}))
    (base / "traffic" / "new-mix.json").write_text(json.dumps({"driver": "dump", "batch": 2}))
    (base / "limits" / "new.cell.json").write_text(json.dumps({"head_rel_l2": 0.5}))
    (base / "metrics" / "new_metric.dump.py").write_text("def read(run):\n    return 42.0\n")
    bench = _bench()
    bench["workloads"].append({"name": "new.cell", "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric.dump", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "entry",
                               "moves": "setup_s", "workloads": ["new.cell"]})
    cell = harness.resolve("new.cell", bench, base=str(base))
    assert cell.config == {"model": {"dims": 8}} and cell.traffic["batch"] == 2
    assert cell.limits == {"head_rel_l2": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.dump"]
    assert harness.reader("new_metric.dump", base=str(base))(None) == 42.0


POOL_ENCODER = '''"""Encoder ``pool``: average pooling and one product a stage."""
import torch.nn.functional as F

from tsodbench.reference import model as ref


def encode(ctx, P, cfg, x):
    skips = [x]
    for s in range(4):
        p = F.avg_pool2d(x.permute(0, 3, 1, 2), 4 * 2 ** s).permute(0, 2, 3, 1)
        skips.append(ref.linear(ctx, p, P[f"pool.{s}.weight"]))
    return skips


def param_shapes(cfg):
    return {f"pool.{s}.weight": (cfg["dims"] * 2 ** s, 3) for s in range(4)}
'''

FORWARD_DRIVER = '''"""Driver ``forward``: one forward of the reference, its heads finite."""
import time

import torch

from tsodbench import counts, runner, weights
from tsodbench.harness import verdict
from tsodbench.reference import model as ref


def run(cell, seed, seconds, traced, device, t0):
    m = cell.config["model"]
    P = weights.draw(ref.param_shapes(m), seed, device)
    x = weights.images(cell.traffic["batch"], m["img_size"], seed, device, 1)[0]
    heads = ref.forward(ref.Ctx(), P, m, x)
    flops = counts.forward_flops(m)["total"]
    r = runner.Run(cell, seconds, seconds, x.shape[0], 1,
                   {"setup_s": time.perf_counter() - t0, "peak_mem_gib": 0.0}, {},
                   runner.device_info(device, 0), 1, 0)
    finite = all(bool(torch.isfinite(h).all()) for h in heads) and flops > 0
    r.readings = {"finite": 0.0 if finite else 1.0, "last_head": list(heads[-1].shape)}
    r.correct, r.checks = verdict({"finite": r.readings["finite"]}, cell.limits)
    return r


def controls(cell, run, seed, device):
    return iter(())
'''


def test_a_new_encoder_and_driver_are_files_only(tmp_path):
    """A configuration whose encoder the reference had no file for, under a
    traffic mix whose driver did not exist, runs once both are added as
    files to a copy of the benchmark whose other files stay as they are."""
    base = tmp_path / "tsodbench"
    shutil.copytree(harness.BENCH_DIR, base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "reference" / "encoders" / "pool.py").write_text(POOL_ENCODER)
    (base / "drivers" / "forward.py").write_text(FORWARD_DRIVER)
    model = dict(encoder="pool", decoder="tramba", img_size=64, dims=8, dec_depths=[1, 1, 1, 1],
                 dec_drop_path=0.2)
    (base / "configs" / "pooled.json").write_text(json.dumps(
        {"method": "none", "dtype": "float32", "model": model, "build": {}}))
    (base / "traffic" / "once.json").write_text(json.dumps({"driver": "forward", "batch": 2}))
    (base / "limits" / "pooled.once.json").write_text(json.dumps({"finite": 0.0}))
    bench = _bench()
    bench["workloads"].append({"name": "pooled.once", "config": "pooled", "traffic": "once",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, torch\n"
            "from tsodbench import harness\n"
            "cell = harness.resolve('pooled.once')\n"
            "run = harness.driver(cell.traffic['driver']).run(cell, 3, 0.1, False,"
            " torch.device('cpu'), time.perf_counter())\n"
            "print(json.dumps([harness.__file__, run.readings,"
            " harness.result_line(run, cell, False)]))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    where, readings, line = json.loads(out.stdout.strip().splitlines()[-1])
    assert where.startswith(str(base))
    assert readings == {"finite": 0.0, "last_head": [2, 64, 64, 1]}
    assert line["correct"] and set(line["metrics"]) == {"setup_s", "peak_mem_gib"}


def test_names_units_and_keys_keep_to_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"])) and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.resolve(w["name"], bench).end_to_end}
        assert "setup_s" in names and len(names) >= 2


class _Trace:
    busy_s, window_s = 1.5, 2.0
    group_s = {"K1 ss2d_scan, segment scans": 0.5}
    range_s = {}

    def breakdown(self):
        return {"device_ops": [["K1", 1.0]], "idle_gaps": [["tsodbench.dump.batch", 0.5]]}


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_exactly_its_keys(traced):
    cell = harness.resolve("tramba-v.dump-b16")
    run = types.SimpleNamespace(
        correct=True, attempted=3, failed=0, images=48, calls=3, window_s=2.0, cell=cell,
        e2e={"setup_s": 1.0, "infer_img_per_s": 24.0, "frame_ms_p95": 70.0, "peak_mem_gib": 3.0},
        device={"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
        host_s={"enqueue": [0.01, 0.02]}, trace=_Trace() if traced else None,
        checks={"head_rel_l2": {"value": 0.01, "limit": 0.1}})
    line = harness.result_line(run, cell, traced)
    want = list(harness.KEYS) + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert json.loads(json.dumps(line)) == line
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "host_enqueue_ms.dump" in line["metrics"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_main_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "tsodbench/main.py", "--workload", "tramba-v.dump-b16",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "tsodbench/main.py", "--workload", "tramba-v.dump-b16",
                          "--seed", "3000000000", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
