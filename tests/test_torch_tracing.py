"""The port's spans and launch counts (``utils/profiling.py``): recorded only
while a profiler session records, nested per thread on ``time.time_ns()``;
device time and idle attributed to them; the exporter; the benchmark's
readers of them (``tsodbench/metrics/``)."""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from tramba_tpu_torch.eval.dump import dump_saliency_maps
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.ops import fused_ss2d, selective_scan
from tramba_tpu_torch.train import optim, step
from tramba_tpu_torch.utils import profiling
from tramba_tpu_torch.utils.profiling import OUTSIDE, Span
from tsodbench import harness

TINY_V = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
TINY_S = dict(enc_config=dict(embed_dim=16, depths=[1, 1, 1, 1], num_heads=[2, 2, 4, 4],
                              window=4), dec_depths=(1, 1, 1, 1))
# the kernel-wrapper spans a bf16 train step of each tiny model records on the
# CPU, where every wrapper runs its plain version
STEP_OPS = {"K1 ss2d_scan", "K2 ss2d_merge", "K3 expand_ln", "K4 final_head", "K5 prologue",
            "K6 ln_mlp", "K7 ln_dwms_mlp", "K8 ss2d_scan_bwd", "K9 ln_mlp_bwd",
            "K10 ln_dwms_mlp_bwd"}


@pytest.fixture(autouse=True)
def _fresh_record():
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()


def _tiny_step(method, overrides, size=64):
    model = build(method, size, device="cpu", seed=0, dtype=torch.bfloat16, **overrides)
    opt = optim.make_optimizer(model.named_parameters())
    g = torch.Generator().manual_seed(0)
    images = torch.randn(2, size, size, 3, generator=g)
    gts = (torch.rand(2, size, size, 1, generator=g) > 0.5).float()
    return lambda: step.train_step(model, opt, images, gts)


def test_nothing_is_recorded_without_a_profiler():
    run = _tiny_step("Tramba-V-TSOD", TINY_V)
    run()
    with profiling.span("train.step"):
        selective_scan.linear_scan(torch.rand(2, 5, 3), torch.rand(2, 5, 3))
    assert profiling.recorded() == []


@pytest.mark.parametrize("method,overrides,extra", [("Tramba-V-TSOD", TINY_V, set()),
                                                    ("Tramba-S-TSOD", TINY_S,
                                                     {"K13 window_attn"})])
def test_a_train_step_records_nested_spans(method, overrides, extra):
    run = _tiny_step(method, overrides)
    run()
    with profile(activities=[ProfilerActivity.CPU]):
        before = time.time_ns()
        run()
        after = time.time_ns()
    spans = profiling.recorded()
    assert [s.t0_ns for s in spans] == sorted(s.t0_ns for s in spans)
    assert all(before <= s.t0_ns <= s.t1_ns <= after for s in spans)
    (top,) = [s for s in spans if s.name == "train.step"]
    assert top.depth == 0 and top.parent == -1 and top.launches == 0  # no library on the CPU
    at = spans.index(top)
    children = [s.name for s in spans if s.parent == at]
    assert children == ["model.forward", "train.loss", "train.backward", "optim.step"]
    fwd = spans.index(next(s for s in spans if s.name == "model.forward"))
    assert [s.name for s in spans if s.parent == fwd] == ["model.encoder", "model.decoder"]
    assert spans[fwd].launches == 0
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns and s.depth == p.depth + 1
    ops = {s.name for s in spans if s.name.startswith("K")}
    assert ops == STEP_OPS | extra
    # the CPU runs the backward on the calling thread: K8 - K10 inside train.backward
    assert {spans[s.parent].name for s in spans
            if s.name in ("K8 ss2d_scan_bwd", "K9 ln_mlp_bwd", "K10 ln_dwms_mlp_bwd")} == {
        "train.backward"}


def test_each_wrapper_span_is_named_by_its_kernel():
    x, w = torch.rand(2, 6, 8), torch.rand(4, 3, 8)
    with profile(activities=[ProfilerActivity.CPU]):
        fused_ss2d.ss2d_proj(x, w)
        selective_scan.linear_scan(torch.rand(2, 5, 3), torch.rand(2, 5, 3))
    assert [s.name for s in profiling.recorded()] == ["K1 ss2d_proj", "K14 linear_scan"]
    assert fused_ss2d.ss2d_proj.__name__ == "ss2d_proj"
    assert selective_scan.linear_scan.launches == 0  # the counter stays on the wrapper


def test_spans_of_two_threads_are_kept_apart():
    both = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            both.wait()
            with profiling.span(f"{tag}.inner"):
                both.wait()
            both.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = profiling.recorded()
    assert len(spans) == 4 and len({s.thread for s in spans}) == 2
    for s in spans:
        tag, part = s.name.split(".")
        if part == "outer":
            assert s.depth == 0 and s.parent == -1
        else:
            p = spans[s.parent]
            assert s.depth == 1 and p.name == f"{tag}.outer" and p.thread == s.thread


def _ev(name, t0, t1, device="CUDA", kind="kernel", cid=0, ann=False):
    """A made-up raw profiler event, as ``tsodbench/tests/test_tsod_trace.py``
    builds them."""
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, end_ns=lambda: t1, correlation_id=lambda: cid,
        device_type=lambda: types.SimpleNamespace(name=device), activity_type=lambda: kind,
        is_user_annotation=lambda: ann)


def _launch(t, cid):
    return _ev("cudaLaunchKernel", t, t + 5, device="CPU", kind="cuda_runtime", cid=cid)


# train.step [0, 1000] on the main thread, its forward [10, 400] with a K6
# wrapper [100, 200]; the backward thread's K9 [500, 700]; optim.step [800, 990]
SPANS = [Span("train.step", 0, 1000, 1, 0, -1, 40), Span("model.forward", 10, 400, 1, 1, 0, 12),
         Span("K6 ln_mlp", 100, 200, 1, 2, 1, None),
         Span("K9 ln_mlp_bwd", 500, 700, 2, 0, -1, None),
         Span("optim.step", 800, 990, 1, 1, 0, None)]


def test_time_by_span_gives_kernels_to_the_innermost_span_at_launch_and_gaps_at_their_start():
    events = [_ev("ln_mlp_kernel", 150, 450, cid=1), _launch(110, 1),
              _ev("mlp_bwd_dx_kernel", 600, 650, cid=2), _launch(510, 2),
              _ev("multi_tensor_apply_kernel", 850, 1050, cid=3), _launch(820, 3),
              _ev("Memcpy HtoD", 1060, 1100, kind="gpu_memcpy", cid=4),
              _ev("cudaMemcpyAsync", 1050, 1055, device="CPU", kind="cuda_runtime", cid=4),
              _ev("aten::add", 100, 120, device="CPU", kind="cpu_op", cid=2),
              _ev("ann", 0, 900, kind="gpu_user_annotation", cid=9, ann=True)]
    got = profiling.time_by_span(events, SPANS, window=(0, 1200))
    assert got["window_ms"] == pytest.approx(1200 / 1e6)
    # busy [150, 450] + [600, 650] + [850, 1050] + [1060, 1100]
    assert got["busy_ms"] == pytest.approx(590 / 1e6)
    assert got["idle_ms"] == pytest.approx(610 / 1e6)
    by = got["spans"]
    assert by["K6 ln_mlp"]["device_ms"] == pytest.approx(300 / 1e6)
    assert by["K9 ln_mlp_bwd"]["device_ms"] == pytest.approx(50 / 1e6)
    assert by["optim.step"]["device_ms"] == pytest.approx(200 / 1e6)
    assert by[OUTSIDE]["device_ms"] == pytest.approx(40 / 1e6)
    # gaps: [0, 150] from train.step, [450, 600] from train.step (500 is later),
    # [650, 850] in K9 (the latest span open at 650), [1050, 1060] and
    # [1100, 1200] outside any span
    assert by["train.step"]["idle_ms"] == pytest.approx(300 / 1e6)
    assert by["K9 ln_mlp_bwd"]["idle_ms"] == pytest.approx(200 / 1e6)
    assert by[OUTSIDE]["idle_ms"] == pytest.approx(110 / 1e6)
    assert by["model.forward"] == {"calls": 1, "host_ms": pytest.approx(390 / 1e6),
                                   "device_ms": 0.0, "idle_ms": 0.0}
    assert sum(v["idle_ms"] for v in by.values()) == pytest.approx(got["idle_ms"])


def test_trace_writes_the_spans_into_the_chrome_trace_and_a_summary(tmp_path):
    for split in ("image", "mask"):
        os.makedirs(tmp_path / "data" / "Test" / split)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8), "RGB").save(
            tmp_path / "data" / "Test" / "image" / f"im{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (40, 50), dtype=np.uint8), "L").save(
            tmp_path / "data" / "Test" / "mask" / f"im{i}.png")
    model = build("Tramba-V-TSOD", 64, device="cpu", seed=0, **TINY_V).eval()
    with profiling.trace(str(tmp_path / "tr")) as tr:
        n = dump_saliency_maps(model, str(tmp_path / "data"), str(tmp_path / "maps"), 64,
                               batch_size=2)
    assert n == 3
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "span"]
    for name in ("dump.load", "dump.copy_in", "model.forward", "dump.to_host", "dump.write"):
        assert name in names
    assert names.count("model.forward") == 2 and names.count("dump.load") == 3
    with open(tmp_path / "tr" / "spans.json") as f:
        summary = json.load(f)
    assert summary == json.loads(json.dumps(tr.summary))
    assert summary["spans"]["model.forward"]["calls"] == 2
    assert summary["spans"]["dump.write"]["host_ms"] > 0
    assert profiling.recorded() and not torch.autograd.profiler._is_profiler_enabled


# metric -> (its span, the statistic)
METRICS = {"host_forward_ms.dump": "model.forward", "host_forward_ms.train": "model.forward",
           "host_backward_ms.train": "train.backward", "host_optim_ms.train": "optim.step",
           "native_launches.dump": "model.forward", "native_launches.train": "train.step",
           "host_ops_ms.train": "train.step"}


def _record():
    """Three made-up train steps of 10, 20 and 40 ms, each with a forward, a
    backward, an optimizer step and kernel-wrapper spans on two threads; the
    third step's forward holds a wrapper inside a wrapper."""
    out, ms = [], 1_000_000
    for k, (dur, launches) in enumerate(((10, 300), (20, 310), (40, 330))):
        t, top = 1000 * ms * k, len(out)
        out += [Span("train.step", t, t + dur * ms, 1, 0, -1, launches),
                Span("model.forward", t + 1, t + 1 + dur * ms // 2, 1, 1, top, launches // 3)]
        fwd = len(out) - 1
        out.append(Span("K6 ln_mlp", t + 2, t + 2 + k * ms, 1, 2, fwd, None))
        if k == 2:
            out.append(Span("K1 weight terms", t + 3, t + 3 + ms, 1, 3, len(out) - 1, None))
        out += [Span("train.backward", t + dur * ms // 2 + 1, t + dur * ms * 3 // 4, 1, 1, top,
                     None),
                Span("K9 ln_mlp_bwd", t + dur * ms // 2 + 2, t + dur * ms // 2 + 2 + ms, 2, 0, -1,
                     None),
                Span("optim.step", t + dur * ms * 3 // 4 + 1, t + dur * ms - 1, 1, 1, top, None)]
    return out


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_each_new_metric_reads_the_program_record(metric, monkeypatch):
    read = harness.reader(metric)
    run = types.SimpleNamespace(trace=None, calls=3)
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert read(run) is None
    record = _record()
    monkeypatch.setattr(profiling, "recorded", lambda: record)
    spans = [s for s in record if s.name == METRICS[metric]]
    if metric.startswith("native_launches"):
        want = sorted(s.launches for s in spans)[1]
    elif metric.startswith("host_ops_ms"):
        want = 2.0  # steps: K9 alone (1 ms), K6 + K9 (2), K6 + K9 (3), K1 inside K6 left out
    else:
        want = sorted(s.t1_ns - s.t0_ns for s in spans)[1] / 1e6
    assert read(run) == pytest.approx(want)


@pytest.mark.cuda
def test_device_time_by_kernel_keys_the_kernels_of_a_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from tramba_tpu_torch.ops import fused_mlp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 24, 24, 128, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(2, 24, 24, 128, device=dev, generator=g).to(torch.bfloat16)
    ln_w, ln_b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    w1 = 0.05 * torch.randn(512, 128, device=dev, generator=g)
    b1 = torch.zeros(512, device=dev)
    w2 = 0.05 * torch.randn(128, 512, device=dev, generator=g)
    times = profiling.device_time_by_kernel(
        lambda: fused_mlp.ln_mlp_bwd(x, dy, ln_w, ln_b, w1, b1, w2), iters=2,
        ranges=("K9 ln_mlp_bwd",))
    # K9's four launches (and the weights' casts to bf16) inside its span
    mine = {k: n for k, (_, n) in times.items() if k.endswith(" @ K9 ln_mlp_bwd")}
    k9 = {k: n for k, n in mine.items() if "mlp_bwd_" in k or "ln_fc_kernel" in k}
    assert len(k9) == 4 and set(k9.values()) == {2}
    assert any("mlp_bwd_dx_kernel" in k for k in k9)
