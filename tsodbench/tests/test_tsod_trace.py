"""The trace reader on made-up profiler events: busy time as a union, idle
gaps named by the host range, kernels attributed to the range that
launched them."""

import types

import pytest

from tsodbench import trace


def _ev(name, t0, t1, device="CUDA", kind="kernel", cid=0, ann=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, end_ns=lambda: t1, correlation_id=lambda: cid,
        device_type=lambda: types.SimpleNamespace(name=device), activity_type=lambda: kind,
        is_user_annotation=lambda: ann)


def test_busy_idle_groups_and_ranges():
    spans = trace.Spans()
    spans.spans += [(trace.WINDOW, 0, 1000), ("tsodbench.step", 0, 600),
                    ("tsodbench.optim_step", 400, 500), ("tsodbench.step", 600, 1000)]
    events = [
        _ev("ss2d_seg_kernel<1>", 100, 300, cid=1), _ev("Memcpy HtoD", 250, 350, kind="gpu_memcpy",
                                                        cid=2),
        _ev("multi_tensor_apply_kernel", 450, 550, cid=3), _ev("gemm_x", 900, 1100, cid=4),
        _ev("cudaLaunchKernel", 90, 95, device="CPU", kind="cuda_runtime", cid=1),
        _ev("cudaMemcpyAsync", 240, 245, device="CPU", kind="cuda_runtime", cid=2),
        _ev("cudaLaunchKernel", 420, 425, device="CPU", kind="cuda_runtime", cid=3),
        _ev("cudaLaunchKernel", 650, 655, device="CPU", kind="cuda_runtime", cid=4),
        _ev("tsodbench.optim_step", 440, 560, kind="gpu_user_annotation", cid=9, ann=True),
    ]
    t = trace.Trace(events, spans, ranges=("tsodbench.optim_step",))
    assert t.window_s == pytest.approx(1000 / 1e9)
    # busy: [100, 350] + [450, 550] + [900, 1000] (clipped to the window)
    assert t.busy_s == pytest.approx(450 / 1e9)
    assert t.group_s["K1 ss2d_scan, segment scans"] == pytest.approx(200 / 1e9)
    assert t.group_s["copies"] == pytest.approx(100 / 1e9)
    assert t.group_s["GEMM (cuBLAS)"] == pytest.approx(100 / 1e9)
    assert t.range_s == {"tsodbench.optim_step": pytest.approx(100 / 1e9)}
    # gaps [0, 100], [350, 450] in the first step, [550, 900]: 50 in the first, 300 in the next
    assert t.idle_s["tsodbench.step"] == pytest.approx(550 / 1e9)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "K1 ss2d_scan, segment scans" and len(b["idle_gaps"]) == 1


def test_a_window_must_be_recorded():
    with pytest.raises(RuntimeError):
        trace.Trace([], trace.Spans())
