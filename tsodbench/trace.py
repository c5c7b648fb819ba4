"""The device side of a traced window, read from ``torch.profiler``'s raw
events (CUDA activity only, so that the host is not slowed by recording
every operator).

Busy time is the union of the intervals in which a kernel, copy or set ran
on the card (one stream or many) inside the benchmark's window.  Kernels are
grouped by name fragments (first match wins).  The benchmark times its own
host ranges on the system clock, which is the profiler's: an idle gap is
named by the innermost range the host was in when the gap began, and a
kernel belongs to the range in which the host launched it (its launch call
shares the kernel's correlation id).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

WINDOW = "tsodbench.window"
# kernel-name fragments (a tuple: all of them) -> group, first match wins
GROUPS = (("linear_scan_", "K14 linear_scan"),
          ("ln_fc_kernel<1>", "K9 ln_mlp_bwd"), ("ln_fc_kernel<2>", "K10 ln_dwms_mlp_bwd"),
          ("mlp_bwd_dwms_", "K10 ln_dwms_mlp_bwd"), ("mlp_bwd_", "K9 / K10 tail"),
          ("bwd_summary_kernel", "K8 ss2d_scan_bwd"), ("bwd_scan_kernel", "K8 ss2d_scan_bwd"),
          ("bwd_dbc_kernel", "K8 ss2d_scan_bwd"), ("bwd_dx_kernel", "K8 ss2d_scan_bwd"),
          ("bwd_wgrad_kernel", "K8 ss2d_scan_bwd"), ("sum_parts_kernel", "K8 ss2d_scan_bwd"),
          ("ss2d_seg_kernel", "K1 ss2d_scan, segment scans"),
          ("ss2d_proj_split_kernel", "K1 ss2d_scan, projection"),
          ("proj_terms_kernel", "K1 ss2d_scan, weight terms"),
          ("ss2d_merge_kernel", "K2 ss2d_merge"),
          ("expand_wgmma_kernel", "K3 expand_ln"), ("expand_simt_kernel", "K3 expand_ln"),
          ("head_wgmma_kernel", "K4 final_head"), ("head_simt_kernel", "K4 final_head"),
          ("prologue_kernel", "K5 prologue"), ("ln_mlp_kernel", "K6 ln_mlp"),
          ("ln_fc_kernel<0>", "K7 ln_dwms_mlp"), ("dwms_tile_kernel", "K7 ln_dwms_mlp"),
          ("dwmlp_tile_kernel", "K11 ln_dwmlp"),
          ("ln_fc_kernel<3>", "K13 window_attn"), ("window_attn_kernel", "K13 window_attn"),
          ("sra_kernel", "K12 sra"), ("finish_split_kernel", "split sums of K6/K7/K11"),
          ("memcpy", "copies"), ("memset", "memsets"),
          ("layer_norm", "LayerNorm (torch)"), ("softmax", "softmax (torch)"),
          ("dgrad", "conv (cuDNN)"), ("wgrad", "conv (cuDNN)"), ("conv", "conv (cuDNN)"),
          ("cudnn", "conv (cuDNN)"), ("fprop", "conv (cuDNN)"),
          ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
          ("multi_tensor_apply", "Adam (torch._foreach)"),
          ("reduce_kernel", "reductions (torch)"), ("upsample", "bilinear resize (torch)"))


def group_of(name: str) -> str:
    low = name.lower()
    for frags, group in GROUPS:
        if all(f.lower() in low for f in (frags if isinstance(frags, tuple) else (frags,))):
            return group
    return "elementwise / other"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Spans:
    """The benchmark's own host ranges, (name, start, end) in ns of the
    system clock, which is the profiler's."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


class Trace:
    """Seconds by kernel group, busy and idle time of the traced window, and
    the device seconds of the kernels launched inside each host range named
    in ``ranges`` (``range_s``).  ``events``: the profiler's raw events
    (``kineto_results.events()``); ``spans``: the benchmark's host ranges,
    among them :data:`WINDOW`."""

    def __init__(self, events, spans: Spans, ranges=()):
        win = [(t0, t1) for n, t0, t1 in spans.spans if n == WINDOW]
        if not win:
            raise RuntimeError("no tsodbench.window range was recorded")
        w0, w1 = win[-1]
        self.window_s = (w1 - w0) / 1e9
        work, launched = [], {}
        for e in events:
            if e.device_type().name == "CUDA":
                if not getattr(e, "is_user_annotation", lambda: False)():
                    work.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
            elif e.correlation_id():  # a runtime or driver call that launched device work
                launched[e.correlation_id()] = e.start_ns()
        work = [(n, max(t0, w0), min(t1, w1), c) for n, t0, t1, c in work if t1 > w0 and t0 < w1]
        self.group_s: Dict[str, float] = {}
        for n, t0, t1, _ in work:
            g = group_of(n)
            self.group_s[g] = self.group_s.get(g, 0.0) + (t1 - t0) / 1e9
        host = sorted((t0, t1, n) for n, t0, t1 in spans.spans if n != WINDOW)
        starts = [h[0] for h in host]

        def inside(t):
            """The innermost host range open at t, or None."""
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0:
                if host[i][1] >= t:
                    return host[i][2]
                i -= 1
            return None

        self.range_s: Dict[str, float] = {r: 0.0 for r in ranges}
        for n, t0, t1, c in work:
            r = inside(launched[c]) if ranges and c in launched else None
            if r in self.range_s:
                self.range_s[r] += (t1 - t0) / 1e9
        busy = _union([(t0, t1) for _, t0, t1, _ in work])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        gaps, at = [], w0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        self.idle_s: Dict[str, float] = {}
        for s, e in gaps:
            name = inside(s) or "outside any range"
            self.idle_s[name] = self.idle_s.get(name, 0.0) + (e - s) / 1e9

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.group_s), "idle_gaps": top(self.idle_s)}
