"""The program's own spans and launch counts, read through
``tramba_tpu_torch.utils.profiling.recorded()`` and nothing else of the
program.  The program records them only while a profiler session runs,
which in a benchmark process is the traced window alone.  A program without
them (an older checkout) reads as an empty record, and every reader of it
then returns None."""

from __future__ import annotations

import bisect
import statistics


def recorded() -> list:
    try:
        from tramba_tpu_torch.utils.profiling import recorded as program_spans
    except ImportError:
        return []
    return program_spans()


def median_ms(name: str):
    """The median host ms of the spans ``name``."""
    xs = [(s.t1_ns - s.t0_ns) / 1e6 for s in recorded() if s.name == name]
    return statistics.median(xs) if xs else None


def median_launches(name: str):
    """The median of the kernels the program launched inside each span
    ``name`` (its launch counter read at the span's entry and exit)."""
    xs = [s.launches for s in recorded() if s.name == name and s.launches is not None]
    return statistics.median(xs) if xs else None


def is_op(name: str) -> bool:
    """A kernel wrapper's span: named by its kernel, ``K<n> <wrapper>``."""
    return name[:1] == "K" and name[1:2].isdigit()


def median_ops_ms(outer: str):
    """The median over the spans ``outer`` of the summed host ms of the
    outermost kernel-wrapper spans (on any thread) that lie inside each."""
    spans = recorded()

    def outermost(s):
        while s.parent >= 0:
            s = spans[s.parent]
            if is_op(s.name):
                return False
        return True

    ops = [(s.t0_ns, s.t1_ns) for s in spans if is_op(s.name) and outermost(s)]
    starts = [t0 for t0, _ in ops]
    sums = []
    for s in spans:
        if s.name == outer:
            i, total = bisect.bisect_left(starts, s.t0_ns), 0
            while i < len(ops) and ops[i][0] <= s.t1_ns:
                if ops[i][1] <= s.t1_ns:
                    total += ops[i][1] - ops[i][0]
                i += 1
            sums.append(total / 1e6)
    return statistics.median(sums) if sums else None
