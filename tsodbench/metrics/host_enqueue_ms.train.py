"""Host ms per step until ``train_step`` returns (its launches enqueued):
the median over the window's steps.  Source: the benchmark's own span."""

import statistics


def read(run):
    xs = run.host_s.get("enqueue")
    return 1e3 * statistics.median(xs) if xs else None
