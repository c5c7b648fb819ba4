"""Host ms per batch from dispatch (before the copy in) to the return of
``model(images)``, before the copy out: the median over the window's
batches.  Source: the benchmark's own span around the dump step."""

import statistics


def read(run):
    xs = run.host_s.get("enqueue")
    return 1e3 * statistics.median(xs) if xs else None
