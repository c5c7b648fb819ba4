"""Device ms per step in the kernels launched inside the benchmark's
``tsodbench.optim_step`` range around the optimizer's step (Adam's
``torch._foreach`` work).  Source: the profiler's device trace."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    s = run.trace.range_s.get("tsodbench.optim_step", 0.0)
    return 1e3 * s / run.calls if s > 0 else None
