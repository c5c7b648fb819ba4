"""The card's idle share of the traced window: 1 - (the union of the
intervals in which a kernel, copy or set ran) / the window's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
