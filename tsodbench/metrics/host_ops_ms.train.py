"""Host ms a step in the program's kernel wrappers: the summed host ms of
the outermost ``K<n> ...`` spans, on the main thread and autograd's
backward thread, that lie inside each ``train.step`` span; the median over
the window's steps.  Source: the program's spans."""

from tsodbench import spans


def read(run):
    return spans.median_ops_ms("train.step")
