"""Host ms of the program's ``train.backward`` span (``loss.backward()``,
its wait on autograd's backward thread included) a step: the median over
the window's steps.  Source: the program's spans."""

from tsodbench import spans


def read(run):
    return spans.median_ms("train.backward")
