"""Host ms of the program's ``model.forward`` span a step: the median over
the window's steps.  Source: the program's spans."""

from tsodbench import spans


def read(run):
    return spans.median_ms("model.forward")
