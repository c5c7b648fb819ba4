"""Host ms of the program's ``optim.step`` span (Adam's ``torch._foreach``
launches) a step: the median over the window's steps.  Source: the
program's spans."""

from tsodbench import spans


def read(run):
    return spans.median_ms("optim.step")
