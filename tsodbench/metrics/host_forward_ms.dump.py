"""Host ms of the program's ``model.forward`` span a batch (the forward's
launches enqueued, the copy in and out left out): the median over the
window's batches.  Source: the program's spans."""

from tsodbench import spans


def read(run):
    return spans.median_ms("model.forward")
