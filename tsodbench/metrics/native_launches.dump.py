"""Kernels of the program's own library (``csrc/``) launched a batch: its
launch counter read at the entry and exit of each ``model.forward`` span;
the median over the window's batches.  Source: the program's counter."""

from tsodbench import spans


def read(run):
    return spans.median_launches("model.forward")
