"""Kernels of the program's own library (``csrc/``) launched a step,
forward and backward: its launch counter read at the entry and exit of
each ``train.step`` span; the median over the window's steps.  Source: the
program's counter."""

from tsodbench import spans


def read(run):
    return spans.median_launches("train.step")
