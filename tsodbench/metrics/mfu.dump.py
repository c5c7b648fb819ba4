"""The model's share of one H100's bf16 peak (989 TFLOP/s, dense): FLOPs of
an image's forward (counted over the plain reference: 2MNK per product, 9
per scanned state element) times the images the window completed, over
the window's seconds.  Source: the host clock and the work counts."""

from tsodbench import counts


def read(run):
    if not run.images:
        return None
    flops = counts.forward_flops(run.cell.config["model"])["total"]
    return 100.0 * flops * run.images / run.window_s / counts.PEAK_OPS_PER_S["bf16"]
