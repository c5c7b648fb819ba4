"""The training step's share of one H100's bf16 peak: three times an
image's forward FLOPs (forward and backward, no recompute counted) times the
images the window trained on, over the window's seconds."""

from tsodbench import counts


def read(run):
    if not run.images:
        return None
    flops = 3 * counts.forward_flops(run.cell.config["model"])["total"]
    return 100.0 * flops * run.images / run.window_s / counts.PEAK_OPS_PER_S["bf16"]
