"""K1 ``ss2d_scan``'s share of its roofline: the bound of every K1 call of
the window's forwards, from the SS2D shapes of the configuration, over the
device time of K1's two launches (segment scans and projection)."""

from tsodbench import counts

GROUPS = ("K1 ss2d_scan, segment scans", "K1 ss2d_scan, projection")


def read(run):
    if run.trace is None:
        return None
    t = sum(run.trace.group_s.get(g, 0.0) for g in GROUPS)
    if t <= 0:
        return None
    B = run.cell.traffic["batch"]
    return 100.0 * counts.k1_bound_per_forward(run.cell.config["model"], B) * run.calls / t
