"""K8 ``ss2d_scan_bwd``'s share of its roofline: the bound of every K8 call
of the window's steps, from the SS2D shapes of the configuration, over the
device time of K8's launches."""

from tsodbench import counts


def read(run):
    if run.trace is None:
        return None
    t = run.trace.group_s.get("K8 ss2d_scan_bwd", 0.0)
    if t <= 0:
        return None
    B = run.cell.traffic["batch"]
    return 100.0 * counts.k8_bound_per_step(run.cell.config["model"], B) * run.calls / t
