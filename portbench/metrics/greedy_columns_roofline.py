"""The column greedy's share of its roofline: the least time the window's
column greedies need on the data-sheet peaks (counts/ops.greedy_columns of
the cell's shapes), over the device time of greedy_owner_kernel in the
trace. Operation-bound: 37 operations a pair, n^2 pairs."""
from portbench.counts import peaks

KERNEL = "greedy_owner_kernel"


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds, launches = ctx.timeline.kernel_s(KERNEL)
    n_ops, n_bytes = ctx.work.get("greedy_columns", (0, 0))
    if not launches or not n_ops:
        return None
    return peaks.share_pct(peaks.bound_s(n_bytes, n_ops)[0], seconds)
