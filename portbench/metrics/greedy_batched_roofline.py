"""The batched column greedy's share of its roofline: the least time the
window's batched jobs need on the data-sheet peaks (each a column greedy
over its cloud, counts/ops.greedy_columns; the jobs run alone take the row
greedy and are not counted), over the device time of greedy_batched_kernel
in the trace."""
from portbench.counts import peaks

KERNEL = "greedy_batched_kernel"


def read(ctx):
    if ctx.timeline is None:
        return None
    seconds, launches = ctx.timeline.kernel_s(KERNEL)
    n_ops, n_bytes = ctx.work.get("greedy_batched", (0, 0))
    if not launches or not n_ops:
        return None
    return peaks.share_pct(peaks.bound_s(n_bytes, n_ops)[0], seconds)
