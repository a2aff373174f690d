"""A whole call's share of the fp32 peak, in %: the device operations that
the window's calls need, counted by counts/ops from the inputs' shapes
(never from the program's launches), over the window's seconds times the
67 TFLOP/s fp32 peak (the H100 SXM data sheet, at its 700 W limit)."""
from portbench.counts import peaks


def read(ctx):
    n_ops = ctx.work.get("call_ops")
    if not n_ops or not ctx.window_s:
        return None
    return 100.0 * n_ops / (ctx.window_s * peaks.PEAK_FLOPS_F32)
