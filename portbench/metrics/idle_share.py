"""The share of the traced window, in %, in which no device operation
(kernel, copy or set) ran, from torch.profiler's trace; the reader of
idle_share.batch and idle_share.serve alike."""


def read(ctx):
    t = ctx.timeline
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
