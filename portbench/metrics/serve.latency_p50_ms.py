"""The median latency of the window's requests (ms, from when each was
due; a failed one counts as taking until the client gave up), as the
open loop's client timed it."""


def read(ctx):
    return getattr(ctx, "latency_p50_ms", None)
