"""Jobs per micro-batch over the window: the change of the server's
MicroBatcher.jobs_run over the change of its batches_run."""


def read(ctx):
    batches = ctx.counters.get("batches_run", 0)
    if not batches:
        return None
    return ctx.counters.get("jobs_run", 0) / batches
