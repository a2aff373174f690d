"""Mean milliseconds of the program's `serve.core` span, one a micro-batch
(the batched device core on the leader's thread), over the batches that ran
the window's requests."""
from portbench import program_spans


def read(ctx):
    return program_spans.mean_core_ms(ctx)
