"""Mean milliseconds a request of the window spends in the program's
`serve.queue` span: from the micro-batcher's submit until a batch leader
hands its job to a runner (the batch window, or the wait behind a batch)."""
from portbench import program_spans


def read(ctx):
    return program_spans.mean_per_request_ms(ctx, "serve.queue")
