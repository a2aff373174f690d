"""Mean milliseconds a request of the window spends in the program's
`serve.admission` span (the quadratic-memory quota, its poll included)."""
from portbench import program_spans


def read(ctx):
    return program_spans.mean_per_request_ms(ctx, "serve.admission")
