"""Mean milliseconds a request of the window spends in the program's
`serve.estimate` span (the handler's host stage: kNN, PCA, transform)."""
from portbench import program_spans


def read(ctx):
    return program_spans.mean_per_request_ms(ctx, "serve.estimate")
