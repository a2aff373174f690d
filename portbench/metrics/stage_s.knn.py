"""Mean seconds a call of the window spends in the program's `estimate.knn`
span (the host kNN of `estimate_normals`)."""
from portbench import program_spans


def read(ctx):
    return program_spans.seconds_per_call(ctx, "estimate.knn")
