"""Mean self time of a call of the window, in seconds: its `api.orient_simple`
span less what its direct child spans (the stages, `transform`,
`transform.inverse`) cover."""
from portbench import program_spans


def read(ctx):
    return program_spans.self_seconds_per_call(ctx)
