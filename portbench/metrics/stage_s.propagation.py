"""Mean seconds a call spends in the program's "dipole propagation" stage
(utils/timing.py's clock, which synchronizes at the stage's end)."""


def read(ctx):
    total = ctx.stages.get("dipole propagation")
    if total is None or not ctx.calls:
        return None
    return total / ctx.calls
