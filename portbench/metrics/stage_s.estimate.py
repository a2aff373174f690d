"""Mean seconds a call spends in the program's "estimate unoriented normals" stage
(utils/timing.py's clock, which synchronizes at the stage's end)."""


def read(ctx):
    total = ctx.stages.get("estimate unoriented normals")
    if total is None or not ctx.calls:
        return None
    return total / ctx.calls
