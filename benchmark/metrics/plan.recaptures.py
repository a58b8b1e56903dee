"""The increase of the program's ``plan.compile_count`` counter over the
window: warm-ups and captures that a replay should have made needless."""


def read(ctx):
    return ctx.counter("plan.compile_count")
