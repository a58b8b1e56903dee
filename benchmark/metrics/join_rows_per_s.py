"""Input rows of both tables of every join of the window, over the
window's seconds (from its start to the end of its last join)."""


def read(ctx):
    return sum(ctx.workload.op_rows(r.index) for r in ctx.records
               if not r.failed) / ctx.window.seconds
