"""Mean host ms of the program's ``plan.dispatch`` span (a replay's
copy-in and launch) per span, over the window."""


def read(ctx):
    span = ctx.span("plan.dispatch")
    if not span or not span[0]:
        return None
    return 1e3 * span[1] / span[0]
