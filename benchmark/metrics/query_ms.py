"""The window's milliseconds over the number of queries it ran."""


def read(ctx):
    return 1e3 * ctx.window.seconds / len(ctx.records)
