"""The row gather's least time (the program's ``gather.bytes``: per row
of each gather's result its index, one source row read and one output
row written, at the card's memory rate) as a share of the device time of
its ``gather`` span, both counted over the traced operations (the
program counts the bytes only while its device-timed spans record), in
%."""

from benchmark.harness import program


def read(ctx):
    nbytes = program.counter_total(ctx, "gather.bytes")
    seconds = program.device_s(ctx, "gather")
    if nbytes is None or not seconds:
        return None
    return 100.0 * nbytes / ctx.bandwidth / seconds
