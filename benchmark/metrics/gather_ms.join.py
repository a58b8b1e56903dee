"""Device ms of the program's ``gather`` span (``take_columns``: the row
gather, from packing to unpacking), per traced operation."""

from benchmark.harness import program


def read(ctx):
    return program.device_ms_per_op(ctx, "gather")
