"""Calls that waited for the card (``set_sync_debug_mode("warn")``) over
the window, per operation; the harness's own wait after each is not
counted."""

from benchmark.harness import readers


def read(ctx):
    return readers.syncs_per_op(ctx)
