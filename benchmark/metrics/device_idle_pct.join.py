"""100 minus the share of the traced window covered by the union of the
device operations' intervals."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
