"""The join's least time (both inputs' columns read once and the result's
columns written once, at the card's memory rate; memory-bound, no
arithmetic term) as a share of the device's busy time in the window."""

from benchmark.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx)
