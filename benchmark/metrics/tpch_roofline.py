"""A query's least time (the columns it reads, read once, and its result
written once, at the card's memory rate) as a share of the device's busy
time in the window."""

from benchmark.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx)
