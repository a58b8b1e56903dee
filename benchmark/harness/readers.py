"""Arithmetic that several metric readers share. Each returns None where
the run gave it nothing to read (no trace, no sync count)."""

import statistics


def walls(ctx) -> list:
    """Seconds of each operation of the window, issue to complete."""
    return [r.wall for r in ctx.records]


def p95(values) -> float:
    """The 95th percentile of ``values``, all of them (``statistics``'
    inclusive quantiles; one value is its own)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def syncs_per_op(ctx):
    """Syncs over the traced operations, per operation."""
    if ctx.syncs is None or not ctx.traced:
        return None
    return ctx.syncs / len(ctx.traced)


def roofline_pct(ctx):
    """The least time the traced operations need (their bytes over the
    card's memory rate), as a share of the device's busy time."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.least_seconds(ctx.traced) / ctx.trace.busy_s


def idle_pct(ctx):
    """The share of the traced window in which nothing ran on the card."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
