"""The share of the window's hash-route decisions that took the bucketed
join (``join.algorithm{kind=hash->hash_bucketed}``) rather than the sort
join after a chain overflow (``hash->sort_overflow``), in %."""


def read(ctx):
    bucketed = ctx.counter("join.algorithm", kind="hash->hash_bucketed")
    fallback = ctx.counter("join.algorithm", kind="hash->sort_overflow")
    if bucketed is None or not bucketed + fallback:
        return None
    return 100.0 * bucketed / (bucketed + fallback)
