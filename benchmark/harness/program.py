"""Readers of what the program counts and times itself, over the window:
its counters per operation and the device time of its device-timed spans
(``<span>.device``, which it records while a profiler session runs, so
over the traced operations). Each returns None where the program has no
such series (a program older than them) or the run none to read."""


def has(ctx, name: str) -> bool:
    """Whether the program's telemetry over the window holds a series
    ``name`` (a counter that counted nothing still has one)."""
    delta = getattr(ctx, "_delta", None)
    return bool(delta) and any(d["name"] == name for d in delta.values())


def counter_total(ctx, name: str):
    """The counter's increase over the window."""
    return ctx.counter(name) if has(ctx, name) else None


def counter_per_op(ctx, name: str):
    """The counter's increase over the window, per operation of it."""
    if not has(ctx, name) or not ctx.records:
        return None
    return ctx.counter(name) / len(ctx.records)


def device_s(ctx, span: str):
    """Seconds of ``<span>.device`` over the traced operations."""
    got = ctx.span(f"{span}.device")
    if not got or not got[0] or not ctx.traced:
        return None
    return got[1]


def device_s_per_op(ctx, span: str):
    """Seconds of ``<span>.device`` per traced operation."""
    s = device_s(ctx, span)
    return None if s is None else s / len(ctx.traced)


def device_ms_per_op(ctx, span: str):
    s = device_s_per_op(ctx, span)
    return None if s is None else 1e3 * s


def device_ms_per_span(ctx, span: str):
    """Mean ms of ``<span>.device`` per span."""
    got = ctx.span(f"{span}.device")
    if not got or not got[0]:
        return None
    return 1e3 * got[1] / got[0]
