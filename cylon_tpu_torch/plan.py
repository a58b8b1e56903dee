"""Capacity scale and the eager regrow ladder.

The eager part of ``cylon_tpu/plan.py``. Operators with a defaulted
result bound (the local ``join``'s ``left.capacity + right.capacity``)
multiply it by the ambient :func:`current_scale`; :func:`regrow_eager`
runs one local op, reads its row count and, on an overflow, runs it
again at twice the scale, up to :data:`MAX_SCALE`. The JAX package's
whole-query compilation (``CompiledQuery``) is not ported yet.
"""

import contextlib
import contextvars

from cylon_tpu_torch.errors import OutOfCapacity

__all__ = ["MAX_SCALE", "capacity_scale", "current_scale", "regrow_eager"]

#: regrow ceiling: 1024x the default budget (``cylon_tpu/plan.py:58``)
MAX_SCALE = 1024

_SCALE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_capacity_scale", default=1)


@contextlib.contextmanager
def capacity_scale(scale: int):
    """Ambient multiplier for defaulted capacity bounds
    (``cylon_tpu/plan.py:99``)."""
    tok = _SCALE.set(int(scale))
    try:
        yield
    finally:
        _SCALE.reset(tok)


def current_scale() -> int:
    """The ambient scale (``cylon_tpu/plan.py:108``); 1 outside
    :func:`capacity_scale`."""
    return _SCALE.get()


def regrow_eager(run, *, bounded: bool):
    """Regrow ladder for one eager local op (``cylon_tpu/plan.py:730``).

    ``run()`` builds and runs the op, reading :func:`current_scale` for
    its defaulted bounds, and returns a local Table. ``bounded=True``
    (the caller passed an explicit capacity) keeps the raise-on-overflow
    contract: the result is returned unchecked. Otherwise the row count
    is read (one host sync) and an overflow reruns at twice the scale."""
    scale = current_scale()
    while True:
        with capacity_scale(scale):
            t = run()
        if bounded:
            return t
        try:
            t.num_rows
            return t
        except OutOfCapacity:
            if scale >= MAX_SCALE:
                raise
            scale *= 2
