"""Scalar aggregates of one column.

Port of ``cylon_tpu/ops/aggregates.py`` (parity: ``compute::Sum/Count/
Min/Max``, ``compute/aggregates.cpp:26-147``): a masked reduction on this
rank; :func:`cylon_tpu_torch.parallel.dist_ops.dist_aggregate` adds the
all-reduce across ranks.
"""

import torch

from cylon_tpu_torch import dtypes, plan
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.selection import _null_flags

AGGS = ("sum", "count", "min", "max", "mean", "var", "std", "nunique",
        "median", "quantile")


def _masked_quantile(data: torch.Tensor, ok: torch.Tensor,
                     q: float) -> torch.Tensor:
    """pandas' linear-interpolation quantile over the rows ``ok`` marks
    (port of ``cylon_tpu/ops/aggregates.py:22``): sort with the missing
    rows at the high sentinel, read at ``q * (n - 1)``; NaN when no row
    counts."""
    if not 0.0 <= q <= 1.0:
        raise InvalidArgument(f"quantile {q} not in [0, 1]")
    f = torch.float64 if data.element_size() >= 4 else torch.float32
    sent = torch.full((), dtypes.sentinel_high(data.dtype), dtype=data.dtype,
                      device=data.device)
    s = torch.sort(torch.where(ok, data, sent)).values.to(f)
    n = ok.sum(dtype=torch.int32)
    pos = q * torch.clamp(n - 1, min=0).to(f)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.ceil(pos).to(torch.int32)
    vlo = kernels._rows_at(s, lo.reshape(1), 1)[0]
    vhi = kernels._rows_at(s, hi.reshape(1), 1)[0]
    out = vlo + (vhi - vlo) * (pos - lo.to(f))
    return torch.where(n > 0, out, torch.full((), float("nan"), dtype=f,
                                              device=data.device))


def _masked_extreme(data: torch.Tensor, ok: torch.Tensor,
                   op: str) -> torch.Tensor:
    """0-d min (``op="min"``) or max of ``data`` where ``ok``: the
    dtype's sentinel when no row counts (so an empty rank folds into a
    world's min as nothing)."""
    sent = dtypes.sentinel_high(data.dtype) if op == "min" \
        else dtypes.sentinel_low(data.dtype)
    fill = torch.full((1,), sent, dtype=data.dtype, device=data.device)
    # one sentinel row more: the reduction of no rows is the sentinel
    v = torch.cat([torch.where(ok, data, fill), fill])
    if v.is_floating_point():
        return v.min() if op == "min" else v.max()
    # integers and bool as int64 (uint64 with its top bit flipped, so
    # that signed order is unsigned order), which every device reduces
    dt = v.dtype
    iv = (v.view(torch.int64) ^ kernels._MIN64) if dt == torch.uint64 \
        else v.to(torch.int64)
    r = iv.amin() if op == "min" else iv.amax()
    if dt == torch.uint64:
        return (r ^ kernels._MIN64).view(torch.uint64)
    return r.to(dt)


def _masked_sum(data: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """0-d sum of ``data`` where ``ok``, in the sum dtype of
    :func:`cylon_tpu_torch.ops.kernels._acc_dtype` (unsigned sums on
    their bit patterns)."""
    acc = kernels._acc_dtype(data.dtype)
    if acc == torch.uint64:
        v = data.view(torch.int64) if data.dtype == torch.uint64 \
            else data.to(torch.int64)
        return torch.where(ok, v, 0).sum().view(torch.uint64)
    return torch.where(ok, data.to(acc), 0).sum()


def table_aggregate(table, col: str, op: str, quantile: float = 0.5):
    """Scalar aggregate of one column, skipping nulls and NaNs (port of
    ``cylon_tpu/ops/aggregates.py:46``): a 0-d tensor on the table's
    device. An overflowed input (``nrows > capacity``) gives NaN for a
    float result and ``iinfo.min`` for an integer one (False for bool),
    never a plausible number, and registers its flag with the enclosing
    :class:`~cylon_tpu_torch.plan.CompiledQuery`
    (:func:`~cylon_tpu_torch.plan.note_overflow`), which then regrows or
    raises instead of returning the poison."""
    if op not in AGGS:
        raise InvalidArgument(f"unknown aggregate {op!r}")
    c = table.column(col)
    cap = table.capacity
    bad = table.nrows > cap
    plan.note_overflow(bad)
    vmask = kernels.valid_mask(cap, table.nrows, c.data.device)
    nulls = _null_flags(c)
    ok = vmask if nulls is None else vmask & (nulls == 0)
    data = c.data
    if op == "count":
        val = ok.sum(dtype=torch.int64)
    elif op == "nunique":
        _, num_groups, _ = kernels.dense_group_ids([data], ok, [None])
        val = num_groups.to(torch.int64)
    elif op in ("median", "quantile"):
        val = _masked_quantile(data, ok, 0.5 if op == "median" else quantile)
    elif op == "sum":
        val = _masked_sum(data, ok)
    elif op in ("min", "max"):
        val = _masked_extreme(data, ok, op)
    else:
        f = torch.float64 if data.element_size() >= 4 else torch.float32
        vals = torch.where(ok, data.to(f), 0.0)
        n = ok.sum(dtype=f)
        s = vals.sum()
        val = _moments(op, s, n,
                      None if op == "mean" else (vals * vals).sum())
    return _poisoned(val, bad)


def _moments(op: str, s, n, sq=None):
    """mean, var or std (ddof 1, pandas' default) from a sum, a count and
    (but for the mean) a sum of squares, as the JAX package computes
    them."""
    if op == "mean":
        return s / torch.clamp(n, min=1.0)
    var = (sq - s * s / torch.clamp(n, min=1.0)) \
        / torch.clamp(n - 1.0, min=1.0)
    var = torch.clamp(var, min=0.0)
    return torch.sqrt(var) if op == "std" else var


def _poisoned(val: torch.Tensor, bad) -> torch.Tensor:
    """``val``, or where ``bad`` holds NaN (floats), ``iinfo.min``
    (integers) or False (bool)."""
    if val.is_floating_point():
        sent = float("nan")
    elif val.dtype == torch.bool:
        sent = False
    else:
        sent = torch.iinfo(val.dtype).min
    return torch.where(bad, torch.full((), sent, dtype=val.dtype,
                                       device=val.device), val)
