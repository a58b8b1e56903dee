"""Group-by aggregation: one group sort, then segment reductions.

Port of ``cylon_tpu/ops/groupby.py`` (parity: ``groupby/hash_groupby.cpp``
``make_groups`` :90 and ``aggregate<op>`` :143, the op set of
``compute/aggregate_kernels.hpp:40-52``). Group ids come from one
lexicographic sort (:func:`cylon_tpu_torch.ops.kernels.group_sort`,
collision-free), and every per-group reduction runs over the
group-sorted layout (:func:`cylon_tpu_torch.ops.kernels.segmented_totals`).

The JAX package has two reduction routes (``_use_segscan``: XLA segment
ops on the CPU, a fused segmented scan on the TPU); the port has one, and
its tests hold it against both. Output groups are key-sorted, null keys
last (pandas ``sort=True``); nulls and NaNs in value columns are skipped
(pandas ``skipna``).
"""

from typing import Sequence

import torch

from cylon_tpu_torch import dtypes, plan
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity, TypeError_
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.aggregates import _moments
from cylon_tpu_torch.ops.selection import _null_flags, take_columns
from cylon_tpu_torch.table import Table
from cylon_tpu_torch.utils.tracing import host_read, traced

#: ops supported (parity: aggregate_kernels.hpp:40-52 + pandas extras).
#: "sumsq" is internal: the mergeable partial of distributed var/std.
AGG_OPS = ("sum", "count", "size", "min", "max", "mean", "var", "std",
           "nunique", "first", "last", "median", "quantile", "sumsq")

#: the ops a device-bytes value column takes (the others need a number)
_BYTES_OPS = ("count", "size", "first", "last", "nunique")

#: (capacity, by, aggs) -> the regrow ladder's settled scale, so that a
#: rerun at one shape dispatches once
_EAGER_SCALE_MEMO: dict = {}

_LOGICAL = {torch.float32: dtypes.float32, torch.float64: dtypes.float64,
            torch.int64: dtypes.int64, torch.uint64: dtypes.uint64}


@traced("groupby")
def groupby_aggregate(table: Table, by: Sequence[str], aggs,
                      out_capacity: "int | None" = None,
                      quantile: float = 0.5) -> Table:
    """Aggregate ``table`` grouped by the key columns ``by`` (port of
    ``cylon_tpu/ops/groupby.py:92``).

    ``aggs``: ``(src_column, op[, out_name])`` tuples, op from
    :data:`AGG_OPS`. Result: one row per distinct key tuple, keys first
    then the aggregates, key-sorted; null keys form one group. Without
    ``out_capacity`` the group bound starts optimistic, ``max(8192,
    capacity // 16)``, and doubles while the groups overflow it (one
    host sync a rung; each rung a full sort), the settled scale
    remembered per shape."""
    cap = table.capacity
    by_t = tuple(by)
    aggs_t = tuple(tuple(a) for a in aggs)

    def dispatch(oc):
        return _groupby_compiled(table, by=by_t, aggs=aggs_t, out_cap=oc,
                                 quantile=float(quantile))

    if out_capacity is not None:
        return dispatch(int(out_capacity))

    def bound(scale):
        return min(cap, max(8192, cap // 16) * scale)

    def fixed(b):
        # in capture mode one rung, at the graph warm-up's bound or the
        # ambient scale's; the whole query regrows on the overflow
        # (``cylon_tpu/ops/groupby.py:126``). Groups never outnumber
        # rows, so a bound of the whole capacity cannot overflow, and an
        # upstream overflow is the upstream op's flag
        b = bound(plan.current_scale()) if b is None else b
        t = dispatch(b)
        if b < cap:
            plan.note_overflow(t.nrows > t.capacity)
        return t

    return plan.settle(("groupby", cap), lambda: _ladder(
        table, (cap, by_t, aggs_t), bound, dispatch), fixed)


def _ladder(table: Table, key, bound, dispatch):
    """The group-by's eager ladder: ``(result, the bound it fitted)``."""
    cap = table.capacity
    # from the ambient scale too (``cylon_tpu/ops/groupby.py:140``). The
    # settled scale is not reported to an enclosing CompiledQuery: its
    # optimistic bound is another ladder than the joins' and exchanges',
    # and one scale for all would grow every join buffer by the group
    # bound's factor. The memo keeps only what this ladder climbed to,
    # never an ambient floor: a compiled query that regrew its joins
    # says nothing of this group count
    start = scale = max(plan.current_scale(), _EAGER_SCALE_MEMO.get(key, 1))
    while True:
        plan.rung()
        t = dispatch(bound(scale))
        try:
            host_read("count", lambda: t.num_rows)   # raises on overflow
        except OutOfCapacity:
            # an upstream overflow rides carry_overflow and would raise
            # at every rung: groups never outnumber rows
            if host_read("groupby_bound", lambda: int(table.nrows)) > cap \
                    or bound(scale) >= cap:
                return t, bound(scale)
            scale *= 2
            continue
        if scale > start:
            _EAGER_SCALE_MEMO[key] = scale
        return t, bound(scale)


class _Channels:
    """The segment reductions of one group-by, each registered once (a
    count shared by count, min and mean is reduced once)."""

    def __init__(self):
        self.channels = []
        self._index = {}

    def add(self, key, kind: str, value) -> int:
        """Index of the channel ``key``; ``value()`` makes its input the
        first time."""
        if key not in self._index:
            self._index[key] = len(self.channels)
            self.channels.append((kind, value()))
        return self._index[key]


def _groupby_compiled(table: Table, *, by, aggs, out_cap: int,
                      quantile: float) -> Table:
    """One group-by at the group bound ``out_cap`` (port of
    ``cylon_tpu/ops/groupby.py:160``; eager, the name kept): one
    ``group_sort`` of the keys carrying the row index, the value columns
    brought into group order by one packed row gather
    (``take_columns``), every reduction in one
    :func:`~cylon_tpu_torch.ops.kernels.segmented_totals` call (nunique
    and quantiles sort their own), the keys read at each group's first
    row. ``nrows`` is the group count, past ``out_cap`` on overflow."""
    specs = []
    for spec in aggs:
        src, op, name = spec if len(spec) == 3 else (*spec, None)
        if op not in AGG_OPS:
            raise InvalidArgument(f"unknown aggregation {op!r}")
        specs.append((src, op, name or f"{src}_{op}"))
    src_names = list(dict.fromkeys(src for src, _, _ in specs))
    cap = table.capacity
    keys = [table.column(n).data for n in by]
    kvals = [table.column(n).validity for n in by]
    iota = torch.arange(cap, dtype=torch.int32, device=table.device)
    gid_s, num_groups, (orig_idx,) = kernels.group_sort(
        keys, table.nrows, kvals, payloads=[iota])
    stab = take_columns(table, orig_idx, table.nrows, names=src_names)
    gvalid = torch.arange(out_cap, dtype=torch.int32,
                          device=table.device) < num_groups

    reg = _Channels()
    plans = [(name, _aggregate_column(stab, src, op, gid_s, gvalid, out_cap,
                                      quantile, reg))
             for src, op, name in specs]
    outputs, (first_orig,) = kernels.segmented_totals(
        gid_s, out_cap, reg.channels, extras=[orig_idx])
    keytab = take_columns(table, first_orig, num_groups, names=list(by))
    out = {n: keytab.column(n) for n in by}
    for name, post in plans:
        out[name] = post(outputs)
    return kernels.carry_overflow(Table(out, num_groups), table)


def _aggregate_column(stab: Table, src: str, op: str, gid_s, gvalid,
                      out_cap: int, q: float, reg: _Channels):
    """Register the reductions ``op`` over ``src`` needs and return the
    function that makes its column from their outputs (port of
    ``cylon_tpu/ops/groupby.py:421``, in the registration form of its
    scan route, ``:236``). ``stab`` and ``gid_s`` are the group-sorted
    layout. Missing values are masked out of the values (zero or a
    sentinel), never out of the ids."""
    c = stab.column(src)
    cap = stab.capacity
    dev = c.data.device
    if c.data.dim() == 2 and op not in _BYTES_OPS:
        raise TypeError_(f"{op!r} of the string column {src!r}: a "
                         f"device-bytes column takes {_BYTES_OPS}")
    vmask = kernels.valid_mask(cap, stab.nrows, dev)
    nulls = _null_flags(c)
    ok = vmask if nulls is None else vmask & (nulls == 0)
    f = torch.float64 if c.data.element_size() >= 4 else torch.float32

    def masked(fill, dtype):
        data = c.data.to(dtype)
        return torch.where(ok, data, torch.full((), fill, dtype=dtype,
                                                device=dev))

    def count():
        return reg.add(("count", src), "sum", lambda: ok.to(torch.int32))

    def counted(i):
        return lambda o: Column(o[i][0].to(torch.int64), None, dtypes.int64)

    if op == "size":
        return counted(reg.add(("size",), "sum",
                               lambda: vmask.to(torch.int32)))
    if op == "count":
        return counted(count())
    if op == "sum":
        acc = kernels._acc_dtype(c.data.dtype)
        if acc == torch.uint64:
            # unsigned sums run on the bit patterns, in int64
            data = c.data.view(torch.int64) \
                if c.data.dtype == torch.uint64 else c.data.to(torch.int64)
            i = reg.add(("sum", src), "sum", lambda: torch.where(
                ok, data, torch.zeros((), dtype=torch.int64, device=dev)))
            return lambda o: Column(o[i][0].view(torch.uint64), None,
                                    dtypes.uint64)
        # a float sum is the mean's sum channel too
        key = ("fsum", src, acc) if acc.is_floating_point else ("sum", src)
        i = reg.add(key, "sum", lambda: masked(0, acc))
        return lambda o: Column(o[i][0], None, _LOGICAL[acc])
    if op == "sumsq":
        i = reg.add(("sumsq", src), "sum", lambda: _square(masked(0, f)))
        return lambda o: Column(o[i][0], None, _LOGICAL[f])
    if op in ("min", "max"):
        # dictionary codes are order-preserving: min / max of the codes
        # is min / max of the strings
        sent = dtypes.sentinel_high(c.data.dtype) if op == "min" \
            else dtypes.sentinel_low(c.data.dtype)
        i = reg.add((op, src), op, lambda: masked(sent, c.data.dtype))
        ic = count()
        return lambda o: Column(o[i][0], gvalid & (o[ic][0] > 0), c.dtype,
                                c.dictionary)
    if op in ("mean", "var", "std"):
        isum = reg.add(("fsum", src, f), "sum", lambda: masked(0, f))
        ic = count()
        isq = None if op == "mean" else \
            reg.add(("sumsq", src), "sum", lambda: _square(masked(0, f)))

        def post(o):
            n = o[ic][0].to(f)
            data = _moments(op, o[isum][0], n,
                            None if isq is None else o[isq][0])
            return Column(data, gvalid & (n > (0 if op == "mean" else 1)),
                          _LOGICAL[f])

        return post
    if op in ("first", "last"):
        # the stable group sort kept row order within each group, so the
        # first / last non-missing row is pandas' first / last
        i = reg.add((op, src), op, lambda: (c.data, ok))
        return lambda o: Column(o[i][0], gvalid & o[i][1], c.dtype,
                                c.dictionary)
    if op == "nunique":
        return lambda _o: _nunique(c, ok, gid_s, out_cap)
    qq = 0.5 if op == "median" else q
    return lambda _o: _quantile(c, ok, gid_s, gvalid, out_cap, qq)


def _square(v: torch.Tensor) -> torch.Tensor:
    return v * v


def _value_sort(c: Column, ok, gid_s):
    """Rows sorted by (group, value), the rows whose value is missing
    last with id ``capacity``: ``(perm, sorted ids, sorted key
    operands)``. A device-bytes value orders by its words, unsigned."""
    cap = c.data.shape[0]
    gid_v = torch.where(ok, gid_s, cap).to(torch.int64)
    ops = [kernels.sortable(k) for k in kernels.pack_order_keys(
        [kernels.OrderKey(gid_v, 32), kernels.order_key(c.data)])]
    perm = kernels.lexsort_perm(ops)
    return perm, gid_v[perm], [k[perm] for k in ops]


def _nunique(c: Column, ok, gid_s, out_cap: int) -> Column:
    """Distinct non-missing values per group (port of
    ``cylon_tpu/ops/groupby.py:518``): sort by (group, value), count the
    runs' starts in each group. Order-key equality is value equality
    (-0.0 equals 0.0)."""
    cap = c.data.shape[0]
    _, g_s, sorted_ops = _value_sort(c, ok, gid_s)
    iota = torch.arange(cap, dtype=torch.int32, device=c.data.device)
    start = iota == 0
    for k in sorted_ops:
        start |= k != torch.roll(k, 1)
    boundary = start & (g_s < cap)
    outputs, _ = kernels.segmented_totals(
        g_s, out_cap, [("sum", boundary.to(torch.int32))])
    return Column(outputs[0][0].to(torch.int64), None, dtypes.int64)


def _quantile(c: Column, ok, gid_s, gvalid, out_cap: int,
              q: float) -> Column:
    """Per-group linear-interpolated quantile of the non-missing values
    (port of ``cylon_tpu/ops/groupby.py:539``): sort by (group, value),
    then read each group's run at ``q * (n - 1)``, its start from an
    exclusive scan of the counts."""
    cap = c.data.shape[0]
    f = torch.float64 if c.data.element_size() >= 4 else torch.float32
    perm, g_s, _ = _value_sort(c, ok, gid_s)
    v_s = c.data[perm].to(f)
    outputs, _ = kernels.segmented_totals(
        g_s, out_cap, [("sum", (g_s < cap).to(torch.int32))])
    n = outputs[0][0]
    start = kernels.exclusive_cumsum(n)
    pos = q * torch.clamp(n - 1, min=0).to(f)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.ceil(pos).to(torch.int32)
    w = pos - lo.to(f)
    data = kernels._rows_at(v_s, start + lo, out_cap) * (1 - w) \
        + kernels._rows_at(v_s, start + hi, out_cap) * w
    return Column(data, gvalid & (n > 0), _LOGICAL[f])
