"""Set operations: unique, union, intersect, subtract, and row equality.

Port of ``cylon_tpu/ops/setops.py`` (parity: ``cpp/src/cylon/table.cpp``
Union :531, Subtract :603, Intersect :661, Unique :913). Results are
distinct rows. All four come down to dense group ids over the rows
(:func:`cylon_tpu_torch.ops.kernels.group_sort`: one lexicographic sort,
no hash table, no collision) and counts a side; the first occurrence's
order in the left table is kept (pandas' ``drop_duplicates``).

``jax.ops.segment_sum`` becomes an int32 ``scatter_add`` and
``segment_min`` a ``scatter_reduce("amin")``: integers, so every call
gives the same bits.
"""

from typing import Sequence

import torch

from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.dictenc import unify_table_dictionaries
from cylon_tpu_torch.ops.selection import take_columns


def _trim_capacity(t, out_cap: int, nrows):
    """The first ``out_cap`` slots of ``t`` WITHOUT clamping ``nrows``
    (port of ``cylon_tpu/ops/setops.py:30``): an overflowed count keeps
    poisoning ``num_rows``."""
    from cylon_tpu_torch.table import Table

    if out_cap >= t.capacity:
        return t
    cols = {n: Column(c.data[:out_cap],
                      None if c.validity is None else c.validity[:out_cap],
                      c.dtype, c.dictionary)
            for n, c in t.columns.items()}
    return Table(cols, nrows)


def unique(table, cols: "Sequence[str] | None" = None, keep: str = "first",
           out_capacity: "int | None" = None):
    """Distinct rows by ``cols`` (default all columns), the first or last
    occurrence of each, in their order (port of
    ``cylon_tpu/ops/setops.py:42-106``; parity ``Table::Unique`` / pandas
    ``drop_duplicates``). One group sort carrying the row index: a
    group's first (last) row in the stable order is its first (last)
    occurrence. The representatives' indices, sorted, feed one gather.
    ``out_capacity`` bounds the result; the true distinct count stays
    ``nrows``, so that an overflow raises at ``num_rows``."""
    if keep not in ("first", "last"):
        raise InvalidArgument(f"keep={keep!r}")
    cap = table.capacity
    out_cap = int(out_capacity if out_capacity is not None else cap)
    names = list(cols) if cols is not None else table.column_names
    dev = table.device
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    gid_s, num_groups, (orig_s,) = kernels.group_sort(
        [table.column(n).data for n in names], table.nrows,
        [table.column(n).validity for n in names], payloads=[iota])
    if keep == "first":
        is_rep = (gid_s != torch.roll(gid_s, 1)) | (iota == 0)
    else:
        is_rep = (gid_s != torch.roll(gid_s, -1)) | (iota == cap - 1)
    is_rep &= gid_s < cap                  # padding holds the id cap
    reps = torch.sort(torch.where(is_rep, orig_s, cap)).values
    out = take_columns(table, reps, num_groups)
    return kernels.carry_overflow(_trim_capacity(out, out_cap, num_groups),
                                  table)


def _group_counts(gid: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int32 rows a group id, ids >= n (padding) dropped
    (``segment_sum`` of ones)."""
    slot = torch.clamp(gid, max=n).to(torch.int64)
    return torch.zeros(n + 1, dtype=torch.int32, device=gid.device
                       ).scatter_add_(0, slot, torch.ones_like(
                           gid, dtype=torch.int32))[:n]


def _two_table_gids(a, b, cols: "Sequence[str] | None"):
    """Dense group ids over the rows of ``a`` then ``b`` and each group's
    rows a side (port of ``cylon_tpu/ops/setops.py:109``). Dictionaries
    unify and string storages align first; a key nullable on one side
    gets an all-valid mask on the other."""
    from cylon_tpu_torch.ops.bytescol import align_table_strings

    a, b = unify_table_dictionaries([a, b])
    a, b = align_table_strings([a, b])
    names = cols if cols is not None else a.column_names
    if [c for c in names if c not in b.column_names]:
        raise InvalidArgument("set op requires matching schemas")
    ca, cb = a.capacity, b.capacity
    dev = a.device
    keys, vals = [], []
    for n in names:
        x, y = a.column(n), b.column(n)
        if x.data.dtype != y.data.dtype:
            raise InvalidArgument(f"dtype mismatch on {n}")
        keys.append(torch.cat([x.data, y.data]))
        if x.validity is None and y.validity is None:
            vals.append(None)
            continue
        xv = torch.ones(ca, dtype=torch.bool, device=dev) \
            if x.validity is None else x.validity
        yv = torch.ones(cb, dtype=torch.bool, device=dev) \
            if y.validity is None else y.validity
        vals.append(torch.cat([xv, yv]))
    cvalid = torch.cat([kernels.valid_mask(ca, a.nrows, dev),
                        kernels.valid_mask(cb, b.nrows, dev)])
    gid, _, _ = kernels.dense_group_ids(keys, cvalid, vals)
    ncomb = ca + cb
    return (a, b, gid, _group_counts(gid[:ca], ncomb),
            _group_counts(gid[ca:], ncomb), ncomb)


def _select_a_groups(a, gid_a, group_keep, ncomb: int,
                     out_capacity: "int | None" = None):
    """The first row of ``a`` of every group that ``group_keep`` marks,
    in ``a``'s order (port of ``cylon_tpu/ops/setops.py:141``)."""
    ca = a.capacity
    dev = a.device
    iota = torch.arange(ca, dtype=torch.int64, device=dev)
    in_group = gid_a < ncomb
    slot = torch.clamp(gid_a, 0, ncomb).to(torch.int64)
    safe = torch.clamp(slot, max=max(ncomb - 1, 0))
    # segment_min of the row index: a row is its group's first in a
    first = torch.full((ncomb + 1,), ca, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, slot, torch.where(in_group, iota, ca), "amin")
    keep_row = in_group & group_keep[safe] & (first[safe] == iota)
    perm, count = kernels.compact_mask(keep_row, a.nrows)
    out = take_columns(a, perm, count)
    if out_capacity is not None:
        out = _trim_capacity(out, out_capacity, count)
    return kernels.carry_overflow(out, a)


def union(a, b, out_capacity: "int | None" = None):
    """Distinct rows in either table (port of
    ``cylon_tpu/ops/setops.py:161``; parity ``Table::Union``). The concat
    keeps every input row; ``out_capacity`` bounds only the result."""
    from cylon_tpu_torch.ops.selection import concat_tables

    return unique(concat_tables([a, b]), out_capacity=out_capacity)


def intersect(a, b, out_capacity: "int | None" = None):
    """Distinct rows in both tables (port of
    ``cylon_tpu/ops/setops.py:172``; parity ``Table::Intersect``)."""
    a, b, gid, cnt_a, cnt_b, ncomb = _two_table_gids(a, b, None)
    return _select_a_groups(a, gid[:a.capacity], (cnt_a > 0) & (cnt_b > 0),
                            ncomb, out_capacity)


def subtract(a, b, out_capacity: "int | None" = None):
    """Distinct rows of ``a`` not in ``b`` (port of
    ``cylon_tpu/ops/setops.py:179``; parity ``Table::Subtract``)."""
    a, b, gid, cnt_a, cnt_b, ncomb = _two_table_gids(a, b, None)
    return _select_a_groups(a, gid[:a.capacity],
                            (cnt_a > 0) & (cnt_b == 0), ncomb, out_capacity)


def equal_tables(a, b, ordered: bool = False) -> bool:
    """Row equality (port of ``cylon_tpu/ops/setops.py:187``; the oracle
    of ``cpp/test/test_utils.hpp:36-60``, stricter): the same multiset of
    rows, or with ``ordered`` the same rows in the same places. NaN
    equals NaN and a null a null (the order keys' canonical forms)."""
    if a.column_names != b.column_names:
        return False
    if ordered:
        aligned = align_for_equal(a, b)
        if aligned is None:
            return False
        a, b = aligned
        eq = _ordered_equal(a, b)
        counts = torch.stack([a.nrows, b.nrows, eq.to(torch.int32)]).tolist()
        for t, n in zip((a, b), counts[:2]):
            if n > t.capacity:
                raise OutOfCapacity(
                    f"table rows {n} exceed capacity {t.capacity}")
        return bool(counts[2])
    if a.num_rows != b.num_rows:
        return False
    _, _, _, cnt_a, cnt_b, _ = _two_table_gids(a, b, None)
    return bool((cnt_a == cnt_b).all())


def align_for_equal(a, b):
    """String storages aligned for a positional compare (port of
    ``cylon_tpu/ops/setops.py:223``): a bytes / dictionary pair converts
    to bytes at one width, dictionary pairs unify. ``(a, b)``, or None
    where a string column faces a non-string one (never equal)."""
    from cylon_tpu_torch.ops.bytescol import align_storages
    from cylon_tpu_torch.ops.dictenc import unify_dictionaries

    for n in a.column_names:
        ca, cb = a.column(n), b.column(n)
        if ca.dtype.is_bytes or cb.dtype.is_bytes:
            if not (ca.dtype.is_bytes or ca.dtype.is_dictionary) or \
                    not (cb.dtype.is_bytes or cb.dtype.is_dictionary):
                return None
            ca, cb = align_storages([ca, cb])
            a, b = a.add_column(n, ca), b.add_column(n, cb)
            continue
        if ca.dtype.is_dictionary != cb.dtype.is_dictionary:
            return None
        if ca.dtype.is_dictionary and ca.dictionary != cb.dictionary:
            ca, cb = unify_dictionaries([ca, cb])
            a, b = a.add_column(n, ca), b.add_column(n, cb)
    return a, b


def _columns_equal(a, b, m: int, mask: torch.Tensor) -> torch.Tensor:
    """0-d bool: every row of the leading ``m`` that ``mask`` marks
    equal, column by column (port of ``cylon_tpu/ops/setops.py:252``):
    equal validity, and equal order keys where valid."""
    eq = torch.ones((), dtype=torch.bool, device=mask.device)
    for n in a.column_names:
        ca, cb = a.column(n), b.column(n)
        if ca.data.shape[1:] != cb.data.shape[1:] or \
                ca.data.dtype != cb.data.dtype:
            return torch.zeros((), dtype=torch.bool, device=mask.device)
        ka = kernels.order_key(ca.data[:m]).value.reshape(m, -1)
        kb = kernels.order_key(cb.data[:m]).value.reshape(m, -1)
        ones = torch.ones(m, dtype=torch.bool, device=mask.device)
        va = ones if ca.validity is None else ca.validity[:m]
        vb = ones if cb.validity is None else cb.validity[:m]
        same = (va == vb) & (~va | (ka == kb).all(dim=1))
        eq = eq & torch.where(mask, same, True).all()
    return eq


def _ordered_equal(a, b) -> torch.Tensor:
    """Positional equality on the device (the JAX package's
    ``_ordered_equal_compiled``)."""
    m = min(a.capacity, b.capacity)
    mask = kernels.valid_mask(m, torch.clamp(a.nrows, max=m), a.device)
    return (a.nrows == b.nrows) & _columns_equal(a, b, m, mask)


def dist_ordered_equal_compiled(env, a, b) -> bool:
    """Positional equality of two distributed tables of one shard layout
    (port of ``cylon_tpu/ops/setops.py:279``): each rank compares its own
    shards, then ONE all-reduce sums every rank's mismatch flag and
    counts; no table is gathered. The same answer on every rank."""
    cap = a.capacity
    na = torch.clamp(a.nrows, max=cap)
    nb = torch.clamp(b.nrows, max=b.capacity)
    if cap == b.capacity:
        same = (na == nb) & _columns_equal(
            a, b, cap, kernels.valid_mask(cap, na, a.device))
    else:
        same = torch.zeros((), dtype=torch.bool, device=a.device)
    bad, ta, tb = env.comm.all_reduce(
        torch.stack([(~same).to(torch.int64), na.to(torch.int64),
                     nb.to(torch.int64)]), "sum").tolist()
    return bad == 0 and ta == tb
