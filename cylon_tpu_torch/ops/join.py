"""Relational equi-join (inner / left / right / full outer).

Port of ``cylon_tpu/ops/join.py:51-508`` (parity: ``join::JoinTables``,
``join/join.cpp:92-98``; semantics follow pandas ``merge``).

Dense-rank equi-join: the key columns of both sides are concatenated and
grouped by ONE lexicographic sort; per-group right-run counts and starts
broadcast to every row through scans and fills (the scan32 and
pair_max_scan kernels); the variable-size result is a prefix-sum
run-length expansion into a caller-bounded buffer; ``take_columns``
gathers the output. The JAX package's ``_join_compiled`` is the plain
function :func:`_join` here: torch runs eagerly.

``algorithm="hash"`` routes as in the JAX package
(:func:`_route_algorithm`): by default to the sort join grouped by murmur
bucket first (``group_sort(hash_first=True)``); with
``CYLON_TPU_JOIN_HASH_IMPL=bucketed`` to the bucketed build / probe of
:mod:`cylon_tpu_torch.ops.hash_join`, whose chains are checked on the
host first. An over-budget chain, or ``how="fullouter"``, takes the sort
join. Every route gives the same rows.

Inside a compiled query's graph the chain check cannot read the host:
the graph's warm-up checks the chains and records the route it took on
the :class:`~cylon_tpu_torch.plan.SizeTape` (:func:`_guarded_route`),
the capture takes that route back, and on the bucketed route registers
the build's overflow count as an overflow flag. A replay on data whose
chains no longer fit flags, and the query's rerun takes the sort join:
the port's counterpart of the JAX package's in-graph ``"hash_guarded"``
``lax.cond``.
"""

import os
from typing import TYPE_CHECKING, Sequence

import torch

from cylon_tpu_torch import plan, telemetry
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.kernels import gather_rows
from cylon_tpu_torch.ops import bytescol, dictenc, hash_join, kernels
from cylon_tpu_torch.ops.selection import take_columns
from cylon_tpu_torch.utils.logging import get_logger
from cylon_tpu_torch.utils.tracing import span, traced

if TYPE_CHECKING:
    from cylon_tpu_torch.config import JoinConfig

#: sort key of the invalid output slots: above every u32 row or group id
M32_MAX = 0xFFFFFFFF

#: routing downgrades already warned about: one warning a kind and process
_warned: set = set()


def _env_algorithm() -> "str | None":
    """``CYLON_TPU_JOIN_ALGORITHM``: process-wide override of the per-call
    ``algorithm`` ("sort" | "hash"; unset or other: the caller's)."""
    v = os.environ.get("CYLON_TPU_JOIN_ALGORITHM", "").lower()
    return v if v in ("sort", "hash") else None


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        get_logger().warning(msg)


def _route_algorithm(requested: str, how: str) -> str:
    """Resolve the ``algorithm`` hint to the routine :func:`_join` runs:
    "sort", "hash_sort" (the sort join grouped by murmur bucket first) or
    "hash_bucketed" (build / probe; the caller pre-checks the chains).
    "hash" is a hint, never an error: a ``how`` the bucketed join does not
    support takes the sort join, with one warning.

    Each decision counts once in ``join.algorithm{kind=requested->chosen}``
    (``cylon_tpu/ops/join.py:107``): here, unless the route is
    "hash_bucketed", whose count waits for :func:`_join`'s chain check
    ("hash->hash_bucketed", or "hash->sort_overflow" with
    ``join.overflow_fallbacks``), counted in a graph's warm-up and never
    in its capture (:func:`_guarded_route`).
    """
    chosen = requested
    if requested == "hash":
        if not hash_join.supported(how):
            _warn_once(f"hash-{how}",
                       f'join(algorithm="hash", how="{how}"): bucketed hash '
                       "join does not support this variant; taking the "
                       "sort path (the hint is honored where supported, "
                       "never an error)")
            chosen = "sort"
        elif hash_join.hash_impl() == "sort":
            chosen = "hash_sort"
        else:
            chosen = "hash_bucketed"
    if chosen != "hash_bucketed":
        telemetry.counter("join.algorithm",
                          kind=f"{requested}->{chosen}").inc()
    return chosen


def _key_list(keys) -> list:
    return [keys] if isinstance(keys, str) else list(keys or ())


@traced("join")
def join(left, right, config: "JoinConfig | None" = None, *,
         on: "Sequence[str] | str | None" = None,
         left_on: "Sequence[str] | str | None" = None,
         right_on: "Sequence[str] | str | None" = None,
         how: str = "inner", suffixes: tuple = ("_x", "_y"),
         out_capacity: "int | None" = None, algorithm: str = "sort",
         ordered: bool = True):
    """Equi-join two tables (pandas ``merge`` semantics).

    ``config``, a :class:`~cylon_tpu_torch.config.JoinConfig`, takes the
    place of ``on``, ``left_on``, ``right_on``, ``how``, ``suffixes`` and
    ``algorithm`` when given (``cylon_tpu/ops/join.py:147-152``).
    ``out_capacity`` bounds the static result size (default
    ``left.capacity + right.capacity``, enough for any 1:N join, times
    :func:`cylon_tpu_torch.plan.current_scale`); an
    overflow shows as ``nrows == out_capacity + 1`` and makes
    ``num_rows`` raise. ``ordered=False`` skips restoring pandas' output
    order (one stable sort of the index pairs); the row set is the same,
    and the order is still deterministic.
    """
    if config is not None:
        left_on, right_on = list(config.left_on), list(config.right_on)
        how = config.join_type.value
        suffixes = (config.left_suffix, config.right_suffix)
        algorithm = config.algorithm.value
    elif on is not None:
        left_on = right_on = _key_list(on)
    else:
        left_on, right_on = _key_list(left_on), _key_list(right_on)
    if not left_on or len(left_on) != len(right_on):
        raise InvalidArgument(f"bad join keys {left_on} / {right_on}")
    how = {"outer": "fullouter", "full_outer": "fullouter"}.get(how, how)
    if how == "right":
        # right join = left join with the sides swapped, columns reordered
        swapped = join(right, left, left_on=right_on, right_on=left_on,
                       how="left", suffixes=(suffixes[1], suffixes[0]),
                       out_capacity=out_capacity, algorithm=algorithm,
                       ordered=ordered)
        return _reorder_right_join(swapped, left, right, left_on, right_on,
                                   suffixes)
    if how not in ("inner", "left", "fullouter"):
        raise InvalidArgument(f"unknown join type {how!r}")
    algorithm = _env_algorithm() or algorithm
    if algorithm not in ("sort", "hash"):
        raise InvalidArgument(f"unknown join algorithm {algorithm!r}")
    if left.device != right.device:
        raise InvalidArgument(f"join inputs lie on {left.device} and "
                              f"{right.device}")
    # the default fits any 1:N join; the ambient scale (cylon_tpu_torch.plan)
    # grows it when a caller's regrow ladder reruns the join
    out_cap = ((left.capacity + right.capacity) * plan.current_scale()
               if out_capacity is None else int(out_capacity))
    left, right = _aligned_keys(left, right, left_on, right_on)
    return _join(left, right, left_on, right_on, how, tuple(suffixes),
                 out_cap, ordered, _route_algorithm(algorithm, how))


def _join(left, right, left_on, right_on, how, suffixes, out_cap, ordered,
          routine: str = "sort"):
    lkeys = [left.column(n).data for n in left_on]
    rkeys = [right.column(n).data for n in right_on]
    lvals = [left.column(n).validity for n in left_on]
    rvals = [right.column(n).validity for n in right_on]
    guard = False
    if routine == "hash_bucketed":
        routine, guard = _guarded_route(lkeys, lvals, left.nrows, rkeys,
                                        rvals, right.nrows, how)
    with span("join.indices", device=True):
        if routine == "hash_bucketed":
            left_idx, right_idx, total = hash_join.bucketed_join_indices(
                lkeys, lvals, left.nrows, rkeys, rvals, right.nrows, how,
                out_cap, ordered, guard=guard)
        else:
            left_idx, right_idx, total = _join_indices(
                lkeys, lvals, left.nrows, rkeys, rvals, right.nrows, how,
                out_cap, ordered, hash_first=routine == "hash_sort")
    res = _assemble(left, right, list(left_on), list(right_on), suffixes,
                    left_idx, right_idx, total, how)
    return kernels.carry_overflow(res, left, right)


def _guarded_route(lkeys, lvals, lrows, rkeys, rvals, rrows, how):
    """``(routine, guard)`` of a join routed to "hash_bucketed": the
    build side's chains checked on the host, "sort" when one passes the
    chain width (the JAX package's eager route), counted in
    ``join.algorithm``. In capture mode (:func:`plan.settle`) the check
    runs in a graph's warm-up, which records the route on its tape; the
    capture takes the route back with no host read, and ``guard`` asks
    the bucketed build to register its overflow count as a flag. With no
    tape (a bare capture mode) the bucketed route is taken, guarded."""
    def eager():
        build, _, _ = hash_join.sides(lkeys, lvals, lrows, rkeys, rvals,
                                      rrows, how)
        routine = "hash_bucketed"
        with span("join.route"):
            if hash_join.chain_overflow(*build):
                telemetry.counter("join.overflow_fallbacks").inc()
                routine = "sort"
        telemetry.counter(
            "join.algorithm",
            kind=("hash->sort_overflow" if routine == "sort"
                  else "hash->hash_bucketed")).inc()
        return (routine, False), routine

    def fixed(routine):
        routine = routine or "hash_bucketed"
        return routine, routine == "hash_bucketed"

    return plan.settle(("join_route", how, lkeys[0].shape[0],
                        rkeys[0].shape[0]), eager, fixed)


def _aligned_keys(left, right, left_on, right_on):
    """The tables with their key columns brought to one layout, so that
    the match and the output gather (and coalesce) see the same words:
    device bytes against bytes or a dictionary through
    ``bytescol.align_storages`` (the dictionary side becomes bytes, the
    widths align), dictionary against dictionary through
    ``dictenc.unify_dictionaries``; string against non-string is refused,
    as are numeric keys of different physical dtypes."""
    for ln, rn in zip(left_on, right_on):
        lc, rc = left.column(ln), right.column(rn)
        if lc.dtype.is_bytes or rc.dtype.is_bytes:
            if lc.dtype.layout != rc.dtype.layout:
                raise InvalidArgument(
                    f"join key {ln}/{rn}: string vs non-string")
            lc, rc = bytescol.align_storages([lc, rc])
        elif lc.dtype.is_dictionary != rc.dtype.is_dictionary:
            raise InvalidArgument(f"join key {ln}/{rn}: string vs non-string")
        elif lc.dtype.is_dictionary:
            lc, rc = dictenc.unify_dictionaries([lc, rc])
        elif lc.data.dtype != rc.data.dtype:
            raise InvalidArgument(
                f"join key {ln}/{rn}: dtype mismatch "
                f"{lc.data.dtype} vs {rc.data.dtype} (cast first)")
        else:
            continue
        left = left.add_column(ln, lc)
        right = right.add_column(rn, rc)
    return left, right


def _gather_plan(cols, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (clamped) of the columns stacked side by side, in one
    packed row gather (``kernels.gather_rows`` on the stack's 4-byte
    words: an int64 stack enters as its int32 view)."""
    plan_rows = torch.stack(cols, dim=1)
    return gather_rows(plan_rows.view(torch.int32), idx).view(plan_rows.dtype)


def _join_indices(lkeys, lvals, lrows, rkeys, rvals, rrows, how, out_cap,
                  ordered: bool = True, hash_first: bool = False):
    """Core: (left_idx, right_idx, total) gather plans of length out_cap;
    -1 in either marks the null side of an output row.

    Everything runs in the combined group-sorted layout of one
    ``group_sort`` over both sides' keys, with the row iota as the
    sub-order (left rows, indices < cl, precede right rows in each group;
    its uniqueness makes the order total). Per-group values broadcast to
    every row by fills, not gathers; the run expansion is one packed row
    gather; ``ordered`` restores pandas' order with one stable sort.
    ``hash_first`` groups by murmur bucket first (the "hash_sort" route).
    """
    cl = lkeys[0].shape[0]
    cr = rkeys[0].shape[0]
    ncomb = cl + cr
    dev = lkeys[0].device
    hi = max(ncomb - 1, 0)

    ckeys = [torch.cat([l, r]) for l, r in zip(lkeys, rkeys)]
    cvals = []
    for lv, rv in zip(lvals, rvals):
        if lv is None and rv is None:
            cvals.append(None)
            continue
        if lv is None:
            lv = torch.ones(cl, dtype=torch.bool, device=dev)
        if rv is None:
            rv = torch.ones(cr, dtype=torch.bool, device=dev)
        cvals.append(torch.cat([lv, rv]))
    cvalid = torch.cat([kernels.valid_mask(cl, lrows, dev),
                        kernels.valid_mask(cr, rrows, dev)])

    iota_c = torch.arange(ncomb, dtype=torch.int32, device=dev)
    want_gid = ordered and how == "fullouter"
    gid_s, _, (orig_u,) = kernels.group_sort(
        ckeys, cvalid, cvals,
        suborder=[kernels.OrderKey(iota_c.to(torch.int64), 32)],
        hash_first=hash_first)
    orig_s = orig_u.to(torch.int32)

    valid_s = gid_s < ncomb
    is_r = valid_s & (orig_s >= cl)
    is_l = valid_s & (orig_s < cl)
    boundary = valid_s & ((gid_s != torch.roll(gid_s, 1)) | (iota_c == 0))
    is_end = valid_s & (torch.roll(boundary, -1) | ~torch.roll(valid_s, -1)
                        | (iota_c == ncomb - 1))
    is_r32 = is_r.to(torch.int32)
    is_l32 = is_l.to(torch.int32)

    cum_r = kernels.fast_cumsum(is_r32)
    cum_l = kernels.fast_cumsum(is_l32)
    s_g = kernels.forward_fill(boundary, iota_c)
    rb = kernels.forward_fill(boundary, cum_r - is_r32)
    lb = kernels.forward_fill(boundary, cum_l - is_l32)
    rcnt = kernels.reverse_fill(is_end, cum_r) - rb    # rights in my group
    lcnt = kernels.reverse_fill(is_end, cum_l) - lb
    right_start = s_g + lcnt   # sorted position of the group's first right

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    match_counts = torch.where(is_l, rcnt, zero)
    if how == "inner":
        ecounts = match_counts
    else:   # left / fullouter: an unmatched left row still emits one row
        ecounts = torch.where(is_l, torch.clamp(match_counts, min=1), zero)

    # run-length expansion: row i emits ecounts[i] output slots. Each
    # run's sorted position lands at its start offset, and a running max
    # fills the run. Offsets of nonempty runs are distinct, so a plain
    # scatter equals the JAX ``.at[start].max``; slots past out_cap (no
    # run, or an overflowing one) go to one extra slot, sliced away, in
    # place of the JAX ``mode="drop"``.
    offs = kernels.exclusive_cumsum(ecounts)
    total = (offs[-1] + ecounts[-1]) if ncomb else zero
    start = torch.where(ecounts > 0, offs.to(torch.int64),
                        out_cap).clamp_(max=out_cap)
    mark = torch.full((out_cap + 1,), -1, dtype=torch.int32, device=dev)
    mark.index_put_((start,), iota_c)   # in place: fresh buffer
    # slots before the first run read -1: the gather clamps them to row 0
    parent = kernels.fast_cummax(mark[:out_cap])
    # the gid column rides the packed gather only when the fullouter
    # restore needs it
    pcols = [offs, match_counts, right_start, orig_s]
    if want_gid:
        pcols.append(gid_s)
    g = _gather_plan(pcols, parent)   # one row gather
    j = torch.arange(out_cap, dtype=torch.int32, device=dev)
    within = j - g[:, 0]
    matched = g[:, 1] > 0
    r_pos = torch.clamp(g[:, 2] + within, 0, hi).to(torch.int64)
    right_idx = torch.where(matched, orig_s[r_pos] - cl, -1)
    left_idx = g[:, 3]
    slot_gid = g[:, 4] if want_gid else None

    if how == "fullouter":
        extra_mask = is_r & (lcnt == 0)
        perm_s, n_extra = kernels.compact_mask(extra_mask, valid_s)
        shifted = torch.clamp(j - total, 0, hi).to(torch.int64)
        ecols = [orig_s] + ([gid_s] if want_gid else [])
        epair = _gather_plan(ecols, perm_s[shifted])
        in_main = j < total
        left_idx = torch.where(in_main, left_idx, -1)
        right_idx = torch.where(in_main, right_idx, epair[:, 0] - cl)
        if want_gid:
            slot_gid = torch.where(in_main, slot_gid, epair[:, 1])
        total = total + n_extra

    if ordered:
        # pandas order by one stable sort of the index pairs. inner/left:
        # left-frame order (a left row's slots keep right-frame order by
        # stability). fullouter: the sorted key union with nulls last --
        # exactly group order, so the group id is the key.
        valid_slot = j < total
        okey = slot_gid if how == "fullouter" else left_idx
        okey = torch.where(valid_slot, okey.to(torch.int64), M32_MAX)
        perm = torch.sort(okey, stable=True).indices
        left_idx, right_idx = left_idx[perm], right_idx[perm]

    return left_idx, right_idx, total.to(torch.int32)


def _assemble(left, right, left_on, right_on, suffixes, left_idx, right_idx,
              total, how):
    """Gather output columns. Shared key names coalesce (left value, else
    right for right-only rows); other name collisions get suffixes --
    pandas merge naming."""
    from cylon_tpu_torch.table import Table

    shared_keys = [ln for ln, rn in zip(left_on, right_on) if ln == rn]
    lgather = take_columns(left, left_idx, total,
                           null_mask=left_idx < 0 if how == "fullouter"
                           else None)
    rgather = take_columns(right, right_idx, total,
                           null_mask=right_idx < 0 if how != "inner"
                           else None)
    out = {}
    overlap = set(left.column_names) & set(right.column_names)
    for name in left.column_names:
        c = lgather.column(name)
        if name in shared_keys:
            out[name] = _coalesce(c, rgather.column(name)) \
                if how == "fullouter" else c
        elif name in overlap:
            out[name + suffixes[0]] = c
        else:
            out[name] = c
    for name in right.column_names:
        if name in shared_keys:
            continue
        out[name + suffixes[1] if name in overlap else name] = \
            rgather.column(name)
    return Table(out, total)


def _coalesce(a: Column, b: Column) -> Column:
    """a where valid, else b (key coalescing for full outer joins)."""
    ones = torch.ones(a.capacity, dtype=torch.bool, device=a.data.device)
    av = ones if a.validity is None else a.validity
    bv = ones if b.validity is None else b.validity
    # content equality, as unify_dictionaries' pass-through
    if a.dtype.is_dictionary and a.dictionary != b.dictionary:
        raise InvalidArgument("coalesce across different dictionaries")
    pick = av[:, None] if a.data.dim() == 2 else av
    return Column(torch.where(pick, a.data, b.data), av | bv, a.dtype,
                  a.dictionary)


def _reorder_right_join(swapped, left, right, left_on, right_on, suffixes):
    """Restore left-then-right column order after the swapped left join."""
    shared_keys = {ln for ln, rn in zip(left_on, right_on) if ln == rn}
    overlap = set(left.column_names) & set(right.column_names)
    order = []
    for name in left.column_names:
        order.append(name + suffixes[0]
                     if name in overlap and name not in shared_keys else name)
    for name in right.column_names:
        if name not in shared_keys:
            order.append(name + suffixes[1] if name in overlap else name)
    return swapped.select(order)
