"""Distributed operators: partition -> exchange -> local operator, on
every rank.

Port of ``cylon_tpu/parallel/dist_ops.py``: ``shuffle`` (:683),
``dist_filter`` (:758), ``dist_head`` (:785), ``repartition`` (:806),
``dist_join`` (:850-947, parity ``DistributedJoin``, ``table.cpp:476``),
``dist_groupby`` (:957-1104), ``dist_sort`` (:1109-1322), the set ops and
``dist_unique`` (:1326-1436), the co-located ops and ``dist_concat``
(:1440-1570) and ``dist_aggregate`` (:1573-1833), with the capacity
defaults and tight receive sizing (:187-269) and the regrow-on-overflow
loop (:313-400). Each rank calls them on its own shard (see
:func:`cylon_tpu_torch.parallel.dtable.scatter_table`).

Telemetry as in the JAX package (:313-426, :551-664): each op runs under
a span of its name (:func:`_op`) and its host steps under stage spans
``<op>.<stage>`` (:func:`_stage`: ``prepare``, ``count_probe``,
``dispatch``, ``sync``, ``price``) that the flight recorder's
``critical_path`` reads; the regrow ladder counts its overflows and
regrows; each exchange is priced from the count matrices the exchange
already holds on the host (:func:`_note_exchange`). The port is SPMD:
each rank counts its own calls and rows, so a ``ThreadWorld`` of W
ranks counts W ``exchange.calls`` where the JAX package's single
controller counts one; the world sums of ``exchange.rows`` and
``exchange.bytes_true`` are the JAX package's.

Resilience as in the JAX package (:681-696, :804-810, :848-878, :290-310):
``shuffle``, ``repartition`` and ``dist_join`` run as the watchdog's
``exchange`` section (:func:`cylon_tpu_torch.watchdog.watched`: a
``cat="stage"`` slice each, and a stall past a deadline dumps stacks and
raises ``DeadlineExceeded``) and hit the ``exchange`` injection point
(:func:`cylon_tpu_torch.resilience.inject`, the env's fault plan first);
the row-preserving exchanges check that the rows out equal the rows in
(:func:`_account_exchange_rows`, ``DataLossError``) from the counts the
regrow ladder already holds on the host, so the check adds no
device->host transfer.
"""

import contextlib
import dataclasses
import functools
import os
from typing import Sequence

import torch

from cylon_tpu_torch.errors import (DataLossError, InvalidArgument,
                                    OutOfCapacity, TypeError_)
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.aggregates import (AGGS, _masked_quantile,
                                            _masked_extreme, _masked_sum,
                                            _moments, _poisoned)
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.ops.hash import paired_validities, partition_ids
from cylon_tpu_torch.ops.join import _aligned_keys, join as _join_fn
from cylon_tpu_torch.ops.partition import modulo_partition_ids
from cylon_tpu_torch.ops.selection import (_null_flags, concat_tables,
                                           filter_table, sort_key_operands,
                                           sort_table)
from cylon_tpu_torch.ops.setops import (_trim_capacity, intersect, subtract,
                                        union, unique)
from cylon_tpu_torch.parallel.collectives import ReduceOp, all_reduce, \
    reduce_tensor as _all_reduce
from cylon_tpu_torch.parallel.dtable import shard_sizes, world_layout, \
    world_layout_sized
from cylon_tpu_torch.parallel.shuffle import checked_recv, \
    exchange_arrays, poison, shuffle_local
from cylon_tpu_torch import plan, resilience, telemetry, watchdog
from cylon_tpu_torch.plan import MAX_SCALE
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils import pow2_bucket
from cylon_tpu_torch.utils.logging import get_logger
from cylon_tpu_torch.utils.tracing import span as _span

#: default headroom factor for post-shuffle local buffers (hash
#: partitioning of uniform keys is balanced; skew beyond 2x should pass
#: an explicit out_capacity)
DEFAULT_SKEW = 2


def _op(name: str):
    """Decorator of a dist op ``fn(env, ...)``: run it under the span
    ``name`` (the JAX package's ``@traced``) with this rank stamped on
    every flight-recorder event inside (:func:`~cylon_tpu_torch.telemetry.trace.rank_scope`;
    the ``ThreadWorld`` ranks share one recorder)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(env, *args, **kwargs):
            with _trace.rank_scope(env.rank), _span(name):
                return fn(env, *args, **kwargs)
        return wrapper
    return deco


def _stage(op: "str | None", stage: str, **targs):
    """Span for one host-side stage of a named eager dispatch —
    ``<op>.<stage>`` with ``cat="stage"`` so the flight recorder's
    :func:`~cylon_tpu_torch.telemetry.trace.critical_path` attributes
    wall time to it (``cylon_tpu/parallel/dist_ops.py:54``). Unnamed
    dispatches (the co-located ops, the world-of-one short-circuits)
    stay span-free."""
    if op is None:
        return contextlib.nullcontext()
    return _span(f"{op}.{stage}", cat="stage", **targs)


def _tight_rows_local(env, sizes, enabled: bool = True):
    """A rank's receive estimate for a defaulted exchange bound (port of
    ``cylon_tpu/parallel/dist_ops.py:187``, eager): from every rank's row
    count and capacity, ``(counts, caps)`` a table as
    :func:`~cylon_tpu_torch.parallel.dtable.world_layout_sized` gathered
    them (no collective of its own), the rows the exchange moves spread
    evenly, ``ceil(total / W)``, plus a margin of ``4 * sqrt`` and 16 for
    the spread of hashing. Skew past it overflows the receive, and
    :func:`_adaptive` regrows. None (keep the capacity default) when not
    ``enabled`` (an explicit bound) or when an input is poisoned, since
    its count is then a lie. (The JAX package's row hint under a
    whole-query trace comes with the planner, ROADMAP A6.)"""
    if not enabled:
        return None
    total = 0
    for counts, caps in sizes:
        if any(c > k for c, k in zip(counts, caps)):
            return None
        total += sum(counts)
    est = -(-total // env.world_size)
    return max(est + 4 * int(est ** 0.5) + 16, 1)


def batched_true_rows(tables) -> "list[int] | None":
    """Each table's true rows, in one host fetch for all of them (port
    of ``cylon_tpu/parallel/dist_ops.py:165``): their row counts stacked
    into one tensor a device, never one fetch a table. None when any
    count marks an overflow (``nrows == capacity + 1``), since the count
    is then a lie, as the JAX package's is None for a poisoned table.
    The port has no per-table count memo: a table's count is one 0-d
    tensor on its device, and each call reads it afresh. Tables given
    here are this process's own (a rank's shard counts its rank's
    rows)."""
    tables = list(tables)
    by_dev: "dict[torch.device, list]" = {}
    for i, t in enumerate(tables):
        by_dev.setdefault(t.nrows.device, []).append(i)
    counts = [0] * len(tables)
    for idx in by_dev.values():
        host = torch.stack([tables[i].nrows.reshape(()).to(torch.int64)
                            for i in idx]).tolist()
        for i, c in zip(idx, host):
            counts[i] = int(c)
    if any(c > t.capacity for c, t in zip(counts, tables)):
        return None
    return counts


def _out_cap_local(env, world_capacity: int, out_capacity=None,
                   skew=DEFAULT_SKEW, scale: int = 1,
                   tight_rows=None) -> int:
    """A rank's receive buffer: ``out_capacity`` split over the ranks, or
    by default the ranks' mean capacity (the JAX package's local
    capacity; ranks that ingest their own rows hold different ones, an
    empty shard none) times the skew headroom and the regrow scale. A
    tight estimate (:func:`_tight_rows_local`) takes its power-of-two
    bucket instead, never above that default."""
    w = env.world_size
    if out_capacity is not None:
        return -(-out_capacity // w)
    default = -(-world_capacity // w) * skew * scale
    if tight_rows is not None:
        return min(pow2_bucket(tight_rows) * scale, default)
    return default


def _partition_keys(lt, rt, left_on, right_on):
    """Key columns and validities for partition hashing, the masks paired
    (:func:`cylon_tpu_torch.ops.hash.paired_validities`) so that equal
    keys reach the same rank. Keys are in one layout on every rank by
    then (:func:`dist_join`'s prepare step), so dictionary keys hash by
    their codes, as in the JAX package's ``_key_data``."""
    lkeys = [lt.column(c).data for c in left_on]
    rkeys = [rt.column(c).data for c in right_on]
    lvals, rvals = paired_validities(
        lkeys, [lt.column(c).validity for c in left_on],
        rkeys, [rt.column(c).validity for c in right_on])
    return lkeys, lvals, rkeys, rvals


def _shard_fit(env, table) -> tuple:
    """``(fits, counts)``: whether every rank's row count is within that
    rank's capacity, and the counts. Every rank takes the same decision."""
    counts, caps = shard_sizes(env, table)
    return all(c <= k for c, k in zip(counts, caps)), counts


def _account_exchange_rows(label: str, sizes, out_counts) -> None:
    """Row conservation of a row-preserving exchange (port of
    ``cylon_tpu/parallel/dist_ops.py:290``): the world's rows after the
    exchange must equal its rows before, or rows were dropped or
    duplicated across the collective, and
    :class:`~cylon_tpu_torch.errors.DataLossError` is raised. ``sizes``:
    each input's ``(counts, caps)`` as
    :func:`~cylon_tpu_torch.parallel.dtable.world_layout_sized` gathered
    them; ``out_counts``: every rank's result rows as the regrow ladder's
    check gathered them. Host lists both, so the check reads no device.
    Skipped when an input is poisoned (its overflow already marks the
    truncation, and its true count is unknown)."""
    rows_in = 0
    for counts, caps in sizes:
        if any(c > k for c, k in zip(counts, caps)):
            return
        rows_in += sum(counts)
    rows_out = sum(out_counts)
    if rows_in != rows_out:
        raise DataLossError(
            f"{label}: {rows_in} rows entered the exchange but "
            f"{rows_out} came out — rows were silently dropped or "
            "duplicated across the collective")


def _headroom(op: str, recv, w: int, scale: int) -> None:
    """Set ``exchange.headroom_ratio{op}`` (port of
    ``cylon_tpu/parallel/dist_ops.py:383-402``): the settled receive
    buffers' rows over the true rows that entered the exchange. ``recv``
    is ``(rows_of, sizes)``: ``rows_of(scale)``, one rank's receive rows
    at ``scale``, and each input's ``(counts, caps)`` as
    :func:`~cylon_tpu_torch.parallel.dtable.world_layout_sized` gathered
    them, every count clamped to its capacity (exact for row-preserving
    exchanges, an upper bound for pre-combining ones). Host lists both,
    so the gauge reads no device. No true rows: the gauge stays unset."""
    rows_of, sizes = recv
    rows_in = sum(min(c, k) for counts, caps in sizes
                  for c, k in zip(counts, caps))
    if rows_in:
        telemetry.gauge("exchange.headroom_ratio", op=op).set(
            rows_of(scale) * w / rows_in)


def _adaptive(env, build, args, adaptive: bool, op: "str | None" = None,
              tight: bool = False, conserve=None, recv=None):
    """Run ``build(scale)(*args)``, doubling the default capacities while
    any rank overflowed (every bound defaulted: ``adaptive``), from the
    ambient :func:`~cylon_tpu_torch.plan.current_scale`; the scale that
    fitted is reported to an enclosing
    :class:`~cylon_tpu_torch.plan.CompiledQuery`. Explicit capacities
    keep the raise-on-overflow contract: their overflow shows in
    ``nrows`` and ``num_rows`` raises.

    Telemetry (``cylon_tpu/parallel/dist_ops.py:361-426``): a named
    ``op`` spans each run as ``<op>.dispatch`` and the world's count
    check as ``<op>.sync``; ``exchange.tight_dispatches`` counts calls
    whose receive buffers came from the tight estimate (``tight``) and
    ``exchange.fallback_regrows`` those whose skew outran it; every
    overflow counts ``plan.overflow_events{site=dist}`` with a
    ``capacity.overflow`` instant, every doubling
    ``plan.capacity_rescales{site=dist}`` with a ``capacity.regrow``
    instant.

    ``conserve``: ``(label, sizes)`` of a row-preserving exchange, whose
    fitted result is held to its inputs' rows
    (:func:`_account_exchange_rows`) with the counts this check
    gathered. ``recv``: ``(rows_of, sizes)`` of a named ``op``'s
    exchange, whose fitted scale sets ``exchange.headroom_ratio``
    (:func:`_headroom`)."""
    if tight and op is not None:
        telemetry.counter("exchange.tight_dispatches", op=op).inc()
    if not adaptive:
        with _stage(op, "dispatch", scale=plan.current_scale()):
            return build(plan.current_scale())(*args)

    def fixed(scale):
        # capture mode: no count is read; the warm-up's scale or the
        # ambient one, the overflow registered and the whole query
        # regrows (``cylon_tpu/plan.py:747``)
        scale = plan.current_scale() if scale is None else scale
        with _stage(op, "dispatch", scale=scale):
            out = build(scale)(*args)
        plan.note_overflow(out.nrows > out.capacity)
        return out

    return plan.settle(("exchange", op), lambda: _ladder(
        env, build, args, op, tight, conserve, recv), fixed)


def _ladder(env, build, args, op, tight, conserve, recv):
    """:func:`_adaptive`'s eager ladder: ``(result, its scale)``."""
    scale = plan.current_scale()
    while True:
        plan.rung()
        with _stage(op, "dispatch", scale=scale):
            out = build(scale)(*args)
        with _stage(op, "sync"):
            fits, counts = _shard_fit(env, out)
        if fits:
            if conserve is not None:
                _account_exchange_rows(conserve[0], conserve[1], counts)
            if recv is not None and op is not None:
                _headroom(op, recv, env.world_size, scale)
            plan.note_scale(scale)
            return out, scale
        for t in args:
            t_fits, tc = _shard_fit(env, t)
            if not t_fits:
                raise OutOfCapacity(
                    f"input shard row counts {tc} exceed their "
                    "capacities: an upstream op overflowed an explicit "
                    "out_capacity")
        telemetry.counter("plan.overflow_events", site="dist").inc()
        _trace.instant("capacity.overflow", cat="capacity", op=op or "?",
                       scale=scale, max_count=max(counts),
                       cap_local=out.capacity)
        if tight and op is not None:
            telemetry.counter("exchange.fallback_regrows", op=op).inc()
        if scale >= MAX_SCALE:
            raise OutOfCapacity(
                f"shard row counts {counts} still exceed their local "
                f"capacities at {scale}x the default budget; pass an "
                "explicit out_capacity")
        scale *= 2
        telemetry.counter("plan.capacity_rescales", site="dist").inc()
        _trace.instant("capacity.regrow", cat="capacity", op=op or "?",
                       scale=scale)


def _note_exchange(env, op: str, ledger: list) -> None:
    """Telemetry for one eager exchange dispatch (port of
    ``cylon_tpu/parallel/dist_ops.py:551``), priced from the exchange
    stages the dispatch left in ``ledger``
    (:class:`~cylon_tpu_torch.parallel.shuffle.Stage`, from
    :func:`~cylon_tpu_torch.parallel.shuffle.exchange_arrays`): host
    data already, so pricing adds no device→host transfer. A regrown
    dispatch leaves only its last run's stages.

    This rank's ``exchange.rows`` are the rows it sent (its row of a
    flat or intra stage's count matrix), its ``exchange.bytes_true``
    those rows times their u32 words times 4, summed over the op's
    exchanges (both sides of a join); summed over the ranks they are the
    JAX package's counts of a row-preserving exchange, in a flat world
    and a two-tier one alike. On a flat world the exchange moves exactly
    those rows (the JAX package's "ragged" path), so
    ``exchange.bytes_padded`` equals ``exchange.bytes_true``. On a
    two-tier world (``path="hier"``) ``exchange.bytes_padded`` is the
    wire bytes of both stages, priced to the rank whose rows they are:
    each row it sent crosses stage 1 with its rider word and stage 2
    without, so for rows of w words ``exchange.pad_ratio`` is
    ``(2w + 1) / w``, and the world's sum is both stages' wire bytes
    exactly. (The JAX package prices its padded capacities and leaves
    the rider out.) The decomposable ``dist_groupby`` exchanges its
    pre-combined partials: the matrices count those, where the JAX
    package prices the input rows. Then one ``memory.sample(op=op)`` at
    the stage boundary, and, when the recorder is armed, an
    ``exchange.dispatch`` instant whose ``rows_shards`` are every rank's
    sent rows, or None where this rank does not know them all (on a
    two-tier world it sees its own slice's)."""
    if not ledger:
        return
    me = env.rank
    path = "hier" if env.is_hierarchical else "ragged"
    with _stage(op, "price"):
        rows = true_b = pad_b = 0
        shard_rows: list = [None] * env.world_size
        for st in ledger:
            if st.stage == "inter":
                continue   # priced with its rows' own stage 1
            sent = st.cmat.sum(dim=1).tolist()
            for r, n in zip(st.ranks, sent):
                shard_rows[r] = (shard_rows[r] or 0) + int(n)
            mine = int(sent[st.ranks.index(me)])
            words = st.words - (st.stage == "intra")   # less the rider
            rows += mine
            true_b += mine * words * 4
            pad_b += mine * (st.words + words if st.stage == "intra"
                             else words) * 4
        telemetry.counter("exchange.calls", op=op, path=path).inc()
        telemetry.counter("exchange.rows", op=op).inc(rows)
        telemetry.counter("exchange.bytes_true", op=op).inc(true_b)
        telemetry.counter("exchange.bytes_padded", op=op).inc(pad_b)
        # device-memory accounting at the stage boundary: one (throttled)
        # live-bytes sample feeds memory.live_bytes{device} and this op's
        # memory.peak_bytes{op} watermark (telemetry.memory)
        _memory.sample(op=op)
        if true_b:
            telemetry.gauge("exchange.pad_ratio", op=op).set(pad_b / true_b)
        if _trace.enabled():
            known = None not in shard_rows and sum(shard_rows)
            _trace.instant(
                "exchange.dispatch", cat="exchange", op=op, path=path,
                rows=rows, bytes_true=true_b, bytes_padded=pad_b,
                rows_shards=shard_rows if known else None,
                counter="exchange.rows")
            _trace.counter("exchange.bytes_true",
                           telemetry.total("exchange.bytes_true"), op=op)
            _trace.counter("exchange.bytes_padded",
                           telemetry.total("exchange.bytes_padded"), op=op)


def _key_data(t, cols):
    return ([t.column(c).data for c in cols],
            [t.column(c).validity for c in cols])


def _value_hash_tables(table, cols) -> dict:
    """Each dictionary-coded key column's value hashes (port of
    ``cylon_tpu/parallel/dist_ops.py:112``): the generic shuffle hashes a
    string's value, not its code, so that relations shuffled apart, whose
    dictionaries may differ or grow, send equal strings to the same
    rank. ``dist_join`` needs none: it unifies both sides' dictionaries
    first."""
    return {c: table.column(c).dictionary.value_hashes(table.device)
            for c in cols if table.column(c).dtype.is_dictionary
            and table.column(c).dictionary is not None}


def _value_partition_keys(t, cols, vh: dict):
    """Key arrays for the generic shuffle's hash, dictionary codes mapped
    to their values' hashes (port of ``cylon_tpu/parallel/dist_ops.py:130``
    ``_partition_keys``; :func:`_partition_keys` here is ``dist_join``'s
    two-sided one). The uint32 hashes ride as int32 bit patterns, the
    words the row hash reads either way."""
    keys, vals = [], []
    for c in cols:
        col = t.column(c)
        if c in vh:
            tab = vh[c].view(torch.int32)
            keys.append(kernels._rows_at(tab, col.data, col.capacity))
        else:
            keys.append(col.data)
        vals.append(col.validity)
    return keys, vals


@_op("shuffle")
@watchdog.watched("exchange", "shuffle")
def shuffle(env, table, key_cols, out_capacity: "int | None" = None,
            bucket_cap: "int | None" = None, partitioning: str = "hash"):
    """Move this rank's rows so that equal keys land on one rank (port of
    ``cylon_tpu/parallel/dist_ops.py:683``; parity ``Table::Shuffle`` /
    ``HashPartition``, ``table.hpp:329-338``). ``partitioning``:
    ``"hash"`` (murmur over the keys, a dictionary key by its value's
    hash) or ``"modulo"`` (the first key, an integer, modulo the world;
    ``ModuloPartitionKernel``, ``arrow_partition_kernels.cpp:67``).

    The receive buffer defaults to a power-of-two bucket of the true
    rows (:func:`_tight_rows_local`) and regrows on overflow; an explicit
    ``out_capacity`` raises on overflow instead. ``bucket_cap`` bounds
    each (sender, destination) pair of the JAX package's padded
    exchange; the port's exchange sends exact counts and has no such
    bound, so on a flat world the argument changes nothing. On a
    two-tier world it raises, as the JAX package's does
    (``dist_ops.py:697-702``): a bound on a flat world's pairs says
    nothing of the stages' pairs."""
    if partitioning not in ("hash", "modulo"):
        raise InvalidArgument(f"unknown partitioning {partitioning!r}")
    if bucket_cap is not None and env.is_hierarchical:
        raise InvalidArgument(
            "bucket_cap is a flat-world per-(sender, dest) bound; the "
            "stages of a hierarchical world have other pairs: omit "
            "bucket_cap")
    resilience.inject("exchange", "shuffle", env=env)
    key_cols = list(key_cols)
    with _stage("shuffle", "prepare"):
        table, counts, caps = world_layout_sized(env, table)
        vh = _value_hash_tables(table, key_cols) \
            if partitioning == "hash" else {}
    w = env.world_size
    with _stage("shuffle", "count_probe"):
        tight = _tight_rows_local(env, [(counts, caps)],
                                  enabled=out_capacity is None)
    sent: list = []

    def recv_rows(scale):
        return _out_cap_local(env, sum(caps), out_capacity, scale=scale,
                              tight_rows=tight)

    def build(scale):
        out_l = recv_rows(scale)

        def run(t):
            sent.clear()
            lt, inof = checked_recv(t, t.capacity)
            if partitioning == "hash":
                keys, vals = _value_partition_keys(lt, key_cols, vh)
                pid = partition_ids(keys, w, vals)
            else:
                pid = modulo_partition_ids(_key_data(lt, key_cols)[0], w)
            res, of = checked_recv(
                shuffle_local(env.comm, lt, pid, out_l, sent), out_l)
            return poison(res, inof, of)
        return run

    out = _adaptive(env, build, (table,), out_capacity is None,
                    op="shuffle", tight=tight is not None,
                    conserve=("shuffle", [(counts, caps)]),
                    recv=(recv_rows, [(counts, caps)]))
    _note_exchange(env, "shuffle", sent)
    return out


@_op("repartition")
@watchdog.watched("exchange", "repartition")
def repartition(env, table, out_capacity: "int | None" = None):
    """Round-robin rebalancing (port of
    ``cylon_tpu/parallel/dist_ops.py:806``; parity: Java
    ``roundRobinPartition``, ``Table.java:191``): the rows in rank order,
    row i of the world to rank ``i % W``, so the ranks' counts differ by
    at most one. Each rank numbers its rows from its global offset, the
    counts of the ranks before it."""
    resilience.inject("exchange", "repartition", env=env)
    with _stage("repartition", "prepare"):
        table, counts, caps = world_layout_sized(env, table)
    w = env.world_size
    offset = sum(min(c, k) for c, k in zip(counts[:env.rank],
                                           caps[:env.rank]))
    pid = ((offset + torch.arange(table.capacity, dtype=torch.int64,
                                  device=table.device)) % w).to(torch.int32)
    with _stage("repartition", "count_probe"):
        tight = _tight_rows_local(env, [(counts, caps)],
                                  enabled=out_capacity is None)
    sent: list = []

    def recv_rows(scale):
        return _out_cap_local(env, sum(caps), out_capacity, scale=scale,
                              tight_rows=tight)

    def build(scale):
        out_l = recv_rows(scale)

        def run(t):
            sent.clear()
            lt, inof = checked_recv(t, t.capacity)
            res, of = checked_recv(
                shuffle_local(env.comm, lt, pid, out_l, sent), out_l)
            return poison(res, inof, of)
        return run

    out = _adaptive(env, build, (table,), out_capacity is None,
                    op="repartition", tight=tight is not None,
                    conserve=("repartition", [(counts, caps)]),
                    recv=(recv_rows, [(counts, caps)]))
    _note_exchange(env, "repartition", sent)
    return out


def _join_keys(on, left_on, right_on) -> tuple:
    """``(left_on, right_on)`` as lists, from ``on`` or the two sides'
    names (the JAX package's ``_normalize_join_keys``)."""
    if on is not None:
        on = [on] if isinstance(on, str) else list(on)
        return on, on
    return ([left_on] if isinstance(left_on, str) else list(left_on),
            [right_on] if isinstance(right_on, str) else list(right_on))


@_op("dist_join")
@watchdog.watched("exchange", "dist_join")
def dist_join(env, left, right, *, on=None, left_on=None, right_on=None,
              how: str = "inner", suffixes=("_x", "_y"),
              out_capacity: "int | None" = None,
              shuffle_capacity: "int | None" = None,
              algorithm: str = "sort"):
    """Distributed equi-join of this rank's shards ``left`` and ``right``
    (parity: ``DistributedJoin``, table.cpp:476): shuffle both by key
    hash, then join locally (``ordered=False``, as every shard of the JAX
    package runs it). A world of one short-circuits to the local join,
    like the reference's ``world==1`` branch (table.cpp:481).

    ``algorithm`` routes each rank's local join as ``join`` does. The JAX
    package checks the bucketed route's chains in-graph (``lax.cond``,
    its traced "hash_guarded" route); the port runs eagerly, so each rank
    checks its own build side on the host before its local join, as the
    eager "hash_bucketed" route does, and an overflowing rank takes the
    sort join alone.

    At W > 1 each side's receive buffer defaults to a power-of-two
    bucket of its true rows spread over the ranks
    (:func:`_tight_rows_local`, as ``dist_ops.py:908-917``), and regrows
    on skew."""
    left_on, right_on = _join_keys(on, left_on, right_on)

    if env.world_size == 1:
        def build1(scale):
            cap = out_capacity if out_capacity is not None \
                else (left.capacity + right.capacity) * scale

            def run(lt, rt):
                return _join_fn(lt, rt, left_on=left_on, right_on=right_on,
                                how=how, suffixes=suffixes,
                                out_capacity=cap, algorithm=algorithm,
                                ordered=False)
            return run

        return _adaptive(env, build1, (left, right), out_capacity is None)

    resilience.inject("exchange", "dist_join", env=env)
    # prepare, before any rows move: each table in one layout on every
    # rank (world_layout: bytes widths, validity masks and dictionaries,
    # which differ where ranks ingested their own rows), so that the
    # exchanged rows line up and their codes keep their strings; then the
    # key columns of both sides in one layout (bytes at one width,
    # dictionaries unified), so the codes co-locate equal keys and the
    # local joins' alignment is a no-op
    with _stage("dist_join", "prepare"):
        left, lcounts, lcaps = world_layout_sized(env, left)
        right, rcounts, rcaps = world_layout_sized(env, right)
        left, right = _aligned_keys(left, right, left_on, right_on)
    w = env.world_size
    comm = env.comm
    caps = [sum(lcaps), sum(rcaps)]
    adaptive = out_capacity is None and shuffle_capacity is None
    with _stage("dist_join", "count_probe"):
        tight_l = _tight_rows_local(env, [(lcounts, lcaps)],
                                    enabled=adaptive)
        tight_r = _tight_rows_local(env, [(rcounts, rcaps)],
                                    enabled=adaptive)
    sent: list = []

    def recv_rows(scale):
        return (_out_cap_local(env, caps[0], shuffle_capacity, scale=scale,
                               tight_rows=tight_l),
                _out_cap_local(env, caps[1], shuffle_capacity, scale=scale,
                               tight_rows=tight_r))

    def build(scale):
        shuf_l, shuf_r = recv_rows(scale)
        join_l = shuf_l + shuf_r if out_capacity is None \
            else -(-out_capacity // w)

        def run(lt, rt):
            sent.clear()
            # clamped shards + the overflow flags an upstream bounded op
            # carried in (nrows == capacity + 1)
            ltab, liof = checked_recv(lt, lt.capacity)
            rtab, riof = checked_recv(rt, rt.capacity)
            lkeys, lvals, rkeys, rvals = _partition_keys(ltab, rtab, left_on,
                                                         right_on)
            lpid = partition_ids(lkeys, w, lvals)
            rpid = partition_ids(rkeys, w, rvals)
            lsh, lof = checked_recv(
                shuffle_local(comm, ltab, lpid, shuf_l, sent), shuf_l)
            rsh, rof = checked_recv(
                shuffle_local(comm, rtab, rpid, shuf_r, sent), shuf_r)
            res = _join_fn(lsh, rsh, left_on=left_on, right_on=right_on,
                           how=how, suffixes=suffixes, out_capacity=join_l,
                           algorithm=algorithm, ordered=False)
            return poison(res, liof, riof, lof, rof)
        return run

    out = _adaptive(env, build, (left, right), adaptive, op="dist_join",
                    tight=tight_l is not None or tight_r is not None,
                    recv=(lambda s: sum(recv_rows(s)),
                          [(lcounts, lcaps), (rcounts, rcaps)]))
    _note_exchange(env, "dist_join", sent)
    return out



# ----------------------------------------------------------------- groupby
_MERGEABLE = {"sum": "sum", "count": "sum", "size": "sum",
              "min": "min", "max": "max"}
_COMPOSITE = {"mean", "var", "std"}


@_op("dist_groupby")
def dist_groupby(env, table, by, aggs, out_capacity: "int | None" = None,
                 shuffle_capacity: "int | None" = None,
                 quantile: float = 0.5):
    """Distributed group-by aggregate of this rank's shard (port of
    ``cylon_tpu/parallel/dist_ops.py:957``; parity
    ``DistributedHashGroupBy``, ``groupby/groupby.cpp:33-84``). Where
    every op is decomposable (sum, count, size, min, max, mean, var,
    std), each rank combines its own rows first, the partials (at most
    one row a group a rank) move by key hash, and a final combine and
    post step finish; otherwise (nunique, median, quantile, first, last)
    the raw rows move and are aggregated once. Each rank holds its keys'
    groups, key-sorted. A world of one short-circuits to the local
    group-by, as ``dist_join`` does."""
    by = list(by)
    aggs = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[0]}_{a[1]}")
            for a in aggs]
    if env.world_size == 1:
        return groupby_aggregate(table, by, aggs, out_capacity=out_capacity,
                                 quantile=quantile)
    with _stage("dist_groupby", "prepare"):
        table, counts, caps = world_layout_sized(env, table)
    w = env.world_size
    comm = env.comm
    decomposable = all(op in _MERGEABLE or op in _COMPOSITE
                       for _, op, _ in aggs)
    # the exchange scales with row volume (raw rows, or one partial a
    # group a rank), never with the caller's group bound
    out_l = None if out_capacity is None else -(-out_capacity // w)
    adaptive = shuffle_capacity is None and out_capacity is None
    # an upper bound for both paths: the partials never outnumber the
    # raw rows priced here
    with _stage("dist_groupby", "count_probe"):
        tight = _tight_rows_local(env, [(counts, caps)], enabled=adaptive)
    pre, final, post = _combine_plan(aggs) if decomposable \
        else (None, None, None)
    sent: list = []

    def recv_rows(scale):
        return _out_cap_local(env, sum(caps), shuffle_capacity,
                              scale=scale, tight_rows=tight)

    def build(scale):
        shuf_l = recv_rows(scale)

        def run(t):
            sent.clear()
            lt, inof = checked_recv(t, t.capacity)
            if not decomposable:
                keys, vals = _key_data(lt, by)
                sh, of = checked_recv(shuffle_local(
                    comm, lt, partition_ids(keys, w, vals), shuf_l, sent),
                    shuf_l)
                res = groupby_aggregate(sh, by, aggs, out_capacity=out_l,
                                        quantile=quantile)
                return poison(res, inof, of)
            part = groupby_aggregate(lt, by, pre)
            # a pre-combine that overflowed its group bound would lose
            # its mark in the exchange (only the buffer's rows move):
            # carry it to the output
            pof = part.nrows > part.capacity
            part = part.with_nrows(torch.clamp(part.nrows,
                                               max=part.capacity))
            keys, vals = _key_data(part, by)
            sh, of = checked_recv(shuffle_local(
                comm, part, partition_ids(keys, w, vals), shuf_l, sent),
                shuf_l)
            res = post(groupby_aggregate(sh, by, final, out_capacity=out_l))
            return poison(res, inof, of, pof)
        return run

    out = _adaptive(env, build, (table,), adaptive, op="dist_groupby",
                    tight=tight is not None,
                    recv=(recv_rows, [(counts, caps)]))
    _note_exchange(env, "dist_groupby", sent)
    return out


def _combine_plan(aggs):
    """Each aggregate as (partial aggregates, their merges, a post step)
    (port of ``cylon_tpu/parallel/dist_ops.py:1049``): mean as sum and
    count, var and std as sum, count and sum of squares."""
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    pre, final, keep = [], [], []
    seen = set()

    def need(src, op):
        name = f"__{src}__{op}"
        if name not in seen:
            seen.add(name)
            pre.append((src, op, name))
            final.append((name, _MERGEABLE.get(op, "sum"), name))
        return name

    for src, op, out in aggs:
        if op in _MERGEABLE:
            keep.append((need(src, op), out, None))
        elif op == "mean":
            keep.append((None, out, ("mean", need(src, "sum"),
                                     need(src, "count"))))
        elif op in ("var", "std"):
            keep.append((None, out, (op, need(src, "sum"),
                                     need(src, "count"),
                                     need(src, "sumsq"))))
        else:
            raise InvalidArgument(f"{op!r} does not decompose")

    def post(res):
        cols = res.columns
        out_cols = {n: c for n, c in cols.items() if not n.startswith("__")}
        for name, out, spec in keep:
            if spec is None:
                out_cols[out] = cols[name]
                continue
            kind = spec[0]
            s = cols[spec[1]].data.to(torch.float64)
            c = cols[spec[2]].data.to(torch.float64)
            sq = None if kind == "mean" \
                else cols[spec[3]].data.to(torch.float64)
            out_cols[out] = Column(_moments(kind, s, c, sq),
                                   c > (0 if kind == "mean" else 1),
                                   dtypes.float64)
        return Table(out_cols, res.nrows)

    return pre, final, post


# -------------------------------------------------------------- aggregates
#: bins per refinement pass of the mergeable quantile sketch; two passes
#: bracket the target rank within (max - min) / SKETCH_BINS**2
SKETCH_BINS = 2048


def _sketch_quantile(comm, data, ok, q: float) -> torch.Tensor:
    """The mergeable two-pass histogram quantile, the ``exact=False``
    route of :func:`dist_aggregate` (port of
    ``cylon_tpu/parallel/dist_ops.py:1576``). Each rank bins its values
    into ``SKETCH_BINS`` buckets over the world's [min, max], the
    histograms add up across ranks (exact integers), the target rank's
    bucket is refined by a second pass; the result, a bracket's
    midpoint interpolated as the exact route does, is within one bracket
    ``(max - min) / SKETCH_BINS**2`` of the exact quantile. Communication
    is O(SKETCH_BINS) a pass, whatever the rows. Non-finite values count
    as missing."""
    if not 0.0 <= q <= 1.0:
        raise InvalidArgument(f"quantile {q} not in [0, 1]")
    f = torch.float64
    dev = data.device
    x = data.to(f)
    ok = ok & torch.isfinite(x)
    x = torch.where(ok, x, 0.0)
    n = comm.all_reduce(ok.sum(dtype=torch.int64), "sum")
    big = torch.full((1,), torch.finfo(f).max, dtype=f, device=dev)
    lo = comm.all_reduce(torch.cat([torch.where(ok, x, big), big]).min(),
                         "min")
    hi = comm.all_reduce(torch.cat([torch.where(ok, x, -big), -big]).max(),
                         "max")
    nb = SKETCH_BINS
    tiny = torch.finfo(f).tiny
    pos = q * torch.clamp(n - 1, min=0).to(f)
    k0 = torch.floor(pos).to(torch.int64)
    k1 = torch.ceil(pos).to(torch.int64)

    def histogram(blo, width, active):
        rel = torch.clamp(torch.floor((x - blo) / width), 0,
                          nb - 1).to(torch.int64)
        # the inactive rows count in one more bin, dropped: adding their
        # zeros into the clamped edge bins would pile every one of them
        # onto two counters
        hist = torch.bincount(torch.where(active, rel, nb),
                              minlength=nb + 1)[:nb]
        return rel, torch.cumsum(comm.all_reduce(hist, "sum"), 0)

    def descend(cum, rel, blo, width, active, k, before):
        # the first bucket whose running count passes the rank left: the
        # bucket of global rank k, its members by bucket id (edge rows
        # follow the binning that counted them)
        j = torch.searchsorted(cum, (k - before).reshape(1), right=True)[0]
        j = torch.clamp(j, 0, nb - 1)
        before = before + torch.where(
            j > 0, cum[torch.clamp(j - 1, min=0)], 0)
        return active & (rel == j), blo + j.to(f) * width, before

    # pass 1 does not depend on the rank sought: one histogram serves both
    w1 = torch.clamp((hi - lo) / nb, min=tiny)
    rel1, cum1 = histogram(lo, w1, ok)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def refine(k):
        act, blo, before = descend(cum1, rel1, lo, w1, ok, k, zero)
        w2 = torch.clamp(w1 / nb, min=tiny)
        rel2, cum2 = histogram(blo, w2, act)
        _, blo2, _ = descend(cum2, rel2, blo, w2, act, k, before)
        return blo2 + w2 * 0.5

    v0 = refine(k0)
    v1 = torch.where(k1 > k0, refine(k1), v0)
    out = v0 + (v1 - v0) * (pos - k0.to(f))
    return torch.where(n > 0, out, torch.full((), float("nan"), dtype=f,
                                              device=dev))


@_op("dist_aggregate")
def dist_aggregate(env, table, col: str, op: str, quantile: float = 0.5,
                   exact: bool = True) -> torch.Tensor:
    """Scalar aggregate of a column over every rank's shard (port of
    ``cylon_tpu/parallel/dist_ops.py:1649``; parity ``compute::Sum/Count/
    Min/Max`` + ``DoAllReduce``, ``compute/aggregates.cpp:26-147``): a 0-d
    tensor, the same bits on every rank (each all-reduce folds in rank
    order). Nulls and NaNs are skipped. ``op`` from
    :data:`cylon_tpu_torch.ops.aggregates.AGGS`.

    median / quantile: ``exact=True`` gathers the column to every rank;
    ``exact=False`` takes the mergeable sketch (:func:`_sketch_quantile`),
    and so does ``exact=True`` when the gathered column would pass
    ``CYLON_TPU_EXACT_GATHER_LIMIT`` bytes (default 2 GiB), with a logged
    notice. nunique moves each value to one rank by its hash and counts
    distinct values there; the move's buffer regrows on skew, its settled
    scale remembered on the table. A poisoned input (an upstream
    overflow on any rank) raises :class:`OutOfCapacity`, as the JAX
    package's eager call does; inside a
    :class:`~cylon_tpu_torch.plan.CompiledQuery` it registers its flag
    (:func:`~cylon_tpu_torch.plan.note_overflow`) and gives NaN or
    ``iinfo.min``, as the JAX package's traced call, and the compiled
    query regrows or raises."""
    if op not in AGGS:
        raise InvalidArgument(f"unknown aggregate {op!r}")
    memo = table.__dict__.setdefault("_agg_scale_memo", {})
    one = env.world_size == 1
    if not one:
        table, counts, caps = world_layout_sized(env, table)
    c = table.column(col)
    if c.data.dim() == 2 and op not in ("count", "nunique"):
        raise TypeError_(f"{op!r} of the string column {col!r}: a "
                         "device-bytes column takes count and nunique")
    if one:
        # the poison decided on the device; only the eager call's raise
        # reads it on the host
        flag = table.nrows > table.capacity
        if not plan.in_compiled() and bool(flag):
            raise OutOfCapacity(
                f"dist_aggregate({op!r}): poisoned input (an upstream op "
                "overflowed its capacity)")
        plan.note_overflow(flag)
        return _poisoned(_world_aggregate(env, table, [table.capacity], c,
                                          col, op, quantile, exact, memo),
                         flag)
    # every rank reads the same counts, so every rank takes one branch
    poisoned = any(n > k for n, k in zip(counts, caps))
    flag = torch.full((), poisoned, dtype=torch.bool, device=c.data.device)
    plan.note_overflow(flag)
    if poisoned and not plan.in_compiled():
        raise OutOfCapacity(
            f"dist_aggregate({op!r}): poisoned input (an upstream op "
            "overflowed its capacity)")
    val = _world_aggregate(env, table, caps, c, col, op, quantile, exact,
                           memo)
    return _poisoned(val, flag) if poisoned else val


def _world_aggregate(env, table, caps, c, col, op, quantile, exact, memo):
    """:func:`dist_aggregate`'s value over the world's valid rows."""
    comm = env.comm
    w = env.world_size
    data = c.data
    if op in ("median", "quantile") and exact:
        limit = int(os.environ.get("CYLON_TPU_EXACT_GATHER_LIMIT",
                                   str(2 << 30)))
        rep = max(caps) * w * data.element_size()
        if rep > limit:
            get_logger().warning(
                "dist_aggregate(%r): the exact route would gather %d MiB "
                "to every rank (over the %d MiB limit, "
                "CYLON_TPU_EXACT_GATHER_LIMIT); using the mergeable "
                "sketch (error <= range/%d^2)", op, rep >> 20,
                limit >> 20, SKETCH_BINS)
            exact = False

    vmask = kernels.valid_mask(table.capacity, table.nrows, data.device)
    nulls = _null_flags(c)
    ok = vmask if nulls is None else vmask & (nulls == 0)
    if op == "count":
        return comm.all_reduce(ok.sum(dtype=torch.int64), "sum")
    if op == "sum":
        return _all_reduce(comm, _masked_sum(data, ok), "sum")
    if op in ("min", "max"):
        return _all_reduce(comm, _masked_extreme(data, ok, op), op)
    if op in ("median", "quantile"):
        q = 0.5 if op == "median" else quantile
        if not exact:
            return _sketch_quantile(comm, data, ok, q)
        # every rank's column, padded to the largest capacity
        m = max(caps)
        pad_d = torch.zeros(m, dtype=data.dtype, device=data.device)
        pad_d[:table.capacity] = data
        pad_ok = torch.zeros(m, dtype=torch.bool, device=data.device)
        pad_ok[:table.capacity] = ok
        return _masked_quantile(comm.all_gather(pad_d).reshape(-1),
                                comm.all_gather(pad_ok).reshape(-1), q)
    if op == "nunique":
        return _dist_nunique(env, c, ok, sum(caps), memo, col)
    f = torch.float64 if data.element_size() >= 4 else torch.float32
    vals = torch.where(ok, data.to(f), 0.0)
    s = comm.all_reduce(vals.sum(), "sum")
    n = comm.all_reduce(ok.sum(dtype=f), "sum")
    sq = None if op == "mean" else comm.all_reduce((vals * vals).sum(),
                                                   "sum")
    return _moments(op, s, n, sq)


def _dist_nunique(env, c, ok, world_capacity: int, memo: dict, col: str):
    """Distinct non-missing values over the world: each value moves to
    the rank its hash names (only the rows ``ok`` marks), each rank counts
    its distinct values, the counts add up. The move's buffer doubles
    while any rank's overflows, from the scale ``memo`` remembers."""
    comm = env.comm
    w = env.world_size
    pid = partition_ids([c.data], w, [c.validity])
    # the table's memo keeps only what this ladder climbed to, never the
    # ambient floor (as the group-by's)
    start = scale = max(plan.current_scale(), memo.get(("nunique", col), 1))
    while True:
        buf = _out_cap_local(env, world_capacity, scale=scale)
        (got,), n_recv = exchange_arrays(comm, [c.data], pid, ok, buf)
        of = (n_recv > buf).to(torch.int32).reshape(1)
        _, ng, _ = kernels.dense_group_ids(
            [got], torch.clamp(n_recv, max=buf), None)
        total = comm.all_reduce(ng.to(torch.int64), "sum")
        if not int(comm.all_reduce(of, "sum")[0]):
            if scale > start:
                memo[("nunique", col)] = scale
            plan.note_scale(scale)
            return total
        if scale >= MAX_SCALE:
            raise OutOfCapacity(
                f"dist_aggregate('nunique'): the exchange still overflows "
                f"at {scale}x the default buffer")
        scale *= 2


# ------------------------------------------------------- filter and head
@_op("dist_filter")
def dist_filter(env, table, mask):
    """Rank-local filter (port of ``cylon_tpu/parallel/dist_ops.py:758``):
    each rank keeps its own valid rows where ``mask`` (``[capacity]``
    bool, built elementwise on its shard) holds. No collective; the
    capacity stays, so it cannot overflow; an overflow carried in stays
    marked. ``env`` is taken for the JAX package's signature."""
    lt, inof = checked_recv(table, table.capacity)
    return poison(filter_table(lt, mask), inof)


@_op("dist_head")
def dist_head(env, table, n: int):
    """The world's first ``n`` rows in rank order, the order
    ``gather_table`` gives (port of
    ``cylon_tpu/parallel/dist_ops.py:785``): no row moves, only the
    counts. One all-gather of the counts gives the rows of the ranks
    before this one, as ``repartition`` computes its offset; this rank
    keeps ``clip(n - before, 0, its count)``. An overflow on any rank
    marks every rank's result."""
    if env.world_size == 1:
        # the same rows from the device count, the mark kept
        n_dev = table.nrows
        return table.with_nrows(torch.where(
            n_dev > table.capacity, n_dev, torch.clamp(n_dev, max=n)))
    counts, caps = shard_sizes(env, table)
    if any(c > k for c, k in zip(counts, caps)):
        return table.with_nrows(table.capacity + 1)
    before = sum(counts[:env.rank])
    return table.with_nrows(min(max(n - before, 0), counts[env.rank]))


# -------------------------------------------------------------------- sort
@dataclasses.dataclass(frozen=True)
class SortOptions:
    """Distributed range partitioning for :func:`dist_sort` (port of
    ``cylon_tpu/config.py:59``; parity ``table.hpp:378-383``
    ``SortOptions{num_bins, num_samples}``). ``num_bins == 0`` (the
    default) takes splitters from ``num_samples`` (0: 1024) sorted
    samples a rank, one all-gather; ``num_bins > 0`` takes the
    reference's histogram (``arrow_partition_kernels.cpp:334-421``):
    the world's min and max of the first key, a ``num_bins``-bucket
    histogram summed over the ranks, split points at the count
    quantiles. The JAX struct's ``ascending`` field, which nothing there
    reads, is left out: the direction is :func:`dist_sort`'s
    argument."""

    num_bins: int = 0
    num_samples: int = 0


@_op("dist_sort")
def dist_sort(env, table, by, ascending=True,
              options: "SortOptions | None" = None,
              out_capacity: "int | None" = None):
    """Distributed sort (port of ``cylon_tpu/parallel/dist_ops.py:1109``;
    parity ``DistributedSort``, ``table.cpp:347``): range-partition the
    rows, exchange them, sort each rank's range. Rank s holds the s-th
    range of the whole stable sort order, so ``gather_table`` gives the
    sorted table.

    The sample path (default) partitions by salted tuples: a row's whole
    local sort key (:func:`sort_key_operands`, each word of a bytes key)
    and its global row id. The partition order is then the stable sort
    order itself: a key value holding half the rows spreads over
    adjacent ranks, and ties keep their global order. The histogram
    path (``options.num_bins > 0``) bins the first key only, so equal
    first keys share a rank. A world of one sorts locally, as
    ``dist_join`` joins locally. Receive buffers as :func:`shuffle`'s:
    a bucket of the true rows, regrown on skew."""
    by = [by] if isinstance(by, str) else list(by)
    asc = [ascending] * len(by) if isinstance(ascending, bool) \
        else list(ascending)
    options = options or SortOptions()
    if env.world_size == 1:
        out = sort_table(table, by, asc)
        return out if out_capacity is None \
            else _trim_capacity(out, out_capacity, out.nrows)
    with _stage("dist_sort", "prepare"):
        table, counts, caps = world_layout_sized(env, table)
    lt, inof = checked_recv(table, table.capacity)
    with _stage("dist_sort", "splitters"):
        pid = _sort_body(env, lt, by, asc, options.num_samples or 1024,
                         options.num_bins or 0, max(caps))
    with _stage("dist_sort", "count_probe"):
        tight = _tight_rows_local(env, [(counts, caps)],
                                  enabled=out_capacity is None)
    sent: list = []

    def recv_rows(scale):
        return _out_cap_local(env, sum(caps), out_capacity, scale=scale,
                              tight_rows=tight)

    def build(scale):
        out_l = recv_rows(scale)

        def run(t):
            sent.clear()
            sh, of = checked_recv(
                shuffle_local(env.comm, lt, pid, out_l, sent), out_l)
            return poison(sort_table(sh, by, asc), inof, of)
        return run

    out = _adaptive(env, build, (table,), out_capacity is None,
                    op="dist_sort", tight=tight is not None,
                    recv=(recv_rows, [(counts, caps)]))
    _note_exchange(env, "dist_sort", sent)
    return out


def _splitter_searchsorted(splitters, rows) -> torch.Tensor:
    """``pid[i]`` = the number of splitter tuples lexicographically below
    row tuple i (port of ``cylon_tpu/parallel/dist_ops.py:1162``): a
    lower bound over the sorted splitters as a binary search of fixed
    depth, each round gathering one splitter tuple a row, so the
    transients are O(rows * components), flat in W. A row equal to a
    splitter tuple lands on the splitter's left rank. ``splitters`` and
    ``rows`` are matching lists of int64 components whose signed order
    is the key order. (``torch.searchsorted`` takes one component; a
    salted tuple never packs into one.)"""
    m = int(splitters[0].shape[0])
    n = rows[0].shape[0]
    dev = rows[0].device
    if m == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), m, dtype=torch.int64, device=dev)
    for _ in range(max(m.bit_length(), 1)):
        active = lo < hi
        mid = torch.where(active, (lo + hi) // 2, 0)
        less = torch.zeros(n, dtype=torch.bool, device=dev)
        eq = torch.ones(n, dtype=torch.bool, device=dev)
        for g, r in zip(splitters, rows):
            sp = g[mid]
            less |= eq & (sp < r)
            eq &= sp == r
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo.to(torch.int32)


def _sortable_high(bits: int) -> int:
    """The largest sortable value of a ``bits``-bit order key (the JAX
    package's ``sentinel_high`` of the unsigned key type)."""
    return kernels._MAX64 if bits == 64 else (1 << bits) - 1


def _unsigned_f64(s: torch.Tensor, bits: int) -> torch.Tensor:
    """A sortable order key as the float64 of its unsigned value,
    rounded once, as the JAX package's ``astype(float64)`` of a uint64:
    the high and low 32 bits are exact doubles, so their sum is the one
    rounding (a 64-bit key in the top half never goes negative)."""
    if bits < 64:
        return s.to(torch.float64)
    u = s ^ kernels._MIN64
    hi = (u >> 32) & 0xFFFFFFFF
    return hi.to(torch.float64) * 4294967296.0 \
        + (u & 0xFFFFFFFF).to(torch.float64)


def _sort_body(env, lt, by, asc, nsamp: int, nbins: int, salt_cap: int):
    """This rank's destination for each row of its shard ``lt`` (port of
    the partition half of ``cylon_tpu/parallel/dist_ops.py:1202``
    ``_sort_body``; the exchange and the local sort follow in
    :func:`dist_sort`). ``salt_cap``, the largest shard capacity, makes
    ``rank * salt_cap + row`` the global row id in rank order (int64:
    exact while W * salt_cap < 2^63)."""
    comm = env.comm
    w = env.world_size
    n = lt.nrows
    cap = lt.capacity
    dev = lt.device
    vmask = kernels.valid_mask(cap, n, dev)
    if nbins:
        c = lt.column(by[0])
        if c.dtype.is_bytes:
            # the first 8 bytes as a u64 prefix, big-endian: prefix order
            # is string order, and rows equal in the prefix share a bin
            w0 = c.data[:, 0].to(torch.int64) & 0xFFFFFFFF
            w1 = c.data[:, 1].to(torch.int64) & 0xFFFFFFFF \
                if c.data.shape[1] > 1 else torch.zeros_like(w0)
            key = kernels.OrderKey((w0 << 32) | w1, 64)
            if not asc[0]:
                key = kernels.OrderKey(~key.value, 64)
        else:
            key = kernels.order_key(c.data, asc[0])
        s = kernels.sortable(key)
        high = _sortable_high(key.bits)
        if c.validity is not None:          # nulls to the top range
            s = torch.where(c.validity, s, high)
        if c.data.is_floating_point() and c.data.dim() == 1:
            s = torch.where(torch.isnan(c.data), high, s)   # NaN last too
        # the world's min and max, and below the histogram's sum: the
        # reference's two mpi::AllReduce rounds
        low = kernels._MIN64 if key.bits == 64 else 0
        smin = all_reduce(env, torch.cat([torch.where(vmask, s, high),
                                          s.new_full((1,), high)]).min(),
                          ReduceOp.MIN)
        smax = all_reduce(env, torch.cat([torch.where(vmask, s, low),
                                          s.new_full((1,), low)]).max(),
                          ReduceOp.MAX)
        kf = _unsigned_f64(s, key.bits)
        kmin = _unsigned_f64(smin, key.bits)
        span = torch.clamp(_unsigned_f64(smax, key.bits) - kmin, min=1.0)
        bins = torch.clamp((kf - kmin) / span * nbins, 0,
                           nbins - 1).to(torch.int64)
        hist = torch.bincount(torch.where(vmask, bins, nbins),
                              minlength=nbins + 1)[:nbins]
        cum = torch.cumsum(all_reduce(env, hist, ReduceOp.SUM), 0)
        targets = torch.arange(1, w, dtype=torch.int64, device=dev) \
            * cum[-1] // w
        split_bin = torch.searchsorted(cum, targets)
        return torch.searchsorted(split_bin, bins).to(torch.int32)
    ops = []
    for name, a in zip(by, asc):
        ops.extend(sort_key_operands(lt.column(name), a))
    comps = kernels.split_order_keys(ops)
    salt = env.rank * salt_cap + torch.arange(cap, dtype=torch.int64,
                                              device=dev)
    rows = [kernels.sortable(k) for k in comps] + [salt]
    highs = [_sortable_high(k.bits) for k in comps] + [kernels._MAX64]
    perm = kernels.sort_perm(ops, n)    # valid rows first
    take_i = torch.arange(nsamp, dtype=torch.int64, device=dev) \
        * torch.clamp(n, min=1) // nsamp
    pos = kernels._rows_at(perm, torch.minimum(take_i,
                                               torch.clamp(n - 1, min=0)),
                           nsamp)
    samples = torch.stack([torch.where(n > 0, kernels._rows_at(r, pos, nsamp),
                                       h) for r, h in zip(rows, highs)])
    k = len(rows)
    got = comm.all_gather(samples).reshape(w, k, nsamp).transpose(0, 1) \
        .reshape(k, w * nsamp)
    order = kernels.lexsort_perm(list(got))
    cut = order[torch.arange(1, w, dtype=torch.int64, device=dev)
                * (w * nsamp) // w]
    return _splitter_searchsorted([g[cut] for g in got], rows)


# ----------------------------------------------------------------- set ops
def _dist_setop(env, a, b, local_op, out_capacity):
    """Hash-partition both tables on every column, exchange, run
    ``local_op`` on each rank (port of
    ``cylon_tpu/parallel/dist_ops.py:1326``). Both tables first take one
    world layout, one dictionary a column and one string storage, and the
    masks of ``a`` and ``b`` are paired before hashing
    (:func:`cylon_tpu_torch.ops.hash.paired_validities`): equal rows
    reach one rank even where a column is nullable on one side only.
    (The JAX package hashes each side's validity word only where that
    side has a mask, and loses those rows.) A world of one runs the
    local op."""
    from cylon_tpu_torch.ops.bytescol import align_table_strings
    from cylon_tpu_torch.ops.dictenc import unify_table_dictionaries

    if env.world_size == 1:
        return local_op(a, b, out_capacity)
    opname = f"dist_{local_op.__name__}"
    with _stage(opname, "prepare"):
        a, counts_a, caps_a = world_layout_sized(env, a)
        b, counts_b, caps_b = world_layout_sized(env, b)
        a, b = align_table_strings(unify_table_dictionaries([a, b]))
    w = env.world_size
    cols = a.column_names
    out_l = None if out_capacity is None else -(-out_capacity // w)
    adaptive = out_capacity is None
    with _stage(opname, "count_probe"):
        tight_a = _tight_rows_local(env, [(counts_a, caps_a)],
                                    enabled=adaptive)
        tight_b = _tight_rows_local(env, [(counts_b, caps_b)],
                                    enabled=adaptive)
    sent: list = []
    la, ina = checked_recv(a, a.capacity)
    lb, inb = checked_recv(b, b.capacity)
    ka, va = _key_data(la, cols)
    kb, vb = _key_data(lb, cols)
    va, vb = paired_validities(ka, va, kb, vb)
    pa, pb = partition_ids(ka, w, va), partition_ids(kb, w, vb)

    def recv_rows(scale):
        return (_out_cap_local(env, sum(caps_a), scale=scale,
                               tight_rows=tight_a),
                _out_cap_local(env, sum(caps_b), scale=scale,
                               tight_rows=tight_b))

    def build(scale):
        shuf_a, shuf_b = recv_rows(scale)

        def run(ta, tb):
            sent.clear()
            sa, ofa = checked_recv(
                shuffle_local(env.comm, la, pa, shuf_a, sent), shuf_a)
            sb, ofb = checked_recv(
                shuffle_local(env.comm, lb, pb, shuf_b, sent), shuf_b)
            return poison(local_op(sa, sb, out_l), ina, inb, ofa, ofb)
        return run

    out = _adaptive(env, build, (a, b), adaptive, op=opname,
                    tight=tight_a is not None or tight_b is not None,
                    recv=(lambda s: sum(recv_rows(s)),
                          [(counts_a, caps_a), (counts_b, caps_b)]))
    _note_exchange(env, opname, sent)
    return out


@_op("dist_union")
def dist_union(env, a, b, out_capacity: "int | None" = None):
    """Distinct rows of either table over the world (port of
    ``cylon_tpu/parallel/dist_ops.py:1373``; parity
    ``DistributedUnion``, ``table.cpp:724-748``)."""
    return _dist_setop(env, a, b, union, out_capacity)


@_op("dist_intersect")
def dist_intersect(env, a, b, out_capacity: "int | None" = None):
    """Distinct rows of both tables over the world (port of
    ``cylon_tpu/parallel/dist_ops.py:1382``; parity
    ``DistributedIntersect``)."""
    return _dist_setop(env, a, b, intersect, out_capacity)


@_op("dist_subtract")
def dist_subtract(env, a, b, out_capacity: "int | None" = None):
    """Distinct rows of ``a`` not in ``b`` over the world (port of
    ``cylon_tpu/parallel/dist_ops.py:1391``; parity
    ``DistributedSubtract``)."""
    return _dist_setop(env, a, b, subtract, out_capacity)


@_op("dist_unique")
def dist_unique(env, table, cols: "Sequence[str] | None" = None,
                out_capacity: "int | None" = None, keep: str = "first"):
    """Distinct rows by ``cols`` over the world (port of
    ``cylon_tpu/parallel/dist_ops.py:1400``; parity
    ``DistributedUnique``, ``table.cpp:977-989``): hash-partition on the
    key columns, exchange, local :func:`unique`. ``out_capacity`` bounds
    the exchange, as in the JAX package. A world of one runs the local
    op, as :func:`dist_join` does, its rows bounded by ``out_capacity``
    as the exchange would."""
    if env.world_size == 1:
        lt, inof = checked_recv(table, table.capacity if out_capacity is None
                                else out_capacity)
        return poison(unique(lt, cols, keep=keep), inof)
    with _stage("dist_unique", "prepare"):
        table, counts, caps = world_layout_sized(env, table)
    names = list(cols) if cols is not None else table.column_names
    w = env.world_size
    lt, inof = checked_recv(table, table.capacity)
    keys, vals = _key_data(lt, names)
    pid = partition_ids(keys, w, vals)
    with _stage("dist_unique", "count_probe"):
        tight = _tight_rows_local(env, [(counts, caps)],
                                  enabled=out_capacity is None)
    sent: list = []

    def recv_rows(scale):
        return _out_cap_local(env, sum(caps), out_capacity, scale=scale,
                              tight_rows=tight)

    def build(scale):
        shuf_l = recv_rows(scale)

        def run(t):
            sent.clear()
            sh, of = checked_recv(
                shuffle_local(env.comm, lt, pid, shuf_l, sent), shuf_l)
            return poison(unique(sh, cols, keep=keep), inof, of)
        return run

    out = _adaptive(env, build, (table,), out_capacity is None,
                    op="dist_unique", tight=tight is not None,
                    recv=(recv_rows, [(counts, caps)]))
    _note_exchange(env, "dist_unique", sent)
    return out


# ------------------------------------------------- co-located (no exchange)
@_op("colocated_join")
def colocated_join(env, left, right, *, on=None, left_on=None,
                   right_on=None, how: str = "inner", suffixes=("_x", "_y"),
                   out_capacity: "int | None" = None,
                   algorithm: str = "sort"):
    """Each rank joins its own shards of two tables whose keys are
    already co-located (port of ``cylon_tpu/parallel/dist_ops.py:1440``;
    parity: the local join stage after the reference's streaming
    all-to-all, ``ops/dis_join_op.cpp``): no exchange. The output bound
    defaults to the rank's input capacities and regrows on overflow."""
    left_on, right_on = _join_keys(on, left_on, right_on)

    def build(scale):
        join_l = (left.capacity + right.capacity) * scale \
            if out_capacity is None else -(-out_capacity // env.world_size)

        def run(lt, rt):
            ltab, liof = checked_recv(lt, lt.capacity)
            rtab, riof = checked_recv(rt, rt.capacity)
            res = _join_fn(ltab, rtab, left_on=left_on, right_on=right_on,
                           how=how, suffixes=suffixes, out_capacity=join_l,
                           algorithm=algorithm, ordered=False)
            return poison(res, liof, riof)
        return run

    return _adaptive(env, build, (left, right), out_capacity is None)


@_op("colocated_groupby")
def colocated_groupby(env, table, by, aggs,
                      out_capacity: "int | None" = None,
                      quantile: float = 0.5):
    """Each rank aggregates its own shard of a table whose keys are
    already co-located (port of ``cylon_tpu/parallel/dist_ops.py:1487``):
    the finalize stage of a streaming group-by. The group bound regrows
    as ``groupby_aggregate``'s does."""
    out_l = None if out_capacity is None \
        else -(-out_capacity // env.world_size)
    lt, inof = checked_recv(table, table.capacity)
    return poison(groupby_aggregate(lt, by, aggs, out_capacity=out_l,
                                    quantile=quantile), inof)


@_op("colocated_unique")
def colocated_unique(env, table, cols: "Sequence[str] | None" = None,
                     keep: str = "first", out_capacity: "int | None" = None):
    """Each rank's distinct rows of a table whose keys are already
    co-located (port of ``cylon_tpu/parallel/dist_ops.py:1514``).
    ``out_capacity`` bounds the world's result, split over the ranks,
    and raises on overflow."""
    out_l = None if out_capacity is None \
        else -(-out_capacity // env.world_size)
    lt, inof = checked_recv(table, table.capacity)
    return poison(unique(lt, cols, keep=keep, out_capacity=out_l), inof)


# ------------------------------------------------------------------ concat
@_op("dist_concat")
def dist_concat(env, tables):
    """Distributed concatenation (port of
    ``cylon_tpu/parallel/dist_ops.py:1540``; parity pycylon
    ``distributed_concat``, ``table.pyx:2398``): each rank concatenates
    its own shards, no row moves, so the world's order is rank-major, as
    in the reference. Each table first takes one world layout, so that
    every rank's result holds one dictionary a column."""
    if not tables:
        raise InvalidArgument("concat of no tables")
    locs, flags = [], []
    for t in tables:
        lt, inof = checked_recv(world_layout(env, t), t.capacity)
        locs.append(lt)
        flags.append(inof)
    return poison(concat_tables(locs), *flags)
