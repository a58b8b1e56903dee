"""Graceful degradation under memory pressure: the OOM→spill fallback
executor.

Port of ``cylon_tpu/fallback.py``: the generic spill path for a query
that does not fit the device, the "partition locally → exchange → local
op" decomposition applied to host memory:

1. **Pre-flight** (:func:`run_with_fallback`): before dispatching, a
   byte estimate of the query's inputs (:func:`predict_query_bytes`)
   times a transient-expansion factor is compared against the free
   device memory (:func:`free_hbm_bytes`: ``torch.cuda.mem_get_info``
   plus what the caching allocator holds unallocated). A query that
   cannot fit routes STRAIGHT to the spill path
   (``ooc.fallbacks{reason="preflight"}``).

2. **In-flight OOM → retry once through the spill path**: the in-core
   attempt runs inside a :func:`cylon_tpu_torch.telemetry.memory.forensics`
   scope; a failure :func:`~cylon_tpu_torch.telemetry.memory.is_oom`
   recognises (``torch.cuda.OutOfMemoryError``, ``MemoryError``) is
   counted (``ooc.fallbacks{reason="oom"}``), the failed attempt's
   tensors are dropped, and the query retries EXACTLY ONCE through the
   spill path, with the pipeline sequential. Non-OOM errors propagate
   untouched.

3. **The spill path** (:func:`tpch_fallback` for TPC-H-shaped queries;
   :func:`join`/:func:`groupby`/:func:`sort` for plain relational
   ops): hash-partition the query's base tables by its dominant join
   key — declared per query in
   :data:`cylon_tpu_torch.tpch.manifest.FALLBACK`; plain ops derive it
   from ``on``/``by`` (their spill twins
   :func:`~cylon_tpu_torch.outofcore.ooc_join` /``ooc_groupby``/
   ``ooc_sort``) — run the EXISTING query per partition on the device,
   and merge the partial results with the associative combiners the
   manifest declares. The six queries whose answer embeds a global
   scalar run their two-phase plans (:mod:`cylon_tpu_torch.tpch.twophase`)
   instead, each phase per partition on the device. With a ``resume_dir`` every completed partition
   checkpoints through :class:`cylon_tpu_torch.resilience.CheckpointedRun`,
   so a run hard-killed mid-fallback (``FaultRule.kill``) resumes at the
   first incomplete partition with byte-identical durable units.

Every partition still runs on the device: nothing here falls back to a
CPU join. Knob: ``CYLON_TPU_HBM_BUDGET_BYTES`` overrides the card's
view of total device memory (tests and the chip smoke force a small
budget to take the spill route). The JAX package's
``CYLON_TPU_FALLBACK_EXPANSION`` and ``_FALLBACK_PARTS`` are the
constants :data:`EXPANSION_FACTOR` and :data:`DEFAULT_PARTITIONS` here.
"""

import gc
import hashlib
import inspect
import os
import traceback
from typing import Mapping

import numpy as np
import torch

from cylon_tpu_torch import pipeline, resilience, telemetry
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.tracing import span as _span

__all__ = [
    "expansion_factor", "free_hbm_bytes", "hbm_limit_bytes",
    "predict_query_bytes",
    "supports", "run_with_fallback", "run_query", "tpch_fallback",
    "join", "groupby", "sort",
]

#: effectively-unbounded limit the executor substitutes for a query's
#: ``limit`` kwarg on per-partition runs whose merge re-aggregates
#: (a per-partition top-k would drop rows whose GLOBAL aggregate is
#: large but whose per-partition partials are individually small).
#: Kept inside int32, as the JAX package's.
_NO_LIMIT = (1 << 31) - 1

#: input-bytes → peak-working-set multiplier of the pre-flight estimate
#: (the JAX package's ``CYLON_TPU_FALLBACK_EXPANSION``, a constant here):
#: the join's build and probe buffers, the result and the transients
EXPANSION_FACTOR = 4.0

#: default partition count of the spill path (the JAX package's
#: ``CYLON_TPU_FALLBACK_PARTS``, a constant here)
DEFAULT_PARTITIONS = 8


def expansion_factor() -> float:
    """Input-bytes → peak-working-set multiplier for the pre-flight
    estimate (:data:`EXPANSION_FACTOR`)."""
    return EXPANSION_FACTOR


def default_partitions() -> int:
    """The spill path's default partition count
    (:data:`DEFAULT_PARTITIONS`)."""
    return DEFAULT_PARTITIONS


def _hbm_budget_override() -> "int | None":
    """The ``CYLON_TPU_HBM_BUDGET_BYTES`` operator cap, parsed ONCE
    for every reader (pre-flight's free calculation and /health's
    headroom denominator — divergent parses would let the two disagree
    about which data source is live). None when unset or unusable; a
    malformed value is LOUDLY ignored — silently un-forcing an
    operator's budget cap (or a test's forced-tiny budget) would swap
    the data source without a trace."""
    knob = os.environ.get("CYLON_TPU_HBM_BUDGET_BYTES")
    if not knob:
        return None
    try:
        budget = int(knob)
    except ValueError:
        from cylon_tpu_torch.utils.logging import get_logger

        get_logger().warning(
            "malformed CYLON_TPU_HBM_BUDGET_BYTES=%r ignored — "
            "falling back to allocator stats", knob)
        return None
    return budget if budget > 0 else None


def _card_mem_info() -> "tuple[int, int] | None":
    """``(free, total)`` bytes of the current card. The free bytes add
    what PyTorch's caching allocator holds reserved but not allocated
    (``memory_reserved() - memory_allocated()``): free to this process,
    though the driver counts it used, so the pre-flight must not count
    the port's own cache against the query. None without a card."""
    if not torch.cuda.is_available():
        return None
    free, total = torch.cuda.mem_get_info()
    cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    return int(free) + max(int(cached), 0), int(total)


def free_hbm_bytes() -> "int | None":
    """Free device memory the pre-flight compares against.

    ``CYLON_TPU_HBM_BUDGET_BYTES`` (when set) is the authoritative
    TOTAL budget: free = budget − live bytes
    (:func:`cylon_tpu_torch.telemetry.memory.live_bytes`) — the knob
    tests use to force a tiny budget. Otherwise the current card's free
    bytes plus the allocator's unallocated cache
    (:func:`_card_mem_info`); None without a card — pre-flight then
    stands down and the in-flight OOM catch is the only route."""
    budget = _hbm_budget_override()
    if budget is not None:
        return max(budget - _memory.live_bytes(), 0)
    info = _card_mem_info()
    return None if info is None else info[0]


def hbm_limit_bytes() -> "int | None":
    """Total device memory: the ``CYLON_TPU_HBM_BUDGET_BYTES`` override
    when set (the same authority order as :func:`free_hbm_bytes`), else
    the current card's total; None without a card."""
    budget = _hbm_budget_override()
    if budget is not None:
        return budget
    info = _card_mem_info()
    return None if info is None else info[1]


def _table_nbytes(t) -> int:
    """Device bytes of a table's column buffers (data and validity),
    read off the tensors' shapes: no sync."""
    total = 0
    for c in t.columns.values():
        for a in (c.data, c.validity):
            if a is not None:
                total += a.numel() * a.element_size()
    return total


def _nbytes(obj) -> int:
    """Host/device byte size of one query input: a column Mapping, a
    pandas frame, or a Table/DataFrame (no device sync: the tensors'
    shapes only)."""
    t = getattr(obj, "table", obj)
    if hasattr(t, "columns") and hasattr(t, "capacity"):
        return _table_nbytes(t)
    if hasattr(obj, "memory_usage"):  # pandas
        return int(obj.memory_usage(index=False).sum())
    if isinstance(obj, Mapping):
        return int(sum(np.asarray(v).nbytes for v in obj.values()))
    return int(getattr(obj, "nbytes", 0))


def predict_query_bytes(data: Mapping, query: "str | None" = None) -> int:
    """Pre-flight byte estimate for a TPC-H-shaped query over ``data``:
    the (manifest-projected, when ``query`` names one) input bytes
    times :func:`expansion_factor` — the EXPLAIN-style static walk, no
    execution."""
    from cylon_tpu_torch.tpch.manifest import MANIFEST
    from cylon_tpu_torch.tpch.queries import manifest_keep

    declared = MANIFEST.get(query or "", None)
    total = 0
    for name, obj in data.items():
        if declared is not None and name not in declared:
            continue
        if isinstance(obj, Mapping) and declared is not None:
            keep = manifest_keep(name, list(obj.keys()), declared[name])
            total += sum(np.asarray(obj[c]).nbytes for c in keep)
        else:
            total += _nbytes(obj)
    return int(total * expansion_factor())


def supports(query: str) -> bool:
    """Does ``query`` have a usable (non-``None``-merge) fallback plan
    in :data:`cylon_tpu_torch.tpch.manifest.FALLBACK`? Since the two-phase
    executor landed this is True for all 22 TPC-H queries — False now
    means "not a TPC-H query name". (The hand-written streaming q1/q5
    paths exist independently of this answer.)"""
    from cylon_tpu_torch.tpch.manifest import FALLBACK

    return FALLBACK.get(query, {}).get("merge") is not None


def _known_queries() -> str:
    """The manifest's query names in numeric order, for fail-fast
    error messages."""
    from cylon_tpu_torch.tpch.manifest import FALLBACK

    return ", ".join(sorted(FALLBACK, key=lambda q: int(q[1:])))


# --------------------------------------------------------- the executor
def run_with_fallback(attempt, spill, *, op: str,
                      predicted_bytes: "int | None" = None,
                      budget_bytes: "int | None" = None):
    """Run ``attempt()`` with the OOM→spill contract (module
    docstring): pre-flight ``predicted_bytes`` against the free device
    memory
    budget (``budget_bytes`` overrides :func:`free_hbm_bytes` — tests
    pass tiny values), route to ``spill()`` when it cannot fit, and
    retry ONCE through ``spill()`` when the in-core attempt dies with
    an allocation failure (:func:`cylon_tpu_torch.telemetry.memory.is_oom`:
    ``torch.cuda.OutOfMemoryError`` and its kin); before the retry the
    failed attempt's tensors are dropped (its frames, held by the
    exception's traceback, lose their locals; then ``gc.collect()`` and,
    on a card, ``torch.cuda.empty_cache()``). Both callables must return the HOST
    (pandas/scalar) result — a device-resident answer to a query that
    just OOM'd would be self-defeating."""
    budget = free_hbm_bytes() if budget_bytes is None else budget_bytes
    if (predicted_bytes is not None and budget is not None
            and predicted_bytes > budget):
        telemetry.counter("ooc.fallbacks", op=op,
                          reason="preflight").inc()
        telemetry.events.emit("fallback", op=op, reason="preflight")
        _trace.instant("fallback.spill", cat="fallback", op=op,
                       reason="preflight", predicted=predicted_bytes,
                       budget=budget)
        from cylon_tpu_torch.utils.logging import get_logger

        get_logger().info(
            "%s: predicted %d bytes exceeds free device memory %d — routing "
            "straight to the spill path", op, predicted_bytes, budget)
        return spill()
    try:
        with _memory.forensics(f"fallback.{op}"):
            # seeded-fault hook: tests inject a deterministic OOM here
            # (FaultRule on the "plan" point) without needing a real
            # allocation failure
            resilience.inject("plan", f"fallback.{op}")
            return attempt()
    except Exception as e:
        if not _memory.is_oom(e):
            raise
        telemetry.counter("ooc.fallbacks", op=op, reason="oom").inc()
        telemetry.events.emit("fallback", op=op, reason="oom")
        _trace.instant("fallback.spill", cat="fallback", op=op,
                       reason="oom", error=type(e).__name__)
        from cylon_tpu_torch.utils.logging import get_logger

        get_logger().warning(
            "%s: in-core attempt exhausted memory (%s) — retrying "
            "ONCE through the spill path", op, type(e).__name__)
        # drop the failed attempt's tensors before the retry allocates:
        # the traceback holds the attempt's frames and they its tables,
        # so clear their locals, collect, and hand the cached blocks back
        traceback.clear_frames(e.__traceback__)
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        try:
            # the retry runs the pipeline SEQUENTIALLY: prefetch
            # lookahead would hold two partitions' device tables in an
            # allocator that just exhausted — the preflight route
            # above keeps the pipeline, its partitions being sized
            # against free device memory with headroom
            with pipeline.sequential():
                return spill()
        except Exception as e2:
            raise e2 from e


# --------------------------------------------- TPC-H partitioned rerun
def _materialize(out):
    """Host result of a query call: DataFrames/Tables → pandas
    (index dropped), 0-d scalars (a device tensor included) → float."""
    if hasattr(out, "to_pandas"):
        return out.to_pandas().reset_index(drop=True)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    arr = np.asarray(out)
    if arr.ndim == 0:
        return float(arr)
    return arr


def _host_cols(obj, table: str, keep) -> "dict[str, np.ndarray]":
    """One table's host columns, projected to the manifest keep-set —
    accepts a raw column Mapping, a pandas frame, or a (possibly
    device-resident) Table/DataFrame (fetched: the spill path
    partitions in host memory)."""
    from cylon_tpu_torch.tpch.queries import manifest_keep

    t = getattr(obj, "table", obj)
    if hasattr(t, "columns") and hasattr(t, "capacity"):
        obj = t.to_pandas()
    if hasattr(obj, "memory_usage"):  # pandas
        obj = {c: obj[c].to_numpy() for c in obj.columns}
    cols = {k: np.asarray(v) for k, v in obj.items()}
    return {c: cols[c]
            for c in manifest_keep(table, list(cols.keys()), keep)}


def _partition_rows(cols: dict, n_partitions: int) -> list:
    """Key-less partitioning (queries with no join over the table —
    q1/q6 lineitem scans): contiguous row chunks, order preserved."""
    n = len(next(iter(cols.values()))) if cols else 0
    bounds = [n * i // n_partitions for i in range(n_partitions + 1)]
    return [{k: v[bounds[p]:bounds[p + 1]] for k, v in cols.items()}
            for p in range(n_partitions)]


def _encode_partial(partial) -> "tuple[dict, int]":
    """A partition's partial result as checkpointable columns + a row
    count (scalars ride a one-element ``__scalar__`` column)."""
    if isinstance(partial, float):
        return {"__scalar__": np.asarray([partial], np.float64)}, 1
    return ({c: partial[c].to_numpy() for c in partial.columns},
            len(partial))


def _decode_partial(cols: dict):
    """Inverse of :func:`_encode_partial` ({} = empty unit → None)."""
    if not cols:
        return None
    if "__scalar__" in cols:
        return float(cols["__scalar__"][0])
    import pandas as pd

    return pd.DataFrame(cols)


def _resume_partial(ckpt, unit: int, op: "str | None" = None):
    """Replay one completed unit back into its partial (float, frame,
    or the schema'd EMPTY frame a 0-row frame unit reconstructs from
    its ``__schema__`` meta — a resumed all-empty run must return the
    byte-identical frame the first run did). ``op`` relabels the
    ``ooc.units_resumed`` counter (the merge unit counts under
    ``op="fallback_merge"``, not the per-query op)."""
    if op is None:
        cols = ckpt.resume_unit(unit)
    else:
        cols = ckpt.load_unit(unit)
        telemetry.counter("ooc.units_resumed", op=op).inc()
        _trace.instant("ckpt.resume", cat="resilience", op=op,
                       unit=int(unit))
        telemetry.events.emit("checkpoint_resume", op=op,
                              unit=int(unit))
    got = _decode_partial(cols)
    if got is None:
        schema = (ckpt.unit_meta(unit) or {}).get("__schema__")
        if schema:
            import pandas as pd

            got = pd.DataFrame({c: np.empty(0, np.dtype(d))
                                for c, d in schema})
    return got


def _partial_schema_meta(partial, meta: dict) -> dict:
    """Unit meta for a checkpointed partial: the verify-on-resume input
    sizes plus, for frame partials, the column schema (a 0-row unit
    writes no spill file; the resume rebuilds the empty frame from
    this)."""
    unit_meta = dict(meta)
    if not isinstance(partial, float):
        unit_meta["__schema__"] = [[c, str(partial[c].dtype)]
                                   for c in partial.columns]
    return unit_meta


def _cols_fingerprint(cols: dict) -> str:
    """Content digest of one table's host columns (string columns
    canonicalised to unicode so object-array identity never leaks into
    the hash) — how a resumable fallback detects a changed BROADCAST
    input, which the per-partition row-count meta cannot see."""
    h = hashlib.sha256()
    for name in sorted(cols):
        a = np.asarray(cols[name])
        if a.dtype.kind in ("O", "U", "S"):
            a = np.asarray(a, dtype=str)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _resolve_limit(fn, spec: dict, params: dict):
    """The caller-visible row limit of a limited query (its kwarg value
    or the signature default); None for unlimited queries."""
    lk = spec.get("limit_kwarg")
    if not lk:
        return None
    if lk in params:
        return params[lk]
    return inspect.signature(fn).parameters[lk].default


def _merge_partials(partials: list, spec: dict, limit):
    """Recombine per-partition partial results per the manifest merge
    spec (see :data:`cylon_tpu_torch.tpch.manifest.FALLBACK`)."""
    import pandas as pd

    merge = spec["merge"]
    if merge == "sum":
        # empty partitions contribute None (nothing of the partitioned
        # tables landed there) — they add 0 to a pure SUM
        return float(sum(float(x) for x in partials if x is not None))
    frames = [f for f in partials if f is not None]
    nonempty = [f for f in frames if len(f)]
    if not nonempty:
        return (frames[0] if frames else pd.DataFrame())
    df = pd.concat(nonempty, ignore_index=True)
    columns = list(nonempty[0].columns)
    if merge == "concat" and spec.get("distinct"):
        df = df.drop_duplicates(ignore_index=True)
    elif merge == "groupby":
        by = list(spec["by"])
        aggs = spec["aggs"]
        # df is a fresh concat we exclusively own — add the weighted
        # temp columns in place (a defensive copy would double host
        # peak in the one path that exists because memory ran out);
        # the final df[columns] selection drops them again
        work = df
        agg_map = {}
        for col, how in aggs.items():
            if isinstance(how, tuple):  # ("wmean", weight): a mean
                _, w = how            # re-merges as a weighted mean
                work["__w__" + col] = work[col] * work[w]
                agg_map["__w__" + col] = "sum"
            else:
                agg_map[col] = how
        out = work.groupby(by, sort=False, as_index=False).agg(agg_map)
        for col, how in aggs.items():
            if isinstance(how, tuple):
                out[col] = out["__w__" + col] / out[how[1]]
        df = out[columns]
    sort = spec.get("sort")
    if sort:
        df = df.sort_values(
            sort, ascending=spec.get("ascending", [True] * len(sort)),
            kind="stable", ignore_index=True)
    if limit is not None:
        df = df.head(int(limit)).reset_index(drop=True)
    return df[columns]


def _two_phase(query: str, part_tables: dict, bcast: dict,
               n_partitions: int, resume_dir: "str | None",
               plan_fp: tuple, params: dict, device):
    """The two-phase global-aggregate executor
    (:mod:`cylon_tpu_torch.tpch.twophase`): phase 1 emits associative
    partials per partition, a global merge computes the blocking
    scalar, phase 2 (when the plan has one) re-runs the cheap apply per
    partition with the scalar broadcast in. Both phases run each
    partition on ``device``; the partials and the merge are host.

    Unit layout under ``resume_dir``: phase-1 partial ``p`` → unit
    ``p`` (0..P-1), the merge result → unit ``P`` (journaled as its own
    unit — a kill between the phases resumes WITHOUT recomputing the
    merge), phase-2 partial ``p`` → unit ``P+1+p``. The merge runs
    under the ``fallback_merge`` watchdog section and fires the
    ``global_merge`` fault-injection point, and its resume counts
    ``ooc.units_resumed{op="fallback_merge"}`` so a chaos harness can
    see WHICH side of the phase boundary replayed."""
    from cylon_tpu_torch import watchdog
    from cylon_tpu_torch.tpch.twophase import PLANS

    plan = PLANS[query]
    merge_unit = n_partitions
    ckpt = None
    if resume_dir is not None:
        ckpt = resilience.CheckpointedRun(
            resume_dir, f"fallback_{query}", ("twophase-v1",) + plan_fp)
    done_map = ckpt.completed if ckpt is not None else {}
    telemetry.counter("ooc.fallback_partitions",
                      op=query).inc(n_partitions)
    metas = [{t: (len(next(iter(part_tables[t][p].values())))
                  if part_tables[t][p] else 0) for t in part_tables}
             for p in range(n_partitions)]

    def _ingest(phase_base):
        def _one(p):
            """Prefetch worker: assemble partition p's input mapping
            (broadcast host tables shared, partitioned slices attached)
            unless the unit is already durable or the partition is
            empty."""
            meta = metas[p]
            data_p = None
            if (phase_base + p) not in done_map and any(meta.values()):
                data_p = dict(bcast)
                for t in part_tables:
                    data_p[t] = part_tables[t][p]
            return data_p
        return _one

    def _run_phase(label, phase_base, compute):
        """One per-partition pass: resume durable units, skip empty
        partitions (0-row unit, no recompute on resume), compute and
        asynchronously checkpoint the rest. Returns the partition-
        aligned partial list."""
        partials = [None] * n_partitions
        with pipeline.committer(f"fallback.{query}.{label}") as com:
            for p, data_p in pipeline.prefetch_map(
                    range(n_partitions), _ingest(phase_base),
                    op="fallback"):
                unit, meta = phase_base + p, metas[p]
                if unit in done_map:
                    ckpt.verify_meta(
                        unit, f"tpch_fallback[{query}] {label}", **meta)
                    partials[p] = _resume_partial(ckpt, unit)
                    continue
                if all(v == 0 for v in meta.values()):
                    if ckpt is not None:
                        com.submit(lambda unit=unit, meta=meta:
                                   ckpt.complete(unit, {}, 0, meta=meta))
                    continue
                with _span("fallback.partition", cat="stage",
                           query=query, partition=p, phase=label,
                           **{f"rows_{t}": n for t, n in meta.items()}):
                    _memory.sample(op="fallback")
                    with _span("ooc.compute", cat="stage", op="fallback",
                               unit=unit):
                        partial = compute(p, data_p)
                if ckpt is not None:
                    cols, rows = _encode_partial(partial)
                    unit_meta = _partial_schema_meta(partial, meta)
                    com.submit(lambda unit=unit, cols=cols, rows=rows,
                               unit_meta=unit_meta: ckpt.complete(
                                   unit, cols, rows, meta=unit_meta))
                partials[p] = partial
                del data_p
        return partials

    partials1 = _run_phase(
        "phase1", 0,
        lambda p, data_p: plan.phase1(data_p, device=device, **params))

    if merge_unit in done_map:
        # the journaled merge replays from the checkpoint — the scalar
        # is NEVER recomputed from possibly-partial in-memory state
        merged = _resume_partial(ckpt, merge_unit, op="fallback_merge")
    else:
        def _compute_merge():
            resilience.inject("global_merge", f"fallback.{query}")
            return plan.merge(partials1, **params)

        with _span("fallback.merge", cat="stage", query=query,
                   partitions=n_partitions):
            merged = watchdog.bounded(_compute_merge, "fallback_merge",
                                      detail=f"fallback.{query}")
        if ckpt is not None:
            cols, rows = _encode_partial(merged)
            # synchronous commit: phase 2 depends on the merge being
            # durable — a kill during phase 2 must resume the SAME
            # scalar, not re-derive it
            ckpt.complete(merge_unit, cols, rows,
                          meta=_partial_schema_meta(
                              merged, {"n_partitions": n_partitions}))
    telemetry.counter("ooc.merge_phases", op=query).inc()
    telemetry.events.emit("merge_phase", op=query)

    partials2 = None
    if plan.phase2 is not None:
        partials2 = _run_phase(
            "phase2", merge_unit + 1,
            lambda p, data_p: plan.phase2(data_p, partials1[p], merged,
                                          device=device, **params))
    return plan.reduce(merged, partials2, **params)


def tpch_fallback(query: str, data: Mapping, *, env=None,
                  n_partitions: "int | None" = None,
                  resume_dir: "str | None" = None,
                  compiled: bool = True, **params):
    """The spill path for one TPC-H query: hash-partition its base
    tables by the manifest's dominant join key, run the EXISTING
    (compiled by default) query per partition, merge the partials
    (module docstring). Queries whose answer embeds a global scalar
    (``merge == "twophase"``) route to the two-phase executor
    (:func:`_two_phase`) instead — partial pass, journaled global
    merge, apply pass. Returns the HOST result (pandas frame or
    float). All 22 queries have a plan; an unknown query name fails
    fast with the known-query list.

    ``resume_dir`` checkpoints every completed partition through
    :class:`cylon_tpu_torch.resilience.CheckpointedRun` (fingerprint = query
    + partition plan + params; per-partition input sizes re-verified
    on resume), so a hard-killed fallback resumes instead of
    restarting.
    """
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.outofcore import host_partition_chunks
    from cylon_tpu_torch.tpch.manifest import FALLBACK, MANIFEST

    spec = FALLBACK.get(query)
    if spec is None:
        raise InvalidArgument(
            f"unknown TPC-H query {query!r} — known queries: "
            f"{_known_queries()}")
    if n_partitions is None:
        n_partitions = default_partitions()
    if int(n_partitions) < 1:
        # zero partitions would run NOTHING and merge an empty/zero
        # "answer" — a silently wrong result, not a degraded one
        raise InvalidArgument(
            f"n_partitions must be >= 1, got {n_partitions}")
    n_partitions = int(n_partitions)
    two_phase = spec["merge"] == "twophase"
    device = None if env is None else env.device
    eager_fn = getattr(tpch, query)
    limit = _resolve_limit(eager_fn, spec, params)
    part_params = dict(params)
    if spec["merge"] == "groupby" and spec.get("limit_kwarg"):
        # a re-aggregating merge must see EVERY group's partial — the
        # caller's top-k re-applies after the merge instead
        part_params[spec["limit_kwarg"]] = _NO_LIMIT

    # split the inputs: partitioned tables hash-split on the dominant
    # key (co-partitioned across tables — same hash, same key domain);
    # everything else ingests ONCE and broadcasts to every partition
    part_tables: dict = {}
    bcast: dict = {}
    bcast_fp: list = []
    for tname, keep in MANIFEST[query].items():
        if tname not in data:
            raise InvalidArgument(
                f"tpch_fallback({query}): input missing table "
                f"{tname!r}")
        cols = _host_cols(data[tname], tname, keep)
        key = spec["partition"].get(tname, "__broadcast__")
        if key == "__broadcast__":
            if resume_dir is not None:
                # a broadcast table feeds EVERY partition, so the
                # per-partition row-count meta cannot see it change —
                # its content digest guards the fingerprint instead
                # (a changed build side discards the checkpoint and
                # recomputes, never mixes generations)
                bcast_fp.append((tname, _cols_fingerprint(cols)))
            bcast.update(tpch.ingest({tname: cols}, device=device))
        elif key is None:
            part_tables[tname] = _partition_rows(cols, n_partitions)
        else:
            part_tables[tname] = host_partition_chunks(
                [cols], [key], n_partitions)
    if two_phase:
        return _two_phase(query, part_tables, bcast, n_partitions,
                          resume_dir,
                          (tuple(sorted((t, k) for t, k in
                                        spec["partition"].items())),
                           int(n_partitions),
                           tuple(sorted((k, repr(v))
                                        for k, v in params.items())),
                           tuple(sorted(bcast_fp))),
                          params, device)
    ckpt = None
    if resume_dir is not None:
        ckpt = resilience.CheckpointedRun(
            resume_dir, f"fallback_{query}",
            (tuple(sorted((t, k) for t, k in
                          spec["partition"].items())),
             int(n_partitions),
             tuple(sorted((k, repr(v)) for k, v in params.items())),
             tuple(sorted(bcast_fp)),
             # compiled vs eager partials can associate float sums
             # differently — a resume must never mix the two
             bool(compiled)))
    runner = tpch.compiled(query) if compiled else eager_fn
    telemetry.counter("ooc.fallback_partitions",
                      op=query).inc(n_partitions)
    done_map = ckpt.completed if ckpt is not None else {}

    def _ingest(p):
        """Pipelined ingest of partition p (prefetch worker): the
        per-table row-count meta + the partition's input mapping
        (broadcast tables shared, partitioned slices attached) —
        assembled while partition p-1's query runs."""
        meta = {t: (len(next(iter(part_tables[t][p].values())))
                    if part_tables[t][p] else 0) for t in part_tables}
        data_p = None
        if p not in done_map and any(meta.values()):
            data_p = dict(bcast)
            for t in part_tables:
                data_p[t] = part_tables[t][p]
        return meta, data_p

    partials: list = []
    # per-partition checkpoint commits ride the async writer (ONE FIFO
    # thread — the manifest is never written concurrently and units
    # land in partition order), overlapping the next partition's query
    with pipeline.committer(f"fallback.{query}") as com:
        for p, (meta, data_p) in pipeline.prefetch_map(
                range(n_partitions), _ingest, op="fallback"):
            done = done_map.get(p)
            if done is not None:
                # completed partition: re-verify the re-split source
                # still matches, then replay the durable partial — no
                # recompute
                ckpt.verify_meta(p, f"tpch_fallback[{query}]", **meta)
                partials.append(_resume_partial(ckpt, p))
                continue
            if all(v == 0 for v in meta.values()):
                if ckpt is not None:
                    com.submit(lambda p=p, meta=meta:
                               ckpt.complete(p, {}, 0, meta=meta))
                partials.append(None)
                continue
            with _span("fallback.partition", cat="stage", query=query,
                       partition=p, **{f"rows_{t}": n
                                       for t, n in meta.items()}):
                _memory.sample(op="fallback")
                with _span("ooc.compute", cat="stage", op="fallback",
                           unit=p):
                    partial = _materialize(runner(data_p, env=env,
                                                  **part_params))
                if ckpt is not None:
                    cols, rows = _encode_partial(partial)
                    unit_meta = _partial_schema_meta(partial, meta)
                    # checkpoint BEFORE the partial joins the merge
                    # set (com.drain() on scope exit is the barrier
                    # before _merge_partials): a kill from here on
                    # resumes it from the durable spill
                    com.submit(lambda p=p, cols=cols, rows=rows,
                               unit_meta=unit_meta: ckpt.complete(
                                   p, cols, rows, meta=unit_meta))
                partials.append(partial)
                del data_p
    return _merge_partials(partials, spec, limit)


def run_query(query: str, data: Mapping, *, env=None,
              n_partitions: "int | None" = None,
              resume_dir: "str | None" = None, compiled: bool = True,
              budget_bytes: "int | None" = None, **params):
    """THE spill-aware entry for a TPC-H query: pre-flight the
    manifest-projected input bytes against free device memory, run in-core when
    it fits, degrade through :func:`tpch_fallback` when it cannot (or
    when the in-core dispatch dies OOM). Returns the HOST result on
    either path. Every known query has a usable plan (the two-phase
    executor closed the last six); an unknown name fails fast with the
    known-query list."""
    from cylon_tpu_torch import tpch

    if not supports(query):
        raise InvalidArgument(
            f"unknown TPC-H query {query!r} — known queries: "
            f"{_known_queries()}")

    def attempt():
        qfn = tpch.compiled(query) if compiled else getattr(tpch, query)
        return _materialize(qfn(data, env=env, **params))

    def spill():
        return tpch_fallback(query, data, env=env,
                             n_partitions=n_partitions,
                             resume_dir=resume_dir, compiled=compiled,
                             **params)

    return run_with_fallback(
        attempt, spill, op=query,
        predicted_bytes=predict_query_bytes(data, query),
        budget_bytes=budget_bytes)


# ------------------------------------------------- plain relational ops
def _as_cols(src) -> "dict[str, np.ndarray]":
    if not isinstance(src, Mapping):
        raise InvalidArgument(
            "fallback ops take host column Mappings (streamed sources "
            "go straight to the ooc_* passes)")
    return {k: np.asarray(v) for k, v in src.items()}


def join(left: Mapping, right: Mapping, on, how: str = "inner", *,
         n_partitions: "int | None" = None, chunk_rows: int = 1 << 22,
         suffixes=("_x", "_y"), resume_dir: "str | None" = None,
         budget_bytes: "int | None" = None, algorithm: str = "sort",
         device=None):
    """Spill-aware equi-join over host column mappings: in-core device
    join when it fits, :func:`cylon_tpu_torch.outofcore.ooc_join`
    (hash-partitioned by ``on`` — the plain-op dominant key) when it
    cannot, both on ``device`` (``None``: CUDA). Returns a pandas frame
    (row order unspecified, like any distributed join)."""
    import pandas as pd

    lcols, rcols = _as_cols(left), _as_cols(right)
    keys = [on] if isinstance(on, str) else list(on)
    if n_partitions is None:
        n_partitions = default_partitions()
    pred = int((_nbytes(lcols) + _nbytes(rcols)) * expansion_factor())

    def attempt():
        from cylon_tpu_torch.ops.join import join as dev_join
        from cylon_tpu_torch.table import Table
        from cylon_tpu_torch.utils import pow2_bucket

        ln = len(next(iter(lcols.values()))) if lcols else 0
        rn = len(next(iter(rcols.values()))) if rcols else 0
        lt = Table.from_pydict(lcols, capacity=pow2_bucket(max(ln, 1)),
                               device=device)
        rt = Table.from_pydict(rcols, capacity=pow2_bucket(max(rn, 1)),
                               device=device)
        cap = pow2_bucket(2 * max(ln, rn, 1))
        for _ in range(12):
            res = dev_join(lt, rt,
                           on=keys if len(keys) > 1 else keys[0],
                           how=how, suffixes=suffixes,
                           out_capacity=cap, ordered=False,
                           algorithm=algorithm)
            # the port's overflow mark: nrows == cap + 1
            if int(res.nrows) <= cap:
                return res.to_pandas().reset_index(drop=True)
            del res
            cap *= 2
        # the deepest rung still overflowed: the output cannot fit any
        # in-core buffer — raised as a memory exhaustion so
        # run_with_fallback routes THIS workload to the spill path
        # (ooc_join's per-partition ladder relieves the fan-out)
        raise MemoryError(
            f"fallback.join: in-core output exceeds {cap // 2} rows "
            "at the deepest capacity rung — memory exhausted, "
            "spilling")

    def spill():
        from cylon_tpu_torch.outofcore import ooc_join

        frames: list = []
        ooc_join(lcols, rcols, on=on, how=how,
                 n_partitions=n_partitions, chunk_rows=chunk_rows,
                 sink=frames.append, suffixes=suffixes,
                 resume_dir=resume_dir, algorithm=algorithm,
                 device=device)
        return (pd.concat(frames, ignore_index=True) if frames
                else pd.DataFrame())

    return run_with_fallback(attempt, spill, op="join",
                             predicted_bytes=pred,
                             budget_bytes=budget_bytes)


def groupby(src: Mapping, by, aggs, *, chunk_rows: int = 1 << 22,
            resume_dir: "str | None" = None,
            budget_bytes: "int | None" = None, device=None):
    """Spill-aware decomposable groupby over a host column Mapping:
    in-core when it fits, chunked
    :func:`cylon_tpu_torch.outofcore.ooc_groupby` (partitioned by ``by``'s
    chunk decomposition) when it cannot. ``aggs``: (src, op[, out])
    with op in sum/count/min/max. Returns a pandas frame."""
    cols = _as_cols(src)
    keys = [by] if isinstance(by, str) else list(by)
    aggs = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[0]}_{a[1]}")
            for a in (tuple(x) for x in aggs)]
    pred = int(_nbytes(cols) * expansion_factor())

    def attempt():
        from cylon_tpu_torch.ops.groupby import groupby_aggregate
        from cylon_tpu_torch.table import Table
        from cylon_tpu_torch.utils import pow2_bucket

        n = len(next(iter(cols.values()))) if cols else 0
        t = Table.from_pydict(cols, capacity=pow2_bucket(max(n, 1)),
                              device=device)
        res = groupby_aggregate(t, keys, aggs)
        return res.to_pandas().reset_index(drop=True)

    def spill():
        from cylon_tpu_torch.outofcore import ooc_groupby

        res = ooc_groupby(cols, keys, aggs, chunk_rows=chunk_rows,
                          resume_dir=resume_dir, device=device)
        return res.to_pandas().reset_index(drop=True)

    return run_with_fallback(attempt, spill, op="groupby",
                             predicted_bytes=pred,
                             budget_bytes=budget_bytes)


def sort(src: Mapping, by, *, n_partitions: "int | None" = None,
         chunk_rows: int = 1 << 22, resume_dir: "str | None" = None,
         budget_bytes: "int | None" = None, device=None):
    """Spill-aware sort over a host column Mapping: in-core device sort
    when it fits, the range-partitioned
    :func:`cylon_tpu_torch.outofcore.ooc_sort` (splitters sampled from
    ``by`` — the plain-op dominant key) when it cannot. Returns the
    globally sorted pandas frame."""
    import pandas as pd

    cols = _as_cols(src)
    keys = [by] if isinstance(by, str) else list(by)
    if n_partitions is None:
        n_partitions = default_partitions()
    pred = int(_nbytes(cols) * expansion_factor())

    def attempt():
        from cylon_tpu_torch.ops.selection import sort_table
        from cylon_tpu_torch.table import Table
        from cylon_tpu_torch.utils import pow2_bucket

        n = len(next(iter(cols.values()))) if cols else 0
        t = Table.from_pydict(cols, capacity=pow2_bucket(max(n, 1)),
                              device=device)
        return sort_table(t, keys).to_pandas().reset_index(drop=True)

    def spill():
        from cylon_tpu_torch.outofcore import ooc_sort

        frames: list = []
        ooc_sort(cols, keys, n_partitions=n_partitions,
                 chunk_rows=chunk_rows, sink=frames.append,
                 resume_dir=resume_dir, device=device)
        return (pd.concat(frames, ignore_index=True) if frames
                else pd.DataFrame())

    return run_with_fallback(attempt, spill, op="sort",
                             predicted_bytes=pred,
                             budget_bytes=budget_bytes)
