"""Per-query EXPLAIN / ANALYZE: pre-execution plans and per-request
execution profiles.

Port of ``cylon_tpu/telemetry/profile.py``. The answer to "where did
*this* query's time and device memory go?", assembled from machinery
the port already has — span timers
(:data:`cylon_tpu_torch.utils.tracing.SPAN_METRIC`), watchdog section
histograms, ``_note_exchange`` byte pricing, the plan-cache counters,
spill/retry/fault counters and the :mod:`cylon_tpu_torch.telemetry.memory`
watermarks. No instrumentation runs inside device code.

**EXPLAIN** (:func:`explain`): the pre-execution view of a query — the
relational ops its code reaches, each input's true rows / power-of-2
bucket / buffer capacity / bytes, the capacity scale a
:class:`~cylon_tpu_torch.plan.CompiledQuery` would run at, and whether
that run would be a plan-cache hit. Nothing is executed. The port's
``CompiledQuery`` is eager and keeps no compiled programs: its
``plan.cache_*`` counters read the scale memo, so ``cache_state`` is
``"hit"`` exactly when the memo already holds the call's key (the next
call then counts ``plan.cache_hits``) and ``"miss"`` otherwise.
``row_hint`` is always None: the port's exchanges size from real
counts and keep no row hint. ``inputs[].distributed`` is the catalog's
shard record for a table registered as a rank's shard, False otherwise
(as ``catalog.stats()`` reports it).

**ANALYZE** (:class:`RequestProfiler` → ``QueryTicket.profile()``): the
serve scheduler runs request steps one at a time on ONE thread, so a
registry delta bracketed around a step is attributable to that request
— the profiler snapshots the relevant counter/timer series before each
step, accumulates the deltas, and samples the memory gauges at the step
boundary (``telemetry.memory.sample``: the caching allocator's counters
on the card, no device sync). Step walls are host walls of eager
launches: a step's device work may finish in a later step, where its
result is fetched, and no sync is added to move it back. A step that
runs a ``ThreadWorld`` of W ranks records each rank's spans and exchange
counters, so an operator's wall is the ranks' summed busy seconds (the
coverage can then exceed 1) and its ``calls`` count every rank's
exchanges. ``headroom_ratio`` is the largest ``exchange.headroom_ratio``
gauge any exchange has set (settled receive rows over true input rows,
from the host counts of the regrow ladder:
:func:`cylon_tpu_torch.parallel.dist_ops._headroom`), None before the
first distributed exchange. Field set pinned by
:data:`REQUIRED_PROFILE_FIELDS`.

Cost model: two registry scans plus one memory sample per step —
host-side dict walks, no device syncs. :data:`PROFILING` ``= False``
turns per-request profiling off (the JAX package reads
``CYLON_TPU_SERVE_PROFILE``; nothing in the port sets it).

**Query-profile history**: retired tickets' measured walls persist into
a bounded per-(query fingerprint, pow2 row bucket)
:class:`ProfileHistory` under the engine's durable tree, survive
restarts, merge across engines (:func:`merged_history`), and surface
through :func:`explain` as ``cost_estimate.predicted_wall_s``. The file
format is the JAX package's: a history written by either loads in the
other.
"""

import contextlib
import json
import os
import threading
import time

from cylon_tpu_torch.telemetry import registry as _r
from cylon_tpu_torch.telemetry.export import json_safe

__all__ = [
    "REQUIRED_PROFILE_FIELDS", "PROFILING", "profiling_enabled",
    "RequestProfiler", "ProfileHistory", "merged_history", "HISTORY_FILE",
    "explain", "explain_text", "profile_text",
]

#: every ``QueryTicket.profile()`` dict carries these keys (the JAX
#: package's set, kept exactly)
REQUIRED_PROFILE_FIELDS = (
    "rid", "tenant", "state", "slo_s", "queue_wait_s", "wall_s",
    "steps", "stages", "operators", "compile", "memory", "spill",
    "faults", "plan_cache", "headroom_ratio", "stage_walls_s",
    "stage_coverage", "degraded", "fallback", "join",
)

#: per-request ANALYZE profiles on (read per admission)
PROFILING = True


def profiling_enabled() -> bool:
    """Per-request ANALYZE profiles on? (:data:`PROFILING`; the cost is
    two registry walks per step.)"""
    return bool(PROFILING)


#: counter metrics the per-step delta tracks, keyed per label series.
#: The serve scheduler's one-step-at-a-time execution makes the delta
#: attributable; rare off-thread increments (an exporter, a client
#: submit) touch none of these names.
_COUNTERS = (
    "exchange.calls", "exchange.rows", "exchange.bytes_true",
    "exchange.bytes_padded", "exchange.tight_dispatches",
    "exchange.fallback_regrows", "plan.compile_count",
    "plan.cache_hits", "plan.cache_misses", "plan.overflow_events",
    "plan.capacity_rescales", "plan.prefetch_bytes",
    "spill.read_bytes", "spill.write_bytes", "resilience.retries",
    "resilience.faults_injected", "ooc.chunks", "ooc.rows_out",
    "ooc.fallbacks", "ooc.fallback_partitions", "ooc.units_resumed",
    "ooc.prefetch_hits", "ooc.prefetch_misses", "ooc.overlap_seconds",
    "join.algorithm", "join.overflow_fallbacks",
)

_SPAN_METRIC = "tracing.span_seconds"
_SECTION_METRIC = "watchdog.section_seconds"

#: span names excluded from profile attribution: the serve step span
#: wraps the entire step (it IS the wall, not a stage of it).
_SELF_SPANS = frozenset({"serve.step"})


def _grab():
    """One registry snapshot of the profile-relevant series:
    ``(counters, spans, sections)`` where counters map
    ``(name, op_label) -> value`` and spans/sections map
    ``name -> cumulative seconds``."""
    counters: dict = {}
    spans: dict = {}
    sections: dict = {}
    want = set(_COUNTERS)
    for name, labels, inst in _r.instruments():
        if name in want:
            lab = (labels.get("op") or labels.get("site")
                   or labels.get("kind") or labels.get("point")
                   or labels.get("code") or "")
            key = (name, lab)
            counters[key] = counters.get(key, 0) + inst.value
        elif name == _SPAN_METRIC:
            sname = labels.get("name", "?")
            if sname not in _SELF_SPANS:
                spans[sname] = spans.get(sname, 0.0) + inst.sum
        elif name == _SECTION_METRIC:
            sec = labels.get("section", "?")
            sections[sec] = sections.get(sec, 0.0) + inst.sum
    return counters, spans, sections


def _diff(cur: dict, prev: dict, into: dict) -> None:
    for k, v in cur.items():
        d = v - prev.get(k, 0)
        if d:
            into[k] = into.get(k, 0) + d


class RequestProfiler:
    """Accumulates one request's ANALYZE profile across its steps (port
    of ``cylon_tpu/telemetry/profile.py:136``).

    Created at admission (``ServeEngine.submit``) and advanced by the
    scheduler via :meth:`step` around each step; rendered on demand by
    ``QueryTicket.profile()``. Only the scheduler thread writes it (the
    one-step-at-a-time execution model is what makes the deltas
    attributable); any thread may render it, under its lock."""

    def __init__(self):
        self._mu = threading.Lock()
        self.steps = 0
        self.counters: dict = {}
        self.spans: dict = {}
        self.sections: dict = {}
        self.step_wall_s = 0.0
        self.mem_start: "int | None" = None
        self.mem_peak: "int | None" = None
        self.mem_end: "int | None" = None
        #: the resident-consumer dump of the step that ran out of memory
        #: (set when a step raises something memory.is_oom recognises)
        #: — rides the profile so a degraded request explains itself
        self.oom_report: "dict | None" = None

    @contextlib.contextmanager
    def step(self):
        """Bracket one scheduler step: registry delta + boundary memory
        sample (the allocator's counters, no device sync)."""
        from cylon_tpu_torch.telemetry import memory

        sampling = memory.enabled()
        c0, s0, w0 = _grab()
        if sampling and self.mem_start is None:
            self.mem_start = memory.sample(op="serve_request", force=True)
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            if memory.is_oom(e):
                # the forensics scope (innermost) attached the report;
                # keep it so the degraded rerun's profile explains WHY
                rep = getattr(e, "oom_report", None)
                with self._mu:
                    self.oom_report = rep if rep is not None \
                        else memory.oom_report()
            raise
        finally:
            dt = time.perf_counter() - t0
            c1, s1, w1 = _grab()
            # memory.sample()'s disabled path returns a 0 sentinel —
            # recording it would fake a zero-residency measurement
            m = (memory.sample(op="serve_request", force=True)
                 if sampling else None)
            with self._mu:
                self.step_wall_s += dt
                self.steps += 1
                _diff(c1, c0, self.counters)
                _diff(s1, s0, self.spans)
                _diff(w1, w0, self.sections)
                if m is not None:
                    self.mem_end = m
                    if self.mem_peak is None or m > self.mem_peak:
                        self.mem_peak = m

    # ------------------------------------------------------- rendering
    @staticmethod
    def _counter(counters: dict, name: str):
        return sum(v for (n, _), v in counters.items() if n == name)

    def render(self, ticket) -> dict:
        """The ANALYZE profile dict (:data:`REQUIRED_PROFILE_FIELDS`).

        ``stages`` is the per-stage wall map: sub-stage spans (names
        with a dot — ``dist_join.dispatch``, ``plan.fetch``, ...) plus
        watchdog sections. ``operators`` merges each top-level op span's
        wall with its exchange pricing deltas. ``stage_walls_s`` sums
        non-nested units only: op seconds that fit inside the
        ``plan.dispatch`` span are taken as nested in it (the eager
        query's ops run inside that span), so the coverage can only
        undercount, never exceed the wall by double counting."""
        now = time.monotonic()
        started = ticket.started if ticket.started is not None else now
        finished = ticket.finished if ticket.finished is not None \
            else now
        wall = max(finished - started, 0.0)
        with self._mu:  # consistent copy vs a concurrent step()
            steps = self.steps
            counters = dict(self.counters)
            spans = dict(self.spans)
            sections = dict(self.sections)
            mem_start, mem_peak, mem_end = (self.mem_start,
                                            self.mem_peak, self.mem_end)
            oom_rep = self.oom_report
        stages = {n: s for n, s in spans.items() if "." in n}
        stages.update({f"section:{n}": s for n, s in sections.items()
                       if n != "serve_request"})
        operators: dict = {}
        for n, s in spans.items():
            if "." not in n:
                operators[n] = {"wall_s": s}
        for (name, op), v in counters.items():
            if not name.startswith("exchange.") or not op:
                continue
            d = operators.setdefault(op, {})
            field = name.split(".", 1)[1]
            d[field] = d.get(field, 0) + v
        # which join kernel ran for THIS request's steps
        # ("requested->chosen" routing decisions) — on the join operator
        # rows and as the top-level "join" block
        join_algos = {lab: v for (n, lab), v in counters.items()
                      if n == "join.algorithm" and lab}
        if join_algos:
            for op, d in operators.items():
                if "join" in op:
                    d["algorithms"] = join_algos
        top_walls = sum(d.get("wall_s", 0.0) for d in operators.values())
        dispatch_s = spans.get("plan.dispatch", 0.0)
        plan_walls = dispatch_s + spans.get("plan.fetch", 0.0)
        stage_walls = plan_walls + max(0.0, top_walls - dispatch_s)
        # worst (max) last-observed headroom across the per-op gauge
        # series — a process-wide gauge, as bench_metrics reports it
        headroom = None
        for _, _, inst in _r.instruments("exchange.headroom_ratio"):
            v = json_safe(inst.value)
            if isinstance(v, (int, float)):
                headroom = v if headroom is None else max(headroom, v)
        misses = self._counter(counters, "plan.cache_misses")
        degraded = bool(getattr(ticket, "degraded", False))
        prof = {
            "rid": ticket.rid,
            "tenant": ticket.tenant,
            "state": ticket.state,
            "slo_s": ticket.slo,
            "queue_wait_s": max(started - ticket.submitted, 0.0),
            "wall_s": wall,
            "steps": steps,
            "stages": stages,
            "operators": operators,
            "compile": {
                # the eager port's "compile" is the scale-memo miss;
                # dispatch is the eager query, fetch its overflow check
                "compile_count": self._counter(counters,
                                               "plan.compile_count"),
                "cache_hits": self._counter(counters, "plan.cache_hits"),
                "cache_misses": misses,
                "dispatch_s": dispatch_s,
                "execute_s": spans.get("plan.fetch", 0.0),
            },
            "memory": {
                "live_bytes_start": mem_start,
                "live_bytes_peak": mem_peak,
                "live_bytes_end": mem_end,
            },
            "spill": {
                "read_bytes": self._counter(counters, "spill.read_bytes"),
                "write_bytes": self._counter(counters,
                                             "spill.write_bytes"),
            },
            "faults": {
                "retries": self._counter(counters, "resilience.retries"),
                "injected": self._counter(counters,
                                          "resilience.faults_injected"),
                "overflow_events": self._counter(counters,
                                                 "plan.overflow_events"),
                "capacity_rescales": self._counter(
                    counters, "plan.capacity_rescales"),
            },
            "plan_cache": {
                "hits": self._counter(counters, "plan.cache_hits"),
                "misses": misses,
            },
            "headroom_ratio": headroom,
            "stage_walls_s": stage_walls,
            "stage_coverage": (stage_walls / wall if wall > 0 else None),
            # did this request complete through the OOM -> spill
            # fallback, over how many partitions, and what crowded it
            # out of device memory
            "degraded": degraded,
            "fallback": {
                # the engine's degrade fires OUTSIDE the step bracket, so
                # the per-step counter delta can read 0 for a degraded
                # request — the ticket flag is the floor
                "fallbacks": max(self._counter(counters, "ooc.fallbacks"),
                                 1 if degraded else 0),
                "partitions": self._counter(counters,
                                            "ooc.fallback_partitions"),
                "units_resumed": self._counter(counters,
                                               "ooc.units_resumed"),
                "oom_report": oom_rep,
            },
            "join": {
                "algorithms": join_algos,
                "overflow_fallbacks": self._counter(
                    counters, "join.overflow_fallbacks"),
            },
        }
        return json_safe(prof)


# ---------------------------------------------------------- history
#: bound on measured samples kept per (fingerprint, bucket) key — a
#: ring: new walls evict the oldest, so the estimate tracks the current
#: regime
DEFAULT_HISTORY_SAMPLES = 64
#: bound on distinct (fingerprint, bucket) keys — least-recently
#: recorded keys evict first
DEFAULT_HISTORY_KEYS = 512
#: file name under the engine's durable dir
HISTORY_FILE = "profile_history.json"
#: persist every N records (plus at engine close) — the history is a
#: cost-model cache, not a durability journal
_HISTORY_FLUSH_EVERY = 32


class ProfileHistory:
    """Bounded, persistent record of measured query walls keyed by
    ``(query fingerprint, pow2 row bucket)`` (port of
    ``cylon_tpu/telemetry/profile.py:376``).

    The engine records one sample per *executed* retirement (cache hits
    and coalesce followers ride a leader's wall); :meth:`predict`
    answers with the median executed wall and the sample count, which
    :func:`explain` surfaces as ``cost_estimate``. Persistence is an
    atomic whole-file JSON swap (:data:`HISTORY_FILE`). Thread-safe."""

    def __init__(self, path: "str | None" = None, *,
                 max_keys: int = DEFAULT_HISTORY_KEYS,
                 samples_per_key: int = DEFAULT_HISTORY_SAMPLES):
        self._mu = threading.Lock()
        self.path = path
        self._max_keys = max(int(max_keys), 1)
        self._n = max(int(samples_per_key), 1)
        # "fp::bucket" -> list of sample dicts; dict insertion order
        # doubles as the LRU order (record() moves a key to the end)
        self._data: "dict[str, list]" = {}
        self._unsaved = 0
        if path is not None:
            self._load()

    @staticmethod
    def _key(fingerprint, bucket) -> str:
        return f"{fingerprint}::{'' if bucket is None else bucket}"

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return  # absent / torn file: start empty, never raise
        keys = doc.get("keys") if isinstance(doc, dict) else None
        if not isinstance(keys, dict):
            return
        with self._mu:
            for k, ring in keys.items():
                if not isinstance(ring, list):
                    continue
                samples = [s for s in ring if isinstance(s, dict)
                           and isinstance(s.get("wall_s"), (int, float))]
                if samples:
                    self._data[str(k)] = samples[-self._n:]

    def record(self, fingerprint, bucket, wall_s: float, *,
               path: str = "executed", degraded: bool = False) -> None:
        """Append one measured wall for ``(fingerprint, bucket)``. No-op
        when the query is unfingerprinted."""
        if fingerprint is None:
            return
        samp = {"wall_s": float(wall_s), "path": str(path),
                "degraded": bool(degraded), "wall": time.time()}
        k = self._key(fingerprint, bucket)
        with self._mu:
            ring = self._data.pop(k, None)
            if ring is None:
                ring = []
                while len(self._data) >= self._max_keys:
                    self._data.pop(next(iter(self._data)))
            self._data[k] = ring  # (re-)insert at LRU tail
            ring.append(samp)
            del ring[:-self._n]
            self._unsaved += 1
            flush = (self.path is not None
                     and self._unsaved >= _HISTORY_FLUSH_EVERY)
            if flush:
                self._unsaved = 0
        if flush:
            self.save()

    def save(self) -> None:
        """Atomic whole-file persist (tmp + rename); an IO failure is
        swallowed — the in-memory estimator never pays for a full
        disk."""
        if self.path is None:
            return
        with self._mu:
            doc = {"version": 1,
                   "keys": {k: list(v) for k, v in self._data.items()}}
            self._unsaved = 0
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(json_safe(doc), fh, allow_nan=False,
                          separators=(",", ":"))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError:
            with contextlib.suppress(OSError):
                os.unlink(tmp)

    def merge(self, other: "ProfileHistory") -> None:
        """Fold another history's samples into this one. Samples
        interleave by record time and stay bounded per key."""
        with other._mu:
            theirs = {k: list(v) for k, v in other._data.items()}
        with self._mu:
            for k, ring in theirs.items():
                mine = self._data.setdefault(k, [])
                mine.extend(ring)
                mine.sort(key=lambda s: s.get("wall", 0.0))
                del mine[:-self._n]
            while len(self._data) > self._max_keys:
                self._data.pop(next(iter(self._data)))

    def predict(self, fingerprint, bucket=None) -> "dict | None":
        """Measured cost estimate for ``(fingerprint, bucket)``:
        ``{"predicted_wall_s": median executed wall, "mean_wall_s",
        "samples", "bucket": key used}``. Pools every bucket of the
        fingerprint when the exact bucket has no samples; None when the
        history has never seen the query."""
        pooled = bucket
        with self._mu:
            samples = list(self._data.get(self._key(fingerprint, bucket),
                                          ()))
            if not samples:
                pfx = f"{fingerprint}::"
                for k, ring in self._data.items():
                    if k.startswith(pfx):
                        samples.extend(ring)
                pooled = None
        walls = sorted(s["wall_s"] for s in samples
                       if s.get("path") == "executed"
                       and not s.get("degraded"))
        if not walls:  # only degraded/short-circuit samples: use all
            walls = sorted(s["wall_s"] for s in samples)
        if not walls:
            return None
        mid = len(walls) // 2
        med = (walls[mid] if len(walls) % 2
               else (walls[mid - 1] + walls[mid]) / 2.0)
        return {"predicted_wall_s": med,
                "mean_wall_s": sum(walls) / len(walls),
                "samples": len(walls), "bucket": pooled}

    def keys(self) -> list:
        with self._mu:
            return list(self._data)

    def __len__(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._data.values())


def merged_history(paths) -> ProfileHistory:
    """One estimator from every engine's persisted :data:`HISTORY_FILE`
    (absent/torn files contribute nothing) (port of
    ``cylon_tpu/telemetry/profile.py:542``)."""
    fleet = ProfileHistory()
    for p in paths:
        fleet.merge(ProfileHistory(path=str(p)))
    return fleet


# ----------------------------------------------------------- EXPLAIN
#: relational-op vocabulary the static scan recognises in a query
#: function's code objects — the pre-execution "ops" line of EXPLAIN
_OP_NAMES = frozenset({
    "join", "dist_join", "colocated_join", "groupby",
    "groupby_aggregate", "dist_groupby", "colocated_groupby",
    "dist_sort", "sort_table", "sort_values", "shuffle",
    "repartition", "dist_unique", "unique", "dist_union", "union",
    "dist_intersect", "intersect", "dist_subtract", "subtract",
    "dist_aggregate", "dist_filter", "dist_head", "dist_concat",
    "merge", "head", "select", "filter",
})


def _query_ops(fn) -> list:
    """Relational ops reachable from ``fn``'s code (static scan of
    ``co_names`` through nested code objects) — an approximation of the
    logical plan, labelled ``static_scan``."""
    import types

    target = getattr(fn, "_fn", fn)  # unwrap CompiledQuery
    code = getattr(target, "__code__", None)
    if code is None:
        return []
    seen, todo, ops = set(), [code], []
    while todo:
        c = todo.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        # co_names: global/attr loads; co_freevars: ops captured from
        # an enclosing scope (queries defined inside functions)
        for name in (*c.co_names, *c.co_freevars):
            if name in _OP_NAMES and name not in ops:
                ops.append(name)
        for const in c.co_consts:
            if isinstance(const, types.CodeType):
                todo.append(const)
    return ops


def _input_tables(args, kwargs) -> list:
    from cylon_tpu_torch.plan import _result_tables

    return [t for t, _env in _result_tables((list(args), dict(kwargs)))]


def explain(fn, *args, _history=None, _fingerprint=None, **kwargs) -> dict:
    """Pre-execution plan for ``fn(*args, **kwargs)`` — nothing runs
    (port of ``cylon_tpu/telemetry/profile.py:599``).

    Returns::

        {"query": name, "compiled": bool, "ops": [...],
         "ops_source": "static_scan",
         "inputs": [{"rows", "bucket", "capacity", "bytes",
                     "columns", "distributed"}, ...],
         "row_hint": None, "scale": int,
         "cache_state": "hit" | "miss" | "untracked",
         "plan_cache": plan_cache_stats(),
         "cost_estimate": ProfileHistory.predict() | None,
         "join_routing": hash_join.describe_routing() | None}

    For a :class:`~cylon_tpu_torch.plan.CompiledQuery` the scale and
    cache state are what the next call would run with (the scale memo's
    entry for the call's static arguments and input shapes); a bare
    callable is ``"untracked"`` at scale 1. The inputs' row counts are
    one host fetch for all of them
    (:func:`~cylon_tpu_torch.parallel.dist_ops.batched_true_rows`).

    ``_history`` (a :class:`ProfileHistory`) turns the plan into a
    measured cost estimate; ``_fingerprint`` overrides the fingerprint
    derivation for registered queries dispatched by name."""
    from cylon_tpu_torch import catalog, plan
    from cylon_tpu_torch.ops import hash_join
    from cylon_tpu_torch.parallel.dist_ops import batched_true_rows
    from cylon_tpu_torch.utils import pow2_bucket

    cq = fn if isinstance(fn, plan.CompiledQuery) else None
    tables = _input_tables(args, kwargs)
    rows = batched_true_rows(tables) if tables else None
    inputs = []
    for i, t in enumerate(tables):
        r = None if rows is None else rows[i]
        inputs.append({
            "rows": r,
            "bucket": None if r is None else pow2_bucket(r),
            "capacity": int(t.capacity),
            "bytes": catalog.table_nbytes(t),
            "columns": t.num_columns,
            "distributed": catalog.holds_shard(t),
        })
    # the history key's bucket: the largest input's true rows, the same
    # derivation the engine's retirement records under
    row_bucket = None if rows is None else pow2_bucket(max(rows))
    scale, cache_state = 1, "untracked"
    if cq is not None:
        key = plan._describe(args, kwargs)[0]
        with cq._mu:
            cache_state = "hit" if key in cq._scale_memo else "miss"
            scale = cq._scale_memo.get(key, 1)
    name = getattr(getattr(fn, "_fn", fn), "__name__", type(fn).__name__)
    ops = _query_ops(fn)
    estimate = None
    if _history is not None:
        fp = _fingerprint
        if fp is None:
            with contextlib.suppress(Exception):
                fp = plan.query_fingerprint(name, args, kwargs)
        if fp is not None:
            estimate = _history.predict(fp, row_bucket)
    return json_safe({
        "query": name,
        "compiled": cq is not None,
        "ops": ops,
        "ops_source": "static_scan",
        "inputs": inputs,
        "row_hint": None,
        "scale": scale,
        "cache_state": cache_state,
        "plan_cache": plan.plan_cache_stats(),
        "cost_estimate": estimate,
        # which implementation an algorithm="hash" join in this plan
        # takes right now (the port's routes "hash" to "sort" unless
        # CYLON_TPU_JOIN_HASH_IMPL says "bucketed")
        "join_routing": (hash_join.describe_routing()
                         if any("join" in o for o in ops) else None),
    })


def explain_text(plan_dict: dict) -> str:
    """Human rendering of an :func:`explain` dict."""
    p = plan_dict
    lines = [f"EXPLAIN {p['query']} "
             f"({'compiled' if p['compiled'] else 'eager'}, "
             f"plan cache: {p['cache_state']})"]
    if p.get("ops"):
        lines.append("  ops: " + " -> ".join(p["ops"]))
    for i, t in enumerate(p.get("inputs", [])):
        lines.append(
            f"  input[{i}]: rows={t['rows']} bucket={t['bucket']} "
            f"capacity={t['capacity']} bytes={t['bytes']} "
            f"{'distributed' if t['distributed'] else 'local'}")
    lines.append(f"  row_hint={p['row_hint']} scale={p['scale']}")
    jr = p.get("join_routing")
    if jr:
        lines.append(
            f"  join: hash->{jr['hash_impl']} "
            f"(width {jr['bucket_width']}, overflow->"
            f"{jr['overflow_fallback']}"
            + (f", env={jr['algorithm_env']}" if jr.get("algorithm_env")
               else "") + ")")
    pc = p.get("plan_cache", {})
    lines.append(f"  plan cache: {pc.get('hits', 0)} hits / "
                 f"{pc.get('misses', 0)} misses "
                 f"(rate {pc.get('hit_rate', 0):.2f})")
    est = p.get("cost_estimate")
    if est:
        lines.append(
            f"  cost: predicted_wall_s={est['predicted_wall_s']:.4f} "
            f"(measured, {est['samples']} sample(s), "
            f"bucket={est.get('bucket')})")
    return "\n".join(lines)


def profile_text(prof: dict) -> str:
    """Human rendering of a ``QueryTicket.profile()`` dict — the ANALYZE
    half."""
    lines = [f"ANALYZE request {prof['rid']} "
             f"(tenant {prof['tenant']}, {prof['state']}): "
             f"wall {prof['wall_s'] * 1e3:.1f} ms, "
             f"queue {prof['queue_wait_s'] * 1e3:.1f} ms, "
             f"{prof['steps']} step(s), coverage "
             f"{(prof['stage_coverage'] or 0) * 100:.0f}%"]
    if prof.get("degraded"):
        fb = prof.get("fallback") or {}
        lines.append(
            f"  DEGRADED: completed via the OOM→spill fallback "
            f"({fb.get('partitions', 0)} partition(s), "
            f"{fb.get('units_resumed', 0)} resumed)")
    for op, d in sorted(prof.get("operators", {}).items(),
                        key=lambda kv: -kv[1].get("wall_s", 0.0)):
        lines.append(
            f"  op {op}: {d.get('wall_s', 0.0) * 1e3:.1f} ms, "
            f"rows={d.get('rows', 0)} "
            f"bytes_true={d.get('bytes_true', 0)} "
            f"bytes_padded={d.get('bytes_padded', 0)}")
    for n, s in sorted(prof.get("stages", {}).items(),
                       key=lambda kv: -kv[1]):
        lines.append(f"    stage {n}: {s * 1e3:.1f} ms")
    c = prof.get("compile", {})
    lines.append(f"  compile: {c.get('compile_count', 0)} "
                 f"program(s), dispatch {c.get('dispatch_s', 0.0) * 1e3:.1f}"
                 f" ms, execute {c.get('execute_s', 0.0) * 1e3:.1f} ms "
                 f"({c.get('cache_hits', 0)} hits/"
                 f"{c.get('cache_misses', 0)} misses)")
    m = prof.get("memory", {})
    lines.append(f"  memory: start={m.get('live_bytes_start')} "
                 f"peak={m.get('live_bytes_peak')} "
                 f"end={m.get('live_bytes_end')}")
    s = prof.get("spill", {})
    f = prof.get("faults", {})
    lines.append(f"  spill {s.get('read_bytes', 0)}r/"
                 f"{s.get('write_bytes', 0)}w bytes; retries "
                 f"{f.get('retries', 0)}, faults "
                 f"{f.get('injected', 0)}")
    return "\n".join(lines)
