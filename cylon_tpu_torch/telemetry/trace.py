"""Flight recorder: per-rank trace timelines for distributed ops.

The reference's only event-level visibility is glog lines of per-rank
``j_t``/``w_t`` wall times in the bench binaries
(``cpp/src/examples/bench/table_join_dist_test.cpp:38-56``) — you can
see *that* a rank was slow, never *why* or *where in the op*. The
metrics registry (:mod:`cylon_tpu_torch.telemetry.registry`) deliberately
drops event structure: spans collapse into histogram buckets with no
timestamps, no nesting, no rank correlation. This module records the
missing half — **traces, not metrics**: a bounded, thread-safe buffer
of structured events (span begin/end with ids and parent nesting,
instants for exchange dispatches / probes / overflows / retries /
fault firings / watchdog expiries, counter samples for byte tracks,
and complete slices for watchdog sections), exportable as Chrome
Trace Event JSON (:func:`cylon_tpu_torch.telemetry.export.to_chrome_trace`)
and mergeable across ranks with clock-offset alignment
(:func:`merge_timelines`; offsets from
:meth:`cylon_tpu_torch.context.CylonEnv.clock_offset`).

Fast-path contract (the same no-overhead-when-off promise as the
metric exporters and the watchdog): the recorder is armed ONLY when
``CYLON_TPU_TRACE`` is set — otherwise every emit function returns
after one env read, :data:`_RECORDER` stays ``None``, and no
allocations, threads or file handles exist (pinned by
``tests/test_trace_timeline.py``).

Event dicts (plain JSON-safe values, so cross-rank gather is one
``json.dumps`` away):

- ``{"kind": "begin"/"end", "name", "ts", "tid", "id", "parent",
  "cat", "args"}`` — a span edge; ``parent`` nests via a
  contextvar stack (worker threads spawned with ``copy_context``
  inherit their parent span).
- ``{"kind": "instant", ...}`` — a point event (exchange dispatch
  with true/padded bytes, probe, overflow, retry, fault, expiry).
- ``{"kind": "counter", "name", "ts", "tid", "value", "args"}`` — one
  sample of a cumulative counter track (exchange bytes).
- ``{"kind": "complete", "name", "ts", "dur", ...}`` — a slice whose
  start was only known in monotonic time (watchdog sections report
  elapsed at finish; ``ts = now() - dur``).

The port is SPMD: a ``ThreadWorld`` runs W ranks as threads of one
process, which share this one recorder. Each dist op runs under
:func:`rank_scope`, so every event emitted inside it carries a
top-level ``"rank"``; :func:`rank_buffers` then splits the process's
buffer into one buffer a rank, and :func:`critical_path` /
:func:`stage_coverage` see W timelines, as they would from W
processes.

Timestamps are seconds on a wall-aligned monotonic clock:
``perf_counter`` plus a process-constant offset captured when the
recorder arms, so durations keep ``perf_counter`` resolution while
cross-process merges can subtract wall-clock offsets. ``torch.profiler``
maps its time stamps to the Unix clock; :func:`unix_skew` says how far
that clock has moved from the recorder's since it armed (NTP slews and
steps), and ``to_chrome_trace(..., origin=)`` takes it off, so that a
recorder export overlays a profiler trace of the same window.

Fleet tracing: a request that crosses PROCESSES — router →
gateway → engine scheduler → (maybe) a failover replay on a second
engine — carries an ambient **trace context** (:func:`trace_context`:
a ``trace_id`` minted at the outermost entry plus the parent span id
on the other side of the hop). Armed emitters stamp ``trace_id`` onto
every event inside the scope, so one id names the whole causal chain
however many processes it hops. Each recorder additionally stamps a
monotone ``seq`` per event and exports bounded cursored segments via
:func:`since` (the ``/trace?since=`` introspect payload — same
cursor/gap discipline as the event journal), and
:func:`merge_timelines` accepts process tracks (buffers carrying a
``proc`` name and a handshake-estimated ``clock_offset``) so
:func:`fleet_request_report` can attribute one request's wall across
router-queue / engine-queue / dispatch / replay-hop phases.
"""

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
import uuid

from cylon_tpu_torch.telemetry.registry import current_tenant as _current_tenant

__all__ = [
    "enabled", "begin", "end", "span", "instant", "counter", "complete",
    "events", "clear", "dropped", "since", "merge_timelines",
    "rank_buffers", "critical_path", "stage_coverage", "filter_tenant",
    "new_trace_id", "trace_context", "current_trace_id",
    "current_parent_span", "request_timeline", "fleet_request_report",
    "DEFAULT_CAPACITY", "rank_scope",
]

#: default ring-buffer bound (events); ``CYLON_TPU_TRACE_EVENTS``
#: overrides. At ~120 bytes/event the default is a few MiB — bounded by
#: construction, the recorder can stay armed for a whole job.
DEFAULT_CAPACITY = 65536


def enabled() -> bool:
    """Is the recorder armed? One env read — the entire fast-path cost
    when tracing is off (``CYLON_TPU_TRACE`` unset/0/off)."""
    return os.environ.get("CYLON_TPU_TRACE", "") not in ("", "0", "off")


class TraceRecorder:
    """Bounded, thread-safe event buffer (oldest events drop first)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._appended = 0
        self._warned = False  # first-drop warning fired?
        # wall-aligned monotonic clock: perf_counter resolution for
        # durations, wall epoch so cross-process offsets subtract
        self._epoch = time.time() - time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() + self._epoch

    def next_id(self) -> int:
        return next(self._ids)

    def append(self, evt: dict) -> None:
        warn = False
        with self._lock:
            if (not self._warned
                    and len(self._buf) == self._buf.maxlen):
                # this append evicts the oldest event: the recording
                # is silently lossy from here on — say so ONCE
                self._warned = warn = True
            self._appended += 1
            # the monotone per-event cursor /trace?since= resumes from
            # (survives ring eviction, so a consumer that fell behind
            # sees the GAP instead of silently missing spans)
            evt["seq"] = self._appended
            self._buf.append(evt)
        if warn:
            from cylon_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "trace ring buffer full (%d events): oldest events "
                "now dropping — raise CYLON_TPU_TRACE_EVENTS or "
                "export/clear more often (trace.dropped() counts the "
                "loss)", self._buf.maxlen)

    def events(self) -> list:
        with self._lock:
            return list(self._buf)

    def since(self, cursor: int = 0) -> dict:
        """Events with ``seq > cursor`` plus the cursor to resume from
        and how many matching events the ring already evicted — the
        same cursor/gap discipline as
        :meth:`telemetry.events.EventJournal.since`, so the
        ``/trace?since=`` consumer (the fleet router's poll loop) can
        fall behind without silently losing spans."""
        cursor = int(cursor)
        with self._lock:
            evts = [e for e in self._buf if e.get("seq", 0) > cursor]
            seq = self._appended
        oldest_held = evts[0]["seq"] if evts else seq + 1
        # everything in (cursor, oldest_held) was evicted before read
        dropped = max(oldest_held - cursor - 1, 0)
        return {"events": evts, "cursor": seq, "dropped": dropped,
                "armed": True}

    def dropped(self) -> int:
        """Events evicted by the ring bound (total appended - held)."""
        with self._lock:
            return self._appended - len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._appended = 0
            self._warned = False


_LOCK = threading.Lock()
_RECORDER: "TraceRecorder | None" = None

#: innermost live span id for this context (tuple stack — immutable, so
#: bounded-call worker threads inherit a consistent view via
#: ``contextvars.copy_context``)
_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_trace_stack", default=())

#: ambient distributed-trace context: ``(trace_id, parent_span)`` — the
#: id minted at the fleet request's outermost entry plus the span id on
#: the other side of the process hop. None outside any scope; entered
#: only on armed paths, so the unarmed world never touches it.
_TRACE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_trace_ctx", default=None)


#: the rank of the SPMD program running in this context (None outside
#: any :func:`rank_scope`); set only on armed paths
_RANK: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_trace_rank", default=None)


@contextlib.contextmanager
def rank_scope(rank: int):
    """Stamp every event emitted inside with ``"rank": rank``: the
    ranks of a ``ThreadWorld`` share one recorder, and the stamp is
    what splits their timelines (:func:`rank_buffers`). A no-op when
    the recorder is off."""
    if not enabled():
        yield
        return
    tok = _RANK.set(int(rank))
    try:
        yield
    finally:
        _RANK.reset(tok)


def new_trace_id() -> str:
    """Mint one fleet-unique trace id (64 random bits, hex — short
    enough for a header, long enough that ids never collide across a
    bench run's worth of requests)."""
    return uuid.uuid4().hex[:16]


def current_trace_id() -> "str | None":
    """The ambient trace id (None outside any :func:`trace_context`)."""
    c = _TRACE_CTX.get()
    return c[0] if c is not None else None


def current_parent_span():
    """The cross-process parent span id carried by the ambient
    context (None outside any scope or when the hop carried none)."""
    c = _TRACE_CTX.get()
    return c[1] if c is not None else None


@contextlib.contextmanager
def trace_context(trace_id: "str | None", parent_span=None):
    """Ambient distributed-trace scope: every armed event emitted
    inside is stamped with ``trace_id`` (and begin/instant events with
    no LOCAL parent span link to ``parent_span`` — the span id on the
    other side of the process hop — via ``parent_span``). A None
    ``trace_id`` makes the whole scope a no-op, so call sites can pass
    an unstamped request straight through."""
    if trace_id is None:
        yield
        return
    tok = _TRACE_CTX.set((str(trace_id), parent_span))
    try:
        yield
    finally:
        _TRACE_CTX.reset(tok)


def _rec() -> TraceRecorder:
    global _RECORDER
    r = _RECORDER
    if r is None:
        with _LOCK:
            if _RECORDER is None:
                try:
                    cap = int(os.environ.get("CYLON_TPU_TRACE_EVENTS",
                                             str(DEFAULT_CAPACITY)))
                except ValueError:
                    cap = DEFAULT_CAPACITY
                _RECORDER = TraceRecorder(max(cap, 16))
            r = _RECORDER
    return r


def now() -> "float | None":
    """Recorder timestamp (None when tracing is off)."""
    return _rec().now() if enabled() else None


def _stamp_tenant(evt: dict) -> None:
    """Attach the ambient tenant attribution
    (:func:`cylon_tpu_torch.telemetry.tenant_scope`) as a top-level
    ``"tenant"`` key and the ambient distributed-trace context
    (:func:`trace_context`) as ``"trace_id"`` — only when a scope is
    active, so events outside the serving layer keep their historical
    shape. Reached only on the armed path (emitters return before it
    when tracing is off), so the off-path cost stays one env read."""
    t = _current_tenant()
    if t is not None:
        evt["tenant"] = t
    r = _RANK.get()
    if r is not None:
        evt["rank"] = r
    c = _TRACE_CTX.get()
    if c is not None:
        evt["trace_id"] = c[0]
        if (c[1] is not None and evt.get("parent") is None
                and evt.get("kind") in ("begin", "instant")):
            # first span/instant after a process hop: link back to the
            # span on the sending side (ids are per-process counters,
            # so the link is advisory — the trace_id is the chain)
            evt["parent_span"] = c[1]


# ------------------------------------------------------------- emitters
def begin(name: str, cat: "str | None" = None, **args):
    """Open a span; returns an opaque token for :func:`end` (None when
    tracing is off — :func:`end` accepts it as a no-op)."""
    if not enabled():
        return None
    r = _rec()
    eid = r.next_id()
    stack = _STACK.get()
    tok = _STACK.set(stack + (eid,))
    evt = {"kind": "begin", "name": name, "ts": r.now(),
           "tid": threading.get_ident(), "id": eid,
           "parent": stack[-1] if stack else None,
           "cat": cat, "args": args or {}}
    _stamp_tenant(evt)
    r.append(evt)
    return (eid, name, tok)


def end(token) -> None:
    if token is None:
        return
    eid, name, tok = token
    try:
        _STACK.reset(tok)
    except ValueError:
        pass  # span closed on a different context (worker thread exit)
    if not enabled():
        return
    r = _rec()
    evt = {"kind": "end", "name": name, "ts": r.now(),
           "tid": threading.get_ident(), "id": eid}
    rank = _RANK.get()
    if rank is not None:
        evt["rank"] = rank
    r.append(evt)


@contextlib.contextmanager
def span(name: str, cat: "str | None" = None, **args):
    """Record a span around the enclosed region (no-op when off)."""
    tok = begin(name, cat=cat, **args)
    try:
        yield
    finally:
        end(tok)


def instant(name: str, cat: "str | None" = None, **args) -> None:
    """Record a point event (no-op when off)."""
    if not enabled():
        return
    r = _rec()
    stack = _STACK.get()
    evt = {"kind": "instant", "name": name, "ts": r.now(),
           "tid": threading.get_ident(),
           "parent": stack[-1] if stack else None,
           "cat": cat, "args": args or {}}
    _stamp_tenant(evt)
    r.append(evt)


def counter(name: str, value, **args) -> None:
    """Record one sample of a cumulative counter track (no-op when
    off). ``value`` should be the running total so the exported track
    is monotone."""
    if not enabled():
        return
    r = _rec()
    evt = {"kind": "counter", "name": name, "ts": r.now(),
           "tid": threading.get_ident(), "value": value,
           "args": args or {}}
    _stamp_tenant(evt)
    r.append(evt)


def complete(name: str, dur: float, cat: "str | None" = None,
             **args) -> None:
    """Record an already-elapsed slice ending now (``ts = now - dur``)
    — for regions whose start was only known in monotonic time, e.g.
    watchdog section completions."""
    if not enabled():
        return
    r = _rec()
    t1 = r.now()
    evt = {"kind": "complete", "name": name,
           "ts": t1 - max(float(dur), 0.0), "dur": float(dur),
           "tid": threading.get_ident(), "cat": cat,
           "args": args or {}}
    _stamp_tenant(evt)
    r.append(evt)


# -------------------------------------------------------------- readers
def events() -> list:
    """Snapshot of the local buffer ([] when never armed)."""
    return _RECORDER.events() if _RECORDER is not None else []


def since(cursor: int = 0) -> dict:
    """The ``/trace?since=`` payload (cursored segment + eviction gap,
    same discipline as ``events.since``). When the recorder was never
    armed, says so instead of returning a deceptively empty stream."""
    if _RECORDER is None:
        return {"events": [], "cursor": int(cursor), "dropped": 0,
                "armed": enabled()}
    return _RECORDER.since(cursor)


def unix_skew() -> float:
    """Seconds the Unix clock reads ahead of the recorder's clock now
    (0.0 before the recorder is made): the wall clock's slews and steps
    since the recorder took its epoch."""
    r = _RECORDER
    return 0.0 if r is None else time.time() - r.now()


def dropped() -> int:
    return _RECORDER.dropped() if _RECORDER is not None else 0


def clear() -> None:
    if _RECORDER is not None:
        _RECORDER.clear()


def rank_buffers(env=None) -> "list[dict]":
    """Per-rank event buffers for merge/export: a list of
    ``{"rank", "world", "clock_offset", "events"}`` dicts.

    Ranks as processes (``ProcessGroupComm``): one buffer per process
    via :func:`cylon_tpu_torch.telemetry.aggregate.gather_traces`,
    clock-aligned by the env's barrier-anchored offset estimate. One
    process (no env, ``LocalComm``, or the W threads of a
    ``ThreadWorld`` sharing this recorder): the local buffer, split by
    each event's :func:`rank_scope` stamp into one buffer a rank at
    offset 0 (unstamped events go to the env's rank, 0 without one).
    (Thin alias of ``gather_traces`` — ONE home for the buffer shape.)
    """
    from cylon_tpu_torch.telemetry.aggregate import gather_traces

    return gather_traces(env)


def filter_tenant(evts, tenant: str) -> list:
    """Events attributed to ``tenant`` — directly (the ``"tenant"``
    stamp from an ambient :func:`cylon_tpu_torch.telemetry.tenant_scope`) or
    transitively (a span/instant nested under a stamped span via
    ``parent``, e.g. the exchange instants a tenant's dist op emits
    inside its request span). End events follow their begin's verdict.
    This is how one mixed-workload recording is sliced into per-tenant
    timelines (``tracing.report(tenant=)`` /
    ``straggler_report(timeline=, tenant=)``)."""
    tenant = str(tenant)
    # span ids are per-rank counters, so on a merged multi-rank
    # timeline the id must be namespaced by rank — otherwise rank 1's
    # id=1 (someone else's span) would match rank 0's kept id=1
    keep_ids: set = set()
    out = []
    for e in evts:
        rank = e.get("rank")
        mine = e.get("tenant") == tenant
        if not mine and e.get("kind") == "end":
            mine = (rank, e.get("id")) in keep_ids
        if not mine and e.get("parent") is not None:
            mine = (rank, e["parent"]) in keep_ids
        if mine:
            if e.get("kind") == "begin":
                keep_ids.add((rank, e.get("id")))
            out.append(e)
    return out


# ----------------------------------------------------- merge + analysis
def merge_timelines(buffers) -> list:
    """One time-sorted event list from per-rank buffers.

    ``buffers``: iterables of ``(rank, events)`` pairs or
    ``{"rank", "clock_offset", "events"}`` dicts (the
    :func:`rank_buffers` / ``gather_traces`` shape). Each event gains a
    ``rank`` key and its ``ts`` is shifted onto rank 0's clock by
    subtracting the buffer's ``clock_offset`` — after the shift,
    same-instant events across hosts line up to within the barrier
    jitter of the offset estimate (see ``CylonEnv.clock_offset``).

    Process tracks: a buffer may carry a ``proc`` name (a
    fleet router or engine process — ``clock_offset`` then comes from
    the router's ping handshake, not a barrier). The proc name becomes
    the timeline's track key (each event's ``rank`` AND ``proc``), so
    :func:`critical_path` / ``straggler_report`` attribute per-process
    exactly as they attribute per-rank. Do not mix named-proc and
    integer-rank buffers in one merge — track keys must stay
    comparably typed.
    """
    merged = []
    for buf in buffers:
        proc = None
        if isinstance(buf, dict):
            rank = buf.get("rank", 0)
            proc = buf.get("proc")
            off = float(buf.get("clock_offset", 0.0) or 0.0)
            evts = buf.get("events", [])
        else:
            rank, evts = buf
            off = 0.0
        for e in evts:
            e = dict(e)
            e["rank"] = proc if proc is not None else rank
            if proc is not None:
                e["proc"] = proc
            e["ts"] = e["ts"] - off
            merged.append(e)
    merged.sort(key=lambda e: e["ts"])
    return merged


def request_timeline(merged, trace_id: str) -> list:
    """The slice of a merged timeline belonging to ONE distributed
    request: events stamped with ``trace_id`` directly, plus end
    events and children whose begin/parent was stamped (end events
    carry no ambient stamps — they follow their begin's verdict, the
    same track-namespaced id discipline as :func:`filter_tenant`)."""
    tid = str(trace_id)
    keep_ids: set = set()
    out = []
    for e in merged:
        rank = e.get("rank")
        mine = e.get("trace_id") == tid
        if not mine and e.get("kind") == "end":
            mine = (rank, e.get("id")) in keep_ids
        if not mine and e.get("parent") is not None:
            mine = (rank, e["parent"]) in keep_ids
        if mine:
            if e.get("kind") == "begin":
                keep_ids.add((rank, e.get("id")))
            out.append(e)
    return out


def fleet_request_report(merged, trace_id: str) -> dict:
    """Causal phase attribution for one fleet request across process
    tracks: where did its wall go — router queue, engine queue,
    dispatch steps, replay hops?

    Reads the spans the serve/fleet layers emit under the request's
    :func:`trace_context`: the router's ``fleet.submit`` span, each
    engine's ``serve.admit`` instant and ``serve.step`` spans, and
    ``fleet.replay_hop`` instants (a failover re-running the request
    on a surviving peer under the ORIGINAL trace id). Returns::

        {"trace_id", "procs",            # tracks the request touched
         "spans": <matched span count>,
         "events": <total>,
         "monotone": bool,               # causally ordered post-merge
         "replay_hops": [{"engine", "ts"}, ...],
         "phases": {"router_queue_s",    # router admit -> engine admit
                    "engine_queue_s": {proc: s},   # admit -> 1st step
                    "dispatch_s": {proc: s}}}      # sum of step spans
    """
    evts = request_timeline(merged, trace_id)
    by_track: "dict[object, list]" = {}
    for e in evts:
        by_track.setdefault(e.get("rank"), []).append(e)
    procs = sorted(str(k) for k in by_track)
    monotone = all(a["ts"] <= b["ts"] for a, b in zip(evts, evts[1:]))
    replay_hops = [{"engine": e.get("args", {}).get("engine"),
                    "ts": e["ts"]}
                   for e in evts if e.get("name") == "fleet.replay_hop"]
    submit_ts = min((e["ts"] for e in evts
                     if e.get("name") == "fleet.submit"
                     and e.get("kind") == "begin"), default=None)
    engine_queue: "dict[str, float]" = {}
    dispatch: "dict[str, float]" = {}
    first_admit = None
    spans = 0
    for track, tevts in by_track.items():
        admits = [e["ts"] for e in tevts
                  if e.get("name") == "serve.admit"]
        steps = [(b, d) for b, d in _matched_spans(tevts)
                 if b.get("name") == "serve.step"]
        spans += len(_matched_spans(tevts))
        if admits and (first_admit is None
                       or admits[0] < first_admit):
            first_admit = admits[0]
        if admits and steps:
            engine_queue[str(track)] = max(
                min(b["ts"] for b, _ in steps) - admits[0], 0.0)
        if steps:
            dispatch[str(track)] = sum(d for _, d in steps)
    phases: dict = {"engine_queue_s": engine_queue,
                    "dispatch_s": dispatch}
    phases["router_queue_s"] = (
        max(first_admit - submit_ts, 0.0)
        if submit_ts is not None and first_admit is not None else None)
    return {"trace_id": str(trace_id), "procs": procs, "spans": spans,
            "events": len(evts), "monotone": monotone,
            "replay_hops": replay_hops, "phases": phases}


def _matched_spans(evts):
    """(begin event, duration) for every begin/end pair in one rank's
    event list — the ONE home for the eviction-tolerant matching
    semantics (unmatched begins and ring-orphaned ends are skipped).
    Shared by :func:`critical_path` and :func:`stage_coverage`."""
    open_by_id, out = {}, []
    for e in evts:
        if e["kind"] == "begin":
            open_by_id[e["id"]] = e
        elif e["kind"] == "end":
            b = open_by_id.pop(e.get("id"), None)
            if b is not None:
                out.append((b, e["ts"] - b["ts"]))
    return out


def critical_path(merged) -> dict:
    """Walk a merged timeline; attribute wall time to stages per rank
    and name the straggler.

    Stages are the events instrumented as such: ``complete`` slices
    with ``cat == "stage"`` (watchdog sections — ``exchange``,
    ``ooc_pass``, ... — always recorded by ``watched_section``) plus
    spans carrying ``cat == "stage"`` (the per-op dispatch/sync
    sub-spans). When a timeline carries no stage events at all (an op
    with no watched sections and no stage spans),
    top-level spans stand in.

    Returns::

        {"straggler_rank": r, "dominant_stage": s,
         "excess_seconds": float,      # straggler's stage time over the
                                       # median of the other ranks
         "rank_walls": {rank: wall},   # first-event -> last-event span
         "stage_seconds": {rank: {stage: seconds}},
         "op_seconds": {rank: {op: seconds}}}   # top-level spans

    The straggler is the rank with the longest wall; its dominant
    stage is the stage with the largest excess over the median of the
    same stage on the other ranks (ties break by stage name, so the
    verdict is deterministic).
    """
    by_rank: "dict[int, list]" = {}
    for e in merged:
        by_rank.setdefault(e.get("rank", 0), []).append(e)

    rank_walls: "dict[int, float]" = {}
    stage_seconds: "dict[int, dict]" = {}
    op_seconds: "dict[int, dict]" = {}
    for rank, evts in by_rank.items():
        ts = [e["ts"] for e in evts]
        ends = [e["ts"] + e.get("dur", 0.0) for e in evts]
        rank_walls[rank] = (max(ends) - min(ts)) if ts else 0.0
        stages: "dict[str, float]" = {}
        ops: "dict[str, float]" = {}
        for e in evts:
            if e["kind"] == "complete" and e.get("cat") == "stage":
                stages[e["name"]] = stages.get(e["name"], 0.0) \
                    + e.get("dur", 0.0)
        for b, dur in _matched_spans(evts):
            if b.get("cat") == "stage":
                stages[b["name"]] = stages.get(b["name"], 0.0) + dur
            if b.get("parent") is None:
                ops[b["name"]] = ops.get(b["name"], 0.0) + dur
        stage_seconds[rank] = stages
        op_seconds[rank] = ops

    if not rank_walls:
        return {"straggler_rank": None, "dominant_stage": None,
                "excess_seconds": 0.0, "rank_walls": {},
                "stage_seconds": {}, "op_seconds": {}}

    straggler = max(sorted(rank_walls), key=lambda r: rank_walls[r])
    mine = stage_seconds.get(straggler) or op_seconds.get(straggler, {})
    use_ops = not stage_seconds.get(straggler)
    others = [r for r in rank_walls if r != straggler]

    def _median(vals):
        vals = sorted(vals)
        if not vals:
            return 0.0
        m = len(vals) // 2
        return vals[m] if len(vals) % 2 else (vals[m - 1] + vals[m]) / 2

    best_stage, best_excess = None, float("-inf")
    for name in sorted(mine):
        table = op_seconds if use_ops else stage_seconds
        med = _median([table.get(r, {}).get(name, 0.0) for r in others])
        excess = mine[name] - med
        if excess > best_excess:
            best_stage, best_excess = name, excess
    return {"straggler_rank": straggler, "dominant_stage": best_stage,
            "excess_seconds": max(best_excess, 0.0)
            if best_stage is not None else 0.0,
            "rank_walls": rank_walls, "stage_seconds": stage_seconds,
            "op_seconds": op_seconds}


def stage_coverage(evts, op: str) -> "float | None":
    """Fraction of the LAST top-level ``op`` span's wall covered by its
    direct child spans — the "no dark time inside the op" metric the
    bench trace artifact reports (acceptance: >= 0.8 for the headline
    dist_join). None when no completed ``op`` span exists."""
    matched = _matched_spans(evts)
    tops = [(b, d) for b, d in matched
            if b["name"] == op and b.get("parent") is None]
    if not tops:
        return None
    top, top_dur = tops[-1]
    if top_dur <= 0:
        return 1.0
    covered = sum(d for b, d in matched if b.get("parent") == top["id"])
    return min(covered / top_dur, 1.0)
