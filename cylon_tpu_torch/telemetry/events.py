"""Structured event journal: the engine's typed control-plane log.

Metrics answer "how many"; traces answer "where did the time go";
neither answers the incident question "*what happened*, in order?" —
which requests were shed, when the breaker opened, which tenant's
request degraded through the spill path. This module is that third
leg: a bounded, typed, in-memory journal of control-plane events,
emitted at the SAME call sites that already bump the corresponding
counters (admission sheds, retirements, breaker transitions, OOM
forensics, checkpoint resumes, fallback routing, watchdog expiries),
replayable in order through ``/events?since=<cursor>`` on the serve
introspection endpoint and optionally appended as JSONL under
``CYLON_TPU_METRICS_DIR`` for post-incident forensics.

**Typed**: every event kind is registered in :data:`EVENT_KINDS` with
its expected payload fields — an unregistered kind raises at the emit
site (and a bench-guard AST lint checks every literal ``emit("...")``
call in the tree against the schema), so the journal's vocabulary
cannot drift silently.

**Bounded**: a ring of ``CYLON_TPU_EVENTS_CAPACITY`` (default 8192)
events; the monotonically increasing ``seq`` cursor survives eviction,
so a consumer that falls behind sees the gap (``dropped``) instead of
silently missing events.

Fast-path contract (same as trace/metrics-dir/introspect): armed ONLY
by ``CYLON_TPU_EVENTS`` — unset, every :func:`emit` is one env read;
no ring, no file handle, no thread exists (pinned by
``tests/test_events.py``).

Event shape::

    {"seq": 42, "ts": <monotonic s>, "wall": <epoch s>,
     "kind": "shed", "tenant": "alice", "rid": 7, ...payload}

``tenant`` is stamped from the ambient
:func:`cylon_tpu_torch.telemetry.tenant_scope` when the emitter does not
pass one explicitly.
"""

import collections
import json
import os
import threading
import time

from cylon_tpu_torch.telemetry.registry import current_tenant as _current_tenant

__all__ = [
    "EVENT_KINDS", "EventJournal", "enabled", "emit", "events",
    "since", "dropped", "clear", "DEFAULT_CAPACITY",
]

DEFAULT_CAPACITY = 8192

#: the registered event vocabulary: kind -> payload fields an emitter
#: may attach (beyond the envelope seq/ts/wall/kind/tenant/rid).
#: :func:`emit` refuses a kind or a field this table does not hold, so
#: an unregistered kind fails at its emit site before it can ship an
#: unparseable journal.
EVENT_KINDS: "dict[str, tuple]" = {
    # serve admission / lifecycle (``path``: how the
    # request was answered — executed | cache_hit | coalesced)
    "admit": ("slo", "path"),
    "retire": ("state", "wall_s", "error"),
    "shed": ("reason",),
    "degraded": ("error",),
    # the dedup plane, journaled: a versioned
    # result-cache hit answered without executing; a submission
    # attached as a coalesce follower behind a leader; a retiring
    # leader fanned its value out to N followers at once
    "cache_hit": ("fingerprint",),
    "coalesced": ("leader_rid",),
    "batch_retire": ("followers", "wall_s"),
    # memory pressure
    "oom": ("point", "error"),
    # circuit breaker transitions (engine-wide, no tenant)
    "breaker_open": ("failures", "window_s", "cooldown_s"),
    "breaker_close": ("open_s",),
    # resilience / fallback
    "checkpoint_resume": ("op", "unit"),
    "fallback": ("op", "reason"),
    # two-phase global aggregate: the journaled merge scalar was
    # computed (or replayed) for this query
    "merge_phase": ("op",),
    # watchdog
    "watchdog_expired": ("section", "detail", "elapsed_s",
                         "budget_s"),
    # fleet router (engine-less process — no tenant/rid)
    "failover": ("engine", "reason", "replayed", "lost"),
    "fence": ("engine", "owner"),
    # the router's /events?since= poll saw an eviction gap: `dropped`
    # spans fell out of the engine's ring before the cursor caught up
    # (storm-time observability loss, itself observable)
    "events_gap": ("engine", "dropped"),
    # appendable tables + materialized views: a delta
    # landed on a resident table / a view folded its pending deltas in
    "append": ("table", "generation", "delta_rows"),
    "view_refresh": ("view", "generation", "delta_rows", "wall_s",
                     "full_recompute"),
}


def enabled() -> bool:
    """Is the journal armed? One env read — the entire fast-path cost
    when ``CYLON_TPU_EVENTS`` is unset/0/off."""
    return os.environ.get("CYLON_TPU_EVENTS", "") not in ("", "0",
                                                          "off")


class EventJournal:
    """Bounded, thread-safe, cursored event ring (+ optional JSONL)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._mu = threading.Lock()
        self._buf: collections.deque = collections.deque(
            maxlen=max(int(capacity), 16))
        self._seq = 0
        self._jsonl = None
        self._jsonl_failed = False

    def emit(self, kind: str, tenant: "str | None" = None,
             rid: "int | None" = None, **fields) -> dict:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unregistered event kind {kind!r}; add it to "
                f"telemetry.events.EVENT_KINDS (known: "
                f"{sorted(EVENT_KINDS)})")
        unknown = set(fields) - set(EVENT_KINDS[kind])
        if unknown:
            # the schema registers FIELDS too, not just kinds: a
            # mistyped payload key would otherwise drift past the
            # bench-guard lint and consumers keyed on the documented
            # name would silently see nothing
            raise ValueError(
                f"event kind {kind!r} does not declare field(s) "
                f"{sorted(unknown)}; declared: "
                f"{list(EVENT_KINDS[kind])}")
        if tenant is None:
            tenant = _current_tenant()
        evt = {"ts": time.monotonic(), "wall": time.time(),
               "kind": kind}
        if tenant is not None:
            evt["tenant"] = str(tenant)
        if rid is not None:
            evt["rid"] = int(rid)
        evt.update(fields)
        with self._mu:
            self._seq += 1
            evt["seq"] = self._seq
            self._buf.append(evt)
            # under the lock on purpose: the lazily-opened handle must
            # not be double-opened by racing emitters, and the JSONL
            # stream must stay seq-ordered like /events (armed-only
            # path — the unarmed world never reaches here)
            self._maybe_jsonl(evt)
        return evt

    # ----------------------------------------------------------- read
    def since(self, cursor: int = 0) -> dict:
        """Events with ``seq > cursor``, in order, plus the cursor to
        resume from and how many matching events were already evicted
        by the ring bound (a consumer that fell behind sees the GAP)::

            {"events": [...], "cursor": <last seq>,
             "dropped": <evicted>, "armed": True}
        """
        cursor = int(cursor)
        with self._mu:
            evts = [e for e in self._buf if e["seq"] > cursor]
            seq = self._seq
        oldest_held = evts[0]["seq"] if evts else seq + 1
        # everything in (cursor, oldest_held) was evicted before read
        dropped = max(oldest_held - cursor - 1, 0)
        return {"events": evts, "cursor": seq, "dropped": dropped,
                "armed": True}

    def events(self) -> list:
        with self._mu:
            return list(self._buf)

    def dropped(self) -> int:
        with self._mu:
            return self._seq - len(self._buf)

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()

    # ---------------------------------------------------------- JSONL
    def _maybe_jsonl(self, evt: dict) -> None:
        """Durable companion stream: when ``CYLON_TPU_METRICS_DIR`` is
        configured, every event also appends to
        ``<dir>/events-<pid>.jsonl`` (line-buffered, no fsync — a
        forensics convenience, not the durability journal). IO
        failures disable the stream after one warning; the in-memory
        ring must never pay for a full disk. Caller holds ``_mu``."""
        if self._jsonl_failed:
            return
        d = os.environ.get("CYLON_TPU_METRICS_DIR")
        if not d:
            return
        from cylon_tpu_torch.telemetry.export import json_safe

        try:
            if self._jsonl is None:
                os.makedirs(d, exist_ok=True)
                self._jsonl = open(
                    os.path.join(d, f"events-{os.getpid()}.jsonl"),
                    "a", buffering=1)
            self._jsonl.write(json.dumps(
                json_safe(evt), allow_nan=False,
                separators=(",", ":")) + "\n")
        except Exception as e:
            self._jsonl_failed = True
            try:
                from cylon_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    "event JSONL stream to %s disabled: %s", d, e)
            except Exception:
                pass


_LOCK = threading.Lock()
_JOURNAL: "EventJournal | None" = None


def _journal() -> EventJournal:
    global _JOURNAL
    j = _JOURNAL
    if j is None:
        with _LOCK:
            if _JOURNAL is None:
                try:
                    cap = int(os.environ.get(
                        "CYLON_TPU_EVENTS_CAPACITY",
                        str(DEFAULT_CAPACITY)))
                except ValueError:
                    cap = DEFAULT_CAPACITY
                _JOURNAL = EventJournal(cap)
            j = _JOURNAL
    return j


def emit(kind: str, tenant: "str | None" = None,
         rid: "int | None" = None, **fields) -> "dict | None":
    """Emit one typed event (no-op returning None when unarmed —
    instrumented call sites pay one env read)."""
    if not enabled():
        return None
    return _journal().emit(kind, tenant=tenant, rid=rid, **fields)


def events() -> list:
    """Snapshot of the ring ([] when never armed)."""
    return _JOURNAL.events() if _JOURNAL is not None else []


def since(cursor: int = 0) -> dict:
    """The ``/events?since=`` payload. When the journal was never
    armed, says so instead of returning a deceptively empty stream."""
    if _JOURNAL is None:
        return {"events": [], "cursor": int(cursor), "dropped": 0,
                "armed": enabled()}
    return _JOURNAL.since(cursor)


def dropped() -> int:
    return _JOURNAL.dropped() if _JOURNAL is not None else 0


def clear() -> None:
    """Reset the journal entirely (tests) — drops the ring, the
    cursor, and the JSONL handle."""
    global _JOURNAL
    with _LOCK:
        j, _JOURNAL = _JOURNAL, None
    if j is not None and j._jsonl is not None:
        try:
            j._jsonl.close()
        except Exception:
            pass
