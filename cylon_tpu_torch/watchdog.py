"""Deadline & watchdog layer: bounded blocking, hang detection, stall
diagnostics.

Port of ``cylon_tpu/watchdog.py`` (host code, copied with its imports
pointed at the port). A hang never raises, so the resilience layer's
retries (:mod:`cylon_tpu_torch.resilience`) cannot see it; this module
bounds the host-side blocking points with three primitives:

1. :func:`deadline` — a contextvar-propagated scope: every named
   blocking section entered while it is active is bounded by it.
   Nesting takes the minimum.

2. :func:`bounded` — run a blocking callable under the section's
   effective deadline. With no ambient scope, no explicit timeout and no
   ``CYLON_TPU_DEADLINE_<SECTION>`` default, the callable runs inline
   with no bookkeeping: no monitor thread, no worker thread. Under a
   deadline it runs on a daemon worker thread (on the caller's CUDA
   stream) and the caller waits at most the remaining budget; on expiry
   the watchdog dumps all-thread stacks and raises
   :class:`~cylon_tpu_torch.errors.DeadlineExceeded` naming the section.
   The stalled worker is abandoned.

3. :func:`watched_section` / :func:`watched` / :func:`check` — for
   regions that must run on the calling thread (an exchange already
   queued on the card cannot be moved): the monitor detects the stall
   and dumps stacks while it is stuck, the region raises on exit if the
   deadline passed, and :func:`check` checkpoints chunked loops.

:data:`SECTIONS` says whether each section's deadline is retryable
(``bootstrap`` and ``spill_io`` are; the collectives are not), and
``resilience.is_retryable`` reads the flag. Section completions feed the
telemetry registry (per-section latency timers, expiry counters, a
bounded record history) and the flight recorder (one ``cat="stage"``
complete slice each); :func:`timings` and :func:`straggler_report` are
views over them. None of this waits on a device: a section adds host
bookkeeping only.

Hangs are injectable: ``FaultRule(point, delay=...)`` (or
``FaultRule.hang``) makes :func:`cylon_tpu_torch.resilience.inject`
sleep at a fault point.
"""

import contextlib
import contextvars
import dataclasses
import functools
import os
import sys
import threading
import time
import traceback

import torch

from cylon_tpu_torch import config as _config
from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import DeadlineExceeded, InvalidArgument

__all__ = [
    "SECTIONS", "DEADLINE_POLICY", "deadline", "active_deadline",
    "remaining", "default_deadline_policy", "section_default", "bounded",
    "watched_section", "watched", "check", "dump_stacks",
    "active_sections", "timings", "clear_timings", "straggler_report",
]

#: Named blocking sections -> is a deadline there retryable?
#: ``bootstrap`` and ``spill_io`` deadlines retry (the peer may rejoin,
#: the mount may recover — same failure domain the retry engine already
#: wraps); ``barrier`` / ``overflow_fetch`` / ``exchange`` / ``ooc_pass``
#: never do: a collective that stalled left the mesh in an unknowable
#: half-completed state, and re-issuing it deadlocks against the first.
SECTIONS: "dict[str, bool]" = {
    "barrier": False,
    "bootstrap": True,
    "overflow_fetch": False,
    "spill_io": True,
    "ooc_pass": False,
    # one unit of pipelined ingest on a prefetch worker
    # (cylon_tpu_torch.pipeline) — never retryable on its own: the expiry
    # surfaces on the consuming pass, whose ooc_pass section already
    # says the mesh/pass state is unrecoverable
    "ooc_prefetch": False,
    "exchange": False,
    # the two-phase fallback's global merge (cylon_tpu_torch.fallback):
    # the blocking scalar between the partial pass and the apply
    # pass — never retryable on its own: the merge is deterministic
    # host compute over durable partials, so a deadline there means
    # the partials (or the journal write) are wedged, and a blind
    # re-merge would just wedge again; resume via the checkpoint
    "fallback_merge": False,
}

#: the process :class:`~cylon_tpu_torch.config.DeadlinePolicy`; None is
#: the struct's defaults (the JAX package reads
#: ``CYLON_TPU_WATCHDOG_POLL`` / ``_DEADLINE_ACTION`` / ``_DEADLINE_DUMP``
#: per call; here a caller sets this instead). ``SECTIONS`` and
#: ``config.DEADLINE_SECTIONS`` cover the same sections
#: (``tests/test_torch_watchdog.py`` holds them equal): the JAX
#: package's, less ``serve_request`` and ``router_poll``, whose serving
#: layer and fleet router the port does not have yet.
DEADLINE_POLICY: "_config.DeadlinePolicy | None" = None


def default_deadline_policy() -> "_config.DeadlinePolicy":
    """The process policy, :data:`DEADLINE_POLICY`, read per call."""
    if DEADLINE_POLICY is None:
        return _config.DeadlinePolicy()
    return DEADLINE_POLICY


def section_default(section: str) -> "float | None":
    """Default budget for ``section``: ``CYLON_TPU_DEADLINE_<SECTION>``
    if set (``<= 0`` = unbounded), else the
    :data:`cylon_tpu_torch.config.DEADLINE_SECTIONS` table."""
    v = os.environ.get(f"CYLON_TPU_DEADLINE_{section.upper()}")
    if v is not None:
        try:
            f = float(v)
        except ValueError:
            raise InvalidArgument(
                f"CYLON_TPU_DEADLINE_{section.upper()}={v!r} is not a "
                "number of seconds") from None
        return f if f > 0 else None
    return _config.DEADLINE_SECTIONS.get(section)


# -------------------------------------------------------- deadline scope
class Deadline:
    """An absolute expiry on the monotonic clock (scope-internal)."""

    __slots__ = ("expires_at", "label")

    def __init__(self, expires_at: float, label: str):
        self.expires_at = expires_at
        self.label = label

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def __repr__(self):
        return f"Deadline({self.label!r}, {self.remaining():.3f}s left)"


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_deadline", default=None)

#: innermost live watched_section for this context — lets check()
#: honour a section budget that came from an env default or explicit
#: timeout, not only from an ambient deadline() scope
_ACTIVE_SECTION: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_watched_section", default=None)


@contextlib.contextmanager
def deadline(seconds: float, label: str = "deadline"):
    """Bound every named blocking section entered in this scope.

    Contextvar-propagated (worker threads spawned by :func:`bounded`
    copy the context, so nested sections inside the worker see it too).
    Nested scopes take the minimum absolute expiry: an inner, tighter
    deadline wins; an inner, looser one cannot extend the outer budget.
    """
    exp = time.monotonic() + float(seconds)
    outer = _SCOPE.get()
    if outer is not None:
        exp = min(exp, outer.expires_at)
    tok = _SCOPE.set(Deadline(exp, label))
    try:
        yield _SCOPE.get()
    finally:
        _SCOPE.reset(tok)


def active_deadline() -> "Deadline | None":
    return _SCOPE.get()


def remaining() -> "float | None":
    """Seconds left on the ambient deadline (None = no scope active)."""
    d = _SCOPE.get()
    return None if d is None else d.remaining()


# ------------------------------------------------------ stall diagnostics
def dump_stacks(header: str, file=None) -> None:
    """Write ``header`` plus every thread's current stack to ``file``
    (default stderr). Pure-Python (``sys._current_frames``), so it
    works under captured/redirected stderr where ``faulthandler``'s
    fd-level dump cannot."""
    out = file if file is not None else sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [f"\n=== {header} ===\n"]
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')!r} "
                     f"(ident {tid}) ---\n")
        lines.extend(traceback.format_stack(frame))
    lines.append("=== end cylon_tpu_torch watchdog dump ===\n")
    try:
        out.write("".join(lines))
        out.flush()
    except Exception:
        pass  # diagnostics must never mask the stall itself


@dataclasses.dataclass
class SectionTiming:
    """One completed section, queryable via :func:`timings` for
    straggler reporting. ``dump_after`` is seconds from section start
    to the watchdog's stack dump (None = never stalled); ``tenant`` is
    the serve-layer attribution active when the section completed
    (None outside a tenant scope)."""

    section: str
    detail: str
    elapsed: float
    budget: "float | None"
    expired: bool
    dump_after: "float | None" = None
    tenant: "str | None" = None


#: telemetry series section completions feed (the registry is the one
#: source of truth — there is no private deque any more):
#: per-section latency histogram, expiry counter, raw-record history
SECTION_TIMER = "watchdog.section_seconds"
SECTION_EXPIRED = "watchdog.sections_expired"
SECTION_RECORDS = "watchdog.section_timings"


def timings(section: "str | None" = None,
            tenant: "str | None" = None) -> "list[SectionTiming]":
    """Completed-section timing records, newest last (bounded history,
    read from the telemetry registry's record store), optionally
    filtered to one section and/or one serve-layer tenant."""
    recs = telemetry.get_records(SECTION_RECORDS)
    if section is not None:
        recs = [r for r in recs if r.section == section]
    if tenant is not None:
        recs = [r for r in recs
                if getattr(r, "tenant", None) == str(tenant)]
    return recs


def clear_timings() -> None:
    """Clear the section history: ONE registry operation —
    ``telemetry.reset("watchdog.")`` — because the history lives only
    in the telemetry registry (no private deque to clear separately,
    so the two can never diverge; a full ``telemetry.reset()`` clears
    it too). Scoped to the ``watchdog.`` namespace so an operator
    resetting straggler stats between query phases does not destroy
    the run's exchange/spill/plan counters."""
    telemetry.reset("watchdog.")


def straggler_report(timeline: "list | None" = None,
                     tenant: "str | None" = None) -> dict:
    """Per-section aggregate: count, mean/max elapsed, and how many
    expired — the quickest way to see which blocking layer is the
    straggler. A pure view over the telemetry registry (the
    :data:`SECTION_TIMER` histograms and :data:`SECTION_EXPIRED`
    counters), not a second accumulation. Sections split across
    tenant-labeled series merge per section; ``tenant=`` restricts the
    report to one serve-layer tenant's sections — isolating its
    stragglers from a mixed multi-tenant workload.

    **Fleet-aware form**: pass ``timeline`` — a merged multi-rank event
    list from :func:`cylon_tpu_torch.telemetry.trace.merge_timelines` (per-
    rank buffers via ``trace.rank_buffers`` / ``gather_traces``) — and
    the report instead walks the timeline and NAMES the straggler:
    ``{"straggler_rank", "dominant_stage", "excess_seconds",
    "rank_walls", "stage_seconds", ...}``
    (:func:`cylon_tpu_torch.telemetry.trace.critical_path`); ``tenant=``
    first slices the timeline to that tenant's events
    (:func:`cylon_tpu_torch.telemetry.trace.filter_tenant`). The local form
    can only say which *section* is slow on this host; the fleet form
    says which *rank* is slow and in which stage."""
    if timeline is not None:
        if tenant is not None:
            timeline = telemetry.trace.filter_tenant(timeline, tenant)
        return telemetry.trace.critical_path(timeline)
    agg: dict[str, dict] = {}
    for _, labels, inst in telemetry.instruments(SECTION_TIMER):
        sec = labels.get("section", "?")
        if not inst.count:
            continue
        if tenant is not None and labels.get("tenant") != str(tenant):
            continue
        a = agg.setdefault(sec, {"count": 0, "total_s": 0.0,
                                 "max_s": 0.0, "expired": 0})
        a["count"] += inst.count
        a["total_s"] += inst.sum
        a["max_s"] = max(a["max_s"],
                         inst.max if inst.max is not None else 0.0)
    for _, labels, inst in telemetry.instruments(SECTION_EXPIRED):
        sec = labels.get("section", "?")
        if sec not in agg:
            continue
        if tenant is not None and labels.get("tenant") != str(tenant):
            continue
        agg[sec]["expired"] += inst.value
    for a in agg.values():
        a["mean_s"] = a["total_s"] / a["count"]
    return agg


class _Section:
    """A live blocking section the monitor watches."""

    __slots__ = ("section", "detail", "started", "expires_at", "budget",
                 "thread_name", "dumped", "dump_after", "dump_event")

    def __init__(self, section, detail, started, expires_at, budget):
        self.section = section
        self.detail = detail
        self.started = started
        self.expires_at = expires_at
        self.budget = budget
        self.thread_name = threading.current_thread().name
        self.dumped = False
        self.dump_after: "float | None" = None
        self.dump_event = threading.Event()


def _finish(rec: _Section, expired: bool) -> None:
    elapsed = time.monotonic() - rec.started
    tl = telemetry.tenant_labels()
    telemetry.timer(SECTION_TIMER, section=rec.section,
                    **tl).observe(elapsed)
    if expired:
        telemetry.counter(SECTION_EXPIRED, section=rec.section,
                          **tl).inc()
    telemetry.add_record(SECTION_RECORDS, SectionTiming(
        rec.section, rec.detail, elapsed, rec.budget, expired,
        rec.dump_after, tenant=tl.get("tenant")))
    # flight recorder: one complete slice per section, cat="stage" — the
    # unit trace.critical_path attributes straggler wall time to (the
    # section start exists only in monotonic time, so the recorder
    # back-dates it from the elapsed duration)
    telemetry.trace.complete(rec.section, elapsed, cat="stage",
                             detail=rec.detail, expired=expired)


# ------------------------------------------------------------- the monitor
class _Monitor:
    """Lazily-started daemon thread watching live sections. Event-driven:
    sleeps until the earliest undumped expiry (clamped by the policy
    poll interval), indefinitely when nothing is registered — a process
    that never enters a deadline scope never starts it at all."""

    def __init__(self):
        self._cond = threading.Condition()
        self._live: "dict[int, _Section]" = {}
        self._thread: "threading.Thread | None" = None

    @property
    def thread(self) -> "threading.Thread | None":
        return self._thread

    def register(self, rec: _Section) -> None:
        with self._cond:
            self._live[id(rec)] = rec
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="cylon-torch-watchdog",
                    daemon=True)
                self._thread.start()
            self._cond.notify()

    def unregister(self, rec: _Section) -> None:
        with self._cond:
            self._live.pop(id(rec), None)

    def ensure_fired(self, rec: _Section) -> None:
        """Dump for ``rec`` if the monitor has not yet (closes the race
        between a bounded call's own join timeout and the monitor's
        wake-up, so the stacks are always on stderr BEFORE the caller's
        DeadlineExceeded propagates)."""
        with self._cond:
            if rec.dumped:
                claimed = False
            else:
                rec.dumped = claimed = True
        if claimed:
            self._fire(rec)
        else:
            rec.dump_event.wait(timeout=5.0)

    def _loop(self):
        while True:
            due = []
            with self._cond:
                if not self._live:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                nxt = None
                for rec in self._live.values():
                    if rec.dumped:
                        continue
                    if now >= rec.expires_at:
                        rec.dumped = True
                        due.append(rec)
                    else:
                        nxt = rec.expires_at if nxt is None \
                            else min(nxt, rec.expires_at)
                if not due:
                    if nxt is not None:
                        # expiries are immutable and new registrations
                        # notify the condition, so sleeping exactly to
                        # the earliest expiry is safe — no periodic
                        # polling while sections are merely in flight
                        wait = max(0.001, nxt - now)
                    else:
                        # only already-dumped (still-stalled) sections
                        # remain: re-scan at the policy poll interval
                        # as a belt-and-braces fallback
                        wait = max(
                            0.001,
                            default_deadline_policy().poll_interval)
                    self._cond.wait(timeout=wait)
                    continue
            for rec in due:
                self._fire(rec)

    def _fire(self, rec: _Section) -> None:
        now = time.monotonic()
        rec.dump_after = now - rec.started
        telemetry.trace.instant("watchdog.expired", cat="watchdog",
                                section=rec.section, detail=rec.detail,
                                elapsed=rec.dump_after,
                                budget=rec.budget)
        telemetry.events.emit("watchdog_expired", section=rec.section,
                              detail=rec.detail,
                              elapsed_s=rec.dump_after,
                              budget_s=rec.budget)
        pol = default_deadline_policy()
        header = (
            f"cylon_tpu_torch watchdog: section {rec.section!r}"
            + (f" ({rec.detail})" if rec.detail else "")
            + f" stalled {now - rec.started:.3f}s"
            + (f" (budget {rec.budget:.3f}s)" if rec.budget is not None
               else "")
            + f", entered on thread {rec.thread_name!r}"
        )
        if pol.dump_stacks:
            dump_stacks(header)
        if pol.action == "abort":
            try:
                sys.stderr.write(
                    "cylon_tpu_torch watchdog: abort policy — exiting 70\n")
                sys.stderr.flush()
            finally:
                os._exit(70)
        # set LAST: the event means "firing (incl. any abort action)
        # is complete", so ensure_fired waiters cannot race ahead of a
        # test-patched os._exit
        rec.dump_event.set()


_MONITOR = _Monitor()


def active_sections() -> "list[tuple[str, str, float]]":
    """(section, detail, elapsed) for every currently-registered live
    section — what the process is blocked on right now."""
    now = time.monotonic()
    with _MONITOR._cond:
        return [(r.section, r.detail, now - r.started)
                for r in _MONITOR._live.values()]


# --------------------------------------------------------- the primitives
def _require_section(section: str) -> None:
    if section not in SECTIONS:
        raise InvalidArgument(
            f"unknown watchdog section {section!r}; valid: "
            f"{tuple(SECTIONS)}")


def _effective(section: str, timeout: "float | None"):
    """(absolute expiry | None, budget seconds | None): the minimum of
    the explicit timeout, the ambient deadline scope, and the section's
    env/config default."""
    now = time.monotonic()
    exp = None if timeout is None else now + float(timeout)
    d = _SCOPE.get()
    if d is not None:
        exp = d.expires_at if exp is None else min(exp, d.expires_at)
    sd = section_default(section)
    if sd is not None:
        e2 = now + sd
        exp = e2 if exp is None else min(exp, e2)
    return exp, (None if exp is None else max(0.0, exp - now))


def _exceeded(section: str, detail: str, elapsed: float,
              budget: "float | None",
              retryable: "bool | None" = None) -> DeadlineExceeded:
    if retryable is None:
        retryable = SECTIONS.get(section, False)
    msg = (
        f"deadline exceeded in section {section!r}"
        + (f" ({detail})" if detail else "")
        + f": {elapsed:.3f}s elapsed"
        + (f", budget {budget:.3f}s" if budget is not None else "")
        + ("; retryable" if retryable
           else "; not retryable")
    )
    return DeadlineExceeded(msg, section=section, elapsed=elapsed,
                            retryable=retryable)


def _caller_stream():
    """The calling thread's current CUDA stream, or None where CUDA was
    never initialised in this process (nothing can be queued on a card
    then, and asking would initialise it)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def bounded(fn, section: str, *, timeout: "float | None" = None,
            detail: str = ""):
    """Call ``fn()`` bounded by ``section``'s effective deadline.

    Fast path: with no ambient :func:`deadline` scope, no ``timeout``
    and no env default for the section, ``fn`` runs inline — no
    threads, no records, byte-for-byte the old unbounded behaviour.

    Bounded path: ``fn`` runs on a daemon worker thread (with the
    caller's contextvars copied in) and the caller waits at most the
    remaining budget. On expiry the watchdog dumps all-thread stacks —
    including the stuck worker's, which is the diagnostic payload —
    and :class:`~cylon_tpu_torch.errors.DeadlineExceeded` naming the section
    is raised (or the process aborts, per
    :class:`~cylon_tpu_torch.config.DeadlinePolicy`). The stalled worker is
    abandoned: it cannot be interrupted, and unblocking the caller is
    the contract. Device work the abandoned call already queued keeps
    running on the card (the JAX package's contract too: a dispatched
    program cannot be cancelled).

    The worker runs on the caller's current CUDA stream (a new thread's
    current stream is the default stream, so it is captured here and
    entered there): work ``fn`` queues and waits on stays ordered after
    what the caller queued before."""
    _require_section(section)
    exp, budget = _effective(section, timeout)
    if exp is None:
        return fn()
    now = time.monotonic()
    if exp <= now:
        # out of budget before starting: never retryable — the expiry
        # is absolute, so a re-attempt gets zero budget too. Recorded
        # in the timing history; no dump (nothing stalled)
        _finish(_Section(section, detail, now, exp, budget), True)
        raise _exceeded(section, detail, 0.0, budget, retryable=False)
    rec = _Section(section, detail, now, exp, budget)
    _MONITOR.register(rec)
    box: dict = {}
    ctx = contextvars.copy_context()
    stream = _caller_stream()

    def _run():
        try:
            if stream is None:
                box["r"] = ctx.run(fn)
            else:
                with torch.cuda.stream(stream):
                    box["r"] = ctx.run(fn)
        except BaseException as e:  # rethrown on the caller thread
            box["e"] = e

    worker = threading.Thread(target=_run, daemon=True,
                              name=f"cylon-bounded-{section}")
    expired = False
    try:
        worker.start()
        worker.join(exp - time.monotonic())
        if worker.is_alive() and "r" not in box and "e" not in box:
            expired = True
            _MONITOR.ensure_fired(rec)  # stacks hit stderr before raise
            raise _exceeded(section, detail,
                            time.monotonic() - rec.started, budget)
    finally:
        _MONITOR.unregister(rec)
        _finish(rec, expired)
    if "e" in box:
        raise box["e"]
    return box.get("r")


@contextlib.contextmanager
def watched_section(section: str, *, timeout: "float | None" = None,
                    detail: str = ""):
    """Detection-only scope for blocking regions that must run on the
    calling thread (a dispatched collective cannot be cancelled or
    moved to a worker). The watchdog dumps all-thread stacks while the
    region is stuck past its deadline; if the deadline passed by the
    time the region completes, exit raises
    :class:`~cylon_tpu_torch.errors.DeadlineExceeded` (a late raise — pair
    with :func:`check` checkpoints inside chunked loops for prompt
    ones). Always records a timing entry, deadline or not."""
    _require_section(section)
    exp, budget = _effective(section, timeout)
    rec = _Section(section, detail, time.monotonic(), exp, budget)
    if exp is not None and exp <= rec.started:
        # already out of budget on entry: refuse to start the region —
        # nothing stalled (no dump), and never retryable (the expiry
        # is absolute; a re-attempt gets zero budget too)
        _finish(rec, True)
        raise _exceeded(section, detail, 0.0, budget, retryable=False)
    if exp is not None:
        _MONITOR.register(rec)
    err = None
    tok = _ACTIVE_SECTION.set(rec)
    try:
        yield rec
    except Exception as e:
        err = e  # deadline verdict decided below; body error chained
    finally:
        _ACTIVE_SECTION.reset(tok)
        expired = exp is not None and time.monotonic() > exp
        if exp is not None:
            _MONITOR.unregister(rec)
        _finish(rec, expired)
    if expired and not isinstance(err, DeadlineExceeded):
        # the deadline is the operative failure: work past it is moot
        # whether it completed or broke (the body error stays chained)
        raise _exceeded(section, detail,
                        time.monotonic() - rec.started, budget) from err
    if err is not None:
        raise err


def watched(section: str, detail: str = ""):
    """Decorator form of :func:`watched_section`."""

    def deco(fn):
        lbl = detail or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with watched_section(section, detail=lbl):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def check(section: "str | None" = None, detail: str = "") -> None:
    """Cooperative checkpoint: raise
    :class:`~cylon_tpu_torch.errors.DeadlineExceeded` if the ambient
    :func:`deadline` scope — or the enclosing
    :func:`watched_section`'s budget, however it was set (scope, env
    default, explicit timeout) — has expired. Two contextvar reads on
    the fast path — cheap enough for per-chunk/per-bucket loops.

    ``section=None`` (for checkpoints in caller-agnostic utilities,
    e.g. ``ops_graph.chunk_stream``) attributes the failure to the
    ENCLOSING live :func:`watched_section` when one exists — so the
    same checkpoint reports ``exchange`` inside an exchange and
    ``ooc_pass`` inside an out-of-core pass — and to the generic
    non-retryable label ``"deadline"`` under a bare scope."""
    d = _SCOPE.get()
    exp = None if d is None else d.expires_at
    rec = _ACTIVE_SECTION.get()
    if rec is not None and rec.expires_at is not None:
        exp = rec.expires_at if exp is None \
            else min(exp, rec.expires_at)
    if exp is None:
        return
    now = time.monotonic()
    if now > exp:
        if section is None:
            section = rec.section if rec is not None else "deadline"
        else:
            _require_section(section)
        # report the enclosing section's true elapsed/budget when one
        # is live; bare-scope checkpoints can only report the overrun
        elapsed = now - rec.started if rec is not None else now - exp
        budget = rec.budget if rec is not None else None
        raise _exceeded(section, detail or "cooperative checkpoint",
                        elapsed, budget)
