"""The always-on query engine: one resident device, many tenants.

Port of ``cylon_tpu/serve/service.py`` on the port's catalog, plan cache,
watchdog, resilience and telemetry. Everything below
:mod:`cylon_tpu_torch.serve` is one-script-one-query; this module is the
front door — a long-lived :class:`ServeEngine` that admits concurrent
queries against shared resident tables and drives them to completion
over ONE resident :class:`~cylon_tpu_torch.context.CylonEnv`.

Design — an assembly of the port's subsystems:

* **Admission** (:mod:`cylon_tpu_torch.serve.admission`): a queue-depth
  cap rejects over-cap submits with a fast
  :class:`~cylon_tpu_torch.errors.ResourceExhausted`; every admitted
  request is stamped with an absolute SLO deadline (queue wait counts —
  the client-visible contract).

* **Scheduling**: each admitted request becomes a :class:`_QueryOp` —
  an :class:`cylon_tpu_torch.ops_graph.op.Op` whose ``progress()``
  advances the query one *step* — and ONE long-lived
  :class:`~cylon_tpu_torch.ops_graph.execution.RoundRobinExecution`
  (fair share, the default) or
  :class:`~cylon_tpu_torch.ops_graph.execution.PriorityExecution`
  (tenant weights) sweeps the live set on one scheduler thread. Query
  functions may be plain callables (one step) or **generator
  functions** (each ``yield`` is a step boundary) — a staged query
  yields after its dispatch phase, so while its kernels are queued on
  the card the scheduler already drives the next request's host-side
  phase. Every step runs on the scheduler thread's current stream, the
  device's default stream, where the tables built on the main thread
  were written (as ``watchdog.bounded`` keeps a section's work).

* **Per-request SLO** (:mod:`cylon_tpu_torch.watchdog`): every step runs
  under ``watchdog.deadline(remaining)`` inside a named
  ``serve_request`` :func:`~cylon_tpu_torch.watchdog.watched_section`;
  expired requests are refused *before* their next step runs.

* **Shared plan cache** (:func:`cylon_tpu_torch.plan.shared_compiled`):
  N clients submitting the same compiled query share one scale memo —
  later calls are ``plan.cache_hits``.

* **Per-tenant observability**: every step executes under
  :func:`cylon_tpu_torch.telemetry.tenant_scope`; request latency lands
  in ``serve.request_seconds{tenant=}`` (:meth:`ServeEngine.tenant_stats`),
  and each ticket carries an ANALYZE profile
  (:mod:`cylon_tpu_torch.telemetry.profile`).

* **Fault isolation**: a per-request
  :class:`~cylon_tpu_torch.resilience.FaultPlan` is installed only
  around that request's steps, and resident-table pins
  (:func:`cylon_tpu_torch.catalog.pin`) keep a concurrent ``drop`` from
  yanking a table out from under an in-flight query.

* **Durability** (:mod:`cylon_tpu_torch.serve.durability`): with a
  ``durable_dir``, every admitted request is journaled (fsynced
  write-ahead, BEFORE dispatch: ops enter the execution set only in
  ``_dispatch``, and every path to it calls ``_journal_admit`` first)
  and every registered table snapshots, so a hard-killed engine process
  recovers via :meth:`ServeEngine.recover`: resident tables restored on
  the env's device, journaled-but-incomplete **named** requests re-run
  exactly once. A sustained failure storm trips the admission circuit
  breaker instead of wedging the engine.

* **Coalescing + the versioned result cache**
  (:mod:`cylon_tpu_torch.serve.result_cache`): same-``(query
  fingerprint, table-version vector)`` requests dedup at admission — a
  completed result is served from the byte-budgeted cache
  (``serve.admitted{path="cache_hit"}``, invalidated by
  :func:`cylon_tpu_torch.catalog.append`), and requests identical to one
  already in flight attach to it as followers (``path="coalesced"``).

* **Graceful degradation** (:mod:`cylon_tpu_torch.fallback`): a request
  submitted with a ``fallback=`` spill path whose step dies with an
  allocation failure (``torch.cuda.OutOfMemoryError`` on the card)
  re-runs ONCE through that path instead of erroring — it retires DONE
  with ``degraded=true`` and the OOM report in its ANALYZE profile, and
  NEVER feeds the circuit breaker.

A result held by a ticket keeps its device memory alive for as long as
the ticket is reachable: the bounded rid -> ticket history
(:data:`RECENT_ENTRIES`), the idempotency map (:data:`IDEM_ENTRIES`) and
the result cache (:data:`RESULT_CACHE_BYTES`, 256 MiB by
:func:`~cylon_tpu_torch.serve.result_cache.value_nbytes`) all count;
:meth:`ServeEngine.close` lets go of all three. The JAX package reads
``CYLON_TPU_SERVE_PROFILE``, ``_COALESCE``, ``_IDEM_ENTRIES``,
``_RECENT_ENTRIES`` and ``_RESULT_CACHE_BYTES`` from the environment;
here they are the module constants
:data:`cylon_tpu_torch.telemetry.profile.PROFILING`, :data:`COALESCE`,
:data:`IDEM_ENTRIES`, :data:`RECENT_ENTRIES` and
:data:`RESULT_CACHE_BYTES`.
``CYLON_TPU_SERVE_HTTP_PORT`` still arms the ops endpoint
(:mod:`cylon_tpu_torch.serve.introspect`).
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
import weakref

from cylon_tpu_torch import catalog, plan, resilience, telemetry, watchdog
from cylon_tpu_torch.errors import (DeadlineExceeded, FailedPrecondition,
                                    InvalidArgument)
from cylon_tpu_torch.ops_graph.execution import (PriorityExecution,
                                                 RoundRobinExecution)
from cylon_tpu_torch.ops_graph.op import Op
from cylon_tpu_torch.serve import introspect
from cylon_tpu_torch.serve.admission import AdmissionController, ServePolicy
from cylon_tpu_torch.serve.result_cache import (DEFAULT_CACHE_BYTES,
                                                ResultCache,
                                                hook_on_append,
                                                version_vector)
from cylon_tpu_torch.serve.slo import SloTracker
from cylon_tpu_torch.telemetry import events as _events
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.telemetry import profile as _profile
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils import tracing

__all__ = ["QueryTicket", "ServeEngine", "COALESCE", "IDEM_ENTRIES",
           "RECENT_ENTRIES", "RESULT_CACHE_BYTES"]

#: request lifecycle states (QueryTicket.state)
QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"

#: micro-batched dispatch: identical in-flight requests attach to one
#: leader op (the JAX package's ``CYLON_TPU_SERVE_COALESCE``)
COALESCE = True
#: bound on the idempotency map: past it, retired keys evict oldest
#: finished first (``CYLON_TPU_SERVE_IDEM_ENTRIES`` there)
IDEM_ENTRIES = 65536
#: bound on the rid -> ticket history behind ``/profiles/<rid>``
#: (``CYLON_TPU_SERVE_RECENT_ENTRIES`` there)
RECENT_ENTRIES = 1024
#: the engine's result-cache budget in bytes, 0 switches the cache off
#: (``CYLON_TPU_SERVE_RESULT_CACHE_BYTES`` there)
RESULT_CACHE_BYTES = DEFAULT_CACHE_BYTES


class QueryTicket:
    """Handle for one admitted request, the client's future (port of
    ``cylon_tpu/serve/service.py`` ``QueryTicket``)."""

    def __init__(self, rid: int, tenant: str, priority: int,
                 slo: "float | None"):
        self.rid = rid
        self.tenant = tenant
        self.priority = priority
        self.slo = slo
        self.submitted = time.monotonic()
        #: absolute SLO expiry (monotonic); queue wait counts against
        #: the budget — the latency the CLIENT sees is the contract
        self.deadline_at = (None if slo is None
                            else self.submitted + float(slo))
        self.started: "float | None" = None
        self.finished: "float | None" = None
        self.state = QUEUED
        self.value = None
        self.error: "BaseException | None" = None
        #: did this request complete through the OOM→spill fallback?
        #: (set by the scheduler's degrade path; rides ``profile()``)
        self.degraded = False
        #: dedup attribution: ``leader``/``follower`` when this request
        #: coalesced with identical in-flight work (rides ``profile()``
        #: as the ``coalesced`` marker), True when it was served
        #: straight from the versioned result cache
        self.coalesced_role: "str | None" = None
        self.cache_hit = False
        #: ``{"fingerprint", "versions"}`` the result is cacheable
        #: under (set at retirement IFF the version vector was still
        #: current) — the fleet router's cross-engine cache key
        self.cache_key: "dict | None" = None
        #: fleet trace identity: the one id naming this
        #: request's whole causal chain — inherited from the router's
        #: HTTP headers, minted at direct submit when tracing is
        #: armed, None (zero cost) otherwise. A failover REPLAY keeps
        #: the original id, so the stitched timeline spans engines.
        self.trace_id: "str | None" = None
        self.parent_span = None
        self._event = threading.Event()
        #: ANALYZE profiler (telemetry.profile.RequestProfiler), set
        #: at admission unless profile.PROFILING is off
        self._profiler = None
        self._retired = False

    def remaining(self) -> "float | None":
        """Seconds of SLO budget left (None = unbounded)."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: "float | None" = None) -> bool:
        return self._event.wait(timeout)

    def profile(self) -> "dict | None":
        """The request's EXPLAIN ANALYZE profile
        (:data:`cylon_tpu_torch.telemetry.profile.REQUIRED_PROFILE_FIELDS`):
        per-stage walls, rows/bytes per operator, compile-vs-execute
        split, spill bytes, retries/faults and the device-memory peak
        — live (partial) while running, final once retired. None when
        profiling is off (``profile.PROFILING``)."""
        if self._profiler is None:
            return None
        prof = self._profiler.render(self)
        if isinstance(prof, dict):
            if self.coalesced_role is not None:
                prof["coalesced"] = self.coalesced_role
            if self.cache_hit:
                prof["cache_hit"] = True
        return prof

    def result(self, timeout: "float | None" = None):
        """Block for the result; re-raise the request's failure."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                f"result({timeout=}) timed out waiting on request "
                f"{self.rid} (tenant {self.tenant!r}, state "
                f"{self.state})", section="serve_request")
        if self.error is not None:
            raise self.error
        return self.value

    def __repr__(self):
        return (f"QueryTicket(rid={self.rid}, tenant={self.tenant!r}, "
                f"state={self.state})")


class _QueryOp(Op):
    """One admitted request as a schedulable op node (port of
    ``cylon_tpu/serve/service.py`` ``_QueryOp``).

    ``progress()`` advances the query by one step: for a generator
    function each ``yield`` delimits a step (``StopIteration.value`` is
    the result); a plain callable is a single step. Steps run under the
    request's tenant scope + remaining-SLO deadline + per-request fault
    plan + the ``serve_request`` watchdog section — all scoped to the
    step, so nothing leaks into the next op the schedule sweeps."""

    def __init__(self, op_id: int, engine: "ServeEngine",
                 ticket: QueryTicket, fn, args, kwargs,
                 fault_plan, pins: "list[str]", fallback=None):
        super().__init__(op_id, name=f"QueryOp[{ticket.tenant}]")
        self._engine = engine
        self.ticket = ticket
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._fault_plan = fault_plan
        self._pins = pins
        self._gen = None
        self._step = 0
        #: the request's spill path (zero-arg callable or generator
        #: fn): armed by submit(fallback=); consumed at most once
        self._fallback = fallback
        self._degraded = False

    def done(self) -> bool:
        return self.ticket.done

    def progress(self) -> bool:  # one scheduled step
        t = self.ticket
        if t.done:
            return False
        # liveness stamp at STEP granularity (not just sweep ends):
        # /health's scheduler-age probe must not read a long single
        # step mid-sweep as a wedged scheduler
        self._engine._last_sweep = time.monotonic()
        # followers never run steps, so the per-step SLO check above
        # cannot expire them — sweep the attached tickets here
        self._engine._expire_followers(self)
        try:
            rem = t.remaining()
            if rem is not None and rem <= 0:
                telemetry.counter("serve.expired", tenant=t.tenant).inc()
                raise DeadlineExceeded(
                    f"request {t.rid} (tenant {t.tenant!r}) missed its "
                    f"{t.slo:.3f}s SLO after {self._step} step(s)",
                    section="serve_request",
                    elapsed=time.monotonic() - t.submitted)
            self._run_step(rem)
        except BaseException as e:  # noqa: BLE001 - isolate per request
            if not self._maybe_degrade(e):
                self._engine._retire(self, error=e)
        finally:
            # the client-visible completion signal fires only AFTER
            # the step's profiler/forensics scopes have fully unwound:
            # a result() that returned implies the ANALYZE profile is
            # complete, not racing the scheduler's bookkeeping
            if t.state in (DONE, FAILED):
                t._event.set()
        return True

    def _maybe_degrade(self, e: BaseException) -> bool:
        """An OOM'd step with an armed ``fallback=`` degrades instead
        of erroring: the op swaps its query fn for the spill callable
        and stays LIVE — the next schedule sweep re-runs it through
        the degraded path under the same tenant scope, remaining SLO
        and profiler. Consumed at most once: a fallback that ALSO
        fails retires as a normal error (and only then can feed the
        circuit breaker — an OOM that ends in a successful degraded
        completion never does)."""
        t = self.ticket
        if (self._fallback is None or self._degraded
                or not _memory.is_oom(e)):
            return False
        self._degraded = True
        # NOTE: ticket.degraded + serve.degraded{tenant} are recorded
        # at SUCCESSFUL retirement (_retire), not here — "degraded"
        # means COMPLETED through the spill path; a fallback that also
        # fails retires as a plain error. The routing counter fires
        # now: the query IS being routed to the spill path, whether or
        # not its fallback callable goes through run_with_fallback.
        telemetry.counter("ooc.fallbacks", op="serve",
                          reason="oom").inc()
        with _trace.trace_context(t.trace_id, t.parent_span):
            # the degrade re-run keeps the SAME trace_id: one id names
            # admission, the OOM'd attempt AND the spill-path rerun
            _trace.instant("serve.degrade", cat="serve",
                           tenant=t.tenant, rid=t.rid,
                           error=type(e).__name__)
        _events.emit("degraded", tenant=t.tenant, rid=t.rid,
                     error=type(e).__name__)
        from cylon_tpu_torch.utils.logging import get_logger

        get_logger().warning(
            "request %d (tenant %r) exhausted memory (%s) — "
            "degrading through its spill fallback", t.rid, t.tenant,
            type(e).__name__)
        self._gen = None
        self._fn, self._args, self._kwargs = self._fallback, (), {}
        return True

    def _run_step(self, rem: "float | None") -> None:
        t = self.ticket
        if t.started is None:
            t.started = time.monotonic()
            t.state = RUNNING
            telemetry.timer("serve.queue_wait_seconds",
                            tenant=t.tenant).observe(
                                t.started - t.submitted)
        with contextlib.ExitStack() as stack:
            # ORDER matters: the tenant scope first (so every nested
            # metric/trace/section carries the label), then the SLO
            # budget, then the request's fault plan — scoped to this
            # step only, which is the whole isolation argument
            if t.trace_id is not None:
                # every span/instant the step records carries the
                # request's fleet trace id (None = unarmed: this
                # branch costs one attribute read, nothing else)
                stack.enter_context(_trace.trace_context(
                    t.trace_id, t.parent_span))
            stack.enter_context(telemetry.tenant_scope(t.tenant))
            if rem is not None:
                stack.enter_context(watchdog.deadline(
                    rem, label=f"serve:{t.rid}"))
            if self._fault_plan is not None:
                # context-LOCAL install (contextvar, not the process
                # global): a noisy tenant's plan is invisible to any
                # other thread reaching an injection point, and it
                # propagates into watchdog workers via copy_context
                stack.enter_context(resilience.scoped(self._fault_plan))
            stack.enter_context(tracing.span(
                "serve.step", cat="serve", rid=t.rid, step=self._step))
            stack.enter_context(watchdog.watched_section(
                "serve_request", detail=f"{t.tenant}/{t.rid}"
                f"#{self._step}"))
            if t._profiler is not None:
                # registry-delta + memory-sample bracket: the one-step-
                # at-a-time scheduler makes the delta THIS request's
                stack.enter_context(t._profiler.step())
            # allocation failures inside the step get the resident-
            # consumer forensics dump before the request fails
            stack.enter_context(_memory.forensics("serve_request"))
            self._step += 1
            if self._gen is None:
                first = self._fn(*self._args, **self._kwargs)
                if hasattr(first, "__next__"):  # generator query
                    self._gen = first
                else:  # plain callable: one step, done
                    self._engine._retire(self, value=first)
                    return
            try:
                next(self._gen)
            except StopIteration as fin:
                self._engine._retire(self, value=fin.value)


class ServeEngine:
    """The long-lived multi-tenant query service (module docstring; port
    of ``cylon_tpu/serve/service.py`` ``ServeEngine``).

    One engine per process and device is the intended shape; the env is
    resident for the engine's lifetime (None: the catalog's tables on
    their own devices, no env for the queries). Thread-safe: many
    client threads submit; ONE scheduler thread executes steps (the
    single-threaded progress model of the reference's parallel-op
    engine — concurrency comes from interleaving steps and from the
    card's asynchronous launches, not from racing host threads)."""

    _ids = itertools.count(1)

    def __init__(self, env=None, policy: "ServePolicy | None" = None,
                 durable_dir: "str | None" = None,
                 snapshot_dir: "str | None" = None):
        self._env = env
        self._admission = AdmissionController(policy)
        self._policy = self._admission.policy
        #: per-tenant SLO burn accounting — a no-op unless
        #: the policy sets slo_target (no windows allocated)
        self._slo = SloTracker(self._policy)
        self._started = time.monotonic()
        #: monotonic ts of the scheduler's last liveness stamp —
        #: refreshed at admission, loop wake-up, every op step, and
        #: sweep completion, so /health's age probe only grows while
        #: the scheduler is genuinely wedged inside one step (an idle
        #: engine or a freshly-admitted cold query never reads stalled)
        self._last_sweep: "float | None" = None
        if self._policy.schedule == "priority":
            self._exec = PriorityExecution()
        else:
            self._exec = RoundRobinExecution()
        self._cond = threading.Condition()
        self._thread: "threading.Thread | None" = None
        self._graph_users: weakref.WeakSet = weakref.WeakSet()
        self._closed = False
        self._op_ids = itertools.count(1)
        #: named-query registry: the replayable submission surface
        #: (recovery can only re-run what it can name)
        self._queries: "dict[str, object]" = {}
        #: idempotency-key -> ticket (live AND retired): a retried key
        #: returns the existing ticket instead of double-executing
        self._idem: "dict[str, QueryTicket]" = {}
        #: versioned result cache (byte-budgeted LRU, precise
        #: catalog.on_append invalidation) — the admission-time fast
        #: path that keeps hot queries off the card entirely
        self._result_cache = hook_on_append(ResultCache(
            RESULT_CACHE_BYTES, metric_prefix="serve"))
        #: (fingerprint, version-vector) -> live leader op: identical
        #: in-queue requests attach here as followers of ONE scheduler
        #: op instead of executing N times (under ``_cond``)
        self._coalesce: "dict[tuple, _QueryOp]" = {}
        self._journal = self._snapshot = None
        if durable_dir is not None:
            from cylon_tpu_torch.serve.durability import (CatalogSnapshot,
                                                          RequestJournal)

            # the journal acquires this engine's exclusive owner lock
            # (fleet fencing — a second live engine on the same dir
            # fails loudly); snapshot_dir lets a fleet share ONE
            # snapshot store while journals stay per-engine
            self._journal = RequestJournal(durable_dir)
            self._snapshot = CatalogSnapshot(snapshot_dir or durable_dir)
        #: measured query-cost history: executed walls
        #: keyed by (fingerprint, row bucket), persisted under the
        #: durable tree so explain()'s predicted_wall_s survives a
        #: restart and merges fleet-wide. Durable engines only — the
        #: same class of hot-path cost as the write-ahead journal.
        self._profile_history = None
        if durable_dir is not None:
            self._profile_history = _profile.ProfileHistory(
                os.path.join(durable_dir, _profile.HISTORY_FILE))
        self.durable_dir = durable_dir
        #: bounded rid -> ticket history (live AND retired): the
        #: lookup surface behind /profiles/<rid> and QueryTicket
        #: retrieval after the fact
        self._recent: "collections.OrderedDict[int, QueryTicket]" = \
            collections.OrderedDict()
        #: the ops-plane HTTP thread — armed ONLY by
        #: CYLON_TPU_SERVE_HTTP_PORT (None otherwise: no socket, no
        #: thread — the telemetry fast-path contract, pinned by test)
        self._http = introspect.maybe_start(self)

    # ------------------------------------------------- resident tables
    @property
    def env(self):
        return self._env

    def register_table(self, table_id: str, table) -> None:
        """Register a resident table (Table or DataFrame) in the
        process catalog under ``table_id`` — the shared store every
        request reads through (pin-protected; see
        :func:`cylon_tpu_torch.catalog.drop`). On a durable engine the
        table's host content also snapshots to ``durable_dir`` so
        :meth:`recover` can restore it after a kill."""
        t = getattr(table, "table", table)
        catalog.put_table(table_id, t)
        if self._snapshot is not None:
            self._snapshot.save(table_id, t, env=self._env,
                                generation=catalog.generation(table_id))

    def append_table(self, table_id: str, delta) -> dict:
        """Fold delta rows into a resident table under the catalog's
        atomic swap (:func:`cylon_tpu_torch.catalog.append`) — legal while
        the table is pinned (in-flight readers finish against the
        generation they started on). The merged table is rebuilt on the
        resident one's device from its host rows (the port's append
        runs through the host). On a durable engine the merged
        table re-snapshots WITH its new generation stamped into the
        snapshot map, so :meth:`recover` after the append restores the
        post-append generation instead of silently serving the stale
        one. Returns ``{"generation", "delta_rows", "rows"}``."""
        res = catalog.append(table_id, delta, env=self._env)
        if self._snapshot is not None:
            self._snapshot.save(table_id, catalog.get_table(table_id),
                                env=self._env,
                                generation=res["generation"])
        return res

    def drop_table(self, table_id: str) -> None:
        """Pin-respecting drop: raises
        :class:`~cylon_tpu_torch.errors.FailedPrecondition` naming the
        holders while any session/request still pins the table."""
        catalog.drop(table_id, if_exists=False)
        if self._snapshot is not None:
            self._snapshot.drop(table_id)

    def register_query(self, name: str, fn, fallback=None,
                       tables=()) -> None:
        """Name a query function for :meth:`submit_named` — the
        REPLAYABLE submission surface: only named queries (with
        JSON-able args) can be re-run by :meth:`recover`, because the
        journal can name them where it cannot serialize a closure.

        ``fallback`` (same signature as ``fn``) registers the query's
        spill path alongside it: every :meth:`submit_named` —
        INCLUDING a journal replay after :meth:`recover` — arms it
        automatically, so graceful degradation survives a crash (the
        journal can name the query but could never serialize a
        per-submit fallback closure).

        ``tables`` declares the query's READ SET (resident catalog
        ids): it is what makes the query coalescible and cacheable —
        the version vector half of the ``(fingerprint, versions)``
        dedup key is computed over exactly these tables (plus any
        per-submit pins), so an append to any of them invalidates the
        cached result precisely. A query registered WITHOUT tables has
        no versionable read set and is never deduped."""
        self._queries[str(name)] = (fn, fallback,
                                    tuple(str(t) for t in tables))

    def table_stats(self) -> dict:
        """Per-table rows/bytes/pins/version of the resident catalog
        (the ``version`` column carries the monotone generation +
        content digest the views subsystem keys on)."""
        return catalog.stats()

    # --------------------------------------------- materialized views
    def register_view(self, name: str, query_fn, refresh_plan: dict,
                      *, sources, delta_source: "str | None" = None,
                      limit=None):
        """Register an incremental materialized view over this
        engine's resident tables
        (:func:`cylon_tpu_torch.views.register_view`, bound to the
        engine's env)."""
        from cylon_tpu_torch import views

        return views.register_view(
            name, query_fn, refresh_plan, sources=sources,
            delta_source=delta_source, limit=limit, env=self._env)

    def refresh_view(self, name: str, *,
                     resume_dir: "str | None" = None,
                     full: bool = False) -> dict:
        """Bring a view up to date with its sources
        (:func:`cylon_tpu_torch.views.refresh`); ``resume_dir`` makes
        the refresh checkpointable across a kill."""
        from cylon_tpu_torch import views

        return views.refresh(name, resume_dir=resume_dir, full=full,
                             env=self._env)

    def read_view(self, name: str) -> dict:
        """Generation-consistent view read
        (:func:`cylon_tpu_torch.views.read`): the returned ``result`` is
        exactly the view at the returned ``generations`` — an append
        racing the read lands entirely before or entirely after it,
        never inside."""
        from cylon_tpu_torch import views

        return views.read(name, env=self._env)

    def view_stats(self) -> dict:
        """Per-view watermarks/digests/refresh counts
        (:func:`cylon_tpu_torch.views.stats`)."""
        from cylon_tpu_torch import views

        return views.stats(env=self._env)

    def session(self, tenant: str, priority: int = 1, tables=()):
        """Open a :class:`cylon_tpu_torch.serve.session.Session` bound
        to this engine (pins ``tables`` for the session's lifetime)."""
        from cylon_tpu_torch.serve.session import Session

        return Session(self, tenant, priority=priority, tables=tables)

    # ------------------------------------------------------ submission
    def submit(self, fn, *args, tenant: str = "default",
               priority: int = 1, slo: "float | None" = None,
               tables=(), fault_plan=None,
               idempotency_key: "str | None" = None,
               fallback=None, predicted_bytes: "int | None" = None,
               _journal_name: "str | None" = None,
               _fingerprint: "str | None" = None,
               _read_tables=None,
               _trace_id: "str | None" = None,
               _parent_span=None,
               **kwargs) -> QueryTicket:
        """Admit one query for scheduled execution.

        ``fn(*args, **kwargs)`` runs on the scheduler thread — a plain
        callable is one step; a generator function advances one step
        per schedule sweep (its ``return`` value is the result).
        ``slo=None`` takes the engine default (the policy's
        ``default_slo``); ``slo <= 0`` explicitly unbounds the
        request. ``tables`` are catalog ids pinned for the request's
        lifetime. ``fault_plan`` (tests/chaos drills) is installed only
        around this request's steps. ``idempotency_key`` dedups: a key
        the engine has already seen (live or retired) returns the
        EXISTING ticket — the same request is never executed twice, so
        a client retrying after a lost answer (or a recovery replaying
        the journal) is safe. ``fallback`` (a zero-arg callable or
        generator fn — e.g. ``lambda:
        cylon_tpu_torch.fallback.tpch_fallback("q3", data)``) arms the
        degrade path: a step that dies with an allocation failure
        re-runs ONCE through it instead of erroring (``degraded=true``
        in the profile, ``serve.degraded{tenant}``, breaker untouched).
        ``predicted_bytes`` feeds memory-aware admission: when it
        exceeds the policy's ``memory_budget`` the submit sheds
        immediately (``serve.shed{reason="memory"}``). Raises
        :class:`~cylon_tpu_torch.errors.ResourceExhausted` immediately when
        the live-request cap is hit, the memory budget is exceeded, or
        the circuit breaker is open."""
        if self._closed:
            raise InvalidArgument("engine is closed")
        key = idempotency_key
        if key is not None:
            with self._cond:
                existing = self._idem.get(key)
            if existing is not None:
                telemetry.counter("serve.idempotent_hits",
                                  tenant=tenant).inc()
                return existing
        # fleet trace identity: adopt the propagated id
        # (router → gateway headers → here), else the ambient context,
        # else mint at this outermost entry — ONLY when tracing is
        # armed. Unarmed: one env read, trace_id stays None and every
        # downstream trace hook short-circuits on that None.
        if _trace_id is None and _trace.enabled():
            _trace_id = _trace.current_trace_id() or _trace.new_trace_id()
            if _parent_span is None:
                _parent_span = _trace.current_parent_span()
        # journal the PRE-normalization slo: an explicit slo<=0
        # ("unbounded") must replay unbounded, not pick up the engine
        # default the way a None would
        slo_raw = slo
        if slo is None:
            slo = self._policy.default_slo
        elif slo <= 0:
            slo = None
        # the two-level dedup (fingerprinted submits only — bare
        # callables have no stable identity): a completed result under
        # this exact (fingerprint, table-version vector) is served
        # straight from the cache; failing that, identical in-flight
        # work adopts this request as a follower. Both paths bypass
        # the scheduler entirely.
        fp, vv = _fingerprint, None
        if fp is not None and (self._result_cache.enabled
                               or self._coalesce_on()):
            vv = version_vector(_read_tables)
        if vv is not None and self._result_cache.enabled:
            hit, cached = self._result_cache.lookup(fp, vv)
            if hit:
                return self._admit_cache_hit(
                    cached, fp, vv, tenant=tenant, priority=priority,
                    slo=slo, slo_raw=slo_raw, key=key,
                    journal_name=_journal_name, args=args,
                    kwargs=kwargs, tables=tables,
                    trace_id=_trace_id, parent_span=_parent_span)
        if vv is not None and self._coalesce_on():
            follower = self._maybe_attach_follower(
                fp, vv, fn=fn, args=args, kwargs=kwargs,
                tenant=tenant, priority=priority, slo=slo,
                slo_raw=slo_raw, key=key, tables=tables,
                fault_plan=fault_plan, fallback=fallback,
                journal_name=_journal_name, trace_id=_trace_id,
                parent_span=_parent_span)
            if follower is not None:
                return follower
        # may raise ResourceExhausted (queue cap, breaker, or the
        # memory-aware predicted-bytes shed)
        self._admission.admit(tenant, predicted_bytes=predicted_bytes)
        ticket = QueryTicket(next(self._ids), str(tenant),
                             int(priority), slo)
        ticket.trace_id, ticket.parent_span = _trace_id, _parent_span
        if _profile.profiling_enabled():
            ticket._profiler = _profile.RequestProfiler()
        holder = f"{tenant}/req{ticket.rid}"
        pinned: list[str] = []
        try:
            for tid in tables:
                catalog.pin(tid, holder=holder)
                pinned.append(tid)
        except Exception:
            for tid in pinned:
                catalog.unpin(tid, holder=holder)
            self._admission.release()
            raise
        op = _QueryOp(next(self._op_ids), self, ticket, fn, args,
                      kwargs, fault_plan, pinned, fallback=fallback)
        op._holder = holder
        op._idem_key = key
        # dedup bookkeeping: a fingerprinted op is the (potential)
        # leader of its (fp, vv) coalesce group and publishes its
        # result to the cache at retirement; followers re-run through
        # _requeue_follower if it fails, which needs the journal name
        op._fp, op._vv = fp, vv
        op._followers = []
        op._coalesce_closed = False
        op._admitted = True
        if key is not None:
            with self._cond:
                existing = self._idem.get(key)
                if existing is not None:  # lost a submit race: undo
                    self._undo_admission(op)
                    telemetry.counter("serve.idempotent_hits",
                                      tenant=tenant).inc()
                    return existing
                self._idem[key] = ticket
                self._evict_idem_locked()
        telemetry.counter("serve.requests", tenant=ticket.tenant).inc()
        telemetry.counter("serve.admitted", path="executed",
                          tenant=ticket.tenant).inc()
        with _trace.trace_context(_trace_id, _parent_span):
            _trace.instant("serve.admit", cat="serve",
                           tenant=ticket.tenant, rid=ticket.rid,
                           slo=slo)
        _events.emit("admit", tenant=ticket.tenant, rid=ticket.rid,
                     slo=slo, path="executed")
        # WRITE-AHEAD: the journal records the admission durably BEFORE
        # the scheduler can touch it — a kill at any later instant
        # leaves the request recoverable (bench-guard lints this order).
        # A journal that cannot be written fails the submit CLEANLY
        # (slot/pins/key released): accepting an unjournalable request
        # would silently void the recovery contract.
        try:
            self._journal_admit(ticket, _journal_name, args, kwargs,
                                key, slo_raw, tables)
        except BaseException:
            with self._cond:
                self._undo_admission(op)
            raise
        with self._cond:
            self._record_recent_locked(ticket)
        self._dispatch(op, ticket)
        return ticket

    def _undo_admission(self, op: "_QueryOp") -> None:
        """Roll back an admission that never reached the scheduler:
        release pins + the admission slot + the idempotency entry.
        Caller holds ``self._cond``."""
        for tid in op._pins:
            try:
                catalog.unpin(tid, holder=op._holder)
            except Exception:  # pragma: no cover - unpin best-effort
                pass
        if getattr(op, "_admitted", True):
            # a requeued follower never took an admission slot; undoing
            # it must not release one it doesn't hold
            self._admission.release()
        if op._idem_key is not None and \
                self._idem.get(op._idem_key) is op.ticket:
            self._idem.pop(op._idem_key, None)

    def _evict_idem_locked(self) -> None:
        """Bound the idempotency map (always-on engines would otherwise
        grow it — and every retained result — forever): past the cap,
        drop retired entries OLDEST-RETIRED-FIRST (by finish time), so
        a recently completed ticket's result survives the bound
        instead of being dropped in arbitrary dict-insertion order;
        live tickets are never evicted. Caller holds ``self._cond``.
        An evicted key loses its dedup guarantee, which is why the cap
        (:data:`IDEM_ENTRIES`) is generous."""
        cap = IDEM_ENTRIES
        if cap <= 0 or len(self._idem) <= cap:
            return
        retired = sorted(
            ((t.finished if t.finished is not None else 0.0, k)
             for k, t in self._idem.items() if t.done))
        for _finished, k in retired:
            if len(self._idem) <= cap:
                break
            del self._idem[k]

    # ------------------------------------------------ dedup fast paths
    @staticmethod
    def _coalesce_on() -> bool:
        """Micro-batched dispatch (:data:`COALESCE`, read per call)."""
        return bool(COALESCE)

    def _record_recent_locked(self, ticket: QueryTicket) -> None:
        """Bounded rid->ticket history insert (caller holds
        ``_cond``): the /profiles + ticket() lookup surface,
        oldest-first eviction past :data:`RECENT_ENTRIES`."""
        self._recent[ticket.rid] = ticket
        cap = RECENT_ENTRIES
        while cap > 0 and len(self._recent) > cap:
            self._recent.popitem(last=False)

    def _admit_cache_hit(self, value, fp, vv, *, tenant, priority,
                         slo, slo_raw, key, journal_name, args,
                         kwargs, tables, trace_id=None,
                         parent_span=None) -> QueryTicket:
        """Serve one admission straight from the versioned result
        cache: the ticket retires DONE before submit() returns — no
        admission slot, no scheduler op, no device work. The request is
        still journaled (admit line THEN an immediate done line) so a
        :meth:`recover` after a kill never replays an answer the
        client already has. Cache hits never feed the circuit breaker
        and never observe ``serve.queue_wait_seconds`` — they never
        queued; they count
        ``serve.admitted{path="cache_hit"}``."""
        ticket = QueryTicket(next(self._ids), str(tenant),
                             int(priority), slo)
        ticket.cache_hit = True
        ticket.trace_id, ticket.parent_span = trace_id, parent_span
        ticket.cache_key = {"fingerprint": fp,
                            "versions": [list(v) for v in vv]}
        if _profile.profiling_enabled():
            ticket._profiler = _profile.RequestProfiler()
        if key is not None:
            with self._cond:
                existing = self._idem.get(key)
                if existing is not None:  # lost a submit race
                    telemetry.counter("serve.idempotent_hits",
                                      tenant=tenant).inc()
                    return existing
                self._idem[key] = ticket
                self._evict_idem_locked()
        telemetry.counter("serve.requests", tenant=ticket.tenant).inc()
        telemetry.counter("serve.admitted", path="cache_hit",
                          tenant=ticket.tenant).inc()
        with _trace.trace_context(trace_id, parent_span):
            # the short-circuit is part of the request's causal chain:
            # its admit/done instants carry the propagated trace_id
            _trace.instant("serve.admit", cat="serve",
                           tenant=ticket.tenant, rid=ticket.rid,
                           slo=slo)
        _events.emit("admit", tenant=ticket.tenant, rid=ticket.rid,
                     slo=slo, path="cache_hit")
        _events.emit("cache_hit", tenant=ticket.tenant,
                     rid=ticket.rid, fingerprint=fp)
        try:
            self._journal_admit(ticket, journal_name, args, kwargs,
                                key, slo_raw, tables)
        except BaseException:
            with self._cond:
                if key is not None and \
                        self._idem.get(key) is ticket:
                    self._idem.pop(key, None)
            raise
        with self._cond:
            self._record_recent_locked(ticket)
        self._finish_ticket(ticket, value=value, idem_key=key)
        return ticket

    def _maybe_attach_follower(self, fp, vv, *, fn, args, kwargs,
                               tenant, priority, slo, slo_raw, key,
                               tables, fault_plan, fallback,
                               journal_name, trace_id=None,
                               parent_span=None
                               ) -> "QueryTicket | None":
        """Micro-batched dispatch: if an identical ``(fp, vv)`` op is
        already in the queue, attach this request to it as a FOLLOWER
        — its own ticket (tenant label, SLO deadline, journal entry,
        profile marked ``coalesced: follower``) but no scheduler op
        and no admission slot: the leader's one execution fans back to
        every attached ticket at retirement. Returns None when there
        is no open leader (the caller proceeds down the normal
        admission path and becomes one)."""
        with self._cond:
            leader = self._coalesce.get((fp, vv))
            if (leader is None or leader._coalesce_closed
                    or leader.ticket.done):
                return None
            ticket = QueryTicket(next(self._ids), str(tenant),
                                 int(priority), slo)
            ticket.coalesced_role = "follower"
            ticket.trace_id, ticket.parent_span = trace_id, parent_span
            if _profile.profiling_enabled():
                ticket._profiler = _profile.RequestProfiler()
            holder = f"{tenant}/req{ticket.rid}"
            pinned: list = []
            try:
                for tid in tables:
                    catalog.pin(tid, holder=holder)
                    pinned.append(tid)
            except Exception:
                for tid in pinned:
                    catalog.unpin(tid, holder=holder)
                raise
            if key is not None:
                existing = self._idem.get(key)
                if existing is not None:  # lost a submit race
                    for tid in pinned:
                        catalog.unpin(tid, holder=holder)
                    telemetry.counter("serve.idempotent_hits",
                                      tenant=tenant).inc()
                    return existing
                self._idem[key] = ticket
                self._evict_idem_locked()
            leader.ticket.coalesced_role = "leader"
            telemetry.counter("serve.requests",
                              tenant=ticket.tenant).inc()
            telemetry.counter("serve.admitted", path="coalesced",
                              tenant=ticket.tenant).inc()
            telemetry.counter("serve.coalesced",
                              tenant=ticket.tenant).inc()
            with _trace.trace_context(trace_id, parent_span):
                _trace.instant("serve.admit", cat="serve",
                               tenant=ticket.tenant, rid=ticket.rid,
                               slo=slo)
            _events.emit("admit", tenant=ticket.tenant,
                         rid=ticket.rid, slo=slo, path="coalesced")
            _events.emit("coalesced", tenant=ticket.tenant,
                         rid=ticket.rid,
                         leader_rid=leader.ticket.rid)
            # WRITE-AHEAD: the follower journals its OWN admit line
            # before it can be answered — recover() after a kill
            # replays it independently of the leader's fate
            try:
                self._journal_admit(ticket, journal_name, args,
                                    kwargs, key, slo_raw, tables)
            except BaseException:
                for tid in pinned:
                    catalog.unpin(tid, holder=holder)
                if key is not None and self._idem.get(key) is ticket:
                    self._idem.pop(key, None)
                raise
            leader._followers.append({
                "ticket": ticket, "key": key, "fn": fn, "args": args,
                "kwargs": kwargs, "fault_plan": fault_plan,
                "fallback": fallback, "pins": pinned,
                "holder": holder, "name": journal_name,
                "slo_raw": slo_raw, "tables": tables, "fp": fp,
                "vv": vv})
            self._record_recent_locked(ticket)
            return ticket

    def _expire_followers(self, op: "_QueryOp") -> None:
        """Retire attached followers whose SLO budget ran out
        mid-flight (the scheduler's per-step expiry check cannot see
        them — they have no op). Counted ``serve.expired`` like any
        expiry, but NEVER fed to the circuit breaker: a coalesced
        ticket did no work that could indicate engine distress."""
        if not getattr(op, "_followers", None):
            return
        expired: list = []
        with self._cond:
            keep = []
            for rec in op._followers:
                rem = rec["ticket"].remaining()
                (expired if rem is not None and rem <= 0
                 else keep).append(rec)
            op._followers = keep
        for rec in expired:
            t = rec["ticket"]
            telemetry.counter("serve.expired", tenant=t.tenant).inc()
            self._finish_ticket(
                t, error=DeadlineExceeded(
                    f"coalesced request {t.rid} (tenant {t.tenant!r}) "
                    f"missed its {t.slo:.3f}s SLO while attached to "
                    f"leader {op.ticket.rid}", section="serve_request"),
                idem_key=rec["key"], pins=rec["pins"],
                holder=rec["holder"])

    def _fanout_follower(self, rec: dict, value) -> None:
        """Deliver the leader's result to one attached follower (or
        expire it, if its deadline passed between the last step and
        retirement — a stale answer is still a missed SLO)."""
        t = rec["ticket"]
        rem = t.remaining()
        if rem is not None and rem <= 0:
            telemetry.counter("serve.expired", tenant=t.tenant).inc()
            self._finish_ticket(
                t, error=DeadlineExceeded(
                    f"coalesced request {t.rid} (tenant {t.tenant!r}) "
                    f"missed its {t.slo:.3f}s SLO awaiting its "
                    "leader's result", section="serve_request"),
                idem_key=rec["key"], pins=rec["pins"],
                holder=rec["holder"])
            return
        self._finish_ticket(t, value=value, idem_key=rec["key"],
                            pins=rec["pins"], holder=rec["holder"])

    def _requeue_follower(self, rec: dict) -> None:
        """The leader FAILED but this follower still has SLO budget:
        re-run it as its own scheduler op (a leader failure fails only
        the tickets that cannot re-run within SLO). The write-ahead
        invariant holds here like every submission path: the re-run
        journals a fresh admit line BEFORE ``_dispatch`` (the journal
        dedups by key/rid, so the replay stays exactly-once)."""
        t = rec["ticket"]
        op = _QueryOp(next(self._op_ids), self, t, rec["fn"],
                      rec["args"], rec["kwargs"], rec["fault_plan"],
                      rec["pins"], fallback=rec["fallback"])
        op._holder = rec["holder"]
        op._idem_key = rec["key"]
        op._fp, op._vv = rec["fp"], rec["vv"]
        op._followers = []
        op._coalesce_closed = False
        #: no admission slot was ever taken for a follower — its
        #: retirement must not release one
        op._admitted = False
        try:
            self._journal_admit(t, rec["name"], rec["args"],
                                rec["kwargs"], rec["key"],
                                rec["slo_raw"], rec["tables"])
            self._dispatch(op, t)
        except BaseException as e:  # noqa: BLE001 - fail THIS ticket
            self._finish_ticket(t, error=e, idem_key=rec["key"],
                                pins=rec["pins"],
                                holder=rec["holder"])

    def _finish_ticket(self, ticket: QueryTicket, value=None,
                       error: "BaseException | None" = None, *,
                       idem_key: "str | None" = None, pins=(),
                       holder: "str | None" = None,
                       release_slot: bool = False,
                       feed_breaker: bool = False,
                       set_event: bool = True) -> None:
        """Shared retirement bookkeeping: outcome + latency + SLO
        accounting, journal done line, pin/slot release, waiter
        wake-up. Cache hits and coalesced followers retire through
        this directly (no slot, no breaker feed — they never ran);
        :meth:`_retire` routes executed ops through it with
        ``release_slot``/``feed_breaker`` armed."""
        t = ticket
        if getattr(t, "_retired", False):
            return
        t._retired = True
        t.finished = time.monotonic()
        wall = t.finished - t.submitted
        if error is None:
            t.state, t.value = DONE, value
            telemetry.counter("serve.completed", tenant=t.tenant).inc()
            if feed_breaker:
                self._admission.breaker.record_success()
        else:
            t.state, t.error = FAILED, error
            telemetry.counter("serve.errors", tenant=t.tenant,
                              kind=type(error).__name__).inc()
            if feed_breaker:
                # dedup'd retirements never reach here with
                # feed_breaker: a cache/coalesce failure says nothing
                # about engine health
                self._admission.breaker.record_failure(
                    type(error).__name__)
        self._slo.record(t.tenant, ok=error is None, latency_s=wall)
        _events.emit("retire", tenant=t.tenant, rid=t.rid,
                     state=t.state, wall_s=round(wall, 6),
                     error=type(error).__name__ if error else None)
        if self._journal is not None:
            try:
                self._journal.done(rid=t.rid, key=idem_key,
                                   state=t.state)
            except OSError:  # pragma: no cover - journal best-effort
                pass  # a full disk must not wedge retirement
            except FailedPrecondition as e:
                # journal FENCED mid-flight: a router declared this
                # engine dead and is replaying its journal on a peer.
                # The retirement still completes locally (the client
                # holding this ticket gets its answer) but the done
                # line must NOT race the replay — log loudly instead.
                from cylon_tpu_torch.utils.logging import get_logger

                get_logger().error(
                    "request %d retired but its journal is fenced "
                    "(%s); a fleet router has failed this engine over",
                    t.rid, e)
        telemetry.timer("serve.request_seconds",
                        tenant=t.tenant).observe(wall)
        with _trace.trace_context(t.trace_id, t.parent_span):
            _trace.instant(
                "serve.done" if error is None else "serve.error",
                cat="serve", tenant=t.tenant, rid=t.rid, wall=wall,
                error=type(error).__name__ if error else None)
        for tid in pins:
            try:
                catalog.unpin(tid, holder=holder)
            except Exception:  # pragma: no cover - unpin best-effort
                pass
        if release_slot:
            self._admission.release()
        if set_event:
            t._event.set()

    #: submit()'s control keywords — everything else in a
    #: submit_named(**kwargs) belongs to the query function itself
    #: (and therefore to its registered fallback's signature too)
    _CONTROL_KW = frozenset({
        "tenant", "priority", "slo", "tables", "fault_plan",
        "idempotency_key", "fallback", "predicted_bytes",
        # propagated fleet trace context (gateway → submit_named →
        # submit): underscore-prefixed so no query kwarg can collide,
        # excluded here so the fingerprint stays trace-independent
        "_trace_id", "_parent_span"})

    def submit_named(self, name: str, *args,
                     idempotency_key: "str | None" = None,
                     **kwargs) -> QueryTicket:
        """Submit a query registered via :meth:`register_query` — the
        durable submission surface: the journal records the NAME plus
        JSON-able args, so :meth:`recover` can re-run the request in a
        fresh process. Accepts every :meth:`submit` keyword
        (tenant/priority/slo/tables/fault_plan/fallback/
        predicted_bytes); when the registry carries a fallback for
        ``name`` and the caller passes none, it is armed with this
        request's query arguments — so a journal REPLAY keeps the
        degrade path its original submit had."""
        entry = self._queries.get(str(name))
        if entry is None:
            raise InvalidArgument(
                f"no query registered under {name!r}; "
                f"register_query() it first (known: "
                f"{sorted(self._queries)})")
        fn, reg_fb, reg_tables = entry
        qkw = {k: v for k, v in kwargs.items()
               if k not in self._CONTROL_KW}
        # "fallback" ABSENT arms the registry's; an explicit
        # fallback=None is a per-request opt-out of degradation
        if reg_fb is not None and "fallback" not in kwargs:
            kwargs["fallback"] = functools.partial(reg_fb, *args, **qkw)
        # the dedup identity: the stable fingerprint over name + query
        # args (None for non-JSON-able args — no stable identity, no
        # dedup) plus the read set the version vector is computed over
        read = set(reg_tables) | {str(t) for t in kwargs.get("tables",
                                                             ())}
        fp = (plan.query_fingerprint(name, args, qkw)
              if read else None)
        return self.submit(fn, *args, idempotency_key=idempotency_key,
                           _journal_name=str(name), _fingerprint=fp,
                           _read_tables=tuple(sorted(read)), **kwargs)

    def _journal_admit(self, ticket: QueryTicket,
                       name: "str | None", args, kwargs,
                       key: "str | None", slo_raw, tables) -> None:
        """No-op unless durable (see :class:`RequestJournal`).
        ``slo_raw`` is the caller's pre-normalization slo argument, so
        an explicit 0 ("unbounded") survives a replay as 0."""
        if self._journal is None:
            return
        self._journal.admit(
            rid=ticket.rid, key=key, name=name, args=args,
            kwargs=kwargs, tenant=ticket.tenant,
            priority=ticket.priority, slo=slo_raw,
            tables=list(tables), trace_id=ticket.trace_id)

    def _dispatch(self, op: "_QueryOp", ticket: QueryTicket) -> None:
        """Hand one admitted (and, if durable, journaled) request to
        the scheduler. The ONLY place ops enter the execution set —
        the bench guard pins that statically, so no future submission
        path can skip the write-ahead journal."""
        with self._cond:
            if self._closed:  # lost a race with close(): undo and refuse
                self._undo_admission(op)
                raise InvalidArgument("engine is closed")
            # reset the scheduler-age clock at admission: after an
            # idle gap _last_sweep is stale by construction (the loop
            # was parked in cond.wait), and /health polled before the
            # first post-idle sweep must not read that as a stall
            self._last_sweep = time.monotonic()
            if (self._coalesce_on()
                    and getattr(op, "_fp", None) is not None
                    and getattr(op, "_vv", None) is not None):
                # open the coalesce window: identical (fingerprint,
                # version-vector) submissions attach to this op as
                # followers until it retires. setdefault — an already
                # open leader for the key keeps the window
                self._coalesce.setdefault((op._fp, op._vv), op)
            if self._policy.schedule == "priority":
                self._exec.add_op(op, ticket.priority)
            else:
                self._exec.add_op(op)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="cylon-serve-scheduler",
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()

    # ------------------------------------------------- scheduler loop
    def _loop(self) -> None:
        # the compiled queries that capture a graph for this engine's
        # requests, let go of at close()
        plan.own_graphs(self._graph_users)
        while True:
            with self._cond:
                while not self._exec.ops and not self._closed:
                    self._cond.wait()
                if self._closed and not self._exec.ops:
                    return
                self._last_sweep = time.monotonic()  # awake, sweeping
            # one fair-share / weighted sweep over every live query:
            # each op advances one step (or `priority` steps), so
            # requests interleave at step granularity
            self._exec.progress()
            self._last_sweep = time.monotonic()
            with self._cond:
                for op in [o for o in self._exec.ops if o.done()]:
                    self._exec.remove_op(op)

    def _retire(self, op: _QueryOp, value=None,
                error: "BaseException | None" = None) -> None:
        """Finish one request: record outcome + latency, release pins
        and the admission slot, wake waiters; then settle the op's
        coalesced followers and (on success) publish the result into
        the versioned cache. Runs on the scheduler thread (once per
        request — ops retire exactly once)."""
        t = op.ticket
        if getattr(t, "_retired", False):
            # a request that retired successfully can still raise on
            # scope exit (a deadline verdict from watched_section);
            # the first retirement's outcome stands
            return
        fp = getattr(op, "_fp", None)
        vv = getattr(op, "_vv", None)
        followers: "list[dict]" = []
        if fp is not None and vv is not None:
            with self._cond:
                # close the coalesce window FIRST: a submit racing
                # this retirement must become a fresh leader (or a
                # cache hit), never attach to an op that will no
                # longer sweep
                op._coalesce_closed = True
                if self._coalesce.get((fp, vv)) is op:
                    self._coalesce.pop((fp, vv), None)
                followers = list(getattr(op, "_followers", ()))
                op._followers = []
        if error is None and getattr(op, "_degraded", False):
            # the degrade COMPLETED: this is the moment the
            # request earns degraded=true and the tenant counter
            t.degraded = True
            telemetry.counter("serve.degraded", tenant=t.tenant).inc()
        # executed retirements feed the breaker and release the slot
        # they took at admission (re-queued followers took none); the
        # waiter event is set by _QueryOp.progress() after the step
        # scopes unwind (see there) — not here, which runs inside them
        self._finish_ticket(
            t, value=value, error=error,
            idem_key=getattr(op, "_idem_key", None), pins=op._pins,
            holder=getattr(op, "_holder", None),
            release_slot=getattr(op, "_admitted", True),
            feed_breaker=True, set_event=False)
        if error is None:
            ck = None
            if fp is not None and vv is not None \
                    and self._result_cache.enabled:
                # store-at-retirement staleness guard: only publish
                # if the read set is STILL at the admitted versions —
                # an append that landed mid-flight makes this result
                # answer data that no longer exists
                cur = version_vector([tid for tid, _g, _d in vv])
                if cur == vv:
                    self._result_cache.store(fp, vv, value)
                    ck = {"fingerprint": fp,
                          "versions": [list(v) for v in vv]}
                    t.cache_key = ck
            for rec in followers:
                if ck is not None:
                    # the router learns (fp, vv) from whichever
                    # ticket it polled — followers advertise the
                    # SAME publishable key as their leader
                    rec["ticket"].cache_key = ck
                self._fanout_follower(rec, value)
            if followers:
                # one leader execution just answered N+1 tickets —
                # the micro-batch itself, journaled
                _events.emit(
                    "batch_retire", tenant=t.tenant, rid=t.rid,
                    followers=len(followers),
                    wall_s=round(t.finished - t.submitted, 6))
            self._record_profile_history(op, t)
        else:
            # leader failed: followers with SLO budget left re-run as
            # their own ops; the rest fail cleanly (never silently)
            for rec in followers:
                rem = rec["ticket"].remaining()
                if rem is None or rem > 0:
                    self._requeue_follower(rec)
                else:
                    t2 = rec["ticket"]
                    telemetry.counter("serve.expired",
                                      tenant=t2.tenant).inc()
                    self._finish_ticket(
                        t2, error=error, idem_key=rec["key"],
                        pins=rec["pins"], holder=rec["holder"])

    def _record_profile_history(self, op: "_QueryOp",
                                t: QueryTicket) -> None:
        """Persist one executed retirement into the measured cost
        history: (fingerprint, pow2 row bucket) -> execution wall.
        Runs on the scheduler thread after the request completed (the
        row read is one host fetch for all the inputs).
        Unfingerprinted or non-durable: no-op."""
        fp = getattr(op, "_fp", None)
        hist = self._profile_history
        if hist is None or fp is None:
            return
        bucket = None
        try:
            # the SAME derivation explain() uses for its lookup key:
            # pow2 bucket of the largest input table's true rows
            from cylon_tpu_torch.parallel.dist_ops import batched_true_rows
            from cylon_tpu_torch.plan import _result_tables
            from cylon_tpu_torch.utils import pow2_bucket

            tbls = [t for t, _env in _result_tables((list(op._args),
                                                     dict(op._kwargs)))]
            if tbls:
                bucket = pow2_bucket(max(batched_true_rows(tbls)))
        except Exception:  # pragma: no cover - bucket best-effort
            bucket = None
        started = t.started if t.started is not None else t.submitted
        wall = max((t.finished or started) - started, 0.0)
        hist.record(fp, bucket, wall, path="executed",
                    degraded=t.degraded)

    def explain_named(self, name: str, *args, **kwargs) -> dict:
        """EXPLAIN a registered query with this engine's measured
        profile history attached: the :func:`explain` plan plus
        ``cost_estimate.predicted_wall_s`` — the median wall previous
        executions of the same (fingerprint, row bucket) actually
        took (None until the history has samples, or on a
        non-durable engine)."""
        entry = self._queries.get(str(name))
        if entry is None:
            raise InvalidArgument(
                f"no query registered under {name!r}; "
                f"register_query() it first (known: "
                f"{sorted(self._queries)})")
        fn, _fb, reg_tables = entry
        qkw = {k: v for k, v in kwargs.items()
               if k not in self._CONTROL_KW}
        read = set(reg_tables) | {str(t) for t in
                                  kwargs.get("tables", ())}
        fp = (plan.query_fingerprint(name, args, qkw)
              if read else None)
        return _profile.explain(fn, *args,
                                _history=self._profile_history,
                                _fingerprint=fp, **qkw)

    @property
    def profile_history(self) -> "_profile.ProfileHistory | None":
        """The engine's measured cost history (None when not
        durable) — :func:`cylon_tpu_torch.telemetry.profile.merged_history`
        folds every fleet member's into one estimator."""
        return self._profile_history

    # ------------------------------------------------------- reporting
    @property
    def live(self) -> int:
        """Live (queued + running) request count."""
        return self._admission.live

    @property
    def closing(self) -> bool:
        """True once :meth:`close` has committed to shutting down
        (``_closed`` published — admission refused, drain under way or
        done): the public flag the introspection endpoints turn into a
        clean 503 ``{"status": "closing"}`` instead of racing the
        teardown."""
        return self._closed

    @property
    def http_address(self) -> "tuple[str, int] | None":
        """(host, port) of the introspection endpoint, or None when
        ``CYLON_TPU_SERVE_HTTP_PORT`` is unarmed."""
        return None if self._http is None else self._http.address

    def ticket(self, rid: int) -> "QueryTicket | None":
        """Look up a recent (live or retired) request by rid — the
        ``/profiles/<rid>`` surface. None once evicted from the
        bounded history (:data:`RECENT_ENTRIES`)."""
        with self._cond:
            return self._recent.get(int(rid))

    def queries(self) -> "list[dict]":
        """In-flight request inventory (the ``/queries`` payload):
        rid, tenant, state, priority, elapsed, queue wait, remaining
        SLO budget and step count per live request."""
        with self._cond:
            ops = list(self._exec.ops)
        now = time.monotonic()
        out = []
        for op in ops:
            t = op.ticket
            out.append({
                "rid": t.rid,
                "tenant": t.tenant,
                "state": t.state,
                "priority": t.priority,
                "elapsed_s": now - t.submitted,
                "queue_wait_s": (t.started or now) - t.submitted,
                "remaining_slo_s": t.remaining(),
                "steps": op._step,
            })
        return out

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._started

    def last_step_age(self) -> "float | None":
        """Seconds since the scheduler last showed liveness (admission,
        loop wake, op step, or sweep completion) — None before any.
        With live requests pending, a large age means the scheduler is
        wedged inside one step, the signal ``/health`` turns into a
        ``scheduler_stalled`` verdict."""
        last = self._last_sweep
        return None if last is None else time.monotonic() - last

    def slo_report(self) -> dict:
        """Fresh per-tenant burn rates plus the worst offender —
        ``{"enabled", "objective", "latency_s", "tenants":
        {tenant: {"60s": burn, ...}}, "worst": {...} | None}``.
        Windows key by the ``serve.slo_burn`` gauge's window label."""
        from cylon_tpu_torch.serve.slo import _wlabel

        rates = {
            t: {_wlabel(w): (round(b, 4) if b is not None else None)
                for w, b in burns.items()}
            for t, burns in self._slo.burn_rates().items()}
        worst = self._slo.worst()
        return {
            "enabled": self._slo.enabled,
            "objective": self._slo.objective,
            "latency_s": self._slo.latency_s,
            "tenants": rates,
            "worst": (None if worst is None else {
                "tenant": worst[0], "window": _wlabel(worst[1]),
                "burn": round(worst[2], 4)}),
        }

    def health(self) -> dict:
        """The router-grade composite verdict (``/health``):
        ``{"status": ok|degraded|unhealthy, "score", "reasons": [...],
        "components": {...}}`` — see
        :func:`cylon_tpu_torch.serve.introspect.health_verdict`."""
        return introspect.health_verdict(self)

    def tenant_stats(self) -> "dict[str, dict]":
        """Per-tenant serving report: requests/completed/errors/
        rejected/expired counts plus p50/p99/max request latency from
        the ``serve.request_seconds{tenant=}`` histogram quantiles."""
        out: dict = {}

        def _count(metric_name):
            for _, labels, inst in telemetry.instruments(metric_name):
                ten = labels.get("tenant")
                if ten is None:
                    continue
                d = out.setdefault(ten, {})
                key = metric_name.split(".", 1)[1]
                d[key] = d.get(key, 0) + inst.value

        for m in ("serve.requests", "serve.completed", "serve.errors",
                  "serve.rejected", "serve.expired"):
            _count(m)
        for _, labels, inst in telemetry.instruments(
                "serve.request_seconds"):
            ten = labels.get("tenant")
            if ten is None or not inst.count:
                continue
            d = out.setdefault(ten, {})
            d.update(p50_s=inst.quantile(0.5),
                     p99_s=inst.quantile(0.99),
                     mean_s=inst.sum / inst.count,
                     max_s=inst.max)
        return out

    def plan_cache_stats(self) -> dict:
        """Hit/miss/eviction totals of the compiled queries' scale
        memos (:func:`cylon_tpu_torch.plan.plan_cache_stats`)."""
        return plan.plan_cache_stats()

    # -------------------------------------------------------- recovery
    @classmethod
    def recover(cls, durable_dir: str, env=None,
                policy: "ServePolicy | None" = None,
                queries: "dict | None" = None,
                replay: bool = True,
                snapshot_dir: "str | None" = None) -> "ServeEngine":
        """Rebuild a killed durable engine from ``durable_dir`` (port of
        ``cylon_tpu/serve/service.py`` ``ServeEngine.recover``).

        1. **Env**: ``env=None`` builds the port's
           :class:`~cylon_tpu_torch.context.CylonEnv` on CUDA (the old
           one died with the old process); pass an env on the CPU to
           recover there.
        2. **Resident tables**: every
           :class:`~cylon_tpu_torch.serve.durability.CatalogSnapshot`
           table restores on the env's device into the process catalog,
           at the generation it was saved at.
        3. **Requests**: journaled-but-incomplete NAMED requests re-run
           via :meth:`submit_named` with their original idempotency
           keys — exactly once (``serve.journal_replayed`` counts
           them); incomplete requests the journal cannot name (bare
           callables, non-JSON args) are reported, not silently lost.

        ``queries`` maps names to query functions (or ``(fn,
        fallback)`` pairs). The report lands on
        ``engine.recovery_report``::

            {"replayed": {key_or_rid: QueryTicket}, "restored_tables":
             [...], "unreplayable": [journal entries]}

        Counts one ``serve.recoveries``.
        """
        from cylon_tpu_torch.serve.durability import RequestJournal

        if env is None:
            from cylon_tpu_torch.context import CylonEnv

            env = CylonEnv()
        device = env.device
        engine = cls(env, policy, durable_dir=durable_dir,
                     snapshot_dir=snapshot_dir)
        for name, fn in (queries or {}).items():
            # a (fn, fallback) pair re-registers the degrade path too,
            # so replayed requests keep their graceful degradation
            if isinstance(fn, tuple):
                engine.register_query(name, *fn)
            else:
                engine.register_query(name, fn)
        telemetry.counter("serve.recoveries").inc()
        _trace.instant("serve.recover", cat="serve", dir=durable_dir)
        restored = engine._snapshot.restore(device=device)
        gens = engine._snapshot.generations()
        for tid, table in restored.items():
            catalog.put_table(tid, table)
            # reinstate the generation the snapshot was taken at: a
            # recovered engine must serve post-append content under the
            # post-append generation, not restart the counter at 1 and
            # alias every version-keyed memo
            if tid in gens:
                catalog.restore_version(tid, gens[tid])
        replayable, unreplayable = RequestJournal.incomplete(durable_dir)
        tickets: dict = {}
        if replay:
            for e in list(replayable):
                if e["name"] not in engine._queries:
                    # journaled under a name this recovery cannot
                    # resolve: report it lost, don't die mid-recovery
                    unreplayable.append(e)
                    continue
                tickets[e.get("key") or e["rid"]] = engine.submit_named(
                    e["name"], *e.get("args", ()),
                    idempotency_key=e.get("key"),
                    tenant=e.get("tenant", "default"),
                    priority=e.get("priority", 1),
                    slo=e.get("slo"), tables=e.get("tables", ()),
                    **e.get("kwargs", {}))
                # retire the ORIGINAL journal entry of a KEYLESS
                # request: the replay's own admit line (just written,
                # ahead of its dispatch) now carries it — without this
                # the entry reads incomplete forever and re-executes on
                # EVERY subsequent recovery. Keyed entries must NOT get
                # this line (a done'd key would hide the replay if THIS
                # process is killed mid-replay); their exactly-once
                # comes from first-admit-per-key dedup instead.
                if e.get("key") is None:
                    engine._journal.done(rid=e["rid"], key=None,
                                         state="replayed")
                telemetry.counter("serve.journal_replayed",
                                  tenant=e.get("tenant",
                                               "default")).inc()
        for e in unreplayable:
            telemetry.counter("serve.journal_unreplayable",
                              tenant=e.get("tenant", "default")).inc()
        engine.recovery_report = {
            "replayed": tickets,
            "restored_tables": sorted(restored),
            "unreplayable": unreplayable,
        }
        return engine

    # -------------------------------------------------------- lifecycle
    def close(self, wait: bool = True,
              timeout: "float | None" = None) -> None:
        """Stop admitting; optionally drain live requests. With
        ``wait=False`` a close under live requests raises
        :class:`~cylon_tpu_torch.errors.FailedPrecondition` (the engine
        never silently abandons admitted work). After the drain the
        engine lets go of every retired ticket it holds — the rid
        history, the idempotency map and the result cache — so their
        results' device memory is freed once the clients drop theirs."""
        with self._cond:
            live = len(self._exec.ops)
            if live and not wait:
                # decide the refusal BEFORE publishing _closed, so a
                # concurrent submit never sees a closed engine that
                # then stays open
                raise FailedPrecondition(
                    f"close(wait=False) with {live} live request(s); "
                    "drain or pass wait=True")
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        if self._profile_history is not None:
            self._profile_history.save()
        if self._journal is not None:
            self._journal.close()
        if self._http is not None:
            self._http.close()
            self._http = None
        with self._cond:
            if not self._exec.ops:
                self._recent.clear()
                self._idem.clear()
                self._coalesce.clear()
        self._result_cache.clear()
        for cq in list(self._graph_users):
            cq.release_graphs()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=True)
