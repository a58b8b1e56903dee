"""cylon_tpu_torch.serve — the always-on multi-tenant query service (port
of ``cylon_tpu/serve``, in part).

One resident device, many concurrent queries: a long-lived
:class:`ServeEngine` admits requests against shared resident tables
(:mod:`cylon_tpu_torch.catalog` pins), schedules them through the
:mod:`cylon_tpu_torch.ops_graph` execution strategies (RoundRobin
fair-share / Priority tenant weights), bounds each under a per-request
SLO (:func:`cylon_tpu_torch.watchdog.deadline`), shares the compiled
queries' scale memos across clients
(:func:`cylon_tpu_torch.plan.shared_compiled`), dedups identical
requests through the versioned result cache, and meters everything per
tenant (``serve.*`` + tenant-labeled instruments, an ANALYZE profile a
ticket, the ``CYLON_TPU_SERVE_HTTP_PORT`` ops endpoint). With a
``durable_dir`` the engine is crash-safe: admitted requests journal
write-ahead (:class:`RequestJournal`), resident tables snapshot
(:class:`CatalogSnapshot`), and ``ServeEngine.recover(dir)`` rebuilds
tables and in-flight work after a hard kill::

    from cylon_tpu_torch.serve import ServeEngine, ServePolicy

    engine = ServeEngine(env, ServePolicy(max_queue=64))
    engine.register_table("tpch/lineitem", frames["lineitem"].table)
    with engine.session("alice", tables=["tpch/lineitem"]) as s:
        ticket = s.submit(query, frames)
        result = ticket.result(timeout=60)
        ticket.profile()                # EXPLAIN ANALYZE of the request
    engine.close()

All of ``cylon_tpu/serve`` is ported (ROADMAP A7.3, A8.2): the engine,
admission and the circuit breaker, SLO burn accounting, sessions, the
ops endpoint, the journal and snapshot, the result cache, the
replicated fleet (:mod:`~cylon_tpu_torch.serve.fleet`: engine processes
behind a :class:`FleetRouter` with journal-replay failover) and the
serving harness (``python -m cylon_tpu_torch.serve.bench``).
"""

from cylon_tpu_torch.serve.admission import (AdmissionController,
                                             CircuitBreaker, ServePolicy,
                                             default_policy)
from cylon_tpu_torch.serve.durability import (CatalogSnapshot, JournalLock,
                                              RequestJournal, fence_journal)
from cylon_tpu_torch.serve.fleet import (EngineGateway, FleetLayout,
                                         FleetRouter, HttpEngineClient,
                                         LocalEngineClient, RouterTicket)
from cylon_tpu_torch.serve.introspect import IntrospectServer
from cylon_tpu_torch.serve.service import QueryTicket, ServeEngine
from cylon_tpu_torch.serve.session import Session
from cylon_tpu_torch.serve.slo import SloTracker

__all__ = ["ServeEngine", "QueryTicket", "Session", "ServePolicy",
           "AdmissionController", "CircuitBreaker", "SloTracker",
           "IntrospectServer", "RequestJournal", "CatalogSnapshot",
           "JournalLock", "fence_journal", "default_policy",
           "FleetLayout", "FleetRouter", "RouterTicket", "EngineGateway",
           "HttpEngineClient", "LocalEngineClient"]
