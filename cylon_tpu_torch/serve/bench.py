"""serve_bench: N concurrent clients replaying a mixed TPC-H workload
against one :class:`~cylon_tpu_torch.serve.ServeEngine` (port of
``cylon_tpu/serve/bench.py``).

The serving acceptance harness: ``--clients N`` (default 8) client
threads, each its own tenant/session, fire a mixed TPC-H query stream
(default mix q1/q3/q5/q6/q14 — groupby-heavy, 3-way join, 6-way join, a
scalar aggregate, a two-phase global aggregate) at a shared engine
holding the TPC-H tables RESIDENT on one device. Every result is
compared against a single-query oracle (the same query run once, alone,
before serving starts), so the run proves correctness under
concurrency, not just liveness. One JSON record lands on stdout with the
schema pinned by :data:`REQUIRED_SERVE_FIELDS`: p50/p99 request latency
from the ``serve.request_seconds`` histogram quantiles, throughput (qps),
plan-cache hit rate, and rejected/expired/error counts.

Run on the card (or ``--device cpu``)::

    python -m cylon_tpu_torch.serve.bench --clients 8
    python -m cylon_tpu_torch.serve.bench --fleet --clients 16 [--fleet-trace]
    python -m cylon_tpu_torch.serve.bench --hot-mix --clients 64
    python -m cylon_tpu_torch.serve.bench --refresh --sf 1.0 --appends 2
    python -m cylon_tpu_torch.serve.bench --clients 8 --storm 8

Knobs: ``--requests`` per client (default 2), ``--sf`` scale factor
(default 0.002), ``--schedule roundrobin|priority``, ``--slo`` seconds
(default unbounded), ``--max-queue``, ``--seed``, ``--device``.

``--fleet`` spawns engine processes behind a
:class:`~cylon_tpu_torch.serve.fleet.FleetRouter` and SIGKILLs one
mid-run (:data:`REQUIRED_FLEET_FIELDS`); ``--hot-mix`` gates the dedup
plane's QPS multiplier over an uncached engine
(:data:`REQUIRED_HOTMIX_FIELDS`); ``--refresh`` runs RF1-style append
rounds against q1/q3/q5/q6 materialized views with concurrent readers
audited at their pinned generations (:data:`REQUIRED_REFRESH_FIELDS`).

Differences from the JAX package: every leg builds its tables on
``device`` (CUDA unless asked), never falling back to the CPU; the
generator keeps only the mix's manifest columns (:func:`_mix_keep`, as
the refresh leg already does); the hot-mix baseline switches the engine
caches and coalescing off through the module constants
``serve.service.RESULT_CACHE_BYTES`` and ``serve.service.COALESCE`` and
the router's cache through ``FleetRouter(cache_bytes=0)``, which the
port reads instead of the environment; the hot mix drives each phase
with its results checked after the timed window (the gated
``qps_multiplier``) and again with them checked inside it, as the JAX
package does (``qps_multiplier_checks_in_window``), and repeats the hot
phase; ``_results_match`` tests float columns with
``pd.api.types.is_float_dtype``, so pandas' string dtype compares as a
key column; ``run_bench``, ``run_hotmix_bench`` and
``run_refresh_bench`` take ``reference=``, a context manager factory
entered around each oracle and from-scratch recompute.
"""

import argparse
import contextlib
import json
import sys
import threading
import time

import numpy as np

from cylon_tpu_torch.fallback import _materialize

__all__ = ["REQUIRED_SERVE_FIELDS", "REQUIRED_HOTMIX_FIELDS",
           "REQUIRED_FLEET_FIELDS", "REQUIRED_FLEET_TRACE_FIELDS",
           "REQUIRED_REFRESH_FIELDS", "DEFAULT_MIX", "REFRESH_MIX",
           "run_bench", "run_hotmix_bench", "run_refresh_bench", "main"]

#: serve-record fields the serving trajectory depends on — ``main``
#: asserts them before emitting (the JAX package's set, unchanged)
REQUIRED_SERVE_FIELDS = frozenset({
    "metric", "clients", "requests_total", "tenants", "schedule",
    "p50_s", "p99_s", "qps", "cache_hit_rate", "rejected", "errors",
    "expired", "oracle_mismatches", "shed", "journal_replayed",
    "recoveries", "degraded",
    # attribution: the slowest request's ANALYZE profile and the run's
    # device-memory high-water mark
    "slowest_profile", "peak_live_bytes",
    # windowed observability: the sliding-window p99 and the worst SLO
    # burn rate any tenant reached (0 when burn accounting is unarmed)
    "windowed_p99_s", "slo_burn",
    # the dedup layer: the versioned result cache and micro-batched
    # dispatch counters (0 on the bare-callable replay)
    "result_cache_hits", "result_cache_misses",
    "result_cache_invalidations", "coalesced",
})

#: hot-mix-record fields: the hot-path QPS against the single-engine
#: uncached baseline (their ratio is the ``qps_multiplier`` gated at >=
#: 10x), the hot-phase cache hit rate, the dedup counters and the
#: staleness audit (an append between submissions MUST force a
#: re-execution — 0 stale results)
REQUIRED_HOTMIX_FIELDS = frozenset({
    "metric", "engines", "clients", "requests_total", "completed",
    "baseline_qps", "hot_qps", "qps_multiplier", "p50_s", "p99_s",
    "cache_hit_rate", "shed", "coalesced", "result_cache_hits",
    "result_cache_misses", "result_cache_invalidations",
    "oracle_mismatches", "stale_results", "errors",
})

#: fleet-record fields: the engine count, the failover and replay
#: counters, the lost-ack and double-execution audits (both MUST be 0)
#: and the p99 before/during/after the mid-run kill
REQUIRED_FLEET_FIELDS = frozenset({
    "metric", "engines", "clients", "requests_total", "completed",
    "failovers", "replayed", "lost_acks", "routed", "deduped",
    "retry_deduped", "double_executions", "oracle_mismatches",
    "errors", "p99_before_s", "p99_during_s", "p99_after_s",
})

#: extra fields a ``--fleet-trace`` record must carry: where the Chrome
#: trace landed, how many spans and engine tracks it stitched, the
#: clock-handshake jitter bound and the failover replay hops
REQUIRED_FLEET_TRACE_FIELDS = frozenset({
    "trace_path", "spans", "engines_stitched", "offset_jitter_s",
    "replay_hops",
})

#: refresh-record fields: the incremental-refresh wall against the
#: from-scratch recompute wall (their ratio, ``speedup``, gated at >=
#: 2x), the generation lag readers observed and the oracle audit
REQUIRED_REFRESH_FIELDS = frozenset({
    "metric", "sf", "delta_sf", "views", "appends", "refreshes",
    "delta_rows_total", "refresh_wall_s", "recompute_wall_s",
    "speedup", "generation_lag", "oracle_mismatches", "reads_total",
    "errors",
})

#: default mixed workload: groupby-heavy scan, 3-way join + top-k,
#: 6-way join, a scalar aggregate, and a two-phase global aggregate
#: (q14's promo ratio needs a global merge scalar)
DEFAULT_MIX = ("q1", "q3", "q5", "q6", "q14")

#: the ``--refresh`` workload: the four mix shapes whose fallback merge
#: is directly view-maintainable
REFRESH_MIX = ("q1", "q3", "q5", "q6")

#: the hot mix's hot phase runs this many times with its checks after
#: the window: the first is the record's rate, the rest its spread
HOT_REPEATS = 3


def _emit_record(line: dict):
    """The one stdout sink for serve bench records: attaches the
    telemetry ``metrics`` block. Telemetry must never fail a bench."""
    line = dict(line)
    try:
        from cylon_tpu_torch import telemetry

        line["metrics"] = telemetry.bench_metrics()
    except Exception as e:  # pragma: no cover - import-time breakage
        line["metrics"] = {"telemetry_error": f"{type(e).__name__}: {e}"}
    print(json.dumps(line))


def _results_match(got, want) -> bool:
    """Order-insensitive equality between a served result and its
    single-query oracle (float columns to 1e-9 rtol; every other column,
    strings and nullable ones included, exactly).

    (port of ``cylon_tpu/serve/bench.py`` ``_results_match``)"""
    import pandas as pd

    if isinstance(want, float):
        return bool(np.isclose(float(got), want, rtol=1e-9))
    if not isinstance(want, pd.DataFrame):
        return bool(np.allclose(np.asarray(got), np.asarray(want)))
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return False
    floats = {c for c in want.columns
              if pd.api.types.is_float_dtype(want[c].dtype)}
    keys = [c for c in want.columns if c not in floats]
    g = got.sort_values(keys or list(got.columns)).reset_index(drop=True)
    w = want.sort_values(keys or list(want.columns)).reset_index(drop=True)
    for c in want.columns:
        if c in floats:
            if not np.allclose(g[c].to_numpy(dtype=np.float64),
                               w[c].to_numpy(dtype=np.float64),
                               rtol=1e-9, equal_nan=True):
                return False
        elif [None if pd.isna(x) else x for x in g[c]] != \
                [None if pd.isna(x) else x for x in w[c]]:
            return False
    return True


def _staged_query(cq, resident, env):
    """A two-step generator query for the scheduler: step 1 runs the
    compiled query (launches + overflow check), step 2 brings the result
    to the host — so while one request's result fetch drains, the
    schedule already dispatches the next tenant's step.

    (port of ``cylon_tpu/serve/bench.py`` ``_staged_query``)"""

    def run():
        out = cq(resident, env=env)
        yield  # step boundary: result fetch happens on the next sweep
        return _materialize(out)

    return run


def _mix_keep(mix) -> dict:
    """The generator's ``keep`` for ``mix``: the union of its queries'
    manifest columns, by table (the same keep-set an oracle built from
    the same mix uses, so both draw the same rows)."""
    from cylon_tpu_torch.tpch.manifest import MANIFEST

    keep: dict = {}
    for q in mix:
        for t, cols in MANIFEST[q].items():
            keep.setdefault(t, set()).update(cols)
    return keep


def _mk_resident(env, data):
    """Build the TPC-H tables on ``env``'s device ONCE — the shared
    resident store every request reads; one shard a rank when the env
    spans several ranks. Tables the generator kept no column of are
    left out. Returns the ``{name: DataFrame}`` mapping queries take.

    (port of ``cylon_tpu/serve/bench.py`` ``_mk_resident``)"""
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.frame import DataFrame
    from cylon_tpu_torch.parallel.dtable import scatter_table

    resident = {}
    for name, df in tpch.ingest(data, device=env.device).items():
        if not df.table.num_columns:
            continue
        if env.world_size > 1:
            df = DataFrame._wrap(scatter_table(env, df.table))
        resident[name] = df
    return resident


def _fault_storm(engine, http_addr, requests: int = 8,
                 tenant: str = "storm") -> dict:
    """Drive ONE tenant into a deadline storm against a live engine and
    watch the observability plane tell the story — ``/health`` flips
    ok → unhealthy, sheds and breaker transitions land in ``/events`` in
    order, and after the cooldown + the storm window aging out,
    ``/health`` recovers to ok. Polls the verdict over HTTP when the
    ops endpoint is armed, falling back to ``engine.health()``.

    (port of ``cylon_tpu/serve/bench.py`` ``_fault_storm``)"""
    import urllib.request

    from cylon_tpu_torch import telemetry
    from cylon_tpu_torch.telemetry import events as _events

    def verdict():
        if http_addr is not None:
            url = "http://%s:%d/health" % http_addr
            with urllib.request.urlopen(url, timeout=10) as r:
                return json.loads(r.read())
        return engine.health()

    cursor = _events.since(0)["cursor"]
    transitions = [verdict()["status"]]
    unhealthy_reasons = None
    peak_burn = 0.0

    def note(v):
        nonlocal unhealthy_reasons, peak_burn
        if v["status"] != transitions[-1]:
            transitions.append(v["status"])
        if v["status"] == "unhealthy" and unhealthy_reasons is None:
            unhealthy_reasons = list(v["reasons"])
        worst = (v.get("components", {}).get("slo") or {}).get("worst")
        if worst and worst["burn"] > peak_burn:
            peak_burn = worst["burn"]

    def slow():
        time.sleep(0.3)
        return None

    t0 = time.perf_counter()
    tickets = []
    for _ in range(int(requests)):
        try:
            tickets.append(engine.submit(slow, tenant=tenant, slo=0.02))
        except Exception:
            pass  # breaker may already be shedding: that IS the storm
        note(verdict())
    for tk in tickets:
        try:
            tk.result(30)
        except Exception:
            pass
        note(verdict())
    shed_probe_errors = 0
    deadline = time.monotonic() + 60
    recovered = False
    while time.monotonic() < deadline:
        v = verdict()
        note(v)
        if v["status"] == "ok" and "unhealthy" in transitions:
            recovered = True
            break
        try:
            # good traffic probes the half-open breaker and re-earns
            # the SLO budget once the storm ages out of the window
            engine.submit(lambda: 1, tenant=tenant, slo=30.0).result(30)
        except Exception:
            shed_probe_errors += 1
        time.sleep(0.25)
    replay = _events.since(cursor)
    kinds = [e["kind"] for e in replay["events"]]
    seqs = [e["seq"] for e in replay["events"]]
    return {
        "tenant": tenant,
        "requests": int(requests),
        "wall_s": round(time.perf_counter() - t0, 3),
        "health_transitions": transitions,
        "unhealthy_reasons": unhealthy_reasons,
        "recovered": recovered,
        "peak_burn": round(peak_burn, 4),
        "recovery_probes_shed": shed_probe_errors,
        "storm_errors": telemetry.total("serve.errors"),
        "storm_shed": telemetry.total("serve.shed"),
        "breaker_trips": telemetry.total("serve.breaker_trips"),
        "events_replayed": len(kinds),
        "event_kinds": sorted(set(kinds)),
        "events_in_order": seqs == sorted(seqs),
        "events_dropped": replay["dropped"],
    }


def run_bench(clients: int = 8, requests: int = 2, sf: float = 0.002,
              schedule: str = "roundrobin", slo: "float | None" = None,
              max_queue: "int | None" = None, seed: int = 0,
              mix=DEFAULT_MIX, slo_target: "float | None" = None,
              slo_latency: "float | None" = None,
              slo_windows: "tuple | None" = None,
              storm: int = 0, device="cuda", reference=None) -> dict:
    """The serving acceptance replay on ``device``; returns the record
    (:data:`REQUIRED_SERVE_FIELDS`). ``reference`` is a context manager
    factory entered around the oracles (:func:`run_hotmix_bench`).

    (port of ``cylon_tpu/serve/bench.py`` ``run_bench``)"""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import catalog, telemetry, tpch, watchdog
    from cylon_tpu_torch.errors import ResourceExhausted
    from cylon_tpu_torch.serve import ServeEngine, ServePolicy
    from cylon_tpu_torch.serve.admission import default_policy
    from cylon_tpu_torch.telemetry import timeseries

    mix = tuple(mix)
    env = ct.CylonEnv(device=device)
    data = tpch.generate(sf, seed, keep=_mix_keep(mix))
    resident = _mk_resident(env, data)
    for name, df in resident.items():
        catalog.put_table(f"tpch/{name}", df.table)

    base = default_policy()
    if storm and slo_target is None and base.slo_target is None:
        # the fault-storm acceptance needs burn accounting armed and
        # windows short enough to watch /health recover in one run
        slo_target = 0.99
        slo_windows = slo_windows or (10.0, 30.0)
    policy = ServePolicy(
        max_queue=max_queue if max_queue is not None else base.max_queue,
        default_slo=slo if slo and slo > 0 else base.default_slo,
        schedule=schedule,
        breaker_fails=base.breaker_fails,
        breaker_window=base.breaker_window,
        breaker_cooldown=base.breaker_cooldown,
        slo_target=(slo_target if slo_target is not None
                    else base.slo_target),
        slo_latency=(slo_latency if slo_latency is not None
                     else base.slo_latency),
        slo_windows=tuple(slo_windows or base.slo_windows),
        burn_critical=base.burn_critical)
    # baseline sample for the windowed-p99 column: the whole replay
    # lands in one history delta slot
    timeseries.sample(force=True)

    # single-query oracles: each mix query runs ONCE, alone, through the
    # same shared compiled query — every concurrent result must
    # reproduce these exactly
    compiled = {q: tpch.compiled(q) for q in mix}
    with (reference or contextlib.nullcontext)():
        oracles = {q: _materialize(compiled[q](resident, env=env))
                   for q in mix}

    engine = ServeEngine(env, policy)
    mismatches = []
    rejected_local = [0]
    all_tickets = []  # (query, ticket) across every client thread
    lock = threading.Lock()

    def client(i: int):
        # under the priority schedule, odd clients are weight-2 tenants
        prio = 2 if (schedule == "priority" and i % 2) else 1
        tenant = f"tenant{i}"
        with engine.session(tenant, priority=prio,
                            tables=[f"tpch/{n}" for n in resident]) as s:
            tickets = []
            for r in range(requests):
                q = mix[(i + r) % len(mix)]
                try:
                    tk = s.submit(_staged_query(compiled[q], resident,
                                                env))
                    tickets.append((q, tk))
                    with lock:
                        all_tickets.append((q, tk))
                except ResourceExhausted:
                    with lock:
                        rejected_local[0] += 1
            for q, tk in tickets:
                try:
                    got = tk.result()
                except Exception as e:
                    with lock:
                        mismatches.append((tenant, q,
                                           f"{type(e).__name__}: {e}"))
                    continue
                if not _results_match(got, oracles[q]):
                    with lock:
                        mismatches.append((tenant, q, "result mismatch"))

    t0 = time.perf_counter()
    with watchdog.watched_section("serve_request",
                                  detail="serve_bench replay"):
        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"serve-client-{i}")
                   for i in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    wall = time.perf_counter() - t0
    http_addr = engine.http_address  # captured before close unbinds
    # close the replay's windowed slot + read the healthy-phase gate
    # counters BEFORE any storm phase muddies them
    timeseries.sample(force=True)
    windowed_p99 = timeseries.history().quantile(
        "serve.request_seconds", 0.99)
    exact_walls = sorted(
        tk.finished - tk.submitted for _, tk in all_tickets
        if tk.finished is not None and tk.state == "done")
    p99_exact = (float(np.quantile(np.asarray(exact_walls), 0.99))
                 if exact_walls else None)
    healthy_errors = telemetry.total("serve.errors")
    healthy_shed = telemetry.total("serve.shed")
    healthy_rejected = telemetry.total("serve.rejected")
    healthy_expired = telemetry.total("serve.expired")
    hist = telemetry.merge_histograms(
        [inst for _, _, inst in
         telemetry.instruments("serve.request_seconds")])
    completed = telemetry.total("serve.completed")
    n_tenants = len(engine.tenant_stats())

    storm_block = (_fault_storm(engine, http_addr, requests=storm)
                   if storm else None)
    worst = engine.slo_report().get("worst")
    engine.close(wait=True)

    cache = engine.plan_cache_stats()
    record = {
        "metric": "serve_bench_tpch_mix",
        "clients": clients,
        "requests_total": clients * requests,
        "tenants": n_tenants,
        "schedule": schedule,
        "sf": sf,
        "device": str(env.device),
        "wall_s": round(wall, 3),
        "qps": round(completed / wall, 3) if wall > 0 else None,
        "p50_s": (round(hist.quantile(0.5), 4)
                  if hist is not None and hist.count else None),
        "p99_s": (round(hist.quantile(0.99), 4)
                  if hist is not None and hist.count else None),
        "completed": completed,
        "rejected": healthy_rejected,
        "errors": healthy_errors,
        "expired": healthy_expired,
        "shed": healthy_shed,
        "windowed_p99_s": (round(windowed_p99, 4)
                           if windowed_p99 is not None else None),
        "p99_exact_s": (round(p99_exact, 4)
                        if p99_exact is not None else None),
        # the worst burn any tenant REACHED during the run
        "slo_burn": max(
            worst["burn"] if worst is not None else 0.0,
            storm_block["peak_burn"] if storm_block else 0.0),
        "journal_replayed": telemetry.total("serve.journal_replayed"),
        "recoveries": telemetry.total("serve.recoveries"),
        "degraded": telemetry.total("serve.degraded"),
        "cache_hit_rate": round(cache["hit_rate"], 4),
        "cache_hits": cache["hits"],
        "cache_misses": cache["misses"],
        # structurally 0 here (this replay submits bare callables, which
        # have no fingerprint), live on the --hot-mix leg
        "result_cache_hits": int(
            telemetry.total("serve.result_cache_hits")),
        "result_cache_misses": int(
            telemetry.total("serve.result_cache_misses")),
        "result_cache_invalidations": int(
            telemetry.total("serve.result_cache_invalidations")),
        "coalesced": int(telemetry.total("serve.coalesced")),
        "oracle_mismatches": len(mismatches),
        "mismatch_detail": mismatches[:8],
        "resident_tables": len(resident),
    }
    slowest = None
    for q, tk in all_tickets:
        if tk.finished is None or tk.state != "done":
            continue
        w = tk.finished - tk.submitted
        if slowest is None or w > slowest[0]:
            slowest = (w, q, tk)
    prof = slowest[2].profile() if slowest is not None else None
    if prof is not None:
        prof["query"] = slowest[1]
    record["slowest_profile"] = prof
    record["peak_live_bytes"] = telemetry.memory.peak_live_bytes()
    if storm_block is not None:
        record["storm"] = storm_block
    if http_addr is not None:
        record["http_url"] = "http://%s:%d" % http_addr
    return record


def run_hotmix_bench(clients: int = 64, requests: int = 4,
                     sf: float = 0.002, seed: int = 0,
                     mix=DEFAULT_MIX, engines: int = 2,
                     device="cuda", reference=None) -> dict:
    """N concurrent clients replay a HOT mix (identical fingerprints,
    stable tables) through the FleetRouter twice — once against a single
    uncached engine (coalescing and both result caches off: every
    request executes), once against the full dedup plane (engine +
    router caches on, coalescing on, warmed) — and the record gates the
    hot-over-baseline QPS multiplier at >= 10x. A mid-probe append then
    proves the staleness contract: the next submission of an affected
    query must MISS and re-execute (0 stale results). Every result, both
    phases, is oracle-checked.

    Each phase is driven twice, in this order: with every result checked
    after the timed window (``qps_multiplier``, the gated rate: the
    serving plane's own), then with each result checked in its client
    thread inside the window, as the JAX package measures it
    (``qps_multiplier_checks_in_window``: the same host-side check added
    to every request of both phases, which bounds the hot rate by the
    harness). The hot phase runs :data:`HOT_REPEATS` times with the
    checks after the window; ``hot_qps`` is the first, the rest show the
    run's own spread (``hot_qps_repeats``). ``reference`` is a context
    manager factory entered around the oracles, so a caller counting the
    served path's kernel launches can throw theirs away.

    (port of ``cylon_tpu/serve/bench.py`` ``run_hotmix_bench``)"""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import catalog, telemetry, tpch
    from cylon_tpu_torch.errors import ResourceExhausted
    from cylon_tpu_torch.serve import ServeEngine
    from cylon_tpu_torch.serve import fleet as _fleet
    from cylon_tpu_torch.serve import service as _service

    env = ct.CylonEnv(device=device)
    mix = tuple(mix)
    data = tpch.generate(sf, seed, keep=_mix_keep(mix))
    resident = _mk_resident(env, data)
    for name, df in resident.items():
        catalog.put_table(f"tpch/{name}", df.table)
    # oracles warm the shared compiled queries for BOTH phases equally —
    # the multiplier measures the dedup plane, not scale memos
    compiled = {q: tpch.compiled(q) for q in mix}
    with (reference or contextlib.nullcontext)():
        oracles = {q: _materialize(compiled[q](resident, env=env))
                   for q in mix}

    def mk_fleet(n_engines: int, cache_bytes: int):
        engs, clis = [], []
        for i in range(n_engines):
            e = ServeEngine(env)
            for q in mix:
                reads = _fleet.QUERY_READ_SETS.get(q, tuple(resident))
                e.register_query(
                    q, _fleet._mk_fleet_query(compiled[q], resident, env),
                    tables=[f"tpch/{nm}" for nm in reads
                            if nm in resident])
            engs.append(e)
            clis.append(_fleet.LocalEngineClient(e, f"hot{i}"))
        return engs, _fleet.FleetRouter(clis, poll_interval=0.25,
                                        cache_bytes=cache_bytes)

    def drive(router, n_requests: int, label: str,
              check_in_window: bool = False) -> dict:
        mismatches: list = []
        errors: list = []
        shed = [0]
        walls: "list[float]" = []
        got_all: list = []  # (tenant, query, result), checked after
        lock = threading.Lock()

        def client(i: int):
            tenant = f"tenant{i}"
            for r in range(n_requests):
                q = mix[(i + r) % len(mix)]
                s0 = time.monotonic()
                try:
                    got = router.submit(q, tenant=tenant).result(600)
                except Exception as e:
                    with lock:
                        if isinstance(e, (ResourceExhausted,
                                          _fleet.EngineUnavailable)):
                            shed[0] += 1
                        errors.append(
                            (tenant, q, f"{type(e).__name__}: {e}"))
                    continue
                w = time.monotonic() - s0
                with lock:
                    walls.append(w)
                    if not check_in_window:
                        got_all.append((tenant, q, got))
                if check_in_window and not _results_match(got,
                                                          oracles[q]):
                    with lock:
                        mismatches.append((tenant, q, label))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"hotmix-{label}-{i}")
                   for i in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        mismatches.extend((tenant, q, label) for tenant, q, got in got_all
                          if not _results_match(got, oracles[q]))
        ws = sorted(walls)
        return {
            "wall_s": wall, "completed": len(walls),
            "qps": (len(walls) / wall) if wall > 0 else None,
            "p50_s": (float(np.quantile(np.asarray(ws), 0.5))
                      if ws else None),
            "p99_s": (float(np.quantile(np.asarray(ws), 0.99))
                      if ws else None),
            "shed": shed[0], "mismatches": mismatches,
            "errors": errors,
        }

    # ---- phase 1: the single-engine uncached baseline (dedup plane OFF
    # end to end — every submission executes). Fewer requests per
    # client than the hot phase: QPS is a rate
    base_requests = max(1, requests // 2)
    saved = (_service.RESULT_CACHE_BYTES, _service.COALESCE)
    _service.RESULT_CACHE_BYTES = 0
    _service.COALESCE = False
    try:
        engs, router = mk_fleet(1, cache_bytes=0)
        try:
            base = drive(router, base_requests, "baseline")
            base_in = drive(router, base_requests, "baseline",
                            check_in_window=True)
        finally:
            router.close()
            for e in engs:
                e.close(wait=True)
    finally:
        _service.RESULT_CACHE_BYTES, _service.COALESCE = saved

    # ---- phase 2: the full dedup plane, warmed with one execution per
    # mix query so the measured window is the HOT path
    engs, router = mk_fleet(engines, _fleet.ROUTER_CACHE_BYTES)
    try:
        for q in mix:
            got = router.submit(q, tenant="warmup").result(600)
            if not _results_match(got, oracles[q]):
                base["mismatches"].append(("warmup", q, "warmup"))
        hits0 = telemetry.total("fleet.result_cache_hits") + \
            telemetry.total("serve.result_cache_hits")
        hot = drive(router, requests, "hot")
        hits1 = telemetry.total("fleet.result_cache_hits") + \
            telemetry.total("serve.result_cache_hits")
        hit_rate = ((hits1 - hits0) / hot["completed"]
                    if hot["completed"] else 0.0)
        extra = [drive(router, requests, "hot")
                 for _ in range(HOT_REPEATS - 1)]
        hot_in = drive(router, requests, "hot", check_in_window=True)
        for r in extra + [hot_in]:
            hot["mismatches"] += r["mismatches"]
            hot["errors"] += r["errors"]
            hot["shed"] += r["shed"]

        # ---- the staleness probe: append one row to lineitem, then
        # re-submit a lineitem query — the dedup plane must MISS and the
        # re-execution must still match the oracle (the resident frames
        # the queries read are not the catalog's entry, which only
        # versions them)
        probe_q = next((q for q in mix if "lineitem"
                        in _fleet.QUERY_READ_SETS.get(q, ("lineitem",))),
                       mix[0])
        cols = catalog.get_table("tpch/lineitem").column_names
        row = {c: np.asarray(data["lineitem"][c][:1]) for c in cols}
        misses0 = telemetry.total("fleet.result_cache_misses") + \
            telemetry.total("serve.result_cache_misses")
        catalog.append("tpch/lineitem", row)
        stale = 0
        try:
            got = router.submit(probe_q, tenant="probe").result(600)
        except Exception as e:
            hot["errors"].append(("probe", probe_q,
                                  f"{type(e).__name__}: {e}"))
        else:
            misses1 = telemetry.total("fleet.result_cache_misses") + \
                telemetry.total("serve.result_cache_misses")
            if misses1 <= misses0:
                stale += 1
            if not _results_match(got, oracles[probe_q]):
                hot["mismatches"].append(("probe", probe_q, "probe"))
    finally:
        router.close()
        for e in engs:
            e.close(wait=True)

    mismatches = base["mismatches"] + base_in["mismatches"] + \
        hot["mismatches"]
    errors = base["errors"] + base_in["errors"] + hot["errors"]

    def rnd(x, n):
        return round(x, n) if x is not None else None

    def ratio(h, b):
        return round(h["qps"] / b["qps"], 2) if h["qps"] and b["qps"] \
            else None

    return {
        "metric": "serve_hotmix_fleet",
        "engines": engines,
        "clients": clients,
        "requests_total": clients * requests,
        "completed": hot["completed"],
        "sf": sf,
        "mix": list(mix),
        "device": str(env.device),
        "baseline_requests_total": clients * base_requests,
        "baseline_completed": base["completed"],
        "baseline_wall_s": round(base["wall_s"], 3),
        "baseline_qps": rnd(base["qps"], 3) if base["qps"] else None,
        "baseline_p50_s": rnd(base["p50_s"], 4),
        "baseline_p99_s": rnd(base["p99_s"], 4),
        "wall_s": round(hot["wall_s"], 3),
        "hot_qps": rnd(hot["qps"], 3) if hot["qps"] else None,
        "qps_multiplier": ratio(hot, base),
        "hot_qps_repeats": [rnd(r["qps"], 3) for r in [hot] + extra],
        "baseline_qps_checks_in_window": rnd(base_in["qps"], 3),
        "hot_qps_checks_in_window": rnd(hot_in["qps"], 3),
        "qps_multiplier_checks_in_window": ratio(hot_in, base_in),
        "p50_s": rnd(hot["p50_s"], 4),
        "p99_s": rnd(hot["p99_s"], 4),
        "cache_hit_rate": round(hit_rate, 4),
        "shed": base["shed"] + base_in["shed"] + hot["shed"],
        "coalesced": int(telemetry.total("serve.coalesced")),
        "result_cache_hits": int(
            telemetry.total("fleet.result_cache_hits")
            + telemetry.total("serve.result_cache_hits")),
        "result_cache_misses": int(
            telemetry.total("fleet.result_cache_misses")
            + telemetry.total("serve.result_cache_misses")),
        "result_cache_invalidations": int(
            telemetry.total("fleet.result_cache_invalidations")
            + telemetry.total("serve.result_cache_invalidations")),
        "stale_results": stale,
        "oracle_mismatches": len(mismatches),
        "mismatch_detail": mismatches[:8],
        "errors": len(errors),
        "error_detail": errors[:8],
    }


def _refresh_keep(mix) -> dict:
    """Per-table column keep-sets for the refresh workload: the union of
    the mix's manifests plus the order keys the RF1 append stream
    offsets. (port of ``cylon_tpu/serve/bench.py`` ``_refresh_keep``)"""
    keep = _mix_keep(mix)
    keep.setdefault("orders", set()).add("o_orderkey")
    keep.setdefault("lineitem", set()).add("l_orderkey")
    return {t: frozenset(c) for t, c in keep.items()}


def _mk_view_query(q, env=None):
    """The view query fn for one mix query: the partitioned EAGER
    fallback on ``env``'s device over whatever tables it is handed — the
    same execution path for the delta run, the initial materialization
    and the from-scratch oracle, so the refresh-vs-recompute walls
    compare like with like. Small inputs (a delta) skip the partition
    split. (port of ``cylon_tpu/serve/bench.py`` ``_mk_view_query``)"""
    from cylon_tpu_torch import fallback

    def qf(tables):
        data = {name: {c: df[c].to_numpy() for c in df.columns}
                for name, df in tables.items()}
        li = data.get("lineitem")
        rows = len(next(iter(li.values()))) if li else 0
        return fallback.tpch_fallback(
            q, data, env=env, compiled=False,
            n_partitions=1 if rows < 100_000 else None)

    return qf


def run_refresh_bench(sf: float = 0.05, delta_sf: "float | None" = None,
                      rounds: int = 2, clients: int = 4, seed: int = 0,
                      mix=REFRESH_MIX, device="cuda",
                      reference=None) -> dict:
    """TPC-H RF1-style appends (new orders arriving WITH their
    lineitems) interleaved with the q1/q3/q5/q6 mix served as
    incremental materialized views.

    Per round: one key-offset delta appends to the resident ``orders``
    and ``lineitem`` tables, every view refreshes INCREMENTALLY (timed),
    and a from-scratch recompute at the same pinned generations runs as
    the oracle (timed — the denominator of ``speedup``). ``clients``
    reader threads hammer ``engine.read_view`` throughout; every read's
    ``(generations, result)`` pair is verified post-hoc against the
    from-scratch oracle at exactly those generations. ``reference`` is a
    context manager factory entered around each recompute
    (:func:`run_hotmix_bench`).

    (port of ``cylon_tpu/serve/bench.py`` ``run_refresh_bench``)"""
    import pandas as pd

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import tpch, views, watchdog
    from cylon_tpu_torch.errors import InvalidArgument
    from cylon_tpu_torch.fallback import _resolve_limit
    from cylon_tpu_torch.serve import ServeEngine
    from cylon_tpu_torch.tpch.manifest import FALLBACK, MANIFEST

    if delta_sf is None:
        delta_sf = max(sf / 100.0, 1e-4)
    mix = tuple(mix)
    for q in mix:
        if FALLBACK[q]["merge"] == "twophase":
            raise InvalidArgument(
                f"--refresh mix cannot include two-phase query {q!r}: "
                "its view state is a phase-1 partial, which needs a "
                "partial-returning query fn; maintainable here: "
                f"{REFRESH_MIX}")
    keep = _refresh_keep(mix)
    env = ct.CylonEnv(device=device)
    base = tpch.generate(sf, seed, keep=keep)
    resident = tpch.ingest(base, device=env.device)
    engine = ServeEngine(env)
    for name, df in resident.items():
        if df.table.num_columns:
            engine.register_table(f"tpch/{name}", df)

    query_fns = {q: _mk_view_query(q, env) for q in mix}
    limits = {}
    for q in mix:
        spec = FALLBACK[q]
        limits[q] = _resolve_limit(getattr(tpch, q), spec, {})
        engine.register_view(
            f"view/{q}", query_fns[q], spec,
            sources={t: f"tpch/{t}" for t in MANIFEST[q]},
            delta_source="lineitem", limit=limits[q])

    # the bench-side delta history: content at ANY generation rebuilds
    # as base + deltas[:gen-1] — what the oracle recomputes from
    host_frames = {t: df.to_pandas() for t, df in resident.items()
                   if df.table.num_columns}
    delta_hist: "dict[str, list]" = {"orders": [], "lineitem": []}
    n_base_ord = int(len(host_frames["orders"]))

    def content_at(tname: str, gen: int):
        hist = delta_hist.get(tname, ())
        parts = [host_frames[tname]] + list(hist[:max(gen - 1, 0)])
        return (parts[0] if len(parts) == 1
                else pd.concat(parts, ignore_index=True))

    oracle_cache: dict = {}
    oracle_mu = threading.Lock()

    def oracle_for(q: str, gens: dict):
        """(result, wall_s, fresh) of the from-scratch recompute at
        exactly ``gens`` — cached per pinned-generation combo."""
        combo = tuple(sorted(gens.items()))
        with oracle_mu:
            hit = oracle_cache.get((q, combo))
        if hit is not None:
            return hit[0], hit[1], False
        tabs = {a: content_at(a, g) for a, g in gens.items()}
        with (reference or contextlib.nullcontext)():
            t0 = time.perf_counter()
            out = query_fns[q](tabs)
            wall = time.perf_counter() - t0
        res = views.present(out, FALLBACK[q], limits[q])
        with oracle_mu:
            oracle_cache[(q, combo)] = (res, wall)
        return res, wall, True

    refresh_walls = {q: 0.0 for q in mix}
    recompute_walls = {q: 0.0 for q in mix}
    mismatches: list = []
    errors: list = []
    samples: list = []  # (q, generations, result, lag)
    lock = threading.Lock()
    stop_readers = threading.Event()
    refreshes = [0]
    full_recomputes = [0]
    delta_rows_total = [0]

    def reader(i: int):
        while not stop_readers.is_set():
            for q in mix:
                try:
                    r = engine.read_view(f"view/{q}")
                except Exception as e:
                    with lock:
                        errors.append((f"read view/{q}",
                                       f"{type(e).__name__}: {e}"))
                    continue
                with lock:
                    samples.append((q, dict(r["generations"]),
                                    r["result"], int(r["lag"])))
            time.sleep(0.01)

    t0 = time.perf_counter()
    with watchdog.watched_section("serve_request",
                                  detail="refresh_bench"):
        threads = [threading.Thread(target=reader, args=(i,),
                                    name=f"refresh-reader-{i}")
                   for i in range(clients)]
        for th in threads:
            th.start()
        try:
            for r in range(rounds):
                d = tpch.generate(delta_sf, seed + 1 + r, keep=keep)
                # RF1 key offset: this round's new orders (and their
                # lineitems) land in a key range disjoint from the base
                # AND every other round
                n_d = int(len(d["orders"]["o_orderkey"]))
                off = n_base_ord + r * n_d
                d["orders"]["o_orderkey"] = (
                    d["orders"]["o_orderkey"] + off)
                d["lineitem"]["l_orderkey"] = (
                    d["lineitem"]["l_orderkey"] + off)
                for t in ("orders", "lineitem"):
                    engine.append_table(f"tpch/{t}", d[t])
                    delta_hist[t].append(pd.DataFrame(
                        {c: np.asarray(v) for c, v in d[t].items()}))
                delta_rows_total[0] += int(
                    len(d["lineitem"]["l_orderkey"]))
                for q in mix:
                    out = engine.refresh_view(f"view/{q}")
                    refreshes[0] += 1
                    refresh_walls[q] += out["wall_s"]
                    if out["full_recompute"]:
                        full_recomputes[0] += 1
                    want, wall, fresh = oracle_for(
                        q, out["generations"])
                    if fresh:
                        recompute_walls[q] += wall
                    got = engine.read_view(f"view/{q}")
                    if (got["generations"] == out["generations"]
                            and not _results_match(got["result"],
                                                   want)):
                        mismatches.append(
                            (q, dict(out["generations"]),
                             "post-refresh mismatch"))
        finally:
            stop_readers.set()
            for th in threads:
                th.join()
    wall = time.perf_counter() - t0

    # post-hoc audit: EVERY concurrent read must equal the from-scratch
    # recompute at its pinned generations
    lag_max = 0
    for q, gens, result, lag in samples:
        lag_max = max(lag_max, lag)
        want, _, _ = oracle_for(q, gens)
        if not _results_match(result, want):
            mismatches.append((q, gens, "concurrent read mismatch"))
    view_stats = engine.view_stats()
    engine.close(wait=True)

    refresh_wall = sum(refresh_walls.values())
    recompute_wall = sum(recompute_walls.values())
    return {
        "metric": "refresh_bench_tpch_rf1",
        "sf": sf,
        "delta_sf": delta_sf,
        "rounds": rounds,
        "clients": clients,
        "device": str(env.device),
        "views": [f"view/{q}" for q in mix],
        # one RF1 round appends to BOTH orders and lineitem
        "appends": rounds * 2,
        "refreshes": refreshes[0],
        "full_recomputes": full_recomputes[0],
        "delta_rows_total": delta_rows_total[0],
        "refresh_wall_s": round(refresh_wall, 4),
        "recompute_wall_s": round(recompute_wall, 4),
        "speedup": (round(recompute_wall / refresh_wall, 2)
                    if refresh_wall > 0 else None),
        "per_view": {q: {
            "refresh_wall_s": round(refresh_walls[q], 4),
            "recompute_wall_s": round(recompute_walls[q], 4),
            "speedup": (round(recompute_walls[q] / refresh_walls[q], 2)
                        if refresh_walls[q] > 0 else None),
        } for q in mix},
        "generation_lag": lag_max,
        "reads_total": len(samples),
        "oracle_mismatches": len(mismatches),
        "mismatch_detail": mismatches[:8],
        "errors": len(errors),
        "error_detail": errors[:8],
        "wall_s": round(wall, 3),
        "view_stats": view_stats,
    }


def _check_fields(record: dict, required, what: str) -> None:
    missing = required - record.keys()
    if missing:
        raise AssertionError(f"{what} record dropped fields {missing}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=2,
                   help="queries per client")
    p.add_argument("--sf", type=float, default=0.002)
    p.add_argument("--schedule", default="roundrobin",
                   choices=("roundrobin", "priority"))
    p.add_argument("--slo", type=float, default=0.0,
                   help="per-request SLO seconds (0 = unbounded)")
    p.add_argument("--max-queue", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the device every table and engine runs on "
                        "(default cuda; no fallback to the CPU)")
    p.add_argument("--mix", default=None,
                   help="comma-separated TPC-H query names (default: "
                        f"{','.join(DEFAULT_MIX)}; --refresh default: "
                        f"{','.join(REFRESH_MIX)})")
    p.add_argument("--slo-target", type=float, default=0.0,
                   help="per-tenant success objective for burn-rate "
                        "accounting (e.g. 0.99; 0 = the policy default)")
    p.add_argument("--slo-latency", type=float, default=0.0,
                   help="latency objective seconds (0 = success-only)")
    p.add_argument("--storm", type=int, default=0,
                   help="after the replay, drive N fault-storm requests "
                        "on one tenant and record the /health "
                        "ok->unhealthy->ok transitions + /events replay")
    p.add_argument("--fleet", action="store_true",
                   help="replicated-fleet mode: spawn --engines engine "
                        "PROCESSES over one durable tree, route the mix "
                        "through a FleetRouter, SIGKILL one engine "
                        "mid-run and prove 0 lost acks / 0 "
                        "double-executions across the failover")
    p.add_argument("--engines", type=int, default=2,
                   help="engine count for --fleet (>= 2) and --hot-mix")
    p.add_argument("--no-kill", action="store_true",
                   help="--fleet without the mid-run kill (baseline)")
    p.add_argument("--fleet-trace", action="store_true",
                   help="with --fleet: arm CYLON_TPU_TRACE fleet-wide, "
                        "stitch the router's and every engine's trace "
                        "segments onto one clock and write the Chrome "
                        "trace; the record gains the stitched-request "
                        "report and the cost-model audit")
    p.add_argument("--fleet-root", default=None,
                   help="--fleet durable root (default: a fresh "
                        "temporary directory)")
    p.add_argument("--hot-mix", action="store_true",
                   help="hot-mix dedup mode: replay a hot mix through "
                        "the FleetRouter against a single uncached "
                        "engine, then against the warmed coalescing + "
                        "versioned-result-cache plane, and gate the QPS "
                        "multiplier at >= 10x with 0 oracle mismatches "
                        "and 0 stale results across a mid-probe append")
    p.add_argument("--refresh", action="store_true",
                   help="incremental-view mode: TPC-H RF1-style appends "
                        "interleaved with the mix served as materialized "
                        "views; gate on refresh wall <= 0.5x the "
                        "from-scratch recompute wall with 0 oracle "
                        "mismatches on concurrent reads")
    p.add_argument("--appends", type=int, default=2,
                   help="RF1 append rounds for --refresh")
    p.add_argument("--delta-sf", type=float, default=0.0,
                   help="scale factor of each RF1 delta (0 = sf/100)")
    args = p.parse_args(argv)
    mix_arg = (tuple(q.strip() for q in args.mix.split(",")
                     if q.strip()) if args.mix else None)

    if args.hot_mix:
        record = run_hotmix_bench(
            clients=args.clients, requests=max(args.requests, 2),
            sf=args.sf, seed=args.seed, mix=mix_arg or DEFAULT_MIX,
            engines=args.engines, device=args.device)
        _check_fields(record, REQUIRED_HOTMIX_FIELDS, "hot-mix")
        _emit_record(record)
        if record["oracle_mismatches"] or record["errors"] \
                or record["stale_results"]:
            return 1
        if record["qps_multiplier"] is None \
                or record["qps_multiplier"] < 10.0:
            return 1
        return 0

    if args.refresh:
        record = run_refresh_bench(
            sf=args.sf,
            delta_sf=args.delta_sf if args.delta_sf > 0 else None,
            rounds=args.appends, clients=args.clients,
            seed=args.seed, mix=mix_arg or REFRESH_MIX,
            device=args.device)
        _check_fields(record, REQUIRED_REFRESH_FIELDS, "refresh")
        _emit_record(record)
        if record["oracle_mismatches"] or record["errors"]:
            return 1
        if record["speedup"] is None or record["speedup"] < 2.0:
            return 1
        return 0

    if args.fleet:
        from cylon_tpu_torch.serve.fleet import run_fleet_bench

        record = run_fleet_bench(
            clients=args.clients,
            requests=max(args.requests, 2), sf=args.sf,
            seed=args.seed, engines=args.engines,
            mix=mix_arg or DEFAULT_MIX,
            kill_mid_run=not args.no_kill, root=args.fleet_root,
            fleet_trace=args.fleet_trace, device=args.device)
        _check_fields(record, REQUIRED_FLEET_FIELDS, "fleet")
        if args.fleet_trace:
            _check_fields(record, REQUIRED_FLEET_TRACE_FIELDS,
                          "fleet-trace")
        _emit_record(record)
        if record["lost_acks"] or record["double_executions"] \
                or record["oracle_mismatches"] or record["errors"]:
            return 1
        if not args.no_kill and record["failovers"] < 1:
            return 1
        return 0

    if args.storm:
        # the storm acceptance wants the full plane armed: the event
        # journal and the router's HTTP view of /health
        import os

        os.environ.setdefault("CYLON_TPU_EVENTS", "1")
        os.environ.setdefault("CYLON_TPU_SERVE_HTTP_PORT", "0")

    record = run_bench(
        clients=args.clients, requests=args.requests, sf=args.sf,
        schedule=args.schedule, slo=args.slo,
        max_queue=args.max_queue, seed=args.seed,
        mix=mix_arg or DEFAULT_MIX,
        slo_target=args.slo_target if args.slo_target > 0 else None,
        slo_latency=args.slo_latency if args.slo_latency > 0 else None,
        storm=args.storm, device=args.device)
    _check_fields(record, REQUIRED_SERVE_FIELDS, "serve")
    _emit_record(record)
    if record["oracle_mismatches"] or record["errors"]:
        return 1
    if args.storm and not record.get("storm", {}).get("recovered"):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
