"""The port's serve engine (``cylon_tpu_torch.serve``) against the JAX
package's, case for case from ``tests/test_serve.py``: catalog pins, fast
admission rejection, round-robin and priority interleaving, per-request
SLO expiry, sessions, ``close``, tenant stats, the shared plan cache under
stress, tenant labels on spans, sections and trace events, fault isolation
between tenants (also beside a request that runs ``ThreadWorld(4)`` in its
step), the versioned result cache and append invalidation, coalescing with
leader failure and idempotency eviction. A TPC-H mix served by four
clients equals the JAX package's engine on the same tables and pandas.
Tables live on the CPU; every wait has a timeout, so a wedged scheduler
fails its test instead of stalling the run."""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import Table, catalog, telemetry
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import (DeadlineExceeded, FailedPrecondition,
                                    InvalidArgument, ResourceExhausted,
                                    TransientError)
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.serve import ServeEngine, ServePolicy
from cylon_tpu_torch.serve import service

WAIT = 30


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    yield
    catalog.clear()
    telemetry.reset("serve.")


def _t(n=8):
    return Table.from_pydict({"k": np.arange(n, dtype=np.int64),
                              "v": np.arange(n, dtype=np.float64)},
                             device="cpu")


def _cpu_env():
    return CylonEnv(device="cpu")


def _join_all(threads):
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# ------------------------------------------------------------ catalog pins
def test_pin_blocks_drop_and_names_holder():
    catalog.put_table("lineitem", _t())
    catalog.pin("lineitem", holder="alice/req7")
    with pytest.raises(FailedPrecondition, match="alice/req7"):
        catalog.drop("lineitem", if_exists=False)
    with pytest.raises(FailedPrecondition):
        catalog.put_table("lineitem", _t())
    catalog.unpin("lineitem", holder="alice/req7")
    catalog.drop("lineitem", if_exists=False)
    assert "lineitem" not in catalog.list_tables()


def test_pins_refcount_and_unbalanced_unpin_raises():
    catalog.put_table("t", _t())
    catalog.pin("t", holder="s1")
    catalog.pin("t", holder="s1")
    catalog.pin("t", holder="s2")
    assert catalog.pins("t") == {"s1": 2, "s2": 1}
    catalog.unpin("t", holder="s1")
    with pytest.raises(FailedPrecondition):
        catalog.drop("t")
    catalog.unpin("t", holder="s1")
    catalog.unpin("t", holder="s2")
    with pytest.raises(InvalidArgument):
        catalog.unpin("t", holder="s2")
    catalog.drop("t", if_exists=False)


def test_pinned_context_and_stats():
    catalog.put_table("t", _t(16))
    with catalog.pinned("t", holder="q") as tab:
        assert tab.num_rows == 16
        st = catalog.stats()["t"]
        assert st["rows"] == 16
        assert st["pins"] == 1 and st["holders"] == ["q"]
        assert st["bytes"] == 16 * 8 * 2
        assert st["columns"] == 2 and not st["distributed"]
    assert catalog.stats()["t"]["pins"] == 0
    catalog.remove_table("t")


# -------------------------------------------------------------- admission
def test_queue_cap_rejects_fast_with_resource_exhausted():
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    gate = threading.Event()

    def gated():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return "done"

    t1 = eng.submit(gated, tenant="a")
    t2 = eng.submit(gated, tenant="a")
    t0 = time.perf_counter()
    with pytest.raises(ResourceExhausted, match="cap 2"):
        eng.submit(gated, tenant="b")
    assert time.perf_counter() - t0 < 0.5
    assert telemetry.counter("serve.rejected", tenant="b").value == 1
    gate.set()
    assert t1.result(WAIT) == "done" and t2.result(WAIT) == "done"
    assert eng.submit(lambda: 1, tenant="b").result(WAIT) == 1
    eng.close()


def _logged_worker(log, name, steps):
    def run():
        for _ in range(steps):
            log.append(name)
            yield
        return name

    return run


def test_roundrobin_interleaves_concurrent_queries():
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    log = []
    # both requests enter the execution set atomically (the engine's
    # condition is an RLock): every sweep from the first sees both ops
    with eng._cond:
        ta = eng.submit(_logged_worker(log, "a", 3), tenant="a")
        tb = eng.submit(_logged_worker(log, "b", 3), tenant="b")
    assert ta.result(WAIT) == "a" and tb.result(WAIT) == "b"
    ab = [x for x in log if x in ("a", "b")]
    assert len(ab) == 6
    assert all(ab[i] != ab[i + 1] for i in range(len(ab) - 1)), ab
    eng.close()


def test_priority_schedule_weights_tenant_steps():
    eng = ServeEngine(policy=ServePolicy(max_queue=8, schedule="priority"))
    log = []
    with eng._cond:
        th = eng.submit(_logged_worker(log, "heavy", 6), tenant="heavy",
                        priority=2)
        tl = eng.submit(_logged_worker(log, "light", 6), tenant="light",
                        priority=1)
    assert th.result(WAIT) == "heavy" and tl.result(WAIT) == "light"
    hl = [x for x in log if x in ("heavy", "light")]
    assert len(hl) == 12
    last_heavy = max(i for i, x in enumerate(hl) if x == "heavy")
    last_light = max(i for i, x in enumerate(hl) if x == "light")
    assert last_heavy < last_light, hl
    assert hl[:6].count("heavy") >= 3, hl
    eng.close()


def test_slo_expiry_fails_request_with_deadline_exceeded():
    eng = ServeEngine(policy=ServePolicy(max_queue=4))

    def slow():
        time.sleep(0.2)
        yield
        time.sleep(0.2)
        yield
        return "never"

    tk = eng.submit(slow, tenant="slo", slo=0.05)
    with pytest.raises(DeadlineExceeded, match="serve"):
        tk.result(WAIT)
    assert tk.state == "failed"
    assert isinstance(tk.error, DeadlineExceeded)
    assert eng.submit(lambda: 42, tenant="slo", slo=30.0).result(WAIT) == 42
    eng.close()


def test_request_pins_protect_tables_and_release_on_retirement():
    catalog.put_table("resident", _t())
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    gate = threading.Event()

    def reader():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return catalog.get_table("resident").num_rows

    tk = eng.submit(reader, tenant="a", tables=["resident"])
    with pytest.raises(FailedPrecondition, match="a/req"):
        eng.drop_table("resident")
    gate.set()
    assert tk.result(WAIT) == 8
    eng.drop_table("resident")
    eng.close()


def test_session_pins_and_submits_under_tenant():
    catalog.put_table("t", _t())
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    with eng.session("alice", priority=2, tables=["t"]) as s:
        assert catalog.pins("t") == {s.holder: 1}
        with pytest.raises(FailedPrecondition, match="session:alice"):
            catalog.drop("t")
        assert s.table("t").num_rows == 8
        with pytest.raises(InvalidArgument):
            s.table("unattached")
        assert s.submit(lambda: "ok").result(WAIT) == "ok"
    assert catalog.pins("t") == {}
    assert eng.tenant_stats()["alice"]["completed"] == 1
    eng.close()


def test_engine_close_refuses_abandoning_live_requests():
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    gate = threading.Event()

    def gated():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return 1

    tk = eng.submit(gated, tenant="a")
    with pytest.raises(FailedPrecondition, match="live request"):
        eng.close(wait=False)
    gate.set()
    assert tk.result(WAIT) == 1
    eng.close(wait=True)
    with pytest.raises(InvalidArgument):
        eng.submit(lambda: 1)


def test_close_lets_go_of_retired_tickets_and_cached_results():
    """A retired ticket's result keeps its memory alive while the engine
    holds the ticket: ``close`` empties the rid history, the idempotency
    map and the result cache."""
    catalog.put_table("t", _t(16))
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    eng.register_query("v", lambda: catalog.get_table("t").column(
        "v").data * 2, tables=["t"])
    tk = eng.submit_named("v", idempotency_key="k")
    assert tk.result(WAIT).shape == (16,)
    assert eng.ticket(tk.rid) is tk and "k" in eng._idem
    assert len(eng._result_cache) == 1
    eng.close()
    assert eng.ticket(tk.rid) is None and eng._idem == {}
    assert len(eng._result_cache) == 0


def test_tenant_stats_report_latency_quantiles():
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    for _ in range(4):
        eng.submit(lambda: 1, tenant="q").result(WAIT)
    st = eng.tenant_stats()["q"]
    assert st["requests"] == 4 and st["completed"] == 4
    assert st["p50_s"] is not None and st["p99_s"] >= st["p50_s"] >= 0
    eng.close()


# ------------------------------------------- shared compiled-plan cache
def test_plan_cache_shared_and_thread_safe_under_stress():
    """Concurrent lookups from many threads: every call right, and the
    first sight of each memo entry counted exactly once."""
    from cylon_tpu_torch import plan
    from cylon_tpu_torch.ops.groupby import groupby_aggregate

    def q(t):
        return groupby_aggregate(t, ["k"], [("v", "sum", "s")])

    telemetry.reset("plan.cache")
    cq = plan.shared_compiled(q)
    assert plan.shared_compiled(q) is cq

    def table(n):
        return Table.from_pydict({
            "k": (np.arange(n, dtype=np.int64) % 4),
            "v": np.ones(n, dtype=np.float64)}, device="cpu")

    sizes = [32, 32, 64, 32, 64, 128]
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(6):
            n = int(rng.choice(sizes))
            out = cq(table(n))
            got = dict(zip(out.column("k").data[:out.num_rows].tolist(),
                           out.column("s").data[:out.num_rows].tolist()))
            if got != {k: float(n // 4) for k in range(4)}:
                errors.append((n, got))

    import sys

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)        # switch threads often: races show
    try:
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    hits = telemetry.total("plan.cache_hits")
    misses = telemetry.total("plan.cache_misses")
    assert misses == len(cq._scale_memo)
    assert hits + misses >= 8 * 6
    assert hits > 0


def test_plan_cache_eviction_counter(monkeypatch):
    from cylon_tpu_torch import plan

    telemetry.reset("plan.cache")
    monkeypatch.setattr(plan, "_MEMO_ENTRIES", 2)
    cq = plan.CompiledQuery(lambda t: t)
    for n in (8, 16, 32, 64):
        cq(_t(n))
    assert telemetry.total("plan.cache_evictions") >= 2
    assert len(cq._scale_memo) <= 2
    stats = plan.plan_cache_stats()
    assert stats["misses"] >= 4 and stats["evictions"] >= 2


def test_serve_clients_share_plan_cache():
    """Two tenants submitting the same compiled query: the second call
    is a cache hit (the JAX case's ``env8`` runs at W = 1 here)."""
    from cylon_tpu_torch import plan
    from cylon_tpu_torch.parallel.dist_ops import dist_aggregate

    env = _cpu_env()

    def q(t):
        return dist_aggregate(env, t, "v", "sum")

    cq = plan.shared_compiled(q)
    t = _t(64)
    telemetry.reset("plan.cache")
    eng = ServeEngine(env, ServePolicy(max_queue=4))
    r1 = eng.submit(lambda: float(cq(t)), tenant="a")
    r2 = eng.submit(lambda: float(cq(t)), tenant="b")
    assert r1.result(WAIT) == r2.result(WAIT) == pytest.approx(
        float(np.arange(64).sum()))
    assert telemetry.total("plan.cache_hits") >= 1
    eng.close()


# ---------------------------------------------- per-tenant observability
def test_span_and_section_metrics_carry_tenant_labels():
    from cylon_tpu_torch import watchdog
    from cylon_tpu_torch.utils import tracing

    telemetry.reset("tracing.")
    telemetry.reset("watchdog.")
    with telemetry.tenant_scope("alice"):
        with tracing.span("tenant.op"):
            pass
        with watchdog.watched_section("serve_request", detail="x"):
            pass
    with tracing.span("tenant.op"):
        pass
    series = {tuple(sorted(labels.items()))
              for _, labels, _ in telemetry.instruments(
                  "tracing.span_seconds")}
    assert (("name", "tenant.op"), ("tenant", "alice")) in series
    assert (("name", "tenant.op"),) in series
    assert tracing.timings(tenant="alice")["tenant.op"].count == 1
    assert tracing.timings()["tenant.op"].count == 2
    assert "tenant.op" in tracing.report(tenant="alice")
    assert tracing.report(tenant="bob") == "(no spans recorded)"
    rep = watchdog.straggler_report(tenant="alice")
    assert rep["serve_request"]["count"] == 1
    assert watchdog.straggler_report(tenant="bob") == {}
    assert watchdog.timings(tenant="alice")[0].tenant == "alice"


def test_trace_events_stamped_and_filterable_by_tenant(monkeypatch):
    from cylon_tpu_torch.telemetry import trace
    from cylon_tpu_torch.utils import tracing

    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    trace.clear()
    with telemetry.tenant_scope("alice"):
        with tracing.span("alice.op"):
            trace.instant("alice.inner")
    with telemetry.tenant_scope("bob"):
        with tracing.span("bob.op"):
            pass
    trace.instant("untenanted")
    evts = trace.events()
    alice = trace.filter_tenant(evts, "alice")
    assert {e["name"] for e in alice} == {"alice.op", "alice.inner"}
    kinds = [e["kind"] for e in alice if e["name"] == "alice.op"]
    assert kinds.count("begin") == kinds.count("end") == 1
    assert {e["name"] for e in trace.filter_tenant(evts, "bob")} \
        == {"bob.op"}
    trace.clear()


def test_straggler_report_timeline_tenant_filter(monkeypatch):
    from cylon_tpu_torch import watchdog
    from cylon_tpu_torch.telemetry import trace

    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    trace.clear()
    with telemetry.tenant_scope("noisy"):
        trace.complete("exchange", 0.5, cat="stage")
    with telemetry.tenant_scope("quiet"):
        trace.complete("exchange", 0.01, cat="stage")
    merged = trace.merge_timelines([(0, trace.events())])
    rep = watchdog.straggler_report(timeline=merged, tenant="quiet")
    assert rep["stage_seconds"][0]["exchange"] == pytest.approx(0.01)
    rep_all = watchdog.straggler_report(timeline=merged)
    assert rep_all["stage_seconds"][0]["exchange"] == pytest.approx(0.51)
    trace.clear()


# ------------------------------------------------- fault isolation (SLA)
def _sorted_frame(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _assert_frames_close(got, want):
    got, want = _sorted_frame(got), _sorted_frame(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        np.testing.assert_allclose(np.asarray(got[c], dtype=float),
                                   np.asarray(want[c], dtype=float),
                                   rtol=1e-9)


@pytest.mark.parametrize("quiet_world", [1, 4])
def test_fault_isolation_between_tenants(quiet_world):
    """Faults injected into ONE tenant's stream fail that tenant's
    queries only; the other tenant's concurrent queries — at W = 1, or at
    W = 4 on ``ThreadWorld`` inside the request's step — return
    oracle-exact results with unpolluted metrics. At W = 1 the port's
    ``dist_join`` moves no rows and so never reaches the ``exchange``
    injection point, so the noisy plan targets the compiled query's
    ``plan`` point: the first dispatch delayed, every later one failing
    (the JAX case delays and then fails the exchange)."""
    from cylon_tpu_torch import resilience, tpch
    from cylon_tpu_torch.resilience import FaultPlan, FaultRule

    telemetry.reset("resilience.")
    env = _cpu_env()
    data = tpch.generate(0.001, 3)
    frames = tpch.ingest(data, device="cpu")
    cq = tpch.compiled("q3")
    oracle = tpch.q3(frames, env=env).to_pandas().reset_index(drop=True)
    noisy_plan = FaultPlan([
        FaultRule("plan", nth=1, delay=0.02, times=1),
        FaultRule("plan", nth=2, times=0,
                  error=TransientError("injected plan loss")),
    ])
    eng = ServeEngine(env, ServePolicy(max_queue=8))

    def noisy_q():
        cq(frames, env=env)
        yield
        return cq(frames, env=env).to_pandas()

    def quiet_q():
        if quiet_world == 1:
            cq(frames, env=env)
            yield
            return cq(frames, env=env).to_pandas().reset_index(drop=True)

        def rank(comm):
            e = CylonEnv(comm, device="cpu")
            return tpch.q3(frames, env=e).to_pandas()

        parts = ThreadWorld(quiet_world).run(rank)
        yield
        return parts[0].reset_index(drop=True)

    tickets = []
    for _ in range(2):
        tickets.append(("noisy", eng.submit(
            noisy_q, tenant="noisy", fault_plan=noisy_plan.reset())))
        tickets.append(("quiet", eng.submit(quiet_q, tenant="quiet")))
    noisy_failures = quiet_ok = 0
    for tenant, tk in tickets:
        if tenant == "noisy":
            with pytest.raises(TransientError, match="injected"):
                tk.result(120)
            noisy_failures += 1
        else:
            _assert_frames_close(tk.result(120), oracle)
            quiet_ok += 1
    assert noisy_failures == 2 and quiet_ok == 2
    for _, labels, inst in telemetry.instruments(
            "resilience.faults_injected"):
        assert labels.get("tenant") == "noisy", labels
        assert inst.value > 0
    assert telemetry.total("resilience.faults_injected") > 0
    stats = eng.tenant_stats()
    assert stats["quiet"]["completed"] == 2
    assert stats["quiet"].get("errors", 0) == 0
    assert stats["noisy"].get("errors", 0) == 2
    assert resilience.active_plan() is None
    eng.close()


# ------------------------------------------------ the TPC-H mix, served
MIX = ("q1", "q3", "q5", "q6", "q14")


def _host(out):
    return out.to_pandas().reset_index(drop=True) \
        if hasattr(out, "to_pandas") else float(out)


def _pandas_oracles(data):
    import chip_smoke as cs
    from cylon_tpu_torch import tpch

    pdfs = {k: pd.DataFrame(v) for k, v in data.items() if v}
    di = tpch.date_int
    return {"q1": cs.tpch_q1_pandas(pdfs, di),
            "q3": cs.tpch_q3_pandas(pdfs, di),
            "q5": cs.tpch_q5_pandas(pdfs, di).reset_index(drop=True),
            "q6": cs.tpch_q6_numpy(data["lineitem"], di),
            "q14": cs.tpch_q14_pandas(pdfs, di)}


def _serve_mix(ServeEngineCls, Policy, compiled, frames, env, clients):
    """The JAX package's serve-bench replay (``cylon_tpu/serve/
    bench.py:196-210, 404-427``): each client its own tenant and
    session, two two-step staged requests of ``MIX[(i + r) % 5]``."""
    eng = ServeEngineCls(env, Policy(max_queue=64))
    results, errors, lock = {}, [], threading.Lock()

    def staged(cq):
        def run():
            out = cq(frames, env=env)
            yield
            return _host(out)
        return run

    def client(i):
        tickets = []
        with eng.session(f"tenant{i}", tables=[]) as s:
            for r in range(2):
                q = MIX[(i + r) % len(MIX)]
                tickets.append((q, s.submit(staged(compiled[q]))))
            for r, (q, tk) in enumerate(tickets):
                try:
                    got = tk.result(120)
                except Exception as e:          # noqa: BLE001 - reported
                    with lock:
                        errors.append((i, q, repr(e)))
                    continue
                with lock:
                    results[(i, r)] = (q, got)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    _join_all(threads)
    stats = eng.tenant_stats()
    eng.close()
    return results, errors, stats


def test_tpch_mix_served_matches_the_jax_engine_and_pandas():
    """A TPC-H mix at SF 0.002 (seed 3) served to four clients by the
    port's engine equals the same replay through the JAX package's
    engine on the same tables, and pandas (floats at rtol 1e-9)."""
    import cylon_tpu.tpch as jtpch
    from cylon_tpu import catalog as jcat
    from cylon_tpu.serve import ServeEngine as JServeEngine
    from cylon_tpu.serve import ServePolicy as JServePolicy
    from cylon_tpu_torch import tpch

    import chip_smoke as cs

    data = tpch.generate(0.002, 3)
    frames = tpch.ingest(data, device="cpu")
    env = _cpu_env()
    got, errs, stats = _serve_mix(
        ServeEngine, ServePolicy, {q: tpch.compiled(q) for q in MIX},
        frames, env, clients=4)
    assert errs == [] and len(got) == 8
    assert all(stats[f"tenant{i}"]["completed"] == 2 for i in range(4))
    jcat.clear()
    try:
        jframes = jtpch.ingest(data)
        want, jerrs, _ = _serve_mix(
            JServeEngine, JServePolicy,
            {q: jtpch.compiled(q) for q in MIX}, jframes, None, clients=4)
    finally:
        jcat.clear()
    assert jerrs == [] and set(want) == set(got)
    oracles = _pandas_oracles(data)
    for key, (q, res) in got.items():
        assert want[key][0] == q
        assert cs.results_match(np, res, want[key][1]), (key, q)
        ok = cs.q3_matches(np, res, oracles[q]) if q == "q3" else \
            cs.results_match(np, res, oracles[q])
        assert ok, (key, q)


# ===================================================================
# coalescing + the versioned result cache
# ===================================================================
def _vsum_query(execs):
    def q():
        execs.append(1)
        d = catalog.table_to_pydict("t")
        return float(np.asarray(d["v"]).sum())
    return q


def test_result_cache_hit_is_byte_identical_and_journaled(tmp_path):
    from cylon_tpu_torch.serve.durability import RequestJournal

    catalog.put_table("t", _t(16))
    eng = ServeEngine(policy=ServePolicy(max_queue=8),
                      durable_dir=str(tmp_path))
    execs = []

    def q():
        execs.append(1)
        d = catalog.table_to_pydict("t")
        return np.asarray(d["v"], dtype=np.float64) * 3.0

    eng.register_query("triple", q, tables=["t"])
    t1 = eng.submit_named("triple", tenant="a")
    v1 = t1.result(WAIT)
    t2 = eng.submit_named("triple", tenant="b")
    v2 = t2.result(WAIT)
    assert execs == [1]
    assert t2.cache_hit and not t1.cache_hit
    assert v2.tobytes() == v1.tobytes() and v2.dtype == v1.dtype
    assert t1.cache_key is not None and t2.cache_key == t1.cache_key
    assert telemetry.counter("serve.admitted", path="executed",
                             tenant="a").value == 1
    assert telemetry.counter("serve.admitted", path="cache_hit",
                             tenant="b").value == 1
    assert telemetry.total("serve.result_cache_hits") == 1
    eng.close()
    lines = RequestJournal.read(str(tmp_path))
    admit_rids = {e["rid"] for e in lines if e["kind"] == "admit"}
    done_rids = {e["rid"] for e in lines if e["kind"] == "done"}
    assert {t1.rid, t2.rid} <= admit_rids
    assert admit_rids == done_rids
    eng2 = ServeEngine.recover(str(tmp_path), env=_cpu_env(),
                               queries={"triple": q})
    assert eng2.recovery_report["replayed"] == {}
    assert execs == [1]
    eng2.close()


def test_append_between_submissions_forces_miss_never_stale():
    catalog.put_table("t", _t(4))
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    execs = []
    eng.register_query("vsum", _vsum_query(execs), tables=["t"])
    assert eng.submit_named("vsum").result(WAIT) == 6.0
    hit = eng.submit_named("vsum")
    assert hit.result(WAIT) == 6.0 and hit.cache_hit
    misses0 = telemetry.total("serve.result_cache_misses")
    catalog.append("t", {"k": np.asarray([100], dtype=np.int64),
                         "v": np.asarray([10.0], dtype=np.float64)})
    assert telemetry.total("serve.result_cache_invalidations") >= 1
    t3 = eng.submit_named("vsum")
    assert t3.result(WAIT) == 16.0
    assert not t3.cache_hit
    assert execs == [1, 1]
    assert telemetry.total("serve.result_cache_misses") > misses0
    eng.close()


def test_append_table_through_the_engine_invalidates_and_snapshots(
        tmp_path):
    """``engine.append_table`` bumps the generation, the next identical
    submit misses and equals a fresh run, and a recovery restores the
    post-append generation on the CPU env's device."""
    eng = ServeEngine(_cpu_env(), ServePolicy(max_queue=8),
                      durable_dir=str(tmp_path))
    eng.register_table("t", _t(4))
    execs = []
    eng.register_query("vsum", _vsum_query(execs), tables=["t"])
    assert eng.submit_named("vsum").result(WAIT) == 6.0
    assert eng.submit_named("vsum").result(WAIT) == 6.0
    res = eng.append_table("t", pd.DataFrame({"k": [7], "v": [1.5]}))
    assert res == {"generation": 2, "delta_rows": 1, "rows": 5}
    again = eng.submit_named("vsum")
    assert again.result(WAIT) == 7.5 and not again.cache_hit
    assert execs == [1, 1]
    eng.close()
    catalog.clear()
    eng2 = ServeEngine.recover(str(tmp_path), env=_cpu_env())
    assert eng2.recovery_report["restored_tables"] == ["t"]
    assert catalog.generation("t") == 2
    assert catalog.get_table("t").device.type == "cpu"
    assert catalog.get_table("t").num_rows == 5
    eng2.close()


def test_append_mid_flight_blocks_stale_store():
    catalog.put_table("t", _t(4))
    gate = threading.Event()
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    execs = []

    def q():
        execs.append(1)
        while not gate.is_set():
            yield
            time.sleep(0.001)
        d = catalog.table_to_pydict("t")
        return float(np.asarray(d["v"]).sum())

    eng.register_query("vsum", q, tables=["t"])
    t1 = eng.submit_named("vsum")
    catalog.append("t", {"k": np.asarray([100], dtype=np.int64),
                         "v": np.asarray([10.0], dtype=np.float64)})
    gate.set()
    assert t1.result(WAIT) == 16.0
    assert t1.cache_key is None
    t2 = eng.submit_named("vsum")
    assert t2.result(WAIT) == 16.0 and not t2.cache_hit
    assert execs == [1, 1]
    eng.close()


def test_coalesced_fanout_byte_identical_to_independent_runs(monkeypatch):
    catalog.put_table("t", _t(32))

    def mk_query(execs, gate=None):
        def q():
            execs.append(1)
            if gate is not None:
                while not gate.is_set():
                    yield
                    time.sleep(0.001)
            d = catalog.table_to_pydict("t")
            return np.asarray(d["v"], dtype=np.float64) * 2.0
        return q

    # baseline: every dedup layer off -> three independent runs
    monkeypatch.setattr(service, "RESULT_CACHE_BYTES", 0)
    monkeypatch.setattr(service, "COALESCE", False)
    base_execs = []
    eng0 = ServeEngine(policy=ServePolicy(max_queue=16))
    eng0.register_query("double", mk_query(base_execs), tables=["t"])
    baseline = [eng0.submit_named("double", tenant=t).result(WAIT)
                for t in ("a", "b", "c")]
    eng0.close()
    assert len(base_execs) == 3
    telemetry.reset("serve.")
    monkeypatch.setattr(service, "COALESCE", True)
    gate = threading.Event()
    hot_execs = []
    eng = ServeEngine(policy=ServePolicy(max_queue=16))
    eng.register_query("double", mk_query(hot_execs, gate), tables=["t"])
    leader = eng.submit_named("double", tenant="a")
    f1 = eng.submit_named("double", tenant="b")
    f2 = eng.submit_named("double", tenant="c", slo=30.0)
    fx = eng.submit_named("double", tenant="d", slo=0.15)
    assert leader.coalesced_role == "leader"
    assert (f1.coalesced_role, f2.coalesced_role,
            fx.coalesced_role) == ("follower",) * 3
    deadline = time.monotonic() + 10
    while not fx.done and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fx.done
    with pytest.raises(DeadlineExceeded):
        fx.result(1)
    assert telemetry.counter("serve.expired", tenant="d").value == 1
    gate.set()
    got = [leader.result(WAIT), f1.result(WAIT), f2.result(WAIT)]
    assert len(hot_execs) == 1
    for g in got:
        assert g.tobytes() == baseline[0].tobytes()
        assert g.dtype == baseline[0].dtype
    assert telemetry.total("serve.coalesced") == 3
    for tn in ("b", "c", "d"):
        assert telemetry.counter("serve.admitted", path="coalesced",
                                 tenant=tn).value == 1
        assert telemetry.timer("serve.queue_wait_seconds",
                               tenant=tn).count == 0
    assert telemetry.counter("serve.admitted", path="executed",
                             tenant="a").value == 1
    snap = eng._admission.breaker.snapshot()
    assert snap["window_failures"] == 0 and snap["state"] == "closed"
    eng.close()


def test_leader_failure_requeues_followers_with_budget(monkeypatch):
    monkeypatch.setattr(service, "RESULT_CACHE_BYTES", 0)
    catalog.put_table("t", _t(8))
    gate = threading.Event()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            while not gate.is_set():
                yield
                time.sleep(0.001)
            raise TransientError("first run dies")
        return 42

    eng = ServeEngine(policy=ServePolicy(max_queue=16))
    eng.register_query("flaky", flaky, tables=["t"])
    leader = eng.submit_named("flaky", tenant="a")
    keep = eng.submit_named("flaky", tenant="b")
    doomed = eng.submit_named("flaky", tenant="c", slo=0.15)
    assert keep.coalesced_role == "follower"
    assert doomed.coalesced_role == "follower"
    deadline = time.monotonic() + 10
    while not doomed.done and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    with pytest.raises(TransientError):
        leader.result(WAIT)
    assert keep.result(WAIT) == 42
    with pytest.raises((TransientError, DeadlineExceeded)):
        doomed.result(WAIT)
    assert len(calls) == 2
    eng.close()


def test_cache_hits_never_observe_queue_wait():
    catalog.put_table("t", _t(8))
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    execs = []
    eng.register_query("vsum", _vsum_query(execs), tables=["t"])
    eng.submit_named("vsum", tenant="a").result(WAIT)
    waits = telemetry.timer("serve.queue_wait_seconds", tenant="a").count
    assert waits == 1
    hit = eng.submit_named("vsum", tenant="a")
    assert hit.result(WAIT) == 28.0 and hit.cache_hit
    assert telemetry.timer("serve.queue_wait_seconds",
                           tenant="a").count == waits
    assert execs == [1]
    eng.close()


def test_idem_eviction_drops_oldest_retired_first(monkeypatch):
    monkeypatch.setattr(service, "IDEM_ENTRIES", 3)
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    gates = {k: threading.Event() for k in ("k1", "k2", "k3")}

    def mk(k):
        def q():
            while not gates[k].is_set():
                yield
                time.sleep(0.001)
            return k
        return q

    tks = {k: eng.submit(mk(k), idempotency_key=k)
           for k in ("k1", "k2", "k3")}
    for k in ("k2", "k3", "k1"):
        gates[k].set()
        assert tks[k].result(WAIT) == k
        time.sleep(0.02)
    t4 = eng.submit(lambda: 4, idempotency_key="k4")
    assert t4.result(WAIT) == 4
    with eng._cond:
        keys = set(eng._idem)
    assert keys == {"k1", "k3", "k4"}
    eng.close()


def test_recent_history_is_bounded(monkeypatch):
    monkeypatch.setattr(service, "RECENT_ENTRIES", 2)
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    tks = [eng.submit(lambda i=i: i) for i in range(4)]
    assert [t.result(WAIT) for t in tks] == [0, 1, 2, 3]
    assert [eng.ticket(t.rid) for t in tks] == [None, None, tks[2], tks[3]]
    eng.close()


# ------------------------------------------------- the write-ahead rule
def _engine_methods(path):
    import ast

    tree = ast.parse(path.read_text(), filename=str(path))
    cls = next(n for n in ast.iter_child_nodes(tree)
               if isinstance(n, ast.ClassDef) and n.name == "ServeEngine")
    return [n for n in ast.iter_child_nodes(cls)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _method_calls(fn, attr: str) -> list:
    import ast

    return [node.lineno for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr]


def test_write_ahead_invariant_journal_before_dispatch():
    """The static check of ``tests/test_bench_guard.py:494`` on the
    port's ``serve/service.py``: ops enter the execution set only in
    ``_dispatch``, and every method that reaches ``_dispatch`` calls
    ``_journal_admit`` first."""
    from pathlib import Path

    path = Path(service.__file__)
    methods = _engine_methods(path)
    assert [m.name for m in methods if _method_calls(m, "add_op")] \
        == ["_dispatch"]
    submitters = [m for m in methods if _method_calls(m, "_dispatch")]
    assert submitters
    for m in submitters:
        journal = _method_calls(m, "_journal_admit")
        assert journal, f"ServeEngine.{m.name} dispatches unjournaled"
        assert min(journal) < min(_method_calls(m, "_dispatch")), m.name


def test_durable_mutations_maintain_catalog_snapshot():
    from pathlib import Path

    methods = {m.name: m for m in _engine_methods(Path(service.__file__))}
    assert _method_calls(methods["register_table"], "save")
    assert _method_calls(methods["append_table"], "save")
    assert _method_calls(methods["drop_table"], "drop")
