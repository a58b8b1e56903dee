"""Fleet-wide tracing and query-profile history in the port (case for
case from ``tests/test_fleet_trace.py``): the cursored ``/trace?since=``
segments and their gap accounting, trace-context stamping, the
cross-process merge and ``fleet_request_report``, the Chrome export's
process tracks, the router's midpoint clock handshake, the bounded
profile history and its fleet-wide merge, the unarmed contract (no
recorder, no trace id), and — with two real ``--device cpu`` engine
processes, one hard-killed — a failover replay that keeps ONE trace id
across three process clocks. Every wait takes an explicit timeout and
every child is ended in a ``finally``.
"""

import concurrent.futures as cf
import json
import os
import time

import pytest

from cylon_tpu_torch import catalog, telemetry
from cylon_tpu_torch.resilience import KILL_EXIT_CODE
from cylon_tpu_torch.serve import ServeEngine, ServePolicy
from cylon_tpu_torch.serve.fleet import (FleetLayout, FleetRouter,
                                   LocalEngineClient, _affinity_order,
                                   spawn_engine)
from cylon_tpu_torch.telemetry import trace
from cylon_tpu_torch.telemetry.profile import (HISTORY_FILE, ProfileHistory,
                                         explain, merged_history)


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")
    yield
    catalog.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")


@pytest.fixture
def armed(monkeypatch):
    """Arm the recorder with a FRESH buffer; disarm + drop it after."""
    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    yield
    monkeypatch.setattr(trace, "_RECORDER", None)


# ------------------------------------------------- cursored segments
def test_trace_since_cursor_resumes_and_counts_gap(armed, monkeypatch):
    monkeypatch.setenv("CYLON_TPU_TRACE_EVENTS", "16")  # the floor
    monkeypatch.setattr(trace, "_RECORDER", None)
    for i in range(5):
        trace.instant("e", i=i)
    seg = trace.since(0)
    assert seg["armed"] and seg["dropped"] == 0
    assert [e["args"]["i"] for e in seg["events"]] == list(range(5))
    cur = seg["cursor"]
    assert cur == 5
    # nothing new: an idle poll is empty, cursor stable
    again = trace.since(cur)
    assert again["events"] == [] and again["dropped"] == 0
    assert again["cursor"] == cur
    # 20 more events through a ring of 16: the consumer resuming from
    # cursor 5 sees ONLY the newest 16 (seqs 10..25) and an explicit
    # 4-event gap — never a silently shortened stream
    for i in range(20):
        trace.instant("f", i=i)
    seg2 = trace.since(cur)
    assert len(seg2["events"]) == 16
    assert seg2["dropped"] == 4
    assert [e["args"]["i"] for e in seg2["events"]] == list(range(4, 20))
    assert seg2["cursor"] == 25


def test_trace_since_unarmed_says_so(monkeypatch):
    """A never-armed process answers /trace with an explicit
    armed=False stub — not a deceptively empty stream."""
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    monkeypatch.setattr(trace, "_RECORDER", None)
    seg = trace.since(7)
    assert seg == {"events": [], "cursor": 7, "dropped": 0,
                   "armed": False}


def test_trace_endpoint_serves_cursored_segments(armed):
    """The read-only introspect handler speaks the same since= shape
    as the module API."""
    from cylon_tpu_torch.serve.introspect import IntrospectServer

    trace.instant("via_http", k=1)
    engine = ServeEngine(policy=ServePolicy(max_queue=2))
    srv = IntrospectServer(engine, port=0)
    try:
        import urllib.request

        with urllib.request.urlopen(
                srv.url + "/trace?since=0", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["armed"] is True
        assert any(e["name"] == "via_http" for e in doc["events"])
        cur = doc["cursor"]
        with urllib.request.urlopen(
                srv.url + f"/trace?since={cur}", timeout=10) as r:
            doc2 = json.loads(r.read().decode())
        assert doc2["events"] == []
    finally:
        srv.close()
        engine.close()


# ------------------------------------------------- context stamping
def test_trace_context_stamps_every_event_in_scope(armed):
    with trace.trace_context("tid-1", parent_span=77):
        with trace.span("a"):
            trace.instant("tick")
    trace.instant("outside")
    evts = {(e["kind"], e["name"]): e for e in trace.events()}
    a_b = evts[("begin", "a")]
    # no LOCAL parent: the begin links back across the process hop via
    # the advisory parent_span key (ids are per-process counters — the
    # trace_id is the chain)
    assert a_b["trace_id"] == "tid-1" and a_b["parent"] is None
    assert a_b["parent_span"] == 77
    tick = evts[("instant", "tick")]
    # a local parent wins over the hop link; the id still stamps
    assert tick["trace_id"] == "tid-1" and tick["parent"] == a_b["id"]
    assert "parent_span" not in tick
    # end events carry no stamps — request_timeline follows them via
    # their begin's (track, id), the filter_tenant discipline
    a_e = next(e for e in trace.events() if e["kind"] == "end")
    assert "trace_id" not in a_e and a_e["id"] == a_b["id"]
    assert "trace_id" not in evts[("instant", "outside")]
    line = trace.request_timeline(trace.events(), "tid-1")
    assert [e["kind"] for e in line] == ["begin", "instant", "end"]


def test_trace_context_none_is_passthrough(armed):
    with trace.trace_context(None, parent_span=5):
        trace.instant("plain")
    (e,) = trace.events()
    assert "trace_id" not in e and e["parent"] is None
    assert trace.current_trace_id() is None


# --------------------------------------------- merge + phase report
def test_fleet_request_report_stitches_proc_tracks(armed):
    tid = trace.new_trace_id()
    # router track: the outermost fleet.submit span + a replay hop
    with trace.trace_context(tid):
        tok = trace.begin("fleet.submit", cat="fleet", query="q")
        trace.end(tok)
        trace.instant("fleet.replay_hop", cat="fleet", engine="e1")
    router_evts = trace.events()
    trace.clear()
    # engine track, its clock running 5s FAST (the handshake offset)
    with trace.trace_context(tid, parent_span=tok[0]):
        trace.instant("serve.admit", cat="serve", rid=1)
        with trace.span("serve.step", cat="serve", rid=1):
            time.sleep(0.01)
    eng_evts = [dict(e, ts=e["ts"] + 5.0) for e in trace.events()]
    merged = trace.merge_timelines([
        {"proc": "router", "pid": 10, "clock_offset": 0.0,
         "events": router_evts},
        {"proc": "e1", "pid": 11, "clock_offset": 5.0,
         "events": eng_evts},
    ])
    # proc names became track keys and the offset subtracted the skew
    assert {e["proc"] for e in merged} == {"router", "e1"}
    raw_admit = next(e for e in eng_evts if e["name"] == "serve.admit")
    al_admit = next(e for e in merged if e["name"] == "serve.admit")
    assert al_admit["ts"] == pytest.approx(raw_admit["ts"] - 5.0)

    rep = trace.fleet_request_report(merged, tid)
    assert rep["trace_id"] == tid
    assert rep["procs"] == ["e1", "router"]
    assert rep["monotone"]
    assert rep["spans"] >= 2  # fleet.submit + serve.step
    assert rep["replay_hops"] == [
        {"engine": "e1", "ts": pytest.approx(
            next(e["ts"] for e in router_evts
                 if e["name"] == "fleet.replay_hop"))}]
    ph = rep["phases"]
    assert ph["router_queue_s"] >= 0.0
    assert ph["engine_queue_s"]["e1"] >= 0.0
    assert ph["dispatch_s"]["e1"] == pytest.approx(0.01, abs=0.05)


def test_fleet_trace_artifact_headlines_widest_replay(armed, tmp_path):
    """When several requests replayed, the artifact's stitched report
    headlines the trace id surviving on the MOST process tracks — not
    the lexicographically first — so a victim engine's partial run is
    shown whenever any replayed trace still carries it."""
    from cylon_tpu_torch.serve import fleet as fleet_mod

    narrow, wide = "aaaa000000000001", "bbbb000000000002"
    # router track: both requests replayed (a hop each); lexicographic
    # order favours the NARROW one — coverage must override it
    for tid in (narrow, wide):
        with trace.trace_context(tid):
            tok = trace.begin("fleet.submit", cat="fleet")
            trace.end(tok)
            trace.instant("fleet.replay_hop", cat="fleet",
                          engine="e1")
    router_evts = trace.events()
    trace.clear()
    # only the WIDE trace kept the dead engine's partial run
    with trace.trace_context(wide):
        trace.instant("serve.admit", cat="serve", rid=1)
    e0_evts = trace.events()
    trace.clear()
    with trace.trace_context(wide):
        trace.instant("serve.admit", cat="serve", rid=2)
        with trace.span("serve.step", cat="serve", rid=2):
            pass
    e1_evts = trace.events()
    trace.clear()

    class _Stub:
        def fleet_trace_buffers(self):
            return [
                {"proc": "router", "pid": 1, "clock_offset": 0.0,
                 "offset_jitter": 0.0, "dropped": 0,
                 "events": router_evts},
                {"proc": "e0", "pid": 2, "clock_offset": 0.0,
                 "offset_jitter": 0.001, "dropped": 0,
                 "events": e0_evts},
                {"proc": "e1", "pid": 3, "clock_offset": 0.0,
                 "offset_jitter": 0.001, "dropped": 0,
                 "events": e1_evts},
            ]

    rec = fleet_mod._fleet_trace_artifact(_Stub(), str(tmp_path))
    assert rec["replay_hops"] == 2
    sr = rec["stitched_request"]
    assert sr["trace_id"] == wide
    assert sr["procs"] == ["e0", "e1", "router"]
    assert os.path.exists(rec["trace_path"])


def test_chrome_export_names_fleet_process_tracks(armed, tmp_path):
    from cylon_tpu_torch.telemetry.export import to_chrome_trace, \
        write_chrome_trace

    with trace.trace_context("deadbeef00000000"):
        with trace.span("fleet.submit", cat="fleet"):
            pass
    bufs = [
        {"proc": "router", "pid": 123, "clock_offset": 0.0,
         "events": trace.events()},
        {"proc": "e0", "pid": 456, "clock_offset": 0.0,
         "events": trace.events()},
    ]
    doc = to_chrome_trace(bufs)
    names = {m["pid"]: m["args"]["name"]
             for m in doc["traceEvents"]
             if m.get("name") == "process_name"}
    # real os pids label the tracks — the stitched artifact opens in
    # Perfetto with one row per fleet process
    assert names[123] == "router" and names[456] == "e0"
    # the top-level trace-context stamp folds into Chrome args: the
    # artifact is filterable by request trace id in Perfetto
    begins = [e for e in doc["traceEvents"] if e.get("ph") == "B"]
    assert begins and all(
        e["args"].get("trace_id") == "deadbeef00000000" for e in begins)
    p = write_chrome_trace(str(tmp_path / "f.trace.json"), bufs)
    loaded = json.loads(open(p).read())
    assert any(e.get("ph") == "B" for e in loaded["traceEvents"])


# -------------------------------------------------- clock handshake
class _SkewClient:
    """ping() answers from a clock running ``skew`` seconds fast."""

    def __init__(self, skew, fail=0):
        self.skew, self._fail = skew, fail

    def ping(self):
        if self._fail > 0:
            self._fail -= 1
            raise OSError("transient")
        return {"ok": True, "ts": time.time() + self.skew}


def test_clock_handshake_recovers_skew_within_jitter():
    off, jit = FleetRouter._clock_handshake(_SkewClient(5.0))
    assert abs(off - 5.0) <= max(jit, 0.05) + 0.05
    assert 0.0 <= jit < 0.25


def test_clock_handshake_tolerates_failures():
    # transient failures: surviving probes still answer
    off, _ = FleetRouter._clock_handshake(_SkewClient(2.0, fail=3))
    assert abs(off - 2.0) < 0.5

    class _Dead:
        def ping(self):
            raise OSError("down")

    class _Old:  # an older gateway: pong carries no ts
        def ping(self):
            return {"ok": True}

    assert FleetRouter._clock_handshake(_Dead()) == (0.0, 0.0)
    assert FleetRouter._clock_handshake(_Old()) == (0.0, 0.0)


# ---------------------------------------------- profile history
def test_profile_history_bounded_record_and_predict(tmp_path):
    path = str(tmp_path / "h.json")
    h = ProfileHistory(path=path, samples_per_key=4, max_keys=2)
    for w in (1.0, 2.0, 3.0, 4.0, 100.0):
        h.record("fpA", 1024, w)
    est = h.predict("fpA", 1024)
    # ring bound 4: the 1.0 sample aged out; median of [2,3,4,100]
    assert est["samples"] == 4
    assert est["predicted_wall_s"] == pytest.approx(3.5)
    assert est["bucket"] == 1024
    # degraded + short-circuit samples never steer the estimate while
    # an executed wall exists
    h.record("fpA", 1024, 900.0, degraded=True)
    h.record("fpA", 1024, 0.0, path="cache_hit")
    assert h.predict("fpA", 1024)["predicted_wall_s"] <= 100.0
    # unmeasured bucket pools the fingerprint's other scales
    pooled = h.predict("fpA", 4096)
    assert pooled is not None and pooled["bucket"] is None
    assert h.predict("fpNever") is None
    # unfingerprinted records are dropped, LRU evicts beyond max_keys
    h.record(None, 1024, 1.0)
    h.record("fpB", None, 5.0)
    h.record("fpC", None, 6.0)
    assert h.predict("fpA", 1024) is None  # evicted (max_keys=2)


def test_profile_history_persists_and_merges(tmp_path):
    p0, p1 = str(tmp_path / "h0.json"), str(tmp_path / "h1.json")
    h0 = ProfileHistory(path=p0)
    h1 = ProfileHistory(path=p1)
    for w in (1.0, 2.0):
        h0.record("fp", None, w)
    h1.record("fp", None, 9.0)
    h0.save()
    h1.save()
    # a restarted engine resumes with its measured past
    again = ProfileHistory(path=p0)
    assert again.predict("fp")["samples"] == 2
    # the fleet-wide fold sees every engine's samples; torn/absent
    # files contribute nothing instead of raising
    fleet = merged_history([p0, p1, str(tmp_path / "absent.json")])
    est = fleet.predict("fp")
    assert est["samples"] == 3
    assert est["predicted_wall_s"] == pytest.approx(2.0)


def test_explain_surfaces_measured_cost_estimate():
    h = ProfileHistory()
    for w in (0.5, 0.7, 0.9):
        h.record("fpQ", None, w)

    def q():
        return 1

    plan = explain(q, _history=h, _fingerprint="fpQ")
    est = plan["cost_estimate"]
    assert est["predicted_wall_s"] == pytest.approx(0.7)
    assert est["samples"] == 3
    # no history for the query: estimate is honest None, not 0
    assert explain(q, _history=h,
                   _fingerprint="fpX")["cost_estimate"] is None


def test_engine_history_warms_explain_and_persists(tmp_path):
    import numpy as np

    from cylon_tpu_torch import Table

    eng = ServeEngine(policy=ServePolicy(max_queue=8),
                      durable_dir=str(tmp_path))
    eng.register_table("tbl", Table.from_pydict(
        {"k": np.arange(8, dtype=np.int64)}, device="cpu"))
    # a declared read set gives the query a stable fingerprint — the
    # history key (reads-nothing queries have no identity to predict)
    eng.register_query("q", lambda: sum(range(10_000)),
                       tables=("tbl",))
    try:
        for _ in range(3):
            assert eng.submit_named("q").result(60) == 49995000
        plan = eng.explain_named("q")
        est = plan.get("cost_estimate")
        assert est is not None and est["samples"] >= 1
        assert est["predicted_wall_s"] >= 0.0
    finally:
        eng.close()
    # close() persisted the history under the durable tree; the
    # fleet-wide merge reads it back
    hpath = os.path.join(str(tmp_path), HISTORY_FILE)
    assert os.path.exists(hpath)
    fleet = merged_history([hpath])
    assert fleet.keys()
    fp = fleet.keys()[0].split("::")[0]
    assert fleet.predict(fp)["samples"] >= 1


# ------------------------------------------------ unarmed contract
def test_unarmed_router_request_allocates_no_tracing(tmp_path,
                                                    monkeypatch):
    """CYLON_TPU_TRACE unset: a full routed request mints no trace id,
    allocates no recorder and performs no handshake — the serve hot
    path pays nothing for fleet tracing."""
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    monkeypatch.setattr(trace, "_RECORDER", None)
    lay = FleetLayout(str(tmp_path))
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=lay.engine_dir("a0"))
    eng.register_query("q", lambda: 2)
    router = FleetRouter([LocalEngineClient(eng, "a0")],
                         poll_interval=0.05, fail_threshold=99,
                         unhealthy_dwell=1.0)
    try:
        assert router._trace_armed is False
        tk = router.submit("q", tenant="t", idempotency_key="K")
        assert tk.result(30) == 2
        assert tk.trace_id is None
        # a poll tick has landed (its verdict), and no handshake ran
        give_up = time.monotonic() + 30
        while router.engines()[0]["status"] == "unknown":
            assert time.monotonic() < give_up
            time.sleep(0.02)
        bufs = router.fleet_trace_buffers()
        assert trace._RECORDER is None  # zero allocations anywhere
        assert all(b["events"] == [] for b in bufs)
        # no handshake ran: the engine track never estimated an offset
        assert bufs[1]["clock_offset"] == 0.0
        assert bufs[1]["offset_jitter"] is None
    finally:
        router.close()
        eng.close()


def test_armed_local_request_carries_one_trace_id(tmp_path, armed):
    """In-process end to end: the router mints the id, the engine's
    admit/step scopes inherit it, and the request timeline holds the
    whole chain under that ONE id."""
    lay = FleetLayout(str(tmp_path))
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=lay.engine_dir("a0"))
    eng.register_query("q", lambda: 3)
    router = FleetRouter([LocalEngineClient(eng, "a0")],
                         poll_interval=0.05, fail_threshold=99,
                         unhealthy_dwell=1.0)
    try:
        tk = router.submit("q", tenant="t", idempotency_key="K")
        assert tk.result(30) == 3
        tid = tk.trace_id
        assert tid
        line = trace.request_timeline(trace.events(), tid)
        names = {e["name"] for e in line}
        assert "fleet.submit" in names
        assert "serve.admit" in names
        assert "serve.step" in names
        # the engine-side admit links back to the router's submit span
        sub = next(e for e in line if e["name"] == "fleet.submit"
                   and e["kind"] == "begin")
        admit = next(e for e in line if e["name"] == "serve.admit")
        assert admit["parent"] == sub["id"]
        # a second request gets a DIFFERENT id: timelines never bleed
        tk2 = router.submit("q", tenant="t", idempotency_key="K2")
        tk2.result(30)
        assert tk2.trace_id and tk2.trace_id != tid
    finally:
        router.close()
        eng.close()


# --------------------------------- acceptance: subprocess stitching
MIX = ("q1", "q6")
SF, SEED = 0.001, 0


def _tenants_for(victim, survivor, n_each):
    names = sorted((victim, survivor))
    out = {victim: [], survivor: []}
    i = 0
    while any(len(v) < n_each for v in out.values()):
        t = f"tenant{i}"
        first = _affinity_order(t, names)[0]
        if len(out[first]) < n_each:
            out[first].append(t)
        i += 1
    return out


def test_failover_replay_keeps_one_trace_id_across_processes(
        tmp_path, monkeypatch):
    """Satellite acceptance: two REAL engine processes, e0 SIGKILLed
    mid-run via the rc-43 harness, the router failing the journaled
    work over to e1 — and the replayed request's SINGLE trace id
    spans the router's admission, the replay hop and the survivor's
    execution, stitched causally after clock alignment with its
    queue-wait phases attributed."""
    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    monkeypatch.setattr(trace, "_RECORDER", None)
    root = str(tmp_path / "fleet")
    procs = []
    router = None
    try:
        with cf.ThreadPoolExecutor(2) as ex:
            f0 = ex.submit(spawn_engine, root, "e0", SF, SEED, MIX,
                           {"CYLON_TPU_TRACE": "1", "OMP_NUM_THREADS": "1"},
                           120, device="cpu",
                           chaos_kill="plan:2")
            f1 = ex.submit(spawn_engine, root, "e1", SF, SEED, MIX,
                           {"CYLON_TPU_TRACE": "1", "OMP_NUM_THREADS": "1"},
                           120, device="cpu")
            for f in (f0, f1):
                procs.append(f.result(150))
        p0, p1 = procs
        router = FleetRouter([p0.client, p1.client], poll_interval=0.2,
                             fail_threshold=3, unhealthy_dwell=2.0)
        # both engines polled first: an unpolled engine ranks below a
        # polled one and would lose its tenants to the peer
        give_up = time.monotonic() + 60
        while any(e["status"] == "unknown" for e in router.engines()):
            assert time.monotonic() < give_up
            time.sleep(0.02)
        tenants = _tenants_for("e0", "e1", 2)
        tickets = []
        k = 0
        for q in MIX:
            for t in tenants["e0"] + tenants["e1"]:
                tickets.append(router.submit(
                    q, tenant=t, idempotency_key=f"key{k}"))
                k += 1
        for tk in tickets:
            tk.result(300)  # acks are never lost
            assert tk.trace_id  # every admitted request was stamped
        assert p0.proc.wait(60) == KILL_EXIT_CODE
        assert telemetry.total("fleet.failovers") == 1
        assert telemetry.total("fleet.replayed") >= 1
        rep = router.report()
        replayed = set(rep["replayed_keys"])
        assert replayed

        bufs = router.fleet_trace_buffers()
        assert [b["proc"] for b in bufs] == ["router", "e0", "e1"]
        by = {b["proc"]: b for b in bufs}
        # the survivor's segments were pulled and its clock estimated
        assert by["e1"]["events"]
        assert isinstance(by["e1"]["offset_jitter"], float)
        assert by["e1"]["pid"] == p1.pid
        merged = trace.merge_timelines(bufs)

        hops = [e for e in merged if e.get("name") == "fleet.replay_hop"]
        assert hops, "failover replay emitted no hop marker"
        # the journal fence shows on the router track, BEFORE any
        # replay hop: victim quiet → fence → survivor's replay
        fences = [e for e in merged if e.get("name") == "fleet.fence"]
        assert fences and fences[0]["proc"] == "router"
        assert fences[0]["args"]["engine"] == "e0"
        assert fences[0]["ts"] <= min(h["ts"] for h in hops)
        # replay runs in the ROUTER under the ORIGINAL id, attributed
        # to the surviving peer
        assert all(h["proc"] == "router" for h in hops)
        assert {h["args"]["engine"] for h in hops} == {"e1"}
        tid = hops[0]["trace_id"]
        assert tid in {tk.trace_id for tk in tickets}

        frep = trace.fleet_request_report(merged, tid)
        assert frep["monotone"]
        assert "router" in frep["procs"] and "e1" in frep["procs"]
        assert [h["engine"] for h in frep["replay_hops"]] == ["e1"]
        ph = frep["phases"]
        # queue-wait attribution: admission -> engine admit (spans the
        # outage for a replayed request) and admit -> first step on
        # the survivor
        assert ph["router_queue_s"] is not None
        assert ph["router_queue_s"] >= 0.0
        assert ph["engine_queue_s"].get("e1", 0.0) >= 0.0
        assert ph["dispatch_s"].get("e1", 0.0) >= 0.0
        # causal stitching across clocks: the survivor's work on this
        # request happens AFTER the router admitted it
        sub_ts = min(e["ts"] for e in merged
                     if e.get("trace_id") == tid
                     and e.get("name") == "fleet.submit")
        e1_req = [e for e in trace.request_timeline(merged, tid)
                  if e.get("proc") == "e1"]
        assert e1_req and all(e["ts"] >= sub_ts for e in e1_req)
    finally:
        if router is not None:
            router.close()
        for p in procs:
            p.terminate(60)


def test_fleet_engines_persist_history_for_merge(tmp_path):
    """The cost-model leg of the fleet artifact at unit scale: an
    engine process that exits cleanly leaves its profile history under
    the durable tree where merged_history folds it fleet-wide."""
    import numpy as np

    from cylon_tpu_torch import Table

    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path / "e"))
    eng.register_table("tbl", Table.from_pydict(
        {"k": np.arange(4, dtype=np.int64)}, device="cpu"))
    eng.register_query("q", lambda: 1, tables=("tbl",))
    eng.submit_named("q").result(30)
    eng.close()
    hpath = os.path.join(str(tmp_path / "e"), HISTORY_FILE)
    fleet = merged_history([hpath])
    assert len(fleet) >= 1
