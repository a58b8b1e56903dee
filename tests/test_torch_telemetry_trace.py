"""The port's flight recorder: trace timelines, Chrome export,
straggler naming, and the ranks of a ``ThreadWorld`` split by their
rank stamp.

The cases of ``tests/test_trace_timeline.py`` on ``cylon_tpu_torch``:
the recorder allocates NOTHING while ``CYLON_TPU_TRACE`` is unset,
spans nest with parent ids, the buffer is bounded, merged multi-rank
timelines align by clock offset, the Chrome Trace exporter emits strict
JSON with monotone timestamps and matched B/E pairs, and ``dist_join``'s
stage spans cover at least 80 % of its wall on every rank; the watchdog's
sections, the fault and retry instants and the spill store's slices
reach the timeline, and an injected exchange delay on one rank names
that rank and the ``exchange`` stage as the straggler.
"""

import json
import threading

import numpy as np
import pytest

import cylon_tpu_torch as ct
from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry import trace


@pytest.fixture
def armed(monkeypatch):
    """Arm the recorder with a FRESH buffer; disarm + drop it after."""
    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    yield
    monkeypatch.setattr(trace, "_RECORDER", None)


# ------------------------------------------------------------- fast path
def test_torch_no_recorder_allocations_threads_or_handles_when_off(
        monkeypatch):
    """The acceptance fast-path pin: with CYLON_TPU_TRACE unset, span/
    instant/counter emission allocates no recorder, starts no thread
    and opens no file — the module global stays None."""
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    monkeypatch.setattr(trace, "_RECORDER", None)
    before = set(threading.enumerate())
    from cylon_tpu_torch.utils import tracing

    assert not trace.enabled()
    with tracing.span("off_span"):
        trace.instant("off_instant", x=1)
        trace.counter("off_counter", 1)
        trace.complete("off_complete", 0.1)
        with trace.span("off_inner"):
            pass
    assert trace._RECORDER is None          # zero allocations
    assert trace.events() == []
    assert trace.dropped() == 0
    assert set(threading.enumerate()) == before
    # ...and the span still fed the metric registry as before
    assert telemetry.metric("tracing.span_seconds",
                            name="off_span") is not None


# ------------------------------------------------------------- recorder
def test_torch_span_nesting_records_parent_ids(armed):
    with trace.span("outer"):
        with trace.span("inner", cat="stage", k=1):
            trace.instant("tick")
    evts = trace.events()
    kinds = [e["kind"] for e in evts]
    assert kinds == ["begin", "begin", "instant", "end", "end"]
    outer_b, inner_b, tick, inner_e, outer_e = evts
    assert outer_b["parent"] is None
    assert inner_b["parent"] == outer_b["id"]
    assert tick["parent"] == inner_b["id"]
    assert inner_b["cat"] == "stage" and inner_b["args"] == {"k": 1}
    assert inner_e["id"] == inner_b["id"]
    assert outer_e["ts"] >= outer_b["ts"]


def test_torch_buffer_is_bounded_and_counts_drops(armed, monkeypatch):
    monkeypatch.setenv("CYLON_TPU_TRACE_EVENTS", "16")
    monkeypatch.setattr(trace, "_RECORDER", None)
    for i in range(50):
        trace.instant("e", i=i)
    evts = trace.events()
    assert len(evts) == 16
    assert trace.dropped() == 34
    # oldest dropped first: the survivors are the newest 16
    assert [e["args"]["i"] for e in evts] == list(range(34, 50))


def test_torch_clear_resets_buffer(armed):
    trace.instant("x")
    assert trace.events()
    trace.clear()
    assert trace.events() == [] and trace.dropped() == 0


def test_torch_end_without_arming_is_noop(monkeypatch):
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    trace.end(None)  # the token emitted while off


# ------------------------------------------------------ merge + analysis
def _stage_evt(name, ts, dur, **extra):
    return dict({"kind": "complete", "name": name, "ts": ts,
                 "dur": dur, "tid": 1, "cat": "stage", "args": {}},
                **extra)


def test_torch_merge_timelines_subtracts_clock_offsets():
    bufs = [
        {"rank": 0, "clock_offset": 0.0,
         "events": [_stage_evt("exchange", 10.0, 0.01)]},
        {"rank": 1, "clock_offset": 5.0,     # rank1's clock runs 5s fast
         "events": [_stage_evt("exchange", 15.0, 0.01)]},
    ]
    merged = trace.merge_timelines(bufs)
    assert [e["rank"] for e in merged] == [0, 1]
    # after alignment the two exchanges are simultaneous on rank0's clock
    assert merged[0]["ts"] == merged[1]["ts"] == 10.0
    assert sorted(e["ts"] for e in merged) == [e["ts"] for e in merged]


def test_torch_critical_path_names_straggler_rank_and_stage():
    bufs = []
    for r in range(4):
        dur = 0.5 if r == 2 else 0.05
        bufs.append({"rank": r, "clock_offset": 0.0, "events": [
            _stage_evt("exchange", 1.0, dur),
            _stage_evt("spill_io", 1.0 + dur, 0.02),
        ]})
    rep = trace.critical_path(trace.merge_timelines(bufs))
    assert rep["straggler_rank"] == 2
    assert rep["dominant_stage"] == "exchange"
    assert rep["excess_seconds"] == pytest.approx(0.45, abs=1e-6)
    assert rep["stage_seconds"][2]["exchange"] == pytest.approx(0.5)
    assert set(rep["rank_walls"]) == {0, 1, 2, 3}


def test_torch_critical_path_falls_back_to_top_level_spans():
    def span_pair(rank, name, t0, dur):
        return [{"kind": "begin", "name": name, "ts": t0, "tid": 1,
                 "id": 1, "parent": None, "cat": None, "args": {}},
                {"kind": "end", "name": name, "ts": t0 + dur, "tid": 1,
                 "id": 1}]

    bufs = [{"rank": r, "clock_offset": 0.0,
             "events": span_pair(r, "dist_sort", 0.0,
                                 0.4 if r == 1 else 0.1)}
            for r in range(3)]
    rep = trace.critical_path(trace.merge_timelines(bufs))
    assert rep["straggler_rank"] == 1
    assert rep["dominant_stage"] == "dist_sort"


def test_torch_critical_path_empty_timeline():
    rep = trace.critical_path([])
    assert rep["straggler_rank"] is None
    assert rep["dominant_stage"] is None


def test_torch_rank_buffers_single_process_wraps_local_events(armed):
    trace.instant("x")
    bufs = trace.rank_buffers()
    assert len(bufs) == 1
    assert bufs[0]["rank"] == 0 and bufs[0]["clock_offset"] == 0.0
    assert [e["name"] for e in bufs[0]["events"]] == ["x"]


def test_torch_clock_offset_zero_in_one_process():
    """One process has one clock: a local env and every ThreadWorld
    rank read an offset of exactly 0, with no collective."""
    assert ct.CylonEnv(device="cpu").clock_offset() == 0.0
    got = ct.ThreadWorld(4).run(
        lambda comm: ct.CylonEnv(comm, device="cpu").clock_offset())
    assert got == [0.0] * 4


# --------------------------------------------------------- chrome export
def _no_const(_):
    raise AssertionError("non-finite constant leaked into the export")


def test_torch_chrome_export_strict_json_monotone_and_matched(armed):
    with trace.span("op"):
        with trace.span("op.dispatch", cat="stage"):
            trace.instant("exchange.dispatch", op="op", bytes_true=128,
                          bytes_padded=256, rows_shards=[3, 5],
                          counter="exchange.rows")
        trace.counter("exchange.bytes_true", 128, op="op")
    trace.complete("exchange", 0.02, cat="stage",
                   nan_arg=float("nan"), inf_arg=float("inf"))
    text = telemetry.chrome_trace_json(trace.rank_buffers(), world=2)
    # strict JSON: a NaN/Infinity constant anywhere fails the parse
    doc = json.loads(text, parse_constant=_no_const)
    evts = doc["traceEvents"]
    body = [e for e in evts if e["ph"] != "M"]
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts), "Chrome trace requires monotone ts"
    # matched B/E pairs per (pid, tid)
    stacks = {}
    for e in body:
        if e["ph"] == "B":
            stacks.setdefault((e["pid"], e["tid"]), []).append(e["name"])
        elif e["ph"] == "E":
            st = stacks.get((e["pid"], e["tid"]))
            assert st, f"E without B: {e}"
            st.pop()
    assert all(not st for st in stacks.values()), stacks
    # per-shard counter tracks + process metadata
    pids = {e["pid"] for e in evts}
    names = {e.get("name") for e in evts}
    assert {10000, 10001} <= pids          # SHARD_PID_BASE + shard
    assert "exchange.rows" in names and "process_name" in names
    assert any(e["ph"] == "C" for e in body)
    assert any(e["ph"] == "X" for e in body)
    # the NaN/inf args came through as null, never as Infinity text
    assert "Infinity" not in text and "NaN" not in text


def test_torch_chrome_export_closes_ring_orphaned_spans(armed, monkeypatch):
    """A begin whose end was ring-evicted must not unbalance the
    export: orphan E events drop, still-open B events are closed."""
    monkeypatch.setenv("CYLON_TPU_TRACE_EVENTS", "16")
    monkeypatch.setattr(trace, "_RECORDER", None)
    toks = [trace.begin(f"s{i}") for i in range(3)]
    for i in range(20):
        trace.instant("flood", i=i)  # evicts the begins
    for t in reversed(toks):
        trace.end(t)
    doc = json.loads(telemetry.chrome_trace_json(trace.rank_buffers()))
    body = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    depth = 0
    for e in body:
        depth += {"B": 1, "E": -1}.get(e["ph"], 0)
        assert depth >= 0
    assert depth == 0


def test_torch_write_chrome_trace_artifact(armed, tmp_path):
    trace.instant("x")
    path = str(tmp_path / "t.trace.json")
    out = telemetry.write_chrome_trace(path, trace.rank_buffers())
    assert out == path
    doc = json.loads(open(path).read(), parse_constant=_no_const)
    assert "traceEvents" in doc


def test_torch_tracing_span_feeds_recorder_and_registry(armed):
    from cylon_tpu_torch.utils import tracing

    with tracing.span("both_worlds"):
        pass
    assert any(e["name"] == "both_worlds" for e in trace.events())
    assert tracing.timings()["both_worlds"].count >= 1
    tracing.reset_timings()


def _w4_tables(rng, n):
    """n rows a side over W = 4, as each rank's shard."""
    keys = [rng.integers(0, 64, n) for _ in range(2)]
    vals = [rng.normal(size=n) for _ in range(2)]
    q = n // 4

    def shard(side, r):
        return ct.Table.from_pydict(
            {"k": keys[side][r * q:(r + 1) * q],
             "ab"[side]: vals[side][r * q:(r + 1) * q]}, device="cpu")
    return shard


def test_torch_dist_join_stage_coverage_at_least_80pct(armed):
    """The bench-artifact acceptance: on every rank of a W = 4 world,
    the stage spans under the rank's dist_join span account for >= 80%
    of its wall, and each rank's exchange instant prices the dispatch,
    its per-rank rows summing to the rows both sides sent."""
    rng = np.random.default_rng(3)
    n = 256
    shard = _w4_tables(rng, n)

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        return ct.dist_join(env, shard(0, comm.rank), shard(1, comm.rank),
                            on="k", how="inner")

    trace.clear()
    ct.ThreadWorld(4).run(rank)
    bufs = trace.rank_buffers()
    assert [b["rank"] for b in bufs] == [0, 1, 2, 3]
    for b in bufs:
        cov = trace.stage_coverage(b["events"], "dist_join")
        assert cov is not None and cov >= 0.8, (b["rank"], cov)
        xs = [e for e in b["events"] if e["name"] == "exchange.dispatch"]
        assert len(xs) == 1 and xs[0]["args"]["bytes_true"] > 0
        assert xs[0]["args"]["bytes_padded"] >= xs[0]["args"]["bytes_true"]
        shards = xs[0]["args"]["rows_shards"]
        assert shards is not None and len(shards) == 4
        assert sum(shards) == 2 * n


def test_torch_thread_world_ranks_split_into_rank_buffers(armed):
    """The ThreadWorld ranks share one recorder: every event inside a
    dist op carries its rank's stamp, rank_buffers splits them, and
    critical_path sees four ranks."""
    rng = np.random.default_rng(4)
    shard = _w4_tables(rng, 128)

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        return ct.shuffle(env, shard(0, comm.rank), ["k"])

    trace.clear()
    ct.ThreadWorld(4).run(rank)
    evts = trace.events()
    assert evts and all(e.get("rank") in (0, 1, 2, 3) for e in evts)
    merged = trace.merge_timelines(trace.rank_buffers())
    rep = trace.critical_path(merged)
    assert set(rep["rank_walls"]) == {0, 1, 2, 3}
    for r in range(4):
        assert "shuffle.dispatch" in rep["stage_seconds"][r]
    # outside a rank scope events carry no stamp, as in the JAX package
    trace.instant("outside")
    assert "rank" not in trace.events()[-1]


def test_torch_first_ring_drop_logs_one_warning(monkeypatch):
    """Silent trace loss gets ONE warning line at the first eviction
    (and dropped() counts it); clear() re-arms."""
    import io
    import logging

    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    monkeypatch.setenv("CYLON_TPU_TRACE_EVENTS", "16")
    # a fresh recorder so the tiny capacity takes effect
    monkeypatch.setattr(trace, "_RECORDER", None)
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    logger = logging.getLogger("cylon_tpu_torch")
    logger.addHandler(h)
    try:
        for i in range(40):
            trace.instant(f"evt{i}")
    finally:
        logger.removeHandler(h)
    assert trace.dropped() == 40 - 16
    out = buf.getvalue()
    assert out.count("trace ring buffer full") == 1, out
    # clear() resets both the loss counter and the one-shot warning
    trace.clear()
    assert trace.dropped() == 0
    buf2 = io.StringIO()
    h2 = logging.StreamHandler(buf2)
    logger.addHandler(h2)
    try:
        for i in range(20):
            trace.instant(f"again{i}")
    finally:
        logger.removeHandler(h2)
    assert "trace ring buffer full" in buf2.getvalue()
    trace.clear()


# ------------------------------------------------- engine instrumentation
def test_torch_watchdog_sections_emit_stage_completes(armed):
    from cylon_tpu_torch import watchdog

    with watchdog.watched_section("ooc_pass", detail="unit"):
        pass
    stages = [e for e in trace.events()
              if e["kind"] == "complete" and e.get("cat") == "stage"]
    assert stages and stages[-1]["name"] == "ooc_pass"
    assert stages[-1]["args"]["detail"] == "unit"
    assert stages[-1]["args"]["expired"] is False


def test_torch_fault_and_retry_emit_instants(armed):
    from cylon_tpu_torch import resilience
    from cylon_tpu_torch.config import RetryPolicy
    from cylon_tpu_torch.errors import TransientError

    plan = resilience.FaultPlan([resilience.FaultRule("io_read")])
    with resilience.active(plan):
        with pytest.raises(TransientError):
            resilience.inject("io_read")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise TransientError("flake")
        return "ok"

    resilience.retrying(flaky, RetryPolicy(max_attempts=3, base_delay=0.0),
                        sleep_fn=lambda _: None)
    names = [e["name"] for e in trace.events()]
    assert "resilience.fault" in names
    assert "resilience.retry" in names


def test_torch_spill_store_emits_slices_and_instants(armed, tmp_path):
    from cylon_tpu_torch import resilience

    store = resilience.SpillStore(str(tmp_path), fingerprint="fp")
    store.write_bucket(0, {"a": np.arange(16)}, 16)
    store.read_bucket(0)
    evts = trace.events()
    names = [e["name"] for e in evts]
    assert "spill.write" in names and "spill.read" in names
    wr = [e for e in evts if e["name"] == "spill.write"
          and e["kind"] == "instant"]
    assert wr and wr[0]["args"]["bytes"] == 16 * 8


def test_torch_fault_delay_names_straggler_rank_and_exchange_stage(armed):
    """A delay fault on ONE rank's exchange point: the merged timeline's
    straggler report names that rank and the ``exchange`` stage. As in
    the JAX package's case, each simulated rank is its own recorder run
    (a world of one here, whose exchange nobody waits on), the faulted
    rank's the only one with the delay."""
    from cylon_tpu_torch import resilience, watchdog

    rng = np.random.default_rng(4)
    n = 256
    t = ct.Table.from_pydict({"k": rng.integers(0, 64, n),
                              "v": rng.normal(size=n)}, device="cpu")
    env = ct.CylonEnv(device="cpu")
    ct.shuffle(env, t, ["k"])          # warm-up

    def _wall(evts):
        ts = [e["ts"] for e in evts]
        return (max(e["ts"] + e.get("dur", 0.0) for e in evts)
                - min(ts)) if ts else 0.0

    bufs = []
    for r in range(4):
        env.set_fault_plan(resilience.FaultPlan(
            [resilience.FaultRule("exchange", delay=0.2, times=0)])
            if r == 1 else None)
        reps = []
        for _ in range(3):
            trace.clear()
            ct.shuffle(env, t, ["k"])
            reps.append(trace.events())
        bufs.append({"rank": r, "clock_offset": 0.0,
                     "events": min(reps, key=_wall)})
    env.set_fault_plan(None)
    merged = trace.merge_timelines(bufs)
    rep = trace.critical_path(merged)
    assert rep["straggler_rank"] == 1
    assert rep["dominant_stage"] == "exchange"
    assert rep["excess_seconds"] >= 0.1
    rep2 = watchdog.straggler_report(timeline=merged)
    assert rep2["straggler_rank"] == 1
    assert rep2["dominant_stage"] == "exchange"
