"""The metric arithmetic on synthetic inputs: rate over the window, the
p95 of all operations, busy and idle from overlapping intervals, idle
gaps by host range, the roofline bytes, and the result line's keys."""

import json

import pytest

from benchmark import run
from benchmark.harness import cell as cells
from benchmark.harness import loop, readers, trace
from benchmark.harness.cell import load_module

METRICS = cells.BENCH_DIR / "metrics"


def metric(name):
    return load_module(METRICS / f"{name}.py")


class FakeWorkload:
    def __init__(self, rows=100, nbytes=1000):
        self.rows, self.nbytes = rows, nbytes

    def op_rows(self, i):
        return self.rows

    def least_bytes(self, i):
        return self.nbytes


def window(walls, gap=0.0, start=10.0, failed=(), traced=True):
    t, records = start, []
    for i, w in enumerate(walls):
        records.append(loop.Record(i, "op", t, t + w, i in failed, traced))
        t += w + gap
    return loop.Window(start, records, syncs=len(walls) * 2)


def ctx(win, **kw):
    return run.Context(win, kw.pop("setup_s", 5.0), kw.pop("peak", 2e9),
                       kw.pop("workload", FakeWorkload()),
                       kw.pop("bandwidth", 1e6), **kw)


def test_rate_counts_every_operation_over_the_whole_window():
    win = window([0.5] * 4, gap=0.25)      # ends at 10 + 4 * 0.5 + 0.75
    assert win.seconds == pytest.approx(2.75)
    rate = metric("join_rows_per_s").read(ctx(win))
    assert rate == pytest.approx(400 / 2.75)
    assert metric("query_ms").read(ctx(win)) == pytest.approx(2750 / 4)


def test_rate_leaves_out_failed_operations_but_not_their_time():
    win = window([0.5] * 4, failed=(1,))
    assert metric("join_rows_per_s").read(ctx(win)) == pytest.approx(300 / 2)


def test_p95_is_over_all_operations():
    walls = [0.1] * 190 + [1.0] * 10
    win = window(walls)
    got = metric("p95_ms").read(ctx(win))
    # inclusive quantiles: position 0.95 * 199 = 189.05 of the sorted walls
    assert got == pytest.approx(1e3 * (0.1 + 0.05 * 0.9))
    assert readers.p95([1.0, 2.0, 3.0]) == pytest.approx(2.9)
    assert readers.p95([4.0]) == 4.0


def test_peak_and_setup():
    c = ctx(window([1.0]), peak=51_203_283_968, setup_s=12.5)
    assert metric("peak_mem_gb").read(c) == pytest.approx(51.203283968)
    assert metric("setup_s").read(c) == 12.5


def test_busy_is_the_union_of_overlapping_device_intervals():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (35, 36, "c"),
           (30, 40, "a")]                              # a repeat counts once
    host = [(0, 100, "bench.op"), (22, 29, "plan.fetch"),
            (50, 90, "bench.wait")]
    tr = trace.read(dev, host, (0, 100))
    assert tr.busy == [(0, 20), (30, 40)]
    assert tr.busy_s == pytest.approx(30e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.by_op == pytest.approx({"a": 20e-9, "b": 15e-9, "c": 1e-9})
    # gaps 20-30 (in plan.fetch), 40-100 (midpoint 70: bench.wait)
    assert tr.idle_by_span == pytest.approx({"plan.fetch": 10e-9,
                                             "bench.wait": 60e-9})
    c = ctx(window([1.0]), trace=tr)
    assert metric("device_idle_pct.join").read(c) == pytest.approx(70.0)
    assert metric("device_idle_pct.tpch").read(c) == pytest.approx(70.0)


def test_gaps_outside_every_range_and_clipping():
    tr = trace.read([(-5, 10, "k"), (95, 120, "k")],
                    [(0, 40, "bench.op"), (60, 100, "bench.op")], (0, 100))
    assert tr.busy == [(0, 10), (95, 100)]
    # one gap, 10-95, named by the range open at its midpoint: none
    assert tr.idle_by_span == pytest.approx({trace.BETWEEN: 85e-9})


def test_breakdown_lists_the_largest_ten():
    dev = [(i * 10, i * 10 + i + 1, f"k{i}") for i in range(12)]
    tr = trace.read(dev, [(0, 200, "bench.op")], (0, 200))
    b = tr.breakdown()
    assert [n for n, _ in b["device_ops"]] == [f"k{i}"
                                               for i in range(11, 1, -1)]
    assert len(b["idle_gaps"]) == 1 and b["idle_gaps"][0][0] == "bench.op"


def test_roofline_is_least_time_over_busy_time():
    tr = trace.read([(0, 2_000_000_000, "k")], [(0, 4e9, "bench.op")],
                    (0, 4_000_000_000))
    win = window([1.0] * 4)
    c = ctx(win, trace=tr, workload=FakeWorkload(nbytes=10**6),
            bandwidth=1e6)                          # 1 s least a call
    assert metric("join_roofline").read(c) == pytest.approx(200.0)
    assert metric("tpch_roofline").read(c) == pytest.approx(200.0)
    assert metric("join_roofline").read(ctx(win)) is None


def test_syncs_per_op_and_program_counters():
    win = window([0.1] * 5)
    assert metric("host_syncs_per_op.join").read(ctx(win)) == 2
    delta = {"a": {"name": "plan.compile_count", "type": "counter",
                   "value": 1, "labels": {}},
             "b": {"name": "tracing.span_seconds", "type": "timer",
                   "labels": {"name": "plan.dispatch"}, "count": 4,
                   "sum": 0.008}}
    for kind, n in (("hash->hash_bucketed", 3), ("hash->sort_overflow", 1),
                    ("sort->sort", 5)):
        delta[kind] = {"name": "join.algorithm", "type": "counter",
                       "value": n, "labels": {"kind": kind}}
    c = ctx(win, telemetry_delta=delta)
    assert metric("join.bucketed_pct").read(c) == pytest.approx(75.0)
    assert metric("plan.recaptures").read(c) == 1
    assert metric("plan.dispatch_ms").read(c) == pytest.approx(2.0)
    assert metric("plan.recaptures").read(ctx(win)) is None
    win.syncs = None
    assert metric("host_syncs_per_op.tpch").read(ctx(win)) is None


def test_join_roofline_bytes(tiny):
    c = cells.resolve("join_16m.sort", False)
    w = c.kind.Workload(c.config, c.traffic, 1, "cpu")
    n = c.config["rows_per_side"]
    w.kept = {0: {"k": [0] * 5}}
    w.rows_out = 5
    # inputs: key and one value a row, both sides; result: key + 2 values
    assert w.least_bytes(0) == 2 * n * 16 + 5 * 24


def test_tpch_roofline_bytes():
    c = cells.resolve("tpch_sf10.captured", False)
    w = c.kind.Workload(c.config, c.traffic, 1, "cpu")
    w.rows = {"customer": 10, "orders": 100, "lineitem": 400,
              "supplier": 5, "nation": 25, "region": 5}
    w.kept = {0: {}, 1: {}}
    w.widths = {c: 8 for t in c.config["columns_read"].values()
                for cols in t.values() for c in cols}
    w.widths.update(c_mktsegment=4, o_orderdate=4, l_shipdate=4, n_name=4,
                    r_name=4)
    q3 = 10 * (8 + 4) + 100 * (8 + 8 + 4 + 8) + 400 * (8 + 8 + 8 + 4)
    q5 = 10 * 16 + 100 * 20 + 400 * 32 + 5 * 16 + 25 * (8 + 4 + 8) \
        + 5 * (8 + 4)
    assert w.least_bytes(0) == q3
    assert w.least_bytes(1) == q5


def test_result_line_keys():
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"p95_ms": {"value": 1.0, "unit": "ms"}},
           "memory_peak_bytes": 7, "trace": None, "build_s": 0.0,
           "checks": {"rows_off": {"value": 0, "limit": 0}}}
    dev = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    line = run.result_line(out, dev, 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "build_s", "card", "checks"]
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 7}
    out["trace"] = trace.read([(0, 5, "k")], [(0, 10, "bench.op")],
                              (0, 10))
    line = run.result_line(out, dev, 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "build_s", "card",
                          "checks"]
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)


def test_no_card_no_result(capsys, monkeypatch):
    import os

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(os, "environ", dict(os.environ))
    assert run.main(["--workload", "join_16m.sort", "--seed", "1",
                     "--seconds", "1"]) == run.EXIT_NO_RESULT
    assert capsys.readouterr().out == ""


class FakeEvent:
    def __init__(self, cuda, annotation):
        self.cuda, self.annotation = cuda, annotation

    def device_type(self):
        return "cuda" if self.cuda else "cpu"

    def is_user_annotation(self):
        return self.annotation


class TypedEvent(FakeEvent):
    def __init__(self, kind):
        super().__init__(kind.startswith(("kernel", "gpu")), False)
        self.kind = kind

    def activity_type(self):
        return self.kind


@pytest.mark.parametrize("event, side", [
    (TypedEvent("kernel"), "device"), (TypedEvent("gpu_memcpy"), "device"),
    (TypedEvent("gpu_memset"), "device"),
    (TypedEvent("gpu_user_annotation"), None),
    (TypedEvent("user_annotation"), "host"), (TypedEvent("cpu_op"), None),
    (FakeEvent(True, False), "device"), (FakeEvent(True, True), None),
    (FakeEvent(False, True), "host"), (FakeEvent(False, False), None)])
def test_events_sorted_into_device_work_and_host_ranges(event, side):
    assert trace._classify(event, "cuda") == side


def test_trace_covers_the_windows_first_seconds_only(monkeypatch):
    import time
    import types

    clock = iter(range(0, 10_000))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    modes = []
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        set_sync_debug_mode=modes.append))
    stopped = []
    kept = []
    win = loop.run(lambda i: i, lambda: None, lambda i, out: kept.append(i),
                   lambda i: "op", 20.0, fake, trace_seconds=7.0,
                   stop_trace=lambda: stopped.append(True))
    assert stopped == [True]
    traced = [r.traced for r in win.records]
    assert traced[0] and not traced[-1]
    assert traced == sorted(traced, reverse=True)
    assert all(r.start < win.start + 7 for r in win.records if r.traced)
    assert kept == [r.index for r in win.records]
    assert win.syncs == 0 and modes[:2] == ["warn", 0]
    assert all(r.start < win.start + 20 for r in win.records)
