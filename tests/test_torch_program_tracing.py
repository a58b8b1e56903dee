"""The port's own names for its idle time and device time, on the CPU.

(a) ``host.reads{site}`` and the ``host_read.<site>`` spans: a local join
    on each route (as a world of one runs it), the build's overflow
    read, a shrink, an eager regrow that overflows, the group-by's
    ladder, and a compiled query's checked replay (one ``fetch``) and
    unchecked replay (none);
(b) the operator spans (``join``, ``groupby``, ``filter``, ``sort``) and
    their nesting: ``join`` > ``join.indices``, ``join`` > ``gather``;
    ``gather.bytes`` on a known table; ``gather.rows{route}``;
(c) device-timed spans: with no profiler session and no recorder armed
    no CUDA event is made and no ``*.device`` series exists; armed, the
    event pairs resolve into ``<span>.device`` at a later span's exit or
    at ``telemetry.snapshot()``; none is recorded while the stream
    captures (the CUDA parts stubbed on the CPU);
(d) one clock: a span's recorder begin and end enclose its
    ``record_function`` range in a ``torch.profiler`` trace, each within
    100 us on the range's side, and a recorder export with the
    profiler's origin overlays it; a step of the wall clock moves no
    recorder duration, and an export takes the step off.
"""

import json
import time

import numpy as np
import pytest
import torch

import cylon_tpu_torch as ct
from cylon_tpu_torch import DataFrame, Table, plan, telemetry
from cylon_tpu_torch.ops import hash_join
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.ops.join import join
from cylon_tpu_torch.ops.selection import (filter_table, sort_table,
                                           take_columns)
from cylon_tpu_torch.telemetry import trace
from cylon_tpu_torch.utils import tracing
from test_torch_capture import (_example_tables, revenue_by_key,
                                stand_in)  # noqa: F401 -- a fixture


def reads_since(before) -> dict:
    """``host.reads`` by site since the snapshot ``before`` (sites that
    read nothing left out)."""
    return {d["labels"]["site"]: d["value"]
            for d in telemetry.delta(before).values()
            if d["name"] == "host.reads" and d["value"]}


def spans_since(before) -> dict:
    return {d["labels"]["name"]: d["count"]
            for d in telemetry.delta(before).values()
            if d["name"] == tracing.SPAN_METRIC and d["count"]}


def keyed(n=1000, keys=4000, seed=0) -> Table:
    rng = np.random.default_rng(seed)
    return Table.from_pydict({"k": rng.integers(0, keys, n).astype(np.int64),
                              "v": rng.random(n)}, device="cpu")


@pytest.fixture
def armed(monkeypatch):
    """The flight recorder armed on a fresh buffer."""
    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    yield
    monkeypatch.setattr(trace, "_RECORDER", None)


class FakeEvent:
    """A CUDA event on the CPU: records the host clock, completes when
    ``done`` is set or it is waited for."""

    made: list = []

    def __init__(self):
        self.done, self.t = False, None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """The device spans' CUDA parts stubbed: a card present, a stream
    that is not capturing, :class:`FakeEvent` for events."""
    FakeEvent.made = []
    monkeypatch.setattr(tracing, "_cuda_ready", lambda: True)
    monkeypatch.setattr(tracing, "_capturing", lambda: False)
    monkeypatch.setattr(tracing, "_new_event", FakeEvent)
    tracing._PENDING.clear()
    yield FakeEvent
    tracing._PENDING.clear()


def device_series() -> dict:
    return {d["labels"]["name"]: (d["count"], d["sum"])
            for d in telemetry.snapshot().values()
            if d["name"] == tracing.SPAN_METRIC
            and d["labels"]["name"].endswith(".device")}


# ------------------------------------------------------------ (a) reads
@pytest.mark.parametrize("route, want", [
    ("sort", {"stage": 1, "shard_sizes": 1}),
    ("hash", {"chain_check": 1, "stage": 1, "shard_sizes": 1})])
def test_a_local_join_reads_at_its_sites(route, want, monkeypatch):
    """A world of one runs ``dist_join`` as the local join and one rung
    of the ladder: the capacity staged and every rank's count read
    (``shard_sizes``); the bucketed route checks its chains first."""
    if route == "hash":
        monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")
    env = ct.CylonEnv(device="cpu")
    left, right = keyed(seed=1), keyed(seed=2)
    before = telemetry.snapshot()
    ct.dist_join(env, left, right, on="k",
                 algorithm="hash" if route == "hash" else "sort")
    assert reads_since(before) == want
    # each read under its own span, once a read
    spans = spans_since(before)
    assert {s: spans[f"host_read.{s}"] for s in want} == want


def test_the_build_overflow_is_one_read():
    left, right = keyed(seed=3), keyed(seed=4)
    keys = [left.column("k").data], [None], left.nrows
    before = telemetry.snapshot()
    hash_join.bucketed_join_indices(
        *keys, [right.column("k").data], [None], right.nrows, "inner",
        2000, True, sort_fallback=lambda: None, width=1)
    assert reads_since(before) == {"build_overflow": 1}


def test_a_shrink_reads_once_above_its_floor():
    big = Table.from_pydict({"a": np.arange(70_000, dtype=np.int64)},
                            device="cpu")
    before = telemetry.snapshot()
    big.shrink_to_fit()
    keyed().shrink_to_fit()   # at most 2^16 rows: left alone, no read
    assert reads_since(before) == {"shrink": 1}
    # a frame's filter shrinks its result
    df = DataFrame._wrap(big)
    before = telemetry.snapshot()
    df.filter(big.column("a").data < 10)
    assert reads_since(before) == {"shrink": 1}


def test_an_eager_regrow_reads_each_rung():
    # 4 x 4 rows on one key: 16 join rows past the default bound of 8,
    # which fits at twice the scale
    one = {"k": np.ones(4, np.int64), "a": np.arange(4, dtype=np.int64)}
    left = DataFrame(one, device="cpu")
    right = DataFrame({"k": one["k"], "b": np.arange(4.0)}, device="cpu")
    before = telemetry.snapshot()
    out = left.merge(right, on="k")
    assert len(out) == 16
    assert reads_since(before) == {"count": 2}


def test_the_groupby_ladder_reads_its_count_and_its_bound():
    # 20011 distinct keys past the first bound of 8192: two doublings,
    # each overflow also reading the input's count
    n = 20_011
    t = Table.from_pydict({"k": np.arange(n, dtype=np.int64),
                           "v": np.ones(n)}, device="cpu")
    before = telemetry.snapshot()
    g = groupby_aggregate(t, ["k"], [("v", "sum", "s")])
    assert g.num_rows == n
    assert reads_since(before) == {"count": 3, "groupby_bound": 2}


@pytest.mark.parametrize("check, want", [(True, {"fetch": 1}),
                                         (False, {})])
def test_a_compiled_replay_fetches_once_checked_and_never_unchecked(
        check, want, stand_in):
    q = plan.compile_query(revenue_by_key, check=check)
    orders, items = (Table.from_pydict(x, device="cpu")
                     for x in _example_tables())
    q(orders, items, cutoff=180)      # warm-up and capture
    before = telemetry.snapshot()
    q(orders, items, cutoff=180)      # a replay
    assert reads_since(before) == want


def test_host_read_takes_only_the_listed_sites():
    assert set(tracing.HOST_READ_SITES) >= {
        "count", "shrink", "shard_sizes", "chain_check", "build_overflow",
        "fetch", "groupby_bound", "stage"}
    with pytest.raises(KeyError):
        tracing.host_read("somewhere", lambda: 0)


# ------------------------------------------------------------ (b) spans
def test_join_nests_its_indices_and_its_gathers(armed):
    join(keyed(seed=5), keyed(seed=6), on="k")
    evts = [e for e in trace.events() if e["kind"] == "begin"]
    name = {e["id"]: e["name"] for e in evts}
    parents = [(name.get(e["parent"]), e["name"]) for e in evts
               if e["name"] in ("join.indices", "gather")]
    assert parents == [("join", "join.indices"), ("join", "gather"),
                       ("join", "gather")]


def test_the_local_operators_open_their_spans():
    t = keyed(seed=7)
    before = telemetry.snapshot()
    f = filter_table(t, t.column("k").data < 100)
    sort_table(f, ["v"])
    groupby_aggregate(t, ["k"], [("v", "sum", "s")])
    spans = spans_since(before)
    assert spans["filter"] == spans["sort"] == spans["groupby"] == 1


def gather_bytes_since(before) -> list:
    return [d["value"] for d in telemetry.delta(before).values()
            if d["name"] == "gather.bytes"]


def sixteen_rows() -> Table:
    n = 16
    cols = {"i64": ct.Column(torch.arange(n), None, ct.dtypes.int64),
            "f32": ct.Column(torch.ones(n, dtype=torch.float32),
                             torch.ones(n, dtype=torch.bool),
                             ct.dtypes.float32),
            "b": ct.Column(torch.zeros(n, dtype=torch.bool), None,
                           ct.dtypes.bool_)}
    return Table(cols, n)


@pytest.mark.parametrize("nrows_out, rows", [
    (7, 7),                              # every slot a row
    (torch.tensor(5), 5),                # a count on the device: 2 padding
    (torch.tensor(9, dtype=torch.int32), 7)])   # past capacity: overflow
def test_gather_bytes_are_an_index_and_a_row_in_and_out_a_slot(
        armed, nrows_out, rows):
    """Counted from the rows the gather produces, not from its padded
    capacity, summed on the device and folded in at the snapshot."""
    t = sixteen_rows()
    before = telemetry.snapshot()
    take_columns(t, torch.tensor([3, 1, 4, 1, 5, 9, 2]), nrows_out)
    assert tracing._DIRTY
    # words a row: 2 (int64) + 1 (float32) + 1 (its validity) + 1 (bool)
    assert gather_bytes_since(before) == [rows * (8 + 2 * 4 * 5)]
    assert not tracing._DIRTY
    # folded once: a second snapshot adds nothing
    before = telemetry.snapshot()
    assert gather_bytes_since(before) in ([], [0])


def test_gather_bytes_count_only_while_device_spans_record(monkeypatch):
    """Unarmed, and while the stream captures, a gather counts nothing
    and adds nothing on the device; a profiler session arms it."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    t, idx = sixteen_rows(), torch.tensor([0, 1, 2])
    before = telemetry.snapshot()
    take_columns(t, idx, torch.tensor(3))
    assert not tracing._DIRTY
    assert gather_bytes_since(before) in ([], [0])
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(tracing, "_capturing", lambda: True)
        take_columns(t, idx, torch.tensor(3))
        assert not tracing._DIRTY
        monkeypatch.setattr(tracing, "_capturing", lambda: False)
        take_columns(t, idx, torch.tensor(3))
    assert gather_bytes_since(before) == [3 * (8 + 2 * 4 * 5)]


def test_a_gather_adds_its_slots_to_the_plain_route():
    """``take_columns`` on CPU tensors runs ``gather_rows``' plain
    version: its index's length lands in ``gather.rows{route=plain}``
    and nothing in the kernel route."""
    t = sixteen_rows()
    before = telemetry.snapshot()
    take_columns(t, torch.tensor([3, 1, 4, 1, 5, 9, 2]), torch.tensor(5))
    rows = {d["labels"]["route"]: d["value"]
            for d in telemetry.delta(before).values()
            if d["name"] == "gather.rows" and d["value"]}
    assert rows == {"plain": 7}


# ----------------------------------------------------- (c) device spans
def test_unarmed_device_spans_make_no_event_and_no_series(fake_card,
                                                          monkeypatch):
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    telemetry.reset("tracing.")
    assert not torch._C._autograd._profiler_enabled()
    join(keyed(seed=8), keyed(seed=9), on="k")
    assert fake_card.made == []
    assert device_series() == {}
    assert not any(n.endswith(".device") for n in tracing.timings())


def test_recorder_armed_device_spans_resolve_later(fake_card, armed):
    telemetry.reset("tracing.")
    join(keyed(seed=10), keyed(seed=11), on="k")
    # a pair a device span: join.indices and two gathers
    assert len(fake_card.made) == 6
    assert len(tracing._PENDING) == 3
    # nothing completed: a span's exit resolves nothing, nor timings()
    with tracing.span("later"):
        pass
    assert not any(n.endswith(".device") for n in tracing.timings())
    # completed: the next span exit resolves them without a wait
    for e in fake_card.made:
        e.done = True
    with tracing.span("later"):
        pass
    assert tracing._PENDING == type(tracing._PENDING)()
    series = device_series()
    assert series.keys() == {"join.indices.device", "gather.device"}
    assert series["join.indices.device"][0] == 1
    assert series["gather.device"][0] == 2
    assert all(s >= 0 for _, s in series.values())


def test_snapshot_waits_for_pending_pairs(fake_card, armed):
    telemetry.reset("tracing.")
    with tracing.span("timed", device=True):
        pass
    assert len(tracing._PENDING) == 1
    snap = telemetry.snapshot()
    assert tracing._PENDING == type(tracing._PENDING)()
    key = "tracing.span_seconds{name=timed.device}"
    assert snap[key]["count"] == 1
    # the one wait: the end event of the pair
    assert fake_card.made[1].done and not fake_card.made[0].done


def test_a_profiler_session_arms_device_spans(fake_card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    telemetry.reset("tracing.")
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("timed", device=True):
            pass
    with tracing.span("untimed", device=True):
        pass
    assert len(fake_card.made) == 2
    assert set(device_series()) == {"timed.device"}


def test_no_device_timing_while_the_stream_captures(fake_card, armed,
                                                    monkeypatch):
    monkeypatch.setattr(tracing, "_capturing", lambda: True)
    telemetry.reset("tracing.")
    join(keyed(seed=12), keyed(seed=13), on="k")
    assert fake_card.made == []
    assert device_series() == {}


def test_nothing_resolves_while_the_stream_captures(fake_card, armed,
                                                   monkeypatch):
    """An event query inside a capture would break it: pending pairs
    wait until the capture ends, even for a snapshot."""
    telemetry.reset("tracing.")
    with tracing.span("timed", device=True):
        pass
    fake_card.made[1].done = True
    monkeypatch.setattr(tracing, "_capturing", lambda: True)
    with tracing.span("inside"):
        pass
    telemetry.snapshot()
    assert len(tracing._PENDING) == 1
    monkeypatch.setattr(tracing, "_capturing", lambda: False)
    with tracing.span("after"):
        pass
    assert len(tracing._PENDING) == 0
    assert set(device_series()) == {"timed.device"}


def test_threads_resolve_every_pair_once(fake_card, armed):
    """Spans of many threads append pairs while their exits resolve
    them: each pair lands in its series exactly once."""
    import sys
    import threading

    telemetry.reset("tracing.")
    threads, spans = 16, 200

    def work():
        for _ in range(spans):
            with tracing.span("stress", device=True):
                pass
            for e in fake_card.made[-2:]:
                e.done = True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert device_series()["stress.device"][0] == threads * spans
    assert len(tracing._PENDING) == 0


# ------------------------------------------------------------ (d) clock
def test_the_recorder_and_the_profiler_share_a_clock(armed, tmp_path):
    """The span's recorder edges enclose its profiler range: the recorder
    begins before ``record_function`` enters and ends after it exits.
    Read on one clock, each edge lies on its side of the range to within
    100 us in every repetition (an offset between the clocks past that
    breaks one side), and in the closest repetition no farther out than
    the host's own cost of entering and leaving a profiled range (2 ms
    on a loaded host; a stall of the host delays one repetition, an
    offset of the clocks every one)."""
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            with tracing.span("clock.check"):
                time.sleep(0.005)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    rngs = sorted((e for e in doc["traceEvents"]
                   if e.get("name") == "clock.check" and e.get("ph") == "X"),
                  key=lambda e: e["ts"])
    begins = [e["ts"] for e in trace.events()
              if e["name"] == "clock.check" and e["kind"] == "begin"]
    ends = [e["ts"] for e in trace.events()
            if e["name"] == "clock.check" and e["kind"] == "end"]
    assert len(rngs) == len(begins) == len(ends) == reps
    # ns the recorder's edge lies outside the range, begin then end
    gaps = [(base + r["ts"] * 1e3 - b * 1e9,
             e * 1e9 - (base + (r["ts"] + r["dur"]) * 1e3))
            for r, b, e in zip(rngs, begins, ends)]
    for before, after in gaps:
        assert before > -100e3 and after > -100e3
    assert min(g[0] for g in gaps) < 2e6 and min(g[1] for g in gaps) < 2e6
    # the recorder's export on the profiler's origin: one time axis
    ours = telemetry.to_chrome_trace(trace.events(), origin=base / 1e9)
    obs = sorted(x["ts"] for x in ours["traceEvents"]
                 if x.get("name") == "clock.check" and x["ph"] == "B")
    off = [r["ts"] - ob for r, ob in zip(rngs, obs)]
    assert len(off) == reps and all(o > -100 for o in off)
    assert min(off) < 2e3


def test_durations_keep_a_monotonic_clock_and_exports_take_off_the_skew(
        armed, monkeypatch):
    """The recorder stamps a monotonic clock, so a step of the wall clock
    moves no duration; an export at a Unix-clock origin takes off how
    far the wall clock has moved since the recorder took its epoch."""
    with tracing.span("before.step"):
        pass
    assert abs(trace.unix_skew()) < 0.05
    class Stepped:   # the recorder's view of the clocks, wall stepped
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def time():
            return time.time() + 3600.0

    monkeypatch.setattr(trace, "time", Stepped)
    with tracing.span("after.step"):
        time.sleep(0.002)
    (b,) = [e for e in trace.events()
            if e["name"] == "after.step" and e["kind"] == "begin"]
    (e,) = [e for e in trace.events()
            if e["name"] == "after.step" and e["kind"] == "end"]
    assert 0.002 <= e["ts"] - b["ts"] < 1.0
    assert trace.unix_skew() == pytest.approx(3600.0, abs=0.05)
    # origin read on the stepped Unix clock: the span lies just after it
    doc = telemetry.to_chrome_trace(trace.events(),
                                    origin=Stepped.time() - 1.0)
    (ob,) = [x for x in doc["traceEvents"]
             if x.get("name") == "after.step" and x["ph"] == "B"]
    assert 0 < ob["ts"] < 1e6
