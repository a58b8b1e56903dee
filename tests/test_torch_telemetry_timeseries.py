"""The port's ``telemetry.timeseries`` — the sliding-window metric
plane: snapshot-delta ring, windowed rates and quantiles, the shared
EventWindow/BurnRate machinery, and the unarmed-process contract. The
cases of ``tests/test_timeseries.py``, run on ``cylon_tpu_torch``'s
copy of the module (which never imports the JAX package)."""

import bisect
import threading

import numpy as np
import pytest

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry import timeseries
from cylon_tpu_torch.telemetry.registry import BUCKET_BOUNDS, MetricRegistry
from cylon_tpu_torch.telemetry.timeseries import (BurnRate, EventWindow,
                                            MetricHistory,
                                            quantile_from_buckets)


@pytest.fixture(autouse=True)
def _clean():
    timeseries.reset()
    yield
    timeseries.reset()


def _bucket_of(v: float) -> float:
    """The pow2 upper bound a Histogram.observe(v) lands in — the
    exact bucket-resolution oracle for windowed quantiles."""
    return float(BUCKET_BOUNDS[bisect.bisect_left(BUCKET_BOUNDS, v)])


# ------------------------------------------------------ MetricHistory
def test_torch_windowed_counter_delta_and_rate():
    reg = MetricRegistry()
    h = MetricHistory(window_s=10.0, slots=10, reg=reg)
    h.sample(force=True, now=0.0)  # baseline
    for i in range(1, 7):
        reg.counter("x.total", op="a").inc(5)
        reg.counter("x.total", op="b").inc(1)
        h.sample(force=True, now=float(i))
    # full window: all 6 deltas
    assert h.window_total("x.total", window=10.0, now=6.0) == 36
    assert h.window_total("x.total", window=10.0, now=6.0, op="a") == 30
    # narrow window: only the last 2 slots (t1 > 4)
    assert h.window_total("x.total", window=2.0, now=6.0) == 12
    r = h.rate("x.total", window=2.0, now=6.0)
    assert r == pytest.approx(12 / 2.0)
    # a window long past the newest sample holds nothing
    assert h.rate("x.total", window=2.0, now=100.0) is None


def test_torch_windowed_quantile_matches_exact_oracle_across_wraparound():
    """The acceptance pin: windowed p99/p50 equal the EXACT per-value
    quantile at bucket resolution, with the ring WRAPPING (more
    samples than slots) so evicted history provably leaves the
    window."""
    rng = np.random.default_rng(7)
    reg = MetricRegistry()
    # slots=4 bounds the ring below the 10 phases recorded: phases
    # 1..6 are evicted by construction
    h = MetricHistory(window_s=4.0, slots=4, reg=reg)
    h.sample(force=True, now=0.0)
    phases = {}
    for i in range(1, 11):
        vals = rng.uniform(1e-3, 900.0, size=50)
        phases[i] = vals
        hist = reg.histogram("req.seconds", tenant="t")
        for v in vals:
            hist.observe(v)
        h.sample(force=True, now=float(i))
    view = h.window_view(now=10.0)
    assert view["samples"] == 4  # the ring bound held
    # the window covers phases 7..10 ONLY (deltas at t=7..10)
    live = np.sort(np.concatenate([phases[i] for i in (7, 8, 9, 10)]))
    for q in (0.5, 0.9, 0.99):
        got = h.quantile("req.seconds", q, now=10.0)
        # exact oracle: the ceil(q*n)-th order statistic. The
        # log-linear interpolation must stay inside the
        # pow2 bucket that order statistic provably occupies...
        k = max(int(np.ceil(q * len(live))), 1)
        exact = float(live[k - 1])
        le = _bucket_of(exact)
        assert le / 2.0 <= got <= le, (q, got, le)
        # ...and land nearer the exact quantile than the
        # upper-bound answer: the
        # bucket bound could overstate by up to 2x, interpolation
        # must not do worse than it ever did, and must hold 25%
        # relative error where the bound alone only promises 100%
        assert abs(got - exact) <= abs(le - exact) + 1e-12, \
            (q, got, exact, le)
        assert abs(got / exact - 1.0) <= 0.25, (q, got, exact)
    # a saturated bucket interpolates to exactly its bound: q=1.0
    # stays the old bucket-resolution answer
    assert h.quantile("req.seconds", 1.0, now=10.0) == \
        _bucket_of(live[-1])


def test_torch_window_views_merge_across_ranks_via_merge_snapshots():
    """A windowed view has the registry-snapshot shape, so the
    existing associative cross-rank merge applies unchanged —
    windowed fleet quantiles are one bucket-add away."""
    from cylon_tpu_torch.telemetry.aggregate import merge_snapshots

    vals = {}
    views = []
    for rank, seed in ((0, 1), (1, 2)):
        reg = MetricRegistry()
        h = MetricHistory(window_s=10.0, slots=8, reg=reg)
        h.sample(force=True, now=0.0)
        v = np.random.default_rng(seed).uniform(0.01, 50.0, 40)
        vals[rank] = v
        for x in v:
            reg.histogram("req.seconds").observe(x)
        reg.counter("req.total").inc(len(v))
        h.sample(force=True, now=1.0)
        views.append(h.window_view(now=1.0)["series"])
    fleet = merge_snapshots(views)
    assert fleet["req.total"]["value"] == 80
    allv = np.sort(np.concatenate([vals[0], vals[1]]))
    k = max(int(np.ceil(0.9 * len(allv))), 1)
    exact = float(allv[k - 1])
    le = _bucket_of(exact)
    got = quantile_from_buckets(
        fleet["req.seconds"]["buckets"], 0.9)
    # interpolated inside the exact order statistic's bucket, within
    # the tightened 25% tolerance (was: bucket bound, up to 2x off)
    assert le / 2.0 <= got <= le
    assert abs(got / exact - 1.0) <= 0.25, (got, exact)


def test_torch_gauges_report_newest_value_in_window():
    reg = MetricRegistry()
    h = MetricHistory(window_s=10.0, slots=8, reg=reg)
    h.sample(force=True, now=0.0)
    reg.gauge("depth").set(3)
    h.sample(force=True, now=1.0)
    reg.gauge("depth").set(7)
    h.sample(force=True, now=2.0)
    view = h.window_view(now=2.0)
    assert view["series"]["depth"]["value"] == 7


def test_torch_sample_throttle_and_force():
    reg = MetricRegistry()
    h = MetricHistory(window_s=10.0, slots=10, reg=reg)  # spacing 1s
    assert h.sample(now=0.0)
    reg.counter("c").inc()
    assert not h.sample(now=0.5)  # throttled
    assert h.sample(now=0.5, force=True)
    assert h.window_total("c", now=0.5) == 1


def test_torch_quantile_from_buckets_edges():
    assert quantile_from_buckets({}, 0.5) is None
    # log-linear interpolation inside the (4, 8] bucket: the median
    # of 10 observations sits at in-bucket fraction 0.5, i.e.
    # 4 * 2**0.5 — exact at both edges, never past the bound
    assert quantile_from_buckets({"8.0": 10}, 0.5) == \
        pytest.approx(4.0 * 2.0 ** 0.5)
    assert quantile_from_buckets({"8.0": 10}, 1.0) == 8.0
    assert quantile_from_buckets({"8.0": 10}, 0.0) == 4.0
    # overflow-only observations resolve to the top finite bound —
    # never +inf
    got = quantile_from_buckets({"+inf": 3}, 0.99)
    assert got == float(BUCKET_BOUNDS[-1]) and np.isfinite(got)
    with pytest.raises(ValueError):
        quantile_from_buckets({"8.0": 1}, 1.5)


# -------------------------------------------------- EventWindow / Burn
def test_torch_event_window_counts_and_evicts():
    w = EventWindow(window_s=10.0, slots=10)
    for t in (0.0, 1.0, 2.0):
        w.add(1, now=t)
    assert w.count(now=2.0) == 3
    # 11.5s later t=0 aged out; t=1 (10.5s old) is RETAINED — bucket
    # granularity over-approximates, never undercounts (below)
    assert w.count(now=11.5) == 2
    assert w.count(now=12.5) == 1
    assert w.count(now=30.0) == 0


def test_torch_event_window_never_undercounts_at_the_edge():
    """The breaker-regression case: events just inside the window
    whose BUCKET started just outside it must still count — evicting
    on bucket start silently dropped them (a breaker that misses its
    trip threshold)."""
    w = EventWindow(window_s=30.0, slots=32)  # width ~0.94s
    w.add(1, now=0.2)
    w.add(1, now=0.5)  # 29.6s old at t=30.1: INSIDE the window
    w.add(1, now=15.0)
    w.add(1, now=29.0)
    w.add(1, now=30.1)
    assert w.count(now=30.1) == 5
    # bounded memory however large the storm (monotonic time, like
    # every real caller)
    for i in range(10_000):
        w.add(1, now=50.0 + i * 0.001)
    assert len(w._buckets) <= w.slots + 1


def test_torch_burn_rate_math_and_decay():
    # objective 0.9 -> 10% error budget
    br = BurnRate(0.9, windows=(10.0, 100.0))
    for i in range(8):
        br.record(True, now=float(i))
    br.record(False, now=8.0)
    br.record(False, now=9.0)
    # 2 bad / 10 total = 0.2 bad fraction / 0.1 budget = 2x burn
    assert br.burn(10.0, now=9.0) == pytest.approx(2.0)
    assert br.burn(100.0, now=9.0) == pytest.approx(2.0)
    # short window forgets the storm, long one still remembers
    assert br.burn(10.0, now=25.0) is None
    assert br.burn(100.0, now=25.0) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        BurnRate(1.5, windows=(10.0,))
    with pytest.raises(ValueError):
        BurnRate(0.9, windows=())


# ------------------------------------------------------ process plane
def test_torch_process_history_arms_lazily_and_resets():
    assert not timeseries.armed()
    telemetry.counter("ts.probe").inc()
    assert not timeseries.armed()  # instruments never arm it
    timeseries.sample(force=True)
    assert timeseries.armed()
    telemetry.counter("ts.probe").inc(3)
    timeseries.sample(force=True)
    assert timeseries.window_total("ts.probe") >= 3
    timeseries.reset()
    assert not timeseries.armed()
    telemetry.reset("ts.")


def test_torch_history_thread_safe_under_concurrent_sampling():
    reg = MetricRegistry()
    h = MetricHistory(window_s=60.0, slots=64, reg=reg)
    stop = threading.Event()

    def bump():
        while not stop.is_set():
            reg.counter("hot").inc()

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            h.sample(force=True)
            h.window_view()
    finally:
        stop.set()
        for t in threads:
            t.join()
    total = reg.counter("hot").value
    # every increment before the final sample is in some delta slot
    h.sample(force=True)
    assert h.window_total("hot") <= total
