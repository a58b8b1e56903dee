"""The port's telemetry core: registry, instruments, exporters,
aggregation, and its instrumentation of the dist ops, the exchange, the
join router, the operator graph, ``CompiledQuery`` and ``CylonEnv``.

The first cases are those of ``tests/test_telemetry.py`` on
``cylon_tpu_torch`` (its registry is the port's own, separate from the
JAX package's in the one process the parity tests run in). Left out are
the cases that need the resilience layer, the out-of-core executor or
the watchdog (ROADMAP A7.1, A7.2), and the padded exchange's wire-row
pricing, which the port's exact-count exchange does not have. Then the
parity tests: the same numpy inputs through the JAX package on ``env4``
and through the port on a W = 4 ``ThreadWorld`` give the same world
sums of ``exchange.rows`` and ``exchange.bytes_true`` (not of
``exchange.bytes_padded``: the JAX package on the CPU takes its padded
path, the port its one exact-count path), the same ``join.algorithm``
decisions, and stage spans that cover the JAX package's.
"""

import json
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu_torch as ct
from cylon_tpu_torch import convert, telemetry
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.telemetry import trace
from cylon_tpu_torch.telemetry.registry import MetricRegistry


@pytest.fixture(autouse=True)
def _clean_registry():
    telemetry.reset()
    yield
    telemetry.reset()


# ------------------------------------------------------------ instruments
def test_torch_concurrent_counter_increments_lose_no_updates():
    c = telemetry.counter("t.concurrent")
    per, nthreads = 5000, 8

    def work():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == per * nthreads


def test_torch_labels_are_distinct_series_and_total_sums():
    telemetry.counter("t.bytes", op="a").inc(3)
    telemetry.counter("t.bytes", op="b").inc(4)
    assert telemetry.counter("t.bytes", op="a").value == 3
    assert telemetry.total("t.bytes") == 7
    snap = telemetry.snapshot()
    assert snap["t.bytes{op=a}"]["value"] == 3
    assert snap["t.bytes{op=b}"]["labels"] == {"op": "b"}


def test_torch_gauge_keeps_last_value():
    g = telemetry.gauge("t.g")
    g.set(2.5)
    g.set(1.5)
    assert telemetry.metric("t.g").value == 1.5


def test_torch_histogram_stats_and_buckets():
    h = telemetry.histogram("t.h")
    for v in (0.001, 0.002, 4.0):
        h.observe(v)
    assert h.count == 3
    assert h.min == 0.001 and h.max == 4.0
    assert abs(h.sum - 4.003) < 1e-9
    assert sum(h.buckets) == 3


def test_torch_timer_context_manager_observes_seconds():
    t = telemetry.timer("t.t", section="x")
    with t.time():
        pass
    assert t.count == 1 and 0 <= t.min < 1.0


def test_torch_metric_lookup_does_not_create():
    assert telemetry.metric("t.absent") is None
    telemetry.counter("t.present").inc()
    assert telemetry.metric("t.present").value == 1


def test_torch_kind_mismatch_raises():
    telemetry.counter("t.kind")
    with pytest.raises(TypeError):
        telemetry.gauge("t.kind")


def test_torch_delta_subtracts_counters_and_histograms():
    telemetry.counter("t.d").inc(5)
    telemetry.histogram("t.dh").observe(1.0)
    prev = telemetry.snapshot()
    telemetry.counter("t.d").inc(2)
    telemetry.histogram("t.dh").observe(2.0)
    d = telemetry.delta(prev)
    assert d["t.d"]["value"] == 2
    assert d["t.dh"]["count"] == 1
    assert sum(d["t.dh"]["buckets"].values()) == 1


def test_torch_reset_by_prefix():
    telemetry.counter("a.x").inc()
    telemetry.counter("b.y").inc()
    telemetry.add_record("a.recs", 1)
    telemetry.reset("a.")
    assert telemetry.metric("a.x") is None
    assert telemetry.get_records("a.recs") == []
    assert telemetry.metric("b.y").value == 1


# ------------------------------------------------------------ aggregation
def _rank_snapshot(seed: int) -> dict:
    reg = MetricRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("exchange.bytes_true", op="join").inc(100 * (seed + 1))
    h = reg.timer("watchdog.section_seconds", section="exchange")
    for v in rng.uniform(1e-4, 2.0, 17):
        h.observe(float(v))
    reg.gauge("exchange.pad_ratio").set(1.0 + seed)
    return reg.snapshot()


def test_torch_histogram_merge_across_ranks_is_associative():
    a, b, c = (_rank_snapshot(s) for s in range(3))
    m = telemetry.merge_snapshots
    left = m([m([a, b]), c])
    right = m([a, m([b, c])])
    assert left == right
    key = "watchdog.section_seconds{section=exchange}"
    assert left[key]["count"] == 3 * 17
    for snap in (a, b, c):
        for le, n in snap[key]["buckets"].items():
            assert left[key]["buckets"][le] >= n


def test_torch_merge_sums_counters_and_maxes_gauges():
    a, b, c = (_rank_snapshot(s) for s in range(3))
    fleet = telemetry.merge_snapshots([a, b, c])
    assert fleet["exchange.bytes_true{op=join}"]["value"] == 600
    assert fleet["exchange.pad_ratio"]["value"] == 3.0


def test_torch_gather_metrics_single_process_is_local_snapshot():
    telemetry.counter("t.gather").inc(9)
    fleet = telemetry.gather_metrics()
    assert fleet["t.gather"]["value"] == 9
    assert fleet == telemetry.snapshot()


# -------------------------------------------------------------- exporters
def test_torch_jsonl_export_roundtrip_contains_no_inf_or_nan(tmp_path):
    telemetry.counter("t.c").inc(2)
    telemetry.gauge("t.inf").set(float("inf"))
    telemetry.gauge("t.nan").set(float("nan"))
    telemetry.timer("t.empty")  # zero observations: min/max are None
    h = telemetry.histogram("t.h")
    h.observe(float("inf"))  # overflow-bucketed, excluded from sum
    path = telemetry.write_snapshot(directory=str(tmp_path))
    assert path is not None
    lines = open(path).read().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])  # strict parse would choke on Infinity
    assert "Infinity" not in lines[0] and "NaN" not in lines[0]
    m = rec["metrics"]
    assert m["t.c"]["value"] == 2
    assert m["t.inf"]["value"] is None
    assert m["t.empty"]["min"] is None
    assert m["t.h"]["count"] == 1 and m["t.h"]["sum"] == 0.0
    # round-trip: the parsed snapshot re-exports byte-identically
    assert telemetry.snapshot_to_json(m) == telemetry.snapshot_to_json(
        json.loads(telemetry.snapshot_to_json(m)))


def test_torch_prometheus_dump_shape(tmp_path):
    telemetry.counter("exchange.bytes_true", op="shuffle").inc(64)
    t = telemetry.timer("watchdog.section_seconds", section="exchange")
    t.observe(0.25)
    text = telemetry.to_prometheus()
    assert "# TYPE cylon_exchange_bytes_true counter" in text
    assert 'cylon_exchange_bytes_true{op="shuffle"} 64' in text
    assert "# TYPE cylon_watchdog_section_seconds histogram" in text
    assert ('cylon_watchdog_section_seconds_bucket'
            '{section="exchange",le="+inf"} 1') in text
    assert "cylon_watchdog_section_seconds_count" in text
    assert "inf " not in text.replace('le="+inf"', "")
    # the .prom companion file lands next to the JSONL
    telemetry.write_snapshot(directory=str(tmp_path))
    proms = list(tmp_path.glob("*.prom"))
    assert proms and proms[0].read_text().startswith("# TYPE")


def test_torch_no_exporter_and_no_threads_without_metrics_dir(monkeypatch):
    monkeypatch.delenv("CYLON_TPU_METRICS_DIR", raising=False)
    before = set(threading.enumerate())
    for i in range(100):
        telemetry.counter("t.fast", op=str(i % 3)).inc()
    with telemetry.timer("t.fast_timer").time():
        pass
    telemetry.snapshot()
    assert set(threading.enumerate()) == before


def test_torch_span_stat_to_json_normalises_inf():
    from cylon_tpu_torch.utils.tracing import SpanStat

    empty = SpanStat()
    assert empty.min_s == float("inf")  # the raw default stays
    js = json.dumps(empty.to_json(), allow_nan=False)  # but exports
    assert json.loads(js)["min_s"] is None
    full = SpanStat(2, 0.5, 0.1, 0.4)
    assert json.loads(json.dumps(full.to_json()))["min_s"] == 0.1


def test_torch_tracing_spans_feed_the_registry():
    from cylon_tpu_torch.utils import tracing

    with tracing.span("t_unit"):
        pass
    snap = telemetry.snapshot()
    key = f"{tracing.SPAN_METRIC}{{name=t_unit}}"
    assert snap[key]["count"] == 1
    assert tracing.timings()["t_unit"].count == 1
    tracing.reset_timings()
    assert "t_unit" not in tracing.timings()


# ------------------------------------------------ engine instrumentation
def _table(n, **cols):
    return ct.Table.from_pydict({k: v[:n] for k, v in cols.items()},
                                device="cpu")


def test_torch_transport_words():
    t = ct.Table.from_pydict({
        "k": np.arange(32, dtype=np.int64),       # 2 words
        "v": np.ones(32),                          # 2 words (f64)
        "f": np.ones(32, np.float32),              # 1 word
    }, device="cpu")
    from cylon_tpu_torch.parallel.shuffle import transport_words

    assert transport_words(t) == 5
    nullable = ct.Table.from_pandas(pd.DataFrame(
        {"k": pd.array([1, None, 3], dtype="Int64")}), device="cpu")
    assert transport_words(nullable) == 3         # the validity word


class _StubEnv:
    """Host-side stand-in for a CylonEnv: _note_exchange reads only the
    rank, the world and the count matrices, so the pricing is testable
    without running an exchange."""

    world_size = 4
    rank = 1


def _cmat(rows):
    return torch.tensor(rows, dtype=torch.int32)


def test_torch_note_exchange_prices_true_bytes_from_the_count_matrices():
    from cylon_tpu_torch.parallel import dist_ops

    # two exchanges (a join's sides): [W send, W dest] row counts every
    # rank holds; this rank (1) sent 10 + 6 rows of 4 words, 5 + 1 of 3
    left = _cmat([[1, 2, 3, 4], [1, 2, 3, 4], [0, 0, 0, 0], [5, 5, 5, 5]])
    right = _cmat([[0, 0, 0, 0], [2, 2, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0]])
    dist_ops._note_exchange(_StubEnv(), "dist_join",
                            [(left, 4), (right, 3)])
    assert telemetry.total("exchange.rows") == 10 + 6
    true_b = telemetry.total("exchange.bytes_true")
    assert true_b == (10 * 4 + 6 * 3) * 4
    # the exact-count exchange ships exactly the rows: no padding
    assert telemetry.total("exchange.bytes_padded") == true_b
    calls = telemetry.metric("exchange.calls", op="dist_join",
                             path="ragged")
    assert calls is not None and calls.value == 1
    ratio = telemetry.metric("exchange.pad_ratio", op="dist_join")
    assert ratio is not None and ratio.value == 1.0


def test_torch_note_exchange_never_reads_the_device(monkeypatch):
    """The pricing reads only host matrices: no tensor is moved or
    synced, whatever the op's capacities (the JAX package's explicit-
    capacity dispatches skip the pricing fetch; the port needs none)."""
    from cylon_tpu_torch.parallel import dist_ops

    def _no_copy(*a, **k):
        raise AssertionError("the pricing moved a tensor")

    monkeypatch.setattr(torch.Tensor, "cpu", _no_copy)
    monkeypatch.setattr(torch.Tensor, "item", _no_copy)
    dist_ops._note_exchange(_StubEnv(), "shuffle",
                            [(_cmat([[1] * 4] * 4), 2)])
    assert telemetry.total("exchange.bytes_true") == 4 * 2 * 4


def test_torch_note_exchange_of_no_exchange_records_nothing():
    """A dispatch that exchanged nothing (the world-of-one short-circuit
    of dist_join) prices nothing, as the JAX package skips traced
    tables."""
    from cylon_tpu_torch.parallel import dist_ops

    dist_ops._note_exchange(_StubEnv(), "shuffle", [])
    assert telemetry.total("exchange.calls") == 0
    env = ct.CylonEnv(device="cpu")
    t = _table(64, k=np.arange(64, dtype=np.int64))
    ct.dist_join(env, t, t, on="k")
    assert telemetry.total("exchange.calls") == 0
    assert telemetry.total("join.algorithm") == 1


def test_torch_write_snapshot_survives_bad_gauge_without_losing_others(
        tmp_path):
    telemetry.counter("t.good").inc(7)
    telemetry.gauge("t.bad").set(object())
    telemetry.gauge("t.np").set(np.float32(1.5))
    path = telemetry.write_snapshot(directory=str(tmp_path))
    assert path is not None
    m = json.loads(open(path).read().splitlines()[-1])["metrics"]
    assert m["t.good"]["value"] == 7
    assert isinstance(m["t.bad"]["value"], str)
    assert m["t.np"]["value"] == 1.5


def test_torch_prometheus_values_are_exact_and_labels_escaped():
    telemetry.counter("t.bytes").inc(1_234_567_890)
    telemetry.counter("t.esc", name='load "x"\\n').inc()
    text = telemetry.to_prometheus()
    assert "cylon_t_bytes 1234567890" in text
    assert r'name="load \"x\"\\n"' in text


def _w4_join(n=512, seed=0, **kw):
    rng = np.random.default_rng(seed)
    q = n // 4
    lk, rk = rng.integers(0, 64, n), rng.integers(0, 64, n)
    a, b = rng.normal(size=n), rng.normal(size=n)

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        r = comm.rank
        lt = _table(q, k=lk[r * q:(r + 1) * q], a=a[r * q:(r + 1) * q])
        rt = _table(q, k=rk[r * q:(r + 1) * q], b=b[r * q:(r + 1) * q])
        return ct.dist_join(env, lt, rt, on="k", how="inner", **kw)

    return ct.ThreadWorld(4).run(rank)


def test_torch_snapshot_after_dist_join_reports_exchange_and_stages():
    # without a card the exchange's (unforced) sample reuses the last
    # forced walk's total: take one first, with a tensor live
    keep = torch.ones(1024)
    assert telemetry.memory.sample(force=True) >= keep.nbytes
    _w4_join()
    snap = telemetry.snapshot()
    # each rank counts its own dispatch: four calls, the world's rows
    assert telemetry.total("exchange.calls") == 4
    assert telemetry.total("exchange.rows") == 2 * 512
    assert telemetry.total("exchange.bytes_true") == 2 * 512 * 4 * 4
    assert telemetry.total("exchange.bytes_padded") == \
        telemetry.total("exchange.bytes_true")
    assert telemetry.total("exchange.tight_dispatches") == 4
    for stage in ("prepare", "count_probe", "price"):
        key = f"tracing.span_seconds{{name=dist_join.{stage}}}"
        assert snap[key]["count"] == 4, key
    # one dispatch and one count check a rung of the regrow ladder
    runs = snap["tracing.span_seconds{name=dist_join.dispatch}"]["count"]
    assert runs == snap["tracing.span_seconds{name=dist_join.sync}"][
        "count"] >= 4
    assert runs - 4 == telemetry.total("exchange.fallback_regrows")
    assert telemetry.metric("memory.peak_bytes", op="dist_join") is not None
    # the ThreadWorld ranks share the process registry: their world view
    # is the local snapshot, gathered by no collective
    views = ct.ThreadWorld(4).run(lambda comm: telemetry.gather_metrics(
        ct.CylonEnv(comm, device="cpu")))
    assert all(v == telemetry.snapshot() for v in views)


def test_torch_explicit_capacity_dispatch_is_priced_too():
    _w4_join(out_capacity=1 << 12, shuffle_capacity=1 << 12)
    assert telemetry.total("exchange.bytes_true") == 2 * 512 * 4 * 4
    assert telemetry.total("exchange.tight_dispatches") == 0


def test_torch_regrow_counts_overflows_and_rescales():
    """Every key equal: the receive buffers overflow, the ladder doubles
    (plan.overflow_events / plan.capacity_rescales at site=dist) and
    the tight dispatch counts its fallback regrows."""
    n = 64

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        t = _table(n, k=np.full(n, 5), a=np.arange(n))
        return ct.shuffle(env, t, ["k"])

    ct.ThreadWorld(4).run(rank)
    ov = telemetry.total("plan.overflow_events")
    assert ov >= 4 and ov % 4 == 0        # every rank takes each rung
    assert telemetry.total("plan.capacity_rescales") == ov
    assert telemetry.total("exchange.fallback_regrows") == ov


def test_torch_bench_metrics_block_is_strict_json_and_complete():
    from cylon_tpu_torch.telemetry import REQUIRED_BENCH_KEYS, bench_metrics

    telemetry.counter("exchange.calls", op="x", path="ragged").inc()
    telemetry.gauge("exchange.pad_ratio", op="x").set(float("inf"))
    telemetry.gauge("exchange.pad_ratio", op="y").set(object())
    blk = bench_metrics()
    for k in REQUIRED_BENCH_KEYS:
        assert k in blk
    assert blk["exchange.calls"] == 1
    assert "exchange.pad_ratio" not in blk
    telemetry.gauge("exchange.pad_ratio", op="z").set(2.5)
    assert bench_metrics()["exchange.pad_ratio"] == 2.5
    json.loads(json.dumps(blk, allow_nan=False))


def test_torch_roofline_constants_are_the_h100_data_sheets():
    assert telemetry.HBM_PEAK_BYTES_PER_SEC == 3.35e12
    assert telemetry.NVLINK_BYTES_PER_SEC == 900e9
    assert not hasattr(telemetry, "ICI_LINK_BYTES_PER_SEC")
    assert telemetry.fraction_of_peak(3.35e12 / 2) == 0.5


def test_torch_unarmed_instrumented_ops_start_no_thread_open_no_file(
        monkeypatch):
    """With CYLON_TPU_TRACE and CYLON_TPU_METRICS_DIR unset, the
    instrumented ops make dict updates only: no recorder, no exporter
    thread, no file."""
    import builtins

    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    monkeypatch.delenv("CYLON_TPU_METRICS_DIR", raising=False)
    monkeypatch.setattr(trace, "_RECORDER", None)
    before = set(threading.enumerate())
    opened = []
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open",
                        lambda *a, **k: opened.append(a) or real_open(*a,
                                                                      **k))
    t = _table(128, k=np.arange(128) % 7, a=np.ones(128))
    env = ct.CylonEnv(device="cpu")
    ct.shuffle(env, t, ["k"])
    ct.dist_join(env, t, t, on="k")
    q = ct.plan.compile_query(lambda x: ct.join(x, x, on="k"))
    q(t)
    assert trace._RECORDER is None
    assert opened == []
    after = set(threading.enumerate())
    assert {th for th in after - before if th.is_alive()} == set()
    assert telemetry.total("exchange.calls") == 1


# ------------------------------------------------------ join router
@pytest.mark.parametrize("algorithm,impl,kinds", [
    ("sort", "sort", {"sort->sort"}),
    ("hash", "sort", {"hash->hash_sort"}),
    ("hash", "bucketed", {"hash->hash_bucketed"}),
])
def test_torch_join_algorithm_kinds_match_jax(monkeypatch, algorithm, impl,
                                              kinds):
    import cylon_tpu as jct
    from cylon_tpu import telemetry as jtel
    from cylon_tpu.ops.join import join as jjoin

    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", impl)
    rng = np.random.default_rng(7)
    ldf = pd.DataFrame({"k": rng.integers(0, 40, 96),
                        "a": rng.normal(size=96)})
    rdf = pd.DataFrame({"k": rng.integers(0, 40, 80),
                        "b": rng.normal(size=80)})
    jtel.reset("join.")
    jjoin(jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf), on="k",
          algorithm=algorithm)
    ct.join(ct.Table.from_pandas(ldf, device="cpu"),
            ct.Table.from_pandas(rdf, device="cpu"), on="k",
            algorithm=algorithm)

    def kinds_of(tel):
        return {lab["kind"] for _, lab, inst in tel.instruments(
            "join.algorithm") if inst.value}

    assert kinds_of(jtel) == kinds_of(telemetry) == kinds
    jtel.reset("join.")


def test_torch_bucketed_chain_overflow_counts_a_fallback(monkeypatch):
    """Every build key equal: the bucket chains pass their budget, so
    the bucketed route takes the sort join and says so."""
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")
    t = _table(256, k=np.zeros(256, np.int64), a=np.ones(256))
    ct.join(t, t, on="k", algorithm="hash", out_capacity=1 << 17)
    assert telemetry.total("join.overflow_fallbacks") == 1
    got = {lab["kind"] for _, lab, _ in telemetry.instruments(
        "join.algorithm")}
    assert got == {"hash->sort_overflow"}


# ----------------------------------------- exchange counters vs the JAX
def _to_port(jt):
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu")


def _parity_frames():
    rng = np.random.default_rng(11)
    nl, nr = 900, 700
    lk = pd.array(rng.integers(0, 300, nl), dtype="Int64")
    lk[rng.random(nl) < 0.05] = pd.NA
    ldf = pd.DataFrame({"k": lk, "a": rng.normal(size=nl)})
    rdf = pd.DataFrame({"k": rng.integers(0, 300, nr),
                        "b": rng.integers(0, 50, nr)})
    return ldf, rdf


@pytest.mark.parametrize("op", ["dist_join", "shuffle"])
def test_torch_exchange_counters_match_jax_world_sums(env4, op):
    """The world sums of exchange.rows and exchange.bytes_true equal the
    JAX package's (true bytes = rows x words x 4 on both sides). The
    calls differ by design: each of the port's four ranks counts its
    own (SPMD), the JAX single controller counts one; bytes_padded
    follows each package's own path (JAX on the CPU: padded; the port:
    exact counts, so equal to the true bytes)."""
    import cylon_tpu as jct
    from cylon_tpu import telemetry as jtel
    from cylon_tpu.parallel import dist_join as jdist_join
    from cylon_tpu.parallel import scatter_table as jscatter
    from cylon_tpu.parallel import shuffle as jshuffle

    ldf, rdf = _parity_frames()
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    jtel.reset("exchange.")
    if op == "dist_join":
        jdist_join(env4, jscatter(env4, jl), jscatter(env4, jr), on="k")
    else:
        jshuffle(env4, jscatter(env4, jl), ["k"])
    tl, tr = _to_port(jl), _to_port(jr)

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        if op == "dist_join":
            return ct.dist_join(env, scatter_table(env, tl),
                                scatter_table(env, tr), on="k")
        return ct.shuffle(env, scatter_table(env, tl), ["k"])

    ct.ThreadWorld(4).run(rank)
    for name in ("exchange.rows", "exchange.bytes_true"):
        assert telemetry.total(name) == jtel.total(name) > 0, name
    assert jtel.total("exchange.calls") == 1
    assert telemetry.total("exchange.calls") == 4
    assert telemetry.total("exchange.bytes_padded") == \
        telemetry.total("exchange.bytes_true")
    jtel.reset("exchange.")


#: the JAX package's stage events of a dist_join at W = 4 that have no
#: port span of the same name: the padded exchange's bucket probe, a
#: path the port does not have (the watchdog's ``exchange`` section is
#: in both)
_JAX_ONLY_STAGES = {"probe.max_bucket": "padded path only"}


def test_torch_dist_join_stage_spans_cover_the_jax_ones(env4, monkeypatch):
    import cylon_tpu as jct
    from cylon_tpu.parallel import dist_join as jdist_join
    from cylon_tpu.parallel import scatter_table as jscatter
    from cylon_tpu.telemetry import trace as jtrace

    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    monkeypatch.setattr(jtrace, "_RECORDER", None)
    monkeypatch.setattr(trace, "_RECORDER", None)
    ldf, rdf = _parity_frames()
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    jdist_join(env4, jscatter(env4, jl), jscatter(env4, jr), on="k")
    tl, tr = _to_port(jl), _to_port(jr)
    ct.ThreadWorld(4).run(lambda comm: ct.dist_join(
        ct.CylonEnv(comm, device="cpu"), scatter_table(
            ct.CylonEnv(comm, device="cpu"), tl),
        scatter_table(ct.CylonEnv(comm, device="cpu"), tr), on="k"))

    def stages(evts):
        return {e["name"] for e in evts if e.get("cat") == "stage"}

    want = stages(jtrace.events())
    got = stages(trace.events())
    assert {s for s in want if s.startswith("dist_join.")} == \
        {f"dist_join.{s}" for s in ("prepare", "count_probe", "dispatch",
                                    "sync", "price")}
    assert want - got <= set(_JAX_ONLY_STAGES), want - got
    for r in range(4):
        assert stages(e for e in trace.events() if e.get("rank") == r) \
            >= {s for s in want if s.startswith("dist_join.")} | {"exchange"}


# ----------------------------------------------- operator graph, plan
def test_torch_ops_graph_counts_chunks_per_op_and_tenant():
    from cylon_tpu_torch.ops_graph import Op, RootOp, SequentialExecution

    root = RootOp()
    op = Op(1, execute=lambda tag, t: [])
    op.add_child(root)
    for i in range(3):
        op.insert(0, _table(8, k=np.arange(8)))
    with telemetry.tenant_scope("acme"):
        op.progress()
    op.progress()
    op.progress()
    assert telemetry.counter("ops_graph.chunks", op="Op",
                             tenant="acme").value == 1
    assert telemetry.counter("ops_graph.chunks", op="Op").value == 2
    del SequentialExecution


def test_torch_compiled_query_counts_hits_misses_and_evictions(
        monkeypatch):
    monkeypatch.setattr(ct.plan, "_MEMO_ENTRIES", 2)
    q = ct.plan.compile_query(lambda t, n: ct.head(t, n))
    tabs = [_table(m, k=np.arange(m)) for m in (8, 16, 32)]
    q(tabs[0], 3)
    q(tabs[0], 3)
    assert telemetry.total("plan.cache_misses") == 1
    assert telemetry.total("plan.cache_hits") == 1
    assert telemetry.total("plan.compile_count") == 1
    q(tabs[1], 3)
    q(tabs[2], 3)                     # a third shape evicts the first
    assert telemetry.total("plan.cache_evictions") == 1
    assert len(q._scale_memo) == 2
    stats = ct.plan.plan_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == 3
    assert stats["hit_rate"] == 0.25 and stats["evictions"] == 1
    snap = telemetry.snapshot()
    assert snap["tracing.span_seconds{name=plan.dispatch}"]["count"] == 4
    assert snap["tracing.span_seconds{name=plan.fetch}"]["count"] == 4


def test_torch_compiled_query_regrow_counts_and_instants(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    monkeypatch.setattr(trace, "_RECORDER", None)
    n = 64
    t = _table(n, k=np.zeros(n, np.int64), a=np.arange(n))
    # the 1:N join of equal keys outgrows its default bound (2n rows)
    q = ct.plan.compile_query(lambda x: ct.join(x, x, on="k"))
    out = q(t)
    assert out.num_rows == n * n
    assert telemetry.total("plan.overflow_events") >= 1
    assert telemetry.total("plan.capacity_rescales") >= 1
    names = [e["name"] for e in trace.events()]
    assert "plan.compile" in names
    assert "capacity.overflow" in names and "capacity.regrow" in names


def test_torch_query_fingerprint_is_stable_and_refuses_tensors():
    fp = ct.plan.query_fingerprint("q3", (1, "x"), {"k": [1, 2]})
    assert fp == ct.plan.query_fingerprint("q3", (1, "x"), {"k": [1, 2]})
    assert fp != ct.plan.query_fingerprint("q5", (1, "x"), {"k": [1, 2]})
    assert len(fp) == 64
    assert ct.plan.query_fingerprint("q3", (torch.ones(1),)) is None


# ---------------------------------------------------------- CylonEnv
def test_torch_env_config_store_topology_and_sequence():
    env = ct.CylonEnv(device="cpu")
    env.add_config("spill", 1)
    assert env.get_config("spill") == "1"
    assert env.get_config("absent", "d") == "d"
    assert env.get_configs() == {"spill": "1"}
    assert env.context is env
    assert env.is_distributed is False and env.is_finalized is False
    a, b = ct.CylonEnv.get_next_sequence(), ct.CylonEnv.get_next_sequence()
    assert b > a
    env.finalize()
    assert env.is_finalized
    got = ct.ThreadWorld(4).run(lambda comm: (
        ct.CylonEnv(comm, device="cpu").is_distributed,
        ct.CylonEnv(comm, device="cpu").get_neighbours(),
        ct.CylonEnv(comm, device="cpu").get_neighbours(include_self=True)))
    for r, (dist, nb, nb_self) in enumerate(got):
        assert dist and nb == [x for x in range(4) if x != r]
        assert nb_self == [0, 1, 2, 3]


def test_torch_barrier_waits_for_every_rank_and_times_it():
    import time

    arrived = []

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        if comm.rank == 2:
            time.sleep(0.05)
        arrived.append(comm.rank)
        env.barrier()
        return sorted(arrived)

    assert ct.ThreadWorld(4).run(rank) == [[0, 1, 2, 3]] * 4
    assert telemetry.metric("barrier.wait_seconds").count == 4
    # a bounded barrier (the watchdog's "barrier" section) completes well
    # inside its timeout and is timed like any other
    ct.CylonEnv(device="cpu").barrier(timeout=30.0)
    assert telemetry.metric("barrier.wait_seconds").count == 5


def test_torch_parallel_aliases():
    from cylon_tpu_torch import parallel

    assert parallel.distributed_join is parallel.dist_join
    assert parallel.distributed_sort is parallel.dist_sort
    assert parallel.distributed_union is parallel.dist_union
    assert parallel.distributed_intersect is parallel.dist_intersect
    assert parallel.distributed_subtract is parallel.dist_subtract
    assert parallel.distributed_unique is parallel.dist_unique
    assert parallel.distributed_concat is parallel.dist_concat


# ------------------------------------------------ resilience and watchdog
def test_torch_faultrule_firing_increments_faults_injected():
    from cylon_tpu_torch import resilience
    from cylon_tpu_torch.errors import TransientError

    plan = resilience.FaultPlan([
        resilience.FaultRule("io_read", nth=2, times=2)])
    with resilience.active(plan):
        resilience.inject("io_read")
        assert telemetry.total("resilience.faults_injected") == 0
        for _ in range(2):
            with pytest.raises(TransientError):
                resilience.inject("io_read")
    c = telemetry.metric("resilience.faults_injected", point="io_read")
    assert c is not None and c.value == 2
    assert len(plan.fired) == 2


def test_torch_retrying_counts_retries_by_code():
    from cylon_tpu_torch import resilience
    from cylon_tpu_torch.config import RetryPolicy
    from cylon_tpu_torch.errors import TransientError

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("flake")
        return "ok"

    assert resilience.retrying(flaky, RetryPolicy(max_attempts=5,
                                                  base_delay=0.0),
                               sleep_fn=lambda _: None) == "ok"
    c = telemetry.metric("resilience.retries", code="Unavailable")
    assert c is not None and c.value == 2


def test_torch_spill_store_records_bytes_and_latency(tmp_path):
    from cylon_tpu_torch import resilience

    store = resilience.SpillStore(str(tmp_path), fingerprint="fp")
    cols = {"a": np.arange(100, dtype=np.int64), "b": np.ones(100)}
    store.write_bucket(0, cols, 100)
    assert list(store.read_bucket(0)) == ["a", "b"]
    nbytes = sum(v.nbytes for v in cols.values())
    assert telemetry.total("spill.write_bytes") == nbytes
    assert telemetry.total("spill.read_bytes") == nbytes
    assert telemetry.metric("spill.write_seconds").count == 1
    assert telemetry.metric("spill.read_seconds").count == 1
    assert telemetry.total("spill.write_buckets") == 1


def test_torch_ooc_chunks_counted():
    from cylon_tpu_torch.outofcore import _as_chunks, host_partition_chunks

    parts = host_partition_chunks(
        _as_chunks({"k": np.arange(64, dtype=np.int64)}, 16), ["k"], 4)
    assert len(parts) == 4
    assert telemetry.total("ooc.chunks") == 4


def test_torch_clear_timings_scoped_to_watchdog_namespace():
    from cylon_tpu_torch import watchdog

    telemetry.counter("exchange.bytes_true", op="x").inc(64)
    with watchdog.deadline(5.0):
        watchdog.bounded(lambda: 1, "overflow_fetch")
    assert watchdog.straggler_report()
    watchdog.clear_timings()
    assert watchdog.straggler_report() == {}
    assert watchdog.timings() == []
    assert telemetry.total("exchange.bytes_true") == 64
