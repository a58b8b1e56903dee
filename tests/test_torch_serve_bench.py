"""The port's serving harness (``cylon_tpu_torch.serve.bench``) on CPU
tables: its record schemas equal the JAX package's, ``_results_match``
holds string and nullable columns (where the JAX package's raises on
pandas' string dtype), and every leg — the replay, the hot mix, the
refresh rounds, the fleet with its mid-run SIGKILL and the fleet trace —
runs at SF 0.002 and passes its record's gates. The refresh leg's
``speedup >= 2`` gate needs tables large enough that a refresh's delta
is small beside a recompute: it runs at SF 0.02, where the from-scratch
recompute partitions."""

import contextlib
import json

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import catalog, telemetry, views
from cylon_tpu_torch.serve import bench

SF = 0.002


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    views.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")
    yield
    catalog.clear()
    views.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")


@pytest.mark.parametrize("name", [
    "REQUIRED_SERVE_FIELDS", "REQUIRED_HOTMIX_FIELDS",
    "REQUIRED_FLEET_FIELDS", "REQUIRED_FLEET_TRACE_FIELDS",
    "REQUIRED_REFRESH_FIELDS", "DEFAULT_MIX", "REFRESH_MIX"])
def test_record_schemas_and_mixes_equal_the_jax_package(name):
    from cylon_tpu.serve import bench as jbench
    from cylon_tpu.serve import fleet as jfleet

    from cylon_tpu_torch.serve import fleet

    assert getattr(bench, name) == getattr(jbench, name)
    assert fleet.REQUIRED_FLEET_TRACE_FIELDS == \
        jbench.REQUIRED_FLEET_TRACE_FIELDS
    assert fleet.DEFAULT_MIX == jfleet.DEFAULT_MIX
    assert fleet.QUERY_READ_SETS == jfleet.QUERY_READ_SETS


# ------------------------------------------------------ _results_match
def _frame(strings, nullable):
    return pd.DataFrame({
        "k": pd.Series(strings, dtype=nullable),
        "n": pd.array([1, None, 3], dtype="Int64"),
        "v": np.asarray([0.5, 1.5, 2.5])})


@pytest.mark.parametrize("dtype", ["string", object],
                         ids=["string_dtype", "object"])
def test_results_match_string_and_nullable_columns(dtype):
    want = _frame(["a", None, "c"], dtype)
    # rows in another order, floats within 1e-9, the string column in
    # the other storage: equal
    got = want.iloc[::-1].reset_index(drop=True)
    got["v"] = got["v"] * (1 + 1e-12)
    got["k"] = got["k"].astype(object if dtype == "string" else "string")
    assert bench._results_match(got, want)
    assert bench._results_match(want, want)
    # a changed string, a missing value turned into a value, a float out
    # of tolerance: each differs
    for col, i, val in (("k", 0, "z"), ("k", 1, "b"), ("n", 1, 2),
                        ("v", 2, 2.6)):
        bad = want.copy()
        bad.loc[i, col] = val
        assert not bench._results_match(bad, want), (col, i, val)
    assert not bench._results_match(want[["k", "v"]], want)


def test_results_match_scalars_and_arrays():
    assert bench._results_match(1.0 + 1e-12, 1.0)
    assert not bench._results_match(1.1, 1.0)
    assert bench._results_match(np.asarray([1.0, 2.0]),
                                np.asarray([1.0, 2.0]))


def test_mk_resident_one_shard_a_rank():
    """At W > 1 every rank holds a shard, and the shards' rows add up to
    the table's."""
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.context import CylonEnv
    from cylon_tpu_torch.parallel.comm import ThreadWorld

    data = tpch.generate(0.001, 0, keep=bench._mix_keep(("q6",)))
    want = len(data["lineitem"]["l_quantity"])

    def rank(comm):
        res = bench._mk_resident(CylonEnv(comm, device="cpu"), data)
        assert set(res) == {"lineitem"}
        return res["lineitem"].table.num_rows

    rows = ThreadWorld(2).run(rank)
    assert sum(rows) == want and all(r > 0 for r in rows)


# ------------------------------------------------------ the legs
class Entered:
    """A ``reference=`` factory that counts the blocks it was entered
    for: the oracles a leg computes apart from its served path."""

    def __init__(self):
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        self.n += 1
        yield


def test_run_bench_record_and_gates():
    ref = Entered()
    rec = bench.run_bench(clients=4, requests=2, sf=SF, device="cpu",
                          reference=ref)
    assert ref.n == 1  # the mix's oracles, once
    assert not bench.REQUIRED_SERVE_FIELDS - rec.keys()
    assert rec["oracle_mismatches"] == 0 and rec["errors"] == 0
    assert rec["completed"] == 8 and rec["rejected"] == 0
    assert rec["cache_hit_rate"] > 0 and rec["p99_s"] is not None
    assert rec["slowest_profile"]["state"] == "done"
    assert rec["device"] == "cpu"
    json.dumps(rec)  # the record is JSON


def test_run_hotmix_bench_record_and_gates():
    ref = Entered()
    rec = bench.run_hotmix_bench(clients=8, requests=4, sf=SF,
                                 device="cpu", reference=ref)
    assert ref.n == 1
    assert not bench.REQUIRED_HOTMIX_FIELDS - rec.keys()
    assert rec["oracle_mismatches"] == 0 and rec["errors"] == 0
    assert rec["stale_results"] == 0
    assert rec["qps_multiplier"] >= 10.0, rec
    # the same run, its checks inside the window as the JAX package
    # times them, and the hot phase's repeats
    assert rec["qps_multiplier_checks_in_window"] > 0
    assert rec["hot_qps_checks_in_window"] > 0
    assert len(rec["hot_qps_repeats"]) == bench.HOT_REPEATS
    assert rec["hot_qps_repeats"][0] == rec["hot_qps"]
    assert rec["completed"] == 32 and rec["cache_hit_rate"] > 0.5
    json.dumps(rec)


def test_run_refresh_bench_record_and_gates():
    ref = Entered()
    rec = bench.run_refresh_bench(sf=SF, rounds=2, device="cpu",
                                  reference=ref)
    # one recompute a view and pinned generations, each in its block
    assert ref.n >= rec["refreshes"]
    assert not bench.REQUIRED_REFRESH_FIELDS - rec.keys()
    assert rec["oracle_mismatches"] == 0 and rec["errors"] == 0
    assert rec["refreshes"] == 8 and rec["reads_total"] > 0
    assert rec["delta_rows_total"] > 0 and rec["speedup"] > 0
    json.dumps(rec, default=str)


def test_run_refresh_bench_speedup_gate():
    rec = bench.run_refresh_bench(sf=0.02, rounds=2, device="cpu")
    assert rec["oracle_mismatches"] == 0 and rec["errors"] == 0
    assert rec["speedup"] >= 2.0, rec["per_view"]


@pytest.mark.parametrize("fleet_trace", [False, True],
                         ids=["fleet", "fleet_trace"])
def test_run_fleet_bench_record_and_gates(tmp_path, monkeypatch,
                                          fleet_trace):
    """Two ``--device cpu`` engine processes, one SIGKILLed mid-run:
    every gate of ``serve.bench --fleet`` (and ``--fleet-trace``)."""
    from cylon_tpu_torch.serve import fleet
    from cylon_tpu_torch.telemetry import trace

    monkeypatch.setattr(trace, "_RECORDER", None)
    monkeypatch.delenv("CYLON_TPU_TRACE", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the engine children's
    if fleet_trace:
        monkeypatch.setenv("CYLON_TPU_TRACE", "1")
    rec = fleet.run_fleet_bench(
        clients=4, requests=3, sf=SF, device="cpu",
        root=str(tmp_path / "fleet"), fleet_trace=fleet_trace,
        result_timeout=120)
    assert not bench.REQUIRED_FLEET_FIELDS - rec.keys()
    assert rec["failovers"] >= 1 and rec["lost_acks"] == 0
    assert rec["replayed"] >= 1  # the victim died owing a request
    assert rec["double_executions"] == 0, rec["double_execution_detail"]
    assert rec["oracle_mismatches"] == 0 and rec["errors"] == 0
    assert rec["completed"] == 12 and rec["retry_deduped"] is True
    assert rec["detect_s"] is not None and rec["detect_s"] >= 0
    assert len(rec["oracle_digests"]) == len(bench.DEFAULT_MIX)
    assert set(rec["engine_setup_s"]["e0"]) == {"generate", "ingest",
                                               "snapshot", "digests"}
    survivor = ({"e0", "e1"} - {rec["victim"]}).pop()
    assert rec["engine_launches"][rec["victim"]] is None  # killed
    assert rec["engine_launches"][survivor] is not None   # closed cleanly
    if fleet_trace:
        assert not bench.REQUIRED_FLEET_TRACE_FIELDS - rec.keys()
        assert rec["engines_stitched"] >= 1 and rec["spans"] > 0
        assert rec["replay_hops"] >= 1
        assert rec["stitched_request"]["replay_hops"]
        assert rec["cost_model"]["history_files"] >= 1
    json.dumps(rec, default=str)


def test_main_emits_the_record_and_exits_zero(capsys):
    rc = bench.main(["--clients", "2", "--requests", "1", "--sf", "0.001",
                     "--mix", "q6", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rc == 0 and rec["metric"] == "serve_bench_tpch_mix"
    assert not bench.REQUIRED_SERVE_FIELDS - rec.keys()
    assert "metrics" in rec


def test_fault_storm_drives_health_unhealthy_and_back(monkeypatch):
    """The ``--storm`` leg (``_fault_storm``) on an engine with short
    windows: one tenant's deadline storm turns ``/health`` unhealthy,
    read over HTTP, the events replay in order, and good traffic brings
    it back to ok."""
    from cylon_tpu_torch.serve import ServeEngine, ServePolicy
    from cylon_tpu_torch.telemetry import events

    monkeypatch.setenv("CYLON_TPU_EVENTS", "1")
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    monkeypatch.setattr(events, "_JOURNAL", None)
    eng = ServeEngine(policy=ServePolicy(
        max_queue=8, breaker_fails=3, breaker_window=30.0,
        breaker_cooldown=0.4, slo_target=0.9, slo_windows=(1.5, 3.0),
        burn_critical=5.0))
    try:
        storm = bench._fault_storm(eng, eng.http_address, requests=5,
                                   tenant="noisy")
    finally:
        eng.close()
    assert storm["health_transitions"][0] == "ok"
    assert "unhealthy" in storm["health_transitions"]
    assert storm["recovered"] and storm["health_transitions"][-1] == "ok"
    assert any("breaker" in r for r in storm["unhealthy_reasons"])
    assert storm["events_in_order"] and storm["breaker_trips"] >= 1
    assert {"breaker_open", "shed"} <= set(storm["event_kinds"])
