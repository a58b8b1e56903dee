"""The port's OOM→spill fallback (``cylon_tpu_torch.fallback``), its
TPC-H plans (``tpch.manifest.FALLBACK``, ``tpch.twophase``) and the
streaming Q1/Q5 (``tpch.streaming``), against the in-core eager result,
pandas and the JAX package, on CPU tables.

The spill route of each TPC-H query is held against the port's in-core
eager result of the same data and against ``test_tpch``'s pandas oracle
(through ``test_torch_tpch.case``). Frames are compared column by column
with ``pd.api.types.is_float_dtype`` deciding which columns get a
tolerance: ``np.issubdtype`` cannot read pandas' ``StringDtype``.
"""

import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu_torch as ct
from cylon_tpu_torch import fallback, resilience, telemetry, tpch
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.resilience import FaultPlan, FaultRule
from cylon_tpu_torch.telemetry import memory
from cylon_tpu_torch.tpch import streaming
from test_torch_tpch import case
from test_tpch import SEED, SF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    resilience.install(None)


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF, SEED)


@pytest.fixture(scope="module")
def pdfs():
    return tpch.generate_pandas(SF, SEED)


@pytest.fixture(scope="module")
def env():
    return ct.CylonEnv(device="cpu")


def _assert_matches(got, want):
    if isinstance(want, float):
        assert np.isclose(float(got), want, rtol=1e-9)
        return
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if pd.api.types.is_float_dtype(want[c].dtype):
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64),
                                       rtol=1e-9)
        else:
            assert list(got[c]) == list(want[c]), c


def _sorted_all(df):
    return df.sort_values(list(df.columns), kind="stable",
                          ignore_index=True)


def _mk_inputs(n=4000):
    rng = np.random.default_rng(11)
    return ({"k": rng.integers(0, n, n).astype(np.int64),
             "a": rng.normal(size=n)},
            {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.normal(size=n)})


def _oom_plan(msg="injected device OOM"):
    return FaultPlan([FaultRule("plan", nth=1, error=MemoryError(msg))])


# ------------------------------------------------------ routing core
def test_preflight_routes_to_spill_without_attempting():
    def attempt():
        raise AssertionError("pre-flight must not dispatch in-core")

    c = telemetry.counter("ooc.fallbacks", op="probe", reason="preflight")
    before = c.value
    assert fallback.run_with_fallback(attempt, lambda: 42, op="probe",
                                      predicted_bytes=1000,
                                      budget_bytes=100) == 42
    assert c.value == before + 1


def test_fitting_query_runs_in_core():
    assert fallback.run_with_fallback(
        lambda: "in_core", lambda: pytest.fail("must not spill"),
        op="probe2", predicted_bytes=10, budget_bytes=1000) == "in_core"


def test_injected_oom_retries_once_through_spill():
    c = telemetry.counter("ooc.fallbacks", op="probe3", reason="oom")
    before = c.value
    with resilience.active(_oom_plan()):
        assert fallback.run_with_fallback(lambda: "in_core",
                                          lambda: "spilled",
                                          op="probe3") == "spilled"
    assert c.value == before + 1


def test_non_oom_error_propagates_without_fallback():
    before = telemetry.total("ooc.fallbacks")

    def attempt():
        raise ValueError("a query bug, not an OOM")

    with pytest.raises(ValueError, match="query bug"):
        fallback.run_with_fallback(attempt,
                                   lambda: pytest.fail("must not spill"),
                                   op="p4")
    assert telemetry.total("ooc.fallbacks") == before


def test_cuda_oom_error_type_is_recognised():
    """A real CUDA allocation failure (``torch.cuda.OutOfMemoryError``)
    takes the OOM route, like the injected ``MemoryError``."""
    def attempt():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 9.00 GiB")

    assert fallback.run_with_fallback(attempt, lambda: "spilled",
                                      op="p_cuda") == "spilled"
    assert telemetry.counter("ooc.fallbacks", op="p_cuda",
                             reason="oom").value >= 1


def test_oom_retry_drops_the_failed_attempts_tensors():
    """Before the spill retry runs, the failed attempt's tables are gone:
    its frames, held by the exception's traceback, lose their locals."""
    alive = {}

    def attempt():
        big = torch.zeros(1 << 16)
        alive["ref"] = weakref.ref(big)
        raise MemoryError("allocation failed")

    def spill():
        gc.collect()
        return alive["ref"]() is None

    assert fallback.run_with_fallback(attempt, spill, op="p_free") is True


def test_fallback_failure_chains_the_original_oom():
    def spill():
        raise RuntimeError("spill path broke too")

    with resilience.active(_oom_plan("oom")):
        with pytest.raises(RuntimeError, match="spill path") as ei:
            fallback.run_with_fallback(lambda: 1, spill, op="p5")
    assert isinstance(ei.value.__cause__, MemoryError)


def test_free_hbm_budget_knob(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_HBM_BUDGET_BYTES", "123456789")
    free = fallback.free_hbm_bytes()
    assert free is not None and 0 <= free <= 123456789
    assert fallback.hbm_limit_bytes() == 123456789
    monkeypatch.setenv("CYLON_TPU_HBM_BUDGET_BYTES", "junk")
    want = None if not torch.cuda.is_available() else \
        fallback._card_mem_info()[1]
    assert fallback.hbm_limit_bytes() == want
    monkeypatch.delenv("CYLON_TPU_HBM_BUDGET_BYTES")
    if not torch.cuda.is_available():
        # no card: no allocator limits, pre-flight stands down
        assert fallback.free_hbm_bytes() is None


def test_free_bytes_count_the_allocators_cache_as_free(monkeypatch):
    """The pre-flight adds what the caching allocator holds reserved but
    unallocated to the driver's free bytes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (10 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 6 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 2 << 30)
    assert fallback.free_hbm_bytes() == 14 << 30
    assert fallback.hbm_limit_bytes() == 80 << 30


def test_knobs_are_the_jax_defaults():
    import cylon_tpu.fallback as jfb

    assert fallback.expansion_factor() == jfb.expansion_factor()
    assert fallback.default_partitions() == jfb.default_partitions()


def test_oom_report_attached_to_exception():
    with pytest.raises(MemoryError) as ei:
        with memory.forensics("fallback_test"):
            raise MemoryError("Unable to allocate 99 GiB")
    assert isinstance(ei.value.oom_report, dict)
    assert "resident-memory forensics" in str(ei.value)


def test_predict_query_bytes_reads_tables_without_a_sync(data):
    frames = tpch.ingest({"nation": data["nation"]}, device="cpu")
    raw = fallback.predict_query_bytes({"nation": data["nation"]})
    dev = fallback.predict_query_bytes(frames)
    assert raw > 0 and dev > 0
    t = frames["nation"].table
    want = sum(c.data.numel() * c.data.element_size()
               + (0 if c.validity is None else
                  c.validity.numel() * c.validity.element_size())
               for c in t.columns.values())
    assert dev == int(want * fallback.expansion_factor())


# --------------------------------------------------- plain relational
def test_plain_join_spill_matches_incore_and_jax():
    import cylon_tpu.fallback as jfb

    left, right = _mk_inputs()
    want = fallback.join(left, right, on="k", device="cpu")
    c = telemetry.counter("ooc.fallbacks", op="join", reason="preflight")
    before = c.value
    got = fallback.join(left, right, on="k", n_partitions=4,
                        budget_bytes=0, device="cpu")
    assert c.value == before + 1
    pd.testing.assert_frame_equal(_sorted_all(got), _sorted_all(want),
                                  check_dtype=False)
    jwant = jfb.join(left, right, on="k", n_partitions=4, budget_bytes=0)
    pd.testing.assert_frame_equal(_sorted_all(got), _sorted_all(jwant),
                                  check_dtype=False)


def test_plain_groupby_spill_matches_incore():
    rng = np.random.default_rng(5)
    src = {"g": rng.integers(0, 50, 3000).astype(np.int64),
           "v": rng.normal(size=3000)}
    aggs = [("v", "sum", "s"), ("v", "count", "c")]
    want = fallback.groupby(src, ["g"], aggs, device="cpu")
    got = fallback.groupby(src, ["g"], aggs, chunk_rows=500,
                           budget_bytes=0, device="cpu")
    pd.testing.assert_frame_equal(_sorted_all(got), _sorted_all(want),
                                  check_dtype=False, check_exact=False,
                                  rtol=1e-9)


def test_plain_sort_spill_matches_incore():
    rng = np.random.default_rng(6)
    src = {"k": rng.integers(0, 200, 3000).astype(np.int64),
           "v": rng.normal(size=3000)}
    want = fallback.sort(src, ["k", "v"], device="cpu")
    got = fallback.sort(src, ["k", "v"], n_partitions=4, chunk_rows=700,
                        budget_bytes=0, device="cpu")
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_plain_join_injected_oom_degrades():
    left, right = _mk_inputs(2000)
    want = fallback.join(left, right, on="k", device="cpu")
    with resilience.active(_oom_plan()):
        got = fallback.join(left, right, on="k", n_partitions=4,
                            device="cpu")
    pd.testing.assert_frame_equal(_sorted_all(got), _sorted_all(want),
                                  check_dtype=False)


def test_plain_ops_take_host_mappings_only():
    with pytest.raises(InvalidArgument, match="host column Mappings"):
        fallback.join([1], {"k": np.arange(3)}, on="k", device="cpu")


# ------------------------------------------------- TPC-H decomposition
def test_fallback_manifest_matches_jax_and_keeps_partition_keys():
    from cylon_tpu.tpch.manifest import FALLBACK as JFALLBACK
    from cylon_tpu_torch.tpch.manifest import FALLBACK, MANIFEST

    assert FALLBACK == JFALLBACK
    assert set(FALLBACK) == {f"q{i}" for i in range(1, 23)}
    for q, spec in FALLBACK.items():
        for table, key in spec["partition"].items():
            assert table in MANIFEST[q], (q, table)
            assert key is None or key in MANIFEST[q][table], (q, key)


#: one query per merge kind (groupby with weighted means, concat top-k,
#: groupby, scalar sum, indicator sums, concat over a HAVING) and the six
#: two-phase plans
SPILL_QUERIES = ("q1", "q3", "q5", "q6", "q12", "q18",
                 "q8", "q11", "q14", "q15", "q16", "q22")


@pytest.mark.parametrize("qn", SPILL_QUERIES)
def test_tpch_fallback_matches_incore_and_pandas(qn, data, pdfs, env):
    kw, data2, want, check = case(qn, pdfs, data)
    inputs = data if data2 is None else data2
    incore = fallback._materialize(getattr(tpch, qn)(inputs, env=env,
                                                     **kw))
    merges = telemetry.counter("ooc.merge_phases", op=qn).value
    got = fallback.tpch_fallback(qn, inputs, env=env, n_partitions=3,
                                 compiled=False, **kw)
    _assert_matches(got, incore)
    check(got, want)
    from cylon_tpu_torch.tpch.manifest import FALLBACK

    if FALLBACK[qn]["merge"] == "twophase":
        assert telemetry.counter("ooc.merge_phases", op=qn).value == \
            merges + 1


def test_tpch_fallback_counts_partitions(data, env):
    before = telemetry.total("ooc.fallback_partitions")
    fallback.tpch_fallback("q6", data, env=env, n_partitions=3,
                           compiled=False)
    assert telemetry.total("ooc.fallback_partitions") == before + 3


def test_unknown_query_fails_fast_with_known_list(data, env):
    assert all(fallback.supports(f"q{i}") for i in range(1, 23))
    assert not fallback.supports("q99")
    with pytest.raises(InvalidArgument, match=r"known queries.*q1,"):
        fallback.tpch_fallback("q99", data, env=env)
    with pytest.raises(InvalidArgument, match=r"'q99'"):
        fallback.run_query("q99", data, env=env, compiled=False)
    with pytest.raises(InvalidArgument, match="n_partitions"):
        fallback.tpch_fallback("q6", data, env=env, n_partitions=0)


def test_run_query_oom_on_two_phase_query_degrades(data, env):
    want = fallback._materialize(tpch.q14(data, env=env))
    mp = telemetry.counter("ooc.merge_phases", op="q14").value
    oom = telemetry.counter("ooc.fallbacks", op="q14", reason="oom")
    before = oom.value
    with resilience.active(_oom_plan()):
        got = fallback.run_query("q14", data, env=env, n_partitions=3,
                                 compiled=False)
    assert oom.value == before + 1
    assert telemetry.counter("ooc.merge_phases", op="q14").value == mp + 1
    _assert_matches(got, want)


@pytest.mark.parametrize("compiled", [False, True])
def test_run_query_injected_oom_on_q3_completes_via_fallback(data, env,
                                                            compiled):
    """The in-core attempt (eager or through ``CompiledQuery``, whose
    dispatch is the ``plan`` point too) dies of an injected OOM and the
    query completes through the spill path with the in-core answer."""
    want = fallback._materialize(tpch.q3(data, env=env))
    oom = telemetry.counter("ooc.fallbacks", op="q3", reason="oom")
    before = oom.value
    with resilience.active(_oom_plan("RESOURCE_EXHAUSTED: injected")):
        got = fallback.run_query("q3", data, env=env, n_partitions=3,
                                 compiled=compiled)
    assert oom.value == before + 1
    _assert_matches(got, want)


def test_run_query_preflight_tiny_budget_spills(data, env, monkeypatch):
    monkeypatch.setenv("CYLON_TPU_HBM_BUDGET_BYTES", "4096")
    c = telemetry.counter("ooc.fallbacks", op="q6", reason="preflight")
    before = c.value
    got = fallback.run_query("q6", data, env=env, n_partitions=3,
                             compiled=False)
    assert c.value == before + 1
    _assert_matches(got, fallback._materialize(tpch.q6(data, env=env)))


def test_run_query_in_core_when_it_fits(data, env):
    before = telemetry.total("ooc.fallbacks")
    got = fallback.run_query("q5", data, env=env, budget_bytes=1 << 40)
    assert telemetry.total("ooc.fallbacks") == before
    _assert_matches(got, fallback._materialize(tpch.q5(data, env=env)))


def test_merge_sum_tolerates_empty_partitions():
    assert fallback._merge_partials([None, 1.5, None, 2.5],
                                    {"merge": "sum"}, None) == 4.0


def test_resume_discards_checkpoint_when_broadcast_changes(tmp_path, env):
    small = tpch.generate(0.002, 0)
    kw = dict(env=env, n_partitions=2, compiled=False,
              resume_dir=str(tmp_path))
    first = fallback.tpch_fallback("q3", small, **kw)
    data2 = dict(small)
    data2["customer"] = {k: np.asarray(v)[: len(v) // 2]
                         for k, v in small["customer"].items()}
    resumed = telemetry.total("ooc.units_resumed")
    second = fallback.tpch_fallback("q3", data2, **kw)
    assert telemetry.total("ooc.units_resumed") == resumed
    _assert_matches(second, fallback._materialize(tpch.q3(data2, env=env)))
    assert not second.equals(first)


def test_resume_replays_partitions_and_keeps_empty_schema(tmp_path, env):
    small = tpch.generate(0.002, 0)
    kw = dict(env=env, n_partitions=2, compiled=False)
    first = fallback.tpch_fallback("q3", small, resume_dir=str(tmp_path /
                                                               "a"), **kw)
    before = telemetry.total("ooc.units_resumed")
    second = fallback.tpch_fallback("q3", small, resume_dir=str(tmp_path /
                                                                "a"), **kw)
    assert telemetry.total("ooc.units_resumed") == before + 2
    pd.testing.assert_frame_equal(second, first)
    empty = fallback.tpch_fallback("q3", small, segment="NO-SUCH-SEGMENT",
                                   resume_dir=str(tmp_path / "b"), **kw)
    assert len(empty) == 0 and list(empty.columns) == [
        "l_orderkey", "revenue", "o_orderdate", "o_shippriority"]
    again = fallback.tpch_fallback("q3", small, segment="NO-SUCH-SEGMENT",
                                   resume_dir=str(tmp_path / "b"), **kw)
    pd.testing.assert_frame_equal(again, empty)


_TWO_PHASE_KILL = r"""
import sys
sys.path.insert(0, {root!r})
import cylon_tpu_torch as ct
from cylon_tpu_torch import fallback, resilience, tpch
data = tpch.generate(0.002, 3)
plan = resilience.FaultPlan([resilience.FaultRule.kill("global_merge")])
with resilience.active(plan):
    fallback.tpch_fallback("q15", data, env=ct.CylonEnv(device="cpu"),
                           n_partitions=3, compiled=False,
                           resume_dir={rdir!r})
"""


def test_two_phase_kill_at_the_merge_resumes_identical(tmp_path, data,
                                                       env):
    """A child killed at q15's global merge leaves the phase-1 partials
    durable; the resumed run replays them (no recompute) and returns the
    fault-free frame."""
    want = fallback.tpch_fallback("q15", data, env=env, n_partitions=3,
                                  compiled=False)
    rdir = str(tmp_path / "r")
    res = subprocess.run(
        [sys.executable, "-c", _TWO_PHASE_KILL.format(root=ROOT,
                                                      rdir=rdir)],
        capture_output=True, text=True, timeout=180)
    assert res.returncode == resilience.KILL_EXIT_CODE, res.stderr[-2000:]
    c = telemetry.counter("ooc.units_resumed", op="fallback_q15")
    before = c.value
    got = fallback.tpch_fallback("q15", data, env=env, n_partitions=3,
                                 compiled=False, resume_dir=rdir)
    assert c.value - before >= 1
    pd.testing.assert_frame_equal(got, want)


# ------------------------------------------------ streaming Q1 and Q5
def test_tpch_q1_q5_streaming_match_incore_and_jax(data, env):
    from cylon_tpu import tpch as jtpch

    want1 = tpch.q1(data, env=env).to_pandas().reset_index(drop=True)
    got1 = streaming.q1_ooc(data, chunk_rows=3000, device="cpu") \
        .to_pandas().reset_index(drop=True)
    _assert_matches(got1[want1.columns], want1)
    _assert_matches(got1[want1.columns],
                    jtpch.q1(data).to_pandas().reset_index(drop=True))
    want5 = tpch.q5(data, env=env).to_pandas().reset_index(drop=True)
    got5 = streaming.q5_ooc(data, chunk_rows=3000, device="cpu") \
        .to_pandas().reset_index(drop=True)
    _assert_matches(got5[want5.columns], want5)
    _assert_matches(got5[want5.columns],
                    jtpch.q5(data).to_pandas().reset_index(drop=True))


def test_streaming_q1_ooc_resumes(tmp_path, data, env):
    want = tpch.q1(data, env=env).to_pandas().reset_index(drop=True)
    rdir = str(tmp_path / "q1")
    with resilience.active(FaultPlan([FaultRule("chunk_source", nth=3,
                                                times=0)])):
        with pytest.raises(ct.errors.TransientError):
            streaming.q1_ooc(data, chunk_rows=3000, resume_dir=rdir,
                             device="cpu")
    got = streaming.q1_ooc(data, chunk_rows=3000, resume_dir=rdir,
                           device="cpu").to_pandas().reset_index(drop=True)
    _assert_matches(got[want.columns], want)


# ----------------------------------------------------------- two-phase
def test_two_phase_plans_cover_the_six_queries():
    from cylon_tpu.tpch.twophase import PLANS as JPLANS
    from cylon_tpu_torch.tpch.twophase import PLANS

    assert set(PLANS) == set(JPLANS) == {"q8", "q11", "q14", "q15", "q16",
                                         "q22"}
    for q in PLANS:
        assert (PLANS[q].phase2 is None) == (JPLANS[q].phase2 is None), q


TWO_PHASE = ("q8", "q11", "q14", "q15", "q16", "q22")


def _split(qn, inputs, n_partitions):
    """The host partitions ``tpch_fallback`` builds for ``qn``: each
    partition's input mapping of host columns (broadcast tables whole)."""
    from cylon_tpu_torch.outofcore import host_partition_chunks
    from cylon_tpu_torch.tpch.manifest import FALLBACK, MANIFEST

    parts = [{} for _ in range(n_partitions)]
    for tname, keep in MANIFEST[qn].items():
        cols = fallback._host_cols(inputs[tname], tname, keep)
        key = FALLBACK[qn]["partition"].get(tname, "__broadcast__")
        if key == "__broadcast__":
            split = [cols] * n_partitions
        elif key is None:
            split = fallback._partition_rows(cols, n_partitions)
        else:
            split = host_partition_chunks([cols], [key], n_partitions)
        for p in range(n_partitions):
            parts[p][tname] = split[p]
    return parts


def _assert_same_rows(got, want):
    """Two partial frames hold the same rows (order aside): keys exact,
    floats at rtol 1e-9."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    keys = [c for c in want.columns
            if not pd.api.types.is_float_dtype(want[c].dtype)]
    if keys:
        got = got.sort_values(keys, kind="stable", ignore_index=True)
        want = want.sort_values(keys, kind="stable", ignore_index=True)
    _assert_matches(got.reset_index(drop=True),
                    want.reset_index(drop=True))


@pytest.mark.parametrize("qn", TWO_PHASE)
def test_two_phase_partials_match_the_jax_plans(qn, data, pdfs):
    """Per partition, the port's phases on the device give the JAX
    plan's host partials, and the merges agree."""
    from cylon_tpu.tpch.twophase import PLANS as JPLANS
    from cylon_tpu_torch.tpch.twophase import PLANS

    kw, data2, _, _ = case(qn, pdfs, data)
    parts = _split(qn, data if data2 is None else data2, 3)
    ours = [PLANS[qn].phase1(t, device="cpu", **kw) for t in parts]
    theirs = [JPLANS[qn].phase1(t, **kw) for t in parts]
    for got, want in zip(ours, theirs):
        _assert_same_rows(got, want)
    merged, jmerged = PLANS[qn].merge(ours, **kw), JPLANS[qn].merge(
        theirs, **kw)
    _assert_same_rows(merged, jmerged)
    if PLANS[qn].phase2 is None:
        return
    # each side applies its own merge: q15's = MAX threshold compares
    # the partition's sums against the max of the same sums
    for t, p1, jp1 in zip(parts, ours, theirs):
        got = PLANS[qn].phase2(t, p1, merged, device="cpu", **kw)
        want = JPLANS[qn].phase2(t, jp1, jmerged, **kw)
        _assert_same_rows(got, want)


@pytest.mark.parametrize("qn", TWO_PHASE)
def test_two_phase_runs_no_pandas_join(qn, data, pdfs, env, monkeypatch):
    """The two-phase spill path joins on the env's device: with pandas'
    joins made to fail, each query still gives its in-core answer."""
    kw, data2, _, _ = case(qn, pdfs, data)
    inputs = data if data2 is None else data2
    want = fallback._materialize(getattr(tpch, qn)(inputs, env=env, **kw))

    def no_join(*_a, **_k):
        raise AssertionError("a pandas join on the spill path")

    monkeypatch.setattr(pd, "merge", no_join)
    monkeypatch.setattr(pd.DataFrame, "merge", no_join)
    monkeypatch.setattr(pd.DataFrame, "join", no_join)
    got = fallback.tpch_fallback(qn, inputs, env=env, n_partitions=3,
                                 compiled=False, **kw)
    _assert_matches(got, want)
