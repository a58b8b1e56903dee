"""The port's EXPLAIN plans and ANALYZE profiles
(``cylon_tpu_torch.telemetry.profile``) against the JAX package's, case
for case from ``tests/test_profile.py``: the profile's key set is
``REQUIRED_PROFILE_FIELDS`` exactly, ``explain``'s key set is the JAX
package's with the same rows and buckets for the same tables, the cache
state turns from "miss" to "hit" exactly when ``plan.cache_hits`` moves,
``ProfileHistory`` files load in either package with the same
``predict()``, and a W = 4 ``dist_join`` on ``ThreadWorld`` inside one
request (64K rows a rank) is attributed to that request."""

import json
import threading
import time

import numpy as np
import pytest

from cylon_tpu_torch import Table, catalog, telemetry
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.serve import ServeEngine, ServePolicy
from cylon_tpu_torch.telemetry import profile as prof_mod
from cylon_tpu_torch.telemetry.profile import (REQUIRED_PROFILE_FIELDS,
                                               explain, explain_text,
                                               profile_text)

WAIT = 30


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    yield
    catalog.clear()
    telemetry.reset("serve.")


def _cols(n):
    return {"k": (np.arange(n, dtype=np.int64) % 4),
            "v": np.ones(n, dtype=np.float64)}


def _t(n=64):
    return Table.from_pydict(_cols(n), device="cpu")


def _q(t):
    from cylon_tpu_torch.ops.groupby import groupby_aggregate

    return groupby_aggregate(t, ["k"], [("v", "sum", "s")])


# ----------------------------------------------------------- EXPLAIN
def test_explain_eager_callable_lists_ops_and_inputs():
    from cylon_tpu_torch.ops.groupby import groupby_aggregate

    def q(t):
        return groupby_aggregate(t, ["k"], [("v", "sum", "s")])

    p = explain(q, _t(64))
    assert p["query"] == "q" and p["compiled"] is False
    assert "groupby_aggregate" in p["ops"]
    assert p["ops_source"] == "static_scan"
    (inp,) = p["inputs"]
    assert inp["rows"] == 64 and inp["bucket"] == 64
    assert inp["capacity"] == 64 and not inp["distributed"]
    assert inp["bytes"] == 64 * 8 * 2
    assert p["cache_state"] == "untracked" and p["row_hint"] is None
    assert p["join_routing"] is None
    text = explain_text(p)
    assert "groupby_aggregate" in text and "rows=64" in text


def test_explain_matches_jax_keys_rows_and_buckets():
    """Same tables, both packages: the same key set, and each input's
    rows and bucket, bytes and columns; a join names its routing (the
    port routes ``algorithm="hash"`` to the sort join)."""
    import cylon_tpu as jct
    from cylon_tpu.telemetry import profile as jprof

    def q(a, b):
        return a.join(b, on="k")

    sizes = (37, 200)
    got = explain(q, *[_t(n) for n in sizes])
    want = jprof.explain(q, *[jct.Table.from_pydict(_cols(n))
                              for n in sizes])
    assert set(got) == set(want)
    for g, w in zip(got["inputs"], want["inputs"]):
        assert set(g) == set(w)
        for k in ("rows", "bucket", "bytes", "columns", "distributed"):
            assert g[k] == w[k], k
    assert got["ops"] == want["ops"] == ["join"]
    assert got["join_routing"]["hash_impl"] == "sort"
    assert set(got["join_routing"]) == set(want["join_routing"])
    assert "join: hash->sort" in explain_text(got)


def test_explain_reads_the_catalogs_shard_record():
    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        catalog.put_table("s", _t(16), env=env)
        return explain(_q, catalog.get_table("s", env=env))["inputs"][0]

    assert all(r["distributed"] and r["rows"] == 16
               for r in ThreadWorld(2).run(rank))
    catalog.put_table("local", _t(16))
    assert not explain(_q, catalog.get_table("local"))["inputs"][0][
        "distributed"]


def test_explain_of_an_overflowed_table_reports_no_rows():
    t = _t(8)
    t.nrows.fill_(9)                        # the overflow mark
    p = explain(_q, t)
    assert p["inputs"][0]["rows"] is None and p["inputs"][0]["bucket"] \
        is None


def test_explain_compiled_reports_cache_state_transition():
    from cylon_tpu_torch import plan

    def q_explain(t):
        return _q(t)

    cq = plan.compile_query(q_explain)
    before = explain(cq, _t(64))
    assert before["compiled"] is True
    assert before["cache_state"] == "miss" and before["scale"] == 1
    cq(_t(64))
    assert explain(cq, _t(64))["cache_state"] == "hit"
    assert explain(cq, _t(256))["cache_state"] == "miss"
    hits = telemetry.total("plan.cache_hits")
    explain(cq, _t(64))
    assert telemetry.total("plan.cache_hits") == hits


def test_cache_state_agrees_with_the_counter_the_call_moves():
    """For every call, ``explain`` just before it says "hit" exactly when
    the call then counts ``plan.cache_hits`` (and "miss" when it counts
    ``plan.cache_misses``)."""
    from cylon_tpu_torch import plan

    cq = plan.compile_query(_q)
    for n in (64, 64, 128, 64, 128, 32):
        t = _t(n)
        state = explain(cq, t)["cache_state"]
        h0 = telemetry.total("plan.cache_hits")
        m0 = telemetry.total("plan.cache_misses")
        cq(t)
        moved = ("hit" if telemetry.total("plan.cache_hits") > h0 else
                 "miss" if telemetry.total("plan.cache_misses") > m0
                 else None)
        assert state == moved, (n, state, moved)


# ----------------------------------------------------------- ANALYZE
def test_profile_schema_and_operator_attribution():
    import cylon_tpu.telemetry.profile as jprof

    def q():
        from cylon_tpu_torch.utils import tracing

        with tracing.span("fake_op"):
            return int(_q(_t(64)).num_rows)

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(q, tenant="alice", slo=60.0)
    assert tk.result(WAIT) == 4
    p = tk.profile()
    eng.close()
    assert REQUIRED_PROFILE_FIELDS == jprof.REQUIRED_PROFILE_FIELDS
    assert set(p) == set(REQUIRED_PROFILE_FIELDS)
    assert p["rid"] == tk.rid and p["tenant"] == "alice"
    assert p["state"] == "done" and p["steps"] == 1
    assert p["slo_s"] == 60.0
    assert p["wall_s"] > 0 and p["queue_wait_s"] >= 0
    assert "fake_op" in p["operators"]
    assert p["operators"]["fake_op"]["wall_s"] > 0
    assert profile_text(p).startswith("ANALYZE request")
    json.dumps(p, allow_nan=False)


def test_profile_compile_vs_execute_split_on_compiled_query():
    """The split on the eager port: the scale-memo miss counts as the
    "compile", the eager query as ``dispatch_s`` and its overflow check
    as ``execute_s``; the warm request is a memo hit. (The JAX case also
    expects the warm dispatch to be cheaper than the traced one; the
    port traces nothing, so both dispatches run the query.)"""
    from cylon_tpu_torch import plan

    def q_split(t):
        return _q(t)

    cq = plan.shared_compiled(q_split)
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(lambda: int(cq(_t(64)).num_rows), tenant="c")
    assert tk.result(WAIT) == 4
    p = tk.profile()
    tk2 = eng.submit(lambda: int(cq(_t(64)).num_rows), tenant="c")
    assert tk2.result(WAIT) == 4
    p2 = tk2.profile()
    eng.close()
    assert p["compile"]["cache_misses"] == 1
    assert p["compile"]["compile_count"] == 1
    assert p["compile"]["dispatch_s"] > 0
    assert p["compile"]["execute_s"] > 0
    assert "plan.dispatch" in p["stages"]
    assert p2["compile"]["cache_hits"] == 1
    assert p2["compile"]["cache_misses"] == 0
    assert p2["compile"]["dispatch_s"] > 0
    for prof in (p, p2):
        assert prof["stage_coverage"] is None or \
            prof["stage_coverage"] <= 1.0 + 1e-6, prof


def test_profile_memory_block_unknown_when_sampling_off(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_MEMORY_SAMPLING", "0")
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(lambda: 1, tenant="nomem")
    assert tk.result(WAIT) == 1
    m = tk.profile()["memory"]
    eng.close()
    assert m == {"live_bytes_start": None, "live_bytes_peak": None,
                 "live_bytes_end": None}


def test_profile_render_safe_against_concurrent_steps():
    gate = threading.Event()
    stepped = threading.Event()

    def churn():
        from cylon_tpu_torch.utils import tracing

        i = 0
        while not gate.is_set():
            with tracing.span(f"churn_op_{i % 97}"):
                pass
            telemetry.counter("exchange.rows", op=f"op{i % 53}").inc(1)
            i += 1
            stepped.set()
            yield
        return i

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(churn, tenant="race")
    errors = []
    # poll for 1 s, and on until the churn step has yielded once: on a
    # loaded host the scheduler may not reach the request within 1 s
    t_end = time.monotonic() + 1.0
    give_up = time.monotonic() + WAIT
    while (time.monotonic() < t_end or not stepped.is_set()) \
            and time.monotonic() < give_up:
        try:
            tk.profile()
        except Exception as e:  # the race under test
            errors.append(e)
            break
    gate.set()
    assert tk.result(WAIT) >= 1
    eng.close()
    assert not errors, errors


def test_profile_disabled_by_the_module_switch(monkeypatch):
    monkeypatch.setattr(prof_mod, "PROFILING", False)
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(lambda: 1, tenant="off")
    assert tk.result(WAIT) == 1
    assert tk.profile() is None
    eng.close()


def test_profile_live_while_running():
    gate = threading.Event()

    def gated():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return "ok"

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(gated, tenant="live")
    for _ in range(200):
        p = tk.profile()
        if p["steps"] >= 1:
            break
        time.sleep(0.01)
    assert p["state"] in ("queued", "running")
    assert p["steps"] >= 1
    gate.set()
    assert tk.result(WAIT) == "ok"
    assert tk.profile()["state"] == "done"
    eng.close()


def test_faults_and_spill_ride_the_profile():
    from cylon_tpu_torch.resilience import FaultPlan, FaultRule, inject

    plan = FaultPlan([FaultRule("worker", times=0)])

    def q():
        try:
            inject("worker")
        except Exception:
            pass
        return 5

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(q, tenant="faulty", fault_plan=plan)
    assert tk.result(WAIT) == 5
    p = tk.profile()
    eng.close()
    assert p["faults"]["injected"] >= 1


def test_degraded_request_carries_the_oom_report():
    """A step that runs out of memory re-runs once through its fallback:
    DONE, ``degraded`` true, the OOM report in the profile, and the
    breaker untouched."""
    import torch

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (seeded)")

    eng = ServeEngine(policy=ServePolicy(max_queue=2, breaker_fails=1))
    tk = eng.submit(oom, tenant="big", fallback=lambda: "spilled")
    assert tk.result(WAIT) == "spilled"
    p = tk.profile()
    assert tk.state == "done" and p["degraded"] is True
    assert p["fallback"]["fallbacks"] == 1
    assert p["fallback"]["oom_report"] is not None
    assert "DEGRADED" in profile_text(p)
    assert eng._admission.breaker.state == "closed"
    assert telemetry.counter("serve.degraded", tenant="big").value == 1
    eng.close()


# ----------------------------------------------------------- history
def _history_sequence(mod, path):
    h = mod.ProfileHistory(str(path), samples_per_key=4)
    for i, w in enumerate((0.5, 0.1, 0.3, 0.2, 0.9)):
        h.record("fp1", 1024, w)
    h.record("fp1", 2048, 0.05, degraded=True)
    h.record("fp2", None, 1.5, path="cache_hit")
    h.record(None, 8, 9.9)
    h.save()
    return h


def test_profile_history_files_load_in_either_package(tmp_path):
    from cylon_tpu.telemetry import profile as jprof

    port = _history_sequence(prof_mod, tmp_path / "port.json")
    jax = _history_sequence(jprof, tmp_path / "jax.json")
    asks = [("fp1", 1024), ("fp1", 2048), ("fp1", 4096), ("fp2", None),
            ("nope", None)]
    for a, b in ((prof_mod, jprof), (jprof, prof_mod)):
        for src in ("port.json", "jax.json"):
            x = a.ProfileHistory(str(tmp_path / src))
            y = b.ProfileHistory(str(tmp_path / src))
            assert [x.predict(*k) for k in asks] == \
                [y.predict(*k) for k in asks]
    assert [port.predict(*k) for k in asks] == \
        [jax.predict(*k) for k in asks]
    assert port.predict("fp1", 1024)["predicted_wall_s"] == 0.25
    merged = prof_mod.merged_history([tmp_path / "port.json",
                                      tmp_path / "jax.json",
                                      tmp_path / "absent.json"])
    jmerged = jprof.merged_history([tmp_path / "port.json",
                                    tmp_path / "jax.json"])
    assert merged.predict("fp1", 1024)["samples"] == 8
    assert merged.predict("fp1", 1024) == jmerged.predict("fp1", 1024)
    assert merged.predict("fp2") == jmerged.predict("fp2")


def test_explain_named_surfaces_the_measured_history(tmp_path):
    catalog.put_table("t", _t(64))
    eng = ServeEngine(policy=ServePolicy(max_queue=2),
                      durable_dir=str(tmp_path))
    eng.register_query("g", lambda t: int(_q(t).num_rows), tables=["t"])
    t = catalog.get_table("t")
    assert eng.explain_named("g", t)["cost_estimate"] is None
    assert eng.submit_named("g", t).result(WAIT) == 4
    est = eng.explain_named("g", t)["cost_estimate"]
    eng.close()
    assert est is None or est["samples"] >= 1
    hist = prof_mod.ProfileHistory(str(tmp_path / prof_mod.HISTORY_FILE))
    assert len(hist) == len(eng.profile_history)


# -------------------------------------------------------- acceptance
def test_acceptance_dist_join_profile_at_w4():
    """A W = 4 ``dist_join`` on ``ThreadWorld`` inside one request (64K
    rows a rank a side; the JAX case runs 1M rows on its 8-device mesh):
    the profile attributes the ``dist_join`` operator and its exchange
    bytes to the request, covers its wall, and records a memory peak.
    Each rank records its own spans, so the operator's wall is the
    ranks' summed busy seconds. The exchange sets
    ``exchange.headroom_ratio``, so ``headroom_ratio`` is that number."""
    from cylon_tpu_torch.parallel.dist_ops import dist_join
    from cylon_tpu_torch.telemetry import memory

    w, n = 4, 64 << 10
    rng = np.random.default_rng(7)
    sides = [(rng.integers(0, w * n, w * n), rng.normal(size=w * n))
             for _ in range(2)]
    # resident shards, built before the request as the JAX case's are
    shards = [[Table.from_pydict({"k": k[r * n:(r + 1) * n],
                                  c: v[r * n:(r + 1) * n]}, device="cpu")
               for (k, v), c in zip(sides, ("a", "b"))] for r in range(w)]

    def q():
        def rank(comm):
            env = CylonEnv(comm, device="cpu")
            lt, rt = shards[comm.rank]
            return dist_join(env, lt, rt, on="k", how="inner").num_rows

        return sum(ThreadWorld(w).run(rank))

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(q, tenant="acceptance")
    rows = tk.result(120)
    p = tk.profile()
    eng.close()
    want = int((np.bincount(sides[0][0], minlength=w * n)
                * np.bincount(sides[1][0], minlength=w * n)).sum())
    assert rows == want > 0
    assert p["stage_coverage"] >= 0.8, p
    dj = p["operators"]["dist_join"]
    assert dj["bytes_true"] > 0 and dj["rows"] >= 2 * w * n * 3 // 4
    assert dj["calls"] >= w and dj["wall_s"] > 0
    assert p["memory"]["live_bytes_peak"] is not None
    assert p["memory"]["live_bytes_peak"] > 0
    gauge = [inst.value for _, _, inst in
             telemetry.instruments("exchange.headroom_ratio")]
    assert isinstance(p["headroom_ratio"], float)
    assert p["headroom_ratio"] == max(gauge) >= 1.0
    assert (memory.peak_live_bytes(op="serve_request") or 0) > 0


def test_headroom_gauge_equals_the_ladder_ratio_at_w4():
    """The ``exchange.headroom_ratio`` gauge of a W = 4 ``dist_join``
    (4096 rows a rank a side) is the ladder's own ratio: each side's
    settled receive rows (the power-of-two bucket of its tight estimate,
    ``ceil(total / W) + 4 * sqrt + 16``) times W, over the true rows of
    both sides; the request's profile reads it, and ``bench_metrics``
    too."""
    import math

    from cylon_tpu_torch.parallel.dist_ops import dist_join
    from cylon_tpu_torch.telemetry.export import bench_metrics
    from cylon_tpu_torch.utils import pow2_bucket

    telemetry.reset("exchange.")
    w, n = 4, 4096
    rng = np.random.default_rng(11)
    sides = [(rng.integers(0, w * n, w * n), rng.normal(size=w * n))
             for _ in range(2)]
    shards = [[Table.from_pydict({"k": k[r * n:(r + 1) * n],
                                  c: v[r * n:(r + 1) * n]}, device="cpu")
               for (k, v), c in zip(sides, ("a", "b"))] for r in range(w)]

    def q():
        def rank(comm):
            env = CylonEnv(comm, device="cpu")
            lt, rt = shards[comm.rank]
            return dist_join(env, lt, rt, on="k", how="inner").num_rows

        return sum(ThreadWorld(w).run(rank))

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(q, tenant="headroom")
    tk.result(120)
    p = tk.profile()
    eng.close()
    est = -(-(w * n) // w)
    recv = pow2_bucket(est + 4 * int(math.sqrt(est)) + 16)
    want = 2 * recv * w / (2 * w * n)
    (gauge,) = [inst.value for _, lab, inst in
                telemetry.instruments("exchange.headroom_ratio")
                if dict(lab).get("op") == "dist_join"]
    assert gauge == want
    assert p["headroom_ratio"] == want
    assert bench_metrics()["exchange.headroom_ratio"] == want
