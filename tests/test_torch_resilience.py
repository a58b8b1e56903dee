"""The port's resilience layer (``cylon_tpu_torch.resilience``) against the
JAX package's (``cylon_tpu.resilience``): fault plans, retry/backoff, the
spill store and checkpoints, ``ooc_sort``'s loss accounting and resume,
and the hooks in io, the exchanges and the process-group bootstrap.

The layer is host code, so the parity cases drive both packages through
the same schedule and compare what fired, the backoff delays and the
fingerprints bit for bit; the device half runs on CPU tensors.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import cylon_tpu.resilience as jres
import cylon_tpu_torch as ct
from cylon_tpu_torch import resilience, telemetry
from cylon_tpu_torch.config import RetryPolicy
from cylon_tpu_torch.errors import (Code, CylonError, DataLossError,
                                    DeadlineExceeded, InvalidArgument,
                                    IOError_, TransientError)
from cylon_tpu_torch.outofcore import ooc_sort
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.resilience import (CheckpointedRun, FaultPlan,
                                        FaultRule, SpillStore,
                                        atomic_write_json, backoff_delays,
                                        is_retryable, retrying)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    """A leaked process-wide plan would fire into unrelated tests."""
    yield
    resilience.install(None)


def _drive(plan, points):
    """Hit ``points`` in order, recording which raise."""
    outcomes = []
    for p in points:
        try:
            plan.check(p)
            outcomes.append(None)
        except Exception as e:
            outcomes.append(type(e).__name__)
    return outcomes


# --------------------------------------------------------- fault plans
@pytest.mark.parametrize("rule,seed", [
    (dict(point="io_read", nth=3, times=2), 0),
    (dict(point="spill_read", nth=2, times=0), 0),
    (dict(point="chunk_source", prob=0.4), 123),
    (dict(point="exchange", prob=0.15), 7),
])
def test_fault_schedule_matches_jax(rule, seed):
    """The same rule and seed fire on the same hits in both packages."""
    seq = [rule["point"]] * 40
    port = FaultPlan([FaultRule(**rule)], seed=seed)
    jax_plan = jres.FaultPlan([jres.FaultRule(**rule)], seed=seed)
    got = _drive(port, seq)
    want = _drive(jax_plan, seq)
    assert [g is None for g in got] == [w is None for w in want]
    assert port.fired == jax_plan.fired


def test_fault_rule_nth_and_times():
    plan = FaultPlan([FaultRule("io_read", nth=3, times=2)])
    assert _drive(plan, ["io_read"] * 6) == [
        None, None, "TransientError", "TransientError", None, None]
    plan = FaultPlan([FaultRule("spill_read", nth=2, times=0)])
    assert _drive(plan, ["spill_read"] * 4) == \
        [None] + ["TransientError"] * 3


def test_fault_plan_replay_determinism():
    plan = FaultPlan([FaultRule("chunk_source", prob=0.4)], seed=123)
    seq = ["chunk_source"] * 40
    first = _drive(plan, seq)
    fired_first = plan.fired
    assert any(first) and not all(first)
    plan.reset()
    assert _drive(plan, seq) == first
    assert plan.fired == fired_first


def test_fault_plan_custom_error_and_validation():
    plan = FaultPlan([FaultRule("spill_write", nth=1,
                                error=IOError_("disk gone"))])
    with pytest.raises(IOError_, match="disk gone"):
        plan.check("spill_write")
    with pytest.raises(InvalidArgument):
        FaultPlan([FaultRule("no_such_point")])
    with pytest.raises(InvalidArgument):
        resilience.inject("no_such_point")
    with pytest.raises(InvalidArgument):
        FaultPlan([FaultRule("io_read", delay=-1.0)])
    with pytest.raises(InvalidArgument):
        FaultPlan([FaultRule("io_read", exit_code=300)])
    assert resilience.INJECTION_POINTS == jres.INJECTION_POINTS
    assert resilience.KILL_EXIT_CODE == jres.KILL_EXIT_CODE


def test_inject_is_noop_without_plan():
    resilience.install(None)
    resilience.inject("exchange")  # must not raise


def test_plan_precedence_env_then_scoped_then_global():
    env_plan = FaultPlan([FaultRule("plan", error=ValueError("env"))])
    scoped = FaultPlan([FaultRule("plan", error=KeyError("scoped"))])
    glob = FaultPlan([FaultRule("plan", error=TypeError("global"))])
    env = ct.CylonEnv(device="cpu").set_fault_plan(env_plan)
    assert env.fault_plan is env_plan
    with resilience.active(glob):
        with pytest.raises(TypeError):
            resilience.inject("plan")
        with resilience.scoped(scoped):
            with pytest.raises(KeyError):
                resilience.inject("plan")
            with pytest.raises(ValueError):
                resilience.inject("plan", env=env)
    env.set_fault_plan(None)
    assert env.fault_plan is None


# --------------------------------------------------------- retry engine
def test_is_retryable_classification():
    assert is_retryable(TransientError("preempted"))
    assert is_retryable(CylonError("x", code=Code.Unavailable))
    assert is_retryable(ConnectionError())
    assert is_retryable(TimeoutError())
    assert is_retryable(DeadlineExceeded("x", section="spill_io",
                                         retryable=True))
    assert not is_retryable(DeadlineExceeded("x", section="barrier"))
    assert not is_retryable(InvalidArgument("bad"))
    assert not is_retryable(IOError_("corrupt file"))
    assert not is_retryable(FileNotFoundError())
    assert not is_retryable(ValueError())
    assert not is_retryable(DataLossError("gone"))
    # an out-of-memory error is the fallback's, never a retry
    assert not is_retryable(MemoryError())


def test_error_codes_match_jax():
    import cylon_tpu.errors as jerr

    for name in ("TransientError", "DataLossError", "DeadlineExceeded",
                 "FailedPrecondition", "ResourceExhausted"):
        port_cls = getattr(ct.errors, name)
        assert issubclass(port_cls, CylonError)
        assert int(port_cls.code) == int(getattr(jerr, name).code), name


def test_retry_then_succeed_on_nth_attempt():
    calls = {"n": 0}
    slept = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError(f"attempt {calls['n']}")
        return 42

    assert retrying(flaky, RetryPolicy(max_attempts=3, base_delay=0.01),
                    sleep_fn=slept.append) == 42
    assert calls["n"] == 3 and len(slept) == 2


def test_retry_exhausts_and_nonretryable_raises_immediately():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise TransientError("still down")

    policy = RetryPolicy(max_attempts=3)
    with pytest.raises(TransientError):
        retrying(always, policy, sleep_fn=lambda d: None)
    assert calls["n"] == 3
    calls["n"] = 0

    def fatal():
        calls["n"] += 1
        raise InvalidArgument("bad input")

    with pytest.raises(InvalidArgument):
        retrying(fatal, policy, sleep_fn=lambda d: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("kw", [
    dict(max_attempts=8, base_delay=0.1, max_delay=0.5, multiplier=2.0,
         jitter=0.25, seed=7),
    dict(base_delay=0.1, max_delay=0.5, multiplier=2.0, jitter=0.0),
    dict(),
])
def test_backoff_sequence_matches_jax(kw):
    from cylon_tpu.config import RetryPolicy as JRetryPolicy

    g = backoff_delays(RetryPolicy(**kw))
    j = jres.backoff_delays(JRetryPolicy(**kw))
    assert [next(g) for _ in range(8)] == [next(j) for _ in range(8)]


def test_backoff_sequence_deterministic_and_capped():
    policy = RetryPolicy(max_attempts=8, base_delay=0.1, max_delay=0.5,
                         multiplier=2.0, jitter=0.25, seed=7)
    g1, g2 = backoff_delays(policy), backoff_delays(policy)
    s = [next(g1) for _ in range(6)]
    assert s == [next(g2) for _ in range(6)]
    assert all(0.1 * 0.75 - 1e-12 <= d <= 0.5 * 1.25 + 1e-12 for d in s)
    other = backoff_delays(RetryPolicy(base_delay=0.1, max_delay=0.5,
                                       multiplier=2.0, jitter=0.0))
    assert [round(next(other), 6) for _ in range(4)] == \
        [0.1, 0.2, 0.4, 0.5]


def test_default_policy_is_the_structs_defaults():
    from cylon_tpu.config import RetryPolicy as JRetryPolicy

    p = resilience.default_policy()
    assert p == RetryPolicy()
    assert dict(vars(p)) == dict(vars(JRetryPolicy()))


# --------------------------------------------------------- spill store
def test_spill_store_roundtrip_and_manifest(tmp_path, rng):
    store = SpillStore(str(tmp_path / "s"), fingerprint="abc")
    cols = {"k": rng.integers(0, 10, 100).astype(np.int64),
            "v": rng.normal(size=100)}
    store.write_bucket(0, cols, 100)
    store.write_bucket(1, {}, 0)
    assert store.completed == {0: 100, 1: 0}
    back = store.read_bucket(0)
    assert list(back) == ["k", "v"]
    np.testing.assert_array_equal(back["k"], cols["k"])
    assert SpillStore(str(tmp_path / "s"),
                      fingerprint="abc").completed == {0: 100, 1: 0}
    alien = tmp_path / "s" / "users_own_data.npz"
    np.savez(str(alien), a=np.arange(3))
    fresh = SpillStore(str(tmp_path / "s"), fingerprint="xyz")
    assert fresh.completed == {}
    assert not (tmp_path / "s" / "bucket00000.npz").exists()
    assert alien.exists()


def test_spill_store_reads_the_jax_stores_files(tmp_path, rng):
    """Same file layout: a store either package wrote, the other reads."""
    cols = {"k": rng.integers(0, 10, 50).astype(np.int64)}
    jstore = jres.SpillStore(str(tmp_path / "s"), fingerprint="f")
    jstore.write_bucket(3, cols, 50, meta={"ln": 50})
    port = SpillStore(str(tmp_path / "s"), fingerprint="f")
    assert port.completed == {3: 50}
    assert port.bucket_meta(3) == {"ln": 50}
    np.testing.assert_array_equal(port.read_bucket(3)["k"], cols["k"])


def test_spill_store_write_retries_transient_fault(tmp_path):
    plan = FaultPlan([FaultRule("spill_write", nth=1, times=1)])
    store = SpillStore(str(tmp_path / "s"), fingerprint="f",
                       policy=RetryPolicy(max_attempts=3,
                                          base_delay=0.001))
    with resilience.active(plan):
        store.write_bucket(0, {"x": np.arange(5)}, 5)
    assert plan.fired and plan.fired[0][0] == "spill_write"
    np.testing.assert_array_equal(store.read_bucket(0)["x"], np.arange(5))


# ---------------------------------------------------- checkpointed runs
def test_checkpointed_run_roundtrip_meta_and_fingerprint(tmp_path):
    ck = CheckpointedRun(str(tmp_path / "c"), "join", (("k",), "inner", 4))
    ck.complete(0, {"x": np.arange(5)}, 5, meta={"ln": 9, "rn": 7})
    ck.complete(1, {}, 0, meta={"ln": 0, "rn": 0})
    assert ck.completed == {0: 5, 1: 0}
    assert ck.unit_meta(0) == {"ln": 9, "rn": 7}
    ck.verify_meta(0, "t", ln=9, rn=7)
    with pytest.raises(DataLossError, match="source changed"):
        ck.verify_meta(0, "t", ln=9, rn=8)
    telemetry.reset("ooc.units_resumed")
    again = CheckpointedRun(str(tmp_path / "c"), "join",
                            (("k",), "inner", 4))
    np.testing.assert_array_equal(again.resume_unit(0)["x"], np.arange(5))
    assert again.resume_unit(1) == {}
    assert telemetry.counter("ooc.units_resumed", op="join").value == 2
    assert CheckpointedRun(str(tmp_path / "c"), "sort",
                           (("k",), "inner", 4)).completed == {}


@pytest.mark.parametrize("parts", [
    ("join", ("k",), "inner", 4, ("_x", "_y")),
    ("sort", ("a", "b"), 8, [(np.int64(3), np.float64(2.5))]),
    ("groupby", np.arange(7, dtype=np.int32), None, 1 << 22),
])
def test_fingerprint_matches_jax(parts):
    """The plan digest is the JAX package's, so a resume directory is
    read the same way by both."""
    assert resilience.fingerprint_arrays(*parts) == \
        jres.fingerprint_arrays(*parts)


def test_truncated_manifest_discarded_cleanly(tmp_path):
    root = tmp_path / "c"
    ck = CheckpointedRun(str(root), "sort", ("k",))
    ck.complete(0, {"x": np.arange(3)}, 3)
    mpath = root / "manifest.json"
    text = mpath.read_text()
    mpath.write_text(text[:len(text) // 2])
    assert CheckpointedRun(str(root), "sort", ("k",)).completed == {}
    assert not (root / "bucket00000.npz").exists()


def test_atomic_write_json_never_leaves_torn_target(tmp_path):
    p = str(tmp_path / "doc.json")
    atomic_write_json(p, {"gen": 1})
    atomic_write_json(p, {"gen": 2})
    assert json.load(open(p)) == {"gen": 2}
    with pytest.raises(TypeError):
        atomic_write_json(p, {"bad": object()})
    assert json.load(open(p)) == {"gen": 2}
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_spill_store_fsyncs_before_rename():
    import inspect

    assert "atomic_write_json" in inspect.getsource(
        resilience.SpillStore._write_manifest)
    wsrc = inspect.getsource(resilience.SpillStore.write_bucket)
    assert wsrc.index("os.fsync") < wsrc.rindex("os.replace(tmp")
    asrc = inspect.getsource(atomic_write_json)
    assert asrc.index("os.fsync") < asrc.rindex("os.replace(tmp")


# ------------------------------------------------ ooc_sort: loss + resume
def test_ooc_sort_rejects_one_shot_iterator(rng):
    n = 500
    data = {"k": rng.integers(0, 50, n).astype(np.int64)}
    gen = ({k: v[lo:lo + 100] for k, v in data.items()}
           for lo in range(0, n, 100))
    with pytest.raises(InvalidArgument, match="one-shot iterator"):
        ooc_sort(gen, "k", n_partitions=2, device="cpu")
    with pytest.raises(InvalidArgument):
        ooc_sort(object(), "k", n_partitions=2, device="cpu")
    parts = []
    assert ooc_sort([{"k": data["k"][:250]}, {"k": data["k"][250:]}], "k",
                    n_partitions=2, sink=parts.append, device="cpu") == n
    np.testing.assert_array_equal(
        pd.concat(parts, ignore_index=True)["k"].to_numpy(),
        np.sort(data["k"]))


def test_ooc_sort_data_loss_on_truncating_source(rng):
    n = 3000
    data = {"k": rng.integers(0, 100, n).astype(np.int64)}
    calls = {"n": 0}

    def src():
        calls["n"] += 1
        m = n if calls["n"] == 1 else n // 2

        def gen():
            for lo in range(0, m, 500):
                yield {k: v[lo:lo + 500] for k, v in data.items()}
        return gen()

    with pytest.raises(DataLossError, match="pass 1 saw 3000"):
        ooc_sort(src, "k", n_partitions=3, device="cpu")


def test_ooc_sort_fault_kill_and_resume(tmp_path, rng):
    """A spill write that fails past the retry budget stops pass 2; the
    rerun with the same resume_dir replays the completed buckets and
    gives the fault-free output."""
    n = 6000
    src = {"k": rng.integers(0, 500, n).astype(np.int64),
           "v": rng.normal(size=n)}
    kw = dict(n_partitions=4, chunk_rows=800, device="cpu")
    want_parts = []
    assert ooc_sort(src, ["k", "v"], sink=want_parts.append, **kw) == n
    want = pd.concat(want_parts, ignore_index=True)
    rdir = str(tmp_path / "resume")
    plan = FaultPlan([FaultRule("spill_write", nth=3, times=0)])
    got_parts: list = []
    with resilience.active(plan):
        with pytest.raises(TransientError):
            ooc_sort(src, ["k", "v"], sink=got_parts.append,
                     resume_dir=rdir, **kw)
    killed_at = len(got_parts)
    manifest = json.loads((tmp_path / "resume" / "manifest.json")
                          .read_text())
    assert 0 < len(manifest["completed"]) < 4
    got_parts = []
    assert ooc_sort(src, ["k", "v"], sink=got_parts.append,
                    resume_dir=rdir, **kw) == n
    pd.testing.assert_frame_equal(pd.concat(got_parts, ignore_index=True),
                                  want)
    assert killed_at < len(got_parts)


def test_ooc_sort_resume_noop_when_complete(tmp_path, rng):
    n = 2000
    src = {"k": rng.integers(0, 80, n).astype(np.int64)}
    rdir = str(tmp_path / "resume")
    kw = dict(n_partitions=3, chunk_rows=600, resume_dir=rdir,
              device="cpu")
    p1: list = []
    assert ooc_sort(src, "k", sink=p1.append, **kw) == n
    plan = FaultPlan([FaultRule("spill_write", nth=1, times=0)])
    p2: list = []
    telemetry.reset("ooc.units_resumed")
    with resilience.active(plan):
        assert ooc_sort(src, "k", sink=p2.append, **kw) == n
    assert plan.hits("spill_write") == 0
    assert telemetry.counter("ooc.units_resumed", op="sort").value == 3
    pd.testing.assert_frame_equal(pd.concat(p2, ignore_index=True),
                                  pd.concat(p1, ignore_index=True))


def test_ooc_sort_chunk_source_fault_mid_pass2(rng):
    n = 2400
    src = {"k": rng.integers(0, 60, n).astype(np.int64)}
    n_chunks = -(-n // 600)
    plan = FaultPlan([FaultRule("chunk_source", nth=n_chunks + 2,
                                times=1)])
    with resilience.active(plan):
        with pytest.raises(TransientError):
            ooc_sort(src, "k", n_partitions=2, chunk_rows=600,
                     device="cpu")
    assert plan.hits("chunk_source") == n_chunks + 2


# ------------------------------------------------------ io retry wiring
def test_read_csv_retries_injected_io_fault(tmp_path):
    p = str(tmp_path / "t.csv")
    pd.DataFrame({"x": np.arange(20)}).to_csv(p, index=False)
    plan = FaultPlan([FaultRule("io_read", nth=1, times=1)])
    with resilience.active(plan):
        df = ct.read_csv(p, device="cpu")
    assert plan.hits("io_read") == 2
    assert len(df) == 20
    plan = FaultPlan([FaultRule("io_read", nth=1, times=0)])
    with resilience.active(plan):
        with pytest.raises(IOError_):
            ct.read_csv(p, device="cpu")


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_chunk_readers_retry_injected_io_fault(tmp_path, fmt):
    p = str(tmp_path / f"t.{fmt}")
    frame = pd.DataFrame({"x": np.arange(30)})
    if fmt == "parquet":
        frame.to_parquet(p)
        read = ct.read_parquet_chunks
    else:
        frame.to_csv(p, index=False)
        read = ct.read_csv_chunks
    plan = FaultPlan([FaultRule("io_read", nth=1, times=1)])
    with resilience.active(plan):
        chunks = list(read(p, 16, device="cpu"))
    assert sum(c.num_rows for c in chunks) == 30
    assert plan.hits("io_read") == 2


def test_read_parquet_retries_injected_io_fault(tmp_path):
    p = str(tmp_path / "t.parquet")
    pd.DataFrame({"x": np.arange(12)}).to_parquet(p)
    plan = FaultPlan([FaultRule("io_read", nth=1, times=1)])
    with resilience.active(plan):
        df = ct.read_parquet(p, device="cpu")
    assert plan.hits("io_read") == 2 and len(df) == 12


# ------------------------------------------ exchange and bootstrap wiring
def _world_shards(comm, n=400, seed=5):
    env = ct.CylonEnv(comm, device="cpu")
    rng = np.random.default_rng(seed)
    t = ct.Table.from_pydict({"k": rng.integers(0, 50, n).astype(np.int64),
                              "v": rng.normal(size=n)}, device="cpu")
    return env, scatter_table(env, t)


@pytest.mark.parametrize("op", ["shuffle", "repartition", "dist_join"])
def test_exchanges_hit_the_env_plan(op):
    """A plan registered on each rank's env fires at the op's exchange
    point before any rows move, as the JAX package's ``env.set_fault_plan``."""

    def rank(comm):
        env, t = _world_shards(comm)
        plan = FaultPlan([FaultRule("exchange", nth=1, times=0)])
        env.set_fault_plan(plan)
        with pytest.raises(TransientError):
            if op == "shuffle":
                ct.shuffle(env, t, ["k"])
            elif op == "repartition":
                ct.repartition(env, t)
            else:
                ct.dist_join(env, t, t, on="k")
        return plan.fired[0][:2], plan.fired[0][2]

    got = ct.ThreadWorld(4, timeout=30).run(rank)
    assert got == [(("exchange", 1), op)] * 4


def test_transient_exchange_fault_is_retried_to_the_clean_rows():
    """A fault at every rank's first exchange hit, inside ``retrying``:
    the second attempt gives the clean run's rows."""
    from cylon_tpu_torch.parallel import dist_num_rows

    def rank(comm):
        env, t = _world_shards(comm)
        clean = dist_num_rows(env, ct.dist_join(env, t, t, on="k"))
        env.set_fault_plan(FaultPlan([FaultRule("exchange", nth=1)]))
        out = retrying(lambda: ct.dist_join(env, t, t, on="k"),
                       RetryPolicy(base_delay=0.0),
                       sleep_fn=lambda d: None)
        return clean, dist_num_rows(env, out), env.fault_plan.hits(
            "exchange")

    telemetry.reset("resilience.")
    got = ct.ThreadWorld(4, timeout=30).run(rank)
    assert all(g == (got[0][0], got[0][0], 2) for g in got)
    assert telemetry.total("resilience.retries") == 4


@pytest.mark.parametrize("op", ["shuffle", "repartition"])
def test_exchange_row_accounting_raises_data_loss(monkeypatch, op):
    """Rows dropped inside the exchange raise DataLossError on every
    rank (the check reads the counts the regrow ladder gathered), and a
    healthy exchange passes it."""
    from cylon_tpu_torch.parallel import dist_ops, dist_num_rows

    def rank(comm):
        env, t = _world_shards(comm)
        fn = ct.shuffle if op == "shuffle" else ct.repartition
        args = (["k"],) if op == "shuffle" else ()
        return dist_num_rows(env, fn(env, t, *args))

    assert ct.ThreadWorld(4, timeout=30).run(rank) == [400] * 4
    real = dist_ops.shuffle_local

    def lossy(comm, table, pid, out_cap, sent=None):
        out = real(comm, table, pid, out_cap, sent)
        if comm.rank == 1:   # rank 1 loses one received row
            out = out.with_nrows(out.nrows - 1)
        return out

    monkeypatch.setattr(dist_ops, "shuffle_local", lossy)

    def lossy_rank(comm):
        try:
            rank(comm)
        except DataLossError as e:
            return str(e)
        return None

    got = ct.ThreadWorld(4, timeout=30).run(lossy_rank)
    assert all(g is not None and "400 rows entered" in g
               and "399 came out" in g for g in got)


_BOOTSTRAP_CHILD = r"""
import sys, torch.distributed as dist
sys.path.insert(0, {root!r})
import cylon_tpu_torch as ct
from cylon_tpu_torch import resilience, telemetry
plan = resilience.FaultPlan([resilience.FaultRule("worker", nth=1, times=1)])
with resilience.active(plan):
    env = ct.CylonEnv(config=ct.DistConfig(
        backend="gloo", init_method="file://" + {store!r}, world_size=1,
        rank=0), device="cpu")
print(plan.hits("worker"), telemetry.total("bootstrap.attempts"),
      env.world_size, dist.is_initialized())
env.finalize()
"""


def test_process_group_bootstrap_retries_preemption(tmp_path):
    """An injected worker preemption at the bootstrap is retried: the
    second attempt initialises the group (a real gloo group of one, in a
    child process so no group outlives the test)."""
    code = _BOOTSTRAP_CHILD.format(root=ROOT, store=str(tmp_path / "fs"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["2", "2", "1", "True"]


def test_fault_rule_kill_exits_the_process_at_the_point(tmp_path):
    """``FaultRule.kill`` ends the process with KILL_EXIT_CODE at the
    seeded hit: nothing after the point runs."""
    marker = tmp_path / "after"
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from cylon_tpu_torch import resilience as r\n"
            "plan = r.FaultPlan([r.FaultRule.kill('spill_write', nth=2)])\n"
            "with r.active(plan):\n"
            "    r.inject('spill_write')\n"
            "    r.inject('spill_write')\n"
            f"    open({str(marker)!r}, 'w').write('ran')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == resilience.KILL_EXIT_CODE
    assert "HARD KILL" in out.stderr
    assert not marker.exists()
