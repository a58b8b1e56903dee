"""The port's deadline and watchdog layer (``cylon_tpu_torch.watchdog``)
against the JAX package's: deadline scopes, bounded sections and their
stack dumps, per-section retry classification, fault-injected hangs at
the exchange, the spill store and the barrier, timings and straggler
reports. Host code: the parity cases compare the section tables and the
verdicts of both packages; the exchanges run on ``ThreadWorld`` ranks
with CPU tables.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import cylon_tpu.watchdog as jwd
import cylon_tpu_torch as ct
from cylon_tpu_torch import config, resilience, watchdog
from cylon_tpu_torch.config import DeadlinePolicy
from cylon_tpu_torch.errors import (Code, DeadlineExceeded, InvalidArgument,
                                    TransientError)
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.resilience import FaultPlan, FaultRule, is_retryable
from cylon_tpu_torch.watchdog import bounded, check, deadline, \
    watched_section

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    resilience.install(None)
    watchdog.clear_timings()


def test_sections_and_budgets_match_jax():
    import cylon_tpu.config as jcfg

    # the serving layer's two sections wait for its port (ROADMAP A8.2)
    serve = ("serve_request", "router_poll")
    assert watchdog.SECTIONS == {k: v for k, v in jwd.SECTIONS.items()
                                 if k not in serve}
    assert set(watchdog.SECTIONS) == set(config.DEADLINE_SECTIONS)
    assert config.DEADLINE_SECTIONS == {
        k: v for k, v in jcfg.DEADLINE_SECTIONS.items() if k not in serve}
    assert dict(vars(DeadlinePolicy())) == dict(vars(jcfg.DeadlinePolicy()))


# ------------------------------------------------------- deadline scopes
def test_deadline_scope_remaining_and_exit():
    assert watchdog.active_deadline() is None
    assert watchdog.remaining() is None
    with deadline(5.0):
        r = watchdog.remaining()
        assert r is not None and 4.0 < r <= 5.0
    assert watchdog.active_deadline() is None


def test_nested_deadline_inner_tighter_wins():
    with deadline(10.0):
        with deadline(0.05):
            assert watchdog.remaining() <= 0.05
            with pytest.raises(DeadlineExceeded):
                bounded(lambda: time.sleep(1.0), "barrier")
        assert watchdog.remaining() > 5.0


def test_nested_deadline_inner_cannot_extend_outer():
    with deadline(0.04):
        with deadline(60.0):
            assert watchdog.remaining() <= 0.04


# ----------------------------------------------- bounded: raise + dump
def test_expiry_raises_named_section_after_stack_dump(capsys):
    with deadline(0.05):
        with pytest.raises(DeadlineExceeded) as ei:
            bounded(lambda: time.sleep(3.0), "barrier",
                    detail="test drain")
    e = ei.value
    assert e.section == "barrier"
    assert "'barrier'" in str(e) and "test drain" in str(e)
    assert e.code == Code.DeadlineExceeded
    assert e.elapsed is not None and e.elapsed >= 0.04
    err = capsys.readouterr().err
    assert "cylon_tpu_torch watchdog" in err and "'barrier'" in err
    assert "stalled" in err and "--- thread" in err
    assert "test drain" in err


def test_bounded_returns_result_and_propagates_errors():
    with deadline(5.0):
        assert bounded(lambda: 42, "barrier") == 42
        with pytest.raises(ZeroDivisionError):
            bounded(lambda: 1 // 0, "barrier")


def test_bounded_explicit_timeout_without_scope():
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded) as ei:
        bounded(lambda: time.sleep(3.0), "spill_io", timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    assert ei.value.section == "spill_io"


def test_bounded_already_expired_scope_raises_immediately():
    with deadline(0.0):
        with pytest.raises(DeadlineExceeded):
            bounded(lambda: 1, "overflow_fetch")


def test_unknown_section_rejected():
    with pytest.raises(InvalidArgument):
        bounded(lambda: 1, "no_such_section")


def test_bounded_worker_runs_without_a_stream_when_cuda_is_untouched():
    """The worker enters the caller's CUDA stream; in a process that
    never initialised CUDA there is none to enter and none is created."""
    import torch

    seen = {}

    def fn():
        seen["tid"] = threading.get_ident()
        return 3

    with deadline(5.0):
        assert bounded(fn, "barrier") == 3
    assert seen["tid"] != threading.get_ident()
    if not torch.cuda.is_initialized():
        assert watchdog._caller_stream() is None


# ------------------------------------------------------------ fast path
def test_no_deadline_fast_path_is_inline_and_unmonitored(monkeypatch):
    def _boom(rec):
        raise AssertionError("fast path must not touch the monitor")

    monkeypatch.setattr(watchdog._MONITOR, "register", _boom)
    seen = {}

    def fn():
        seen["tid"] = threading.get_ident()
        return 7

    assert bounded(fn, "barrier") == 7
    assert seen["tid"] == threading.get_ident()


def test_monitor_thread_never_starts_without_scope():
    """In a fresh process, a barrier, a spill write and an exchange with
    no deadline start no monitor thread."""
    code = (
        f"import sys, threading, tempfile; sys.path.insert(0, {ROOT!r})\n"
        "import numpy as np\n"
        "import cylon_tpu_torch as ct\n"
        "from cylon_tpu_torch import watchdog\n"
        "from cylon_tpu_torch.resilience import SpillStore\n"
        "env = ct.CylonEnv(device='cpu')\n"
        "env.barrier()\n"
        "t = ct.Table.from_pydict({'k': np.arange(64)}, device='cpu')\n"
        "ct.shuffle(env, t, ['k'])\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    SpillStore(d, 'fp').write_bucket(0, {'a': np.arange(3)}, 3)\n"
        "assert watchdog._MONITOR.thread is None, 'monitor started!'\n"
        "assert not any(t.name == 'cylon-torch-watchdog'\n"
        "               for t in threading.enumerate())\n"
        "print('FAST_PATH_CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FAST_PATH_CLEAN" in out.stdout


def test_env_default_bounds_section_without_scope(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_DEADLINE_BARRIER", "0.05")
    with pytest.raises(DeadlineExceeded) as ei:
        bounded(lambda: time.sleep(3.0), "barrier")
    assert ei.value.section == "barrier"
    monkeypatch.setenv("CYLON_TPU_DEADLINE_BARRIER", "0")
    assert bounded(lambda: 5, "barrier") == 5
    monkeypatch.setenv("CYLON_TPU_DEADLINE_BARRIER", "nope")
    with pytest.raises(InvalidArgument):
        bounded(lambda: 5, "barrier")


# ------------------------------------------------- retry classification
def test_retryable_classification_per_section_matches_jax():
    verdicts = {}
    for section in watchdog.SECTIONS:
        with pytest.raises(DeadlineExceeded) as ei:
            with deadline(0.02):
                bounded(lambda: time.sleep(0.3), section)
        verdicts[section] = is_retryable(ei.value)
    assert verdicts == {k: jwd.SECTIONS[k] for k in watchdog.SECTIONS}
    assert verdicts["bootstrap"] and verdicts["spill_io"]
    assert not verdicts["exchange"] and not verdicts["barrier"]


def test_retrying_absorbs_retryable_deadline():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            return bounded(lambda: time.sleep(1.0), "bootstrap",
                           timeout=0.02)
        return "joined"

    assert resilience.retrying(flaky, sleep_fn=lambda d: None) == "joined"
    assert calls["n"] == 2


# ------------------------------------------------- fault-injected hangs
def test_fault_rule_delay_mode_sleeps_instead_of_raising():
    plan = FaultPlan([FaultRule("exchange", nth=2, delay=0.08)])
    with resilience.active(plan):
        t0 = time.monotonic()
        resilience.inject("exchange")
        assert time.monotonic() - t0 < 0.05
        resilience.inject("exchange")
        assert time.monotonic() - t0 >= 0.08
        resilience.inject("exchange")
    assert [f[:2] for f in plan.fired] == [("exchange", 2)]


def test_fault_rule_delay_plus_error_is_slow_failure():
    plan = FaultPlan([FaultRule("io_read", delay=0.05,
                                error=TransientError("slow death"))])
    t0 = time.monotonic()
    with pytest.raises(TransientError, match="slow death"):
        plan.check("io_read")
    assert time.monotonic() - t0 >= 0.05


def test_hang_alias_and_validation():
    r = FaultRule.hang("exchange")
    assert r.delay == 3600.0 and r.point == "exchange"
    assert FaultRule.hang("worker", seconds=0.25).delay == 0.25
    with pytest.raises(InvalidArgument):
        FaultPlan([FaultRule("exchange", delay=-1.0)])


def test_injected_exchange_hang_detected_and_dumped(capsys):
    """A hang at the ``exchange`` point under a 50 ms deadline raises
    DeadlineExceeded naming the section, after the watchdog dumped every
    thread's stack while the hang was still in progress."""
    rng = np.random.default_rng(1)
    t = ct.Table.from_pydict({"k": rng.integers(0, 50, 64)
                              .astype(np.int64)}, device="cpu")
    env = ct.CylonEnv(device="cpu")
    plan = FaultPlan([FaultRule.hang("exchange", seconds=0.4)])
    with resilience.active(plan):
        with pytest.raises(DeadlineExceeded) as ei:
            with deadline(0.05):
                ct.shuffle(env, t, ["k"])
    assert ei.value.section == "exchange"
    assert plan.fired and plan.fired[0][0] == "exchange"
    err = capsys.readouterr().err
    assert "cylon_tpu_torch watchdog" in err and "'exchange'" in err
    assert "--- thread" in err
    rec = watchdog.timings("exchange")[-1]
    assert rec.expired
    assert rec.dump_after is not None and rec.dump_after < 0.4


# ------------------------------------------------ cooperative sections
def test_check_raises_promptly_between_chunks():
    with deadline(0.02):
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded) as ei:
            check("ooc_pass", "chunk 3")
    assert ei.value.section == "ooc_pass"
    assert "chunk 3" in str(ei.value)
    check("ooc_pass")


def test_ooc_pass_deadline_raises_between_chunks():
    from cylon_tpu_torch.outofcore import ooc_sort

    src = {"k": np.arange(4096, dtype=np.int64)}
    plan = FaultPlan([FaultRule.hang("chunk_source", seconds=0.1)])
    with resilience.active(plan):
        with deadline(0.05):
            with pytest.raises(DeadlineExceeded) as ei:
                ooc_sort(src, "k", n_partitions=2, chunk_rows=256,
                         device="cpu")
    assert ei.value.section == "ooc_pass"


def test_chunk_stream_checkpoint_attributes_the_enclosing_section():
    from cylon_tpu_torch.ops_graph import chunk_stream

    t = ct.Table.from_pydict({"k": np.arange(40)}, device="cpu")
    with pytest.raises(DeadlineExceeded) as ei:
        with deadline(0.02):
            with watched_section("ooc_pass"):
                time.sleep(0.04)
                list(chunk_stream(t, 8))
    assert ei.value.section == "ooc_pass"
    assert len(list(chunk_stream(t, 8))) == 5  # no scope: no check


def test_watched_section_late_raise_chains_body_error():
    with pytest.raises(DeadlineExceeded) as ei:
        with deadline(0.01):
            with watched_section("exchange", detail="wedge"):
                time.sleep(0.05)
                raise RuntimeError("collective fell apart")
    assert isinstance(ei.value.__cause__, RuntimeError)
    with pytest.raises(RuntimeError):
        with deadline(10.0):
            with watched_section("exchange"):
                raise RuntimeError("real bug")


# -------------------------------------------------- barrier & spill io
def test_barrier_timeout_argument():
    env = ct.CylonEnv(device="cpu")
    env.barrier()
    env.barrier(timeout=30.0)
    with pytest.raises(DeadlineExceeded) as ei:
        with deadline(0.0):
            env.barrier()
    assert ei.value.section == "barrier"


def test_barrier_timeout_against_a_hung_peer():
    """A hang rule at the barrier's ``worker`` point stands for a peer
    that never arrives: ``barrier(timeout=)`` raises DeadlineExceeded
    (never retryable) within the timeout plus a small slack."""
    env = ct.CylonEnv(device="cpu")
    env.set_fault_plan(FaultPlan([FaultRule.hang("worker", seconds=2.0)]))
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded) as ei:
        env.barrier(timeout=0.1)
    assert time.monotonic() - t0 < 0.1 + 1.0
    assert ei.value.section == "barrier" and not is_retryable(ei.value)


def test_barrier_timeout_at_w4_waits_for_every_rank():
    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        if comm.rank == 3:
            time.sleep(0.05)
        env.barrier(timeout=30.0)
        return True

    assert ct.ThreadWorld(4, timeout=30).run(rank) == [True] * 4


def test_spill_io_deadline_with_injected_hang(tmp_path):
    plan = FaultPlan([FaultRule("spill_write", nth=1, delay=0.3)])
    store = resilience.SpillStore(
        str(tmp_path / "a"), fingerprint="fp",
        policy=config.RetryPolicy(max_attempts=1))
    with resilience.active(plan):
        with deadline(0.05):
            with pytest.raises(DeadlineExceeded) as ei:
                store.write_bucket(0, {"a": np.arange(3)}, 3)
    assert ei.value.section == "spill_io"
    assert ei.value.retryable and is_retryable(ei.value)


def test_spill_io_env_budget_retry_absorbs_hang(tmp_path, monkeypatch):
    store = resilience.SpillStore(str(tmp_path / "b"), fingerprint="fp")
    store.write_bucket(0, {"a": np.arange(4)}, 4)
    monkeypatch.setenv("CYLON_TPU_DEADLINE_SPILL_IO", "0.05")
    plan = FaultPlan([FaultRule("spill_read", nth=1, delay=0.3)])
    with resilience.active(plan):
        out = store.read_bucket(0)
    assert list(out["a"]) == [0, 1, 2, 3]
    assert any(r.expired for r in watchdog.timings("spill_io"))


def test_expired_scope_on_entry_is_not_retryable():
    with deadline(0.0):
        with pytest.raises(DeadlineExceeded) as ei:
            bounded(lambda: 1, "bootstrap")
    assert not ei.value.retryable and not is_retryable(ei.value)
    recs = watchdog.timings("bootstrap")
    assert recs and recs[-1].expired


def test_compiled_query_fetch_is_a_bounded_section():
    """``CompiledQuery``'s one transfer is the ``overflow_fetch``
    section: under a deadline it runs bounded and is recorded."""
    from cylon_tpu_torch import plan

    q = plan.CompiledQuery(lambda t: ct.filter_table(
        t, t.column("k").data > 3))
    t = ct.Table.from_pydict({"k": np.arange(10)}, device="cpu")
    with deadline(30.0):
        assert q(t).num_rows == 6
    recs = watchdog.timings("overflow_fetch")
    assert recs and not recs[-1].expired


# ------------------------------------------------- timings & stragglers
def test_timing_records_and_straggler_report():
    with deadline(5.0):
        bounded(lambda: time.sleep(0.01), "overflow_fetch",
                detail="8 leaves")
    with watched_section("exchange", detail="shuffle"):
        time.sleep(0.005)
    assert {r.section for r in watchdog.timings()} >= {"overflow_fetch",
                                                        "exchange"}
    of = watchdog.timings("overflow_fetch")[-1]
    assert of.elapsed >= 0.01 and not of.expired and of.budget <= 5.0
    rep = watchdog.straggler_report()
    assert rep["overflow_fetch"]["count"] == 1
    assert rep["exchange"]["expired"] == 0
    assert rep["exchange"]["max_s"] >= 0.005


def test_exchanges_record_one_section_per_rank():
    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        t = scatter_table(env, ct.Table.from_pydict(
            {"k": np.arange(200) % 17}, device="cpu"))
        ct.dist_join(env, t, t, on="k")
        ct.repartition(env, t)

    ct.ThreadWorld(4, timeout=30).run(rank)
    details = sorted(r.detail for r in watchdog.timings("exchange"))
    assert details == ["dist_join"] * 4 + ["repartition"] * 4


def test_active_sections_visible_while_blocked():
    seen = {}

    def peek():
        seen["live"] = watchdog.active_sections()
        return 1

    with deadline(5.0):
        bounded(peek, "barrier", detail="introspect")
    assert any(s == "barrier" and d == "introspect"
               for s, d, _ in seen["live"])


# ------------------------------------------------------- policy knobs
def test_default_policy_is_the_module_constant(monkeypatch):
    assert watchdog.default_deadline_policy() == DeadlinePolicy()
    pol = DeadlinePolicy(poll_interval=0.01, action="abort",
                         dump_stacks=False)
    monkeypatch.setattr(watchdog, "DEADLINE_POLICY", pol)
    assert watchdog.default_deadline_policy() is pol


def test_abort_policy_exits_process(monkeypatch):
    exits = []
    monkeypatch.setattr(watchdog.os, "_exit", lambda code: exits.append(code))
    monkeypatch.setattr(watchdog, "DEADLINE_POLICY",
                        DeadlinePolicy(action="abort"))
    with pytest.raises(DeadlineExceeded):
        with deadline(0.02):
            bounded(lambda: time.sleep(0.3), "barrier")
    assert exits == [70]
