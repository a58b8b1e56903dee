"""The port's serve durability and admission
(``cylon_tpu_torch.serve.service``, ``.admission``, ``.slo``) case for
case from ``tests/test_serve_recovery.py``: the journal written ahead of
execution, torn tails, idempotency, the kill-then-recover replay in a
child process, exactly-once replay across repeated recoveries, the
unreplayable report, and the breaker under a deadline storm. On the same
sequence of events the circuit breaker's and the SLO tracker's snapshots
equal the JAX package's, apart from timestamps. Windows and cooldowns are
short; no case sleeps more than about a second."""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cylon_tpu_torch import catalog, telemetry
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import (DeadlineExceeded, DeviceUnavailable,
                                    InvalidArgument, ResourceExhausted)
from cylon_tpu_torch.resilience import KILL_EXIT_CODE
from cylon_tpu_torch.serve import ServeEngine, ServePolicy, admission, slo
from cylon_tpu_torch.serve.durability import RequestJournal
from cylon_tpu_torch.table import Table

REPO = pathlib.Path(__file__).resolve().parents[1]
WAIT = 30


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    yield
    catalog.clear()
    telemetry.reset("serve.")


def _t(n=32):
    return Table.from_pydict({"k": np.arange(n, dtype=np.int64),
                              "v": np.arange(n, dtype=np.float64)},
                             device="cpu")


def _vsum(scale=1.0):
    tab = catalog.get_table("resident")
    return float(tab.column("v").data[:tab.num_rows].sum()) * scale


def _cpu_env():
    return CylonEnv(device="cpu")


# --------------------------------------------------- journal semantics
def test_journal_is_write_ahead_of_execution(tmp_path):
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))
    eng.register_query("probe", lambda: [
        e for e in RequestJournal.read(str(tmp_path))
        if e["kind"] == "admit"])
    seen = eng.submit_named("probe", idempotency_key="k1",
                            tenant="a").result(WAIT)
    assert len(seen) == 1
    assert seen[0]["key"] == "k1" and seen[0]["name"] == "probe"
    assert seen[0]["replayable"] is True
    eng.close()
    kinds = [e["kind"] for e in RequestJournal.read(str(tmp_path))]
    assert kinds == ["admit", "done"]


def test_journal_incomplete_and_done_dedup(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.admit(rid=1, key="a", name="q", args=[1], tenant="t")
    j.admit(rid=2, key="b", name="q", args=[2], tenant="t")
    j.admit(rid=3, key=None, name=None, tenant="t")
    j.done(rid=1, key="a", state="done")
    j.close()
    replayable, unreplayable = RequestJournal.incomplete(str(tmp_path))
    assert [e["key"] for e in replayable] == ["b"]
    assert len(unreplayable) == 1 and unreplayable[0]["rid"] == 3


def test_torn_journal_tail_is_skipped(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.admit(rid=1, key="a", name="q", tenant="t")
    j.close()
    with open(os.path.join(str(tmp_path), RequestJournal.FILE), "a") as f:
        f.write('{"kind": "admit", "rid": 2, "key": "b", "na')
    assert [e["rid"] for e in RequestJournal.read(str(tmp_path))] == [1]
    replayable, _ = RequestJournal.incomplete(str(tmp_path))
    assert [e["key"] for e in replayable] == ["a"]


def test_failed_request_is_journaled_done_not_replayed(tmp_path):
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))

    def boom():
        raise InvalidArgument("query bug")

    eng.register_query("boom", boom)
    tk = eng.submit_named("boom", idempotency_key="f1", tenant="a")
    with pytest.raises(InvalidArgument):
        tk.result(WAIT)
    eng.close()
    assert RequestJournal.incomplete(str(tmp_path)) == ([], [])


# ------------------------------------------------------- idempotency
def test_idempotency_key_dedups_live_and_completed(tmp_path):
    calls = []
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))
    eng.register_query("q", lambda x: calls.append(x) or x * 2)
    t1 = eng.submit_named("q", 21, idempotency_key="once", tenant="a")
    assert t1.result(WAIT) == 42
    t2 = eng.submit_named("q", 21, idempotency_key="once", tenant="a")
    assert t2 is t1 and t2.result(WAIT) == 42
    assert calls == [21]
    assert telemetry.counter("serve.idempotent_hits",
                             tenant="a").value == 1
    assert eng.submit_named("q", 1, idempotency_key="twice",
                            tenant="a").result(WAIT) == 2
    assert calls == [21, 1]
    eng.close()


def test_submit_named_requires_registration():
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    with pytest.raises(InvalidArgument, match="register_query"):
        eng.submit_named("ghost")
    eng.close()


# ------------------------------------------------- kill -> recover()
SERVE_CHILD = '''
import sys
import threading

import numpy as np

from cylon_tpu_torch import catalog, resilience
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.serve import ServeEngine, ServePolicy
from cylon_tpu_torch.table import Table

durable = sys.argv[1]
eng = ServeEngine(CylonEnv(device="cpu"), ServePolicy(max_queue=8),
                  durable_dir=durable)
eng.register_table("resident", Table.from_pydict(
    {"k": np.arange(32, dtype=np.int64),
     "v": np.arange(32, dtype=np.float64)}, device="cpu"))


def qsum(scale):
    tab = catalog.get_table("resident")
    return float(tab.column("v").data[:tab.num_rows].sum()) * scale


#: the killing request idles until the main thread has admitted request
#: 3 too, so the kill lands with BOTH incomplete requests journaled
admitted_all = threading.Event()


def qkill(scale):
    admitted_all.wait(30)
    resilience.inject("worker", "kill step")
    return qsum(scale)


eng.register_query("qsum", qsum)
eng.register_query("qkill", qkill)
t1 = eng.submit_named("qsum", 1.0, idempotency_key="req-1", tenant="a")
assert t1.result(60) == float(np.arange(32).sum())
plan = resilience.FaultPlan([resilience.FaultRule.kill("worker")])
t2 = eng.submit_named("qkill", 2.0, idempotency_key="req-2",
                      tenant="a", fault_plan=plan)
t3 = eng.submit_named("qsum", 3.0, idempotency_key="req-3", tenant="b")
admitted_all.set()
t2.result(60)
raise SystemExit("unreachable: the kill never fired")
'''


def test_serve_kill_then_recover_replays_exactly_once(tmp_path):
    """Hard-kill a durable engine mid-request (a child process), then
    ``recover`` here on a CPU env: the table restored, the two
    incomplete journaled requests replayed exactly once each, the
    completed one not re-run, and a second recovery replays nothing."""
    durable = tmp_path / "dur"
    script = tmp_path / "serve_child.py"
    script.write_text(SERVE_CHILD)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, str(script), str(durable)],
                       env=env, cwd=str(REPO), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == KILL_EXIT_CODE, p.stderr[-2000:]
    kinds = [e["kind"] for e in RequestJournal.read(str(durable))]
    assert kinds.count("admit") == 3 and kinds.count("done") == 1

    calls = []

    def qsum(scale):
        calls.append(scale)
        return _vsum(scale)

    telemetry.reset("serve.")
    eng = ServeEngine.recover(str(durable), env=_cpu_env(),
                              queries={"qsum": qsum, "qkill": qsum})
    try:
        rep = eng.recovery_report
        assert rep["restored_tables"] == ["resident"]
        assert catalog.get_table("resident").num_rows == 32
        assert catalog.get_table("resident").device.type == "cpu"
        assert rep["unreplayable"] == []
        assert set(rep["replayed"]) == {"req-2", "req-3"}
        oracle = float(np.arange(32).sum())
        assert rep["replayed"]["req-2"].result(WAIT) == 2.0 * oracle
        assert rep["replayed"]["req-3"].result(WAIT) == 3.0 * oracle
        assert sorted(calls) == [2.0, 3.0]
        assert telemetry.total("serve.journal_replayed") == 2
        assert telemetry.total("serve.recoveries") == 1
        again = eng.submit_named("qsum", 2.0, idempotency_key="req-2",
                                 tenant="a")
        assert again.result(WAIT) == 2.0 * oracle
        assert sorted(calls) == [2.0, 3.0]
        eng.close()
        telemetry.reset("serve.")
        eng2 = ServeEngine.recover(str(durable), env=eng.env,
                                   queries={"qsum": qsum, "qkill": qsum})
        assert eng2.recovery_report["replayed"] == {}
        assert sorted(calls) == [2.0, 3.0]
        eng2.close()
    finally:
        eng.close()


def test_recover_builds_on_cuda_unless_asked(tmp_path, monkeypatch):
    """With no env, ``recover`` builds the port's env on CUDA: without a
    card it refuses instead of dropping to the CPU."""
    eng = ServeEngine(_cpu_env(), ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))
    eng.register_table("resident", _t())
    eng.close()
    catalog.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        ServeEngine.recover(str(tmp_path))
    assert "resident" not in catalog.list_tables()


def test_keyless_replay_does_not_repeat_across_recoveries(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.admit(rid=1, key=None, name="q", args=[5], tenant="t")
    j.close()
    calls = []
    eng = ServeEngine.recover(str(tmp_path), env=_cpu_env(),
                              queries={"q": lambda x: calls.append(x)
                                       or x})
    assert list(eng.recovery_report["replayed"]) == [1]
    assert eng.recovery_report["replayed"][1].result(WAIT) == 5
    eng.close()
    assert calls == [5]
    eng2 = ServeEngine.recover(str(tmp_path), env=_cpu_env(),
                               queries={"q": lambda x: calls.append(x)
                                        or x})
    assert eng2.recovery_report["replayed"] == {}
    assert calls == [5]
    eng2.close()


def test_explicit_unbounded_slo_survives_replay(tmp_path):
    eng = ServeEngine(policy=ServePolicy(max_queue=4, default_slo=30.0),
                      durable_dir=str(tmp_path))
    eng.register_query("q", lambda: 1)
    tk = eng.submit_named("q", idempotency_key="u", tenant="a", slo=0)
    assert tk.result(WAIT) == 1 and tk.slo is None
    eng.close()
    entry = [e for e in RequestJournal.read(str(tmp_path))
             if e["kind"] == "admit"][0]
    assert entry["slo"] == 0


def test_journal_failure_rolls_back_admission(tmp_path):
    catalog.put_table("t", _t())
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))
    eng.register_query("q", lambda: 1)

    def boom(**kw):
        raise OSError("disk full")

    eng._journal.admit = boom
    for _ in range(6):
        with pytest.raises(OSError, match="disk full"):
            eng.submit_named("q", idempotency_key="k", tenant="a",
                             tables=["t"])
    assert eng.live == 0
    assert catalog.pins("t") == {}
    assert "k" not in eng._idem
    eng.close()


def test_recover_reports_unreplayable_without_registry(tmp_path):
    j = RequestJournal(str(tmp_path))
    j.admit(rid=1, key="x", name="mystery", args=[], tenant="t")
    j.close()
    eng = ServeEngine.recover(str(tmp_path), env=_cpu_env(), queries={})
    try:
        rep = eng.recovery_report
        assert rep["replayed"] == {}
        assert [e["key"] for e in rep["unreplayable"]] == ["x"]
        assert telemetry.total("serve.journal_unreplayable") == 1
    finally:
        eng.close()


# ------------------------------------------------- circuit breaker
def test_breaker_sheds_under_deadline_storm_and_drains_inflight():
    eng = ServeEngine(policy=ServePolicy(
        max_queue=16, breaker_fails=3, breaker_window=30.0,
        breaker_cooldown=0.2))
    gate = threading.Event()

    def survivor():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return "drained"

    alive = eng.submit(survivor, tenant="ok")

    def storm():
        raise DeadlineExceeded("wedged card", section="serve_request")

    for _ in range(3):
        with pytest.raises(DeadlineExceeded):
            eng.submit(storm, tenant="noisy").result(WAIT)
    assert eng._admission.breaker.state == "open"
    t0 = time.perf_counter()
    with pytest.raises(ResourceExhausted, match="circuit breaker"):
        eng.submit(lambda: 1, tenant="late")
    assert time.perf_counter() - t0 < 0.5
    assert telemetry.counter("serve.shed", reason="breaker",
                             tenant="late").value == 1
    gate.set()
    assert alive.result(WAIT) == "drained"
    time.sleep(0.25)
    assert eng.submit(lambda: 2, tenant="late").result(WAIT) == 2
    assert eng._admission.breaker.state == "closed"
    eng.close()


def test_breaker_ignores_per_request_bugs_and_resets_on_success():
    eng = ServeEngine(policy=ServePolicy(
        max_queue=16, breaker_fails=2, breaker_window=30.0,
        breaker_cooldown=60.0))

    def bug():
        raise InvalidArgument("caller error")

    def slow():
        raise DeadlineExceeded("one-off", section="serve_request")

    for _ in range(4):
        with pytest.raises(InvalidArgument):
            eng.submit(bug, tenant="a").result(WAIT)
    assert eng._admission.breaker.state == "closed"
    with pytest.raises(DeadlineExceeded):
        eng.submit(slow, tenant="a").result(WAIT)
    assert eng.submit(lambda: 1, tenant="a").result(WAIT) == 1
    with pytest.raises(DeadlineExceeded):
        eng.submit(slow, tenant="a").result(WAIT)
    assert eng._admission.breaker.state == "closed"
    eng.close()


def test_queue_full_shed_reason_counted():
    eng = ServeEngine(policy=ServePolicy(max_queue=1))
    gate = threading.Event()

    def gated():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return 1

    tk = eng.submit(gated, tenant="a")
    with pytest.raises(ResourceExhausted):
        eng.submit(lambda: 2, tenant="b")
    assert telemetry.counter("serve.shed", reason="queue_full",
                             tenant="b").value == 1
    gate.set()
    assert tk.result(WAIT) == 1
    eng.close()


def test_memory_budget_sheds_predicted_overflow():
    eng = ServeEngine(policy=ServePolicy(max_queue=4, memory_budget=1000))
    with pytest.raises(ResourceExhausted, match="memory budget"):
        eng.submit(lambda: 1, tenant="big", predicted_bytes=1001)
    assert telemetry.counter("serve.shed", reason="memory",
                             tenant="big").value == 1
    assert eng.submit(lambda: 2, tenant="small",
                      predicted_bytes=1000).result(WAIT) == 2
    eng.close()


# ------------------------------------- the same events, both packages
def _breaker_sequence(mod):
    """Drive one breaker through a storm, the open state, the half-open
    probe and a re-trip; returns its snapshots, timestamps removed."""
    br = mod.CircuitBreaker(threshold=2, window=0.5, cooldown=0.1)
    snaps = []

    def snap():
        s = dict(br.snapshot())
        s.pop("cooldown_remaining_s")
        snaps.append((br.state, s))

    snap()
    br.record_failure("InvalidArgument")       # never counts
    br.record_failure("DeadlineExceeded")
    snap()
    br.record_success()                        # a success clears it
    snap()
    br.record_failure("DeadlineExceeded")
    br.record_failure("ResourceExhausted")     # trips
    snap()
    snaps.append(("allow", br.allow()))        # open: shed
    time.sleep(0.12)
    snap()                                     # half open
    snaps.append(("allow", br.allow()))        # probes through, closes
    snap()
    return snaps


def test_breaker_snapshots_match_jax():
    from cylon_tpu.serve import admission as jadm

    got = _breaker_sequence(admission)
    assert got == _breaker_sequence(jadm)
    assert [s[0] for s in got if s[0] != "allow"] == [
        "closed", "closed", "closed", "open", "half_open", "closed"]


def _slo_sequence(mod, policy):
    tr = mod.SloTracker(policy)
    out = [tr.enabled, tr.burn_rates(), tr.worst()]
    for tenant, ok, lat in (("a", True, 0.01), ("a", False, 0.01),
                            ("b", True, 0.5), ("b", True, 0.01),
                            ("a", True, 0.02), ("b", False, None)):
        tr.record(tenant, ok=ok, latency_s=lat)
    out += [tr.burn_rates(), tr.worst()]
    return out


def test_slo_tracker_matches_jax():
    from cylon_tpu.serve import admission as jadm
    from cylon_tpu.serve import slo as jslo

    kw = dict(max_queue=4, slo_target=0.9, slo_latency=0.1,
              slo_windows=(0.5, 2.0))
    got = _slo_sequence(slo, admission.ServePolicy(**kw))
    assert got == _slo_sequence(jslo, jadm.ServePolicy(**kw))
    assert got[-1][0] == "b" and got[-1][2] == pytest.approx(20.0 / 3)
    off = _slo_sequence(slo, admission.ServePolicy())
    assert off == _slo_sequence(jslo, jadm.ServePolicy())
    assert off[0] is False and off[-2] == {}


def test_engine_slo_reports_match_jax():
    """The same good and bad retirements through both engines give the
    same ``slo_report`` and burn gauges."""
    import cylon_tpu.telemetry as jtel
    from cylon_tpu.serve import ServeEngine as JEngine
    from cylon_tpu.serve import ServePolicy as JPolicy

    def run(engine_cls, policy_cls, tel, err):
        tel.reset("serve.")
        eng = engine_cls(None, policy_cls(max_queue=4, slo_target=0.99,
                                          slo_windows=(5.0, 30.0)))

        def bad():
            raise err("bad request")

        for fn, tenant in ((lambda: 1, "a"), (bad, "a"), (lambda: 2, "b"),
                           (lambda: 3, "a"), (bad, "b")):
            tk = eng.submit(fn, tenant=tenant)
            tk.wait(WAIT)
        rep = eng.slo_report()
        gauges = {tuple(sorted(l.items())): i.value
                  for _, l, i in tel.instruments("serve.slo_burn")}
        eng.close()
        return rep, gauges

    from cylon_tpu.errors import InvalidArgument as JInvalid

    got = run(ServeEngine, ServePolicy, telemetry, InvalidArgument)
    want = run(JEngine, JPolicy, jtel, JInvalid)
    jtel.reset("serve.")
    assert got == want
    assert got[0]["worst"]["tenant"] == "b"


def test_policy_defaults_and_validation_match_jax(monkeypatch):
    """``default_policy`` is the documented defaults, the JAX package's
    with no ``CYLON_TPU_SERVE_*`` set, and reads no such variable; the
    same bad knobs are refused."""
    from cylon_tpu.serve import admission as jadm

    for var in ("MAX_QUEUE", "SLO", "SCHEDULE", "BREAKER_FAILS",
                "SLO_TARGET", "MEMORY_BUDGET"):
        monkeypatch.delenv(f"CYLON_TPU_SERVE_{var}", raising=False)
    assert vars(admission.default_policy()) == vars(jadm.default_policy())
    monkeypatch.setenv("CYLON_TPU_SERVE_MAX_QUEUE", "3")
    monkeypatch.setenv("CYLON_TPU_SERVE_SCHEDULE", "priority")
    assert admission.default_policy() == admission.ServePolicy()
    for bad in (dict(max_queue=0), dict(schedule="lifo"),
                dict(default_slo=0.0), dict(breaker_fails=-1),
                dict(breaker_cooldown=0.0), dict(memory_budget=-1),
                dict(slo_target=1.0), dict(slo_latency=0.0),
                dict(slo_windows=()), dict(burn_critical=0.0)):
        with pytest.raises(InvalidArgument):
            admission.ServePolicy(**bad)
        with pytest.raises(Exception) as e:
            jadm.ServePolicy(**bad)
        assert type(e.value).__name__ == "InvalidArgument"
