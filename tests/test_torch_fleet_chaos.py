"""Fleet chaos at test scale (port of ``tests/test_fleet_chaos.py``):
two REAL engine processes (``--device cpu``, SF 0.001, mix q1 / q6 /
q14) over one durable tree, one hard-killed mid-run at its second
``plan`` dispatch (exit 43), the router failing over. The survivor raises
an injected ``MemoryError`` from its first dispatch on, so every
completion — the replayed ones included — degrades through its
registered spill fallback (q14's two-phase plan recomputes its merge
scalar there). Proven: the child died at the seeded point, every
acknowledged ticket equals its in-process oracle, the dead engine's
unresolved requests replayed on the peer exactly once (the cross-journal
audit finds 0 doubles), an idempotent retry after the failover dedups,
and the replayed q14 shows ``merge_phase`` in the survivor's journal and
no done line in the victim's. Every wait has an explicit timeout and
every child is ended in a ``finally``; the test takes about 10 s."""

import concurrent.futures as cf
import json
import os
import time

import pytest

from cylon_tpu_torch import telemetry, tpch
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.resilience import KILL_EXIT_CODE
from cylon_tpu_torch.serve.bench import (_materialize, _mix_keep,
                                         _mk_resident, _results_match)
from cylon_tpu_torch.serve.durability import RequestJournal
from cylon_tpu_torch.serve.fleet import (FleetLayout, FleetRouter,
                                         _affinity_order,
                                         audit_double_executions,
                                         spawn_engine)

MIX = ("q1", "q6", "q14")  # q14: two-phase global aggregate
#: e0's q1s, then its q14s, then its q6s: its second q1 is answered
#: without a dispatch (coalesced, or a result-cache hit), so its second
#: dispatch, the kill, is a q14 it acknowledged and had not completed,
#: however fast the victim runs beside the submissions
SUBMIT_ORDER = ("q1", "q14", "q6")
SF, SEED = 0.001, 0
READY_S = 120
RESULT_S = 120
#: the children's tables are tiny: one CPU thread each keeps the test
#: light on a shared host
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset("fleet.")
    yield
    telemetry.reset("fleet.")


def _oracles():
    env = CylonEnv(device="cpu")
    resident = _mk_resident(env, tpch.generate(SF, SEED,
                                               keep=_mix_keep(MIX)))
    return {q: _materialize(tpch.compiled(q)(resident, env=env))
            for q in MIX}


def _tenants_for(victim: str, survivor: str, n_each: int):
    """Deterministic tenants whose affinity ring starts at each engine,
    so the victim provably serves traffic before it dies."""
    names = sorted((victim, survivor))
    out = {victim: [], survivor: []}
    i = 0
    while any(len(v) < n_each for v in out.values()):
        t = f"tenant{i}"
        first = _affinity_order(t, names)[0]
        if len(out[first]) < n_each:
            out[first].append(t)
        i += 1
    return out


def test_kill_one_engine_mid_tpch_run_loses_nothing(tmp_path):
    oracles = _oracles()
    root = str(tmp_path / "fleet")
    procs = []
    router = None
    try:
        with cf.ThreadPoolExecutor(2) as ex:
            f0 = ex.submit(spawn_engine, root, "e0", SF, SEED, MIX,
                           ONE_THREAD, READY_S, device="cpu",
                           chaos_kill="plan:2")
            f1 = ex.submit(spawn_engine, root, "e1", SF, SEED, MIX,
                           ONE_THREAD, READY_S, device="cpu",
                           chaos_oom="plan:1")
            for f in (f0, f1):
                procs.append(f.result(READY_S + 30))
        p0, p1 = procs
        assert p0.ready["device"] == p1.ready["device"] == "cpu"
        router = FleetRouter([p0.client, p1.client], poll_interval=0.2,
                             fail_threshold=3, unhealthy_dwell=2.0)
        # both engines polled first: an unpolled engine ranks below a
        # polled one and would lose its tenants to the peer
        give_up = time.monotonic() + 60
        while any(e["status"] == "unknown" for e in router.engines()):
            assert time.monotonic() < give_up
            time.sleep(0.02)
        tenants = _tenants_for("e0", "e1", 2)
        tickets = []  # (key, query, ticket)
        k = 0
        # each tenant submits one of each mix query, so e0 sees >= 2
        # dispatches (the second kills it) with acknowledged work queued
        for q in SUBMIT_ORDER:
            for t in tenants["e0"] + tenants["e1"]:
                key = f"key{k}"
                tickets.append((key, q, router.submit(
                    q, tenant=t, idempotency_key=key)))
                k += 1
        mismatches = [key for key, q, tk in tickets
                      if not _results_match(tk.result(RESULT_S),
                                            oracles[q])]
        assert mismatches == []

        # the child died AT the seeded kill point
        assert p0.proc.wait(60) == KILL_EXIT_CODE
        with open(p0.log_path) as f:
            assert "injected HARD KILL" in f.read()
        assert p0.launches() is None  # no clean close, no launch line

        rep = router.report()
        assert telemetry.total("fleet.failovers") == 1
        assert telemetry.total("fleet.lost_acks") == 0
        assert telemetry.total("fleet.replayed") >= 1
        assert rep["failovers"][0]["engine"] == "e0"

        # an idempotent retry AFTER the failover dedups
        key0, q0, tk0 = tickets[0]
        again = router.submit(q0, tenant=tenants["e0"][0],
                              idempotency_key=key0)
        assert again is tk0
        assert _results_match(again.result(30), oracles[q0])
        assert telemetry.total("fleet.deduped") >= 1

        lay = FleetLayout(root)
        doubles, detail = audit_double_executions(lay,
                                                  rep["replayed_keys"])
        assert doubles == 0, detail
        with open(os.path.join(lay.engine_dir("e0"),
                               "journal.lock")) as f:
            lock = json.load(f)
        assert lock.get("fenced") is True
        assert lock["owner"].startswith("router:")

        done_e1 = {e.get("key") for e in
                   RequestJournal.read(lay.engine_dir("e1"))
                   if e["kind"] == "done" and e.get("state") == "done"}
        for rk in rep["replayed_keys"]:
            assert rk in done_e1, (rk, done_e1)

        # a replayed TWO-PHASE request recomputed its merge scalar on
        # the survivor: e0 died at its 2nd dispatch, a q14 it had
        # journaled and not completed (SUBMIT_ORDER)
        key_q = {key: q for key, q, _ in tickets}
        replayed_q14 = [k for k in rep["replayed_keys"]
                        if key_q.get(k) == "q14"]
        assert replayed_q14, (rep["replayed_keys"], key_q)
        done_e0 = {e.get("key") for e in
                   RequestJournal.read(lay.engine_dir("e0"))
                   if e["kind"] == "done" and e.get("state") == "done"}
        assert not set(replayed_q14) & done_e0
        merge_evts = [e for e in p1.client.events_since(0)["events"]
                      if e["kind"] == "merge_phase"
                      and e.get("op") == "q14"]
        q14_done_e1 = [k for k in done_e1 if key_q.get(k) == "q14"]
        assert set(replayed_q14) <= set(q14_done_e1)
        assert len(q14_done_e1) >= 1 and len(merge_evts) >= 1
        # every completion on the survivor degraded through its fallback
        degraded = [e for e in p1.client.events_since(0)["events"]
                    if e["kind"] == "degraded"]
        assert degraded

        router.close()
        router = None
        assert p1.terminate(60) == 0
        assert p1.launches() is not None  # the clean close logged them
    finally:
        if router is not None:
            router.close()
        for p in procs:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait(30)
