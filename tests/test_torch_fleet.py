"""The port's replicated serve fleet (``cylon_tpu_torch.serve.fleet``)
case for case from ``tests/test_fleet.py``: journal lock and fencing, the
closing-503 probes, the value codec, tenant-affinity routing,
fleet-scoped idempotency dedup and in-process failover with journal
replay, all on CPU engines. Against the JAX package: the codec's
envelopes decode to the same frames, ``_affinity_order`` gives the same
ring for 1,000 tenants, and a string column's ``None`` survives the
codec (the JAX package's codec turns it into NaN under pandas' string
dtype). Every wait takes an explicit timeout; no test sleeps a fixed
time to let something happen."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import Table, catalog, telemetry
from cylon_tpu_torch.errors import (DataLossError, FailedPrecondition,
                                    InvalidArgument)
from cylon_tpu_torch.serve import ServeEngine, ServePolicy, fleet
from cylon_tpu_torch.serve.durability import (JournalLock, RequestJournal,
                                              fence_journal)
from cylon_tpu_torch.serve.fleet import (EngineUnavailable, FleetLayout,
                                         FleetRouter, LocalEngineClient,
                                         _affinity_order, decode_value,
                                         encode_value)

WAIT = 60


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")
    yield
    catalog.clear()
    telemetry.reset("serve.")
    telemetry.reset("fleet.")


def _wait_for(cond, timeout=WAIT):
    """Poll ``cond`` until it holds or ``timeout`` seconds pass."""
    give_up = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > give_up:
            return False
        time.sleep(0.02)
    return True


def _polled(router, timeout=WAIT):
    """Wait until the router has a verdict for every engine: before
    that an unpolled engine ranks below a polled one, and a tenant's
    affinity engine can lose its request to the peer."""
    assert _wait_for(lambda: all(e["status"] != "unknown"
                                 for e in router.engines()), timeout)
    return router


def _gated(gate):
    def q(*args):
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return args[0] * 2 if args else 1
    return q


# ------------------------------------------------- journal lock / fence
def test_second_live_engine_cannot_own_a_journal(tmp_path):
    """Two live engines on ONE durable dir would interleave journal
    lines: the second fails at construction instead."""
    j = RequestJournal(str(tmp_path))
    with pytest.raises(FailedPrecondition, match="owned by a live"):
        RequestJournal(str(tmp_path))
    j.close()
    j2 = RequestJournal(str(tmp_path))  # released: adoptable again
    j2.close()


def test_stale_lock_dead_pid_is_broken_on_acquire(tmp_path):
    """A lock held by a dead pid is stale — the next acquire breaks it."""
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    lock = tmp_path / JournalLock.FILE
    lock.write_text(json.dumps({
        "pid": proc.pid, "host": __import__("socket").gethostname(),
        "owner": "engine", "token": "stale", "acquired": 0}))
    j = RequestJournal(str(tmp_path))  # breaks the stale lock
    j.admit(rid=1, key="k", name="q")
    j.close()


def test_expired_heartbeat_is_stale_when_ttl_armed(tmp_path, monkeypatch):
    """An OTHER-host owner with an expired heartbeat is breakable once
    ``CYLON_TPU_FLEET_LOCK_TTL`` is armed, refused without it; a
    SAME-host owner whose pid is alive is never stale."""
    lock = tmp_path / JournalLock.FILE

    def write_lock(host):
        lock.write_text(json.dumps({
            "pid": os.getpid(), "host": host,
            "owner": "engine", "token": "old", "acquired": 0}))
        old = time.time() - 3600
        os.utime(lock, (old, old))

    write_lock("some-other-host")
    monkeypatch.delenv("CYLON_TPU_FLEET_LOCK_TTL", raising=False)
    with pytest.raises(FailedPrecondition):
        JournalLock(str(tmp_path)).acquire()
    monkeypatch.setenv("CYLON_TPU_FLEET_LOCK_TTL", "10")
    lk = JournalLock(str(tmp_path)).acquire()
    lk.release()
    write_lock(__import__("socket").gethostname())
    with pytest.raises(FailedPrecondition):
        JournalLock(str(tmp_path)).acquire()


def test_fence_blocks_owner_appends_but_not_adoption(tmp_path):
    """``fence_journal`` replaces the lock token: the fenced owner's
    next append raises, while a NEW engine adopts the dir."""
    j = RequestJournal(str(tmp_path))
    j.admit(rid=1, key="a", name="q")
    fence_journal(str(tmp_path), owner="router:test")
    with pytest.raises(FailedPrecondition, match="FENCED"):
        j.admit(rid=2, key="b", name="q")
    j.close()
    assert (tmp_path / JournalLock.FILE).exists()  # fence survives
    j2 = RequestJournal(str(tmp_path))  # adoption breaks the fence
    j2.admit(rid=3, key="c", name="q")
    j2.close()
    keys = [e.get("key") for e in RequestJournal.read(str(tmp_path))]
    assert keys == ["a", "c"]


def test_fenced_engine_retires_locally_without_journaling(tmp_path):
    """A live engine whose journal gets fenced mid-flight still retires
    its request (the local client gets the answer); only the done line
    is suppressed."""
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=str(tmp_path))
    gate = threading.Event()
    eng.register_query("g", _gated(gate))
    try:
        tk = eng.submit_named("g", 7, idempotency_key="k", tenant="a")
        fence_journal(str(tmp_path), owner="router:test")
        gate.set()
        assert tk.result(WAIT) == 14
        done = [e for e in RequestJournal.read(str(tmp_path))
                if e["kind"] == "done"]
        assert done == []
    finally:
        gate.set()
        eng.close()


def test_health_probes_return_503_closing_during_drain(monkeypatch):
    """``/health`` and ``/healthz`` polled while ``close()`` drains
    answer a clean 503 ``{"status": "closing"}``."""
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    base = "http://%s:%d" % eng.http_address
    gate = threading.Event()
    tk = eng.submit(_gated(gate), tenant="a")
    closer = threading.Thread(target=lambda: eng.close(wait=True))
    closer.start()
    codes = set()

    def probed():
        for path in ("/healthz", "/health"):
            try:
                with urllib.request.urlopen(base + path, timeout=5) as r:
                    codes.add((path, r.status))
            except urllib.error.HTTPError as e:
                assert e.code == 503, (path, e.code)
                assert json.loads(e.read())["status"] == "closing"
                codes.add((path, 503))
        return {("/healthz", 503), ("/health", 503)} <= codes

    try:
        assert _wait_for(probed, 10), codes
    finally:
        gate.set()
        closer.join(WAIT)
    assert tk.result(WAIT) == 1  # the drain completed the request


# ------------------------------------------------- value codec
def _codec_frame():
    return pd.DataFrame({
        "i": np.asarray([1, 2, 3], dtype=np.int64),
        "f": np.asarray([1.5, float("nan"), float("inf")]),
        "s": ["a", "b", None],
        "b": [b"\x00\xff", b"ok", None],
        "d": np.asarray(["2024-01-01", "2024-06-01", "2024-12-31"],
                        dtype="datetime64[ns]"),
    })


def test_value_codec_round_trips_frames_scalars_bytes():
    """Strict JSON end to end; non-finite floats exact; a string
    column's None stays None whatever pandas' string dtype reads it as;
    bytes, datetimes, scalars and arrays round-trip."""
    df = _codec_frame()
    back = decode_value(json.loads(json.dumps(encode_value(df),
                                              allow_nan=False)))
    assert list(back.columns) == list(df.columns)
    assert back["i"].tolist() == [1, 2, 3]
    assert back["f"][0] == 1.5 and np.isnan(back["f"][1])
    assert back["f"][2] == float("inf")
    assert back["s"].tolist() == ["a", "b", None]
    assert back["b"].tolist() == [b"\x00\xff", b"ok", None]
    assert back["d"].astype("int64").tolist() == \
        df["d"].astype("int64").tolist()
    assert decode_value(json.loads(json.dumps(
        encode_value(3.75)))) == 3.75
    arr = decode_value(json.loads(json.dumps(
        encode_value(np.asarray([1.0, 2.0])))))
    assert arr.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("col", [
    pd.array(["x", None, "z"], dtype="string"),
    pd.Series(["x", pd.NA, "z"], dtype=object),
    pd.Series(["x", float("nan"), "z"], dtype=object),
    np.asarray(["x", None, "z"], dtype=object),
], ids=["string_dtype", "object_na", "object_nan", "numpy_object"])
def test_codec_missing_string_values_decode_as_none(col):
    """Every spelling of a missing string (None, ``pd.NA``, NaN, under
    the string dtype or object) crosses the codec as None."""
    back = decode_value(json.loads(json.dumps(
        encode_value(pd.DataFrame({"s": col})), allow_nan=False)))
    assert back["s"].tolist() == ["x", None, "z"]


@pytest.mark.parametrize("dtype,vals", [
    ("Int64", [1, None, 3]), ("Float64", [1.5, None, 2.5]),
    ("boolean", [True, None, False])])
def test_codec_keeps_nullable_dtypes(dtype, vals):
    """A nullable number or boolean column keeps its pandas dtype and
    its missing values."""
    df = pd.DataFrame({"c": pd.array(vals, dtype=dtype)})
    back = decode_value(json.loads(json.dumps(encode_value(df),
                                              allow_nan=False)))
    assert str(back["c"].dtype) == dtype
    assert back["c"].isna().tolist() == [v is None for v in vals]
    assert back.equals(df)


def test_codec_numeric_frames_decode_as_the_jax_envelopes():
    """For numeric frames (seeded) the port's envelope decodes to the
    frame the JAX package's envelope decodes to, bit for bit."""
    from cylon_tpu.serve import fleet as jfleet

    rng = np.random.default_rng(5)
    df = pd.DataFrame({
        "k": rng.integers(-5, 5, 64).astype(np.int64),
        "i32": rng.integers(0, 9, 64).astype(np.int32),
        "v": rng.normal(size=64),
        "f32": rng.normal(size=64).astype(np.float32),
        "flag": rng.integers(0, 2, 64).astype(bool),
        "d": (np.datetime64("2024-01-01")
              + rng.integers(0, 365, 64).astype("timedelta64[D]")
              ).astype("datetime64[ns]")})
    df.loc[3, "v"] = np.nan
    df.loc[4, "v"] = -np.inf
    ours = decode_value(json.loads(json.dumps(encode_value(df))))
    theirs = jfleet.decode_value(json.loads(json.dumps(
        jfleet.encode_value(df))))
    assert encode_value(df) == jfleet.encode_value(df)
    pd.testing.assert_frame_equal(ours, theirs)
    pd.testing.assert_frame_equal(ours, df)
    for v in (3.75, 7, np.float64(2.5), np.asarray([1.0, np.inf])):
        a = decode_value(json.loads(json.dumps(encode_value(v))))
        b = jfleet.decode_value(json.loads(json.dumps(
            jfleet.encode_value(v))))
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("value", [float("nan"), np.float64("nan")],
                         ids=["float", "np_float64"])
def test_codec_nan_scalar_stays_nan_as_in_the_jax_codec(value):
    """A NaN scalar (the median of no valid row) crosses the codec as
    NaN, not as a missing value, as the JAX package's codec gives."""
    from cylon_tpu.serve import fleet as jfleet

    ours = decode_value(json.loads(json.dumps(encode_value(value),
                                              allow_nan=False)))
    theirs = jfleet.decode_value(json.loads(json.dumps(
        jfleet.encode_value(value), allow_nan=False)))
    assert isinstance(ours, float) and np.isnan(ours)
    assert isinstance(theirs, float) and np.isnan(theirs)


def test_router_delivers_a_nan_scalar_as_its_alone_run(tmp_path):
    """A query whose answer is a NaN scalar, routed through an
    in-process FleetRouter, equals the same query run alone."""
    import cylon_tpu_torch as ct

    def median_of_nothing():
        df = ct.DataFrame({"v": np.array([np.nan, np.nan, np.nan])},
                          device="cpu")
        return df.median()["v"]

    alone = median_of_nothing()
    assert np.isnan(alone)
    lay = FleetLayout(str(tmp_path))
    engines = {n: ServeEngine(policy=ServePolicy(max_queue=16),
                              durable_dir=lay.engine_dir(n))
               for n in ("a0", "a1")}
    for eng in engines.values():
        eng.register_query("m", median_of_nothing)
    router = _polled(FleetRouter(
        [LocalEngineClient(e, n) for n, e in engines.items()],
        poll_interval=0.1, fail_threshold=2, unhealthy_dwell=1.0))
    try:
        got = router.submit("m", tenant="alice",
                            idempotency_key="nan").result(WAIT)
        assert got is not None and np.isnan(got)
        assert np.array_equal(np.asarray(got), np.asarray(alone),
                              equal_nan=True)
    finally:
        router.close()
        for e in engines.values():
            e.close()


# ------------------------------------------------- affinity
def test_affinity_order_is_stable_and_spreads():
    names = ["e0", "e1", "e2"]
    assert _affinity_order("alice", names) == \
        _affinity_order("alice", names)
    assert sorted(_affinity_order("alice", names)) == sorted(names)
    starts = {_affinity_order(f"tenant{i}", names)[0] for i in range(64)}
    assert starts == set(names)


@pytest.mark.parametrize("names", [["e0", "e1"], ["e2", "e0", "e1"]],
                         ids=["two", "three"])
def test_affinity_order_equals_the_jax_ring(names):
    """1,000 tenants over 2 and 3 engines: the same ring as the JAX
    package's, so a mixed fleet places a tenant alike."""
    from cylon_tpu.serve.fleet import _affinity_order as jorder

    for i in range(1000):
        t = f"tenant{i}"
        assert _affinity_order(t, names) == jorder(t, names), t


# ------------------------------------------------- routing and failover
def _mk_local_fleet(tmp_path, record_execs=None):
    """Two in-process engines over one FleetLayout tree, each with a
    'q' query that records which engine executed it."""
    lay = FleetLayout(str(tmp_path))
    engines, clients = {}, []
    for name in ("a0", "a1"):
        eng = ServeEngine(policy=ServePolicy(max_queue=16),
                          durable_dir=lay.engine_dir(name))

        def mk(n):
            def q(x):
                if record_execs is not None:
                    record_execs.append((n, x))
                return x * 2
            return q

        eng.register_query("q", mk(name))
        engines[name] = eng
        clients.append(LocalEngineClient(eng, name))
    return lay, engines, clients


def _tenant_on(first: str, names=("a0", "a1")) -> str:
    return next(t for t in (f"t{i}" for i in range(64))
                if _affinity_order(t, list(names))[0] == first)


def test_router_routes_by_affinity_and_dedups(tmp_path):
    execs = []
    lay, engines, clients = _mk_local_fleet(tmp_path, execs)
    router = _polled(FleetRouter(clients, poll_interval=0.1,
                                 fail_threshold=2, unhealthy_dwell=1.0))
    try:
        t1 = router.submit("q", 21, tenant="alice", idempotency_key="k1")
        assert t1.result(WAIT) == 42
        expected = _affinity_order("alice", ["a0", "a1"])[0]
        assert t1.engine == expected
        assert telemetry.counter("fleet.routed", engine=expected,
                                 tenant="alice").value == 1
        # fleet-scoped dedup: same key → same ticket, no execution
        t2 = router.submit("q", 21, tenant="alice", idempotency_key="k1")
        assert t2 is t1 and t2.result(WAIT) == 42
        assert execs == [(expected, 21)]
        assert telemetry.total("fleet.deduped") == 1
    finally:
        router.close()
        for e in engines.values():
            e.close()


class _MortalClient(LocalEngineClient):
    """A LocalEngineClient with a kill switch: once dead, every call
    raises EngineUnavailable — an in-process stand-in for a killed
    engine process."""

    def __init__(self, engine, name):
        super().__init__(engine, name)
        self.dead = threading.Event()

    def _check(self):
        if self.dead.is_set():
            raise EngineUnavailable(
                f"engine {self.name!r} is (simulated) dead")

    def submit(self, *a, **kw):
        self._check()
        return super().submit(*a, **kw)

    def result(self, *a, **kw):
        self._check()
        return super().result(*a, **kw)

    def health(self):
        self._check()
        return super().health()


def test_failover_replays_incomplete_on_peer_exactly_once(tmp_path):
    """An acknowledged, journaled-but-incomplete request on a 'dead'
    engine is fenced, replayed on the peer under its ORIGINAL key, and
    the blocked ticket delivers the peer's answer: exactly once, zero
    lost acks, the zombie's late completion fenced out of the journal
    and a client retry deduped."""
    lay = FleetLayout(str(tmp_path))
    execs = []
    gate = threading.Event()
    e0 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a1"))

    def fast_q(x):
        execs.append(("a1", x))
        return x * 2

    e0.register_query("q", _gated(gate))
    e1.register_query("q", fast_q)
    c0, c1 = _MortalClient(e0, "a0"), _MortalClient(e1, "a1")
    tenant = _tenant_on("a0")
    router = _polled(FleetRouter([c0, c1], poll_interval=0.05,
                                 fail_threshold=2, unhealthy_dwell=1.0))
    try:
        tk = router.submit("q", 21, tenant=tenant, idempotency_key="K")
        assert tk.engine == "a0"
        zombie = e0.ticket(tk.rid)
        assert [e["key"] for e in
                RequestJournal.incomplete(lay.engine_dir("a0"))[0]] \
            == ["K"]
        c0.dead.set()  # the engine "dies" with the request in flight
        assert tk.result(WAIT) == 42
        assert tk.engine == "a1"
        assert execs == [("a1", 21)]
        assert telemetry.total("fleet.failovers") == 1
        assert telemetry.total("fleet.replayed") == 1
        assert telemetry.total("fleet.lost_acks") == 0
        # the zombie retires on a0, but its journal is fenced
        gate.set()
        assert zombie.wait(WAIT) and zombie.done
        assert [e for e in RequestJournal.read(lay.engine_dir("a0"))
                if e["kind"] == "done"] == []
        t2 = router.submit("q", 21, tenant=tenant, idempotency_key="K")
        assert t2 is tk and t2.result(WAIT) == 42
        assert execs == [("a1", 21)]  # never double-executed
        done_all = [e for n in ("a0", "a1") for e in
                    RequestJournal.read(lay.engine_dir(n))
                    if e["kind"] == "done" and e.get("state") == "done"
                    and e.get("key") == "K"]
        assert len(done_all) == 1
    finally:
        gate.set()
        router.close()
        e0.close()
        e1.close()


def test_unhealthy_dwell_triggers_failover(tmp_path):
    """An engine that stays closing past the dwell is failed over even
    though it still answers."""
    lay = FleetLayout(str(tmp_path))
    e0 = ServeEngine(policy=ServePolicy(max_queue=4),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=4),
                     durable_dir=lay.engine_dir("a1"))
    for e in (e0, e1):
        e.register_query("q", lambda: 1)
    router = FleetRouter([LocalEngineClient(e0, "a0"),
                          LocalEngineClient(e1, "a1")],
                         poll_interval=0.05, fail_threshold=99,
                         unhealthy_dwell=0.2)
    try:
        e0.close()  # now its health reports {"status": "closing"}
        assert _wait_for(lambda: telemetry.total("fleet.failovers") >= 1,
                         10)
        assert telemetry.total("fleet.failovers") == 1
        assert [s["name"] for s in router.engines() if s["dead"]] == \
            ["a0"]
        assert router.submit("q", tenant="x").result(WAIT) == 1
    finally:
        router.close()
        e1.close()


def test_no_surviving_peer_counts_lost_acks(tmp_path):
    """A fleet of one: the only engine dies with an acknowledged
    request in flight — the ticket is LOST, loudly, never a hang."""
    lay = FleetLayout(str(tmp_path))
    eng = ServeEngine(policy=ServePolicy(max_queue=4),
                      durable_dir=lay.engine_dir("solo"))
    gate = threading.Event()
    eng.register_query("q", _gated(gate))
    c = _MortalClient(eng, "solo")
    router = FleetRouter([c], poll_interval=0.05, fail_threshold=2,
                         unhealthy_dwell=1.0)
    try:
        tk = router.submit("q", tenant="t", idempotency_key="K")
        c.dead.set()
        with pytest.raises(DataLossError, match="LOST"):
            tk.result(WAIT)
        assert telemetry.total("fleet.lost_acks") >= 1
    finally:
        gate.set()
        router.close()
        eng.close()


def test_shared_snapshot_store_concurrent_init_is_safe(tmp_path):
    """Eight constructions of the SHARED snapshot store at once on a
    fresh dir: the init mutex serializes them, none raises."""
    from cylon_tpu_torch.serve.durability import CatalogSnapshot

    errors = []
    barrier = threading.Barrier(8)

    def build():
        try:
            barrier.wait(10)
            CatalogSnapshot(str(tmp_path))
        except Exception as e:  # noqa: BLE001 - collected for assert
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert errors == [], errors
    snap = CatalogSnapshot(str(tmp_path))
    assert snap.tables == []
    assert not os.path.exists(os.path.join(snap.root,
                                           CatalogSnapshot.INIT_LOCK))


def test_submit_reroutes_on_connection_refusal(tmp_path):
    """A submit whose affinity engine refuses (closing: nothing was
    admitted) walks the ring to the peer."""
    lay = FleetLayout(str(tmp_path))
    e0 = ServeEngine(policy=ServePolicy(max_queue=4),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=4),
                     durable_dir=lay.engine_dir("a1"))
    execs = []
    e0.register_query("q", lambda: execs.append("a0") or 0)
    e1.register_query("q", lambda: execs.append("a1") or 1)
    router = FleetRouter(
        [LocalEngineClient(e0, "a0"), LocalEngineClient(e1, "a1")],
        poll_interval=5.0, fail_threshold=99, unhealthy_dwell=99.0,
        start=False)
    try:
        e0.close()
        tk = router.submit("q", tenant=_tenant_on("a0"),
                           idempotency_key="K")
        assert tk.result(WAIT) == 1 and tk.engine == "a1"
        assert execs == ["a1"]
    finally:
        router.close()
        e1.close()


def test_router_refuses_duplicate_engine_names(tmp_path):
    eng = ServeEngine(policy=ServePolicy(max_queue=4))
    try:
        with pytest.raises(InvalidArgument, match="unique"):
            FleetRouter([LocalEngineClient(eng, "x"),
                         LocalEngineClient(eng, "x")], start=False)
    finally:
        eng.close()


# ------------------------------------------- dedup across the fleet
def _put_shared(n=8):
    catalog.put_table("shared", Table.from_pydict({
        "k": np.arange(n, dtype=np.int64),
        "v": np.arange(n, dtype=np.float64)}, device="cpu"))


def test_killed_leader_followers_rerun_on_peer_zero_lost_acks(tmp_path):
    """Three identical in-flight requests coalesce engine-side (one
    leader, two followers, each journaled). The leader's engine dies:
    failover replays all three keys on the peer, 0 lost acks."""
    lay = FleetLayout(str(tmp_path))
    _put_shared()
    gate = threading.Event()
    execs = []
    e0 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a1"))

    def fast(x):
        execs.append(("a1", x))
        return x * 2

    e0.register_query("q", _gated(gate), tables=("shared",))
    e1.register_query("q", fast, tables=("shared",))
    c0, c1 = _MortalClient(e0, "a0"), _MortalClient(e1, "a1")
    tenant = _tenant_on("a0")
    router = _polled(FleetRouter([c0, c1], poll_interval=0.05,
                                 fail_threshold=2, unhealthy_dwell=1.0))
    try:
        tks = [router.submit("q", 21, tenant=tenant,
                             idempotency_key=f"K{i}") for i in range(3)]
        assert telemetry.total("serve.coalesced") == 2
        inc, _ = RequestJournal.incomplete(lay.engine_dir("a0"))
        assert sorted(e["key"] for e in inc) == ["K0", "K1", "K2"]
        c0.dead.set()
        assert [tk.result(WAIT) for tk in tks] == [42, 42, 42]
        assert {tk.engine for tk in tks} == {"a1"}
        assert telemetry.total("fleet.lost_acks") == 0
        assert telemetry.total("fleet.replayed") == 3
        assert execs and set(execs) == {("a1", 21)}
    finally:
        gate.set()
        router.close()
        e0.close()
        e1.close()


def test_router_cache_survives_engine_death(tmp_path):
    """The router learns the (fingerprint, version vector) key from the
    done reply and serves repeats from ITS cache — even after the origin
    engine dies; an append invalidates precisely and the recompute runs
    on the survivor."""
    lay = FleetLayout(str(tmp_path))
    _put_shared()
    execs = []
    e0 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a1"))

    def mk(n):
        def q(x):
            execs.append((n, x))
            return x * 2
        return q

    e0.register_query("q", mk("a0"), tables=("shared",))
    e1.register_query("q", mk("a1"), tables=("shared",))
    c0, c1 = _MortalClient(e0, "a0"), _MortalClient(e1, "a1")
    tenant = _tenant_on("a0")
    router = _polled(FleetRouter([c0, c1], poll_interval=0.05,
                                 fail_threshold=2, unhealthy_dwell=1.0))
    try:
        t1 = router.submit("q", 21, tenant=tenant)
        assert t1.result(WAIT) == 42 and t1.engine == "a0"
        assert execs == [("a0", 21)]
        c0.dead.set()
        t2 = router.submit("q", 21, tenant=tenant)
        assert t2.result(WAIT) == 42
        assert execs == [("a0", 21)]  # served by the ROUTER's cache
        assert telemetry.total("fleet.result_cache_hits") == 1
        assert _wait_for(lambda: router._is_dead("a0"), 15)
        catalog.append("shared", {
            "k": np.asarray([100], dtype=np.int64),
            "v": np.asarray([1.0], dtype=np.float64)})
        t3 = router.submit("q", 21, tenant=tenant)
        assert t3.result(WAIT) == 42
        assert execs == [("a0", 21), ("a1", 21)]
        assert telemetry.total("fleet.result_cache_invalidations") >= 1
    finally:
        router.close()
        e0.close()
        e1.close()


def test_router_cache_bytes_switches_one_router(tmp_path):
    """``cache_bytes=0`` turns one router's result cache off, so a
    repeat reaches an engine; a router built after it with the default
    budget serves the repeat from its own cache."""
    _put_shared()
    eng = ServeEngine(policy=ServePolicy(max_queue=16))
    eng.register_query("q", lambda x: x * 2, tables=("shared",))
    hits = []
    for budget in (0, fleet.ROUTER_CACHE_BYTES):
        router = _polled(FleetRouter([LocalEngineClient(eng, "a0")],
                                     poll_interval=0.05,
                                     cache_bytes=budget))
        try:
            for _ in range(2):
                assert router.submit("q", 21, tenant="t").result(WAIT) \
                    == 42
            hits.append(telemetry.total("fleet.result_cache_hits"))
        finally:
            router.close()
    eng.close()
    assert hits == [0, 1]
    assert fleet.ROUTER_CACHE_BYTES > 0


class _DyingClient(_MortalClient):
    """Dies DURING a submit: the connection breaks mid-request, after the
    engine admitted it (``admitted=True``) or before — the ambiguous
    case, which is not a refusal."""

    def __init__(self, engine, name, admitted):
        super().__init__(engine, name)
        self.admitted = admitted

    def submit(self, *a, **kw):
        self._check()
        if self.admitted:
            LocalEngineClient.submit(self, *a, **kw)
        self.dead.set()
        raise EngineUnavailable(f"engine {self.name!r} reset mid-submit")


@pytest.mark.parametrize("admitted", [True, False],
                         ids=["admitted", "not_admitted"])
def test_submit_broken_mid_request_waits_for_the_failover(tmp_path,
                                                         admitted):
    """A submit whose connection breaks mid-request may or may not have
    been admitted. The router waits for the engine's failover: an admit
    the dead engine journaled is replayed on the peer and re-points the
    ticket; a key it never admitted re-routes. Either way the client gets
    the answer, executed exactly once on the peer."""
    lay = FleetLayout(str(tmp_path))
    gate = threading.Event()
    execs = []
    e0 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a0"))
    e1 = ServeEngine(policy=ServePolicy(max_queue=16),
                     durable_dir=lay.engine_dir("a1"))

    def fast(x):
        execs.append(("a1", x))
        return x * 2

    e0.register_query("q", _gated(gate))
    e1.register_query("q", fast)
    c0 = _DyingClient(e0, "a0", admitted)
    router = _polled(FleetRouter([c0, _MortalClient(e1, "a1")],
                                 poll_interval=0.05, fail_threshold=2,
                                 unhealthy_dwell=1.0))
    try:
        tk = router.submit("q", 21, tenant=_tenant_on("a0"),
                           idempotency_key="K")
        assert tk.result(WAIT) == 42 and tk.engine == "a1"
        assert execs == [("a1", 21)]
        assert telemetry.total("fleet.failovers") == 1
        assert telemetry.total("fleet.lost_acks") == 0
        assert telemetry.total("fleet.replayed") == (1 if admitted else 0)
    finally:
        gate.set()
        router.close()
        e0.close()
        e1.close()
