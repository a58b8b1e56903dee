"""The port's ops endpoint (``cylon_tpu_torch.serve.introspect``) case for
case from ``tests/test_introspect.py``: no socket and no thread unless
``CYLON_TPU_SERVE_HTTP_PORT`` arms it, live endpoints during requests, a
startup failure that degrades without killing the engine, the profile
opt-out, and a 500 that does not kill the server thread. For the same
engine states ``health_verdict``'s status, score and reason kinds equal
the JAX package's; without a card the memory component is skipped."""

import ast
import json
import pathlib
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cylon_tpu_torch import Table, catalog, telemetry
from cylon_tpu_torch.errors import DeadlineExceeded
from cylon_tpu_torch.serve import ServeEngine, ServePolicy, introspect
from cylon_tpu_torch.telemetry import profile as prof_mod

WAIT = 30


@pytest.fixture(autouse=True)
def _clean():
    catalog.clear()
    telemetry.reset("serve.")
    yield
    catalog.clear()
    telemetry.reset("serve.")


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _get_json(url):
    status, ctype, body = _get(url)
    assert status == 200 and ctype.startswith("application/json")
    return json.loads(body)


def _gated(gate):
    def run():
        while not gate.is_set():
            yield
            time.sleep(0.001)
        return "done"
    return run


def test_unarmed_engine_creates_no_socket_or_thread(monkeypatch):
    monkeypatch.delenv("CYLON_TPU_SERVE_HTTP_PORT", raising=False)
    before = set(threading.enumerate())
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    assert eng._http is None and eng.http_address is None
    assert set(threading.enumerate()) == before
    assert eng.submit(lambda: 1, tenant="a").result(WAIT) == 1
    assert not any(t.name == "cylon-serve-introspect"
                   for t in threading.enumerate())
    eng.close()


def test_endpoints_serve_live_state_during_requests(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    catalog.put_table("resident", Table.from_pydict(
        {"k": np.arange(16, dtype=np.int64)}, device="cpu"))
    eng = ServeEngine(policy=ServePolicy(max_queue=8))
    assert any(t.name == "cylon-serve-introspect"
               for t in threading.enumerate())
    host, port = eng.http_address
    assert host == "127.0.0.1"
    base = f"http://{host}:{port}"
    gate = threading.Event()
    t1 = eng.submit(_gated(gate), tenant="alice", slo=60.0,
                    tables=["resident"])
    t2 = eng.submit(_gated(gate), tenant="bob")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        qs = _get_json(base + "/queries")["queries"]
        if len(qs) == 2:
            break
        time.sleep(0.01)
    assert {q["tenant"] for q in qs} == {"alice", "bob"}
    alice = next(q for q in qs if q["tenant"] == "alice")
    assert alice["state"] in ("queued", "running")
    assert alice["elapsed_s"] >= 0
    assert alice["remaining_slo_s"] is not None \
        and alice["remaining_slo_s"] <= 60.0
    assert next(q for q in qs if q["tenant"] == "bob")[
        "remaining_slo_s"] is None
    h = _get_json(base + "/healthz")
    assert h["status"] == "ok" and h["live"] == 2 and h["uptime_s"] > 0
    assert h["breaker"]["state"] == "closed"
    tables = _get_json(base + "/tables")
    assert tables["resident"]["rows"] == 16
    assert tables["resident"]["pins"] == 1
    assert tables["resident"]["bytes_by_device"] == {
        "cpu:0": tables["resident"]["bytes"]}
    status, ctype, body = _get(base + "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert "cylon_serve_requests" in text and "# TYPE" in text
    gate.set()
    assert t1.result(WAIT) == "done" and t2.result(WAIT) == "done"
    tenants = _get_json(base + "/tenants")
    assert tenants["alice"]["completed"] == 1
    assert tenants["bob"]["completed"] == 1
    prof = _get_json(f"{base}/profiles/{t1.rid}")
    assert prof == json.loads(json.dumps(t1.profile()))
    assert prof["tenant"] == "alice" and prof["state"] == "done"
    health = _get_json(base + "/health")
    assert health["status"] == "ok"
    assert health["components"]["memory"] == {"free_hbm_bytes": None,
                                              "hbm_limit_bytes": None}
    assert "/metrics" in _get_json(base + "/")["endpoints"]
    assert set(_get_json(base + "/views")) == set()
    assert "series" in _get_json(base + "/metrics/window?window=30")
    assert "events" in _get_json(base + "/events?since=0")
    assert _get_json(base + "/trace?since=0")["armed"] in (True, False)
    for bad, code in (("/profiles/999999", 404), ("/nope", 404),
                      ("/events?since=x", 400),
                      ("/metrics/window?window=x", 400)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + bad)
        assert ei.value.code == code, bad
    eng.close()
    with pytest.raises((ConnectionError, urllib.error.URLError,
                        socket.timeout, OSError)):
        _get(base + "/healthz", timeout=2)


def test_startup_failure_degrades_never_kills_engine(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "not-a-port")
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    assert eng._http is None
    assert eng.submit(lambda: 1, tenant="a").result(WAIT) == 1
    eng.close()
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    holder = ServeEngine(policy=ServePolicy(max_queue=2))
    _, port = holder.http_address
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", str(port))
    clashed = ServeEngine(policy=ServePolicy(max_queue=2))
    assert clashed._http is None
    assert clashed.submit(lambda: 2, tenant="b").result(WAIT) == 2
    clashed.close()
    holder.close()


def test_profiles_endpoint_respects_profile_optout(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    monkeypatch.setattr(prof_mod, "PROFILING", False)
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    tk = eng.submit(lambda: 1, tenant="a")
    assert tk.result(WAIT) == 1
    host, port = eng.http_address
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"http://{host}:{port}/profiles/{tk.rid}")
    assert ei.value.code == 404
    eng.close()


def test_handler_error_returns_500_not_thread_death(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    host, port = eng.http_address
    base = f"http://{host}:{port}"
    orig = eng.tenant_stats
    eng.tenant_stats = lambda: 1 / 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/tenants")
    assert ei.value.code == 500
    eng.tenant_stats = orig
    assert _get_json(base + "/healthz")["status"] == "ok"
    eng.close()


def test_closing_engine_answers_503(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SERVE_HTTP_PORT", "0")
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    host, port = eng.http_address
    eng._closed = True                      # close() has committed
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"http://{host}:{port}/health")
    assert ei.value.code == 503
    eng._closed = False
    eng.close()


# ----------------------------------------- the verdict, both packages
def _verdicts(engine_cls, policy_cls, errors, tel):
    """The same engine states through one package: idle, queue pressure,
    a tripped breaker, a burning SLO and a closed engine. Returns each
    verdict's status, score and reason kinds."""
    tel.reset("serve.")
    out = []

    def kinds(v):
        return (v["status"], v["score"],
                [r.split(":")[0] for r in v["reasons"]])

    eng = engine_cls(None, policy_cls(max_queue=5, breaker_fails=1,
                                      breaker_cooldown=60.0))
    out.append(kinds(eng.health()))
    gate = threading.Event()
    live = [eng.submit(_gated(gate), tenant="a") for _ in range(4)]
    out.append(kinds(eng.health()))
    gate.set()
    for tk in live:
        tk.wait(WAIT)

    def storm():
        raise errors("wedged", section="serve_request")

    eng.submit(storm, tenant="noisy").wait(WAIT)
    out.append(kinds(eng.health()))
    eng.close()
    out.append(kinds(eng.health()))
    slo_eng = engine_cls(None, policy_cls(max_queue=5, breaker_fails=0,
                                          slo_target=0.9,
                                          slo_windows=(30.0, 60.0)))
    slo_eng.submit(storm, tenant="burn").wait(WAIT)
    out.append(kinds(slo_eng.health()))
    slo_eng.submit(lambda: 1, tenant="burn").wait(WAIT)
    out.append(kinds(slo_eng.health()))
    slo_eng.close()
    return out


def test_health_verdict_matches_jax(monkeypatch):
    import cylon_tpu.telemetry as jtel
    from cylon_tpu import fallback as jfallback
    from cylon_tpu.errors import DeadlineExceeded as JDeadline
    from cylon_tpu.serve import ServeEngine as JEngine
    from cylon_tpu.serve import ServePolicy as JPolicy

    from cylon_tpu.telemetry import timeseries as jseries
    from cylon_tpu_torch.telemetry import timeseries

    # neither side has a card here: both skip the memory component
    monkeypatch.setattr(jfallback, "free_hbm_bytes", lambda: None)
    monkeypatch.delenv("CYLON_TPU_SERVE_STALL_AGE", raising=False)
    # a watchdog expiry that an earlier test of this process left in
    # either package's history window would read as this engine's
    for tel, series in ((telemetry, timeseries), (jtel, jseries)):
        tel.reset()
        series.reset()
    got = _verdicts(ServeEngine, ServePolicy, DeadlineExceeded, telemetry)
    want = _verdicts(JEngine, JPolicy, JDeadline, jtel)
    jtel.reset("serve.")
    assert got == want
    assert [g[0] for g in got] == ["ok", "ok", "unhealthy", "unhealthy",
                                   "degraded", "ok"]
    assert got[1][2] == ["queue_pressure"]
    assert got[2][2] == ["breaker_open"]
    assert got[3][2][-1] == "engine_closed"
    assert got[4][2] == ["slo_burn"]
    assert got[5][2] == ["slo_burn_warning"]


def test_health_memory_component_reads_free_over_limit(monkeypatch):
    """With a card the component is the free bytes over the total: under
    10 % free the verdict degrades, under 2 % it is exhausted."""
    from cylon_tpu_torch import fallback

    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    assert introspect.health_verdict(eng)["components"]["memory"] == {
        "free_hbm_bytes": None, "hbm_limit_bytes": None}
    monkeypatch.setattr(fallback, "hbm_limit_bytes", lambda: 1000)
    for free, status, kind in ((500, "ok", []),
                               (50, "ok", ["hbm_pressure"]),
                               (10, "degraded", ["hbm_exhausted"])):
        monkeypatch.setattr(fallback, "free_hbm_bytes", lambda f=free: f)
        v = introspect.health_verdict(eng)
        assert v["components"]["memory"]["headroom"] == free / 1000
        assert v["status"] == status
        assert [r.split(":")[0] for r in v["reasons"]] == kind
    eng.close()


def test_stalled_scheduler_reads_unhealthy(monkeypatch):
    monkeypatch.setattr(introspect, "STALL_AGE_S", 0.05)
    eng = ServeEngine(policy=ServePolicy(max_queue=2))
    gate = threading.Event()

    def wedged():
        gate.wait(WAIT)
        return 1

    tk = eng.submit(wedged, tenant="a")
    time.sleep(0.2)
    v = eng.health()
    gate.set()
    assert tk.result(WAIT) == 1
    eng.close()
    assert v["status"] == "unhealthy"
    assert [r.split(":")[0] for r in v["reasons"]] == ["scheduler_stalled"]


# ------------------------------------------------- read-only by design
_FORBIDDEN = frozenset({
    "submit", "submit_named", "register_table", "register_query",
    "drop_table", "drop", "remove_table", "put_table", "pin", "unpin",
    "clear", "reset", "close", "recover", "session", "read_csv",
    "join_tables", "sort_table", "unique_table", "append_table",
    "register_view", "refresh_view", "drop_view",
})


def test_introspect_handlers_are_read_only():
    """``tests/test_bench_guard.py``'s lint on the port's module: no
    handler reaches a mutating surface, and GET is the only verb."""
    path = pathlib.Path(introspect.__file__)
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(n.lineno, n.func.attr) for n in ast.walk(tree)
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
           and n.func.attr in _FORBIDDEN]
    assert not bad, bad
    verbs = {n.name for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name.startswith("do_")}
    assert verbs == {"do_GET"}
    import cylon_tpu.serve.introspect as jintro

    assert introspect.ENDPOINTS == jintro.ENDPOINTS
