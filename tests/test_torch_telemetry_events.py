"""The port's ``telemetry.events`` — the typed structured event
journal: schema-checked kinds, cursored replay, ring-bound drop
accounting, optional JSONL, and the one-env-read unarmed path. The
cases of ``tests/test_events.py``, run on ``cylon_tpu_torch``'s copy of
the module. Its last case drives the serve engine there; the port has no
serve layer yet (ROADMAP A8.2), so here a worker thread runs the same
admit / retire lifecycle the engine emits, and the journal is held to
the same envelope."""

import json
import os

import pytest

from cylon_tpu_torch.telemetry import events


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    events.clear()
    monkeypatch.setenv("CYLON_TPU_EVENTS", "1")
    yield
    events.clear()


def test_torch_unregistered_kind_raises():
    with pytest.raises(ValueError, match="unregistered event kind"):
        events.emit("totally_new_kind", tenant="a")


def test_torch_undeclared_field_raises():
    """The schema registers FIELDS, not just kinds: a mistyped payload
    key fails at the emit site instead of drifting past consumers."""
    with pytest.raises(ValueError, match="does not declare"):
        events.emit("shed", tenant="a", cause="memory")  # not "reason"


def test_torch_emit_envelope_and_cursor_replay():
    e1 = events.emit("admit", tenant="alice", rid=1, slo=2.5)
    e2 = events.emit("retire", tenant="alice", rid=1, state="done",
                     wall_s=0.1, error=None)
    assert e1["seq"] == 1 and e2["seq"] == 2
    assert e2["ts"] >= e1["ts"]  # monotonic timestamps
    rep = events.since(0)
    assert [e["kind"] for e in rep["events"]] == ["admit", "retire"]
    assert rep["cursor"] == 2 and rep["dropped"] == 0
    # resume from the cursor: nothing new
    assert events.since(rep["cursor"])["events"] == []
    events.emit("shed", tenant="bob", reason="queue_full")
    rep2 = events.since(rep["cursor"])
    assert [e["kind"] for e in rep2["events"]] == ["shed"]
    assert rep2["events"][0]["reason"] == "queue_full"


def test_torch_ring_bound_reports_the_gap(monkeypatch):
    events.clear()
    monkeypatch.setenv("CYLON_TPU_EVENTS_CAPACITY", "16")
    for i in range(40):
        events.emit("admit", tenant="t", rid=i, slo=None)
    rep = events.since(0)
    assert len(rep["events"]) == 16
    # a consumer that fell behind SEES the eviction, not silence
    assert rep["dropped"] == 24
    assert events.dropped() == 24
    # seqs stay contiguous and ordered across the wrap
    seqs = [e["seq"] for e in rep["events"]]
    assert seqs == list(range(25, 41))


def test_torch_ambient_tenant_scope_stamps_events():
    from cylon_tpu_torch import telemetry

    with telemetry.tenant_scope("carol"):
        events.emit("fallback", op="q3", reason="oom")
    evt = events.since(0)["events"][-1]
    assert evt["tenant"] == "carol"


def test_torch_unarmed_process_pays_one_env_read(monkeypatch):
    events.clear()
    monkeypatch.delenv("CYLON_TPU_EVENTS", raising=False)
    assert events.emit("admit", tenant="a", rid=1, slo=None) is None
    # no ring, no allocations: the journal never materialised
    assert events._JOURNAL is None
    assert events.events() == []
    rep = events.since(0)
    assert rep["events"] == [] and rep["armed"] is False


def test_torch_jsonl_companion_stream(tmp_path, monkeypatch):
    events.clear()
    monkeypatch.setenv("CYLON_TPU_METRICS_DIR", str(tmp_path))
    events.emit("breaker_open", failures=5, window_s=30.0,
                cooldown_s=5.0)
    events.emit("breaker_close", open_s=5.2)
    events.clear()  # closes the handle
    path = tmp_path / f"events-{os.getpid()}.jsonl"
    lines = [json.loads(x) for x in
             path.read_text().strip().splitlines()]
    assert [x["kind"] for x in lines] == ["breaker_open",
                                          "breaker_close"]
    assert lines[0]["failures"] == 5


def test_torch_lifecycle_from_a_worker_thread_emits_admit_and_retire():
    import threading

    from cylon_tpu_torch import telemetry

    done = {}

    def serve_one(rid, fn):
        # what the serve engine's scheduler emits around one request
        with telemetry.tenant_scope("alice"):
            events.emit("admit", rid=rid, slo=None, path="executed")
            try:
                done[rid] = fn()
                events.emit("retire", rid=rid, state="done", wall_s=0.0,
                            error=None)
            except Exception as e:     # noqa: BLE001 -- journaled
                events.emit("retire", rid=rid, state="failed",
                            wall_s=0.0, error=type(e).__name__)

    t = threading.Thread(target=serve_one, args=(7, lambda: 7))
    t.start()
    t.join()
    assert done[7] == 7
    kinds = [(e["kind"], e.get("tenant"), e.get("rid"))
             for e in events.since(0)["events"]]
    assert ("admit", "alice", 7) in kinds
    assert ("retire", "alice", 7) in kinds
    retire = next(e for e in events.since(0)["events"]
                  if e["kind"] == "retire" and e["rid"] == 7)
    assert retire["state"] == "done" and retire["error"] is None
