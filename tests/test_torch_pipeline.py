"""The port's pipelined out-of-core execution (``cylon_tpu_torch.pipeline``):
prefetcher, async committer, deadlines; the cases of the JAX package's
``tests/test_pipeline.py``, on CPU tables.

Items arrive in order with bounded lookahead on an abandonable worker;
durable commits run FIFO on one writer thread behind the compute; a
``watchdog.deadline`` around a pass bounds the pipeline workers too; and
``CYLON_TPU_OOC_PREFETCH_DEPTH=0`` restores byte-identical sequential
behaviour (the control the chip smoke's spill phase times against).
"""

import threading
import time

import numpy as np
import pytest

from cylon_tpu_torch import pipeline, telemetry, watchdog
from cylon_tpu_torch.errors import DeadlineExceeded


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("cylon-ooc-prefetch",
                                  "cylon-ooc-writer"))]


def _await_no_pipeline_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _pipeline_threads():
            return True
        time.sleep(0.02)
    return not _pipeline_threads()


@pytest.fixture(autouse=True)
def _no_thread_leaks():
    yield
    assert _await_no_pipeline_threads(), (
        f"pipeline threads leaked: {_pipeline_threads()}")


# ---------------------------------------------------------- prefetched
def test_prefetched_yields_in_order_and_counts(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "2")
    h0 = telemetry.total("ooc.prefetch_hits")
    m0 = telemetry.total("ooc.prefetch_misses")
    b0 = telemetry.total("plan.prefetch_bytes")
    items = [{"x": np.arange(10, dtype=np.int64)} for _ in range(6)]
    out = list(pipeline.prefetched(iter(items), op="t"))
    assert [o["x"].sum() for o in out] == [45] * 6
    hits = telemetry.total("ooc.prefetch_hits") - h0
    misses = telemetry.total("ooc.prefetch_misses") - m0
    assert hits + misses == 6
    # every ingest path feeds plan.prefetch_bytes (counter honesty)
    assert telemetry.total("plan.prefetch_bytes") - b0 == 6 * 80


def test_prefetched_depth_zero_is_inline_and_threadless(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "0")
    before = set(threading.enumerate())
    b0 = telemetry.total("plan.prefetch_bytes")
    out = list(pipeline.prefetched(
        ({"x": np.zeros(4, np.int64)} for _ in range(3)), op="t"))
    assert len(out) == 3
    assert set(threading.enumerate()) == before
    # the sequential arm still feeds the honesty counter
    assert telemetry.total("plan.prefetch_bytes") - b0 == 3 * 32
    # and forces the writer inline too: the depth-0 control arm is
    # FULLY sequential
    assert not pipeline.async_write_enabled()


def test_prefetched_lookahead_is_bounded(monkeypatch):
    """depth counts mid-ingest work too (slot semaphore): with depth 1
    the worker holds at most ONE pulled-but-unconsumed unit, so at
    most 2 units are live including the consumer's — the HBM bound
    the device-ingesting passes (ooc_join/ooc_sort) rely on."""
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    pulled = []

    def src():
        for i in range(10):
            pulled.append(i)
            yield i

    g = pipeline.prefetched(src(), op="t")
    assert next(g) == 0
    time.sleep(0.3)
    assert len(pulled) <= 2
    g.close()


def test_prefetched_source_error_propagates(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")

    def src():
        yield 1
        raise ValueError("source broke")

    g = pipeline.prefetched(src(), op="t")
    assert next(g) == 1
    with pytest.raises(ValueError, match="source broke"):
        list(g)


def test_prefetch_map_runs_fn_on_worker_in_order(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "2")
    main = threading.get_ident()
    seen_threads = set()

    def fn(i):
        seen_threads.add(threading.get_ident())
        return i * i

    out = list(pipeline.prefetch_map(range(5), fn, op="t"))
    assert out == [(i, i * i) for i in range(5)]
    assert seen_threads and main not in seen_threads


def test_prefetch_worker_inherits_context(monkeypatch):
    """The worker copies the caller's contextvars: a scoped
    (context-local) fault plan fires INSIDE the worker — the same
    propagation serve tenants and deadline scopes ride."""
    from cylon_tpu_torch import resilience

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")

    def src():
        for i in range(4):
            resilience.inject("io_read", f"chunk {i}")
            yield i

    plan = resilience.FaultPlan(
        [resilience.FaultRule("io_read", nth=3,
                              error=ValueError("worker fault"))])
    with resilience.scoped(plan):
        g = pipeline.prefetched(src(), op="t")
        with pytest.raises(ValueError, match="worker fault"):
            list(g)
    assert plan.fired and plan.fired[0][0] == "io_read"


# ------------------------------------------------------ async committer
def test_committer_fifo_order_and_drain(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    ran = []
    with pipeline.committer("t") as com:
        for i in range(8):
            com.submit(lambda i=i: ran.append(i))
    # the committer context drains on exit — every commit durable,
    # strictly in submission order
    assert ran == list(range(8))


def test_committer_error_is_sticky_and_halts_later_commits(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    ran = []

    def boom():
        raise OSError("disk gone")

    com = pipeline.AsyncCommitter(op="t")
    com.submit(lambda: ran.append(0))
    com.submit(boom)
    # the failure surfaces on a later submit or the drain, and NOTHING
    # past the failure point ever runs (no unit recorded out of order)
    with pytest.raises(OSError, match="disk gone"):
        for _ in range(50):
            com.submit(lambda: ran.append(1))
            time.sleep(0.01)
    with pytest.raises(OSError, match="disk gone"):
        com.drain()
    com.close()
    assert ran == [0]


def test_committer_discards_queued_commits_on_body_exception(
        monkeypatch):
    """A pass that raises mid-loop must NOT race its queued sink/ckpt
    closures against the caller's exception handling: the in-flight
    commit finishes (can't interrupt an fsync), queued ones are
    discarded — matching sequential semantics, where nothing past the
    raise ever ran (discarded units just recompute on resume)."""
    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    ran = []
    started = threading.Event()

    def slow():
        started.set()
        time.sleep(0.3)
        ran.append("slow")

    with pytest.raises(ValueError, match="pass body died"):
        with pipeline.committer("t") as com:
            com.submit(slow)
            com.submit(lambda: ran.append("queued"))
            assert started.wait(5.0)  # slow is IN FLIGHT when we raise
            raise ValueError("pass body died")
    time.sleep(0.2)
    assert ran == ["slow"], (
        "in-flight commit must finish; queued commit must not run "
        "after the pass body raised")


def test_committer_sync_mode_runs_inline_threadless():
    before = set(threading.enumerate())
    ran = []
    with pipeline.sequential(), pipeline.committer("t") as com:
        com.submit(lambda: ran.append(threading.get_ident()))
        assert ran == [threading.get_ident()]  # inline, immediately
    assert set(threading.enumerate()) == before


# ----------------------------------------------------------- deadlines
def test_deadline_bounds_prefetch_worker_no_orphan():
    """A watchdog.deadline scoped around a
    prefetched loop bounds the WORKER too — the expiry surfaces as
    DeadlineExceeded on the consumer and the worker thread exits
    instead of orphaning past the expiry."""
    def slow_src():
        for i in range(100):
            time.sleep(0.05)
            yield i

    with pytest.raises(DeadlineExceeded):
        with watchdog.deadline(0.25):
            for _ in pipeline.prefetched(slow_src(), op="t", depth=1):
                time.sleep(0.05)
                watchdog.check()
    assert _await_no_pipeline_threads(), (
        "prefetch worker orphaned past the deadline expiry")


def test_deadline_bounds_whole_ooc_pass_workers(monkeypatch, tmp_path):
    """The pass-level form: deadline() around ooc_sort with a slow
    chunk source raises DeadlineExceeded and leaves no pipeline thread
    behind — prefetcher AND async writer both bounded."""
    from cylon_tpu_torch.outofcore import ooc_sort

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "2")
    rng = np.random.default_rng(0)
    n, chunk = 4000, 250

    def slow_chunks():
        for lo in range(0, n, chunk):
            time.sleep(0.05)
            yield {"k": rng.integers(0, 50, chunk).astype(np.int64),
                   "v": rng.normal(size=chunk)}

    with pytest.raises(DeadlineExceeded):
        with watchdog.deadline(0.3):
            ooc_sort(slow_chunks, ["k", "v"], n_partitions=4,
                     chunk_rows=chunk,
                     resume_dir=str(tmp_path / "ck"), device="cpu")
    assert _await_no_pipeline_threads(), (
        "ooc_sort left pipeline threads running past its deadline")


# ------------------------------------------- end-to-end A/B determinism
def _run_sort(depth, monkeypatch, tmp_path, tag):
    from cylon_tpu_torch.outofcore import ooc_sort

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", str(depth))
    rng = np.random.default_rng(11)
    n, chunk = 6000, 700
    src = {"k": rng.integers(0, 300, n).astype(np.int64),
           "v": rng.normal(size=n)}
    frames = []
    total = ooc_sort(src, ["k", "v"], n_partitions=4, chunk_rows=chunk,
                     sink=frames.append,
                     resume_dir=str(tmp_path / f"ck{tag}"), device="cpu")
    text = "".join(f.to_csv(index=False, float_format="%.17g")
                   for f in frames)
    return total, text


def test_pipelined_output_identical_to_sequential(monkeypatch,
                                                  tmp_path):
    """Overlap must not change a single byte: depth=2 (prefetch + async
    writes) and depth=0 (fully sequential) produce identical sink
    streams — unit order included."""
    t0, seq = _run_sort(0, monkeypatch, tmp_path, "seq")
    t1, pipe = _run_sort(2, monkeypatch, tmp_path, "pipe")
    assert t0 == t1 and seq == pipe


def test_ooc_pass_emits_overlap_counters(monkeypatch):
    from cylon_tpu_torch.outofcore import ooc_groupby

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    h0 = (telemetry.total("ooc.prefetch_hits")
          + telemetry.total("ooc.prefetch_misses"))
    rng = np.random.default_rng(5)
    src = {"g": rng.integers(0, 20, 4000).astype(np.int64),
           "v": rng.normal(size=4000)}
    ooc_groupby(src, ["g"], [("v", "sum", "s")], chunk_rows=500,
                device="cpu")
    assert (telemetry.total("ooc.prefetch_hits")
            + telemetry.total("ooc.prefetch_misses")) - h0 >= 8


def test_oom_retry_spill_runs_sequential_pipeline(monkeypatch):
    """An IN-FLIGHT OOM's spill retry must not grow its device
    footprint: run_with_fallback wraps the retry in
    pipeline.sequential() (depth 0 — no prefetch lookahead of a
    second partition's device tables, no async writes), while the
    preflight-routed spill keeps the pipeline (its partitions are
    sized against free device memory with headroom)."""
    from cylon_tpu_torch import fallback

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "2")
    depths = []

    def attempt():
        raise MemoryError("device OOM")

    def spill():
        depths.append(pipeline.prefetch_depth())
        return "degraded"

    assert fallback.run_with_fallback(attempt, spill, op="t") \
        == "degraded"
    assert depths == [0], (
        "OOM-retry spill ran with prefetch lookahead enabled")
    # preflight route: pipeline stays on
    depths.clear()
    assert fallback.run_with_fallback(
        lambda: "in_core", spill, op="t", predicted_bytes=100,
        budget_bytes=1) == "degraded"
    assert depths == [2]
    # and the override never leaks out of the scope
    assert pipeline.prefetch_depth() == 2


def test_required_bench_keys_pin_overlap_counters():
    """The overlap series ride every bench record's metrics block."""
    from cylon_tpu_torch.telemetry import REQUIRED_BENCH_KEYS

    want = {"ooc.prefetch_hits", "ooc.prefetch_misses",
            "ooc.overlap_seconds"}
    assert want <= set(REQUIRED_BENCH_KEYS)


def test_ooc_prefetch_watchdog_section_registered():
    from cylon_tpu_torch.config import DEADLINE_SECTIONS

    assert watchdog.SECTIONS.get("ooc_prefetch") is False
    assert "ooc_prefetch" in DEADLINE_SECTIONS


def test_prefetch_worker_table_bytes_feed_the_counter(monkeypatch):
    """A unit that is a device table counts its column buffers' bytes,
    read off the tensors' shapes."""
    import cylon_tpu_torch as ct

    monkeypatch.setenv("CYLON_TPU_OOC_PREFETCH_DEPTH", "1")
    b0 = telemetry.total("plan.prefetch_bytes")
    t = ct.Table.from_pydict({"a": np.arange(16, dtype=np.int64),
                              "b": np.ones(16)}, device="cpu")
    assert list(pipeline.prefetched([t], op="t")) == [t]
    assert telemetry.total("plan.prefetch_bytes") - b0 == 16 * 16
