"""The port's ``telemetry.memory`` — device-memory accounting:
live-bytes gauges, per-op peak watermarks, OOM forensics.

The cases of ``tests/test_memory.py`` on ``cylon_tpu_torch``, on the CPU,
where the live bytes come from a walk of the live CPU tensors (each
storage counted once). The JAX file's pinned-catalog case holds the
report's other sections here with an empty catalog; the ``tables``
section over resident tables is held in ``tests/test_torch_catalog.py``.
"""

import io
import logging

import numpy as np
import pytest
import torch

import cylon_tpu_torch as ct
from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry import memory


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset("memory.")
    memory._THROTTLE[0] = 0.0
    yield
    telemetry.reset("memory.")
    memory._THROTTLE[0] = 0.0


def test_torch_device_bytes_sees_live_tensors():
    base = memory.live_bytes()
    keep = torch.zeros(1 << 16, dtype=torch.float64)   # 512 KiB resident
    view = keep[::2]                  # a view: its storage counts once
    grown = memory.live_bytes()
    assert grown >= base + keep.nbytes
    assert grown < base + 2 * keep.nbytes
    per = memory.device_bytes()
    assert set(per) == {"cpu:0"}
    assert all(isinstance(v, int) and v >= 0 for v in per.values())
    del keep, view


def test_torch_sample_publishes_gauges_and_monotone_peak():
    keep = torch.ones(1 << 14, dtype=torch.float64)
    total = memory.sample(op="test_op", force=True)
    assert total >= keep.nbytes
    series = telemetry.instruments("memory.live_bytes")
    assert series and all(lab.get("device") for _, lab, _ in series)
    assert memory.peak_live_bytes() >= total
    assert memory.peak_live_bytes(op="test_op") >= total
    # the watermark never regresses, even when residency shrinks
    del keep
    shrunk = memory.sample(op="test_op", force=True)
    assert memory.peak_live_bytes() >= total >= shrunk
    assert memory.peak_live_bytes(op="test_op") >= total


def test_torch_sampling_disabled_is_one_env_read(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_MEMORY_SAMPLING", "0")
    assert memory.sample(op="off", force=True) == 0
    assert telemetry.metric("memory.peak_bytes") is None
    assert telemetry.metric("memory.peak_bytes", op="off") is None


def test_torch_throttle_reuses_last_total(monkeypatch):
    monkeypatch.setattr(memory, "SAMPLE_INTERVAL_S", 60.0)
    t1 = memory.sample(force=True)
    assert memory.sample() == t1         # cached, no walk
    assert memory.sample(force=True) >= 0


def test_torch_hot_path_sample_never_walks_live_tensors(monkeypatch):
    """The noise contract: an UNFORCED sample without a card must not
    pay the O(live-objects) walk — it reuses the last forced walk's
    total, so per-exchange sampling cannot jitter op walls."""
    base = memory.sample(force=True)      # prime the cache

    def _boom(*a, **k):
        raise AssertionError("hot-path sample walked the live tensors")

    monkeypatch.setattr(memory, "_live_tensors", _boom)
    monkeypatch.setattr(memory.gc, "get_objects", _boom)
    monkeypatch.setattr(memory, "SAMPLE_INTERVAL_S", 0.0)
    assert memory.sample(op="hot_op") == base
    if base:
        assert memory.peak_live_bytes(op="hot_op") >= base


def test_torch_watermark_context_brackets_op():
    with memory.watermark("bracket_op"):
        held = torch.ones(1 << 14, dtype=torch.float64)
        memory.sample(op="bracket_op", force=True)
    assert memory.peak_live_bytes(op="bracket_op") >= held.nbytes


def test_torch_is_oom_recognises_backend_shapes():
    assert memory.is_oom(MemoryError())
    assert memory.is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert memory.is_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 1073741824 bytes"))
    assert memory.is_oom(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 1073741824 bytes"))
    assert memory.is_oom(ValueError("Unable to allocate 8.0 GiB"))
    assert not memory.is_oom(ValueError("bad argument"))
    assert not memory.is_oom(KeyError("x"))


def test_torch_oom_report_names_plan_cache_and_devices():
    q = ct.plan.shared_compiled(_one_table_query)
    q(ct.Table.from_pydict({"k": np.arange(64, dtype=np.int64)},
                           device="cpu"))
    rep = memory.oom_report()
    assert rep["tables"] == []             # the catalog holds no table
    assert set(rep["devices"]) == {"cpu:0"}
    assert "spill" in rep and isinstance(rep["top_arrays"], list)
    assert rep["top_arrays"] == []          # no CUDA tensor here
    pc = rep["plan_cache"]
    assert pc["shared_queries"] >= 1
    assert pc["entries_per_query"]["_one_table_query"] >= 1
    text = memory.format_oom_report(rep)
    assert "resident-memory forensics" in text
    assert "_one_table_query" in text


def _one_table_query(t):
    return t


def test_torch_forensics_counts_and_reraises_oom():
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    logger = logging.getLogger("cylon_tpu_torch")
    logger.addHandler(h)
    try:
        with pytest.raises(RuntimeError, match="CUDA out of memory"):
            with memory.forensics("unit_test"):
                raise RuntimeError("CUDA out of memory. Tried to allocate "
                                   "999 bytes")
    finally:
        logger.removeHandler(h)
    assert telemetry.counter("memory.oom_events",
                             point="unit_test").value == 1
    err = buf.getvalue()
    assert "resident-memory forensics" in err
    assert "allocation failure in unit_test" in err


def test_torch_forensics_passes_non_oom_through_silently():
    with pytest.raises(ValueError):
        with memory.forensics("unit_test2"):
            raise ValueError("not an oom")
    assert telemetry.metric("memory.oom_events",
                            point="unit_test2") is None


def test_torch_second_graph_join_leaves_live_bytes_where_the_first_did():
    """ROADMAP C8: an operator graph once held its chunks in a reference
    cycle (each op's children held it as their parent), so a finished
    ``DisJoinOp`` kept every chunk and join output alive until the next
    cyclic collection: 5.37 GB after ``chip_smoke.py``'s frame phase on
    the card. With the collector off, a second run of the same graph must
    leave the live bytes where the first left them."""
    import gc

    from cylon_tpu_torch.ops_graph import DisJoinOp, chunk_stream

    rng = np.random.default_rng(8)
    n = 1 << 15

    def side():
        return ct.Table.from_pydict({"k": rng.integers(0, n, n),
                                     "v": rng.random(n)}, device="cpu")

    lt, rt = side(), side()

    def graph_join():
        graph = DisJoinOp("k")
        for chunk in chunk_stream(lt, n // 8):
            graph.insert_left(chunk)
        for chunk in chunk_stream(rt, n // 8):
            graph.insert_right(chunk)
        return graph.result().num_rows

    gc.collect()
    gc.disable()
    try:
        rows = graph_join()
        first = memory.live_bytes()
        assert graph_join() == rows
        second = memory.live_bytes()
    finally:
        gc.enable()
    # one run's chunks and output are several times this slack
    assert second <= first + (n * 16) // 4, (first, second)
    assert gc.collect() == 0 or not any(
        issubclass(type(o), torch.Tensor) for o in gc.garbage)
