"""The port's tracing/logging subsystem: spans, registry, report, env
log level — the cases of ``tests/test_tracing.py`` on
``cylon_tpu_torch.utils``.

The reference's analog is inline chrono+glog timing (``table.cpp:
167-177``); these tests pin the formalised replacement.
"""

import logging

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch.utils import tracing
from cylon_tpu_torch.utils.logging import (disable_logging, get_logger,
                                     log_level)


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset_timings()
    yield
    tracing.reset_timings()


def test_torch_span_records():
    with tracing.span("unit"):
        pass
    with tracing.span("unit"):
        pass
    t = tracing.timings()
    assert t["unit"].count == 2
    assert t["unit"].total_s >= t["unit"].max_s >= t["unit"].min_s >= 0


def test_torch_span_sync_waits_only_for_the_given_tensors(monkeypatch):
    """``sync=`` synchronizes the current stream of the CUDA devices its
    tensors lie on, and nothing else: CPU tensors need no wait, and a
    span without ``sync`` never touches a stream."""
    import torch

    def _no_stream(*a, **k):
        raise AssertionError("a CPU span synchronized a CUDA stream")

    monkeypatch.setattr(torch.cuda, "current_stream", _no_stream)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_stream)
    x = torch.arange(1024.0)
    with tracing.span("devwork", sync={"y": [x * 2]}):
        x * 2
    with tracing.span("nowait"):
        x * 2
    assert tracing.timings()["devwork"].count == 1
    assert tracing.timings()["nowait"].count == 1


def test_torch_traced_decorator_preserves_fn():
    @tracing.traced("mylabel")
    def f(a, b=1):
        """doc."""
        return a + b

    assert f(2, b=3) == 5
    assert f.__doc__ == "doc."
    assert tracing.timings()["mylabel"].count == 1


def test_torch_dist_ops_emit_spans():
    """Each rank runs the dist op under its span: a ThreadWorld of four
    ranks counts four ``dist_join`` spans (the JAX package's single
    controller counts one)."""
    import cylon_tpu_torch as ct

    rng = np.random.default_rng(0)
    n = 64

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        lt = ct.Table.from_pydict({"k": rng.integers(0, 50, n),
                                   "a": np.ones(n)}, device="cpu")
        rt = ct.Table.from_pydict({"k": rng.integers(0, 50, n),
                                   "b": np.ones(n)}, device="cpu")
        return ct.dist_join(env, lt, rt, on="k", how="inner",
                            out_capacity=16 * n)

    ct.ThreadWorld(4).run(rank)
    assert tracing.timings()["dist_join"].count == 4


def test_torch_report_renders():
    with tracing.span("a"):
        pass
    out = tracing.report()
    assert "span" in out and "a" in out and "count" in out
    # tail-latency columns derived from the shared histogram buckets
    assert "p50 ms" in out and "p99 ms" in out
    tracing.reset_timings()
    assert "no spans" in tracing.report()


def test_torch_report_percentiles_track_the_tail():
    from cylon_tpu_torch import telemetry

    t = telemetry.timer(tracing.SPAN_METRIC, name="tailspan")
    for _ in range(90):
        t.observe(0.001)
    for _ in range(10):
        t.observe(8.0)  # the straggler tail
    p50, p99 = t.quantile(0.5), t.quantile(0.99)
    # p50 stays near the body, p99 reaches into the tail bucket
    assert p50 is not None and p50 <= 0.01
    assert p99 is not None and p99 >= 1.0
    out = tracing.report()
    assert "tailspan" in out


def test_torch_log_levels():
    logger = get_logger()
    old = logger.level
    log_level(0)
    assert logger.level == logging.INFO
    log_level(2)
    assert logger.level == logging.ERROR
    log_level(9)  # out of range -> disabled
    assert logger.level > logging.CRITICAL
    disable_logging()
    assert logger.level > logging.CRITICAL
    log_level(1)
    assert logger.level == logging.WARNING
    logger.setLevel(old)          # the level the other tests found


def test_torch_span_logs_at_debug_not_info(caplog):
    """The per-span completion line is DEBUG: at millions of spans an
    INFO line per span is pure noise on hot paths — INFO must stay
    quiet, DEBUG must still carry the line."""
    logger = get_logger()
    old = logger.propagate, logger.level
    logger.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="cylon_tpu_torch"):
            with tracing.span("quiet"):
                pass
        assert not any("quiet" in r.message for r in caplog.records)
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger="cylon_tpu_torch"):
            with tracing.span("logged"):
                pass
        recs = [r for r in caplog.records if "logged" in r.message]
        assert recs and recs[0].levelno == logging.DEBUG
    finally:
        logger.propagate = old[0]
        logger.setLevel(old[1])


def test_torch_rank_world_prefix_once_env_is_live():
    """With a CylonEnv live, the handler's filter stamps every record
    with the rank/world (``CylonEnv.__init__`` sets it)."""
    from cylon_tpu_torch.utils import logging as clog

    f = clog._RankFilter()
    rec = logging.LogRecord("cylon_tpu_torch", logging.INFO, __file__, 1,
                            "msg", (), None)
    old = clog._WORLD
    try:
        clog._WORLD = None
        f.filter(rec)
        assert rec.rankprefix == ""
        clog.set_world(3, 8)
        f.filter(rec)
        assert rec.rankprefix == "[3/8] "
        import cylon_tpu_torch as ct

        ct.CylonEnv(device="cpu")
        f.filter(rec)
        assert rec.rankprefix == "[0/1] "
    finally:
        clog._WORLD = old


def test_torch_profile_to_writes_a_chrome_trace_with_the_spans(tmp_path):
    """``profile_to`` records a ``torch.profiler`` trace of its region:
    one Chrome-trace file whose events include the spans inside."""
    import json

    import torch

    with tracing.profile_to(str(tmp_path)):
        with tracing.span("profiled_span"):
            torch.ones(64) + 1
    files = list(tmp_path.glob("*.trace.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert any(e.get("name") == "profiled_span"
               for e in doc["traceEvents"])
