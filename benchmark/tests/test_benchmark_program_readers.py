"""The readers of what the program counts and times itself
(``harness/program.py``: host reads a call, device-timed spans a traced
call, the row gather's roofline, the copy-in's mean) on a synthetic
``Context``, and None wherever there is nothing to read: no telemetry,
no traced call, a program without the series."""

import pytest

from benchmark import run
from benchmark.harness import loop, program
from benchmark.harness.cell import load_module
from test_benchmark_metrics import METRICS, FakeWorkload, window

NEW = ("host_reads_per_op.join", "host_reads_per_op.tpch",
       "join.indices_ms", "gather_ms.join", "gather_roofline.join",
       "gather_ms.tpch", "plan.copy_in_ms")


def metric(name):
    return load_module(METRICS / f"{name}.py")


def counter(name, value, **labels):
    return {f"{name}{labels}": {"name": name, "type": "counter",
                                "labels": labels, "value": value}}


def span(name, count, seconds):
    return {f"span{name}": {"name": "tracing.span_seconds",
                            "type": "timer", "labels": {"name": name},
                            "count": count, "sum": seconds}}


def ctx(delta, ops=4, traced=2, bandwidth=1e9):
    win = window([0.1] * ops)
    for r in win.records[traced:]:
        r.traced = False
    return run.Context(win, 5.0, 1e9, FakeWorkload(), bandwidth,
                       telemetry_delta=delta)


def program_delta():
    d = {}
    d.update(counter("host.reads", 6, site="shard_sizes"))
    d.update(counter("host.reads", 2, site="stage"))
    d.update(counter("gather.bytes", 8e9))
    d.update(span("join.indices", 2, 0.5))
    d.update(span("join.indices.device", 2, 0.12))
    d.update(span("gather.device", 4, 0.08))
    d.update(span("plan.copy_in.device", 5, 0.01))
    return d


def test_host_reads_are_every_site_over_every_call():
    c = ctx(program_delta())
    assert metric("host_reads_per_op.join").read(c) == pytest.approx(2.0)
    assert metric("host_reads_per_op.tpch").read(c) == pytest.approx(2.0)


def test_a_counter_that_counted_nothing_reads_zero():
    c = ctx(counter("host.reads", 0, site="fetch"))
    assert metric("host_reads_per_op.tpch").read(c) == 0.0


def test_device_spans_are_ms_a_traced_call():
    c = ctx(program_delta())
    assert metric("join.indices_ms").read(c) == pytest.approx(60.0)
    assert metric("gather_ms.join").read(c) == pytest.approx(40.0)
    assert metric("gather_ms.tpch").read(c) == pytest.approx(40.0)


def test_the_gather_roofline_is_its_bytes_over_its_device_time():
    # both counted over the traced calls alone: 8e9 bytes at 1e9 bytes/s
    # is 8 s, over 0.08 s of device time; the untraced calls count
    # neither, so their number does not enter
    for ops in (2, 4):
        c = ctx(program_delta(), ops=ops)
        assert metric("gather_roofline.join").read(c) == \
            pytest.approx(10000.0)
    c = ctx(program_delta(), bandwidth=1e12)
    assert metric("gather_roofline.join").read(c) == pytest.approx(10.0)


def test_the_copy_in_is_a_mean_a_span():
    c = ctx(program_delta())
    assert metric("plan.copy_in_ms").read(c) == pytest.approx(2.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name):
    reader = metric(name)
    # no telemetry read at all
    assert reader.read(ctx(None)) is None
    # a program without these series (an older one): other series only
    older = counter("join.algorithm", 3, kind="sort->sort")
    older.update(span("dist_join", 4, 0.4))
    assert reader.read(ctx(older)) is None
    # the series but no call traced: what is read a traced call reads
    # nothing (host reads are a call of the window, the copy-in a span)
    got = reader.read(ctx(program_delta(), traced=0))
    if name.startswith("host_reads") or name == "plan.copy_in_ms":
        assert got is not None
    else:
        assert got is None


def test_host_spans_alone_give_no_device_time():
    """The host series of a span is not its device series."""
    c = ctx(span("gather", 4, 0.2))
    assert program.device_ms_per_op(c, "gather") is None
    assert program.counter_per_op(c, "gather.bytes") is None


def test_an_empty_window_reads_nothing():
    c = run.Context(loop.Window(0.0, []), 5.0, 1e9, FakeWorkload(), 1e9,
                    telemetry_delta=program_delta())
    assert program.counter_per_op(c, "host.reads") is None
    assert program.device_ms_per_op(c, "gather") is None
