"""Whole-query capture (``cylon_tpu_torch.plan``) on the CPU.

A :class:`~cylon_tpu_torch.plan.CompiledQuery` on CUDA tensors runs its
query in capture mode and replays it as one CUDA graph. This host has no
card, so these tests hold what can be held here:

(a) a host-read lint: every TPC-H query and the whole-query example's
    query, warmed up eagerly (their sizes recorded on a
    ``plan.SizeTape``), then run in capture mode at those sizes, as a
    graph captures them, on CPU tensors under a dispatch mode that
    raises at the first host read (a scalar read, ``nonzero``, a boolean
    index, ``unique``, ``bincount``, ``repeat_interleave`` without its
    size, ``Tensor.numpy`` / ``tolist`` / ``cpu``, a tensor made from host
    data outside ``plan.staged``), locally and with an env of one rank;
    the queries it fails are exactly ``tpch.EAGER_QUERIES``;
(b) capture-mode results against the JAX package's compiled queries and
    the port's eager ones, at ``test_torch_tpch``'s tolerances;
(c) a join past its default bound raises the bare capture mode's flag
    and the whole query regrows at twice the scale until it fits, equal
    to pandas; under a graph's warm-up the join's own ladder settles it
    and the graph runs at its size, and a replay whose flag fires
    regrows the whole query;
(d) the graph cache's bookkeeping through a stand-in graph class put in
    ``plan.GRAPH_CLASS``, whose replay runs the captured program again
    on the graph's own input buffers: a hit on the same tensors, a
    replay with the new values after an in-place write, a new capture
    for another layout or another schema on the same tensors (names,
    dictionaries), the LRU bound, ``invalidate()``, a graph that
    outlives its first inputs without keeping them; the capture's
    launches tallied apart from other threads'; and the eager route's
    reasons. ``test_torch_rebind.py`` holds replays on new inputs.
"""

import contextlib
import gc

import numpy as np
import pandas as pd
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cylon_tpu_torch import (CylonEnv, DataFrame, Table, ThreadWorld, frame,
                             plan, telemetry, tpch)
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.ops.join import join
from cylon_tpu_torch.ops.selection import filter_table, sort_table
from cylon_tpu_torch.tpch import queries as Q
from test_tpch import SEED, SF, _assert_q3_equal, _frame_close
from test_torch_tpch import case, result

QUERIES = [f"q{i}" for i in range(1, 23)]
IN_SCOPE = ["q1", "q3", "q5", "q6", "q14"]


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF, SEED)


@pytest.fixture(scope="module")
def pdfs():
    return tpch.generate_pandas(SF, SEED)


@pytest.fixture(scope="module")
def frames(data):
    return tpch.ingest(data, device="cpu")


def warmed(fn, args, kwargs) -> plan.SizeTape:
    """A graph's warm-up of ``fn``: the sizes it settles at, replaying."""
    tape = plan.SizeTape()
    plan.run_captured(fn, args, kwargs, tape=tape)
    return tape.replaying()


def decided(out, packed, env):
    """A capture-mode result, its packed words decided and its tables
    shrunk, as a replay returns them."""
    return plan._shrink_results(out, plan._decide(out, packed.numpy(), env))


def captured(fn, *args, **kwargs):
    """The program a graph captures of ``fn``, run once: capture mode at
    its warm-up's sizes."""
    return decided(*plan.run_captured(fn, args, kwargs,
                                      tape=warmed(fn, args, kwargs)))


def bare_captured(fn, *args, **kwargs):
    """``fn`` in capture mode with no warm-up: every op at its one-rung
    default, as under a JAX trace."""
    return decided(*plan.run_captured(fn, args, kwargs))


# ------------------------------------------------------- (a) the lint
class HostRead(Exception):
    pass


_aten = torch.ops.aten
_READS = {_aten._local_scalar_dense.default, _aten.nonzero.default,
          _aten.masked_select.default, _aten.equal.default,
          _aten.is_nonzero.default, _aten.bincount.default,
          _aten.allclose.default}


class _HostReadMode(TorchDispatchMode):
    """Raise :class:`HostRead` at an op that reads a device value on the
    host or sizes its output from one."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if func in _READS or name.startswith(("unique", "_unique")):
            raise HostRead(str(func))
        if name == "repeat_interleave" and kwargs.get("output_size") is None:
            raise HostRead(f"{func} without output_size")
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            idx = args[1] if len(args) > 1 else kwargs.get("indices")
            if any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in (idx or ())):
                raise HostRead(f"{func} with a boolean index")
        return func(*args, **kwargs)


@contextlib.contextmanager
def host_read_lint():
    """:class:`_HostReadMode`, with ``Tensor.numpy`` / ``tolist`` / ``cpu``
    raising, and ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` of
    host data raising outside :func:`plan.staged`."""
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    for name in ("numpy", "tolist", "cpu"):
        def read(*a, _name=name, **k):
            raise HostRead(f"Tensor.{_name}")
        patch(torch.Tensor, name, read)
    for name in ("tensor", "as_tensor", "from_numpy"):
        def make(data, *a, _orig=getattr(torch, name), _name=name, **k):
            if not torch.is_tensor(data) and not plan.in_staging():
                raise HostRead(f"torch.{_name} of host data")
            return _orig(data, *a, **k)
        patch(torch, name, make)
    try:
        with _HostReadMode():
            yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)


def lint_fails(fn, *args, **kwargs) -> bool:
    """Whether the program a graph captures of ``fn`` reads the host (its
    warm-up, which reads counts, runs outside the lint)."""
    tape = warmed(fn, args, kwargs)
    try:
        with host_read_lint():
            plan.run_captured(fn, args, kwargs, tape=tape)
    except HostRead:
        return True
    return False


def test_lint_catches_each_kind_of_host_read():
    x = torch.arange(8)
    reads = [lambda: int(x.sum()), lambda: x.nonzero(),
             lambda: x[x > 3], lambda: torch.unique(x),
             lambda: x.repeat_interleave(x), lambda: x.numpy(),
             lambda: x.tolist(), lambda: torch.tensor([1, 2])]
    for read in reads:
        assert lint_fails(lambda: read())
    assert not lint_fails(lambda: plan.staged(np.arange(3), "cpu") + x[:3])
    assert not lint_fails(lambda: x.repeat_interleave(x, output_size=28))


def _query_inputs(qn, data, pdfs, frames):
    kw, data2, _, _ = case(qn, pdfs, data)
    return (frames if data2 is None
            else tpch.ingest(data2, device="cpu")), kw


@pytest.mark.parametrize("world", ["local", "w1"])
@pytest.mark.parametrize("qn", QUERIES)
def test_lint_fails_exactly_the_eager_queries(qn, world, data, pdfs,
                                              frames):
    inputs, kw = _query_inputs(qn, data, pdfs, frames)
    if world == "w1":
        kw = dict(kw, env=CylonEnv(device="cpu"))
    assert lint_fails(getattr(Q, qn), inputs, **kw) == \
        (qn in tpch.EAGER_QUERIES), qn


# --------------------------------------- the whole-query example's query
def _example_tables(n=4000, keys=50, seed=0):
    rng = np.random.default_rng(seed)
    orders = {"k": rng.integers(0, keys, n).astype(np.int64),
              "day": rng.integers(0, 365, n).astype(np.int64),
              "amount": rng.uniform(1.0, 100.0, n)}
    items = {"k": np.arange(keys, dtype=np.int64),
             "label": rng.integers(0, 9, keys).astype(np.int64)}
    return orders, items


def revenue_by_key(orders, items, cutoff=None):
    """``examples/whole_query.py``'s query on the port's ops."""
    recent = filter_table(orders, orders.column("day").data >= cutoff)
    j = join(recent, items, on="k", how="inner")
    g = groupby_aggregate(j, ["k"], [("amount", "sum", "revenue")])
    return sort_table(g, ["revenue"], ascending=False)


def test_lint_passes_the_whole_query_example():
    orders, items = _example_tables()
    assert not lint_fails(revenue_by_key,
                          Table.from_pydict(orders, device="cpu"),
                          Table.from_pydict(items, device="cpu"),
                          cutoff=180)


# ------------------------------------------------------ (b) the results
@pytest.mark.parametrize("qn", QUERIES)
def test_captured_equals_the_eager_query(qn, data, pdfs, frames):
    inputs, kw = _query_inputs(qn, data, pdfs, frames)
    _, _, want, check = case(qn, pdfs, data)
    got = result(captured(getattr(Q, qn), inputs, **kw)) \
        if qn not in ("q6", "q14", "q17", "q19") else \
        float(captured(getattr(Q, qn), inputs, **kw))
    eager = result(getattr(tpch, qn)(inputs, **kw))
    check(got, eager)
    check(got, want)


@pytest.mark.parametrize("qn", IN_SCOPE)
def test_captured_equals_the_jax_compiled_query(qn, data, frames):
    from cylon_tpu import tpch as jtpch

    got = captured(getattr(Q, qn), frames,
                   env=CylonEnv(device="cpu"))
    want = jtpch.compiled(qn)(data)
    if qn in ("q6", "q14"):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-9)
        return
    got, want = got.to_pandas(), want.to_pandas()
    assert list(got.columns) == list(want.columns)
    if qn == "q3":
        _assert_q3_equal(got, want)
    else:
        _frame_close(got, want,
                     {c for c in want.columns if want[c].dtype.kind == "f"})


def test_captured_example_equals_the_jax_example():
    import cylon_tpu as jct
    from cylon_tpu.ops.groupby import groupby_aggregate as jgroupby
    from cylon_tpu.ops.join import join as jjoin
    from cylon_tpu.ops.selection import filter_table as jfilter
    from cylon_tpu.ops.selection import sort_table as jsort
    from cylon_tpu.plan import compile_query as jcompile

    @jcompile
    def jax_revenue_by_key(orders, items, cutoff=None):
        recent = jfilter(orders, orders.column("day").data >= cutoff)
        j = jjoin(recent, items, on="k", how="inner")
        g = jgroupby(j, ["k"], [("amount", "sum", "revenue")])
        return jsort(g, ["revenue"], ascending=False)

    orders, items = _example_tables()
    want = jax_revenue_by_key(jct.Table.from_pydict(orders),
                              jct.Table.from_pydict(items),
                              cutoff=180).to_pandas()
    got = captured(revenue_by_key, Table.from_pydict(orders, device="cpu"),
                   Table.from_pydict(items, device="cpu"),
                   cutoff=180).to_pandas()
    assert list(got.k) == list(want.k)
    np.testing.assert_allclose(got.revenue, want.revenue, rtol=1e-9)


# ------------------------------------------------- (d)'s stand-in graph
def result_tensors(x) -> list:
    """The tensors of a captured program's ``(out, packed, env)``, in a
    fixed order: each table's columns (data, validity) and row count, a
    frame's table, bare tensors."""
    found = []

    def visit(x):
        if torch.is_tensor(x):
            found.append(x)
        elif isinstance(x, Table):
            for c in x.columns.values():
                found.append(c.data)
                if c.validity is not None:
                    found.append(c.validity)
            found.append(x.nrows)
        elif isinstance(x, DataFrame):
            visit(x.table)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(x)
    return found


class StandInGraph:
    """A graph whose capture runs its program (the query in capture mode
    on the graph's own input buffers, at its warm-up's sizes, its staged
    constants frozen) and whose replay runs it again, writing the
    results into the captured tensors, as a CUDA graph's replay
    rewrites its pool. A size or constant that a replay on new data
    would get wrong shows here: a staged constant the warm-up did not
    make raises, an op past its recorded size flags. Counts what the
    cache does with it."""

    device_type = "cpu"
    made: list = []

    def __init__(self):
        self.replays = 0
        self.reset_calls = 0
        self.pool_bytes = 0
        self.program = self.result = None
        StandInGraph.made.append(self)

    def capture(self, program):
        self.program = program
        self.result = program()
        return self.result

    def replay(self):
        self.replays += 1
        new = self.program()
        old_t, new_t = result_tensors(self.result[:2]), \
            result_tensors(new[:2])
        assert len(old_t) == len(new_t)
        for dst, src in zip(old_t, new_t):
            assert dst.shape == src.shape and dst.dtype == src.dtype
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def reset(self):
        self.reset_calls += 1


@pytest.fixture
def stand_in(monkeypatch):
    StandInGraph.made = []
    monkeypatch.setattr(plan, "GRAPH_CLASS", StandInGraph)
    return StandInGraph


# ----------------------------------------------------- (c) the regrow
def test_join_past_its_bound_regrows_the_whole_query(stand_in):
    # 64 x 64 rows on one key: 4096 join rows against a default bound of
    # 128, so the query fits at scale 32 after five doublings
    left = DataFrame({"k": np.ones(64, np.int64),
                      "a": np.arange(64, dtype=np.int64)}, device="cpu")
    right = DataFrame({"k": np.ones(64, np.int64),
                       "b": np.arange(64, dtype=np.float64)}, device="cpu")

    def q(left, right):
        j = left.merge(right, on="k", how="inner")
        return j.groupby(["a"]).agg([("b", "sum", "s")])

    pl = left.to_pandas().merge(right.to_pandas(), on="k")
    want = pl.groupby("a", as_index=False).agg(s=("b", "sum"))
    # the bare capture mode: the join's flag fires, and the whole query
    # fits first at twice the scale five times over
    with pytest.raises(Exception) as flagged:
        bare_captured(q, left, right)
    assert type(flagged.value).__name__ == "OutOfCapacity"
    fits = []
    for scale in (1, 2, 4, 8, 16, 32):
        out, packed, env = plan.run_captured(q, (left, right), scale=scale)
        fits.append(not packed.numpy()[0])
    assert fits == [False] * 5 + [True]
    pd.testing.assert_frame_equal(
        decided(out, packed, env).to_pandas().reset_index(drop=True), want)
    # a graph: its warm-up's join ladder settles at 32x, the graph runs
    # there at scale 1
    telemetry.reset()
    cq = plan.compile_query(q)
    got = cq(left, right).to_pandas()
    assert telemetry.total("plan.capacity_rescales") == 0
    assert [g["scale"] for g in cq.graph_stats()] == [1]
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want)
    pd.testing.assert_frame_equal(cq(left, right).to_pandas(), got)
    # a replay whose flag fires drops its graph and reruns the query: a
    # new warm-up (whose own fetch fits) and capture at the same scale
    real, fired = plan._fetch, []

    def fetch(packed):
        host = real(packed)
        if not fired:
            fired.append(True)
            host = host.copy()
            host[0] = 1
        return host

    plan._fetch = fetch
    try:
        again = cq(left, right).to_pandas()
    finally:
        plan._fetch = real
    assert telemetry.total("plan.overflow_events") == 1
    assert telemetry.total("plan.capacity_rescales") == 0
    assert [g["scale"] for g in cq.graph_stats()] == [1]
    assert len(stand_in.made) == 2 and stand_in.made[0].reset_calls == 1
    pd.testing.assert_frame_equal(again, got)
    pd.testing.assert_frame_equal(cq(left, right).to_pandas(), got)
    assert [g["replays"] for g in cq.graph_stats()] == [1]


# ------------------------------------------------ (d) the bookkeeping
def _small(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return (Table.from_pydict({"k": rng.integers(0, 20, n).astype(np.int64),
                               "day": rng.integers(0, 365, n).astype(np.int64),
                               "amount": rng.uniform(1.0, 9.0, n)},
                              device="cpu"),
            Table.from_pydict({"k": np.arange(20, dtype=np.int64),
                               "label": np.arange(20, dtype=np.int64)},
                              device="cpu"))


def test_a_second_call_on_the_same_tensors_replays(stand_in):
    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    telemetry.reset()
    first = cq(orders, items, cutoff=100).to_pandas()
    second = cq(orders, items, cutoff=100).to_pandas()
    pd.testing.assert_frame_equal(first, second)
    pd.testing.assert_frame_equal(
        first, revenue_by_key(orders, items, cutoff=100).to_pandas())
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 1
    assert telemetry.total("plan.compile_count") == 1
    assert telemetry.total("plan.cache_hits") == 1
    # another static argument is another graph
    cq(orders, items, cutoff=200)
    assert len(stand_in.made) == 2 and len(cq.graph_stats()) == 2


def test_replayed_results_are_copies_out_of_the_pool(stand_in):
    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    cq(orders, items, cutoff=100)
    a = cq(orders, items, cutoff=100)
    b = cq(orders, items, cutoff=100)
    assert a.column("revenue").data.data_ptr() != \
        b.column("revenue").data.data_ptr()


def test_new_tensors_or_an_in_place_write_capture_again(stand_in):
    """New tensors of another layout (a column read through a stride)
    capture again; an in-place write on the captured tensors replays
    with the new values."""
    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    cq(orders, items, cutoff=100)
    wide = torch.stack([orders.column("amount").data] * 2, dim=1)
    strided = Table({"k": orders.column("k"), "day": orders.column("day"),
                     "amount": Column(wide[:, 0], None,
                                      orders.column("amount").dtype, None)},
                    orders.nrows)
    got = cq(strided, items, cutoff=100).to_pandas()
    pd.testing.assert_frame_equal(
        got, revenue_by_key(orders, items, cutoff=100).to_pandas())
    assert len(stand_in.made) == 2 and len(cq.graph_stats()) == 2
    orders.column("amount").data.mul_(2.0)
    got = cq(orders, items, cutoff=100).to_pandas()
    pd.testing.assert_frame_equal(
        got, revenue_by_key(orders, items, cutoff=100).to_pandas())
    assert len(stand_in.made) == 2
    assert stand_in.made[0].replays == 1
    assert stand_in.made[0].reset_calls == 0
    assert len(cq.graph_stats()) == 2


def test_another_schema_on_the_same_tensors_captures_again(stand_in):
    """A table rebuilt around the same tensors with its names swapped,
    or a column given another dictionary, is another input: its call
    captures again and gets its own answer."""
    from cylon_tpu_torch.column import Dictionary

    t = Table.from_pydict({"a": np.arange(300, dtype=np.int64) % 7,
                           "b": np.arange(300, dtype=np.int64) % 11},
                          device="cpu")

    def q(t):
        return groupby_aggregate(t, ["a"], [("b", "sum", "s")])

    cq = plan.compile_query(q)
    first = cq(t).to_pandas()
    swapped = Table({"b": t.column("a"), "a": t.column("b")}, t.nrows)
    got = cq(swapped).to_pandas()
    pd.testing.assert_frame_equal(got, q(swapped).to_pandas())
    assert not got.equals(first) and len(stand_in.made) == 2

    names = Table.from_pandas(pd.DataFrame(
        {"k": ["x", "y", "x", "z"] * 50, "v": np.arange(200.0)}),
        device="cpu")

    def by_name(t):
        return groupby_aggregate(t, ["k"], [("v", "sum", "s")])

    cn = plan.compile_query(by_name)
    cn(names)
    k = names.column("k")
    other = Table({"k": Column(k.data, k.validity, k.dtype,
                               Dictionary(["p", "q", "r"])),
                   "v": names.column("v")}, names.nrows)
    got = cn(other).to_pandas()
    assert list(got.k) == ["p", "q", "r"]
    assert len(stand_in.made) == 4
    # the first table again: its own graph, replayed
    pd.testing.assert_frame_equal(cq(t).to_pandas(), first)
    assert stand_in.made[0].replays == 1


def test_a_capture_tallies_only_its_own_threads_launches(monkeypatch):
    """While a thread captures, its launches go to its tally; another
    thread's launches meanwhile count in the wrappers' counters."""
    import threading

    from cylon_tpu_torch.kernels import build, scan32

    monkeypatch.setattr(build, "capturing", lambda: True)
    before = scan32.launches
    with build.graph_tally() as tally:
        build.count(scan32, 3)
        other = threading.Thread(target=build.count, args=(scan32, 5))
        other.start()
        other.join()
    assert tally == {"scan32": 3}
    assert scan32.launches == before + 5
    build.count(scan32)
    assert scan32.launches == before + 6
    scan32.launches = before


def test_the_graph_runs_at_its_warm_up_sizes():
    """A selective filter shrinks its frame in the eager query; the
    captured program cuts it to the warm-up's capacity with no host
    read, the bare capture mode keeps the whole bound."""
    n = 1 << 17
    df = DataFrame({"a": np.arange(n, dtype=np.int64) % 1000,
                    "b": np.arange(n, dtype=np.float64)}, device="cpu")

    def q(df):
        small = df[df["a"] < 3]
        return small.groupby(["a"]).agg([("b", "sum", "s")]), small

    eager = q(df)[1].table.capacity
    tape = warmed(q, (df,), {})
    with host_read_lint():
        (_, small), _, _ = plan.run_captured(q, (df,), tape=tape)
    (_, bare), _, _ = plan.run_captured(q, (df,))
    assert small.table.capacity == eager == 1024
    assert bare.table.capacity == n
    assert ("shrink", n) in [site for site, _ in tape.sizes]


def test_graphs_past_the_bound_are_let_go_oldest_first(stand_in,
                                                       monkeypatch):
    monkeypatch.setattr(plan, "GRAPH_ENTRIES", 2)
    cq = plan.compile_query(revenue_by_key)
    inputs = [_small(seed=s, n=300 + s) for s in range(3)]
    for o, i in inputs:
        cq(o, i, cutoff=100)
    assert len(cq.graph_stats()) == 2
    assert [g.reset_calls for g in stand_in.made] == [1, 0, 0]
    cq(*inputs[2], cutoff=100)
    assert stand_in.made[2].replays == 1


def test_invalidate_lets_go_of_every_graph(stand_in):
    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    cq(orders, items, cutoff=100)
    cq.invalidate()
    assert cq.graph_stats() == []
    assert stand_in.made[0].reset_calls == 1
    cq(orders, items, cutoff=100)
    assert len(stand_in.made) == 2


def test_a_dropped_input_drops_its_graph(stand_in):
    """A graph holds copies of its inputs, not the caller's tensors: a
    dropped input is freed, and its graph stays to serve the next input
    of its shapes."""
    import weakref

    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    cq(orders, items, cutoff=100)
    gone = weakref.ref(orders.column("amount").data)
    del orders
    gc.collect()
    assert gone() is None
    assert len(cq.graph_stats()) == 1
    assert stand_in.made[0].reset_calls == 0
    keep, _ = _small(seed=1)
    got = cq(keep, items, cutoff=100).to_pandas()
    pd.testing.assert_frame_equal(
        got, revenue_by_key(keep, items, cutoff=100).to_pandas())
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 1


def test_a_result_on_an_input_does_not_keep_it_alive(stand_in):
    import weakref

    orders, items = _small()
    cq = plan.compile_query(lambda t: t)
    first = cq(orders)          # the warm run's result: the input itself
    got = cq(orders)            # a replay's: a copy
    assert got.column("k").data.data_ptr() != \
        orders.column("k").data.data_ptr()
    pd.testing.assert_frame_equal(got.to_pandas(), orders.to_pandas())
    gone = weakref.ref(orders.column("k").data)
    del orders, first, got
    gc.collect()
    assert gone() is None
    assert len(cq.graph_stats()) == 1


def test_serve_engine_lets_go_of_its_graphs_on_close(stand_in):
    from cylon_tpu_torch.serve import ServeEngine

    orders, items = _small()
    cq = plan.compile_query(revenue_by_key)
    eng = ServeEngine(CylonEnv(device="cpu"))
    with eng.session("t") as s:
        s.submit(lambda: cq(orders, items, cutoff=100)).result(60)
    assert len(cq.graph_stats()) == 1
    eng.close()
    assert cq.graph_stats() == []


# ------------------------------------------------- the eager route
def test_cpu_tensors_take_the_eager_route(frames):
    telemetry.reset()
    tpch.compiled("q6")(frames)
    assert telemetry.total("plan.eager_runs") == 1
    assert tpch.compiled("q6").graph_stats() == []


def test_a_world_of_more_ranks_takes_the_eager_route(stand_in, data):
    telemetry.reset()
    ThreadWorld(2, timeout=120).run(
        lambda comm: tpch.compiled("q6")(data, env=CylonEnv(
            comm, device="cpu")))
    assert stand_in.made == []
    assert telemetry.total("plan.eager_runs") == 2


def test_no_shrink_is_a_module_constant(monkeypatch):
    t = Table.from_pydict({"a": np.arange(1 << 17, dtype=np.int64)},
                          device="cpu")
    small = DataFrame(t).filter(t.column("a").data < 10)
    assert small.table.capacity == 1024
    monkeypatch.setattr(frame, "_NO_SHRINK", True)
    assert DataFrame(t).filter(t.column("a").data < 10).table.capacity \
        == 1 << 17


def test_a_result_frame_with_an_index_refuses_to_capture(stand_in):
    orders, _ = _small()
    cq = plan.compile_query(
        lambda t: DataFrame(t).set_index("k"))
    with pytest.raises(plan.CaptureFailed, match="index"):
        cq(orders)


def test_threads_sharing_a_compiled_query_keep_one_graph_an_input(
        stand_in):
    """Twelve threads call one CompiledQuery on six input sets, two of
    each of three shapes, with a short switch interval: every result is
    its set's (the sets of one shape take turns in one graph's input
    buffers), and the cache ends with one graph a shape (a lost update
    would leave a second graph or a stale one)."""
    import sys
    import threading

    sets = [_small(seed=s, n=300 + s % 3) for s in range(6)]
    want = [revenue_by_key(o, i, cutoff=100).to_pandas() for o, i in sets]
    cq = plan.compile_query(revenue_by_key)
    errors = []

    def worker(k):
        try:
            for r in range(6):
                j = (k + r) % 6
                got = cq(*sets[j], cutoff=100).to_pandas()
                pd.testing.assert_frame_equal(got, want[j])
        except Exception as exc:   # noqa: BLE001 -- reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(cq.graph_stats()) == 3
    live = [g for g in stand_in.made if g.reset_calls == 0]
    assert len(live) == 3
