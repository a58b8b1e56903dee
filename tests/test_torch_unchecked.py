"""Compiled queries in the unchecked mode (``compile_query(check=False)``,
``cylon_tpu_torch.plan``) and the JAX package's last public-surface
names, on the CPU.

An unchecked :class:`~cylon_tpu_torch.plan.CompiledQuery` replays its
graph with no host read: its results are copied out at their full
capacities and the overflow flags folded into them on the device. These
tests put ``test_torch_capture``'s stand-in graph in
``plan.GRAPH_CLASS`` for the graph route, and count ``plan._fetch``.

(a) the port of ``tests/test_tight_capacity.py``'s unchecked sort,
    against the JAX package's unchecked query;
(b) unchecked replays fetch nothing and their first ``num_rows`` rows
    are the checked replays' on the same data, the example's query, a
    frame query and TPC-H queries locally and at a world of one;
(c) data past a recorded size poisons the result (``num_rows`` raises,
    a scalar is NaN or ``iinfo.min``, a shard at W = 1 is marked) and
    the graph stays until ``invalidate()``;
(d) ``shared_compiled`` keeps one object a ``(fn, check)``;
(e) the eager route at W = 4 against the JAX package's unchecked query
    on ``env4``;
(f)-(h) ``join(left, right, JoinConfig)``, ``CylonEnv(config,
    distributed=False)``, ``context.MPIConfig`` and the error codes.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu_torch import (CylonEnv, DataFrame, OutOfCapacity, Table,
                             ThreadWorld, plan, telemetry)
from cylon_tpu_torch.ops.aggregates import table_aggregate
from cylon_tpu_torch.ops.selection import sort_table
from cylon_tpu_torch.tpch import queries as Q
from test_torch_capture import (QUERIES, _example_tables, _query_inputs,
                                data, pdfs, revenue_by_key, stand_in,
                                warmed)  # noqa: F401 -- fixtures
from test_torch_capture import frames as capture_frames  # noqa: F401
from test_torch_rebind import (SHRUNK, frame_equal, frame_revenue, frames,
                               tables, tpch_sets)  # noqa: F401 -- a fixture


def counting_fetch(monkeypatch) -> list:
    """Count ``plan._fetch`` calls; the list grows by one a fetch."""
    calls, real = [], plan._fetch

    def fetch(packed):
        calls.append(packed.numel())
        return real(packed)

    monkeypatch.setattr(plan, "_fetch", fetch)
    return calls


def totals() -> dict:
    return {k: telemetry.total(k) for k in (
        "plan.compile_count", "plan.cache_hits", "plan.overflow_events",
        "plan.capacity_rescales")}


def same_rows(got, want):
    """``got``'s first ``num_rows`` rows are ``want``'s, bit for bit."""
    g = got.table if isinstance(got, DataFrame) else got
    w = want.table if isinstance(want, DataFrame) else want
    n = w.num_rows
    assert g.num_rows == n
    assert g.column_names == w.column_names
    for name in w.column_names:
        a, b = g.column(name), w.column(name)
        assert torch.equal(a.data[:n], b.data[:n]), name
        assert (a.validity is None) == (b.validity is None), name
        if a.validity is not None:
            assert torch.equal(a.validity[:n], b.validity[:n]), name


# ------------------------------------------------------------- (a)
def test_unchecked_sort_matches_the_jax_unchecked_query():
    """``tests/test_tight_capacity.py``'s unchecked sort: 512 rows come
    back with ``num_rows == 512``, bit for bit the JAX package's."""
    import cylon_tpu as jct
    from cylon_tpu.ops.selection import sort_table as jsort
    from cylon_tpu.plan import compile_query as jcompile

    k = np.random.default_rng(42).integers(0, 100, 512).astype(np.int64)

    @plan.compile_query(check=False)
    def q(t):
        return sort_table(t, ["k"])

    @jcompile(check=False)
    def jq(t):
        return jsort(t, ["k"])

    before = totals()
    out = q(Table.from_pydict({"k": k}, device="cpu"))
    assert out.num_rows == 512
    want = jq(jct.Table.from_pydict({"k": k}))
    assert out.capacity == want.capacity
    np.testing.assert_array_equal(out.column("k").data.numpy(),
                                  np.asarray(want.column("k").data))
    assert totals()["plan.capacity_rescales"] == \
        before["plan.capacity_rescales"]


def test_compile_query_takes_check_as_the_jax_one():
    cq = plan.compile_query(revenue_by_key)
    assert cq._check is True
    assert plan.compile_query(check=False)(revenue_by_key)._check is False
    assert plan.CompiledQuery(revenue_by_key, check=False)._check is False
    assert cq.__name__ == "revenue_by_key"


# ------------------------------------------------------------- (b)
def test_unchecked_replays_fetch_nothing(stand_in, monkeypatch):
    checked = plan.compile_query(revenue_by_key)
    unchecked = plan.compile_query(revenue_by_key, check=False)
    sets = [tables(*_example_tables(seed=s)) for s in range(3)]
    fetches = counting_fetch(monkeypatch)
    first = unchecked(*sets[0], cutoff=180)
    # a key with no graph warms up as a checked call does: one fetch, a
    # shrunk result
    assert len(fetches) == 1
    frame_equal(first, revenue_by_key(*sets[0], cutoff=180))
    checked(*sets[0], cutoff=180)
    want = [checked(*s, cutoff=180) for s in sets]
    del fetches[:]
    spans, span = [], plan._span

    def named(name, *a, **k):
        spans.append(name)
        return span(name, *a, **k)

    monkeypatch.setattr(plan, "_span", named)
    before = totals()
    got = [unchecked(*s, cutoff=180) for s in sets + sets]
    assert fetches == []
    # the JAX package's spans: a dispatch a call, no fetch; the
    # dispatch's device-timed copy-in inside it
    assert spans == ["plan.dispatch", "plan.copy_in"] * 6
    assert {k: v - before[k] for k, v in totals().items()} == {
        "plan.compile_count": 0, "plan.cache_hits": 6,
        "plan.overflow_events": 0, "plan.capacity_rescales": 0}
    for g, w in zip(got, want + want):
        # full capacity: the graph's, not shrunk to the rows
        assert g.capacity == checked._graphs[next(iter(
            checked._graphs))].out.capacity
        same_rows(g, w)
    assert [e.replays for e in unchecked._graphs.values()] == [6]


def test_unchecked_frame_replays_equal_the_checked(stand_in, monkeypatch):
    """The frame query, whose filter shrinks to a size its warm-up
    recorded: the unchecked copy keeps the full capacity."""
    checked = plan.compile_query(frame_revenue)
    unchecked = plan.compile_query(frame_revenue, check=False)
    a = frames(*_example_tables(n=SHRUNK, seed=0))
    b = frames(*_example_tables(n=SHRUNK, seed=1))
    for cq in (checked, unchecked):
        cq(*a, cutoff=300)
    fetches = counting_fetch(monkeypatch)
    got = [unchecked(*s, cutoff=300) for s in (a, b)]
    assert fetches == []
    for g, s in zip(got, (a, b)):
        w = checked(*s, cutoff=300)
        assert g.table.capacity >= w.table.capacity
        same_rows(g, w)


@pytest.mark.parametrize("world", ["local", "w1"])
@pytest.mark.parametrize("qn", ["q3", "q5", "q6"])
def test_unchecked_tpch_replays_equal_the_checked(qn, world, stand_in,
                                                   tpch_sets, monkeypatch):
    (a, b), _ = tpch_sets
    kw = {"env": CylonEnv(device="cpu")} if world == "w1" else {}
    fn = getattr(Q, qn)
    checked = plan.compile_query(fn)
    unchecked = plan.compile_query(fn, check=False)
    for cq in (checked, unchecked):
        cq(a, **kw)
    fetches = counting_fetch(monkeypatch)
    got = [unchecked(s, **kw) for s in (a, b)]
    assert fetches == []
    for g, s in zip(got, (a, b)):
        w = checked(s, **kw)
        if qn == "q6":
            assert torch.equal(g, w) and not torch.isnan(g)
        else:
            same_rows(g, w)


# ------------------------------------------------------------- (c)
def hot(orders):
    """Every row past the filter: more rows than the shrink the
    warm-up recorded (the sets keep about 23K of 131072)."""
    return dict(orders, day=np.full_like(orders["day"], 300))


def test_data_past_a_recorded_size_poisons_the_result(stand_in,
                                                      monkeypatch):
    cq = plan.compile_query(frame_revenue, check=False)
    orders, items = _example_tables(n=SHRUNK)
    cq(*frames(orders, items), cutoff=300)
    fetches = counting_fetch(monkeypatch)
    before = totals()
    got = cq(*frames(hot(orders), items), cutoff=300)
    assert fetches == []
    with pytest.raises(OutOfCapacity):
        got.table.num_rows
    assert int(got.table.nrows) == got.table.capacity + 1
    # the graph stays: the host never learned that its flag fired
    assert {k: v - before[k] for k, v in totals().items()} == {
        "plan.compile_count": 0, "plan.cache_hits": 1,
        "plan.overflow_events": 0, "plan.capacity_rescales": 0}
    assert stand_in.made[0].reset_calls == 0 and len(cq.graph_stats()) == 1
    # data that fits again replays clean on the same graph
    frame_equal(cq(*frames(orders, items), cutoff=300),
                frame_revenue(*frames(orders, items), cutoff=300))
    cq.invalidate()
    assert stand_in.made[0].reset_calls == 1 and cq.graph_stats() == []


def guarded_recent(orders, cutoff=None):
    """A filter of a frame of an env of one rank (a shard, kept at its
    capacity) beside a flag on the data, as an op's guard registers
    one: no day may lie past 365."""
    plan.note_overflow((orders.table.column("day").data > 365).any())
    return orders[orders["day"] >= cutoff]


def test_a_shard_at_a_world_of_one_is_marked(stand_in, monkeypatch):
    env = CylonEnv(device="cpu")
    cq = plan.compile_query(guarded_recent, check=False)
    orders, _ = _example_tables(n=2000)
    cq(DataFrame(orders, env=env, device="cpu"), cutoff=300)
    fetches = counting_fetch(monkeypatch)
    got = cq(DataFrame(orders, env=env, device="cpu"), cutoff=300)
    assert got.env is env and got.table.num_rows == \
        int((orders["day"] >= 300).sum())
    late = dict(orders, day=orders["day"] + 100)
    got = cq(DataFrame(late, env=env, device="cpu"), cutoff=300)
    assert fetches == []
    assert got.env is env
    with pytest.raises(OutOfCapacity):
        got.table.num_rows


def revenue_and_count(orders, cutoff=None):
    """Two scalars of a filtered frame, whose filter shrinks to the
    bucket of its rows: a float and an integer."""
    recent = orders[orders["day"] >= cutoff].table
    return (table_aggregate(recent, "amount", "sum"),
            table_aggregate(recent, "k", "count"))


def test_a_scalar_only_query_whose_flag_fires_is_poison(stand_in,
                                                        monkeypatch):
    cq = plan.compile_query(revenue_and_count, check=False)
    orders, _ = _example_tables(n=SHRUNK)
    s, n = cq(DataFrame(orders, device="cpu"), cutoff=300)
    want = orders["day"] >= 300
    assert int(n) == int(want.sum())
    np.testing.assert_allclose(float(s), orders["amount"][want].sum(),
                               rtol=1e-9)
    fetches = counting_fetch(monkeypatch)
    s, n = cq(DataFrame(hot(orders), device="cpu"), cutoff=300)
    assert fetches == []
    assert torch.isnan(s)
    assert n.dtype == torch.int64 and int(n) == torch.iinfo(torch.int64).min
    assert stand_in.made[0].reset_calls == 0
    # the checked query reruns instead, and answers
    checked = plan.compile_query(revenue_and_count)
    checked(DataFrame(orders, device="cpu"), cutoff=300)
    s, n = checked(DataFrame(hot(orders), device="cpu"), cutoff=300)
    assert int(n) == SHRUNK
    cq.invalidate()
    assert stand_in.made[0].reset_calls == 1


def test_a_replay_that_fits_is_never_poisoned(stand_in):
    """The fold reads only the flags: a clean replay keeps its values,
    zeros and empty results included."""
    cq = plan.compile_query(revenue_and_count, check=False)
    orders, _ = _example_tables(n=SHRUNK)
    cq(DataFrame(orders, device="cpu"), cutoff=300)
    s, n = cq(DataFrame(orders, device="cpu"), cutoff=400)
    assert float(s) == 0.0 and int(n) == 0


def result_leaves(x) -> list:
    """The tables (a frame's too) and bare tensors of a query result, in
    order; any other kind of value fails: the fold would not reach it."""
    if isinstance(x, DataFrame):
        return [x.table]
    if isinstance(x, Table) or torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in result_leaves(v)]
    if isinstance(x, dict):
        return [y for v in x.values() for y in result_leaves(v)]
    raise AssertionError(f"a result of kind {type(x).__name__}")


@pytest.mark.parametrize("world", ["local", "w1"])
@pytest.mark.parametrize("qn", QUERIES)
def test_every_tpch_result_kind_is_poisoned_by_a_fired_flag(
        qn, world, data, pdfs, capture_frames):
    """The audit of the fold over the 22 queries' results, locally and
    at a world of one: the program a graph captures, run once at its
    warm-up's sizes; with word 0 of its packed tensor set, every table
    of the copy-out (every shard) raises on ``num_rows`` and every bare
    tensor is NaN or ``iinfo.min``; with it clear, the copy-out's first
    ``num_rows`` rows are the checked replay's."""
    inputs, kw = _query_inputs(qn, data, pdfs, capture_frames)
    if world == "w1":
        kw = dict(kw, env=CylonEnv(device="cpu"))
    fn = getattr(Q, qn)
    out, packed, env = plan.run_captured(fn, (inputs,), kw,
                                         tape=warmed(fn, (inputs,), kw))
    assert not packed.reshape(-1, packed.shape[-1])[:, 0].any()
    want = result_leaves(plan._shrink_results(
        out, plan._decide(out, packed.numpy(), env)))
    clean = result_leaves(plan._map_tables(out,
                                           plan._poisoned_copies(packed)))
    fired = packed.clone()
    fired.reshape(-1, fired.shape[-1])[:, 0] = 1
    poisoned = result_leaves(plan._map_tables(
        out, plan._poisoned_copies(fired)))
    assert len(want) == len(clean) == len(poisoned) > 0
    for w, c, p in zip(want, clean, poisoned):
        if torch.is_tensor(w):
            assert torch.equal(c, w)
            bad = torch.isnan(p) if p.is_floating_point() \
                else p == torch.iinfo(p.dtype).min
            assert bool(bad.all()), qn
        else:
            same_rows(c, w)
            with pytest.raises(OutOfCapacity):
                p.num_rows


# ------------------------------------------------------------- (d)
def test_shared_compiled_keys_on_check():
    def q(t):
        return t

    a = plan.shared_compiled(q)
    b = plan.shared_compiled(q, check=False)
    assert a is not b
    assert a._check is True and b._check is False
    assert plan.shared_compiled(q) is a
    assert plan.shared_compiled(q, check=0) is b
    assert plan.shared_compiled(q, check=True) is a


# ------------------------------------------------------------- (e)
def test_eager_route_at_w4_matches_the_jax_unchecked_query(env4):
    import cylon_tpu as jct
    from cylon_tpu.parallel import dist_join as jdist_join
    from cylon_tpu.parallel import scatter_table as jscatter
    from cylon_tpu.plan import compile_query as jcompile
    from cylon_tpu_torch.parallel.dist_ops import dist_join
    from cylon_tpu_torch.parallel.dtable import gather_table, scatter_table
    from test_torch_dist_join import _unordered_eq, to_port

    # one right row a key: the join fits the JAX exchange's default
    # receive bound, which its unchecked query does not regrow
    rng = np.random.default_rng(20)
    ldf = pd.DataFrame({"k": rng.integers(0, 300, 900),
                        "a": rng.normal(size=900)})
    rdf = pd.DataFrame({"k": rng.permutation(300),
                        "b": rng.integers(0, 50, 300)})
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)

    @jcompile(check=False)
    def jq(left, right):
        return jdist_join(env4, left, right, on="k")

    want = jq(jscatter(env4, jl), jscatter(env4, jr))
    want = jct.parallel.dist_to_pandas(env4, want)

    @plan.compile_query(check=False)
    def q(env, left, right):
        return dist_join(env, left, right, on="k")

    tl, tr = to_port(jl), to_port(jr)
    telemetry.reset()

    def rank(comm):
        env = CylonEnv(comm)
        res = q(env, scatter_table(env, tl), scatter_table(env, tr))
        return gather_table(env, res).to_pandas()

    got = ThreadWorld(4).run(rank)
    assert telemetry.total("plan.capacity_rescales") == 0
    assert telemetry.total("plan.eager_runs") == 4
    _unordered_eq(got[0], want)
    _unordered_eq(got[0], ldf.merge(rdf, on="k"))


# ------------------------------------------------------------- (f)
@pytest.mark.parametrize("how,algorithm", [("inner", "sort"),
                                           ("left", "hash"),
                                           ("right", "sort"),
                                           ("fullouter", "sort")])
def test_join_takes_a_join_config_as_the_jax_join(how, algorithm):
    import cylon_tpu as jct
    from cylon_tpu.config import JoinConfig as JJoinConfig
    from cylon_tpu.ops.join import join as jjoin
    from cylon_tpu_torch.config import JoinConfig
    from cylon_tpu_torch.ops.join import join

    rng = np.random.default_rng(7)
    left = {"a": rng.integers(0, 60, 200).astype(np.int64),
            "v": rng.normal(size=200)}
    right = {"b": rng.permutation(80).astype(np.int64)[:50],
             "v": rng.normal(size=50)}
    args = (how, algorithm, ["a"], ["b"], ("_l", "_r"))
    got = join(Table.from_pydict(left, device="cpu"),
               Table.from_pydict(right, device="cpu"),
               JoinConfig.make(*args))
    want = jjoin(jct.Table.from_pydict(left), jct.Table.from_pydict(right),
                 JJoinConfig.make(*args))
    n = want.num_rows
    assert got.num_rows == n
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        np.testing.assert_array_equal(g.data[:n].numpy(),
                                      np.asarray(w.data)[:n], err_msg=name)
        assert (g.validity is None) == (w.validity is None), name
        if w.validity is not None:
            np.testing.assert_array_equal(g.validity[:n].numpy(),
                                          np.asarray(w.validity)[:n])
    # the keywords a config replaces are the same join
    kw = join(Table.from_pydict(left, device="cpu"),
              Table.from_pydict(right, device="cpu"), left_on="a",
              right_on="b", how=how, suffixes=("_l", "_r"),
              algorithm=algorithm)
    same_rows(got, kw)
    # Table.join forwards it by keyword, as the JAX Table.join does
    same_rows(Table.from_pydict(left, device="cpu").join(
        Table.from_pydict(right, device="cpu"),
        config=JoinConfig.make(*args)), kw)


# ------------------------------------------------------------- (g)
def test_cylon_env_distributed_false_is_a_world_of_one():
    from cylon_tpu_torch.context import DistConfig, LocalConfig
    from cylon_tpu_torch.errors import InvalidArgument

    env = CylonEnv(LocalConfig(), distributed=False)
    assert env.world_size == 1 and env.rank == 0
    env = CylonEnv(DistConfig(backend="gloo"), distributed=False,
                   device="cpu")
    assert env.world_size == 1 and not env.is_distributed
    assert not torch.distributed.is_initialized()
    env = CylonEnv(config=DistConfig(), distributed=False, device="cpu")
    assert env.world_size == 1
    t = Table.from_pydict({"k": np.arange(5, dtype=np.int64)}, device="cpu")
    assert env.device.type == "cpu" and t.num_rows == 5

    def rank(comm):
        with pytest.raises(InvalidArgument, match="world of one"):
            CylonEnv(comm, distributed=False)
        return CylonEnv(comm).world_size

    assert ThreadWorld(2).run(rank) == [2, 2]


# ------------------------------------------------------------- (h)
def test_mpi_config_and_the_error_codes_are_the_jax_packages():
    from cylon_tpu import context as jcontext
    from cylon_tpu import errors as jerrors
    from cylon_tpu_torch import context, errors

    assert context.MPIConfig is context.DistConfig
    assert hasattr(jcontext, "MPIConfig")
    want = {m.name: int(m) for m in jerrors.Code}
    got = {m.name: int(m) for m in errors.Code}
    assert got == want
    for name in ("SerializationError", "RError", "CodeGenError",
                 "ExpressionValidationError", "ExecutionError",
                 "AlreadyExists"):
        assert int(getattr(errors.Code, name)) == \
            int(getattr(jerrors.Code, name))
