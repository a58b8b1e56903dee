"""Compiled queries that serve any input of their shapes
(``cylon_tpu_torch.plan``) and the bucketed hash join guarded inside a
graph (``ops.join._guarded_route``), on the CPU.

A :class:`~cylon_tpu_torch.plan.CompiledQuery` keys its graphs by the
inputs' schema, shapes, layout and dictionary content, captures each on
its own input buffers and copies a call's tensors in before a replay.
These tests put ``test_torch_capture``'s stand-in graph in
``plan.GRAPH_CLASS``: its replay runs the captured program again on the
graph's input buffers at the warm-up's sizes with the staged constants
frozen, so a size the new data outgrows flags and a constant made from
the data raises, as they would on the card.

(a) new tensors of the same shapes replay (no new capture) and equal the
    port's eager query and the JAX package's compiled query on the new
    data: the whole-query example and ``IN_SCOPE``'s TPC-H queries;
(b) equal-content dictionaries in new objects replay, other content
    captures again; aliased and strided inputs keep their layout in the
    graph's buffers; the caller's inputs are never written;
(c) a replay whose new data outgrows a recorded size (a filter's shrink,
    a join's bound) flags, and the call reruns and returns the eager
    answer, at the same scale;
(d) the bucketed hash route: the host-read lint over all 22 queries
    under ``CYLON_TPU_JOIN_HASH_IMPL=bucketed``, the captured route
    against the JAX package's ``hash_guarded`` compiled query, and a
    build side past the chain width, whose replay flags and whose rerun
    takes the sort join.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu_torch import CylonEnv, DataFrame, Table, plan, telemetry, tpch
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.ops.dictenc import unify_table_dictionaries
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.tpch import queries as Q
from cylon_tpu_torch.tpch.manifest import MANIFEST
from test_torch_capture import (IN_SCOPE, QUERIES, _example_tables,
                                _query_inputs, lint_fails, revenue_by_key,
                                stand_in)  # noqa: F401 -- a fixture
from test_tpch import SEED, SF, _assert_q3_equal, _frame_close

#: orders rows of the shrink tests: a frame shrinks above 65536 rows
SHRUNK = 1 << 17

BUCKETED = {"CYLON_TPU_JOIN_ALGORITHM": "hash",
            "CYLON_TPU_JOIN_HASH_IMPL": "bucketed"}


def tables(orders, items):
    return (Table.from_pydict(orders, device="cpu"),
            Table.from_pydict(items, device="cpu"))


def totals() -> dict:
    return {k: telemetry.total(k) for k in (
        "plan.compile_count", "plan.cache_hits", "plan.overflow_events",
        "plan.capacity_rescales")}


def moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in totals().items()}


def frame_equal(got, want):
    pd.testing.assert_frame_equal(got.to_pandas().reset_index(drop=True),
                                  want.to_pandas().reset_index(drop=True))


@pytest.fixture
def bucketed(monkeypatch):
    for k, v in BUCKETED.items():
        monkeypatch.setenv(k, v)


def jax_example():
    """``examples/whole_query.py``'s query as a fresh JAX compiled query
    (its own executable cache, so the route the environment selects is
    traced anew)."""
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

    return jax_revenue_by_key


def assert_equals_jax(got, jq, orders, items, cutoff):
    import cylon_tpu as jct

    want = jq(jct.Table.from_pydict(orders), jct.Table.from_pydict(items),
              cutoff=cutoff).to_pandas()
    got = got.to_pandas()
    assert list(got.k) == list(want.k)
    np.testing.assert_allclose(got.revenue, want.revenue, rtol=1e-9)


# --------------------------------------------------------- (a) rebinding
def test_new_tensors_of_the_same_shapes_replay(stand_in):
    cq = plan.compile_query(revenue_by_key)
    a = tables(*_example_tables(seed=0))
    cq(*a, cutoff=180)
    jq = jax_example()
    for seed in (1, 2):
        raw = _example_tables(seed=seed)
        b = tables(*raw)
        before = totals()
        got = cq(*b, cutoff=180)
        assert moved(before) == {"plan.compile_count": 0,
                                 "plan.cache_hits": 1,
                                 "plan.overflow_events": 0,
                                 "plan.capacity_rescales": 0}
        frame_equal(got, revenue_by_key(*b, cutoff=180))
        assert_equals_jax(got, jq, *raw, cutoff=180)
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 2
    # A again, then B again: each the answer on its own data
    frame_equal(cq(*a, cutoff=180), revenue_by_key(*a, cutoff=180))
    frame_equal(cq(*b, cutoff=180), revenue_by_key(*b, cutoff=180))
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 4


def _tpch_sets(queries):
    """Two TPC-H input sets (seeds ``SEED`` and ``SEED + 1``, the
    queries' manifest columns) as frames brought to the same capacities
    and, column by column, onto one dictionary (at this scale a seed
    draws 138 of the 150 part types, another 139), and their raw
    mappings."""
    keep = {}
    for qn in queries:
        for t, cols in MANIFEST[qn].items():
            keep.setdefault(t, set()).update(cols)
    raws = [tpch.generate(SF, s, keep=keep) for s in (SEED, SEED + 1)]
    sets = [tpch.ingest(r, device="cpu") for r in raws]
    for name in sets[0]:
        cap = max(s[name].table.capacity for s in sets)
        padded = unify_table_dictionaries(
            [s[name].table.with_capacity(cap) for s in sets])
        for s, t in zip(sets, padded):
            s[name] = DataFrame(t)
    return sets, raws


@pytest.fixture(scope="module")
def tpch_sets():
    return _tpch_sets(IN_SCOPE)


@pytest.mark.parametrize("qn", IN_SCOPE)
def test_tpch_queries_replay_new_tables_of_their_shapes(qn, stand_in,
                                                        tpch_sets):
    from cylon_tpu import tpch as jtpch

    (a, b), (_, raw_b) = tpch_sets
    env = CylonEnv(device="cpu")
    cq = plan.compile_query(getattr(Q, qn))
    cq(a, env=env)
    before = totals()
    got = cq(b, env=env)
    assert moved(before)["plan.compile_count"] == 0
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 1
    eager = getattr(tpch, qn)(b, env=env)
    want = jtpch.compiled(qn)(raw_b)
    if qn in ("q6", "q14"):
        np.testing.assert_allclose(float(got), float(eager), rtol=1e-12)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-9)
        return
    got, eager, want = got.to_pandas(), eager.to_pandas(), want.to_pandas()
    pd.testing.assert_frame_equal(got, eager)
    if qn == "q3":
        _assert_q3_equal(got, want)
    else:
        _frame_close(got, want,
                     {c for c in want.columns if want[c].dtype.kind == "f"})


def test_an_in_place_write_replays_with_the_new_values(stand_in):
    cq = plan.compile_query(revenue_by_key)
    orders, items = tables(*_example_tables())
    cq(orders, items, cutoff=180)
    cq(orders, items, cutoff=180)
    orders.column("day").data.sub_(90)
    orders.column("amount").data.mul_(3.0)
    frame_equal(cq(orders, items, cutoff=180),
                revenue_by_key(orders, items, cutoff=180))
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 2


# --------------------------------------------- (b) dictionaries, layout
def _named(seed, names):
    rng = np.random.default_rng(seed)
    return Table.from_pandas(pd.DataFrame(
        {"k": rng.choice(names, 400), "v": rng.uniform(0, 1, 400)}),
        device="cpu")


def by_name(t):
    return groupby_aggregate(t, ["k"], [("v", "sum", "s")])


def test_equal_dictionaries_in_new_objects_replay(stand_in):
    cq = plan.compile_query(by_name)
    first = _named(0, ["x", "y", "z"])
    cq(first)
    again = _named(1, ["x", "y", "z"])
    assert again.column("k").dictionary is not first.column("k").dictionary
    frame_equal(cq(again), by_name(again))
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 1
    other = _named(1, ["p", "q", "r"])
    got = cq(other)
    frame_equal(got, by_name(other))
    assert list(got.to_pandas().k) == ["p", "q", "r"]
    assert len(stand_in.made) == 2


def shared_offsets(leaves) -> list:
    """Each leaf's storage (numbered in order of first sight) and its
    byte offset from the first leaf seen on that storage."""
    first: dict = {}
    out = []
    for x in leaves:
        s = x.untyped_storage().data_ptr()
        g, p = first.setdefault(s, (len(first), x.data_ptr()))
        out.append((g, x.data_ptr() - p))
    return out


def test_aliased_and_strided_inputs_keep_their_layout(stand_in):
    n = 512
    base = torch.arange(3 * n, dtype=torch.int64)
    wide = torch.rand(n, 2, dtype=torch.float64)

    def make(shift):
        b = base + shift
        w = wide + shift
        # k and day share one storage; amount is a column of stride 2
        return Table({"k": Column(b[:n] % 7, None, _i64, None),
                      "day": Column(b[n:2 * n], None, _i64, None),
                      "shared": Column(b[n + 1:2 * n + 1], None, _i64, None),
                      "amount": Column(w[:, 1], None, _f64, None)},
                     torch.tensor(n - 3, dtype=torch.int32))

    def q(t):
        s = t.column("day").data + t.column("shared").data
        g = groupby_aggregate(t.add_column("s", Column(s, None, _i64, None)),
                              ["k"], [("amount", "sum", "a"),
                                      ("s", "max", "m")])
        return g

    cq = plan.compile_query(q)
    t0 = make(0)
    cq(t0)
    (entry,) = cq._graphs.values()
    _, leaves, _ = plan._describe((t0,), {})
    mine = entry.inputs.leaves
    assert [x.stride() for x in mine] == [x.stride() for x in leaves]
    assert shared_offsets(mine) == shared_offsets(leaves)
    assert [x.data_ptr() % 64 for x in mine] == \
        [x.data_ptr() % 64 for x in leaves]
    t1 = make(5)
    frame_equal(cq(t1), q(t1))
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 1
    # another layout (day no longer shares k's storage) captures again
    t2 = Table({**t1.columns, "day": Column(t1.column("day").data.clone(),
                                            None, _i64, None)}, t1.nrows)
    frame_equal(cq(t2), q(t2))
    assert len(stand_in.made) == 2


def test_the_callers_inputs_are_never_written(stand_in):
    cq = plan.compile_query(frame_revenue)
    sets = [frames(*_example_tables(n=SHRUNK, seed=s)) for s in range(3)]
    copies = [[(x.clone(), x._version) for x in plan._describe(s, {})[1]]
              for s in sets]
    for s in sets + sets:
        cq(*s, cutoff=300)
    hot = frames(*_example_tables(n=SHRUNK, seed=3))
    # a flagged replay, rerun: every row past the filter's shrink to
    # 32768 (the sets keep about 23K rows each)
    hot[0].table.column("day").data.fill_(300)
    before = totals()
    cq(*hot, cutoff=300)
    assert moved(before)["plan.overflow_events"] == 1
    for s, kept in zip(sets, copies):
        for x, (c, v) in zip(plan._describe(s, {})[1], kept):
            assert torch.equal(x, c) and x._version == v


# ------------------------------------------------------- (c) stale sizes
def frame_revenue(orders, items, cutoff=None):
    """The example's query on frames, whose filter shrinks its result to
    the power-of-two bucket of its rows (above 65536 rows of capacity,
    ``Table.shrink_to_fit``): a size taken from the data."""
    recent = orders[orders["day"] >= cutoff]
    j = recent.merge(items, on="k", how="inner")
    g = j.groupby(["k"]).agg([("amount", "sum", "revenue")])
    return g.sort_values(["revenue"], ascending=False)


def frames(orders, items):
    return (DataFrame(orders, device="cpu"), DataFrame(items, device="cpu"))


def test_a_replay_past_a_recorded_size_reruns(stand_in):
    cq = plan.compile_query(frame_revenue)
    orders, items = _example_tables(n=SHRUNK)
    cq(*frames(orders, items), cutoff=300)
    # every row passes the filter: past the shrink the warm-up recorded
    hot = dict(orders, day=np.full_like(orders["day"], 300))
    c = frames(hot, items)
    before = totals()
    got = cq(*c, cutoff=300)
    assert moved(before) == {"plan.compile_count": 1,
                             "plan.cache_hits": 1,
                             "plan.overflow_events": 1,
                             "plan.capacity_rescales": 0}
    frame_equal(got, frame_revenue(*c, cutoff=300))
    assert stand_in.made[0].reset_calls == 1 and len(stand_in.made) == 2
    assert [g["scale"] for g in cq.graph_stats()] == [1]
    # the rerun's graph replays C
    frame_equal(cq(*c, cutoff=300), frame_revenue(*c, cutoff=300))
    assert stand_in.made[1].replays == 1


def test_a_replay_past_a_joins_bound_reruns(stand_in):
    """Items with each key four times: the join's rows pass the bound its
    warm-up's ladder settled at; the rerun's ladder climbs past it."""
    cq = plan.compile_query(frame_revenue)
    orders, _ = _example_tables(n=2000)
    items4 = {"k": np.arange(200, dtype=np.int64) % 50,
              "label": np.arange(200, dtype=np.int64)}
    items1 = {"k": np.arange(200, dtype=np.int64) + 1000,
              "label": np.arange(200, dtype=np.int64)}
    items1["k"][:50] = np.arange(50)
    cq(*frames(orders, items1), cutoff=100)
    d = frames(orders, items4)
    before = totals()
    got = cq(*d, cutoff=100)
    assert moved(before)["plan.overflow_events"] == 1
    assert moved(before)["plan.compile_count"] == 1
    assert moved(before)["plan.capacity_rescales"] == 0
    frame_equal(got, frame_revenue(*d, cutoff=100))
    assert [g["scale"] for g in cq.graph_stats()] == [1]


# ----------------------------------------------- (d) the bucketed route
@pytest.mark.parametrize("world", ["local", "w1"])
@pytest.mark.parametrize("qn", QUERIES)
def test_lint_on_the_bucketed_route(qn, world, bucketed, lint_inputs):
    data, pdfs, frames = lint_inputs
    inputs, kw = _query_inputs(qn, data, pdfs, frames)
    if world == "w1":
        kw = dict(kw, env=CylonEnv(device="cpu"))
    assert lint_fails(getattr(Q, qn), inputs, **kw) == \
        (qn in tpch.EAGER_QUERIES), qn


@pytest.fixture(scope="module")
def lint_inputs():
    data = tpch.generate(SF, SEED)
    return data, tpch.generate_pandas(SF, SEED), \
        tpch.ingest(data, device="cpu")


def _routes() -> dict:
    return {k: telemetry.counter("join.algorithm", kind=k).value
            for k in ("hash->hash_bucketed", "hash->sort_overflow")}


def test_the_guarded_route_against_the_jax_guarded_query(stand_in,
                                                         bucketed):
    """The example under the bucketed route: captured with the bucketed
    join, a rebound replay, then a build side of 17 rows of one key
    (past the chain width of 16): its replay flags and its rerun takes
    the sort join. Each result against JAX's ``hash_guarded`` compiled
    query and the port's default-route eager query."""
    from cylon_tpu_torch.ops.hash_join import bucket_width

    assert bucket_width() == 16
    jq = jax_example()
    cq = plan.compile_query(revenue_by_key)
    orders, items = _example_tables()
    telemetry.reset()
    got = cq(*tables(orders, items), cutoff=180)
    assert _routes() == {"hash->hash_bucketed": 1, "hash->sort_overflow": 0}
    assert_equals_jax(got, jq, orders, items, cutoff=180)
    raw_b = _example_tables(seed=5)
    b = tables(*raw_b)
    before = totals()
    got = cq(*b, cutoff=180)
    assert moved(before)["plan.compile_count"] == 0
    assert_equals_jax(got, jq, *raw_b, cutoff=180)
    # set D: 17 rows of key 7 on the build side (items, the smaller)
    dup = dict(items, k=items["k"].copy())
    dup["k"][:17] = 7
    d = tables(orders, dup)
    before = totals()
    got = cq(*d, cutoff=180)
    assert moved(before)["plan.overflow_events"] == 1
    assert telemetry.total("join.overflow_fallbacks") == 1
    assert _routes() == {"hash->hash_bucketed": 1, "hash->sort_overflow": 1}
    assert_equals_jax(got, jq, orders, dup, cutoff=180)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CYLON_TPU_JOIN_ALGORITHM")
        mp.delenv("CYLON_TPU_JOIN_HASH_IMPL")
        frame_equal(got, revenue_by_key(*d, cutoff=180))
    # the sort-route graph keeps its route for data whose chains fit
    got = cq(*b, cutoff=180)
    assert stand_in.made[-1].replays == 1
    assert_equals_jax(got, jq, *raw_b, cutoff=180)


def test_the_capture_takes_the_warm_ups_route_with_no_host_read(bucketed):
    from test_torch_capture import host_read_lint, warmed

    orders, items = tables(*_example_tables())
    tape = warmed(revenue_by_key, (orders, items), {"cutoff": 180})
    assert [size for site, size in tape.sizes
            if site[0] == "join_route"] == ["hash_bucketed"]
    with host_read_lint():
        out, packed, _ = plan.run_captured(
            revenue_by_key, (orders, items), {"cutoff": 180}, tape=tape)
    assert not packed.numpy()[0]


_i64 = Table.from_pydict({"a": np.zeros(1, np.int64)},
                         device="cpu").column("a").dtype
_f64 = Table.from_pydict({"a": np.zeros(1, np.float64)},
                         device="cpu").column("a").dtype
