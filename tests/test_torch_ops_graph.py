"""The port's operator graph against the JAX package's on the same chunks,
on the CPU: the cases of ``tests/test_ops_graph.py`` translated. Local
graphs run against the JAX graph and pandas; the distributed graphs run
at W = 4 on ``ThreadWorld`` (every rank streaming its own shard's
chunks) against the JAX graph on the 4-device mesh ``env4``.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
import cylon_tpu.ops_graph as jog
import cylon_tpu_torch as ct
from cylon_tpu.parallel import dist_to_pandas as jdist_to_pandas
from cylon_tpu_torch import Table
from cylon_tpu_torch.ops_graph import (DisJoinOp, DisUnionOp, GroupByOp, Op,
                                       PartitionOp, PriorityExecution,
                                       RootOp, RoundRobinExecution,
                                       SequentialExecution, chunk_stream)
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dtable import dist_to_pandas, scatter_table

CPU = "cpu"


def _t(d):
    return Table.from_pydict({k: np.asarray(v) for k, v in d.items()},
                             device=CPU)


def _world(fn, w: int = 4):
    return ThreadWorld(w).run(lambda comm: fn(ct.CylonEnv(comm)))


def _sorted(df, cols):
    return df[cols].sort_values(cols).reset_index(drop=True)


def test_op_wiring_and_finalize():
    seen = []
    a = Op(1, execute=lambda tag, t: t)
    b = Op(2, execute=lambda tag, t: (seen.append(tag), None)[1])
    a.add_child(b)
    a.insert(7, _t({"x": [1]}))
    a.insert(8, _t({"x": [2]}))
    ex = RoundRobinExecution([a, b])
    a.finish()
    assert ex.is_complete()
    assert seen == [7, 8]
    assert a.done() and b.done() and a.processed == 2


def test_partition_op_covers_all_rows():
    t = _t({"k": np.arange(100, dtype=np.int64), "v": np.arange(100)})
    part = PartitionOp(1, ["k"], 4)
    root = RootOp(0)
    part.add_child(root)
    part.insert(0, t)
    part.finish()
    while root.progress():
        pass
    got = sorted(x for c in root.results for x in c.table.to_pydict()["k"])
    assert got == list(range(100))
    assert {c.tag for c in root.results} == {0, 1, 2, 3}
    # the JAX graph's partition of the same rows, tag by tag
    jpart = jog.PartitionOp(1, ["k"], 4)
    jroot = jog.RootOp(0)
    jpart.add_child(jroot)
    jpart.insert(0, jct.Table.from_pydict({"k": np.arange(100),
                                           "v": np.arange(100)}))
    jpart.finish()
    while jroot.progress():
        pass
    assert {c.tag: sorted(c.table.to_pydict()["k"]) for c in root.results} \
        == {c.tag: sorted(c.table.to_pydict()["k"]) for c in jroot.results}


def test_chunk_stream_matches_jax():
    t = _t({"k": np.arange(70), "v": np.arange(70) * 0.5})
    jt = jct.Table.from_pydict({"k": np.arange(70),
                                "v": np.arange(70) * 0.5})
    mine = list(chunk_stream(t, 32))
    theirs = list(jog.chunk_stream(jt, 32))
    assert [c.capacity for c in mine] == [c.capacity for c in theirs]
    for a, b in zip(mine, theirs):
        pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())
    # with env: every rank yields as many chunks as the largest shard
    got = _world(lambda env: [c.num_rows for c in chunk_stream(
        t.with_nrows(10 * (env.rank + 1)), 8, env)])
    assert [len(g) for g in got] == [5] * 4
    assert [sum(g) for g in got] == [10, 20, 30, 40]


@pytest.mark.parametrize("execution_cls", ["join", "roundrobin", "priority",
                                           "sequential"])
def test_streaming_join_matches_jax_and_pandas(execution_cls, rng):
    n = 300
    lp = pd.DataFrame({"k": rng.integers(0, 40, n), "a": rng.normal(size=n)})
    rp = pd.DataFrame({"k": rng.integers(0, 40, n), "b": rng.normal(size=n)})
    g = DisJoinOp("k", n_partitions=4, how="inner", out_capacity=8 * n)
    for chunk in chunk_stream(Table.from_pandas(lp, device=CPU), 64):
        g.insert_left(chunk)
    for chunk in chunk_stream(Table.from_pandas(rp, device=CPU), 128):
        g.insert_right(chunk)
    execution = {"join": None,
                 "roundrobin": RoundRobinExecution(g.ops),
                 "priority": PriorityExecution(
                     [(op, i + 1) for i, op in enumerate(g.ops)]),
                 "sequential": SequentialExecution(g.ops)}[execution_cls]
    res = g.result(execution).to_pandas()
    jg = jog.DisJoinOp("k", n_partitions=4, how="inner", out_capacity=8 * n)
    for chunk in jog.chunk_stream(jct.Table.from_pandas(lp), 64):
        jg.insert_left(chunk)
    for chunk in jog.chunk_stream(jct.Table.from_pandas(rp), 128):
        jg.insert_right(chunk)
    key = ["k", "a", "b"]
    want = _sorted(lp.merge(rp, on="k", how="inner"), key)
    pd.testing.assert_frame_equal(_sorted(res, key), want)
    pd.testing.assert_frame_equal(_sorted(res, key),
                                  _sorted(jg.result().to_pandas(), key))


def test_streaming_union_matches_jax_and_pandas(rng):
    a = pd.DataFrame({"x": rng.integers(0, 30, 100)})
    b = pd.DataFrame({"x": rng.integers(20, 50, 100)})
    got = []
    for mod, mk, stream in ((ct, lambda d: Table.from_pandas(d, device=CPU),
                             chunk_stream),
                            (jct, jct.Table.from_pandas, jog.chunk_stream)):
        g = (DisUnionOp if mod is ct else jog.DisUnionOp)(n_partitions=3)
        pa_, pb_ = g.add_input(["x"]), g.add_input(["x"])
        for chunk in stream(mk(a), 32):
            pa_.insert(0, chunk)
        for chunk in stream(mk(b), 32):
            pb_.insert(0, chunk)
        got.append(sorted(g.result().to_pandas()["x"].tolist()))
    assert got[0] == got[1] == sorted(set(a["x"]) | set(b["x"]))


def test_streaming_groupby_matches_jax_and_pandas(rng):
    n = 400
    p = pd.DataFrame({"k": rng.integers(0, 25, n), "v": rng.normal(size=n)})
    res = []
    for mod, table, stream in (
            (ct, Table.from_pandas(p, device=CPU), chunk_stream),
            (jog, jct.Table.from_pandas(p), jog.chunk_stream)):
        gb = (GroupByOp if mod is ct else jog.GroupByOp)(
            1, ["k"], [("v", "sum", "s"), ("v", "count", "c")])
        root = RootOp(0) if mod is ct else jog.RootOp(0)
        gb.add_child(root)
        for chunk in stream(table, 100):
            gb.insert(0, chunk)
        gb.finish()
        while root.progress():
            pass
        res.append(pd.concat([c.table.to_pandas() for c in root.results])
                   .sort_values("k").reset_index(drop=True))
    exp = p.groupby("k").agg(s=("v", "sum"), c=("v", "count")).reset_index()
    np.testing.assert_allclose(res[0]["s"], exp["s"], rtol=1e-9)
    np.testing.assert_array_equal(res[0]["c"], exp["c"])
    pd.testing.assert_frame_equal(res[0], res[1], rtol=1e-9)


def test_insert_after_finalize_raises():
    op = Op(1)
    op.finish()
    with pytest.raises(Exception, match="finalize"):
        op.insert(0, _t({"x": [1]}))


# --------------------------------------------- distributed streaming graph
def _stream_world(build, sides, chunk_rows):
    """Each rank streams its shard of every side through the graph
    ``build(env)`` makes (``sides``: {insert method: pandas frame}) and
    returns the gathered result."""
    def rank(env):
        graph = build(env)
        for method, pdf in sides.items():
            shard = scatter_table(env, Table.from_pandas(pdf, device=CPU))
            for chunk in chunk_stream(shard, chunk_rows, env):
                method(graph, chunk)
        return dist_to_pandas(env, graph.result())

    return _world(rank)


def _jax_stream(graph, sides, chunk_rows, env4):
    for method, pdf in sides.items():
        for chunk in jog.chunk_stream(jct.Table.from_pandas(pdf), chunk_rows):
            method(graph, chunk)
    return jdist_to_pandas(env4, graph.result())


@pytest.mark.parametrize("keys", ["int", "string"])
def test_dis_join_streams_over_the_world(env4, rng, keys):
    """DisJoinOp(env=...): every chunk shuffles over the world as it
    arrives, the join at finalize is rank-local; string keys of relations
    ingested apart (their codes differ) still meet."""
    if keys == "int":
        n = 300
        ldf = pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                            "a": rng.normal(size=n)})
        rdf = pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                            "b": rng.normal(size=n)})
        rows = 128
    else:
        ldf = pd.DataFrame({"k": ["apple", "pear", "plum", "apple", "kiwi"],
                            "a": [1.0, 2.0, 3.0, 4.0, 5.0]})
        rdf = pd.DataFrame({"k": ["plum", "apple", "fig"],
                            "b": [10.0, 20.0, 30.0]})
        rows = 2
    cols = ["k", "a", "b"]
    want = _sorted(ldf.merge(rdf, on="k"), cols)
    got = _stream_world(lambda env: DisJoinOp("k", env=env, how="inner"),
                        {DisJoinOp.insert_left: ldf,
                         DisJoinOp.insert_right: rdf}, rows)
    jgot = _jax_stream(jog.DisJoinOp("k", env=env4, how="inner"),
                       {jog.DisJoinOp.insert_left: ldf,
                        jog.DisJoinOp.insert_right: rdf}, rows, env4)
    for g in got:
        pd.testing.assert_frame_equal(_sorted(g, cols), want,
                                      check_dtype=False)
    pd.testing.assert_frame_equal(_sorted(jgot, cols), want,
                                  check_dtype=False)


def test_dis_union_streams_over_the_world(env4, rng):
    a = pd.DataFrame({"x": rng.integers(0, 30, 200).astype(np.int64)})
    b = pd.DataFrame({"x": rng.integers(0, 30, 150).astype(np.int64)})

    def build(env):
        g = DisUnionOp(env=env)
        g.ports = [g.add_input(["x"]), g.add_input(["x"])]
        return g

    got = _stream_world(build, {
        (lambda g, c: g.ports[0].insert(0, c)): a,
        (lambda g, c: g.ports[1].insert(0, c)): b}, 64)
    jg = jog.DisUnionOp(env=env4)
    jports = [jg.add_input(["x"]), jg.add_input(["x"])]
    jgot = _jax_stream(jg, {(lambda g, c: jports[0].insert(0, c)): a,
                            (lambda g, c: jports[1].insert(0, c)): b},
                       64, env4)
    want = sorted(set(a["x"]) | set(b["x"]))
    assert sorted(jgot["x"].tolist()) == want
    for g in got:
        assert sorted(g["x"].tolist()) == want


def test_groupby_op_streams_over_the_world(env4, rng):
    n = 500
    df = pd.DataFrame({"k": rng.integers(0, 25, n).astype(np.int64),
                       "v": rng.normal(size=n)})

    def rank(env):
        root = RootOp(0)
        g = GroupByOp(1, ["k"], [("v", "sum"), ("v", "count")], env=env)
        g.add_child(root)
        shard = scatter_table(env, Table.from_pandas(df, device=CPU))
        for chunk in chunk_stream(shard, 64, env):
            g.insert(0, chunk)
        g.finish()
        chunks = root.wait_for_completion(RoundRobinExecution([g, root]))
        assert len(chunks) == 1
        return dist_to_pandas(env, chunks[0].table)

    jroot = jog.RootOp(0)
    jg = jog.GroupByOp(1, ["k"], [("v", "sum"), ("v", "count")], env=env4)
    jg.add_child(jroot)
    for chunk in jog.chunk_stream(jct.Table.from_pandas(df), 128):
        jg.insert(0, chunk)
    jg.finish()
    jres = jroot.wait_for_completion(jog.RoundRobinExecution([jg, jroot]))
    jgot = jdist_to_pandas(env4, jres[0].table).sort_values("k") \
        .reset_index(drop=True)
    want = df.groupby("k").agg(v_sum=("v", "sum"),
                               v_count=("v", "count")).reset_index()
    for got in _world(rank):
        got = got.sort_values("k").reset_index(drop=True)
        assert len(got) == len(want)
        np.testing.assert_allclose(got["v_sum"], want["v_sum"], rtol=1e-9)
        np.testing.assert_array_equal(got["v_count"], want["v_count"])
        pd.testing.assert_frame_equal(got, jgot, rtol=1e-9)
