"""Tables the port must take whatever their shape on each rank: an empty
side or shard, and shards ingested per rank whose columns differ in
order, dtype or string storage.

The JAX package's ``join`` fails at capacity 0 too, and it keeps one
global table, so it has no per-rank layouts: the reference here is
pandas' ``merge`` alone.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu_torch as ct
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.parallel.dist_ops import dist_join
from cylon_tpu_torch.parallel.dtable import gather_table, world_layout
from test_torch_strings import _assert_rows

HOWS = ("inner", "left", "right", "outer")
POOL = np.array(["apple", "Banana", "é", "", "zebra pie"], object)


def _frame(rng, n, key, value):
    if key == "int64":
        k = rng.integers(0, 6, n)
    else:
        k = POOL[rng.integers(0, len(POOL), n)]
    return pd.DataFrame({"k": k, value: rng.normal(size=n)})


def _table(df, key, capacity=None):
    return ct.Table.from_pandas(df, capacity=capacity, device="cpu",
                                string_storage="dict" if key == "dict"
                                else "bytes")


@pytest.mark.parametrize("capacity", [0, 8])
@pytest.mark.parametrize("empty", ["left", "right"])
@pytest.mark.parametrize("key", ["int64", "bytes", "dict"])
@pytest.mark.parametrize("route", ["sort", "bucketed"])
@pytest.mark.parametrize("how", HOWS)
def test_join_with_an_empty_side_matches_pandas(how, route, key, empty,
                                                capacity, monkeypatch):
    """An empty side, at capacity 0 (every scan, sort and gather of the
    join on no rows) and with no valid row in a capacity of 8: an inner
    join gives no rows, an outer join the other side's rows with nulls.
    ``route`` is the sort join or the bucketed hash join."""
    rng = np.random.default_rng(HOWS.index(how))
    ldf, rdf = _frame(rng, 7, key, "a"), _frame(rng, 5, key, "b")
    if empty == "left":
        ldf = ldf.iloc[:0]
    else:
        rdf = rdf.iloc[:0]
    caps = [capacity if empty == side else None for side in ("left",
                                                             "right")]
    lt, rt = _table(ldf, key, caps[0]), _table(rdf, key, caps[1])
    if route == "bucketed":
        monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")
    got = ct.join(lt, rt, on="k", how=how,
                  algorithm="hash" if route == "bucketed" else "sort")
    want = ldf.merge(rdf, on="k", how=how)
    assert got.column_names == list(want.columns)
    _assert_rows(got.to_pandas(), want)


def _shards(df, empty_rank):
    parts = [df.iloc[r::4] for r in range(4)]
    parts[empty_rank] = df.iloc[:0]
    return parts


@pytest.mark.parametrize("how", HOWS)
def test_dist_join_w4_with_an_empty_shard_matches_pandas(how):
    """Each rank ingests its own rows; rank 1's left shard and rank 2's
    right shard are empty (capacity 0). Every rank's receive buffers come
    from the ranks' mean capacity, so an empty shard still receives its
    share."""
    rng = np.random.default_rng(11)
    ldf, rdf = _frame(rng, 80, "int64", "a"), _frame(rng, 60, "int64", "b")
    lparts, rparts = _shards(ldf, 1), _shards(rdf, 2)

    def rank(comm):
        env = ct.CylonEnv(comm)
        lt = ct.Table.from_pandas(lparts[comm.rank], device="cpu")
        rt = ct.Table.from_pandas(rparts[comm.rank], device="cpu")
        res = dist_join(env, lt, rt, on="k", how=how)
        return gather_table(env, res).to_pandas()

    want = pd.concat(lparts).merge(pd.concat(rparts), on="k", how=how)
    assert len(want) > 0
    for got in ct.ThreadWorld(4).run(rank):
        _assert_rows(got, want, ordered=False)


def test_gather_table_with_an_empty_shard():
    rng = np.random.default_rng(12)
    parts = _shards(_frame(rng, 30, "bytes", "a"), 3)

    def rank(comm):
        env = ct.CylonEnv(comm)
        t = ct.Table.from_pandas(parts[comm.rank], device="cpu",
                                 string_storage="bytes")
        return gather_table(env, t).to_pandas()

    for got in ct.ThreadWorld(4).run(rank):
        _assert_rows(got, pd.concat(parts))


def _raises_on_every_rank(make, match):
    """Every rank of four builds its table with ``make(rank)`` and calls
    world_layout, which must raise InvalidArgument matching ``match`` on
    each of them; none may hang."""
    def rank(comm):
        env = ct.CylonEnv(comm)
        with pytest.raises(InvalidArgument, match=match):
            world_layout(env, make(comm.rank))
        return True

    assert ct.ThreadWorld(4, timeout=30).run(rank) == [True] * 4


def test_a_dtype_that_differs_across_ranks_raises_on_every_rank():
    """``v`` is int64 on three ranks and float64 on rank 3, as pandas
    types an int column holding a null: no cast, every rank raises and
    names the column and each rank's dtype."""
    def make(r):
        v = np.arange(4, dtype=np.float64 if r == 3 else np.int64)
        return ct.Table.from_pydict({"k": np.arange(4), "v": v},
                                    device="cpu")

    _raises_on_every_rank(
        make, r"'v': \['int64', 'int64', 'int64', 'double'\]")


def test_different_column_names_raise_on_every_rank():
    """Rank 2 holds a column the others lack and one fewer column: the
    header gather keeps the summaries from mis-shaping, and every rank
    raises."""
    def make(r):
        cols = {"k": np.arange(3), "v": np.ones(3)}
        if r == 2:
            cols = {"k": np.arange(3), "w": np.ones(3), "x": np.ones(3)}
        return ct.Table.from_pydict(cols, device="cpu")

    _raises_on_every_rank(make, "different columns")


def test_dist_join_w4_reordered_columns_match_pandas():
    """Ranks 1 and 3 hold their columns in another order: each is brought
    to rank 0's order before any row moves, so keys stay keys."""
    rng = np.random.default_rng(13)
    ldf = pd.DataFrame({"k": rng.integers(0, 8, 40),
                        "a": rng.integers(100, 200, 40)})
    rdf = pd.DataFrame({"k": rng.integers(0, 8, 32),
                        "b": rng.normal(size=32)})
    lparts = [ldf.iloc[r::4] for r in range(4)]
    rparts = [rdf.iloc[r::4] for r in range(4)]

    def rank(comm):
        env = ct.CylonEnv(comm)
        lp, rp = lparts[comm.rank], rparts[comm.rank]
        if comm.rank % 2:
            lp, rp = lp[["a", "k"]], rp[["b", "k"]]
        lt = ct.Table.from_pandas(lp, device="cpu")
        rt = ct.Table.from_pandas(rp, device="cpu")
        res = dist_join(env, lt, rt, on="k")
        return gather_table(env, res).to_pandas()

    want = ldf.merge(rdf, on="k")
    for got in ct.ThreadWorld(4).run(rank):
        assert list(got.columns) == ["k", "a", "b"]
        _assert_rows(got, want, ordered=False)


@pytest.mark.parametrize("nul", [False, True])
def test_dist_join_w4_mixed_string_storages_match_pandas(nul):
    """The key and a payload are device bytes on rank 0 and dictionary
    codes on the other ranks. Both convert to device bytes, at the widest
    width; where a rank's dictionary holds a value with a NUL byte, which
    device bytes cannot hold, both convert to dictionary codes."""
    rng = np.random.default_rng(14)
    pool = np.array(["a", "bb", "ccc-é", "a long value, 24 bytes!!",
                     "x\x00y" if nul else "xy"], object)
    ldf = pd.DataFrame({"k": pool[rng.integers(0, 5, 48)],
                        "s": pool[rng.integers(0, 5, 48)]})
    rdf = pd.DataFrame({"k": pool[rng.integers(0, 5, 36)],
                        "b": rng.normal(size=36)})
    ldf.loc[[5, 9], "k"] = None
    lparts = [ldf.iloc[r::4] for r in range(4)]
    rparts = [rdf.iloc[r::4] for r in range(4)]
    # rank 0 ingests device bytes, which cannot hold the NUL byte
    lparts[0] = lparts[0][~lparts[0].isin([pool[4]]).any(axis=1)]
    rparts[0] = rparts[0][~rparts[0].isin([pool[4]]).any(axis=1)]

    def rank(comm):
        env = ct.CylonEnv(comm)
        storage = "bytes" if comm.rank == 0 else "dict"
        lt = ct.Table.from_pandas(lparts[comm.rank], device="cpu",
                                  string_storage=storage)
        rt = ct.Table.from_pandas(rparts[comm.rank], device="cpu",
                                  string_storage=storage)
        laid = world_layout(env, lt)
        res = dist_join(env, lt, rt, on="k")
        return laid.column("k").dtype, gather_table(env, res).to_pandas()

    out = ct.ThreadWorld(4).run(rank)
    assert len({repr(d) for d, _ in out}) == 1
    assert out[0][0].is_dictionary == nul
    want = pd.concat(lparts).merge(pd.concat(rparts), on="k")
    for _, got in out:
        _assert_rows(got, want, ordered=False)
