"""The public ``shuffle`` and ``repartition`` of the port against the JAX
package's at W = 4 (``ThreadWorld`` against the 4-device CPU mesh
``env4``): each rank's rows equal the JAX shard's as a row set (hash
and modulo partitioning; numeric, nullable, dictionary and device-bytes
keys), ``Dictionary.value_hashes`` bit for bit, equal strings meeting
on one rank when each rank ingested its own shard, round-robin counts
within one of each other, and the regrow on skew.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu.column import Dictionary as JDictionary
from cylon_tpu.parallel import repartition as jrepartition
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu_torch import Table, convert
from cylon_tpu_torch.column import Dictionary
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.ops.partition import modulo_partition_ids
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import repartition, shuffle
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, gather_table,
                                             scatter_table)

NAMES = np.array(["apple", "fig", "", "kiwi", "pear", "éclair", "plum",
                  "quince"], object)


def _frame(rng, n: int = 203):
    k = pd.array(rng.integers(0, 60, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    s = NAMES[rng.integers(0, len(NAMES), n)]
    s[rng.random(n) < 0.05] = None
    return pd.DataFrame({"k": k, "m": rng.integers(-1000, 1000, n),
                         "s": s, "v": rng.normal(size=n)})


def to_port(jt):
    cols, dicts = {}, {}
    for n, c in jt.columns.items():
        cols[n] = (np.asarray(c.data),
                   None if c.validity is None else np.asarray(c.validity),
                   repr(c.dtype))
        if c.dictionary is not None:
            dicts[n] = c.dictionary.values
    return convert.from_arrays(cols, int(jt.nrows), device="cpu",
                               dictionaries=dicts)


def _shard_frame(jt, s):
    counts = np.asarray(jt.nrows).reshape(-1)
    cap_l = jt.capacity // counts.shape[0]
    lo = s * cap_l
    cols, dicts = {}, {}
    for n, c in jt.columns.items():
        cols[n] = (np.asarray(c.data)[lo:lo + cap_l],
                   None if c.validity is None
                   else np.asarray(c.validity)[lo:lo + cap_l],
                   repr(c.dtype))
        if c.dictionary is not None:
            dicts[n] = c.dictionary.values
    return convert.from_arrays(cols, int(counts[s]), device="cpu",
                               dictionaries=dicts).to_pandas()


def _rows(df):
    """A frame as a sorted list of row tuples of the cells' text, nulls
    as one tag."""
    def cell(x):
        return "<null>" if x is None or x is pd.NA or \
            (isinstance(x, float) and np.isnan(x)) else str(x)
    return sorted(tuple(cell(x) for x in r)
                  for r in df.itertuples(index=False))


def _world(fn, w: int = 4):
    return ThreadWorld(w).run(lambda comm: fn(CylonEnv(comm)))


@pytest.mark.parametrize("keys,partitioning,storage", [
    (["k"], "hash", "dict"),
    (["s"], "hash", "dict"),
    (["s", "k"], "hash", "bytes"),
    (["m"], "modulo", "dict"),
])
def test_shuffle_w4_matches_jax_shards(env4, keys, partitioning, storage):
    df = _frame(np.random.default_rng(21))
    jt = jct.Table.from_pandas(df, string_storage=storage)
    want = jshuffle(env4, jscatter(env4, jt), keys,
                    partitioning=partitioning)
    tt = to_port(jt)
    got = _world(lambda env: shuffle(env, scatter_table(env, tt), keys,
                                     partitioning=partitioning).to_pandas())
    for s in range(4):
        assert _rows(got[s]) == _rows(_shard_frame(want, s)), s
    assert sum(len(g) for g in got) == len(df)


def test_shuffle_arguments():
    """bucket_cap is accepted and changes nothing (the exchange sends
    exact counts); an unknown partitioning and a modulo of a float key
    raise; an explicit out_capacity too small raises on num_rows."""
    tt = Table.from_pandas(_frame(np.random.default_rng(22)), device="cpu")

    def rank(env):
        mine = scatter_table(env, tt)
        a = shuffle(env, mine, ["k"]).to_pandas()
        b = shuffle(env, mine, ["k"], bucket_cap=1).to_pandas()
        with pytest.raises(InvalidArgument):
            shuffle(env, mine, ["k"], partitioning="range")
        with pytest.raises(InvalidArgument):
            shuffle(env, mine, ["v"], partitioning="modulo")
        small = shuffle(env, mine, ["k"], out_capacity=8)
        with pytest.raises(OutOfCapacity):
            dist_num_rows(env, small)
        return _rows(a) == _rows(b)

    assert _world(rank) == [True] * 4


def test_value_hashes_match_jax_bit_for_bit():
    values = list(NAMES) + ["Customer#000000001", "ü" * 40]
    want = np.asarray(JDictionary(np.array(values, object)).value_hashes())
    got = Dictionary(values).value_hashes("cpu")
    assert str(got.dtype) == "torch.uint32"
    np.testing.assert_array_equal(got.numpy(), want)
    assert Dictionary(values).value_hashes("cpu") is not got   # per object
    d = Dictionary(values)
    assert d.value_hashes("cpu") is d.value_hashes("cpu")        # cached


@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_shuffle_colocates_strings_of_shards_ingested_per_rank(storage):
    """Each rank builds its own table from its own rows: its own
    dictionary (other codes for the same strings) or bytes width. After
    the shuffle every string lives on one rank, and no row is lost."""
    rng = np.random.default_rng(23)
    frames = []
    for r in range(4):
        vals = NAMES[rng.integers(0, len(NAMES) - r, 40 + 10 * r)]
        frames.append(pd.DataFrame({"s": vals, "r": np.full(len(vals), r)}))

    def rank(env):
        mine = Table.from_pandas(frames[env.rank], device="cpu",
                                 string_storage=storage)
        return shuffle(env, mine, ["s"]).to_pandas()

    got = _world(rank)
    seen = {}
    for r, df in enumerate(got):
        for v in set(df["s"]):
            assert seen.setdefault(v, r) == r, v
    assert sorted(pd.concat(got)["s"]) == sorted(pd.concat(frames)["s"])


def test_repartition_w4_matches_jax_and_balances(env4):
    """All rows on rank 0 at first: round robin from each rank's global
    offset spreads them, the counts within one of each other, each
    rank's rows those of the JAX shard."""
    df = _frame(np.random.default_rng(24), n=61)
    jt = jct.Table.from_pandas(df)
    want = jrepartition(env4, jscatter(env4, jt, local_cap=64))
    tt = to_port(jt)
    got = _world(lambda env: repartition(
        env, scatter_table(env, tt, local_cap=64)).to_pandas())
    counts = [len(g) for g in got]
    assert max(counts) - min(counts) <= 1 and sum(counts) == len(df)
    for s in range(4):
        assert _rows(got[s]) == _rows(_shard_frame(want, s)), s


def test_repartition_uneven_shards_ingested_per_rank():
    sizes = [0, 37, 5, 11]

    def rank(env):
        mine = Table.from_pydict(
            {"x": np.arange(sizes[env.rank]) + 100 * env.rank},
            device="cpu")
        res = repartition(env, mine)
        return res.num_rows, gather_table(env, res).to_pandas()

    got = _world(rank)
    counts = [g[0] for g in got]
    assert max(counts) - min(counts) <= 1 and sum(counts) == sum(sizes)
    want = np.concatenate([np.arange(n) + 100 * r
                           for r, n in enumerate(sizes)])
    np.testing.assert_array_equal(np.sort(got[0][1]["x"].to_numpy()),
                                  np.sort(want))


def test_shuffle_w4_regrows_on_skew():
    """Every key equal: all rows land on one rank, past the tight bucket
    and the capacity default; the regrow loop doubles until they fit."""
    n = 400
    tt = Table.from_pydict({"k": np.full(n, 3), "v": np.arange(n)},
                           device="cpu")

    def rank(env):
        res = shuffle(env, scatter_table(env, tt), ["k"])
        return res.num_rows, res.capacity

    got = _world(rank)
    assert sorted(g[0] for g in got) == [0, 0, 0, n]
    assert all(g[1] >= n for g in got)


def test_modulo_partition_ids_match_jax():
    import jax.numpy as jnp

    from cylon_tpu.ops.partition import modulo_partition_ids as jmod

    v = np.array([-7, -1, 0, 1, 5, 2 ** 40 + 3, -(2 ** 62)], np.int64)
    for w in (1, 3, 4):
        got = modulo_partition_ids([convert.from_arrays(
            {"v": (v, None, "int64")}, len(v), device="cpu").column(
                "v").data], w)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jmod([jnp.asarray(v)], w)))
