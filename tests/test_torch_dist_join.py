"""The slice as a whole: the port's ``dist_join`` against the JAX
package's, at W=1 (``LocalComm`` against ``env1``) and W=4 (a
``ThreadWorld`` of four ranks against the 4-device CPU mesh ``env4``).
Per shard the valid rows are equal; the whole result equals a pandas
``merge`` as a row set.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu_torch import convert
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import dist_join
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, gather_table,
                                             scatter_table)


def to_port(jt):
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu")


def _frames(rng, right_nulls: bool = True):
    """Nullable int64 keys with duplicates. With ``right_nulls=False``
    only the left key column carries a validity mask."""
    nl, nr = 900, 700
    lk = pd.array(rng.integers(0, 300, nl), dtype="Int64")
    rk = pd.array(rng.integers(0, 300, nr), dtype="Int64")
    lk[rng.random(nl) < 0.05] = pd.NA
    if right_nulls:
        rk[rng.random(nr) < 0.05] = pd.NA
    ldf = pd.DataFrame({"k": lk, "a": rng.normal(size=nl)})
    rdf = pd.DataFrame({"k": rk, "b": rng.integers(0, 50, nr)})
    return ldf, rdf


def assert_shard_equal(jt, shard, tt):
    counts = np.asarray(jt.nrows).reshape(-1)
    cap_l = jt.capacity // counts.shape[0]
    n = int(counts[shard])
    assert int(tt.nrows) == n
    got, _ = convert.to_arrays(tt)
    assert list(got) == jt.column_names
    lo = shard * cap_l
    for name, c in jt.columns.items():
        data, validity, _ = got[name]
        jv = None if c.validity is None else np.asarray(c.validity)[lo:lo + n]
        assert (validity is None) == (jv is None), name
        keep = np.ones(n, bool) if jv is None else jv
        if jv is not None:
            np.testing.assert_array_equal(validity[:n], jv)
        np.testing.assert_array_equal(data[:n][keep],
                                      np.asarray(c.data)[lo:lo + n][keep],
                                      err_msg=name)


def _unordered_eq(got: pd.DataFrame, want: pd.DataFrame):
    """Equal as row sets. Nulls read back as None in an object column
    (integers) or NaN (floats), where pandas' merge writes <NA> or NaN:
    both sides go to float64 first."""
    cols = list(want.columns)

    def norm(df):
        df = df[cols].apply(lambda s: pd.to_numeric(s).astype("float64"))
        return df.sort_values(cols).reset_index(drop=True)

    pd.testing.assert_frame_equal(norm(got), norm(want))


@pytest.mark.parametrize("how", ["inner", "outer"])
def test_dist_join_w1_matches_jax(env1, how):
    ldf, rdf = _frames(np.random.default_rng(1))
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    want = jdist_join(env1, jl, jr, on="k", how=how)
    env = CylonEnv()
    got = dist_join(env, to_port(jl), to_port(jr), on="k", how=how)
    assert_shard_equal(want, 0, got)
    assert dist_num_rows(env, got) == len(ldf.merge(rdf, on="k", how=how))
    _unordered_eq(got.to_pandas(), ldf.merge(rdf, on="k", how=how))


@pytest.mark.parametrize("how", ["inner"])
def test_dist_join_w4_matches_jax(env4, how):
    ldf, rdf = _frames(np.random.default_rng(4))
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    want = jdist_join(env4, jscatter(env4, jl), jscatter(env4, jr), on="k",
                      how=how)
    tl, tr = to_port(jl), to_port(jr)

    def rank(comm):
        env = CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on="k", how=how)
        return res, gather_table(env, res).to_pandas()

    got = ThreadWorld(4).run(rank)
    for s in range(4):
        assert_shard_equal(want, s, got[s][0])
    _unordered_eq(got[0][1], ldf.merge(rdf, on="k", how=how))


def test_dist_join_w4_key_nullable_on_one_side_only():
    """Only the left key column has a validity mask. The port hashes an
    all-valid mask for the right side too, so equal keys meet; the JAX
    package hashes the masks as they are and loses most matches, so here
    the reference is pandas alone."""
    ldf, rdf = _frames(np.random.default_rng(5), right_nulls=False)
    tl = to_port(jct.Table.from_pandas(ldf))
    tr = to_port(jct.Table.from_pandas(rdf))
    assert tl.column("k").validity is not None
    assert tr.column("k").validity is None

    def rank(comm):
        env = CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on="k")
        return gather_table(env, res).to_pandas()

    _unordered_eq(ThreadWorld(4).run(rank)[0], ldf.merge(rdf, on="k"))


def test_dist_join_w4_regrows_on_skew():
    """Every key equal: all rows land on one rank, past the default
    2x-skew receive buffer; the regrow loop doubles until they fit, on
    every rank alike."""
    n = 64
    ldf = pd.DataFrame({"k": np.full(n, 5), "a": np.arange(n)})
    rdf = pd.DataFrame({"k": np.full(n, 5), "b": np.arange(n)})
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    tl, tr = to_port(jl), to_port(jr)

    def rank(comm):
        env = CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on="k")
        return dist_num_rows(env, res)

    assert ThreadWorld(4).run(rank) == [n * n] * 4


def test_dist_join_w4_on_nine_int64_keys():
    """A key of nine int64 columns is 18 u32 words, more than the row
    hash kernel's chunk of 16: the partition hash takes them all."""
    rng = np.random.default_rng(9)
    n = 300
    on = [f"k{i}" for i in range(9)]
    base = rng.integers(0, 40, n)
    ldf = pd.DataFrame({c: base * (i + 1) for i, c in enumerate(on)})
    ldf["a"] = rng.normal(size=n)
    rbase = rng.integers(0, 40, n)
    rdf = pd.DataFrame({c: rbase * (i + 1) for i, c in enumerate(on)})
    rdf["b"] = rng.integers(0, 50, n)
    tl = to_port(jct.Table.from_pandas(ldf))
    tr = to_port(jct.Table.from_pandas(rdf))

    def rank(comm):
        env = CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on=on)
        return gather_table(env, res).to_pandas()

    want = ldf.merge(rdf, on=on)
    assert len(want) > 0
    _unordered_eq(ThreadWorld(4).run(rank)[0], want)
