"""Scalar aggregates of the port against the JAX package on the CPU:
``table_aggregate`` for every op, and ``dist_aggregate`` at W = 4
(``ThreadWorld`` against the 4-device mesh ``env4``) for every op, on
the exact route and the sketch, with poisoned input, empty shards and
the nunique exchange's regrow.

Tolerances: sum, mean, var and std at rtol 1e-12 (the packages sum in
other orders); count, min, max and nunique exactly; median and quantile
exactly where they select a value, at rtol 1e-12 where they
interpolate; the sketch within one bracket of the exact quantile, and
equal to the JAX package's sketch at rtol 1e-12; a float32 sum at rtol
1e-5.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.ops.aggregates import table_aggregate as jtable_aggregate
from cylon_tpu.parallel import dist_aggregate as jdist_aggregate
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu_torch import Table, convert
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.ops.aggregates import AGGS, table_aggregate
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import (SKETCH_BINS, dist_aggregate,
                                               dist_join)
from cylon_tpu_torch.parallel.dtable import scatter_table

RTOL = 1e-12
#: a float32 sum of a few hundred values in another order
F32_RTOL = 1e-5
EXACT = ("count", "min", "max", "nunique")
Q = 0.35


def to_port(jt):
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu")


def _frame(n: int = 301):
    """A float column with NaNs, a nullable int64 column and an int32
    one, no value missing in the last."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=n) * 3
    v[rng.random(n) < 0.1] = np.nan
    iv = pd.array(rng.integers(-10**6, 10**6, n), dtype="Int64")
    iv[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({"v": v, "i": iv,
                         "j": rng.integers(-50, 50, n).astype(np.int32)})


def assert_scalar(got, want, op, q=Q, n=None):
    got, want = got.item(), float(np.asarray(want))
    if op in EXACT or (op in ("median", "quantile") and n is not None
                       and ((0.5 if op == "median" else q)
                            * (n - 1)) % 1 == 0):
        assert got == want, (op, got, want)
    else:
        assert got == pytest.approx(want, rel=RTOL, abs=0), (op, got, want)


@pytest.mark.parametrize("col", ["v", "i", "j"])
def test_table_aggregate_every_op_matches_jax(col):
    df = _frame()
    jt = jct.Table.from_pandas(df)
    tt = to_port(jt)
    n = int(df[col].count())
    for op in AGGS:
        got = table_aggregate(tt, col, op, quantile=Q)
        want = jtable_aggregate(jt, col, op, quantile=Q)
        assert str(got.dtype).split(".")[1] == str(np.asarray(want).dtype)
        assert_scalar(got, want, op, n=n)


def test_table_aggregate_poisoned_input_and_no_rows():
    """An overflowed input (nrows past capacity) folds into the value:
    NaN for a float result, iinfo.min for an integer one. A table of
    capacity 0 gives the sentinels, NaN for a quantile, and 0.0 for mean,
    var and std, as the JAX package's ``s / max(n, 1)`` does (pandas
    gives NaN there)."""
    tt = Table.from_pandas(_frame(), device="cpu")
    bad = tt.with_nrows(tt.capacity + 1)
    assert np.isnan(table_aggregate(bad, "v", "sum").item())
    assert table_aggregate(bad, "i", "max").item() == np.iinfo(np.int64).min
    assert table_aggregate(bad, "j", "count").item() == \
        np.iinfo(np.int64).min
    empty = Table.from_pydict({"v": np.zeros(0)}, device="cpu")
    assert table_aggregate(empty, "v", "count").item() == 0
    assert table_aggregate(empty, "v", "sum").item() == 0.0
    assert table_aggregate(empty, "v", "min").item() == np.inf
    assert np.isnan(table_aggregate(empty, "v", "median").item())
    for op in ("mean", "var", "std"):
        assert table_aggregate(empty, "v", op).item() == 0.0, op
    with pytest.raises(InvalidArgument):
        table_aggregate(tt, "v", "quantile", quantile=1.5)


def _world(fn):
    return ThreadWorld(4).run(lambda comm: fn(CylonEnv(comm)))


@pytest.mark.parametrize("col", ["v", "i"])
def test_dist_aggregate_w4_every_op_matches_jax(env4, col):
    """Every op on the exact route; the same bits on every rank. nunique
    of a column with nulls is held against pandas: the JAX package's
    distributed nunique counts the null (and NaN) as a value (ROADMAP
    C5)."""
    df = _frame()
    jt = jct.Table.from_pandas(df)
    jd = jscatter(env4, jt)
    tt = to_port(jt)
    n = int(df[col].count())

    def rank(env):
        mine = scatter_table(env, tt)
        return [dist_aggregate(env, mine, col, op, quantile=Q)
                for op in AGGS]

    got = _world(rank)
    for op, *vals in zip(AGGS, *got):
        assert len({v.numpy().tobytes() for v in vals}) == 1, op
        if op == "nunique":
            assert vals[0].item() == df[col].nunique()
            continue
        assert_scalar(vals[0], jdist_aggregate(env4, jd, col, op,
                                               quantile=Q), op, n=n)


def test_dist_aggregate_w4_nunique_matches_jax_without_nulls(env4):
    df = _frame()
    jt = jct.Table.from_pandas(df)
    tt = to_port(jt)
    got = _world(lambda env: dist_aggregate(env, scatter_table(env, tt),
                                            "j", "nunique"))
    want = int(jdist_aggregate(env4, jscatter(env4, jt), "j", "nunique"))
    assert [g.item() for g in got] == [want] * 4 == [df["j"].nunique()] * 4


def test_dist_aggregate_w4_unsigned_and_narrow_columns_match_jax(env4):
    """Unsigned columns, whose sums run in uint64 on their bit patterns
    and whose extremes fold as int64 (uint64 with its top bit flipped),
    and int8, float32 and bool columns: every rank the JAX value."""
    rng = np.random.default_rng(16)
    n = 203
    df = pd.DataFrame({
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32),
        "u64": rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        + np.uint64(2 ** 62) * rng.integers(0, 3, n).astype(np.uint64),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "f32": rng.normal(size=n).astype(np.float32),
        "b": rng.random(n) < 0.4})
    jt = jct.Table.from_pandas(df)
    jd = jscatter(env4, jt)
    tt = to_port(jt)
    ops = ("sum", "min", "max", "count", "mean")

    def rank(env):
        mine = scatter_table(env, tt)
        return {(c, op): dist_aggregate(env, mine, c, op)
                for c in df.columns for op in ops}

    got = _world(rank)
    for (c, op), val in got[0].items():
        want = np.asarray(jdist_aggregate(env4, jd, c, op))
        assert str(val.dtype).split(".")[1] == str(want.dtype), (c, op)
        assert all(g[(c, op)].numpy().tobytes() == val.numpy().tobytes()
                   for g in got), (c, op)
        if val.is_floating_point() and op in ("sum", "mean"):
            # float sums in another order: rtol by the dtype
            rtol = RTOL if val.dtype == torch.float64 else F32_RTOL
            assert val.item() == pytest.approx(want.item(), rel=rtol)
        else:
            assert val.item() == want.item(), (c, op)


@pytest.mark.parametrize("op", ["median", "quantile"])
def test_dist_aggregate_w4_sketch_matches_jax(env4, op):
    """exact=False: equal to the JAX sketch, and within one bracket of
    the exact quantile."""
    rng = np.random.default_rng(12)
    v = rng.normal(size=4000)
    v[::97] = np.nan
    df = pd.DataFrame({"v": v})
    jt = jct.Table.from_pandas(df)
    tt = to_port(jt)
    q = 0.5 if op == "median" else 0.9
    got = _world(lambda env: dist_aggregate(
        env, scatter_table(env, tt), "v", op, quantile=q, exact=False))
    want = float(jdist_aggregate(env4, jscatter(env4, jt), "v", op,
                                 quantile=q, exact=False))
    assert len({g.item() for g in got}) == 1
    assert got[0].item() == pytest.approx(want, rel=RTOL, abs=0)
    ok = v[~np.isnan(v)]
    bracket = (ok.max() - ok.min()) / SKETCH_BINS ** 2
    assert abs(got[0].item() - np.quantile(ok, q)) <= bracket


def test_dist_aggregate_auto_sketch_over_the_gather_limit(monkeypatch):
    """exact=True takes the sketch where the gathered column would pass
    CYLON_TPU_EXACT_GATHER_LIMIT, and the exact route under it."""
    v = np.random.default_rng(13).normal(size=2000)
    tt = Table.from_pydict({"v": v}, device="cpu")
    monkeypatch.setenv("CYLON_TPU_EXACT_GATHER_LIMIT", "1024")
    got = _world(lambda env: dist_aggregate(env, scatter_table(env, tt),
                                            "v", "median"))
    bracket = (v.max() - v.min()) / SKETCH_BINS ** 2
    assert abs(got[0].item() - np.median(v)) <= bracket
    monkeypatch.setenv("CYLON_TPU_EXACT_GATHER_LIMIT", str(1 << 30))
    got = _world(lambda env: dist_aggregate(env, scatter_table(env, tt),
                                            "v", "median"))
    assert got[0].item() == np.median(v)


def test_dist_aggregate_w4_poisoned_input_raises_on_every_rank():
    """A join whose output overflowed its explicit bound poisons its
    rank's shard; dist_aggregate raises OutOfCapacity on every rank, as
    the JAX package's eager call does."""
    rng = np.random.default_rng(14)
    n = 256
    left = Table.from_pydict({"k": rng.integers(0, 8, n),
                              "a": np.arange(n, dtype=np.float64)},
                             device="cpu")
    right = Table.from_pydict({"k": rng.integers(0, 8, n),
                               "b": np.arange(n, dtype=np.float64)},
                              device="cpu")

    def rank(env):
        j = dist_join(env, scatter_table(env, left),
                      scatter_table(env, right), on="k",
                      out_capacity=2 * n, shuffle_capacity=8 * n)
        with pytest.raises(OutOfCapacity):
            dist_aggregate(env, j, "a", "sum")
        return True

    assert _world(rank) == [True] * 4


def test_dist_aggregate_w4_empty_shards():
    """Ranks 1 and 3 ingest no rows (capacity 0): every op as pandas on
    the others' rows. No row anywhere gives the sentinels, NaN for a
    quantile and 0.0 for mean, var and std (the JAX package's formulas;
    see test_table_aggregate_poisoned_input_and_no_rows)."""
    rng = np.random.default_rng(15)
    parts = [rng.normal(size=50), np.zeros(0), rng.normal(size=30),
             np.zeros(0)]
    allv = pd.Series(np.concatenate(parts))

    def rank(env):
        mine = Table.from_pydict({"v": parts[env.rank]}, device="cpu")
        none = Table.from_pydict({"v": np.zeros(0)}, device="cpu")
        return ([dist_aggregate(env, mine, "v", op).item() for op in AGGS],
                [dist_aggregate(env, none, "v", op).item() for op in AGGS])

    got, empty = _world(rank)[0]
    want = {"sum": allv.sum(), "count": allv.count(), "min": allv.min(),
            "max": allv.max(), "mean": allv.mean(), "var": allv.var(),
            "std": allv.std(), "nunique": allv.nunique(),
            "median": allv.median(), "quantile": allv.quantile(0.5)}
    for op, g in zip(AGGS, got):
        assert g == pytest.approx(want[op], rel=RTOL), op
    assert dict(zip(AGGS, empty)) == pytest.approx(
        {"sum": 0.0, "count": 0, "min": np.inf, "max": -np.inf,
         "mean": 0.0, "var": 0.0, "std": 0.0, "nunique": 0,
         "median": np.nan, "quantile": np.nan}, nan_ok=True)


def test_dist_aggregate_nunique_regrows_under_skew():
    """Nine rows in ten hash to one rank, past the default buffer of
    twice the mean capacity: the exchange regrows, the count is exact,
    and the settled scale is remembered on the table."""
    n = 4096
    v = np.full(n, 7, np.int64)
    v[:n // 12] = np.arange(n // 12)
    tt = Table.from_pydict({"v": v}, device="cpu")

    def rank(env):
        mine = scatter_table(env, tt)
        first = dist_aggregate(env, mine, "v", "nunique").item()
        return first, mine.__dict__["_agg_scale_memo"][("nunique", "v")]

    got = _world(rank)
    assert {g[0] for g in got} == {len(np.unique(v))}
    assert {g[1] for g in got} == {2}
