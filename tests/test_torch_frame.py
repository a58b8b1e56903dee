"""The port's DataFrame against the JAX package's on the same inputs, on
the CPU: every case of ``tests/test_frame.py`` translated (JAX frames on
the 4-device mesh ``env4`` where the JAX case is distributed, port frames
at W = 4 on ``ThreadWorld``), the result dtype of every dunder against
``jnp``'s promotion, integer division by zero and negative integer
powers, the local ``merge`` regrowing past ``left.capacity +
right.capacity`` rows, and the README's quick start end to end at
W = 4. Keys, integers and row sets exactly; float64 results within rtol
1e-9.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu import DataFrame as JDataFrame
from cylon_tpu_torch import DataFrame, concat
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.parallel.comm import ThreadWorld

CPU = "cpu"


def _world(fn, w: int = 4):
    return ThreadWorld(w).run(lambda comm: fn(ct.CylonEnv(comm)))


def _eq_unordered(got, want, cols=None):
    cols = cols or list(want.columns)
    got = got[cols].sort_values(cols).reset_index(drop=True)
    want = want[cols].sort_values(cols).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)


def _frame(d, **kw):
    return DataFrame(d, device=CPU, **kw)


# ------------------------------------------------ tests/test_frame.py cases
def test_construct_and_introspect():
    data = {"a": [1, 2, 3], "s": ["x", "y", "x"]}
    df, jdf = _frame(data), JDataFrame(data)
    assert df.columns == jdf.columns == ["a", "s"]
    assert df.shape == jdf.shape == (3, 2)
    assert len(df) == len(jdf) == 3
    pd.testing.assert_frame_equal(df.to_pandas(), jdf.to_pandas())


def test_merge_local_matches_jax_and_pandas(rng):
    ldf = pd.DataFrame({"k": rng.integers(0, 10, 50),
                        "a": rng.normal(size=50)})
    rdf = pd.DataFrame({"k": rng.integers(0, 10, 40),
                        "b": rng.normal(size=40)})
    got = _frame(ldf).merge(_frame(rdf), on="k", how="inner",
                            out_capacity=4000).to_pandas()
    jgot = JDataFrame(ldf).merge(JDataFrame(rdf), on="k", how="inner",
                                 out_capacity=4000).to_pandas()
    want = ldf.merge(rdf, on="k")
    assert len(got) == len(jgot) == len(want)
    pd.testing.assert_frame_equal(got, jgot, check_dtype=False)
    _eq_unordered(got, want)


def test_merge_distributed(env4, rng):
    ldf = pd.DataFrame({"k": rng.integers(0, 20, 100),
                        "a": rng.normal(size=100)})
    rdf = pd.DataFrame({"k": rng.integers(0, 20, 80),
                        "b": rng.normal(size=80)})
    jgot = JDataFrame(ldf).merge(JDataFrame(rdf), on="k", env=env4,
                                 out_capacity=20_000)

    def rank(env):
        got = _frame(ldf).merge(_frame(rdf), on="k", env=env,
                                out_capacity=20_000)
        return got.is_distributed, len(got), got.to_pandas()

    res = _world(rank)
    want = ldf.merge(rdf, on="k")
    for dist, n, got in res:
        assert dist and n == len(want) == len(jgot)
        _eq_unordered(got, jgot.to_pandas())
        _eq_unordered(got, want)


def test_groupby_agg_dict_and_shortcuts(rng):
    df = pd.DataFrame({"k": rng.integers(0, 5, 40),
                       "v": rng.normal(size=40)})
    for cdf, jdf in ((_frame(df), JDataFrame(df)),):
        got = cdf.groupby("k").agg({"v": ["sum", "mean"]}).to_pandas()
        jgot = jdf.groupby("k").agg({"v": ["sum", "mean"]}).to_pandas()
        pd.testing.assert_frame_equal(got, jgot, rtol=1e-9)
        want = df.groupby("k").agg(v_sum=("v", "sum"),
                                   v_mean=("v", "mean")).reset_index()
        pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                      rtol=1e-9)
        got2 = cdf.groupby("k").sum().to_pandas()
        pd.testing.assert_frame_equal(got2, jdf.groupby("k").sum()
                                      .to_pandas(), rtol=1e-9)
        pd.testing.assert_frame_equal(
            got2, df.groupby("k").sum().reset_index(), check_dtype=False,
            rtol=1e-9)
        named = cdf.groupby("k").agg(total=("v", "sum")).to_pandas()
        assert named.columns.tolist() == ["k", "total"]


def test_groupby_distributed(env4, rng):
    df = pd.DataFrame({"k": rng.integers(0, 6, 60),
                       "v": rng.normal(size=60)})
    jgot = JDataFrame(df).groupby("k", env=env4).agg({"v": "sum"}) \
        .to_pandas().sort_values("k").reset_index(drop=True)
    res = _world(lambda env: _frame(df).groupby("k", env=env)
                 .agg({"v": "sum"}).to_pandas())
    want = df.groupby("k").agg(v_sum=("v", "sum")).reset_index()
    for got in res:
        got = got.sort_values("k").reset_index(drop=True)
        pd.testing.assert_frame_equal(got, jgot, rtol=1e-9)
        pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                      rtol=1e-9)


def test_sort_values_local_and_dist(env4, rng):
    df = pd.DataFrame({"a": rng.integers(0, 50, 80),
                       "b": rng.normal(size=80)})
    want = df.sort_values(["a", "b"]).reset_index(drop=True)
    got = _frame(df).sort_values(["a", "b"]).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    pd.testing.assert_frame_equal(
        got, JDataFrame(df).sort_values(["a", "b"]).to_pandas())
    jdist = JDataFrame(df).sort_values(["a", "b"], env=env4).to_pandas()
    for got in _world(lambda env: _frame(df).sort_values(
            ["a", "b"], env=env).to_pandas()):
        pd.testing.assert_frame_equal(got, want, check_dtype=False)
        pd.testing.assert_frame_equal(got, jdist.reset_index(drop=True))


def test_drop_duplicates(rng):
    df = pd.DataFrame({"a": rng.integers(0, 4, 30)})
    got = _frame(df).drop_duplicates().to_pandas()
    pd.testing.assert_frame_equal(
        got, df.drop_duplicates().reset_index(drop=True), check_dtype=False)
    pd.testing.assert_frame_equal(
        got, JDataFrame(df).drop_duplicates().to_pandas())


def test_filter_and_dunders():
    data = {"a": [1, 2, 3, 4], "b": [10.0, 20.0, 30.0, 40.0]}
    for df in (_frame(data), JDataFrame(data)):
        assert (df["a"] > 2).to_dict()["a"] == [False, False, True, True]
        assert df[df["a"] > 2].to_pandas()["a"].tolist() == [3, 4]
        assert (df["a"] + 10).to_dict()["a"] == [11, 12, 13, 14]
        assert df.filter(items=["b"]).columns == ["b"]


def test_setitem_and_reductions():
    for df in (_frame({"a": [1.0, 2.0, 3.0]}),
               JDataFrame({"a": [1.0, 2.0, 3.0]})):
        df["b"] = np.array([4.0, 5.0, 6.0])
        df["c"] = 7
        assert df.columns == ["a", "b", "c"]
        s = df.sum()
        assert s["a"] == 6.0 and s["b"] == 15.0 and s["c"] == 21
        assert df.mean()["b"] == 5.0
        assert df.count()["a"] == 3
    got = _frame({"a": [1.0, 2.0, 3.0]})
    got["c"] = 7
    assert got.dtypes["c"] == ct.dtypes.int64


@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "mean", "var",
                                "std", "median"])
def test_reductions_distributed(env4, rng, op):
    df = pd.DataFrame({"v": rng.normal(size=100),
                       "i": rng.integers(-50, 50, 100)})
    jres = getattr(JDataFrame(df, env=env4), op)(env=env4)
    for got in _world(lambda env: getattr(_frame(df, env=env), op)(env=env)):
        assert got.keys() == jres.keys()
        for k in got:
            np.testing.assert_allclose(got[k], jres[k], rtol=1e-9)
            np.testing.assert_allclose(got[k], getattr(df[k], op)(),
                                       rtol=1e-9)


def test_fillna_isnull():
    for df in (_frame({"a": [1.0, np.nan, 3.0]}),
               JDataFrame({"a": [1.0, np.nan, 3.0]})):
        assert df.isnull().to_dict()["a"] == [False, True, False]
        assert df.notnull().to_dict()["a"] == [True, False, True]
        assert df.fillna(0.0).to_dict()["a"] == [1.0, 0.0, 3.0]


def test_isin():
    data = {"a": [1, 2, 3], "s": ["x", "y", "z"]}
    for df in (_frame(data), JDataFrame(data)):
        assert df.isin([1, 3]).to_dict()["a"] == [True, False, True]
        assert df[["s"]].isin(["y"]).to_dict()["s"] == [False, True, False]


def test_concat(env4):
    d1, d2 = pd.DataFrame({"a": [1, 2]}), pd.DataFrame({"a": [3]})
    got = concat([_frame(d1), _frame(d2)]).to_pandas()
    want = pd.concat([d1, d2]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(
        got, jct.concat([JDataFrame(d1), JDataFrame(d2)]).to_pandas())
    for got in _world(lambda env: concat([_frame(d1), _frame(d2)],
                                         env=env).to_pandas()):
        assert sorted(got["a"].tolist()) == [1, 2, 3]


def test_rename_drop_astype():
    for mod, df in ((ct, _frame({"a": [1, 2], "b": [3, 4]})),
                    (jct, JDataFrame({"a": [1, 2], "b": [3, 4]}))):
        assert df.rename({"a": "z"}).columns == ["z", "b"]
        assert df.drop(["b"]).columns == ["a"]
        assert df.add_prefix("p_").columns == ["p_a", "p_b"]
        out = df.astype({"a": mod.dtypes.float64})
        assert out.dtypes["a"] == mod.dtypes.float64


def test_distributed_mask_filter():
    df_pd = pd.DataFrame({"a": np.arange(40)})

    def rank(env):
        df = _frame(df_pd, env=env)
        # the mask is built on the shard's layout: shard-local filters
        a = df.filter(df.table.column("a").data % 2 == 0, env=env)
        b = df.filter(df.series("a") % 2 == 0, env=env)
        c = df[df["a"] % 2 == 0]
        with pytest.raises(InvalidArgument):
            df[np.asarray(df["a"].to_dict()["a"]) % 2 == 0]
        return a.is_distributed, len(a), len(b), len(c)

    assert _world(rank) == [(True, 20, 20, 20)] * 4


def test_collectives_of_a_distributed_frame_at_w4(env4, rng):
    """Every method that gathers, called by every rank in the same
    order, gives each rank the whole frame's answer: the JAX frame's on
    the 4-device mesh and the local frame's."""
    df = pd.DataFrame({"k": rng.integers(0, 9, 37), "v": rng.normal(size=37),
                       "s": rng.choice(["a", "bb", None], 37)})
    local = _frame(df)
    jdist = JDataFrame(df, env=env4)

    def rank(env):
        d = _frame(df, env=env)
        return {"len": len(d), "shape": d.shape, "index": len(d.index),
                "pandas": d.to_pandas(), "dict": d.to_dict(),
                "numpy": d[["k", "v"]].to_numpy(),
                "arrow": d.to_arrow().num_rows, "repr": repr(d),
                "equals": d.equals(local), "head": d.head(5).to_pandas(),
                "sum": d.sum(), "gathered_sort": d.sort_values(
                    "k").to_pandas()}

    for got in _world(rank):
        assert got["len"] == len(jdist) == 37
        assert got["shape"] == jdist.shape == (37, 3)
        assert got["index"] == 37
        pd.testing.assert_frame_equal(got["pandas"], jdist.to_pandas())
        assert got["dict"] == local.to_dict()
        np.testing.assert_array_equal(got["numpy"],
                                      local[["k", "v"]].to_numpy())
        assert got["arrow"] == 37 and got["equals"]
        assert got["repr"] == repr(local)
        pd.testing.assert_frame_equal(got["head"],
                                      jdist.head(5).to_pandas())
        np.testing.assert_allclose(got["sum"]["v"], df["v"].sum(),
                                   rtol=1e-9)
        pd.testing.assert_frame_equal(got["gathered_sort"],
                                      local.sort_values("k").to_pandas())


def test_setitem_on_distributed():
    def rank(env):
        df = _frame({"a": [1.0, 2.0, 3.0]}, env=env)
        df["b"] = np.array([9.0, 8.0, 7.0])
        return df.is_distributed, df.to_pandas()["b"].tolist()

    assert _world(rank) == [(False, [9.0, 8.0, 7.0])] * 4


def test_setitem_of_a_sharded_column_stays_sharded():
    def rank(env):
        df = _frame({"a": [1.0, 2.0, 3.0, 4.0, 5.0]}, env=env)
        df["b"] = df["a"] * 2 + 1
        return df.is_distributed, df.to_pandas()["b"].tolist()

    assert _world(rank) == [(True, [3.0, 5.0, 7.0, 9.0, 11.0])] * 4


def test_fillna_string_column():
    data = pd.DataFrame({"s": ["x", None, "z"]})
    for df in (_frame(data), JDataFrame(data), _frame(
            data, string_storage="bytes")):
        assert df.fillna("missing").to_dict()["s"] == ["x", "missing", "z"]


def test_drop_duplicates_keep_last_distributed(env4):
    data = {"k": [1, 1, 2], "v": [10, 20, 30]}
    jgot = JDataFrame(data, env=env4).drop_duplicates(
        subset=["k"], keep="last", env=env4, out_capacity=24).to_pandas()
    for got in _world(lambda env: _frame(data, env=env).drop_duplicates(
            subset=["k"], keep="last", env=env,
            out_capacity=24).to_pandas()):
        got = got.sort_values("k").reset_index(drop=True)
        assert got["v"].tolist() == [20, 30]
        assert got["v"].tolist() == jgot.sort_values("k")["v"].tolist()


def _equals_frame(rng, n):
    df = pd.DataFrame({"k": rng.integers(0, 9, n), "v": rng.normal(size=n),
                       "s": rng.choice(["a", "b", None], n)})
    df.loc[3, "v"] = np.nan
    return df


def test_equals_device_side(rng):
    df = _equals_frame(rng, 50)
    df2 = df.copy()
    df2.loc[7, "v"] += 1.0
    df3 = df.copy()
    df3.loc[2, "s"] = None
    others = [df.copy(), df.rename(columns={"v": "w"}), df2, df3,
              df.astype({"k": np.int32}), df.iloc[:40]]
    for mk in (_frame, JDataFrame):
        a = mk(df)
        verdicts = [a.equals(mk(o)) for o in others]
        assert verdicts == [True, False, False, False, False, False]
    # a distributed layout compares against a local frame by gathering
    assert _world(lambda env: _frame(df, env=env).equals(_frame(df))) \
        == [True] * 4


def test_equals_distributed_no_gather(rng, monkeypatch):
    """Frames of one shard layout compare shard by shard with one
    all-reduce: no gather of either table."""
    from cylon_tpu_torch import frame as frame_mod

    df = _equals_frame(rng, 400)
    df2 = df.copy()
    df2.loc[111, "v"] += 1.0
    gathered = []
    real = frame_mod.gather_table

    def logged(env, t):
        gathered.append(t.capacity)
        return real(env, t)

    monkeypatch.setattr(frame_mod, "gather_table", logged)

    def rank(env):
        a = _frame(df, env=env)
        return (a.equals(_frame(df.copy(), env=env)),
                a.equals(_frame(df2, env=env)))

    assert _world(rank) == [(True, False)] * 4
    assert gathered == []
    # a row missing on one shard only: still shard-local, and unequal
    assert _world(lambda env: _frame(df, env=env).equals(
        _frame(df.iloc[:399], env=env))) == [False] * 4


def test_equals_mixed_storage_and_dtype_fallback(rng):
    df = pd.DataFrame({"s": rng.choice(["aa", "bb", "cc"], 60),
                       "x": rng.integers(0, 5, 60)})
    a, b = _frame(df, string_storage="bytes"), _frame(df.copy())
    assert a.equals(b) and b.equals(a)
    df2 = pd.DataFrame({"n": pd.array([1, None, 3], dtype="Int64")})
    x = _frame(df2)
    y = _frame(x.to_pandas())
    jx = JDataFrame(df2)
    jy = JDataFrame(jx.to_pandas())
    assert x.equals(y) == x.to_pandas().equals(y.to_pandas()) \
        == jx.equals(jy)


# ------------------------------------------------------------- dunders
_DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
           np.float16, np.float32, np.float64]
_SCALARS = [2, -3, 1.5, True, np.float32(2.5), np.int32(3), np.int8(-2)]
#: each dunder of cylon_tpu/frame.py:420-443: its jnp ufunc, reversed?
_BINOPS = {"__add__": ("add", False), "__radd__": ("add", True),
           "__sub__": ("subtract", False), "__rsub__": ("subtract", True),
           "__mul__": ("multiply", False), "__rmul__": ("multiply", True),
           "__truediv__": ("true_divide", False),
           "__rtruediv__": ("true_divide", True),
           "__floordiv__": ("floor_divide", False),
           "__mod__": ("mod", False), "__pow__": ("power", False),
           "__and__": ("bitwise_and", False),
           "__or__": ("bitwise_or", False),
           "__xor__": ("bitwise_xor", False), "__eq__": ("equal", False),
           "__ne__": ("not_equal", False), "__lt__": ("less", False),
           "__le__": ("less_equal", False), "__gt__": ("greater", False),
           "__ge__": ("greater_equal", False)}


def _jax_dtype(ufunc: str, reverse: bool, dtype, other):
    """The dtype the JAX frame's dunder gives (``jax.eval_shape`` of its
    ``jnp`` ufunc, as it runs under x64), or the exception's name."""
    import jax
    import jax.numpy as jnp

    fn = getattr(jnp, ufunc)
    col = jax.ShapeDtypeStruct((4,), dtype)
    try:
        if isinstance(other, np.dtype):
            out = jax.eval_shape(fn, col, jax.ShapeDtypeStruct((4,), other))
        elif reverse:
            out = jax.eval_shape(lambda x: fn(other, x), col)
        else:
            out = jax.eval_shape(lambda x: fn(x, other), col)
    except Exception as e:   # noqa: BLE001 -- the kind of failure compared
        return type(e).__name__
    return np.dtype(out.dtype).name


def _port_dtype(op: str, dtype, other):
    a = _frame({"x": np.ones(4, dtype)})
    if isinstance(other, np.dtype):
        other = _frame({"x": np.ones(4, other)})
    try:
        out = getattr(a, op)(other)
    except Exception as e:   # noqa: BLE001
        return type(e).__name__
    return str(out.to_pandas()["x"].dtype)


@pytest.mark.parametrize("op", sorted(_BINOPS))
def test_dunder_result_dtypes_match_jax(op):
    """Every dunder of the frame over every pair of column dtypes and
    against Python and numpy scalars: the result dtype the JAX frame
    gives (``int64 + 1.5`` is float64 there, float32 in torch;
    ``int32 / int32`` float32, ``int64 / int64`` float64), or a failure
    where it fails."""
    ufunc, reverse = _BINOPS[op]
    others = [*_SCALARS, *(np.dtype(d) for d in _DTYPES)]
    for dt in _DTYPES:
        for other in others:
            want = _jax_dtype(ufunc, reverse, np.dtype(dt), other)
            got = _port_dtype(op, dt, other)
            if want.endswith("Error"):
                assert got.endswith("Error"), (op, dt, other, want, got)
            else:
                assert got == want, (op, dt, other)


def test_dunder_values_match_jax(rng):
    """Values of the arithmetic dunders on mixed columns and scalars,
    against the JAX frame (one compile a case: a few cases)."""
    cols = {"i": rng.integers(-9, 9, 8).astype(np.int64),
            "j": rng.integers(1, 9, 8).astype(np.int32),
            "f": rng.normal(size=8).astype(np.float32),
            "d": rng.normal(size=8)}
    mine, theirs = _frame(cols), JDataFrame(cols)
    for op, other in (("__add__", 1.5), ("__truediv__", 3),
                      ("__rtruediv__", 2), ("__mul__", np.float32(0.5)),
                      ("__pow__", 2), ("__floordiv__", 2),
                      ("__mod__", -3), ("__sub__", True)):
        got = getattr(mine, op)(other).to_pandas()
        want = getattr(theirs, op)(other).to_pandas()
        pd.testing.assert_frame_equal(got, want, rtol=1e-6)


def _outcome(fn):
    """(dtype name, values) of a frame op's single column."""
    col = fn().to_pandas()
    col = col[col.columns[0]]
    return str(col.dtype), col.to_numpy()


@pytest.mark.parametrize("op", ["__neg__", "__abs__", "__invert__"])
def test_unary_dunders_match_jax(op, rng):
    cols = {"i": np.array([-3, 0, 5], np.int64),
            "f": np.array([-1.5, 0.0, 2.0]), "b": np.array([True, False,
                                                              True])}
    for name in cols:
        if op == "__neg__" and name == "b":
            continue
        if op == "__invert__" and name == "f":
            continue
        got = _outcome(lambda: getattr(_frame(cols)[[name]], op)())
        want = _outcome(lambda: getattr(JDataFrame(cols)[[name]], op)())
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_integer_division_by_zero_and_negative_powers():
    """XLA's integer results where torch raises or differs: ``x // 0``
    is -1 adjusted by floor (7 // 0 = -2, 0 // 0 = -1), ``x % 0`` is 0,
    ``INT64_MIN // -1`` wraps; an array power with a negative exponent
    keeps the low six exponent bits (2 ** -1 = -2**63 in int64), and a
    Python negative integer power of an integer column raises."""
    lo = np.iinfo(np.int64).min
    x = np.array([7, -7, 5, 0, -5, lo], np.int64)
    y = np.array([2, 2, 0, 0, 0, -1], np.int64)
    mine = _frame({"x": x})
    theirs = JDataFrame({"x": x})
    my, jy = _frame({"x": y}), JDataFrame({"x": y})
    fd = (mine // my).to_dict()["x"]
    assert fd == (theirs // jy).to_dict()["x"]
    assert fd == [3, -4, -2, -1, -2, lo]
    md = (mine % my).to_dict()["x"]
    assert md == (theirs % jy).to_dict()["x"] == [1, 1, 0, 0, 0, 0]
    assert (mine // 0).to_dict()["x"] == (theirs // 0).to_dict()["x"]
    assert (mine % 0).to_dict()["x"] == (theirs % 0).to_dict()["x"]
    b = np.array([2, 3, -2, 0, 1, -1], np.int64)
    e = np.array([-1, -2, -3, -1, -5, -3], np.int64)
    got = (_frame({"x": b}) ** _frame({"x": e})).to_dict()["x"]
    assert got == (JDataFrame({"x": b}) ** JDataFrame({"x": e})) \
        .to_dict()["x"]
    assert got[0] == -2 ** 63
    assert (_frame({"x": b}) ** 3).to_dict()["x"] == \
        (JDataFrame({"x": b}) ** 3).to_dict()["x"] == [8, 27, -8, 0, 1, -1]
    with pytest.raises(TypeError):
        _frame({"x": b}) ** -1
    with pytest.raises(TypeError):
        JDataFrame({"x": b}) ** -1
    i32 = np.array([7, -7, 0], np.int32)
    z32 = np.zeros(3, np.int32)
    assert (_frame({"x": i32}) // _frame({"x": z32})).to_dict()["x"] == \
        (JDataFrame({"x": i32}) // JDataFrame({"x": z32})).to_dict()["x"]


def test_float_floor_division_and_mod_match_jax():
    x = np.array([7.5, -7.5, 1.0, 0.0, -0.0, np.inf, 3.0])
    y = np.array([2.0, 2.0, 0.0, 0.0, 3.0, 2.0, -np.inf])
    for op in ("__floordiv__", "__mod__"):
        got = getattr(_frame({"x": x}), op)(_frame({"x": y})) \
            .to_pandas()["x"].to_numpy()
        want = getattr(JDataFrame({"x": x}), op)(JDataFrame({"x": y})) \
            .to_pandas()["x"].to_numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- map / where
def test_applymap_and_map_types_follow_jax():
    data = {"i": np.array([1, 2, 3], np.int64),
            "f": np.array([0.5, 1.5, 2.5], np.float32),
            "s": np.array(["ab", "c", "de"], object)}
    for fn in (lambda x: x * 1.5, lambda x: x + 1 if not isinstance(
            x, str) else x.upper()):
        mine = _frame({k: v for k, v in data.items() if k != "s"}) \
            .applymap(fn).to_pandas()
        theirs = JDataFrame({k: v for k, v in data.items() if k != "s"}) \
            .applymap(fn).to_pandas()
        pd.testing.assert_frame_equal(mine, theirs, rtol=1e-9)
    assert _frame(data).applymap(lambda x: x.upper() if isinstance(
        x, str) else x).to_dict()["s"] == ["AB", "C", "DE"]
    # a function torch cannot vmap runs on the host, as JAX's fallback
    host = _frame({"i": np.array([1, 2, 3])}).applymap(
        lambda x: int(x) % 2 == 0)
    assert host.to_dict()["i"] == [False, True, False]


def test_where_mask_dropna_match_jax():
    data = pd.DataFrame({"a": pd.array([1, None, 3, 4], dtype="Int64"),
                         "f": [1.0, np.nan, 3.0, 4.0],
                         "s": ["x", "y", None, "w"], "c": [1, 2, 3, 4]})
    mine, theirs = _frame(data), JDataFrame(data)
    for fn in (lambda d: d.where(d[["f"]] > 2.0),
               lambda d: d[["a", "f"]].where(d[["f"]] > 2.0, 0),
               lambda d: d[["a", "f"]].mask(d[["f"]] > 2.0, 7),
               lambda d: d[["s"]].where(d[["f"]] > 2.0, "z"),
               lambda d: d.dropna(),
               lambda d: d.dropna(how="all"),
               lambda d: d.dropna(axis=1),
               lambda d: d.dropna(subset="s")):
        if fn(theirs).columns != fn(mine).columns:
            raise AssertionError("columns differ")
        pd.testing.assert_frame_equal(fn(mine).to_pandas(),
                                      fn(theirs).to_pandas())


# ---------------------------------------------------------- the regrow
def test_merge_regrows_past_the_default_capacity(rng):
    """An N:M merge whose rows pass ``left.capacity + right.capacity``
    reruns at twice the scale (``plan.regrow_eager``), as the JAX frame
    does; an explicit capacity raises instead."""
    ldf = pd.DataFrame({"k": rng.integers(0, 3, 60),
                        "a": rng.normal(size=60)})
    rdf = pd.DataFrame({"k": rng.integers(0, 3, 50),
                        "b": rng.normal(size=50)})
    want = ldf.merge(rdf, on="k")
    assert len(want) > 110
    got = _frame(ldf).merge(_frame(rdf), on="k").to_pandas()
    jgot = JDataFrame(ldf).merge(JDataFrame(rdf), on="k").to_pandas()
    assert len(got) == len(jgot) == len(want)
    _eq_unordered(got, want)
    pd.testing.assert_frame_equal(got, jgot)
    with pytest.raises(ct.OutOfCapacity):
        len(_frame(ldf).merge(_frame(rdf), on="k", out_capacity=110))
    from cylon_tpu_torch import plan

    with plan.capacity_scale(16):
        t = ct.join(_frame(ldf).table, _frame(rdf).table, on="k")
    assert t.capacity == 16 * 110 and t.num_rows == len(want)


# ---------------------------------------------------- README quick start
def test_readme_quick_start_end_to_end(env4, rng):
    """The README's quick start, written for the port, on ThreadWorld
    W = 4 against the JAX package's on env4 and against pandas."""
    df = ct.DataFrame({"k": [1, 2, 2], "v": [10., 20., 30.]}, device=CPU)
    out = df.merge(ct.DataFrame({"k": [2, 3], "w": [5., 6.]}, device=CPU),
                   on="k")
    assert out.to_dict() == {"k": [2, 2], "v": [20.0, 30.0],
                             "w": [5.0, 5.0]}
    big_pd = pd.DataFrame({"key": rng.integers(0, 40, 120),
                           "g": rng.integers(0, 5, 120),
                           "v": rng.normal(size=120)})
    other_pd = pd.DataFrame({"key": rng.integers(0, 40, 90),
                             "w": rng.normal(size=90)})

    jbig = JDataFrame(big_pd, env=env4)
    jres = jbig.merge(JDataFrame(other_pd, env=env4), on="key", env=env4)
    jsorted = jres.sort_values("key", env=env4).to_pandas()

    def rank(env):
        big = ct.DataFrame(big_pd, env=env, device=CPU)
        res = big.merge(ct.DataFrame(other_pd, env=env, device=CPU),
                        on="key", env=env)
        srt = res.sort_values("key", env=env).to_pandas()
        agg = big.groupby("g", env=env).agg({"v": ["sum", "mean"]})
        uniq = big.drop_duplicates(subset="key", env=env)
        return srt, agg.to_pandas(), uniq.to_pandas()

    want = big_pd.merge(other_pd, on="key")
    want_agg = big_pd.groupby("g").agg(v_sum=("v", "sum"),
                                       v_mean=("v", "mean")).reset_index()
    for srt, agg, uniq in _world(rank):
        assert srt["key"].tolist() == sorted(want["key"].tolist())
        assert srt["key"].tolist() == jsorted["key"].tolist()
        _eq_unordered(srt, want)
        pd.testing.assert_frame_equal(
            agg.sort_values("g").reset_index(drop=True), want_agg,
            check_dtype=False, rtol=1e-9)
        assert sorted(uniq["key"]) == sorted(big_pd["key"].unique())
