"""The port's Series against the JAX package's on the same inputs, on the
CPU: arithmetic and comparisons (result types and values), boolean
logic, ``isin`` (numbers, temporals, nulls, strings of both storages),
``fillna`` / ``dropna`` / ``isnull``, the ``str`` accessor on dictionary
codes and device bytes, ``map`` (a function ``torch.func.vmap`` takes,
and one it cannot), reductions, and a Series of a distributed frame.
Exact for integers and masks; float64 within rtol 1e-9.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu.series import Series as JSeries
from cylon_tpu_torch import Series
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.parallel.comm import ThreadWorld

NAMES = np.array(["apple", "Éclair", "", "fig", "banana split", None,
                  "apricot", "fig"], object)


def _pair(values, name="x"):
    return Series(values, name, device="cpu"), JSeries(values, name)


def _same(got, want, rtol=1e-9):
    g, w = got.to_numpy(), want.to_numpy()
    assert got.dtype == ct.dtypes.from_name(repr(want.dtype)) or \
        repr(got.dtype) == repr(want.dtype), (got.dtype, want.dtype)
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, w)


_INTS = np.array([5, -3, 0, 7, 2, -8], np.int64)
_FLOATS = np.array([1.5, -2.25, 0.0, np.nan, 4.0, 10.0])


@pytest.mark.parametrize("op", ["__add__", "__radd__", "__sub__",
                                "__rsub__", "__mul__", "__rmul__",
                                "__truediv__", "__rtruediv__",
                                "__floordiv__", "__rfloordiv__", "__mod__",
                                "__pow__"])
def test_arithmetic_matches_jax(op):
    (a, ja), (b, jb) = _pair(_INTS), _pair(_FLOATS)
    i32, ji32 = _pair(_INTS.astype(np.int32))
    for x, jx in ((a, ja), (b, jb), (i32, ji32)):
        for other, jother in ((2, 2), (1.5, 1.5), (b, jb), (i32, ji32)):
            if op == "__pow__" and other is b:
                continue
            _same(getattr(x, op)(other), getattr(jx, op)(jother))


@pytest.mark.parametrize("op", ["__eq__", "__ne__", "__lt__", "__le__",
                                "__gt__", "__ge__"])
def test_comparisons_match_jax(op):
    (a, ja), (b, jb) = _pair(_INTS), _pair(_FLOATS)
    for x, jx, other, jother in ((a, ja, 2, 2), (a, ja, 0.5, 0.5),
                                 (b, jb, a, ja), (a, ja, b, jb)):
        got, want = getattr(x, op)(other), getattr(jx, op)(jother)
        assert got.dtype == ct.dtypes.bool_
        _same(got, want)


def test_logic_and_unary_match_jax():
    m1 = np.array([True, False, True, False])
    m2 = np.array([True, True, False, False])
    (p, jp), (q, jq) = _pair(m1), _pair(m2)
    for op in ("__and__", "__or__", "__xor__"):
        _same(getattr(p, op)(q), getattr(jp, op)(jq))
    _same(~p, ~jp)
    a, ja = _pair(_INTS)
    _same(-a, -ja)
    _same(abs(a), abs(ja))


def test_nulls_propagate_through_arithmetic():
    s = Series(pd.array([1, None, 3], dtype="Int64").to_numpy(
        dtype=object, na_value=None), device="cpu")
    col = ct.Table.from_pandas(pd.DataFrame(
        {"x": pd.array([1, None, 3], dtype="Int64")}), device="cpu")
    s = Series(col.column("x"), "x", nrows=3)
    out = (s + 1).to_numpy()
    assert out[0] == 2 and out[1] is None and out[2] == 4
    assert (s.isnull().to_numpy() == [False, True, False]).all()


@pytest.mark.parametrize("case", ["ints", "floats_nan", "dict", "bytes",
                                  "dates", "mixed_probe"])
def test_isin_matches_jax(case):
    if case == "ints":
        vals, probe = _INTS, [5, 7, 1.5, "a"]
    elif case == "floats_nan":
        vals, probe = _FLOATS, [1.5, None, 4]
    elif case in ("dict", "bytes"):
        vals, probe = NAMES, ["fig", None, "kiwi", 3]
    elif case == "dates":
        vals = np.array(["2020-01-01", "2021-06-30", "NaT"],
                        "datetime64[ns]")
        probe = [np.datetime64("2021-06-30"), 7, None]
    else:
        vals, probe = np.array([1, 2, 3], np.int32), [2, 2.0, 2.5, True]
    if case in ("dict", "bytes"):
        t = ct.Table.from_pandas(pd.DataFrame({"x": vals}), device="cpu",
                                 string_storage="dict" if case == "dict"
                                 else "bytes")
        got = Series(t.column("x"), "x", nrows=len(vals)).isin(probe)
        jt = jct.Table.from_pandas(pd.DataFrame({"x": vals}),
                                   string_storage="dict" if case == "dict"
                                   else "bytes")
        want = JSeries(jt.column("x"), "x", nrows=len(vals)).isin(probe)
    else:
        s, js = _pair(vals)
        got, want = s.isin(probe), js.isin(probe)
    _same(got, want)
    if case == "ints":
        assert got.to_numpy().tolist() == pd.Series(vals).isin(
            [5, 7]).tolist()


def test_fillna_dropna_isnull_match_jax():
    (s, js) = _pair(_FLOATS)
    _same(s.fillna(0.5), js.fillna(0.5))
    _same(s.isnull(), js.isnull())
    _same(s.notnull(), js.notnull())
    _same(s.dropna(), js.dropna())
    assert len(s.dropna()) == 5
    for storage in ("dict", "bytes"):
        t = ct.Table.from_pandas(pd.DataFrame({"x": NAMES}), device="cpu",
                                 string_storage=storage)
        jt = jct.Table.from_pandas(pd.DataFrame({"x": NAMES}),
                                   string_storage=storage)
        got = Series(t.column("x"), "x", nrows=len(NAMES)).fillna("zz")
        want = JSeries(jt.column("x"), "x", nrows=len(NAMES)).fillna("zz")
        assert got.to_numpy().tolist() == want.to_numpy().tolist()


@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_str_accessor_matches_jax_on_both_storages(storage):
    t = ct.Table.from_pandas(pd.DataFrame({"x": NAMES}), device="cpu",
                             string_storage=storage)
    jt = jct.Table.from_pandas(pd.DataFrame({"x": NAMES}),
                               string_storage=storage)
    s = Series(t.column("x"), "x", nrows=len(NAMES))
    js = JSeries(jt.column("x"), "x", nrows=len(NAMES))
    cases = [lambda x: x.str.startswith("ap"),
             lambda x: x.str.endswith("g"),
             lambda x: x.str.contains("an"),
             lambda x: x.str.contains("^a.*t$"),
             lambda x: x.str.contains(".", regex=False),
             lambda x: x.str.len(), lambda x: x.str.upper(),
             lambda x: x.str.lower()]
    compare = [lambda x: x == "fig", lambda x: x != "fig",
               lambda x: x < "b"]
    if storage == "bytes":
        cases += compare
    else:   # a scalar compare of dictionary codes raises in both
        for fn in compare:
            with pytest.raises(ct.TypeError_):
                fn(s)
            with pytest.raises(jct.TypeError_):
                fn(js)
    for fn in cases:
        got, want = fn(s), fn(js)
        assert got.to_numpy().tolist() == want.to_numpy().tolist()
    pdv = pd.Series(NAMES)
    assert s.str.startswith("ap").to_numpy().tolist() == \
        pdv.str.startswith("ap").fillna(False).tolist()


def test_map_types_follow_jax():
    (i, ji), (f, jf) = _pair(_INTS), _pair(_FLOATS.astype(np.float32))
    for fn in (lambda x: x * 1.5, lambda x: x + 1, lambda x: x / 2,
               lambda x: x > 0):
        _same(i.map(fn), ji.map(fn))
        _same(f.map(fn), jf.map(fn))
    # a function vmap cannot trace maps on the host, as JAX's fallback
    host = i.map(lambda x: 1 if int(x) > 0 else 0)
    assert host.to_numpy().tolist() == ji.map(
        lambda x: 1 if int(x) > 0 else 0).to_numpy().tolist()
    t = ct.Table.from_pandas(pd.DataFrame({"x": NAMES}), device="cpu")
    s = Series(t.column("x"), "x", nrows=len(NAMES))
    assert s.map(lambda v: None if v is None else v[:2]).to_numpy() \
        .tolist() == [None if v is None else v[:2] for v in NAMES]


@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "mean", "var",
                                "std", "nunique"])
def test_reductions_match_jax(op):
    for vals in (_INTS, _FLOATS):
        s, js = _pair(vals)
        np.testing.assert_allclose(getattr(s, op)(), getattr(js, op)(),
                                   rtol=1e-9)
    s, js = _pair(_FLOATS)
    np.testing.assert_array_equal(s.unique(), js.unique())


def test_distributed_series_is_shard_local():
    df_pd = pd.DataFrame({"a": np.arange(10, dtype=np.int64)})

    def rank(comm):
        env = ct.CylonEnv(comm)
        s = ct.DataFrame(df_pd, env=env, device="cpu").series("a")
        doubled = s * 2
        with pytest.raises(InvalidArgument):
            len(s)
        with pytest.raises(InvalidArgument):
            s.sum()
        return doubled.is_distributed, doubled.column.data[
            :int(doubled.nrows)].tolist()

    got = ThreadWorld(4).run(rank)
    assert [g[0] for g in got] == [True] * 4
    assert sum((g[1] for g in got), []) == [2 * i for i in range(10)]
