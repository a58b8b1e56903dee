"""The port's set operations against the JAX package's, element for
element: ``unique`` (first and last occurrence, by some or all columns),
``union``, ``intersect``, ``subtract`` and ``equal_tables`` (ordered and
not), on nullable, NaN and string keys in both storages, with the
storages mixed across the two sides, a column nullable on one side
only, and empty sides (no valid row, and capacity 0).
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu.ops import setops as jset
from tests.test_torch_sort import _cells, to_port

NAMES = np.array(["apple", "éclair", "", "fig", "ärger", "Zebra"], object)


def _frame(seed: int, n: int, nullable: bool = True):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, n)
    if nullable:
        k = pd.array(k, dtype="Int64")
        k[rng.random(n) < 0.2] = pd.NA
    f = rng.integers(-1, 2, n).astype(np.float64)
    f[rng.random(n) < 0.2] = np.nan
    f[rng.random(n) < 0.2] = -0.0
    s = NAMES[rng.integers(0, len(NAMES), n)]
    s[rng.random(n) < 0.1] = None
    return pd.DataFrame({"k": k, "f": f, "s": s})


def _pair(storage_a, storage_b, nullable_b=True, nb=37, capacity_b=None):
    a = _frame(11, 53)
    b = pd.concat([a.iloc[::3], _frame(12, nb)], ignore_index=True) \
        if nb else _frame(12, 0)
    if not nullable_b:
        b["k"] = b["k"].fillna(9).astype(np.int64)
    ja = jct.Table.from_pandas(a, capacity=64, string_storage=storage_a)
    jb = jct.Table.from_pandas(b.astype({"s": object}),
                               capacity=capacity_b,
                               string_storage=storage_b)
    return ja, jb


@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_unique_matches_jax(storage):
    ja, _ = _pair(storage, storage)
    ta = to_port(ja)
    for cols in (None, ["k"], ["s", "f"]):
        for keep in ("first", "last"):
            got = ct.unique(ta, cols, keep=keep).to_pandas()
            want = jset.unique(ja, cols, keep=keep).to_pandas()
            assert _cells(got) == _cells(want), (cols, keep)
    df = ja.to_pandas()
    first = ct.unique(ta, ["s", "k"]).to_pandas()
    assert _cells(first) == _cells(df.drop_duplicates(["s", "k"]))
    small = ct.unique(ta, ["k"], out_capacity=2)
    assert small.capacity == 2
    with pytest.raises(ct.OutOfCapacity):
        small.num_rows


@pytest.mark.parametrize("storages,nullable_b", [
    (("dict", "dict"), True),
    (("bytes", "dict"), False),
    (("dict", "bytes"), True),
])
def test_union_intersect_subtract_match_jax(storages, nullable_b):
    ja, jb = _pair(*storages, nullable_b=nullable_b)
    ta, tb = to_port(ja), to_port(jb)
    for op in ("union", "intersect", "subtract"):
        got = getattr(ct, op)(ta, tb).to_pandas()
        want = getattr(jset, op)(ja, jb).to_pandas()
        assert _cells(got) == _cells(want), op
        assert len(got), op
        got = getattr(ct, op)(tb, ta).to_pandas()
        want = getattr(jset, op)(jb, ja).to_pandas()
        assert _cells(got) == _cells(want), op


@pytest.mark.parametrize("capacity_b", [0, 8])
def test_set_ops_with_an_empty_side(capacity_b):
    ja, jb = _pair("dict", "bytes", nb=0, capacity_b=capacity_b)
    ta, tb = to_port(ja), to_port(jb)
    assert tb.capacity == capacity_b
    for x, y, jx, jy in ((ta, tb, ja, jb), (tb, ta, jb, ja)):
        for op in ("union", "intersect", "subtract"):
            got = getattr(ct, op)(x, y).to_pandas()
            want = getattr(jset, op)(jx, jy).to_pandas()
            assert _cells(got) == _cells(want), (op, capacity_b)
    assert ct.unique(tb).num_rows == 0
    assert ct.intersect(ta, tb).num_rows == 0
    assert ct.subtract(ta, tb).num_rows == ct.unique(ta).num_rows


def test_equal_tables_matches_jax():
    df = _frame(11, 53)
    ja = jct.Table.from_pandas(df, capacity=64)
    ta = to_port(ja)
    shuffled = df.sample(frac=1.0, random_state=3).reset_index(drop=True)
    cases = {
        "same": jct.Table.from_pandas(df),
        "bytes": jct.Table.from_pandas(df.astype({"s": object}),
                                       string_storage="bytes"),
        "shuffled": jct.Table.from_pandas(shuffled),
        "one_less": jct.Table.from_pandas(df.iloc[1:]),
        "changed": jct.Table.from_pandas(df.assign(f=df["f"].fillna(7.0))),
    }
    for name, jb in cases.items():
        tb = to_port(jb)
        for ordered in (False, True):
            want = jset.equal_tables(ja, jb, ordered=ordered)
            assert ct.equal_tables(ta, tb, ordered=ordered) == want, \
                (name, ordered)
    assert ct.equal_tables(ta, to_port(cases["shuffled"]))
    assert not ct.equal_tables(ta, to_port(cases["shuffled"]), ordered=True)
