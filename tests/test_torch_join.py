"""Fuzz parity of the port's sort join with ``cylon_tpu.ops.join.join``.

The same inputs (numpy, from a seed) go to both packages; the port gets
them through :mod:`cylon_tpu_torch.convert`. Valid prefixes must match
element-wise for every ``how`` and both ``ordered`` values: the row iota
sub-order makes ``ordered=False`` deterministic too, so it must match
exactly, not only as a row set.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.ops.join import join as jjoin
from cylon_tpu.ops.selection import take_columns as jtake
from cylon_tpu_torch import convert
from cylon_tpu_torch.ops.join import join as tjoin
from cylon_tpu_torch.ops.selection import take_columns as ttake


def to_port(jt):
    """A cylon_tpu Table -> the same table in the port, on the CPU."""
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu")


def assert_same_table(jt, tt):
    """Same names, types and row count; equal valid prefixes (payloads
    under a null are not compared)."""
    assert tt.column_names == jt.column_names
    n = int(jt.nrows)
    assert int(tt.nrows) == n
    got, _ = convert.to_arrays(tt)
    for name, c in jt.columns.items():
        data, validity, dtype = got[name]
        assert dtype == repr(c.dtype), name
        assert (validity is None) == (c.validity is None), name
        want = np.asarray(c.data)[:n]
        data = data[:n]
        if validity is not None:
            np.testing.assert_array_equal(validity[:n],
                                          np.asarray(c.validity)[:n])
            keep = validity[:n]
            want, data = want[keep], data[keep]
        np.testing.assert_array_equal(data, want, err_msg=name)


def _frames(case: str, rng):
    nl, nr = 700, 500
    if case == "dup_keys":
        ldf = pd.DataFrame({"k": rng.integers(0, 120, nl),
                            "a": rng.normal(size=nl)})
        rdf = pd.DataFrame({"k": rng.integers(0, 120, nr),
                            "b": rng.integers(-5, 5, nr).astype(np.int32)})
        return ldf, rdf, ["k"], (nl + 37, nr)
    if case == "null_keys":
        lk = pd.array(rng.integers(0, 60, nl), dtype="Int64")
        rk = pd.array(rng.integers(0, 60, nr), dtype="Int64")
        lk[rng.random(nl) < 0.1] = pd.NA
        rk[rng.random(nr) < 0.1] = pd.NA
        ldf = pd.DataFrame({"k": lk, "a": rng.normal(size=nl)})
        rdf = pd.DataFrame({"k": rk, "b": rng.random(nr) < 0.5})
        return ldf, rdf, ["k"], (nl, nr + 21)
    if case == "multi_keys":
        k1 = pd.array(rng.integers(0, 8, nl), dtype="Int64")
        k1[rng.random(nl) < 0.05] = pd.NA
        ldf = pd.DataFrame({"k1": k1,
                            "k2": rng.integers(0, 9, nl).astype(np.int32),
                            "v": rng.normal(size=nl)})
        rdf = pd.DataFrame({"k1": pd.array(rng.integers(0, 8, nr),
                                           dtype="Int64"),
                            "k2": rng.integers(0, 9, nr).astype(np.int32),
                            "v": rng.normal(size=nr)})
        return ldf, rdf, ["k1", "k2"], (nl + 5, nr + 3)
    if case == "above_gate":
        # cl + cr >= SCAN_MIN_SIZE: the scans and fills take the kernel
        # wrappers (their plain versions here), not torch.cumsum / cummax
        nl, nr = 3000, 2000
        ldf = pd.DataFrame({"k": rng.integers(0, 1500, nl),
                            "a": rng.normal(size=nl)})
        rdf = pd.DataFrame({"k": rng.integers(0, 1500, nr),
                            "b": rng.normal(size=nr)})
        return ldf, rdf, ["k"], (nl + 11, nr + 7)
    # float keys: NaN, -0.0 and +0.0 among them
    lk = rng.integers(0, 40, nl).astype(np.float64)
    rk = rng.integers(0, 40, nr).astype(np.float64)
    lk[:4] = [np.nan, -0.0, 0.0, np.inf]
    rk[:4] = [0.0, np.nan, -np.inf, -0.0]
    ldf = pd.DataFrame({"k": lk, "a": rng.integers(0, 100, nl)})
    rdf = pd.DataFrame({"k": rk, "a": rng.integers(0, 100, nr)})
    return ldf, rdf, ["k"], (nl, nr)


CASES = ["dup_keys", "null_keys", "multi_keys", "float_keys", "above_gate"]
HOWS = ["inner", "left", "right", "outer"]
# every how x ordered for the first two cases; the others split them
COMBOS = ([(c, h, o) for c in CASES[:2] for h in HOWS for o in (True, False)]
          + [(c, h, (i + j) % 2 == 0) for j, c in enumerate(CASES[2:])
             for i, h in enumerate(HOWS)])


@pytest.mark.parametrize("case,how,ordered", COMBOS)
def test_join_matches_jax(case, how, ordered):
    rng = np.random.default_rng(CASES.index(case))
    ldf, rdf, on, (cl, cr) = _frames(case, rng)
    jl = jct.Table.from_pandas(ldf, capacity=cl)
    jr = jct.Table.from_pandas(rdf, capacity=cr)
    want = jjoin(jl, jr, on=on, how=how, ordered=ordered)
    got = tjoin(to_port(jl), to_port(jr), on=on, how=how, ordered=ordered)
    assert got.capacity == want.capacity
    assert_same_table(want, got)
    if ordered and case != "float_keys":   # pandas joins NaN keys
        pdm = ldf.merge(rdf, on=on, how=how)
        assert int(got.nrows) == len(pdm)


def test_join_overflow_marks_nrows():
    rng = np.random.default_rng(7)
    ldf = pd.DataFrame({"k": np.zeros(50, np.int64), "a": rng.normal(size=50)})
    rdf = pd.DataFrame({"k": np.zeros(40, np.int64), "b": rng.normal(size=40)})
    jl, jr = jct.Table.from_pandas(ldf), jct.Table.from_pandas(rdf)
    want = jjoin(jl, jr, on="k", out_capacity=100)
    got = tjoin(to_port(jl), to_port(jr), on="k", out_capacity=100)
    assert int(got.nrows) == int(want.nrows) > 100
    with pytest.raises(Exception, match="capacity"):
        got.num_rows


@pytest.mark.parametrize("with_null_mask", [False, True])
def test_take_columns_matches_jax(with_null_mask):
    rng = np.random.default_rng(11)
    n = 300
    v = pd.array(rng.integers(0, 9, n), dtype="Int64")
    v[rng.random(n) < 0.2] = pd.NA
    df = pd.DataFrame({
        "i64": rng.integers(-2 ** 62, 2 ** 62, n),
        "f64": rng.normal(size=n),
        "i32": rng.integers(-9, 9, n).astype(np.int32),
        "f32": rng.normal(size=n).astype(np.float32),
        "i16": rng.integers(-300, 300, n).astype(np.int16),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "b": rng.random(n) < 0.5,
        "nullable": v,
    })
    jt = jct.Table.from_pandas(df, capacity=n + 9)
    idx = rng.integers(-3, n + 5, 512).astype(np.int32)
    mask = rng.random(512) < 0.3 if with_null_mask else None
    want = jtake(jt, jnp.asarray(idx), jnp.int32(400),
                 null_mask=None if mask is None else jnp.asarray(mask))
    got = ttake(to_port(jt), torch.from_numpy(idx), 400,
                null_mask=None if mask is None else torch.from_numpy(mask))
    assert_same_table(want, got)
