"""Group-by of the port against the JAX package on the CPU, on the same
numpy inputs from a seed: ``dense_group_ids`` and ``segmented_totals``,
``groupby_aggregate`` for every op of ``AGG_OPS`` against both JAX
reduction routes (``CYLON_TPU_SEGSCAN`` 0 and 1), and ``dist_groupby`` at
W = 4 (``ThreadWorld`` against the 4-device mesh ``env4``) on both of its
paths, with an empty shard and a skewed key that regrows.

Tolerances: sums, means, var, std and sumsq at rtol 1e-12 (the JAX CPU
route sums in row order, its scan route in tree order); counts, sizes,
min, max, first, last and nunique exactly; median and quantile exactly
where they select a value, at rtol 1e-12 where they interpolate.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.ops import kernels as jkernels
from cylon_tpu.ops.groupby import AGG_OPS as JAGG_OPS
from cylon_tpu.ops.groupby import groupby_aggregate as jgroupby
from cylon_tpu.parallel import dist_groupby as jdist_groupby
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu_torch import Table, convert
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.ops import groupby as tgroupby
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.groupby import AGG_OPS, groupby_aggregate
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import dist_groupby
from cylon_tpu_torch.parallel.dtable import gather_table, scatter_table

RTOL = 1e-12
EXACT_OPS = ("count", "size", "min", "max", "first", "last", "nunique")
Q = 0.3


def to_port(jt):
    """A JAX table's arrays, dictionaries and bytes words as a port
    table on the CPU."""
    cols, dicts = {}, {}
    for n, c in jt.columns.items():
        cols[n] = (np.asarray(c.data),
                   None if c.validity is None else np.asarray(c.validity),
                   repr(c.dtype))
        if c.dictionary is not None:
            dicts[n] = c.dictionary.values
    return convert.from_arrays(cols, int(jt.nrows), device="cpu",
                               dictionaries=dicts)


def _frame(rng, n: int = 240):
    """Keys of every kind and values with nulls and NaNs."""
    v = rng.normal(size=n) * 10
    v[rng.random(n) < 0.1] = np.nan
    iv = pd.array(rng.integers(-50, 50, n), dtype="Int64")
    iv[rng.random(n) < 0.1] = pd.NA
    nk = pd.array(rng.integers(0, 12, n), dtype="Int64")
    nk[rng.random(n) < 0.08] = pd.NA
    names = np.array(["apple", "fig", "", "kiwi", "pear", "éclair",
                      "plum"], object)
    sk = names[rng.integers(0, len(names), n)]
    sk[rng.random(n) < 0.05] = None
    return pd.DataFrame({"k": rng.integers(0, 20, n), "nk": nk, "sk": sk,
                         "v": v, "i": iv, "c": names[rng.integers(0, 3, n)]})


def _nulls_as_tag(a: np.ndarray) -> np.ndarray:
    """An object column's None and NaN as one tag, so that nulls compare
    equal whichever way a package decodes them."""
    if a.dtype != object:
        return a
    return np.array(["<null>" if v is None or v is pd.NA
                     or (isinstance(v, float) and np.isnan(v)) else v
                     for v in a], object)


def assert_table_matches(got, want, specs, q: float = Q):
    """Port table ``got`` against JAX table ``want``: the group count, the
    keys exactly, each aggregate by its op's tolerance, the logical
    dtypes equal."""
    n = want.num_rows
    assert got.num_rows == n
    gp, wp = got.to_pandas(), want.to_pandas()
    assert list(gp.columns) == list(wp.columns)
    for name in gp.columns:
        assert repr(got.column(name).dtype) == repr(want.column(name).dtype), \
            name
    op_of = {name: op for _, op, name in specs}
    for name in gp.columns:
        a, b = gp[name].to_numpy(), wp[name].to_numpy()
        op = op_of.get(name)
        if op is None or op in EXACT_OPS or a.dtype == object:
            np.testing.assert_array_equal(_nulls_as_tag(a), _nulls_as_tag(b),
                                          err_msg=name)
            continue
        a, b = a.astype(float), b.astype(float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        if op in ("median", "quantile"):
            qq = 0.5 if op == "median" else q
            cnt = _counts(got, specs, name)
            sel = (qq * np.maximum(cnt - 1, 0)) % 1 == 0
            np.testing.assert_array_equal(a[sel], b[sel], err_msg=name)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=name)


def _counts(got, specs, name):
    """The non-missing count of the source column behind ``name``."""
    src = next(s for s, _, n in specs if n == name)
    cname = next(n for s, op, n in specs if s == src and op == "count")
    return got.to_pandas()[cname].to_numpy().astype(float)


def _specs(sources, ops):
    return [(s, op, f"{s}_{op}") for s in sources for op in ops]


# ------------------------------------------------------------ primitives
def test_dense_group_ids_match_jax():
    rng = np.random.default_rng(1)
    df = _frame(rng)
    jt = jct.Table.from_pandas(df)
    tt = to_port(jt)
    by = ["nk", "sk"]
    jgid, jng, jperm = jkernels.dense_group_ids(
        [jt.column(c).data for c in by], jt.nrows,
        [jt.column(c).validity for c in by])
    gid, ng, perm = kernels.dense_group_ids(
        [tt.column(c).data for c in by], tt.nrows,
        [tt.column(c).validity for c in by])
    assert int(ng) == int(jng)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_segmented_totals_match_jax():
    """Every channel kind over a group-sorted layout with empty groups
    past the last id and padding rows, against the JAX package's fused
    scan."""
    rng = np.random.default_rng(2)
    cap, nvalid, out_cap = 300, 260, 64
    gid = np.sort(rng.integers(0, 40, nvalid)).astype(np.int32)
    gid = np.concatenate([np.unique(gid, return_inverse=True)[1]
                          .astype(np.int32), np.full(cap - nvalid, cap,
                                                     np.int32)])
    f = rng.normal(size=cap)
    i = rng.integers(-10**12, 10**12, cap)
    has = rng.random(cap) < 0.7
    jch = [("sum", f), ("sum", i), ("min", f), ("max", i),
           ("first", (i, has)), ("last", (f, has))]
    jout, _ = jkernels.segmented_totals(
        np.asarray(gid), out_cap,
        [(k, tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
          else np.asarray(v)) for k, v in jch])
    tch = [(k, tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple)
            else torch.from_numpy(v)) for k, v in jch]
    tout, _ = kernels.segmented_totals(torch.from_numpy(gid), out_cap, tch)
    ngroups = int(gid[:nvalid].max()) + 1
    for (kind, _), j, t in zip(jch, jout, tout):
        for a, b in zip(t, j):
            a, b = a.numpy()[:ngroups], np.asarray(b)[:ngroups]
            if kind == "sum" and a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=kind)
            else:
                np.testing.assert_array_equal(a, b, err_msg=kind)


# ------------------------------------------------------- groupby_aggregate
_KEYS = {
    "int64": ["k"],
    "nullable": ["nk"],
    "multi": ["nk", "c"],
    "dict": ["sk"],
    "bytes": ["sk"],
}


@pytest.mark.parametrize("segscan", ["0", "1"])
@pytest.mark.parametrize("keys", list(_KEYS))
def test_groupby_every_op_matches_jax(monkeypatch, keys, segscan):
    """Every op of AGG_OPS on a float column with NaNs and a nullable
    int64 column, grouped by each kind of key, against both JAX
    routes."""
    assert AGG_OPS == JAGG_OPS
    monkeypatch.setenv("CYLON_TPU_SEGSCAN", segscan)
    df = _frame(np.random.default_rng(3))
    storage = "bytes" if keys == "bytes" else "dict"
    jt = jct.Table.from_pandas(df, string_storage=storage)
    tt = to_port(jt)
    ops = AGG_OPS if keys == "int64" else \
        ("sum", "count", "min", "mean", "std", "first", "nunique", "median")
    specs = _specs(["v", "i"], ops)
    if "count" not in ops:
        specs += _specs(["v", "i"], ["count"])
    by = _KEYS[keys]
    want = jgroupby(jt, by, specs, quantile=Q)
    got = groupby_aggregate(tt, by, specs, quantile=Q)
    assert_table_matches(got, want, specs)


def test_groupby_string_values_match_jax():
    """A dictionary-coded value column: min and max by code order,
    first, last and nunique; a device-bytes value column: count, first,
    last and nunique by its words."""
    df = _frame(np.random.default_rng(4))
    jt = jct.Table.from_pandas(df)
    specs = _specs(["sk"], ["count", "min", "max", "first", "last",
                            "nunique"])
    assert_table_matches(groupby_aggregate(to_port(jt), ["k"], specs),
                         jgroupby(jt, ["k"], specs), specs)
    tb = Table.from_pandas(df, device="cpu", string_storage="bytes")
    bspecs = _specs(["sk"], ["count", "first", "last", "nunique"])
    got = groupby_aggregate(tb, ["k"], bspecs).to_pandas()
    want = df.groupby("k").agg(
        sk_count=("sk", "count"), sk_first=("sk", "first"),
        sk_last=("sk", "last"), sk_nunique=("sk", "nunique")).reset_index()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def _widths_frame(n: int = 200):
    """Value columns of every width and signedness: uint64 values past
    2^63, float32 with NaNs, bool."""
    rng = np.random.default_rng(9)
    f32 = rng.normal(size=n).astype(np.float32)
    f32[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "k": rng.integers(0, 9, n),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32),
        "u64": rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        + np.uint64(2 ** 62) * rng.integers(0, 3, n).astype(np.uint64),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "f32": f32, "b": rng.random(n) < 0.3})


def test_groupby_narrow_and_unsigned_values_match_jax():
    """Sums in int64, uint64 (modular, on the bit pattern) and float32;
    min and max by each dtype's sentinels; means in float64 (float32 for
    one-byte values)."""
    df = _widths_frame()
    jt = jct.Table.from_pandas(df)
    specs = _specs(["u8", "u32", "u64", "i8", "f32", "b"],
                   ["sum", "min", "max", "mean", "count"])
    assert_table_matches(groupby_aggregate(to_port(jt), ["k"], specs),
                         jgroupby(jt, ["k"], specs), specs)


def test_groupby_matches_pandas_and_sorts_null_keys_last():
    df = _frame(np.random.default_rng(5))
    tt = Table.from_pandas(df, device="cpu")
    got = groupby_aggregate(tt, ["nk"], [("v", "sum"), ("v", "mean"),
                                         ("i", "max")]).to_pandas()
    want = df.groupby("nk", dropna=False, sort=True).agg(
        v_sum=("v", "sum"), v_mean=("v", "mean"),
        i_max=("i", "max")).reset_index()
    assert got["nk"].iloc[-1] is None
    np.testing.assert_array_equal(got["nk"].to_numpy()[:-1],
                                  want["nk"].to_numpy()[:-1].astype(int))
    for c in ("v_sum", "v_mean", "i_max"):
        np.testing.assert_allclose(got[c].to_numpy(float),
                                   want[c].to_numpy(float), rtol=RTOL)


@pytest.mark.parametrize("capacity", [0, 8])
def test_groupby_without_rows(capacity):
    """A table of capacity 0, and one of capacity 8 without a valid row:
    no groups, every op."""
    empty = pd.DataFrame({"k": np.zeros(0, np.int64),
                          "v": np.zeros(0, np.float64)})
    tt = Table.from_pandas(empty, capacity=capacity, device="cpu")
    got = groupby_aggregate(tt, ["k"], _specs(["v"], AGG_OPS))
    assert got.num_rows == 0
    assert list(got.to_pandas().columns) == \
        ["k"] + [f"v_{op}" for op in AGG_OPS]


def test_groupby_regrow_ladder_settles_and_remembers(monkeypatch):
    """20000 rows in 15000 groups: the optimistic bound (8192) overflows,
    the ladder doubles once, and a second call at the same shape
    dispatches once."""
    calls = []
    inner = tgroupby._groupby_compiled

    def counting(*args, **kw):
        calls.append(kw["out_cap"])
        return inner(*args, **kw)

    monkeypatch.setattr(tgroupby, "_groupby_compiled", counting)
    monkeypatch.setattr(tgroupby, "_EAGER_SCALE_MEMO", {})
    rng = np.random.default_rng(6)
    k = rng.permutation(20000) % 15000
    tt = Table.from_pydict({"k": k, "v": np.ones(20000)}, device="cpu")
    got = groupby_aggregate(tt, ["k"], [("v", "sum")])
    assert got.num_rows == 15000 and calls == [8192, 16384]
    np.testing.assert_array_equal(got.to_pandas()["v_sum"].to_numpy(),
                                  np.bincount(k)[:15000].astype(float))
    calls.clear()
    assert groupby_aggregate(tt, ["k"], [("v", "sum")]).num_rows == 15000
    assert calls == [16384]


# ------------------------------------------------------------ dist_groupby
def _shard_frame(jt, s):
    """JAX distributed table shard s as a DataFrame."""
    counts = np.asarray(jt.nrows).reshape(-1)
    cap_l = jt.capacity // counts.shape[0]
    cols, dicts = {}, {}
    for n, c in jt.columns.items():
        lo = s * cap_l
        cols[n] = (np.asarray(c.data)[lo:lo + cap_l],
                   None if c.validity is None
                   else np.asarray(c.validity)[lo:lo + cap_l],
                   repr(c.dtype))
        if c.dictionary is not None:
            dicts[n] = c.dictionary.values
    return convert.from_arrays(cols, int(counts[s]), device="cpu",
                               dictionaries=dicts).to_pandas()


def _sorted(df, by):
    return df.sort_values(by, na_position="last").reset_index(drop=True)


_DIST = {
    "decomposable": [("v", "sum"), ("v", "mean"), ("v", "std"),
                     ("i", "min"), ("i", "max"), ("i", "count"),
                     ("v", "size"), ("v", "var")],
    "raw_rows": [("v", "median"), ("i", "nunique"), ("v", "first"),
                 ("i", "last"), ("v", "quantile"), ("v", "count")],
}


@pytest.mark.parametrize("path", list(_DIST))
def test_dist_groupby_w4_matches_jax(env4, path):
    """Each rank's groups equal the JAX shard's, by the tolerances
    above; the decomposable path moves pre-combined partials, the other
    raw rows."""
    df = _frame(np.random.default_rng(7))
    jt = jct.Table.from_pandas(df)
    aggs = _DIST[path]
    by = ["nk", "c"]
    want = jdist_groupby(env4, jscatter(env4, jt), by, aggs, quantile=Q)
    tt = to_port(jt)

    def rank(comm):
        env = CylonEnv(comm)
        return dist_groupby(env, scatter_table(env, tt), by, aggs,
                            quantile=Q).to_pandas()

    got = ThreadWorld(4).run(rank)
    for s in range(4):
        a, b = _sorted(got[s], by), _sorted(_shard_frame(want, s), by)
        assert list(a.columns) == list(b.columns)
        for name in a.columns:
            x, y = a[name].to_numpy(), b[name].to_numpy()
            if x.dtype == object or name.endswith(EXACT_OPS):
                np.testing.assert_array_equal(_nulls_as_tag(x),
                                              _nulls_as_tag(y), err_msg=name)
            else:
                np.testing.assert_allclose(x.astype(float), y.astype(float),
                                           rtol=RTOL, err_msg=name)


def test_dist_groupby_w4_empty_shard_and_skewed_key_regrow():
    """Rank 2 ingests no rows (capacity 0), and one key holds most rows,
    so its rank's receive buffer overflows the tight bucket and the
    regrow loop doubles it; both paths against pandas, and W = 1 on the
    same rows gives the same groups."""
    rng = np.random.default_rng(8)
    n = 400
    k = np.where(rng.random(n) < 0.8, 7, rng.integers(0, 30, n))
    df = pd.DataFrame({"k": k, "v": rng.normal(size=n)})
    parts = [df.iloc[:150], df.iloc[150:300], df.iloc[:0], df.iloc[300:]]
    aggs = [("v", "sum"), ("v", "mean"), ("v", "median"), ("v", "count")]
    want = df.groupby("k").agg(v_sum=("v", "sum"), v_mean=("v", "mean"),
                               v_median=("v", "median"),
                               v_count=("v", "count")).reset_index()

    def rank(comm):
        env = CylonEnv(comm)
        mine = Table.from_pandas(parts[env.rank], device="cpu")
        out = []
        for a in (aggs[:2] + aggs[3:], aggs):
            res = dist_groupby(env, mine, ["k"], a)
            out.append(gather_table(env, res).to_pandas())
        return out

    got = ThreadWorld(4).run(rank)[0]
    local = groupby_aggregate(Table.from_pandas(df, device="cpu"), ["k"],
                              aggs).to_pandas()
    for frame in got + [local]:
        frame = _sorted(frame, ["k"])
        for c in frame.columns:
            np.testing.assert_allclose(frame[c].to_numpy(float),
                                       want[c].to_numpy(float), rtol=RTOL,
                                       err_msg=c)
