"""TPC-H in the port (``cylon_tpu_torch.tpch``) against the JAX package
and pandas on the CPU: the generator bit for bit, the manifest, all 22
queries on one device against the pandas oracles of ``test_tpch`` (with
the small-scale parameters those tests pass), q1, q3, q5 and q6 against
the JAX package's eager queries, projection pushdown and the device-bytes
comment columns."""

import re

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import tpch
from cylon_tpu_torch.table import Table
from cylon_tpu_torch.tpch import queries as Q
from cylon_tpu_torch.tpch.manifest import MANIFEST
from test_tpch import (SEED, SF, _assert_q3_equal, _frame_close, q2_pandas,
                       q3_pandas, q4_pandas, q5_pandas, q7_pandas,
                       q8_pandas, q9_pandas, q10_pandas, q11_pandas,
                       q12_pandas, q13_pandas, q14_pandas, q15_pandas,
                       q16_pandas, q17_pandas, q18_pandas, q19_pandas,
                       q20_pandas, q21_pandas, q22_pandas)

QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF, SEED)


@pytest.fixture(scope="module")
def pdfs():
    return tpch.generate_pandas(SF, SEED)


@pytest.fixture(scope="module")
def frames(data):
    return tpch.ingest(data, device="cpu")


def _assert_same_arrays(a: dict, b: dict):
    assert list(a) == list(b)
    for t in a:
        assert list(a[t]) == list(b[t]), t
        for c in a[t]:
            x, y = a[t][c], b[t][c]
            assert x.dtype == y.dtype, (t, c)
            assert x.shape == y.shape, (t, c)
            assert np.array_equal(x, y), (t, c)


def _manifest_keep() -> dict:
    keep = {}
    for entry in MANIFEST.values():
        for t, cols in entry.items():
            keep.setdefault(t, set()).update(cols)
    return keep


@pytest.mark.parametrize("keep", [None, "manifest", "q3"])
def test_generate_equals_the_jax_generator(keep):
    from cylon_tpu.tpch import dbgen as jdbgen

    ks = {None: None, "manifest": _manifest_keep(),
          "q3": {t: set(c) for t, c in MANIFEST["q3"].items()}}[keep]
    _assert_same_arrays(tpch.generate(SF, SEED, keep=ks),
                        jdbgen.generate(SF, SEED, keep=ks))


def test_generate_pandas_equals_the_jax_generator():
    from cylon_tpu.tpch import dbgen as jdbgen

    got, want = tpch.generate_pandas(0.001, 5), jdbgen.generate_pandas(0.001, 5)
    assert list(got) == list(want)
    for t in want:
        pd.testing.assert_frame_equal(got[t], want[t])
    assert tpch.date_int(1995, 3, 15) == jdbgen.date_int(1995, 3, 15)


def test_manifest_equals_the_jax_manifest():
    from cylon_tpu.tpch.manifest import MANIFEST as JMANIFEST

    assert MANIFEST == JMANIFEST
    assert sorted(MANIFEST) == sorted(QUERIES)


# ------------------------------------------------------------- the oracles
def q1_pandas(pdfs, cutoff=None):
    if cutoff is None:
        cutoff = tpch.date_int(1998, 9, 2)
    li = pdfs["lineitem"]
    li = li[li["l_shipdate"] <= cutoff].copy()
    li["disc_price"] = li["l_extendedprice"] * (1 - li["l_discount"])
    li["charge"] = li["disc_price"] * (1 + li["l_tax"])
    return li.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "count"),
    ).reset_index().sort_values(
        ["l_returnflag", "l_linestatus"]).reset_index(drop=True)


Q1_FLOATS = {"sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
             "avg_price", "avg_disc"}


def q6_pandas(pdfs):
    li = pdfs["lineitem"]
    m = ((li["l_shipdate"] >= tpch.date_int(1994, 1, 1))
         & (li["l_shipdate"] < tpch.date_int(1995, 1, 1))
         & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
         & (li["l_quantity"] < 24))
    return float((li[m]["l_extendedprice"] * li[m]["l_discount"]).sum())


def _q16_norm(df):
    return df.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                          ascending=[False, True, True, True]
                          ).reset_index(drop=True)


def case(qn, pdfs, data):
    """``(kwargs, trimmed data or None, oracle result, check(got, want))``
    for one query, with the parameters ``test_tpch`` passes at this
    scale."""
    part = pdfs["part"]
    frame = _frame_close
    if qn == "q1":
        return {}, None, q1_pandas(pdfs), \
            lambda g, w: frame(g, w, Q1_FLOATS)
    if qn == "q2":
        kw = {"size": int(part.p_size.iloc[0]), "type_suffix": ""}
        return kw, None, q2_pandas(pdfs, **kw), \
            lambda g, w: frame(g, w, {"s_acctbal"})
    if qn == "q3":
        return {}, None, q3_pandas(pdfs), _assert_q3_equal
    if qn == "q4":
        return {}, None, q4_pandas(pdfs), lambda g, w: frame(g, w, set())
    if qn == "q5":
        return {}, None, q5_pandas(pdfs), \
            lambda g, w: frame(g, w, {"revenue"})
    if qn == "q6":
        return {}, None, q6_pandas(pdfs), \
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-9)
    if qn == "q7":
        return {}, None, q7_pandas(pdfs), \
            lambda g, w: frame(g, w, {"revenue"})
    if qn == "q8":
        kw = {"ptype": part.p_type.mode()[0]}
        return kw, None, q8_pandas(pdfs, **kw), \
            lambda g, w: frame(g, w, {"mkt_share"})
    if qn == "q9":
        return {}, None, q9_pandas(pdfs), \
            lambda g, w: frame(g, w, {"profit"})
    if qn == "q10":
        return {}, None, q10_pandas(pdfs), \
            lambda g, w: frame(g, w, {"revenue", "c_acctbal"})
    if qn == "q11":
        def check11(g, w):
            # ties in value may permute partkeys
            assert len(g) == len(w)
            np.testing.assert_allclose(np.sort(g.value.to_numpy()),
                                       np.sort(w.value.to_numpy()),
                                       rtol=1e-9)
            assert sorted(g.ps_partkey) == sorted(w.ps_partkey)
        return {"fraction": 0.001}, None, \
            q11_pandas(pdfs, fraction=0.001), check11
    if qn == "q12":
        return {}, None, q12_pandas(pdfs), lambda g, w: frame(g, w, set())
    if qn == "q13":
        return {}, None, q13_pandas(pdfs), lambda g, w: frame(g, w, set())
    if qn == "q14":
        return {}, None, q14_pandas(pdfs), \
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-9)
    if qn == "q15":
        return {}, None, q15_pandas(pdfs), \
            lambda g, w: frame(g, w, {"total_revenue"})
    if qn == "q16":
        kw = {"sizes": tuple(int(x) for x in
                             part.p_size.drop_duplicates().head(8))}

        def check16(g, w):
            g, w = _q16_norm(g), _q16_norm(w)
            assert g.supplier_cnt.tolist() == w.supplier_cnt.tolist()
            # ties among equal counts may permute: compare as row sets
            assert (set(map(tuple, g.itertuples(index=False)))
                    == set(map(tuple, w.itertuples(index=False))))
        return kw, None, q16_pandas(pdfs, **kw), check16
    if qn == "q17":
        kw = {"brand": part.p_brand.mode()[0],
              "container": part.p_container.iloc[0]}
        return kw, None, q17_pandas(pdfs, **kw), \
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-9)
    if qn == "q18":
        return {"threshold": 150}, None, q18_pandas(pdfs, threshold=150), \
            lambda g, w: frame(g, w, {"o_totalprice", "sum_qty"})
    if qn == "q19":
        return {}, None, q19_pandas(pdfs), \
            lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-9)
    if qn == "q20":
        kw = {"color": part.p_name.str.split().str[0].mode()[0]}
        return kw, None, q20_pandas(pdfs, **kw), \
            lambda g, w: frame(g, w, set())
    if qn == "q21":
        nk = pdfs["supplier"].s_nationkey.mode()[0]
        kw = {"nation": pdfs["nation"].set_index("n_nationkey").n_name[nk]}
        return kw, None, q21_pandas(pdfs, **kw), \
            lambda g, w: frame(g, w, set())
    assert qn == "q22"
    # every customer has orders at this scale: keep 5 % of the orders so
    # that idle customers exist
    n_keep = max(len(pdfs["orders"]) // 20, 1)
    pdfs2 = dict(pdfs, orders=pdfs["orders"].head(n_keep))
    data2 = dict(data, orders={k: v[:n_keep]
                               for k, v in data["orders"].items()})
    kw = {"codes": tuple(sorted(pdfs["customer"].c_phone.str[:2].unique()))}
    return kw, data2, q22_pandas(pdfs2, **kw), \
        lambda g, w: frame(g, w, {"totacctbal"})


def result(out):
    """A query's result on the host: a pandas frame, or the float."""
    if hasattr(out, "to_pandas"):
        return out.to_pandas()
    assert isinstance(out, float), type(out)
    return out


@pytest.mark.parametrize("qn", QUERIES)
def test_query_local_matches_pandas(qn, data, pdfs, frames):
    kw, data2, want, check = case(qn, pdfs, data)
    if isinstance(want, pd.DataFrame):
        assert len(want) > 0, qn   # the parameters keep rows
    inputs = frames if data2 is None else tpch.ingest(data2, device="cpu")
    check(result(getattr(tpch, qn)(inputs, **kw)), want)


@pytest.mark.parametrize("qn", ["q1", "q3", "q5", "q6"])
def test_query_matches_the_jax_query(qn, data, frames):
    from cylon_tpu import tpch as jtpch

    got = result(getattr(tpch, qn)(frames))
    want = getattr(jtpch, qn)(data)
    if qn == "q6":
        np.testing.assert_allclose(got, float(want), rtol=1e-9)
        return
    want = want.to_pandas()
    floats = {c for c in want.columns if want[c].dtype.kind == "f"}
    if qn == "q3":
        _assert_q3_equal(got, want)
    else:
        _frame_close(got, want, floats)
    assert list(got.columns) == list(want.columns)


def test_q19_handcrafted():
    """Rows built to hit each OR-branch of Q19 and to miss on every leg
    (``test_tpch.test_q19_handcrafted``'s tables)."""
    part = {
        "p_partkey": np.arange(1, 9, dtype=np.int64),
        "p_brand": np.array(["Brand#12", "Brand#23", "Brand#34", "Brand#12",
                             "Brand#55", "Brand#12", "Brand#23", "Brand#34"],
                            dtype=object),
        "p_container": np.array(["SM CASE", "MED BAG", "LG PKG", "JUMBO BOX",
                                 "SM CASE", "SM BOX", "MED PKG", "LG CASE"],
                                dtype=object),
        "p_size": np.array([3, 7, 12, 2, 4, 50, 9, 1], dtype=np.int64),
    }
    n = 10
    lineitem = {
        "l_partkey": np.array([1, 2, 3, 4, 5, 6, 7, 8, 1, 2], dtype=np.int64),
        "l_quantity": np.array([5, 15, 25, 5, 5, 5, 15, 25, 40, 15],
                               dtype=np.int64),
        "l_extendedprice": np.full(n, 100.0),
        "l_discount": np.zeros(n),
        "l_shipmode": np.array(["AIR", "REG AIR", "AIR", "AIR", "AIR",
                                "AIR", "REG AIR", "AIR", "AIR", "TRUCK"],
                               dtype=object),
        "l_shipinstruct": np.array(
            ["DELIVER IN PERSON"] * 9 + ["COLLECT COD"], dtype=object),
    }
    raw = {"part": part, "lineitem": lineitem}
    want = q19_pandas({k: pd.DataFrame(v) for k, v in raw.items()})
    assert want == 500.0
    assert tpch.q19(tpch.ingest(raw, device="cpu")) == want
    with pytest.raises(Exception):
        tpch.q19(tpch.ingest(raw, device="cpu"), brands=("Brand#12",))


# -------------------------------------------------- strings and projection
def test_comment_columns_are_device_bytes(data):
    """The near-unique text columns ingest as device bytes (no host
    dictionary); the rest of the strings as dictionary codes."""
    for tname, cname in [("orders", "o_comment"), ("supplier", "s_comment"),
                         ("lineitem", "l_comment")]:
        col = Q._df(data[tname], device="cpu").table.column(cname)
        assert col.dtype.is_bytes, (tname, cname, col.dtype)
        assert col.dictionary is None
        assert col.data.dim() == 2 and str(col.data.dtype) == "torch.int32"
    col = Q._df(data["orders"], device="cpu").table.column("o_orderpriority")
    assert col.dtype.is_dictionary
    o = data["orders"]["o_comment"]
    assert len(set(o)) > 0.5 * len(o)


@pytest.mark.parametrize("table,col,w1,w2,sf", [
    ("orders", "o_comment", "special", "requests", SF),
    ("orders", "o_comment", "requests", "special", SF),
    # 1 % of suppliers carry the phrase: 500 suppliers, not SF's 20
    ("supplier", "s_comment", "Customer", "Complaints", 0.05)])
def test_like_seq_on_comment_bytes_matches_the_regex(table, col, w1, w2,
                                                     sf):
    """Q13's and Q16's ``LIKE '%w1%w2%'`` on the device-bytes comment
    columns against Python's regex over the same strings."""
    raw = tpch.generate(sf, SEED, keep={table: {col}})[table]
    t = Q._df(raw, device="cpu").table
    vals = raw[col]
    got = Q._like_seq(t.column(col), w1, w2)[:len(vals)].numpy()
    rx = re.compile(f".*{w1}.*{w2}.*")
    want = np.array([rx.match(v) is not None for v in vals])
    assert want.any()
    assert np.array_equal(got, want)


def test_projection_pushdown_covers_actual_access(frames):
    """Every column a query reads while it runs (each ``Table.column``
    access) survives the string-constant inference's pruning
    (``test_tpch.test_projection_pushdown_covers_actual_access``)."""
    input_cols = {n: set(d.table.column_names) for n, d in frames.items()}
    accessed: set = set()
    orig = Table.column

    def spy(self, name):
        accessed.add(name)
        return orig(self, name)

    for qn in QUERIES:
        fn = getattr(Q, qn)
        accessed.clear()
        Table.column = spy
        try:
            fn(frames)
        finally:
            Table.column = orig
        strings = Q._query_strings(fn.__code__, fn.__globals__)
        for tname, cols in input_cols.items():
            keep = set(Q.keep_columns(tname, sorted(cols), strings))
            missing = (accessed & cols) - keep
            assert not missing, (qn, tname, sorted(missing))


def test_inferred_pruning_matches_manifest(data):
    """The inference equals the manifest for every query and table, and
    each query loads exactly the tables its manifest entry names
    (``test_tpch.test_inferred_pruning_matches_manifest``)."""
    import ast
    import inspect

    cols = {name: sorted(tbl) for name, tbl in data.items()}
    tree = ast.parse(inspect.getsource(Q))
    loads = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in MANIFEST:
            for call in ast.walk(node):
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id == "_tables"):
                    loads[node.name] = sorted(
                        ast.literal_eval(e) for e in call.args[1].elts)
    for qn, entry in MANIFEST.items():
        assert loads.get(qn) == sorted(entry), qn
        fn = getattr(Q, qn)
        strings = Q._query_strings(fn.__code__, fn.__globals__)
        for tname, declared in entry.items():
            inferred = set(Q.keep_columns(tname, cols[tname], strings))
            assert inferred == set(declared), (qn, tname)


def test_raw_mapping_builds_on_the_default_device(data, monkeypatch):
    """A query given a raw mapping and no env builds on CUDA, the default
    device, and never quietly on the CPU."""
    import torch

    from cylon_tpu_torch.errors import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        tpch.q6(data)
    with pytest.raises(DeviceUnavailable):
        tpch.ingest(data)
