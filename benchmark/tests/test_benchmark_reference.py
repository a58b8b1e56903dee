"""Each reference against pandas at a tiny scale, on the same inputs."""

import numpy as np
import pandas as pd
import pytest
import torch

from benchmark.data import join as join_data
from benchmark.data import tpch as tpch_data
from benchmark.harness import cell as cells
from benchmark.kinds.tpch import _params

JOIN = cells.load_module(cells.BENCH_DIR / "reference" / "join_16m.py")
TPCH = cells.load_module(cells.BENCH_DIR / "reference" / "tpch_sf10.py")


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_join_reference_is_pandas_merge(seed):
    config = {"rows_per_side": 3000, "value_columns": 1,
              "key": {"distribution": "uniform", "domain": 2000}}
    raw = join_data.tables(config, seed, "cpu")
    got = JOIN.join(raw["left"], raw["right"])
    frame = lambda side: pd.DataFrame(  # noqa: E731
        {"k": raw[side][0].numpy(), "v": raw[side][1][0].numpy()})
    want = frame("left").merge(frame("right"), on="k", how="inner")
    as_dict = {"k": torch.from_numpy(want["k"].to_numpy().copy()),
               "left": [torch.from_numpy(want["v_x"].to_numpy().copy())],
               "right": [torch.from_numpy(want["v_y"].to_numpy().copy())]}
    assert len(want) > 1000
    assert JOIN.compare(got, as_dict) == {"rows_off": 0}


def test_join_compare_counts_differences():
    raw = join_data.tables({"rows_per_side": 500, "value_columns": 1,
                            "key": {"distribution": "uniform",
                                    "domain": 500}}, 3, "cpu")
    want = JOIN.join(raw["left"], raw["right"])
    n = want["k"].shape[0]
    bad = {"k": want["k"], "left": [want["left"][0].clone()],
           "right": want["right"]}
    bad["left"][0][7] += 1.0
    assert JOIN.compare(bad, want) == {"rows_off": 1}
    half = {"k": want["k"][: n // 2], "left": [want["left"][0][: n // 2]],
            "right": [want["right"][0][: n // 2]]}
    assert JOIN.compare(half, want)["rows_off"] >= n - n // 2


def frames(raw):
    out = {}
    for t, cols in raw.items():
        df = pd.DataFrame({c: v.numpy() for c, v in cols.items()})
        for c, values in tpch_data.DICTS.items():
            if c in df:
                df[c] = np.array(values, dtype=object)[df[c].to_numpy()]
        out[t] = df
    return out


def q3_pandas(f, segment, cutoff, limit):
    c = f["customer"][f["customer"].c_mktsegment == segment]
    o = f["orders"][f["orders"].o_orderdate < cutoff]
    li = f["lineitem"][f["lineitem"].l_shipdate > cutoff].copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    j = li.merge(o.merge(c, left_on="o_custkey", right_on="c_custkey"),
                 left_on="l_orderkey", right_on="o_orderkey")
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False)["revenue"].sum()
    g = g.sort_values(["revenue", "o_orderdate"], ascending=[False, True],
                      kind="stable").head(limit)
    return {k: g[k].to_numpy() for k in g}


def q5_pandas(f, region, date_from, date_to):
    r = f["region"][f["region"].r_name == region]
    n = f["nation"].merge(r, left_on="n_regionkey", right_on="r_regionkey")
    s = f["supplier"].merge(n, left_on="s_nationkey",
                            right_on="n_nationkey")
    o = f["orders"][(f["orders"].o_orderdate >= date_from)
                    & (f["orders"].o_orderdate < date_to)]
    li = f["lineitem"].copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    j = li.merge(o.merge(f["customer"], left_on="o_custkey",
                         right_on="c_custkey"),
                 left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(s, left_on=["l_suppkey", "c_nationkey"],
                right_on=["s_suppkey", "s_nationkey"])
    g = j.groupby("n_name", as_index=False)["revenue"].sum()
    g = g.sort_values("revenue", ascending=False, kind="stable")
    return {"n_name": g.n_name.tolist(), "revenue": g.revenue.to_numpy()}


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
@pytest.mark.parametrize("batch", ["a", "b"])
def test_tpch_reference_is_pandas(seed, batch):
    c = cells.resolve("tpch_sf10.eager", False)
    config = dict(c.config, scale_factor=0.02)
    raw = tpch_data.generate(config, seed, "cpu")
    if batch == "b":
        raw = tpch_data.permuted(raw, tpch_data.permutations(raw, seed,
                                                             "cpu"))
    params = {q: _params(p) for q, p in c.traffic["params"].items()}
    f = frames(raw)
    for q, pandas_q in (("q3", q3_pandas), ("q5", q5_pandas)):
        got = TPCH.answer(q, raw, tpch_data.DICTS, params[q])
        want = pandas_q(f, **params[q])
        assert len(want["revenue"]) > 0
        numbers = TPCH.compare(q, got, want)
        assert numbers["rows_off"] == 0, (q, got, want)
        assert numbers["revenue_gap"] < 1e-12


def test_tpch_compare_counts_differences():
    want = {"n_name": ["INDIA", "CHINA"], "revenue": np.array([2.0, 1.0])}
    got = {"n_name": ["INDIA", "JAPAN"], "revenue": np.array([2.0 + 2e-9,
                                                             1.0])}
    assert TPCH.compare("q5", got, want) == {"rows_off": 1,
                                             "revenue_gap": pytest.approx(
                                                 1e-9)}
    short = {"n_name": ["INDIA"], "revenue": np.array([2.0])}
    assert TPCH.compare("q5", short, want)["rows_off"] == 1


def test_generator_is_the_seeds_alone():
    c = cells.resolve("tpch_sf10.eager", False)
    config = dict(c.config, scale_factor=0.01)
    a = tpch_data.generate(config, 2**31 + 3, "cpu")
    b = tpch_data.generate(config, 2**31 + 3, "cpu")
    other = tpch_data.generate(config, 2**31 + 4, "cpu")
    for t in a:
        for col in a[t]:
            assert torch.equal(a[t][col], b[t][col])
    assert not torch.equal(a["lineitem"]["l_extendedprice"][:100],
                           other["lineitem"]["l_extendedprice"][:100])
    keep = {c for q in config["columns_read"].values()
            for cols in q.values() for c in cols}
    assert {c for t in a.values() for c in t} == keep
