"""Two-phase plans for the TPC-H queries whose answer embeds a global
scalar (``FALLBACK[q]["merge"] == "twophase"``).

Port of ``cylon_tpu/tpch/twophase.py``: the same plans and partial
algebra, with the per-partition phases on the device.

Six queries (q8/q11/q14/q15/q16/q22) cannot recombine from
per-partition runs of the UNCHANGED query fn: their output bakes in a
ratio of global sums (q8/q14), a threshold against a global total or
max (q11/q15), a global average (q22), or a COUNT(DISTINCT) (q16).
Each gets a hand-decomposed plan instead — the classic two-phase
aggregate:

* **phase 1** runs per partition over the SAME co-partitioned shards
  the generic executor builds, and emits an *associative partial*:
  sum/count pairs for ratios and averages, per-group sums for
  thresholds, per-partition distinct counts for q16 (exact because the
  executor hash-partitions partsupp BY ``ps_suppkey`` — the distinct
  key — so no supplier's rows span partitions and per-partition
  distinct sets are disjoint).
* **merge** combines all partials into the blocking global value (the
  promo ratio, the HAVING total, the max revenue, the balance average —
  or, for q8/q16, directly the final frame). The executor journals this
  result as its own checkpoint unit and counts
  ``ooc.merge_phases{query}``.
* **phase 2** (q11/q15/q22 only) re-runs the cheap apply per partition
  with the merged value broadcast in — a filter against the global
  threshold plus partition-local joins that are exact under the
  declared co-partitioning (q22's NOT EXISTS anti-join: orders are
  hash-split by ``o_custkey`` with customers by ``c_custkey``, so a
  customer's orders never land elsewhere).
* **reduce** concatenates phase-2 partials into the final host answer
  (or unwraps the merged frame when there is no phase 2).

Where it runs: the phases build each partition's frames on ``device``
(``None``: CUDA, as every entry point of the port) and filter, join and
group there with the port's ops and the in-core queries' own helpers
(:mod:`cylon_tpu_torch.tpch.queries`), so the numeric semantics are the
in-core query's. Only the partials come to the host: one row of sums,
or one row per group (per partkey for q11, per supplier for q15). The
merge, the q11 threshold filter of its own partial, and the reduce are
pandas over those partials. The JAX package runs the phases in pandas
too; the port does not (ROADMAP A7.2, deliberate differences). Resume
determinism: every phase fn is a pure function of its (durable)
inputs, partials round-trip through the spill store bit-exactly
(float64 ``.npz``), and merges iterate in partition order — so a
killed run re-merges to the identical bytes.
"""

import numpy as np
import pandas as pd
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.tpch import queries as _q
from cylon_tpu_torch.tpch.dbgen import date_int

__all__ = ["PLANS", "TwoPhasePlan"]


class TwoPhasePlan:
    """One query's decomposition: ``phase1(tables, device=, **params)``
    → associative partial frame; ``merge(partials, **params)`` → the
    journaled global frame; optional ``phase2(tables, partial1, merged,
    device=, **params)`` → apply-pass partial; ``reduce(merged,
    partials2, **params)`` → final host result. ``tables`` maps each
    input to a frame (a broadcast table, built once) or to host columns
    (the partition's slice, built here on ``device``). ``partials``
    lists align with partition index; empty partitions contribute
    ``None``."""

    __slots__ = ("phase1", "merge", "reduce", "phase2")

    def __init__(self, phase1, merge, reduce, phase2=None):
        self.phase1 = phase1
        self.merge = merge
        self.reduce = reduce
        self.phase2 = phase2


# ------------------------------------------------------------- helpers
def _load(t, names, device) -> list:
    """The partition's inputs as local frames on ``device`` (the TPC-H
    string storage of :func:`cylon_tpu_torch.tpch.ingest`)."""
    return [_q._df(t[n], device) for n in names]


def _host(df) -> pd.DataFrame:
    """A partial's frame on the host (index dropped)."""
    return df.to_pandas().reset_index(drop=True)


def _shipped_revenue(li, date_from, date_to, cols):
    """lineitem shipped in ``[date_from, date_to)`` with its revenue,
    projected to ``cols`` (q14's and q15's common head)."""
    sd = li.table.column("l_shipdate").data
    li = _q._filt(li, (sd >= date_from) & (sd < date_to))
    return _q._with_revenue(li)[cols]


def _coded_customers(customer, codes):
    """customer with its phone's country code, restricted to ``codes``
    (q22's SUBSTRING over the host dictionary, as the in-core query)."""
    code = customer.series("c_phone").map(lambda v: str(v)[:2])
    cust = _q._with(customer, "cntrycode", code.column)
    cust = _q._filt(cust, _q._dict_mask(cust.table.column("cntrycode"),
                                        list(codes)))
    return cust[["c_custkey", "c_acctbal", "cntrycode"]]


def _frames(partials):
    return [f for f in partials if f is not None and len(f)]


def _empty(schema: "dict[str, object]") -> pd.DataFrame:
    return pd.DataFrame({c: np.empty(0, d) for c, d in schema.items()})


def _passthrough(merged, _partials2, **_params):
    return merged


# ------------------------------------------------------------------ q14
def _q14_phase1(t, device=None, date_from=None, date_to=None):
    if date_from is None:
        date_from = date_int(1995, 9, 1)
    if date_to is None:
        date_to = date_int(1995, 10, 1)
    lineitem, part = _load(t, ["lineitem", "part"], device)
    li = _shipped_revenue(lineitem, date_from, date_to,
                          ["l_partkey", "revenue"])
    j = li.merge(part[["p_partkey", "p_type"]], left_on="l_partkey",
                 right_on="p_partkey", how="inner")
    tj = j.table
    promo = _q._dict_mask(tj.column("p_type"),
                          pred=lambda v: v is not None
                          and str(v).startswith("PROMO"))
    j = _q._with(j, "promo_rev", _q._where(promo, tj.column("revenue")))
    return pd.DataFrame({"promo_rev": [_q._agg_scalar(j, "promo_rev",
                                                      "sum")],
                         "total_rev": [_q._agg_scalar(j, "revenue",
                                                      "sum")]})


def _q14_merge(partials, **_params):
    fs = _frames(partials)
    promo = float(sum(float(f["promo_rev"].iloc[0]) for f in fs))
    total = float(sum(float(f["total_rev"].iloc[0]) for f in fs))
    # same zero-denominator guard as the in-core query
    value = 0.0 if total == 0 else 100.0 * promo / total
    return pd.DataFrame({"value": [value]})


def _q14_reduce(merged, _partials2, **_params):
    return float(merged["value"].iloc[0])


# ------------------------------------------------------------------- q8
def _q8_phase1(t, device=None, nation="BRAZIL", region="AMERICA",
               ptype="ECONOMY ANODIZED STEEL"):
    # the in-core q8 up to its group-by: the share's two sums per year
    (part, supplier, lineitem, orders, customer, nations, reg
     ) = _load(t, ["part", "supplier", "lineitem", "orders", "customer",
                   "nation", "region"], device)
    pf = _q._filt(part, _q._eq_str(part, "p_type", ptype))[["p_partkey"]]
    regk = _q._filt(reg, _q._eq_str(reg, "r_name", region))[
        ["r_regionkey"]]
    n1 = nations.merge(regk, left_on="n_regionkey",
                       right_on="r_regionkey", how="inner")[["n_nationkey"]]
    cust = customer[["c_custkey", "c_nationkey"]].merge(
        n1, left_on="c_nationkey", right_on="n_nationkey", how="inner")
    cust = cust[["c_custkey"]]
    n2 = nations[["n_nationkey", "n_name"]].rename(
        columns={"n_name": "supp_nation"})
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        n2, left_on="s_nationkey", right_on="n_nationkey", how="inner")
    sup = sup[["s_suppkey", "supp_nation"]]

    od = orders.table.column("o_orderdate").data
    ords = _q._filt(orders, (od >= date_int(1995, 1, 1))
                    & (od <= date_int(1996, 12, 31)))
    ords = ords[["o_orderkey", "o_custkey", "o_orderdate"]]
    ords = _q._with(ords, "o_year",
                    _q._year(ords.table.column("o_orderdate").data))
    ords = ords[["o_orderkey", "o_custkey", "o_year"]]

    li = _q._with_revenue(lineitem)[["l_partkey", "l_suppkey",
                                     "l_orderkey", "revenue"]]
    j = li.merge(pf, left_on="l_partkey", right_on="p_partkey",
                 how="inner")
    j = j.merge(ords, left_on="l_orderkey", right_on="o_orderkey",
                how="inner")
    j = j.merge(cust, left_on="o_custkey", right_on="c_custkey",
                how="inner")
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey",
                how="inner")
    tj = j.table
    is_nat = _q._dict_mask(tj.column("supp_nation"), [nation])
    j = _q._with(j, "nation_rev", _q._where(is_nat, tj.column("revenue")))
    return _host(j.groupby(["o_year"]).agg([
        ("revenue", "sum", "total"),
        ("nation_rev", "sum", "nation_total"),
    ]))


def _q8_merge(partials, **_params):
    fs = _frames(partials)
    if not fs:
        return _empty({"o_year": np.int32, "mkt_share": np.float64})
    df = pd.concat(fs, ignore_index=True)
    g = df.groupby("o_year", as_index=False, sort=False).agg(
        total=("total", "sum"), nation_total=("nation_total", "sum"))
    g["mkt_share"] = g["nation_total"] / g["total"]
    return g.sort_values("o_year", kind="stable", ignore_index=True)[
        ["o_year", "mkt_share"]]


# ------------------------------------------------------------------ q11
def _q11_phase1(t, device=None, nation="GERMANY", fraction=0.0001):
    partsupp, supplier, nations = _load(
        t, ["partsupp", "supplier", "nation"], device)
    natk = _q._filt(nations, _q._eq_str(nations, "n_name", nation))[
        ["n_nationkey"]]
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        natk, left_on="s_nationkey", right_on="n_nationkey", how="inner")
    tp = partsupp.table
    value = tp.column("ps_supplycost").data * tp.column("ps_availqty").data
    ps = _q._with(partsupp, "value", Column(value, None,
                                              dtypes.float64))
    j = ps[["ps_partkey", "ps_suppkey", "value"]].merge(
        sup[["s_suppkey"]], left_on="ps_suppkey", right_on="s_suppkey",
        how="inner")
    return _host(j.groupby(["ps_partkey"]).agg([("value", "sum",
                                                  "value")]))


def _q11_merge(partials, **_params):
    total = float(sum(float(f["value"].sum()) for f in _frames(partials)))
    return pd.DataFrame({"total": [total]})


def _q11_phase2(t, partial1, merged, device=None, nation="GERMANY",
                fraction=0.0001):
    # the partial IS the partition's grouped result: its HAVING is a
    # filter of the host partial, with no input table read again
    total = float(merged["total"].iloc[0])
    keep = partial1["value"].to_numpy() > (fraction * total)
    return partial1[keep].reset_index(drop=True)


def _q11_reduce(merged, partials2, **_params):
    fs = _frames(partials2)
    if not fs:
        return _empty({"ps_partkey": np.int64, "value": np.float64})
    df = pd.concat(fs, ignore_index=True)
    return df.sort_values("value", ascending=False, kind="stable",
                          ignore_index=True)[["ps_partkey", "value"]]


# ------------------------------------------------------------------ q15
def _q15_phase1(t, device=None, date_from=None, date_to=None):
    if date_from is None:
        date_from = date_int(1996, 1, 1)
    if date_to is None:
        date_to = date_int(1996, 4, 1)
    (lineitem,) = _load(t, ["lineitem"], device)
    li = _shipped_revenue(lineitem, date_from, date_to,
                          ["l_suppkey", "revenue"])
    return _host(li.groupby(["l_suppkey"]).agg(
        [("revenue", "sum", "total_revenue")]))


def _q15_merge(partials, **_params):
    vals = [float(f["total_revenue"].max()) for f in _frames(partials)]
    # empty view -> NaN threshold -> every >= comparison is False ->
    # empty result, matching the in-core empty-grouped semantics
    mx = max(vals) if vals else float("nan")
    return pd.DataFrame({"max_revenue": [mx]})


def _q15_phase2(t, partial1, merged, device=None, date_from=None,
                date_to=None):
    mx = float(merged["max_revenue"].iloc[0])
    top = partial1[partial1["total_revenue"].to_numpy() >= mx]
    if not len(top):
        # the max lies in another partition: nothing here to join
        return _empty({"s_suppkey": np.int64, "s_name": object,
                       "total_revenue": np.float64})
    (supplier,) = _load(t, ["supplier"], device)
    topf = _q._df({c: top[c].to_numpy() for c in top.columns}, device)
    out = topf.merge(supplier[["s_suppkey", "s_name"]],
                     left_on="l_suppkey", right_on="s_suppkey",
                     how="inner")
    return _host(out[["s_suppkey", "s_name", "total_revenue"]])


def _q15_reduce(merged, partials2, **_params):
    fs = _frames(partials2)
    if not fs:
        return _empty({"s_suppkey": np.int64, "s_name": object,
                       "total_revenue": np.float64})
    df = pd.concat(fs, ignore_index=True)
    return df.sort_values("s_suppkey", kind="stable",
                          ignore_index=True)[
        ["s_suppkey", "s_name", "total_revenue"]]


# ------------------------------------------------------------------ q16
def _q16_phase1(t, device=None, brand="Brand#45",
                type_prefix="MEDIUM POLISHED",
                sizes=(49, 14, 23, 45, 19, 3, 36, 9)):
    part, partsupp, supplier = _load(
        t, ["part", "partsupp", "supplier"], device)
    # good suppliers of THIS partition: supplier is co-partitioned with
    # partsupp by suppkey, so the NOT IN semi-join is partition-local
    good = _q._filt(supplier, ~_q._like_seq(
        supplier.table.column("s_comment"), "Customer", "Complaints"))
    tp = part.table
    sizes_arr = from_host(np.asarray(sizes, np.int64), tp.device)
    pmask = (~_q._dict_mask(tp.column("p_brand"), [brand])
             & ~_q._dict_mask(tp.column("p_type"),
                              pred=lambda v: v is not None
                              and str(v).startswith(type_prefix))
             & (tp.column("p_size").data[:, None]
                == sizes_arr[None, :]).any(dim=1))
    pf = _q._filt(part, pmask)[["p_partkey", "p_brand", "p_type",
                                "p_size"]]
    j = partsupp[["ps_partkey", "ps_suppkey"]].merge(
        pf, left_on="ps_partkey", right_on="p_partkey", how="inner")
    j = j.merge(good[["s_suppkey"]], left_on="ps_suppkey",
                right_on="s_suppkey", how="inner")
    # distinct suppliers per group, counted HERE: partitions split by
    # suppkey, so per-partition distinct sets are disjoint and the
    # merge may SUM them — the exactness this plan partitions for
    return _host(j.groupby(["p_brand", "p_type", "p_size"]).agg(
        [("ps_suppkey", "nunique", "supplier_cnt")]))


def _q16_merge(partials, **_params):
    fs = _frames(partials)
    if not fs:
        return _empty({"p_brand": object, "p_type": object,
                       "p_size": np.int64, "supplier_cnt": np.int64})
    df = pd.concat(fs, ignore_index=True)
    g = df.groupby(["p_brand", "p_type", "p_size"], as_index=False,
                   sort=False).agg(supplier_cnt=("supplier_cnt", "sum"))
    return g.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"],
        ascending=[False, True, True, True], kind="stable",
        ignore_index=True)[
        ["p_brand", "p_type", "p_size", "supplier_cnt"]]


# ------------------------------------------------------------------ q22
_Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def _q22_phase1(t, device=None, codes=_Q22_CODES):
    (customer,) = _load(t, ["customer"], device)
    cust = _coded_customers(customer, codes)
    pos = _q._filt(cust, cust.table.column("c_acctbal").data > 0.0)
    return pd.DataFrame({
        "bal_sum": [_q._agg_scalar(pos, "c_acctbal", "sum")],
        "bal_cnt": [int(_q._agg_scalar(pos, "c_acctbal", "count"))]})


def _q22_merge(partials, **_params):
    fs = _frames(partials)
    s = float(sum(float(f["bal_sum"].iloc[0]) for f in fs))
    c = int(sum(int(f["bal_cnt"].iloc[0]) for f in fs))
    # no positive-balance customers -> NaN average -> every > avg
    # comparison False -> empty result, same as the in-core mean
    avg = (s / c) if c else float("nan")
    return pd.DataFrame({"avg_bal": [avg]})


def _q22_phase2(t, partial1, merged, device=None, codes=_Q22_CODES):
    avg = float(merged["avg_bal"].iloc[0])
    customer, orders = _load(t, ["customer", "orders"], device)
    cust = _coded_customers(customer, codes)
    cand = _q._filt(cust, cust.table.column("c_acctbal").data > avg)
    # NOT EXISTS anti-join is partition-local: orders co-partitioned
    # by o_custkey with customers by c_custkey (a left join on the
    # distinct order custkeys, then the null filter, as in core)
    active = orders[["o_custkey"]].drop_duplicates(["o_custkey"])
    j = cand.merge(active, left_on="c_custkey", right_on="o_custkey",
                   how="left")
    nul = j.table.column("o_custkey")
    no_orders = (torch.zeros(j.table.capacity, dtype=torch.bool,
                             device=j.table.device)
                 if nul.validity is None else ~nul.validity)
    idle = _q._filt(j, no_orders)
    return _host(idle.groupby(["cntrycode"]).agg([
        ("c_custkey", "count", "numcust"),
        ("c_acctbal", "sum", "totacctbal"),
    ]))


def _q22_reduce(merged, partials2, **_params):
    fs = _frames(partials2)
    if not fs:
        return _empty({"cntrycode": object, "numcust": np.int64,
                       "totacctbal": np.float64})
    df = pd.concat(fs, ignore_index=True)
    g = df.groupby("cntrycode", as_index=False, sort=False).agg(
        numcust=("numcust", "sum"), totacctbal=("totacctbal", "sum"))
    return g.sort_values("cntrycode", kind="stable", ignore_index=True)[
        ["cntrycode", "numcust", "totacctbal"]]


PLANS: "dict[str, TwoPhasePlan]" = {
    "q8": TwoPhasePlan(_q8_phase1, _q8_merge, _passthrough),
    "q11": TwoPhasePlan(_q11_phase1, _q11_merge, _q11_reduce,
                        phase2=_q11_phase2),
    "q14": TwoPhasePlan(_q14_phase1, _q14_merge, _q14_reduce),
    "q15": TwoPhasePlan(_q15_phase1, _q15_merge, _q15_reduce,
                        phase2=_q15_phase2),
    "q16": TwoPhasePlan(_q16_phase1, _q16_merge, _passthrough),
    "q22": TwoPhasePlan(_q22_phase1, _q22_merge, _q22_reduce,
                        phase2=_q22_phase2),
}
