"""Plain PyTorch reference of the ``tpch_sf10`` configuration: TPC-H Q3
and Q5 (specification clauses 2.4.3 and 2.4.5) over the raw columns.

Every join here is on a dense integer key (TPC-H keys are 1..n), so each
one is a lookup table indexed by the key; each group-by is a scatter-add.
String columns arrive as codes into sorted dictionaries (``dicts``).
Revenue is computed in ``dtype`` (float64 as the configuration states;
float32 is the control). Imports torch alone.
"""

import torch


def _by_key(keys, values, size, fill=0):
    """A lookup table: ``out[keys[i]] = values[i]``, ``fill`` elsewhere."""
    out = torch.full((size,), fill, dtype=values.dtype, device=keys.device)
    out[keys] = values
    return out


def _revenue(li, mask, dtype):
    price = li["l_extendedprice"][mask].to(dtype)
    return price * (1 - li["l_discount"][mask].to(dtype))


def q3(t: dict, dicts: dict, segment: str, cutoff: int, limit: int,
       dtype=torch.float64) -> dict:
    """Shipping priority: the ``limit`` unshipped orders of ``segment``
    with the most revenue, by revenue descending, then order date."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    seg = dicts["c_mktsegment"].index(segment)
    ncust = int(c["c_custkey"].max()) + 1
    nord = int(o["o_orderkey"].max()) + 1
    in_segment = _by_key(c["c_custkey"], c["c_mktsegment"] == seg, ncust,
                         False)
    order_ok = (o["o_orderdate"] < cutoff) & in_segment[o["o_custkey"]]
    ok = _by_key(o["o_orderkey"], order_ok, nord, False)
    date = _by_key(o["o_orderkey"], o["o_orderdate"], nord)
    prio = _by_key(o["o_orderkey"], o["o_shippriority"], nord)
    mask = (li["l_shipdate"] > cutoff) & ok[li["l_orderkey"]]
    keys, inverse = torch.unique(li["l_orderkey"][mask],
                                 return_inverse=True)
    revenue = torch.zeros(keys.shape[0], dtype=dtype, device=keys.device)
    revenue.index_add_(0, inverse, _revenue(li, mask, dtype))
    dates = date[keys]
    order = torch.argsort(dates, stable=True)
    order = order[torch.argsort(revenue[order], descending=True,
                                stable=True)][:limit]
    return {"l_orderkey": keys[order].cpu().numpy(),
            "revenue": revenue[order].double().cpu().numpy(),
            "o_orderdate": dates[order].cpu().numpy(),
            "o_shippriority": prio[keys[order]].cpu().numpy()}


def q5(t: dict, dicts: dict, region: str, date_from: int, date_to: int,
       dtype=torch.float64) -> dict:
    """Local supplier volume: revenue by nation of ``region`` from items
    whose customer and supplier share that nation, in orders of
    ``[date_from, date_to)``, by revenue descending."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    reg = dicts["r_name"].index(region)
    in_region = torch.isin(n["n_regionkey"],
                           r["r_regionkey"][r["r_name"] == reg])
    nnat = int(n["n_nationkey"].max()) + 1
    nation_ok = _by_key(n["n_nationkey"], in_region, nnat, False)
    name = _by_key(n["n_nationkey"], n["n_name"], nnat)
    supp_nation = _by_key(s["s_suppkey"], s["s_nationkey"],
                          int(s["s_suppkey"].max()) + 1)
    cust_nation = _by_key(c["c_custkey"], c["c_nationkey"],
                          int(c["c_custkey"].max()) + 1)
    nord = int(o["o_orderkey"].max()) + 1
    in_dates = (o["o_orderdate"] >= date_from) & (o["o_orderdate"] < date_to)
    order_ok = _by_key(o["o_orderkey"], in_dates, nord, False)
    order_cust = _by_key(o["o_orderkey"], o["o_custkey"], nord)
    sn = supp_nation[li["l_suppkey"]]
    mask = (order_ok[li["l_orderkey"]]
            & (cust_nation[order_cust[li["l_orderkey"]]] == sn)
            & nation_ok[sn])
    nations = sn[mask]
    revenue = torch.zeros(nnat, dtype=dtype, device=nations.device)
    revenue.index_add_(0, nations, _revenue(li, mask, dtype))
    present = torch.nonzero(torch.bincount(nations, minlength=nnat))[:, 0]
    order = present[torch.argsort(revenue[present], descending=True,
                                  stable=True)]
    names = dicts["n_name"]
    return {"n_name": [names[i] for i in name[order].tolist()],
            "revenue": revenue[order].double().cpu().numpy()}


QUERIES = {"q3": q3, "q5": q5}

#: each query's key columns (compared exactly, in order) and its one
#: floating column (compared by relative gap)
KEYS = {"q3": ("l_orderkey", "o_orderdate", "o_shippriority"),
        "q5": ("n_name",)}
FLOAT = "revenue"


def answer(query: str, t: dict, dicts: dict, params: dict,
           dtype=torch.float64) -> dict:
    """The query's result rows as host arrays, by column."""
    return QUERIES[query](t, dicts, dtype=dtype, **params)


def compare(query: str, got: dict, want: dict) -> dict:
    """``{"rows_off": n, "revenue_gap": g}``: rows missing, extra or with a
    key that differs from the reference's row at the same place; and the
    largest ``|got - want| / |want|`` of revenue over the rows whose keys
    agree (0 where none do)."""
    ng, nw = len(got[FLOAT]), len(want[FLOAT])
    off, gap = abs(ng - nw), 0.0
    for i in range(min(ng, nw)):
        if any(got[k][i] != want[k][i] for k in KEYS[query]):
            off += 1
            continue
        w = float(want[FLOAT][i])
        gap = max(gap, abs(float(got[FLOAT][i]) - w) / abs(w))
    return {"rows_off": off, "revenue_gap": gap}
