"""TPC-H tables on the device, from the seed.

The distributions are those of the port's numpy generator
(``cylon_tpu_torch/tpch/dbgen.py``, itself a copy of the JAX package's),
which follow the TPC-H specification (clause 4.2.3): keys dense from 1,
``c_mktsegment`` uniform over 5 segments, ``o_orderdate`` uniform over
1992-01-01 .. 1998-08-02, 1 to 7 items an order, ``l_shipdate`` 1 to 121
days after the order, ``l_suppkey`` one of the 4 suppliers of the item's
part, ``l_extendedprice`` uniform in [900, 105000) at cents, ``l_discount``
0.00 .. 0.10. Only the columns a configuration's queries read are kept;
every draw is made whatever is kept, so one seed gives one data set.
Made with one ``torch.Generator`` on the device, a few large calls a
column, so set-up pays no host generation and no host-to-device copy.

String columns come as int32 codes into a sorted dictionary (``DICTS``),
which is how the program holds them, and dates as int32 days since
1970-01-01.
"""

import datetime

import torch

from benchmark.data.join import generator

_EPOCH = datetime.date(1970, 1, 1).toordinal()

REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")

#: each string column's dictionary, sorted (code order is value order)
DICTS = {
    "c_mktsegment": tuple(sorted(SEGMENTS)),
    "n_name": tuple(sorted(n for n, _ in NATIONS)),
    "r_name": tuple(sorted(REGIONS)),
}


def date_int(iso: str) -> int:
    """``"YYYY-MM-DD"`` -> int32 days since 1970-01-01."""
    return datetime.date.fromisoformat(iso).toordinal() - _EPOCH


START = date_int("1992-01-01")
END = date_int("1998-08-02")


def _codes(values, names) -> torch.Tensor:
    """Host strings -> codes into ``DICTS[names]``."""
    index = {v: i for i, v in enumerate(DICTS[names])}
    return torch.tensor([index[v] for v in values], dtype=torch.int32)


def _uniform_cents(lo: float, hi: float, n: int, g, device):
    """Uniform in ``[lo, hi)``, rounded to cents as ``np.round(x, 2)``."""
    x = torch.rand(n, dtype=torch.float64, device=device, generator=g)
    return torch.round((lo + (hi - lo) * x) * 100.0) / 100.0


def generate(config: dict, seed: int, device) -> dict:
    """``{table: {column: tensor}}`` at ``config["scale_factor"]``, the
    columns of ``config["columns_read"]``'s queries only."""
    sf = float(config["scale_factor"])
    keep = {}
    for per_query in config["columns_read"].values():
        for table, cols in per_query.items():
            keep.setdefault(table, set()).update(cols)
    g = generator(seed, device)
    i64, i32 = torch.int64, torch.int32

    def uint(lo, hi, n, dtype=i64):
        """Integers uniform in ``[lo, hi)``."""
        return torch.randint(lo, hi, (n,), dtype=dtype, device=device,
                             generator=g)

    n_cust = max(int(150_000 * sf), 10)
    n_supp = max(int(10_000 * sf), 5)
    n_ord = max(int(1_500_000 * sf), 20)
    n_part = max(int(200_000 * sf), 8)
    cols = {}
    cols["region"] = {
        "r_regionkey": torch.arange(5, dtype=i64),
        "r_name": _codes(REGIONS, "r_name")}
    cols["nation"] = {
        "n_nationkey": torch.arange(len(NATIONS), dtype=i64),
        "n_name": _codes([n for n, _ in NATIONS], "n_name"),
        "n_regionkey": torch.tensor([r for _, r in NATIONS], dtype=i64)}
    for t in ("region", "nation"):
        cols[t] = {c: v.to(device) for c, v in cols[t].items()}
    cols["customer"] = {
        "c_custkey": torch.arange(1, n_cust + 1, dtype=i64, device=device),
        "c_nationkey": uint(0, len(NATIONS), n_cust),
        "c_mktsegment": uint(0, len(SEGMENTS), n_cust, i32)}
    cols["supplier"] = {
        "s_suppkey": torch.arange(1, n_supp + 1, dtype=i64, device=device),
        "s_nationkey": uint(0, len(NATIONS), n_supp)}
    # partsupp's supplier progression (4 distinct suppliers a part): an
    # item's supplier is one of its part's, as in the port's generator
    base = uint(0, n_supp, n_part)
    step = uint(1, max((n_supp - 1) // 3, 1) + 1, n_part)
    o_orderdate = uint(START, END + 1, n_ord, i32)
    cols["orders"] = {
        "o_orderkey": torch.arange(1, n_ord + 1, dtype=i64, device=device),
        "o_custkey": uint(1, n_cust + 1, n_ord),
        "o_orderdate": o_orderdate,
        "o_shippriority": torch.zeros(n_ord, dtype=i64, device=device)}
    per_order = uint(1, 8, n_ord)
    l_orderkey = torch.repeat_interleave(cols["orders"]["o_orderkey"],
                                         per_order)
    n_li = l_orderkey.shape[0]
    l_orderdate = torch.repeat_interleave(o_orderdate, per_order)
    l_partkey = uint(1, n_part + 1, n_li)
    cols["lineitem"] = {
        "l_orderkey": l_orderkey,
        "l_shipdate": (l_orderdate + uint(1, 122, n_li, i32)).to(i32),
        "l_suppkey": (base[l_partkey - 1] + uint(0, 4, n_li)
                      * step[l_partkey - 1]) % n_supp + 1,
        "l_extendedprice": _uniform_cents(900.0, 105_000.0, n_li, g,
                                          device),
        "l_discount": uint(0, 11, n_li).to(torch.float64) / 100.0}
    del base, step, l_orderdate, l_partkey, per_order
    return {t: {c: v for c, v in tcols.items() if c in keep[t]}
            for t, tcols in cols.items() if t in keep}


def permutations(data: dict, seed: int, device) -> dict:
    """One seeded row permutation a table (the second batch: the same rows
    in another order), ``{table: int64 tensor}``. Drawn from a stream of
    its own (``seed`` + 1), so the first batch does not depend on it."""
    g = generator(int(seed) + 1, device)
    out = {}
    for t in sorted(data):
        n = next(iter(data[t].values())).shape[0]
        out[t] = torch.randperm(n, device=device, generator=g)
    return out


def permuted(data: dict, perms: dict) -> dict:
    """``data`` with each table's rows in the order ``perms`` gives."""
    return {t: {c: v[perms[t]] for c, v in cols.items()}
            for t, cols in data.items()}


def rows(data: dict) -> dict:
    """Row count of each table."""
    return {t: next(iter(cols.values())).shape[0]
            for t, cols in data.items()}
