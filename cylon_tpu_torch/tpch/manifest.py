"""The columns each TPC-H query reads, by table.

Port of ``cylon_tpu/tpch/manifest.py:26-238`` (``MANIFEST``): for each of
the 22 queries, the exact column set each input table is projected to
before any compute. It is the source of truth for projection pushdown
(``queries._tables`` looks its caller up here; the string-constant
inference is the fallback for other callers and a cross-check that the
tests hold equal to this manifest), and the generator's ``keep`` sets
(``dbgen.generate(keep=...)``) are unions of its entries. The JAX
module's ``FALLBACK`` plans serve the out-of-core path and come with it
(ROADMAP A7).
"""

MANIFEST = {
    "q1": {
        "lineitem": frozenset([
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate",
        ]),
    },
    "q2": {
        "part": frozenset(["p_partkey", "p_mfgr", "p_type", "p_size"]),
        "supplier": frozenset([
            "s_suppkey", "s_name", "s_nationkey", "s_acctbal",
        ]),
        "partsupp": frozenset(["ps_partkey", "ps_suppkey", "ps_supplycost"]),
        "nation": frozenset(["n_nationkey", "n_name", "n_regionkey"]),
        "region": frozenset(["r_regionkey", "r_name"]),
    },
    "q3": {
        "customer": frozenset(["c_custkey", "c_mktsegment"]),
        "orders": frozenset([
            "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
        ]),
        "lineitem": frozenset([
            "l_orderkey", "l_extendedprice", "l_discount", "l_shipdate",
        ]),
    },
    "q4": {
        "orders": frozenset(["o_orderkey", "o_orderdate", "o_orderpriority"]),
        "lineitem": frozenset([
            "l_orderkey", "l_commitdate", "l_receiptdate",
        ]),
    },
    "q5": {
        "customer": frozenset(["c_custkey", "c_nationkey"]),
        "orders": frozenset(["o_orderkey", "o_custkey", "o_orderdate"]),
        "lineitem": frozenset([
            "l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
        ]),
        "supplier": frozenset(["s_suppkey", "s_nationkey"]),
        "nation": frozenset(["n_nationkey", "n_name", "n_regionkey"]),
        "region": frozenset(["r_regionkey", "r_name"]),
    },
    "q6": {
        "lineitem": frozenset([
            "l_quantity", "l_extendedprice", "l_discount", "l_shipdate",
        ]),
    },
    "q7": {
        "supplier": frozenset(["s_suppkey", "s_nationkey"]),
        "lineitem": frozenset([
            "l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
            "l_shipdate",
        ]),
        "orders": frozenset(["o_orderkey", "o_custkey"]),
        "customer": frozenset(["c_custkey", "c_nationkey"]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q8": {
        "part": frozenset(["p_partkey", "p_type"]),
        "supplier": frozenset(["s_suppkey", "s_nationkey"]),
        "lineitem": frozenset([
            "l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice",
            "l_discount",
        ]),
        "orders": frozenset(["o_orderkey", "o_custkey", "o_orderdate"]),
        "customer": frozenset(["c_custkey", "c_nationkey"]),
        "nation": frozenset(["n_nationkey", "n_name", "n_regionkey"]),
        "region": frozenset(["r_regionkey", "r_name"]),
    },
    "q9": {
        "part": frozenset(["p_partkey", "p_name"]),
        "supplier": frozenset(["s_suppkey", "s_nationkey"]),
        "lineitem": frozenset([
            "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
            "l_extendedprice", "l_discount",
        ]),
        "partsupp": frozenset(["ps_partkey", "ps_suppkey", "ps_supplycost"]),
        "orders": frozenset(["o_orderkey", "o_orderdate"]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q10": {
        "customer": frozenset(["c_custkey", "c_nationkey", "c_acctbal"]),
        "orders": frozenset(["o_orderkey", "o_custkey", "o_orderdate"]),
        "lineitem": frozenset([
            "l_orderkey", "l_extendedprice", "l_discount", "l_returnflag",
        ]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q11": {
        "partsupp": frozenset([
            "ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost",
        ]),
        "supplier": frozenset(["s_suppkey", "s_nationkey"]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q12": {
        "orders": frozenset(["o_orderkey", "o_orderpriority"]),
        "lineitem": frozenset([
            "l_orderkey", "l_shipdate", "l_commitdate", "l_receiptdate",
            "l_shipmode",
        ]),
    },
    "q13": {
        "customer": frozenset(["c_custkey"]),
        "orders": frozenset(["o_orderkey", "o_custkey", "o_comment"]),
    },
    "q14": {
        "lineitem": frozenset([
            "l_partkey", "l_extendedprice", "l_discount", "l_shipdate",
        ]),
        "part": frozenset(["p_partkey", "p_type"]),
    },
    "q15": {
        "supplier": frozenset(["s_suppkey", "s_name"]),
        "lineitem": frozenset([
            "l_suppkey", "l_extendedprice", "l_discount", "l_shipdate",
        ]),
    },
    "q16": {
        "part": frozenset(["p_partkey", "p_brand", "p_type", "p_size"]),
        "partsupp": frozenset(["ps_partkey", "ps_suppkey"]),
        "supplier": frozenset(["s_suppkey", "s_comment"]),
    },
    "q17": {
        "part": frozenset(["p_partkey", "p_brand", "p_container"]),
        "lineitem": frozenset(["l_partkey", "l_quantity", "l_extendedprice"]),
    },
    "q18": {
        "customer": frozenset(["c_custkey"]),
        "orders": frozenset([
            "o_orderkey", "o_custkey", "o_orderdate", "o_totalprice",
        ]),
        "lineitem": frozenset(["l_orderkey", "l_quantity"]),
    },
    "q19": {
        "lineitem": frozenset([
            "l_partkey", "l_quantity", "l_extendedprice", "l_discount",
            "l_shipmode", "l_shipinstruct",
        ]),
        "part": frozenset(["p_partkey", "p_brand", "p_size", "p_container"]),
    },
    "q20": {
        "part": frozenset(["p_partkey", "p_name"]),
        "partsupp": frozenset(["ps_partkey", "ps_suppkey", "ps_availqty"]),
        "lineitem": frozenset([
            "l_partkey", "l_suppkey", "l_quantity", "l_shipdate",
        ]),
        "supplier": frozenset(["s_suppkey", "s_name", "s_nationkey"]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q21": {
        "supplier": frozenset(["s_suppkey", "s_name", "s_nationkey"]),
        "lineitem": frozenset([
            "l_orderkey", "l_suppkey", "l_commitdate", "l_receiptdate",
        ]),
        "orders": frozenset(["o_orderkey", "o_orderstatus"]),
        "nation": frozenset(["n_nationkey", "n_name"]),
    },
    "q22": {
        "customer": frozenset(["c_custkey", "c_acctbal", "c_phone"]),
        "orders": frozenset(["o_custkey"]),
    },
}
