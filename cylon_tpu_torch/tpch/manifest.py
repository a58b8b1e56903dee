"""The columns each TPC-H query reads, by table.

Port of ``cylon_tpu/tpch/manifest.py:26-238`` (``MANIFEST``): for each of
the 22 queries, the exact column set each input table is projected to
before any compute. It is the source of truth for projection pushdown
(``queries._tables`` looks its caller up here; the string-constant
inference is the fallback for other callers and a cross-check that the
tests hold equal to this manifest), and the generator's ``keep`` sets
(``dbgen.generate(keep=...)``) are unions of its entries. ``FALLBACK``
(``cylon_tpu/tpch/manifest.py:190-377``) holds each query's spill plan
for :mod:`cylon_tpu_torch.fallback`.
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


#: Per-query spill-fallback plans (:mod:`cylon_tpu_torch.fallback`). Each
#: entry declares:
#:
#: - ``partition``: ``{table: key_column | None}`` — the tables the
#:   executor hash-splits by the query's DOMINANT join key into P
#:   co-partitioned host shards (same splitmix hash on the same key
#:   domain, so e.g. orders and lineitem rows of one order always land
#:   in the same shard); ``None`` means plain row-chunking (a query
#:   with no join over that table — q1/q6 scan lineitem). Every table
#:   the query reads but does NOT partition is broadcast whole to
#:   every partition (the small build sides).
#: - ``merge``: how per-partition runs of the UNCHANGED query fn
#:   recombine into the exact answer:
#:
#:   * ``"concat"`` — every output group/row is fully contained in one
#:     partition (the query's group keys refine the partition key), so
#:     the global answer is the concatenation re-sorted (+ re-limited;
#:     a global top-k is always a subset of the per-partition top-ks).
#:   * ``"groupby"`` — groups span partitions; partials re-aggregate
#:     with the associative combiner map (``sum``/``min``/``max``;
#:     averages re-merge as count-weighted means — the ooc_groupby
#:     decomposition applied to the query's OWN output columns). The
#:     executor suppresses any per-partition ``limit`` (``limit_kwarg``)
#:     and re-applies it after the merge.
#:   * ``"sum"`` — scalar queries that are a pure SUM over rows of the
#:     partitioned table(s): the answer is the sum of partial scalars.
#:   * ``"twophase"`` — the query's output embeds global
#:     non-associative state (a ratio of sums, a global
#:     threshold/average, COUNT(DISTINCT)) that per-partition runs of
#:     the stock query cannot recombine. These run a hand-decomposed
#:     plan (:data:`cylon_tpu_torch.tpch.twophase.PLANS`) instead: phase 1
#:     emits associative partials per partition, a journaled global
#:     merge computes the blocking value, phase 2 re-applies it per
#:     partition. The partition map is chosen FOR the decomposition —
#:     q16 splits partsupp/supplier by SUPPKEY (the distinct key) so
#:     per-partition distinct counts are disjoint and summable; q15
#:     co-partitions supplier with the lineitem revenue groups; q22
#:     co-partitions orders with customer so the NOT EXISTS anti-join
#:     stays partition-local.
#:
#: - ``sort``/``ascending``/``limit_kwarg``: the query's final order
#:   (and the name of its limit parameter), re-applied after the merge.
#: - ``distinct``: concat-merge dedup (a row may qualify independently
#:   in several partitions — q20's EXISTS-style supplier set).
#:
#: ``tests/test_torch_fallback.py`` holds it equal to the JAX package's
#: and checks that every partition key is inside the projection manifest
#: above (a pruned ingest must keep its own partition key).
FALLBACK = {
    "q1": {
        "partition": {"lineitem": None},
        "merge": "groupby", "by": ["l_returnflag", "l_linestatus"],
        "aggs": {"sum_qty": "sum", "sum_base_price": "sum",
                 "sum_disc_price": "sum", "sum_charge": "sum",
                 "avg_qty": ("wmean", "count_order"),
                 "avg_price": ("wmean", "count_order"),
                 "avg_disc": ("wmean", "count_order"),
                 "count_order": "sum"},
        "sort": ["l_returnflag", "l_linestatus"],
    },
    "q2": {
        "partition": {"part": "p_partkey", "partsupp": "ps_partkey"},
        "merge": "concat",
        "sort": ["s_acctbal", "n_name", "s_name", "ps_partkey"],
        "ascending": [False, True, True, True], "limit_kwarg": "limit",
    },
    "q3": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "concat",
        "sort": ["revenue", "o_orderdate"], "ascending": [False, True],
        "limit_kwarg": "limit",
    },
    "q4": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "groupby", "by": ["o_orderpriority"],
        "aggs": {"order_count": "sum"}, "sort": ["o_orderpriority"],
    },
    "q5": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "groupby", "by": ["n_name"],
        "aggs": {"revenue": "sum"},
        "sort": ["revenue"], "ascending": [False],
    },
    "q6": {"partition": {"lineitem": None}, "merge": "sum"},
    "q7": {
        "partition": {"lineitem": "l_orderkey", "orders": "o_orderkey"},
        "merge": "groupby",
        "by": ["supp_nation", "cust_nation", "l_year"],
        "aggs": {"revenue": "sum"},
        "sort": ["supp_nation", "cust_nation", "l_year"],
    },
    "q8": {
        # per-year market share is a ratio of sums: phase 1 emits
        # (total, nation_total) per o_year, the merge re-sums and
        # takes the ratio — no phase 2
        "partition": {"lineitem": "l_orderkey", "orders": "o_orderkey"},
        "merge": "twophase",
    },
    "q9": {
        "partition": {"lineitem": "l_orderkey", "orders": "o_orderkey"},
        "merge": "groupby", "by": ["nation", "o_year"],
        "aggs": {"profit": "sum"},
        "sort": ["nation", "o_year"], "ascending": [True, False],
    },
    "q10": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "groupby",
        "by": ["c_custkey", "c_acctbal", "n_name"],
        "aggs": {"revenue": "sum"},
        "sort": ["revenue", "c_custkey"], "ascending": [False, True],
        "limit_kwarg": "limit",
    },
    "q11": {
        # HAVING value > fraction * GLOBAL total: phase 1 emits exact
        # per-partkey value sums (groups never span partitions), the
        # merge sums the total, phase 2 filters against it
        "partition": {"partsupp": "ps_partkey"},
        "merge": "twophase",
    },
    "q12": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "groupby", "by": ["l_shipmode"],
        "aggs": {"high_line_count": "sum", "low_line_count": "sum"},
        "sort": ["l_shipmode"],
    },
    "q13": {
        "partition": {"customer": "c_custkey", "orders": "o_custkey"},
        "merge": "groupby", "by": ["c_count"],
        "aggs": {"custdist": "sum"},
        "sort": ["custdist", "c_count"], "ascending": [False, False],
    },
    "q14": {
        # scalar promo/total percentage: phase 1 emits the (promo_rev,
        # total_rev) sum pair, the merge takes the ratio — no phase 2
        "partition": {"lineitem": "l_partkey", "part": "p_partkey"},
        "merge": "twophase",
    },
    "q15": {
        # = MAX(total_revenue) against a GLOBAL max: phase 1 emits
        # exact per-suppkey revenue sums, the merge takes the max,
        # phase 2 filters and joins the co-partitioned supplier slice
        "partition": {"lineitem": "l_suppkey", "supplier": "s_suppkey"},
        "merge": "twophase",
    },
    "q16": {
        # COUNT(DISTINCT ps_suppkey) per part-attribute group:
        # partitioned BY THE DISTINCT KEY (suppkey, not partkey) so
        # per-partition distinct sets are disjoint and the merge SUMS
        # them exactly; part broadcasts — no phase 2
        "partition": {"partsupp": "ps_suppkey", "supplier": "s_suppkey"},
        "merge": "twophase",
    },
    "q17": {
        "partition": {"part": "p_partkey", "lineitem": "l_partkey"},
        "merge": "sum",
    },
    "q18": {
        "partition": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
        "merge": "concat",
        "sort": ["o_totalprice", "o_orderdate"],
        "ascending": [False, True], "limit_kwarg": "limit",
    },
    "q19": {
        "partition": {"lineitem": "l_partkey", "part": "p_partkey"},
        "merge": "sum",
    },
    "q20": {
        "partition": {"part": "p_partkey", "partsupp": "ps_partkey",
                      "lineitem": "l_partkey"},
        "merge": "concat", "distinct": True, "sort": ["s_name"],
    },
    "q21": {
        "partition": {"lineitem": "l_orderkey", "orders": "o_orderkey"},
        "merge": "groupby", "by": ["s_name"],
        "aggs": {"numwait": "sum"},
        "sort": ["numwait", "s_name"], "ascending": [False, True],
        "limit_kwarg": "limit",
    },
    "q22": {
        # the balance cutoff is a GLOBAL average: phase 1 emits the
        # (sum, count) pair over positive-balance coded customers, the
        # merge divides, phase 2 re-filters and anti-joins the
        # co-partitioned orders slice
        "partition": {"customer": "c_custkey", "orders": "o_custkey"},
        "merge": "twophase",
    },
}
