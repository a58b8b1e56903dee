"""The 22 TPC-H queries over the port's DataFrame.

Port of ``cylon_tpu/tpch/queries.py``. Each query is the standard
multi-way join and group-by pipeline (BASELINE.json configuration 5),
written as a PyCylon user writes it (``DataFrame.merge`` / ``groupby`` /
``sort_values``, env dispatch as ``python/pycylon/frame.py:1728-1743``):
``env=None`` runs on one device, a :class:`cylon_tpu_torch.CylonEnv`
runs every join, group-by and sort over its ranks.

Row-local predicates run before the first exchange (predicate pushdown),
so the exchanges move only the rows that survive them.

With an ``env`` the queries are distributed end to end, SPMD as the
reference: every rank calls the query with the same ``data``, keeps its
block of each input (``dtable.scatter_table``; frames already sharded
over the env keep their shard), filters and derived columns run on its
shard, scalar subqueries reduce over the world (``dist_aggregate``), and
final sorts are distributed sample sorts. No input is gathered; only the
result's ``to_pandas`` gathers, a collective every rank calls.

Devices: frames keep theirs; a raw ``{table: {column: array}}`` mapping
is built on the env's device (:attr:`CylonEnv.device`), or without an
env on the default device, CUDA. Scalar queries (q6, q14, q17, q19)
return a Python float, and a 0-d tensor on the device inside a
:class:`~cylon_tpu_torch.plan.CompiledQuery` (``tpch.compiled``).
"""

from typing import Mapping

import numpy as np
import torch

from cylon_tpu_torch import dtypes, plan
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.frame import DataFrame
from cylon_tpu_torch.ops.aggregates import table_aggregate
from cylon_tpu_torch.ops.datetime_ops import year_of
from cylon_tpu_torch.parallel.dist_ops import dist_aggregate
from cylon_tpu_torch.tpch.dbgen import date_int


def _scalar(x):
    """A 0-d aggregate as a host float, but inside a
    :class:`~cylon_tpu_torch.plan.CompiledQuery`, where it stays a 0-d
    tensor on the device (``cylon_tpu/tpch/queries.py:39``: a traced
    value there)."""
    if plan.in_compiled():
        return x
    return float(x)


#: ingest policy for raw dbgen mappings: near-unique text columns take
#: DEVICE BYTES (no host dictionary: at SF1 o_comment alone is ~1.5M
#: distinct values); every other string column is low-cardinality and
#: keeps dictionary codes
TPCH_STRING_STORAGE = {"o_comment": "bytes", "s_comment": "bytes",
                       "l_comment": "bytes"}


def _df(x, device=None) -> DataFrame:
    if isinstance(x, DataFrame):
        return x
    return DataFrame(x, string_storage=TPCH_STRING_STORAGE, device=device)


#: per-table column-name prefix; only columns carrying their own
#: table's prefix are pruning candidates
_TPCH_PREFIXES = {"lineitem": "l_", "orders": "o_", "customer": "c_",
                  "supplier": "s_", "part": "p_", "partsupp": "ps_",
                  "nation": "n_", "region": "r_"}


def _code_strings(code) -> set:
    """Every string constant reachable from a code object: nested
    lambdas and comprehensions recurse, tuple constants flatten."""
    out = set()
    for c in code.co_consts:
        if isinstance(c, str):
            out.add(c)
        elif isinstance(c, tuple):
            out |= {e for e in c if isinstance(e, str)}
        elif hasattr(c, "co_consts"):
            out |= _code_strings(c)
    return out


def _query_strings(code, globalns, depth: int = 2, top: bool = True) -> set:
    """String constants of a query function and of the module helpers it
    calls (through ``co_names``), ``cylon_tpu/tpch/queries.py:88``.
    Long strings (over 60 characters: docstrings) count only from the
    query's own code object, where :func:`keep_columns` matches them by
    substring (a column named only in the query's SQL survives), so that
    a helper's docstring cannot defeat pruning for every caller."""
    out = _code_strings(code)
    if not top:
        out = {s for s in out if len(s) <= 60}
    if depth:
        for name in code.co_names:
            fc = getattr(globalns.get(name), "__code__", None)
            if fc is not None:
                out |= _query_strings(fc, globalns, depth - 1, top=False)
    return out


def _prune(x, table_name: str, strings: set,
           explicit: "frozenset | None" = None, device=None) -> DataFrame:
    """Projection pushdown: drop the columns of this table the calling
    query never names (``cylon_tpu/tpch/queries.py:114``). With an
    ``explicit`` manifest set (:mod:`.manifest`, the source of truth for
    the 22 queries) that set is the keep predicate; otherwise the
    string-constant inference, which only ever keeps more. A raw mapping
    is pruned before it is built, so a dropped column never reaches the
    device."""
    frame = isinstance(x, DataFrame)
    cols = list(x.table.column_names if frame else x)
    if explicit is not None:
        keep = manifest_keep(table_name, cols, explicit)
    elif strings:
        keep = keep_columns(table_name, cols, strings)
    else:
        keep = cols
    if frame:
        return x if len(keep) == len(cols) else x[keep]
    return _df({c: x[c] for c in keep}, device)


def manifest_keep(table_name: str, cols, explicit) -> list:
    """The explicit-manifest keep predicate, shared by runtime pruning and
    a pre-ingest projection (``cylon_tpu/tpch/queries.py:139``): keep a
    column unless it carries this table's own TPC-H prefix and the
    manifest set leaves it out."""
    prefix = _TPCH_PREFIXES.get(table_name)
    return [c for c in cols
            if prefix is None or not c.startswith(prefix)
            or c in explicit]


def keep_columns(table_name: str, cols, strings: set) -> list:
    """The inference keep predicate (``cylon_tpu/tpch/queries.py:151``):
    keep a column unless it carries this table's own TPC-H prefix and
    the query names it nowhere; long constants (the query's SQL) match
    by substring."""
    prefix = _TPCH_PREFIXES.get(table_name)
    if prefix is None:
        return list(cols)
    long_strs = [s for s in strings if len(s) > 60]
    return [c for c in cols
            if not c.startswith(prefix) or c in strings
            or any(c in s for s in long_strs)]


def _tables(data: Mapping, names, env=None) -> list:
    """The query's inputs in the layout it runs in, projected to the
    columns the calling query reads (``cylon_tpu/tpch/queries.py:168``;
    the caller's name picks its :data:`.manifest.MANIFEST` entry). With
    ``env=None`` each is a local frame (a distributed one gathered);
    with an ``env`` each is this rank's shard over it: a frame sharded
    over the env keeps its shard, anything else is the same whole table
    on every rank and this rank keeps its block."""
    import sys

    from cylon_tpu_torch.tpch.manifest import MANIFEST

    missing = [n for n in names if n not in data]
    if missing:
        raise InvalidArgument(f"tpch input missing tables {missing}")
    caller = sys._getframe(1)
    declared = MANIFEST.get(caller.f_code.co_name, {})
    strings = (set() if declared
               else _query_strings(caller.f_code, caller.f_globals))
    dev = None if env is None else env.device
    frames = [_prune(data[n], n, strings, declared.get(n), dev)
              for n in names]
    if env is None:
        return [f._materialized() for f in frames]
    return [DataFrame._wrap(f._sharded(env), env=env) for f in frames]


def _filt(df: DataFrame, mask, env=None) -> DataFrame:
    """Row filter in the query's layout: each rank compacts its own shard
    (``dist_filter``, no collective) when distributed, a local filter
    otherwise. Masks are ``[capacity]`` bool tensors built elementwise on
    ``df.table``, so they are born in its layout."""
    return df.filter(mask, env=env) if df.is_distributed else df.filter(mask)


def _agg_scalar(df: DataFrame, col: str, op: str, env=None):
    """A scalar aggregate in the query's layout: over the world
    (``dist_aggregate``) when distributed, local otherwise; a float, or
    a 0-d tensor inside a compiled query."""
    if df.is_distributed:
        return _scalar(dist_aggregate(env or df.env, df.table, col, op))
    return _scalar(table_aggregate(df.table, col, op))


def _with(df: DataFrame, name: str, col: Column) -> DataFrame:
    """``df`` with a column added, in its layout."""
    return DataFrame._wrap(df.table.add_column(name, col), env=df.env)


def _eq_str(df: DataFrame, col: str, value: str) -> torch.Tensor:
    """Boolean row mask ``col == value`` for a string column (through
    ``Series.isin``: dictionary codes and null masking)."""
    return df.series(col).isin([value]).column.data


def _dict_mask(col, values=None, pred=None) -> torch.Tensor:
    """``[capacity]`` bool mask from a membership list or a host predicate
    over a dictionary column: the dictionary is on the host and the same
    on every shard, the codes compare on the device, so the same mask
    builds on a local or a distributed column."""
    vals = [] if col.dictionary is None else list(col.dictionary.values)
    if pred is not None:
        codes = [i for i, v in enumerate(vals) if pred(v)]
    else:
        lut = {v: i for i, v in enumerate(vals)}
        codes = [lut[v] for v in values if v in lut]
    probe = plan.staged(np.asarray(codes or [-1], np.int64),
                        col.data.device, col.data.dtype)
    m = (col.data[:, None] == probe[None, :]).any(dim=1)
    if col.validity is not None:
        m = m & col.validity
    return m


def _like_seq(col, w1: str, w2: str) -> torch.Tensor:
    """``[capacity]`` bool mask for ``LIKE '%w1%w2%'`` (w2 after the first
    w1), by storage: byte windows on the device for a bytes column
    (``bytescol.contains_seq``), a host predicate over a dictionary."""
    if col.dtype.is_bytes:
        from cylon_tpu_torch.ops import bytescol

        return bytescol.contains_seq(col, w1, w2)
    return _dict_mask(
        col, pred=lambda v: v is not None and w1 in str(v)
        and w2 in str(v)[str(v).index(w1) + len(w1):])


def _where(mask, col: Column) -> Column:
    """``col`` where ``mask`` holds, else zero (a SQL CASE)."""
    return Column(torch.where(mask, col.data, torch.zeros(
        (), dtype=col.data.dtype, device=col.data.device)),
        col.validity, col.dtype)


def _year(days: torch.Tensor) -> Column:
    return Column(year_of(days).to(torch.int32), None, dtypes.int32)


def _percent(part, total):
    """``100 * part / total``, 0 where the total is 0; tensors inside a
    compiled query, floats outside."""
    if torch.is_tensor(total):
        zero = total == 0
        return torch.where(zero, torch.zeros_like(total), 100.0 * part
                           / torch.where(zero, torch.ones_like(total),
                                         total))
    return 0.0 if total == 0 else 100.0 * part / total


def _with_revenue(li: DataFrame) -> DataFrame:
    """lineitem + revenue = l_extendedprice * (1 - l_discount)
    (Series arithmetic: validities intersect)."""
    rev = li.series("l_extendedprice") * (1 - li.series("l_discount"))
    return _with(li, "revenue", rev.column)


def q3(data: Mapping, env=None, segment: str = "BUILDING",
       cutoff: int | None = None, limit: int = 10) -> DataFrame:
    """TPC-H Q3 (shipping priority): revenue of unshipped orders for one
    market segment.

    SELECT l_orderkey, SUM(l_extendedprice*(1-l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = :segment AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey
      AND o_orderdate < :cutoff AND l_shipdate > :cutoff
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate LIMIT :limit
    """
    if cutoff is None:
        cutoff = date_int(1995, 3, 15)
    customer, orders, lineitem = _tables(
        data, ["customer", "orders", "lineitem"], env)

    cust = _filt(customer, _eq_str(customer, "c_mktsegment", segment), env)
    cust = cust[["c_custkey"]]
    ords = _filt(orders, orders.table.column("o_orderdate").data < cutoff,
                 env)
    ords = ords[["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]]
    li = _filt(lineitem, lineitem.table.column("l_shipdate").data > cutoff,
               env)
    li = _with_revenue(li)[["l_orderkey", "revenue"]]

    oc = ords.merge(cust, left_on="o_custkey", right_on="c_custkey",
                    how="inner", env=env)
    j = li.merge(oc, left_on="l_orderkey", right_on="o_orderkey",
                 how="inner", env=env)
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  env=env).agg([("revenue", "sum", "revenue")])
    out = g.sort_values(["revenue", "o_orderdate"], ascending=[False, True],
                        env=env)
    out = out.head(limit)
    return out[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]


def q5(data: Mapping, env=None, region: str = "ASIA",
       date_from: int | None = None, date_to: int | None = None
       ) -> DataFrame:
    """TPC-H Q5 (local supplier volume): per-nation revenue where
    customer and supplier share the nation, within one region and year.

    SELECT n_name, SUM(l_extendedprice*(1-l_discount)) AS revenue
    FROM customer, orders, lineitem, supplier, nation, region
    WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
      AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
      AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
      AND r_name = :region AND o_orderdate IN [:date_from, :date_to)
    GROUP BY n_name ORDER BY revenue DESC
    """
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)
    customer, orders, lineitem, supplier, nation, reg = _tables(
        data, ["customer", "orders", "lineitem", "supplier", "nation",
               "region"], env)

    reg = _filt(reg, _eq_str(reg, "r_name", region), env)[["r_regionkey"]]
    nat = nation.merge(reg, left_on="n_regionkey", right_on="r_regionkey",
                       how="inner", env=env)[["n_nationkey", "n_name"]]
    sup = supplier.merge(nat, left_on="s_nationkey",
                         right_on="n_nationkey", how="inner",
                         env=env)[["s_suppkey", "s_nationkey", "n_name"]]

    od = orders.table.column("o_orderdate").data
    ords = _filt(orders, (od >= date_from) & (od < date_to), env)
    ords = ords[["o_orderkey", "o_custkey"]]
    cust = customer[["c_custkey", "c_nationkey"]]
    li = _with_revenue(lineitem)[["l_orderkey", "l_suppkey", "revenue"]]

    oc = ords.merge(cust, left_on="o_custkey", right_on="c_custkey",
                    how="inner", env=env)
    j = li.merge(oc, left_on="l_orderkey", right_on="o_orderkey",
                 how="inner", env=env)
    # the customer-supplier co-nation predicate is a second equi-key of
    # the supplier join, so it runs after the exchange on each shard
    j = j.merge(sup, left_on=["l_suppkey", "c_nationkey"],
                right_on=["s_suppkey", "s_nationkey"],
                how="inner", env=env)
    g = j.groupby(["n_name"], env=env).agg([("revenue", "sum", "revenue")])
    out = g.sort_values(["revenue"], ascending=[False], env=env)
    return out[["n_name", "revenue"]]


def q1(data: Mapping, env=None, cutoff: int | None = None) -> DataFrame:
    """TPC-H Q1 (pricing summary report): per (returnflag, linestatus)
    sums/averages over shipped lineitems.

    SELECT l_returnflag, l_linestatus, SUM(l_quantity),
           SUM(l_extendedprice), SUM(l_extendedprice*(1-l_discount)),
           SUM(l_extendedprice*(1-l_discount)*(1+l_tax)),
           AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount),
           COUNT(*)
    FROM lineitem WHERE l_shipdate <= :cutoff
    GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2
    """
    if cutoff is None:
        cutoff = date_int(1998, 9, 2)
    (lineitem,) = _tables(data, ["lineitem"], env)
    li = _filt(lineitem, lineitem.table.column("l_shipdate").data <= cutoff,
               env)
    price = li.series("l_extendedprice")
    disc = li.series("l_discount")
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + li.series("l_tax"))
    li = _with(_with(li, "disc_price", disc_price.column), "charge",
               charge.column)
    g = li.groupby(["l_returnflag", "l_linestatus"], env=env).agg([
        ("l_quantity", "sum", "sum_qty"),
        ("l_extendedprice", "sum", "sum_base_price"),
        ("disc_price", "sum", "sum_disc_price"),
        ("charge", "sum", "sum_charge"),
        ("l_quantity", "mean", "avg_qty"),
        ("l_extendedprice", "mean", "avg_price"),
        ("l_discount", "mean", "avg_disc"),
        ("l_quantity", "count", "count_order"),
    ])
    return g.sort_values(["l_returnflag", "l_linestatus"], env=env)


def q6(data: Mapping, env=None, date_from: int | None = None,
       date_to: int | None = None, discount: float = 0.06,
       quantity: int = 24):
    """TPC-H Q6 (forecasting revenue change), a scalar:

    SELECT SUM(l_extendedprice * l_discount) FROM lineitem
    WHERE l_shipdate >= :from AND l_shipdate < :to
      AND l_discount BETWEEN :discount-0.01 AND :discount+0.01
      AND l_quantity < :quantity
    """
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)
    (lineitem,) = _tables(data, ["lineitem"], env)
    t = lineitem.table
    sd = t.column("l_shipdate").data
    dc = t.column("l_discount").data
    qt = t.column("l_quantity").data
    mask = ((sd >= date_from) & (sd < date_to)
            & (dc >= discount - 0.01001) & (dc <= discount + 0.01001)
            & (qt < quantity))
    li = _filt(lineitem, mask, env)
    rev = li.series("l_extendedprice") * li.series("l_discount")
    return _agg_scalar(_with(li, "rev", rev.column), "rev", "sum", env)


def q4(data: Mapping, env=None, date_from: int | None = None,
       date_to: int | None = None) -> DataFrame:
    """TPC-H Q4 (order priority checking): orders in a quarter with at
    least one late lineitem. The EXISTS subquery is a semi-join =
    unique(l_orderkey of late lineitems) ⋈ orders.

    SELECT o_orderpriority, COUNT(*) AS order_count FROM orders
    WHERE o_orderdate >= :from AND o_orderdate < :from + 3 months
      AND EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
                  AND l_commitdate < l_receiptdate)
    GROUP BY o_orderpriority ORDER BY o_orderpriority
    """
    if date_from is None:
        date_from = date_int(1993, 7, 1)
    if date_to is None:
        date_to = date_int(1993, 10, 1)
    orders, lineitem = _tables(data, ["orders", "lineitem"], env)

    od = orders.table.column("o_orderdate").data
    ords = _filt(orders, (od >= date_from) & (od < date_to), env)
    ords = ords[["o_orderkey", "o_orderpriority"]]
    late = _filt(lineitem,
                 lineitem.table.column("l_commitdate").data
                 < lineitem.table.column("l_receiptdate").data, env)
    keys = late[["l_orderkey"]].drop_duplicates(["l_orderkey"], env=env)
    j = ords.merge(keys, left_on="o_orderkey", right_on="l_orderkey",
                   how="inner", env=env)
    g = j.groupby(["o_orderpriority"], env=env).agg(
        [("o_orderkey", "count", "order_count")])
    return g.sort_values(["o_orderpriority"], env=env)[
        ["o_orderpriority", "order_count"]]


def q10(data: Mapping, env=None, date_from: int | None = None,
        date_to: int | None = None, limit: int = 20) -> DataFrame:
    """TPC-H Q10 (returned item reporting): top customers by lost
    revenue on returned items in a quarter.

    SELECT c_custkey, SUM(l_extendedprice*(1-l_discount)) AS revenue,
           c_acctbal, n_name
    FROM customer, orders, lineitem, nation
    WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
      AND o_orderdate IN [:from, :from + 3 months)
      AND l_returnflag = 'R' AND c_nationkey = n_nationkey
    GROUP BY c_custkey, c_acctbal, n_name
    ORDER BY revenue DESC LIMIT :limit
    """
    if date_from is None:
        date_from = date_int(1993, 10, 1)
    if date_to is None:
        date_to = date_int(1994, 1, 1)
    customer, orders, lineitem, nation = _tables(
        data, ["customer", "orders", "lineitem", "nation"], env)

    od = orders.table.column("o_orderdate").data
    ords = _filt(orders, (od >= date_from) & (od < date_to), env)
    ords = ords[["o_orderkey", "o_custkey"]]
    li = _filt(lineitem, _eq_str(lineitem, "l_returnflag", "R"), env)
    li = _with_revenue(li)[["l_orderkey", "revenue"]]
    cust = customer[["c_custkey", "c_nationkey", "c_acctbal"]]
    nat = nation[["n_nationkey", "n_name"]]

    j = li.merge(ords, left_on="l_orderkey", right_on="o_orderkey",
                 how="inner", env=env)
    j = j.merge(cust, left_on="o_custkey", right_on="c_custkey",
                how="inner", env=env)
    j = j.merge(nat, left_on="c_nationkey", right_on="n_nationkey",
                how="inner", env=env)
    g = j.groupby(["c_custkey", "c_acctbal", "n_name"], env=env).agg(
        [("revenue", "sum", "revenue")])
    out = g.sort_values(["revenue", "c_custkey"], ascending=[False, True],
                        env=env)
    out = out.head(limit)
    return out[["c_custkey", "revenue", "c_acctbal", "n_name"]]


def q12(data: Mapping, env=None, modes=("MAIL", "SHIP"),
        date_from: int | None = None, date_to: int | None = None
        ) -> DataFrame:
    """TPC-H Q12 (shipping modes and order priority): late-shipping
    counts per mode, split by order priority. The CASE sums become
    0/1 indicator columns summed by groupby.

    SELECT l_shipmode,
           SUM(o_orderpriority IN ('1-URGENT','2-HIGH')) AS high_line_count,
           SUM(NOT ...) AS low_line_count
    FROM orders JOIN lineitem ON o_orderkey = l_orderkey
    WHERE l_shipmode IN :modes AND l_commitdate < l_receiptdate
      AND l_shipdate < l_commitdate AND l_receiptdate IN [:from, :from+1y)
    GROUP BY l_shipmode ORDER BY l_shipmode
    """
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)
    orders, lineitem = _tables(data, ["orders", "lineitem"], env)

    t = lineitem.table
    rd = t.column("l_receiptdate").data
    mask = (lineitem.series("l_shipmode").isin(list(modes)).column.data
            & (t.column("l_commitdate").data < rd)
            & (t.column("l_shipdate").data < t.column("l_commitdate").data)
            & (rd >= date_from) & (rd < date_to))
    li = _filt(lineitem, mask, env)[["l_orderkey", "l_shipmode"]]
    j = li.merge(orders[["o_orderkey", "o_orderpriority"]],
                 left_on="l_orderkey", right_on="o_orderkey",
                 how="inner", env=env)
    # the CASE indicators build elementwise on the (possibly
    # distributed) joined table
    high = j.series("o_orderpriority").isin(["1-URGENT", "2-HIGH"])
    low = ~high
    j = _with(j, "high_line_count", high.column.astype(dtypes.int64))
    j = _with(j, "low_line_count", low.column.astype(dtypes.int64))
    g = j.groupby(["l_shipmode"], env=env).agg([
        ("high_line_count", "sum", "high_line_count"),
        ("low_line_count", "sum", "low_line_count"),
    ])
    return g.sort_values(["l_shipmode"], env=env)[
        ["l_shipmode", "high_line_count", "low_line_count"]]


def q14(data: Mapping, env=None, date_from: int | None = None,
        date_to: int | None = None):
    """TPC-H Q14 (promotion effect), a scalar percentage:

    SELECT 100 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                          THEN l_extendedprice*(1-l_discount) ELSE 0 END)
               / SUM(l_extendedprice*(1-l_discount))
    FROM lineitem JOIN part ON l_partkey = p_partkey
    WHERE l_shipdate IN [:from, :from + 1 month)
    """
    if date_from is None:
        date_from = date_int(1995, 9, 1)
    if date_to is None:
        date_to = date_int(1995, 10, 1)
    lineitem, part = _tables(data, ["lineitem", "part"], env)

    sd = lineitem.table.column("l_shipdate").data
    li = _filt(lineitem, (sd >= date_from) & (sd < date_to), env)
    li = _with_revenue(li)[["l_partkey", "revenue"]]
    j = li.merge(part[["p_partkey", "p_type"]], left_on="l_partkey",
                 right_on="p_partkey", how="inner", env=env)
    # CASE is a masked revenue column on the (possibly distributed)
    # joined table; both sums reduce over the world, no gather
    t = j.table
    promo = _dict_mask(t.column("p_type"),
                       pred=lambda v: v is not None
                       and str(v).startswith("PROMO"))
    j = _with(j, "promo_rev", _where(promo, t.column("revenue")))
    total = _agg_scalar(j, "revenue", "sum", env)
    promo_sum = _agg_scalar(j, "promo_rev", "sum", env)
    return _percent(promo_sum, total)


def q18(data: Mapping, env=None, threshold: int = 300,
        limit: int = 100) -> DataFrame:
    """TPC-H Q18 (large volume customer): orders whose total quantity
    exceeds a threshold (the HAVING clause = groupby → filter → join).

    SELECT c_custkey, o_orderkey, o_orderdate, o_totalprice,
           SUM(l_quantity) AS sum_qty
    FROM customer, orders, lineitem
    WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem
                         GROUP BY l_orderkey
                         HAVING SUM(l_quantity) > :threshold)
      AND c_custkey = o_custkey AND o_orderkey = l_orderkey
    GROUP BY c_custkey, o_orderkey, o_orderdate, o_totalprice
    ORDER BY o_totalprice DESC, o_orderdate LIMIT :limit
    """
    customer, orders, lineitem = _tables(
        data, ["customer", "orders", "lineitem"], env)

    g = lineitem.groupby(["l_orderkey"], env=env).agg(
        [("l_quantity", "sum", "sum_qty")])
    big = _filt(g, g.table.column("sum_qty").data.to(torch.float64)
                > float(threshold), env)
    j = big.merge(orders[["o_orderkey", "o_custkey", "o_orderdate",
                          "o_totalprice"]],
                  left_on="l_orderkey", right_on="o_orderkey",
                  how="inner", env=env)
    j = j.merge(customer[["c_custkey"]], left_on="o_custkey",
                right_on="c_custkey", how="inner", env=env)
    out = j.sort_values(["o_totalprice", "o_orderdate"],
                        ascending=[False, True], env=env).head(limit)
    return out[["c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
                "sum_qty"]]


_Q19_CONTAINERS = (("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                   ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                   ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))
_Q19_SIZES = (5, 10, 15)


def q19(data: Mapping, env=None,
        brands=("Brand#12", "Brand#23", "Brand#34"),
        quantities=(1, 10, 20), containers=_Q19_CONTAINERS,
        sizes=_Q19_SIZES):
    """TPC-H Q19 (discounted revenue), a scalar: revenue from
    brand/container/quantity/size OR-branches (one branch per entry of
    the four parallel tuples). Shipmode/instruct predicates push down
    before the join; the branch predicates mix part and lineitem
    attributes so they evaluate post-join.

    SELECT SUM(l_extendedprice*(1-l_discount)) FROM lineitem, part
    WHERE p_partkey = l_partkey AND l_shipinstruct = 'DELIVER IN PERSON'
      AND l_shipmode IN ('AIR','REG AIR') AND (<branch1> OR ... OR <branchN>)
    """
    if not (len(brands) == len(quantities) == len(containers)
            == len(sizes)):
        raise InvalidArgument(
            "q19 branch tuples must have equal length: "
            f"{len(brands)} brands, {len(quantities)} quantities, "
            f"{len(containers)} containers, {len(sizes)} sizes")
    lineitem, part = _tables(data, ["lineitem", "part"], env)

    pre = (lineitem.series("l_shipmode").isin(["AIR", "REG AIR"]).column.data
           & _eq_str(lineitem, "l_shipinstruct", "DELIVER IN PERSON"))
    li = _with_revenue(_filt(lineitem, pre, env))[
        ["l_partkey", "l_quantity", "revenue"]]
    j = li.merge(part[["p_partkey", "p_brand", "p_container", "p_size"]],
                 left_on="l_partkey", right_on="p_partkey",
                 how="inner", env=env)

    # the OR-branch mask builds on the (possibly distributed) joined
    # table; the scalar reduces over the world (q6's pattern)
    t = j.table
    qty = t.column("l_quantity").data
    size = t.column("p_size").data
    mask = torch.zeros(t.capacity, dtype=torch.bool, device=t.device)
    for brand, cont, q_lo, s_hi in zip(brands, containers, quantities,
                                       sizes):
        branch = (_dict_mask(t.column("p_brand"), values=[brand])
                  & _dict_mask(t.column("p_container"), values=list(cont))
                  & (qty >= q_lo) & (qty <= q_lo + 10)
                  & (size >= 1) & (size <= s_hi))
        mask = mask | branch
    j = _with(j, "sel_rev", _where(mask, t.column("revenue")))
    return _agg_scalar(j, "sel_rev", "sum", env)


def q7(data: Mapping, env=None, nation1: str = "FRANCE",
       nation2: str = "GERMANY", date_from: int | None = None,
       date_to: int | None = None) -> DataFrame:
    """TPC-H Q7 (volume shipping): revenue between two nations by year
    and direction.

    SELECT supp_nation, cust_nation, l_year, SUM(volume) FROM supplier,
    lineitem, orders, customer, nation n1, nation n2
    WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
      AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
      AND c_nationkey = n2.n_nationkey
      AND ((n1 = :a AND n2 = :b) OR (n1 = :b AND n2 = :a))
      AND l_shipdate IN [1995-01-01, 1996-12-31]
    GROUP BY supp_nation, cust_nation, l_year ORDER BY 1, 2, 3

    Nation-pair pushdown: both sides pre-filter to the two nations, so
    the big joins only move candidate rows; the cross-pair predicate
    (exclude same-nation) drops on the tiny grouped result.
    """
    if date_from is None:
        date_from = date_int(1995, 1, 1)
    if date_to is None:
        date_to = date_int(1996, 12, 31)
    supplier, lineitem, orders, customer, nation = _tables(
        data, ["supplier", "lineitem", "orders", "customer", "nation"], env)

    pair = [nation1, nation2]
    n1 = _filt(nation, _dict_mask(nation.table.column("n_name"), pair), env)
    n1 = n1[["n_nationkey", "n_name"]].rename(
        columns={"n_name": "supp_nation"})
    n2 = _filt(nation, _dict_mask(nation.table.column("n_name"), pair), env)
    n2 = n2[["n_nationkey", "n_name"]].rename(
        columns={"n_name": "cust_nation"})
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        n1, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    cust = customer[["c_custkey", "c_nationkey"]].merge(
        n2, left_on="c_nationkey", right_on="n_nationkey", how="inner",
        env=env)

    sd = lineitem.table.column("l_shipdate").data
    li = _filt(lineitem, (sd >= date_from) & (sd <= date_to), env)
    li = _with_revenue(li)[["l_orderkey", "l_suppkey", "revenue",
                            "l_shipdate"]]
    li = _with(li, "l_year", _year(li.table.column("l_shipdate").data))

    j = li.merge(orders[["o_orderkey", "o_custkey"]],
                 left_on="l_orderkey", right_on="o_orderkey",
                 how="inner", env=env)
    j = j.merge(cust, left_on="o_custkey", right_on="c_custkey",
                how="inner", env=env)
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey",
                how="inner", env=env)
    g = j.groupby(["supp_nation", "cust_nation", "l_year"], env=env).agg(
        [("revenue", "sum", "revenue")])
    t = g.table
    keep = ((_dict_mask(t.column("supp_nation"), [nation1])
             & _dict_mask(t.column("cust_nation"), [nation2]))
            | (_dict_mask(t.column("supp_nation"), [nation2])
               & _dict_mask(t.column("cust_nation"), [nation1])))
    g = _filt(g, keep, env)
    return g.sort_values(["supp_nation", "cust_nation", "l_year"],
                         env=env)[
        ["supp_nation", "cust_nation", "l_year", "revenue"]]


def q8(data: Mapping, env=None, nation: str = "BRAZIL",
       region: str = "AMERICA", ptype: str = "ECONOMY ANODIZED STEEL"
       ) -> DataFrame:
    """TPC-H Q8 (national market share): the :nation share of :region
    revenue for one part type, by order year.

    SELECT o_year, SUM(CASE WHEN nation = :nation THEN volume ELSE 0)
                   / SUM(volume) AS mkt_share
    FROM part, supplier, lineitem, orders, customer, nation n1,
         nation n2, region
    WHERE <star joins> AND r_name = :region
      AND o_orderdate IN [1995-01-01, 1996-12-31]
      AND p_type = :ptype
    GROUP BY o_year ORDER BY o_year
    """
    target = nation
    (part, supplier, lineitem, orders, customer, nations, reg
     ) = _tables(data, ["part", "supplier", "lineitem", "orders",
                        "customer", "nation", "region"], env)

    pf = _filt(part, _eq_str(part, "p_type", ptype), env)[["p_partkey"]]
    # customers restricted to the region (n1 ⋈ region pushdown)
    regk = _filt(reg, _eq_str(reg, "r_name", region), env)[["r_regionkey"]]
    n1 = nations.merge(regk, left_on="n_regionkey", right_on="r_regionkey",
                       how="inner", env=env)[["n_nationkey"]]
    cust = customer[["c_custkey", "c_nationkey"]].merge(
        n1, left_on="c_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    cust = cust[["c_custkey"]]
    # supplier nation name rides the supplier side (n2)
    n2 = nations[["n_nationkey", "n_name"]].rename(
        columns={"n_name": "supp_nation"})
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        n2, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    sup = sup[["s_suppkey", "supp_nation"]]

    od = orders.table.column("o_orderdate").data
    ords = _filt(orders, (od >= date_int(1995, 1, 1))
                 & (od <= date_int(1996, 12, 31)), env)
    ords = ords[["o_orderkey", "o_custkey", "o_orderdate"]]
    ords = _with(ords, "o_year", _year(ords.table.column("o_orderdate").data))
    ords = ords[["o_orderkey", "o_custkey", "o_year"]]

    li = _with_revenue(lineitem)[["l_partkey", "l_suppkey", "l_orderkey",
                                  "revenue"]]
    j = li.merge(pf, left_on="l_partkey", right_on="p_partkey",
                 how="inner", env=env)
    j = j.merge(ords, left_on="l_orderkey", right_on="o_orderkey",
                how="inner", env=env)
    j = j.merge(cust, left_on="o_custkey", right_on="c_custkey",
                how="inner", env=env)
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey",
                how="inner", env=env)
    # CASE -> masked-revenue column on the (possibly distributed) table
    t = j.table
    is_nat = _dict_mask(t.column("supp_nation"), [target])
    j = _with(j, "nation_rev", _where(is_nat, t.column("revenue")))
    g = j.groupby(["o_year"], env=env).agg([
        ("revenue", "sum", "total"),
        ("nation_rev", "sum", "nation_total"),
    ])
    # the share is elementwise on the (possibly distributed) result
    share = g.series("nation_total") / g.series("total")
    out = _with(g, "mkt_share", share.column)
    return out.sort_values(["o_year"], env=env)[["o_year", "mkt_share"]]


def q9(data: Mapping, env=None, color: str = "green") -> DataFrame:
    """TPC-H Q9 (product type profit): profit by nation and year over
    parts whose name contains :color.

    SELECT nation, o_year,
           SUM(l_extendedprice*(1-l_discount)
               - ps_supplycost*l_quantity) AS profit
    FROM part, supplier, lineitem, partsupp, orders, nation
    WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
      AND ps_partkey = l_partkey AND p_partkey = l_partkey
      AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
      AND p_name LIKE '%:color%'
    GROUP BY nation, o_year ORDER BY nation, o_year DESC
    """
    (part, supplier, lineitem, partsupp, orders, nation
     ) = _tables(data, ["part", "supplier", "lineitem", "partsupp",
                        "orders", "nation"], env)

    pf = _filt(part, _dict_mask(
        part.table.column("p_name"),
        pred=lambda v: v is not None and color in str(v)),
        env)[["p_partkey"]]
    nat = nation[["n_nationkey", "n_name"]].rename(
        columns={"n_name": "nation"})
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        nat, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    sup = sup[["s_suppkey", "nation"]]
    ords = _with(orders, "o_year",
                 _year(orders.table.column("o_orderdate").data))
    ords = ords[["o_orderkey", "o_year"]]

    li = lineitem[["l_partkey", "l_suppkey", "l_orderkey", "l_quantity",
                   "l_extendedprice", "l_discount"]]
    j = li.merge(pf, left_on="l_partkey", right_on="p_partkey",
                 how="inner", env=env)
    j = j.merge(partsupp[["ps_partkey", "ps_suppkey", "ps_supplycost"]],
                left_on=["l_partkey", "l_suppkey"],
                right_on=["ps_partkey", "ps_suppkey"],
                how="inner", env=env)
    j = j.merge(ords, left_on="l_orderkey", right_on="o_orderkey",
                how="inner", env=env)
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey",
                how="inner", env=env)
    t = j.table
    amount = (t.column("l_extendedprice").data
              * (1.0 - t.column("l_discount").data)
              - t.column("ps_supplycost").data
              * t.column("l_quantity").data)
    j = _with(j, "amount", Column(amount, None, dtypes.float64))
    g = j.groupby(["nation", "o_year"], env=env).agg(
        [("amount", "sum", "profit")])
    return g.sort_values(["nation", "o_year"], ascending=[True, False],
                         env=env)[["nation", "o_year", "profit"]]


def q11(data: Mapping, env=None, nation: str = "GERMANY",
        fraction: float = 0.0001) -> DataFrame:
    """TPC-H Q11 (important stock identification): partkeys whose stock
    value at :nation's suppliers exceeds :fraction of the total.

    SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) AS value
    FROM partsupp, supplier, nation
    WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
      AND n_name = :nation
    GROUP BY ps_partkey
    HAVING value > :fraction * SUM(... over the same set)
    ORDER BY value DESC
    """
    target = nation
    partsupp, supplier, nations = _tables(
        data, ["partsupp", "supplier", "nation"], env)

    natk = _filt(nations, _eq_str(nations, "n_name", target),
                 env)[["n_nationkey"]]
    sup = supplier[["s_suppkey", "s_nationkey"]].merge(
        natk, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    sup = sup[["s_suppkey"]]
    t = partsupp.table
    value = (t.column("ps_supplycost").data
             * t.column("ps_availqty").data)
    ps = _with(partsupp, "value", Column(value, None, dtypes.float64))
    ps = ps[["ps_partkey", "ps_suppkey", "value"]]
    j = ps.merge(sup, left_on="ps_suppkey", right_on="s_suppkey",
                 how="inner", env=env)
    g = j.groupby(["ps_partkey"], env=env).agg(
        [("value", "sum", "value")])
    # HAVING's total reduces over the world; the grouped result stays
    # on its ranks
    total = _agg_scalar(g, "value", "sum", env)
    keep = g.table.column("value").data > (fraction * total)
    out = _filt(g, keep, env)
    return out.sort_values(["value"], ascending=[False], env=env)[
        ["ps_partkey", "value"]]


def q2(data: Mapping, env=None, size: int = 15,
       type_suffix: str = "BRASS", region: str = "EUROPE",
       limit: int = 100) -> DataFrame:
    """TPC-H Q2 (minimum cost supplier): for each qualifying part, the
    region supplier(s) quoting the minimum supply cost.

    The correlated MIN subquery = groupby-min per part joined back on
    the int partkey, then an equality filter against the min — float
    keys never enter a join (min returns an existing value, so the
    equality is exact).

    SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr FROM part,
    supplier, partsupp, nation, region
    WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
      AND p_size = :size AND p_type LIKE '%:suffix'
      AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
      AND r_name = :region
      AND ps_supplycost = (SELECT MIN(ps_supplycost) ... same part+region)
    ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT :limit
    """
    part, supplier, partsupp, nations, reg = _tables(
        data, ["part", "supplier", "partsupp", "nation", "region"], env)

    regk = _filt(reg, _eq_str(reg, "r_name", region),
                 env)[["r_regionkey"]]
    nat = nations.merge(regk, left_on="n_regionkey",
                        right_on="r_regionkey", how="inner",
                        env=env)[["n_nationkey", "n_name"]]
    sup = supplier[["s_suppkey", "s_name", "s_acctbal",
                    "s_nationkey"]].merge(
        nat, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    pf = _filt(part,
               (part.table.column("p_size").data == size)
               & _dict_mask(part.table.column("p_type"),
                            pred=lambda v: v is not None
                            and str(v).endswith(type_suffix)), env)
    pf = pf[["p_partkey", "p_mfgr"]]

    ps = partsupp[["ps_partkey", "ps_suppkey", "ps_supplycost"]]
    j = ps.merge(sup, left_on="ps_suppkey", right_on="s_suppkey",
                 how="inner", env=env)
    j = j.merge(pf, left_on="ps_partkey", right_on="p_partkey",
                how="inner", env=env)
    mn = j.groupby(["ps_partkey"], env=env).agg(
        [("ps_supplycost", "min", "min_cost")])
    j = j.merge(mn, on="ps_partkey", how="inner", env=env)
    t = j.table
    keep = t.column("ps_supplycost").data == t.column("min_cost").data
    j = _filt(j, keep, env)
    out = j.sort_values(["s_acctbal", "n_name", "s_name", "ps_partkey"],
                        ascending=[False, True, True, True],
                        env=env).head(limit)
    return out[["s_acctbal", "s_name", "n_name", "ps_partkey", "p_mfgr"]]


def q13(data: Mapping, env=None, word1: str = "special",
        word2: str = "requests") -> DataFrame:
    """TPC-H Q13 (customer distribution): histogram of per-customer
    order counts, excluding orders whose comment matches
    '%:word1%:word2%'.

    SELECT c_count, COUNT(*) AS custdist FROM
      (SELECT c_custkey, COUNT(o_orderkey) AS c_count
       FROM customer LEFT JOIN orders ON c_custkey = o_custkey
        AND o_comment NOT LIKE '%:word1%:word2%'
       GROUP BY c_custkey)
    GROUP BY c_count ORDER BY custdist DESC, c_count DESC
    """
    customer, orders = _tables(data, ["customer", "orders"], env)

    keep = ~_like_seq(orders.table.column("o_comment"), word1, word2)
    ords = _filt(orders, keep, env)[["o_orderkey", "o_custkey"]]
    j = customer[["c_custkey"]].merge(
        ords, left_on="c_custkey", right_on="o_custkey", how="left",
        env=env)
    g = j.groupby(["c_custkey"], env=env).agg(
        [("o_orderkey", "count", "c_count")])
    g2 = g.groupby(["c_count"], env=env).agg(
        [("c_custkey", "count", "custdist")])
    return g2.sort_values(["custdist", "c_count"],
                          ascending=[False, False], env=env)[
        ["c_count", "custdist"]]


def q15(data: Mapping, env=None, date_from: int | None = None,
        date_to: int | None = None) -> DataFrame:
    """TPC-H Q15 (top supplier): supplier(s) with the maximum revenue
    in a quarter (the revenue VIEW = a groupby; the = MAX correlated
    filter happens on the tiny grouped result).

    SELECT s_suppkey, s_name, total_revenue FROM supplier,
      (SELECT l_suppkey, SUM(l_extendedprice*(1-l_discount)) AS
       total_revenue FROM lineitem WHERE l_shipdate IN [:from, :from+3mo)
       GROUP BY l_suppkey) revenue
    WHERE s_suppkey = l_suppkey AND total_revenue = (SELECT MAX(...))
    ORDER BY s_suppkey
    """
    if date_from is None:
        date_from = date_int(1996, 1, 1)
    if date_to is None:
        date_to = date_int(1996, 4, 1)
    supplier, lineitem = _tables(data, ["supplier", "lineitem"], env)

    sd = lineitem.table.column("l_shipdate").data
    li = _filt(lineitem, (sd >= date_from) & (sd < date_to), env)
    li = _with_revenue(li)[["l_suppkey", "revenue"]]
    g = li.groupby(["l_suppkey"], env=env).agg(
        [("revenue", "sum", "total_revenue")])
    # MAX over the revenue view: over the world when distributed
    mx = _agg_scalar(g, "total_revenue", "max", env)
    top = _filt(g, g.table.column("total_revenue").data >= mx, env)
    out = top.merge(supplier[["s_suppkey", "s_name"]],
                    left_on="l_suppkey", right_on="s_suppkey",
                    how="inner", env=env)
    return out.sort_values(["s_suppkey"], env=env)[
        ["s_suppkey", "s_name", "total_revenue"]]


def q17(data: Mapping, env=None, brand: str = "Brand#23",
        container: str = "MED BOX"):
    """TPC-H Q17 (small-quantity-order revenue), a scalar: weekly
    revenue lost if small orders of one brand/container went unfilled.
    The per-part AVG subquery = groupby-mean joined back on partkey.

    SELECT SUM(l_extendedprice) / 7.0 FROM lineitem, part
    WHERE p_partkey = l_partkey AND p_brand = :brand
      AND p_container = :container
      AND l_quantity < 0.2 * (SELECT AVG(l_quantity) ... same part)
    """
    part, lineitem = _tables(data, ["part", "lineitem"], env)

    pf = _filt(part,
               _dict_mask(part.table.column("p_brand"), [brand])
               & _dict_mask(part.table.column("p_container"), [container]),
               env)
    pf = pf[["p_partkey"]]
    li = lineitem[["l_partkey", "l_quantity", "l_extendedprice"]]
    j = li.merge(pf, left_on="l_partkey", right_on="p_partkey",
                 how="inner", env=env)
    avg = j.groupby(["l_partkey"], env=env).agg(
        [("l_quantity", "mean", "avg_qty")])
    avg = avg.rename(columns={"l_partkey": "a_partkey"})
    j = j.merge(avg, left_on="l_partkey", right_on="a_partkey",
                how="inner", env=env)
    t = j.table
    small = (t.column("l_quantity").data
             < 0.2 * t.column("avg_qty").data)
    j = _with(j, "sel_price", _where(small, t.column("l_extendedprice")))
    return _agg_scalar(j, "sel_price", "sum", env) / 7.0


def q16(data: Mapping, env=None, brand: str = "Brand#45",
        type_prefix: str = "MEDIUM POLISHED",
        sizes=(49, 14, 23, 45, 19, 3, 36, 9)) -> DataFrame:
    """TPC-H Q16 (parts/supplier relationship): distinct supplier counts
    per (brand, type, size), excluding one brand, a type prefix, and
    complaint-flagged suppliers. The NOT IN supplier subquery inverts
    into a semi-join with the GOOD suppliers (supplier is the small
    table — pushdown, no anti-join on the big side).

    SELECT p_brand, p_type, p_size, COUNT(DISTINCT ps_suppkey)
    FROM partsupp, part WHERE p_partkey = ps_partkey
      AND p_brand <> :brand AND p_type NOT LIKE ':prefix%'
      AND p_size IN :sizes AND ps_suppkey NOT IN
        (SELECT s_suppkey FROM supplier
         WHERE s_comment LIKE '%Customer%Complaints%')
    GROUP BY 1,2,3 ORDER BY 4 DESC, 1, 2, 3
    """
    part, partsupp, supplier = _tables(
        data, ["part", "partsupp", "supplier"], env)

    good = _filt(supplier, ~_like_seq(
        supplier.table.column("s_comment"), "Customer", "Complaints"), env)
    good = good[["s_suppkey"]]
    t = part.table
    sizes_arr = plan.staged(np.asarray(sizes, np.int64), t.device)
    pmask = (~_dict_mask(t.column("p_brand"), [brand])
             & ~_dict_mask(t.column("p_type"),
                           pred=lambda v: v is not None
                           and str(v).startswith(type_prefix))
             & (t.column("p_size").data[:, None]
                == sizes_arr[None, :]).any(dim=1))
    pf = _filt(part, pmask, env)[["p_partkey", "p_brand", "p_type",
                                  "p_size"]]
    j = partsupp[["ps_partkey", "ps_suppkey"]].merge(
        pf, left_on="ps_partkey", right_on="p_partkey", how="inner",
        env=env)
    j = j.merge(good, left_on="ps_suppkey", right_on="s_suppkey",
                how="inner", env=env)
    g = j.groupby(["p_brand", "p_type", "p_size"], env=env).agg(
        [("ps_suppkey", "nunique", "supplier_cnt")])
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True], env=env)[
        ["p_brand", "p_type", "p_size", "supplier_cnt"]]


def q20(data: Mapping, env=None, color: str = "forest",
        nation: str = "CANADA", date_from: int | None = None,
        date_to: int | None = None) -> DataFrame:
    """TPC-H Q20 (potential part promotion): :nation suppliers holding
    excess stock (> half a year's shipments) of :color parts.

    SELECT s_name FROM supplier, nation
    WHERE s_suppkey IN
      (SELECT ps_suppkey FROM partsupp WHERE ps_partkey IN
         (SELECT p_partkey FROM part WHERE p_name LIKE ':color%')
       AND ps_availqty > 0.5 * (SELECT SUM(l_quantity) FROM lineitem
            WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
            AND l_shipdate IN [:from, :from+1y)))
      AND s_nationkey = n_nationkey AND n_name = :nation
    ORDER BY s_name
    """
    target = nation
    part, partsupp, lineitem, supplier, nations = _tables(
        data, ["part", "partsupp", "lineitem", "supplier", "nation"], env)
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)

    pf = _filt(part, _dict_mask(
        part.table.column("p_name"),
        pred=lambda v: v is not None
        and str(v).startswith(color)), env)[["p_partkey"]]
    sd = lineitem.table.column("l_shipdate").data
    li = _filt(lineitem, (sd >= date_from) & (sd < date_to), env)
    li = li[["l_partkey", "l_suppkey", "l_quantity"]]
    shipped = li.groupby(["l_partkey", "l_suppkey"], env=env).agg(
        [("l_quantity", "sum", "qty_sum")])
    ps = partsupp[["ps_partkey", "ps_suppkey", "ps_availqty"]]
    j = ps.merge(pf, left_on="ps_partkey", right_on="p_partkey",
                 how="inner", env=env)
    # empty shipment sums are NULL in SQL -> comparison false -> the
    # inner join (pairs with shipments only) is the faithful semantics
    j = j.merge(shipped, left_on=["ps_partkey", "ps_suppkey"],
                right_on=["l_partkey", "l_suppkey"], how="inner",
                env=env)
    t = j.table
    keep = (t.column("ps_availqty").data.to(torch.float64)
            > 0.5 * t.column("qty_sum").data)
    cand = _filt(j, keep, env)[["ps_suppkey"]].drop_duplicates(
        ["ps_suppkey"], env=env)
    natk = _filt(nations, _eq_str(nations, "n_name", target),
                 env)[["n_nationkey"]]
    sup = supplier[["s_suppkey", "s_name", "s_nationkey"]].merge(
        natk, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    out = cand.merge(sup, left_on="ps_suppkey", right_on="s_suppkey",
                     how="inner", env=env)
    return out.sort_values(["s_name"], env=env)[["s_name"]]


def q21(data: Mapping, env=None, nation: str = "SAUDI ARABIA",
        limit: int = 100) -> DataFrame:
    """TPC-H Q21 (suppliers who kept orders waiting): per supplier, the
    multi-supplier 'F' orders where ONLY that supplier delivered late.

    The EXISTS / NOT EXISTS pair compiles into two per-order distinct
    counts: total distinct suppliers (>= 2) and distinct LATE suppliers
    (== 1); a late lineitem's supplier waits iff both hold.

    SELECT s_name, COUNT(*) AS numwait FROM supplier, lineitem l1,
    orders, nation WHERE s_suppkey = l1.l_suppkey
      AND o_orderkey = l1.l_orderkey AND o_orderstatus = 'F'
      AND l1.l_receiptdate > l1.l_commitdate
      AND EXISTS (l2: same order, other supplier)
      AND NOT EXISTS (l3: same order, other supplier, late)
      AND s_nationkey = n_nationkey AND n_name = :nation
    GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT :limit
    """
    target = nation
    supplier, lineitem, orders, nations = _tables(
        data, ["supplier", "lineitem", "orders", "nation"], env)

    t = lineitem.table
    late_mask = (t.column("l_receiptdate").data
                 > t.column("l_commitdate").data)
    pairs = lineitem[["l_orderkey", "l_suppkey"]].drop_duplicates(
        ["l_orderkey", "l_suppkey"], env=env)
    nsupp = pairs.groupby(["l_orderkey"], env=env).agg(
        [("l_suppkey", "count", "nsupp")])
    late_pairs = _filt(lineitem, late_mask, env)[
        ["l_orderkey", "l_suppkey"]].drop_duplicates(
        ["l_orderkey", "l_suppkey"], env=env)
    nlate = late_pairs.groupby(["l_orderkey"], env=env).agg(
        [("l_suppkey", "count", "nlate")])
    nlate = nlate.rename(columns={"l_orderkey": "lo"})

    of = _filt(orders, _eq_str(orders, "o_orderstatus", "F"),
               env)[["o_orderkey"]]
    # COUNT(*) counts qualifying late l1 ROWS (spec), so the final path
    # joins the raw late rows, not the deduped pairs (those only feed
    # the per-order distinct counts above)
    late_rows = _filt(lineitem, late_mask, env)[
        ["l_orderkey", "l_suppkey"]]
    j = late_rows.merge(of, left_on="l_orderkey", right_on="o_orderkey",
                        how="inner", env=env)
    j = j.merge(nsupp, on="l_orderkey", how="inner", env=env)
    j = j.merge(nlate, left_on="l_orderkey", right_on="lo", how="inner",
                env=env)
    tt = j.table
    keep = ((tt.column("nsupp").data >= 2)
            & (tt.column("nlate").data == 1))
    j = _filt(j, keep, env)
    natk = _filt(nations, _eq_str(nations, "n_name", target),
                 env)[["n_nationkey"]]
    sup = supplier[["s_suppkey", "s_name", "s_nationkey"]].merge(
        natk, left_on="s_nationkey", right_on="n_nationkey", how="inner",
        env=env)
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey",
                how="inner", env=env)
    g = j.groupby(["s_name"], env=env).agg(
        [("l_orderkey", "count", "numwait")])
    return g.sort_values(["numwait", "s_name"],
                         ascending=[False, True], env=env).head(limit)[
        ["s_name", "numwait"]]


def q22(data: Mapping, env=None,
        codes=("13", "31", "23", "29", "30", "18", "17")) -> DataFrame:
    """TPC-H Q22 (global sales opportunity): idle customers with
    above-average balances in selected phone country codes.

    SELECT cntrycode, COUNT(*) AS numcust, SUM(c_acctbal) AS totacctbal
    FROM (SELECT SUBSTRING(c_phone, 1, 2) AS cntrycode, c_acctbal
          FROM customer WHERE SUBSTRING(c_phone, 1, 2) IN :codes
          AND c_acctbal > (SELECT AVG(c_acctbal) FROM customer
                           WHERE c_acctbal > 0 AND code IN :codes)
          AND NOT EXISTS (SELECT * FROM orders
                          WHERE o_custkey = c_custkey))
    GROUP BY cntrycode ORDER BY cntrycode

    SUBSTRING maps over the host dictionary (``Series.map``); the NOT
    EXISTS anti-join = left join on distinct order custkeys + null
    filter.
    """
    customer, orders = _tables(data, ["customer", "orders"], env)

    code = customer.series("c_phone").map(lambda v: str(v)[:2])
    cust = _with(customer, "cntrycode", code.column)
    cust = _filt(cust, _dict_mask(cust.table.column("cntrycode"),
                                  list(codes)), env)
    cust = cust[["c_custkey", "c_acctbal", "cntrycode"]]
    bal = cust.table.column("c_acctbal").data
    pos = _filt(cust, bal > 0.0, env)
    avg = _agg_scalar(pos, "c_acctbal", "mean", env)
    cand = _filt(cust, cust.table.column("c_acctbal").data > avg, env)

    active = orders[["o_custkey"]].drop_duplicates(["o_custkey"],
                                                   env=env)
    j = cand.merge(active, left_on="c_custkey", right_on="o_custkey",
                   how="left", env=env)
    nul = j.table.column("o_custkey")
    no_orders = (torch.zeros(j.table.capacity, dtype=torch.bool,
                             device=j.table.device)
                 if nul.validity is None else ~nul.validity)
    idle = _filt(j, no_orders, env)
    g = idle.groupby(["cntrycode"], env=env).agg([
        ("c_custkey", "count", "numcust"),
        ("c_acctbal", "sum", "totacctbal"),
    ])
    return g.sort_values(["cntrycode"], env=env)[
        ["cntrycode", "numcust", "totacctbal"]]
