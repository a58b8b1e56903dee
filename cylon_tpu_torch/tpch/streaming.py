"""Out-of-core TPC-H: Q1 and Q5 as chunked streams over lineitem.

Port of ``cylon_tpu/tpch/streaming.py``. These variants stream lineitem
in fixed-size chunks through the same device ops, so the device never
holds more than one chunk of it: structurally the reference's streaming
op-graph (``ops/dis_join_op.cpp:21-72``) with host memory as the
inter-stage buffer:

- ``q1_ooc``: per chunk filter + derived columns + device pre-combine
  (sums/counts; averages decompose), partials accumulate on host, one
  final combine — chunked ``DistributedHashGroupBy`` structure
  (``groupby/groupby.cpp:62-78``).
- ``q5_ooc``: the small relations build in-core exactly as
  :func:`cylon_tpu_torch.tpch.queries.q5` does (orders⋈customer ~2M rows,
  supplier⋈nation⋈region ~100k); lineitem streams against the build
  sides chunk by chunk (chunked probe side of ``DisJoinOp``), each
  chunk's revenue pre-combines by nation.

Both return the same frame as their in-core twins (held against them
and against pandas at small SF in ``tests/test_torch_fallback.py``).
Each chunk's tables are built on ``device`` (``None``: CUDA).

Both drivers are PIPELINED through ``ooc_groupby``'s shared ingest
funnel (:mod:`cylon_tpu_torch.pipeline`): chunk k+1's pull/decode runs on a
prefetch worker while chunk k's filter+pre-combine computes on-device,
and per-chunk checkpoint commits (``resume_dir=``) overlap the next
chunk on the async writer — ``CYLON_TPU_OOC_PREFETCH_DEPTH=0``
restores the sequential behaviour.
"""

from typing import Iterable, Mapping

import numpy as np

from cylon_tpu_torch import device as _device
from cylon_tpu_torch.frame import DataFrame
from cylon_tpu_torch.tpch.dbgen import date_int
from cylon_tpu_torch.tpch.queries import _df, _eq_str

__all__ = ["q1_ooc", "q5_ooc", "lineitem_chunks"]


def lineitem_chunks(data: Mapping, columns, chunk_rows: int
                    ) -> Iterable[dict]:
    """Slice the host lineitem mapping into column-pruned chunks
    (the storage-scan projection; a parquet deployment would use
    ``io.read_parquet_chunks(path, chunk_rows, columns=...)`` here —
    same contract, chunks of host columns)."""
    li = data["lineitem"]
    cols = {c: np.asarray(li[c]) for c in columns}
    n = len(next(iter(cols.values())))
    for lo in range(0, n, chunk_rows):
        yield {k: v[lo:lo + chunk_rows] for k, v in cols.items()}


def q1_ooc(data: Mapping, chunk_rows: int = 1 << 22,
           cutoff: int | None = None,
           resume_dir: str | None = None, device=None) -> DataFrame:
    """Q1, out-of-core: device never holds more than one chunk.
    ``resume_dir`` checkpoints every chunk's partial aggregate so a
    killed run resumes instead of restarting."""
    from cylon_tpu_torch.outofcore import ooc_groupby

    dev = _device.resolve(device)
    if cutoff is None:
        cutoff = date_int(1998, 9, 2)
    need = ["l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]

    def transform(chunk):
        df = _df(dict(chunk), dev)
        m = df.table.column("l_shipdate").data <= cutoff
        li = df.filter(m)
        price = li.series("l_extendedprice")
        disc = li.series("l_discount")
        disc_price = price * (1 - disc)
        charge = disc_price * (1 + li.series("l_tax"))
        t = li.table.add_column("disc_price", disc_price.column)
        return t.add_column("charge", charge.column)

    # averages decompose: partial = sums + count, final avg =
    # sum_of_sums / sum_of_counts. The source is a zero-arg callable
    # returning a FRESH generator: ooc passes require replayable
    # sources (a resume or a retry re-iterates them from the top)
    out = ooc_groupby(
        lambda: lineitem_chunks(data, need, chunk_rows),
        ["l_returnflag", "l_linestatus"],
        [("l_quantity", "sum", "sum_qty"),
         ("l_extendedprice", "sum", "sum_base_price"),
         ("disc_price", "sum", "sum_disc_price"),
         ("charge", "sum", "sum_charge"),
         ("l_discount", "sum", "sum_disc"),
         ("l_quantity", "count", "count_order")],
        chunk_rows=chunk_rows, transform=transform,
        resume_dir=resume_dir, device=dev)
    g = DataFrame._wrap(out)
    cnt = g.series("count_order")
    for num, name in (("sum_qty", "avg_qty"),
                      ("sum_base_price", "avg_price"),
                      ("sum_disc", "avg_disc")):
        t2 = g.table.add_column(name, (g.series(num) / cnt).column)
        g = DataFrame._wrap(t2)
    g = g[["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
           "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
           "avg_disc", "count_order"]]
    return g.sort_values(["l_returnflag", "l_linestatus"])


def q5_ooc(data: Mapping, chunk_rows: int = 1 << 22,
           region: str = "ASIA", date_from: int | None = None,
           date_to: int | None = None,
           resume_dir: str | None = None, device=None) -> DataFrame:
    """Q5, out-of-core: build sides in-core, lineitem streamed.
    ``resume_dir``: per-chunk checkpoint/resume like :func:`q1_ooc`."""
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)
    from cylon_tpu_torch.ops.join import join

    dev = _device.resolve(device)
    customer = _df({k: np.asarray(v) for k, v in
                    data["customer"].items()
                    if k in ("c_custkey", "c_nationkey")}, dev)
    orders = _df({k: np.asarray(v) for k, v in data["orders"].items()
                  if k in ("o_orderkey", "o_custkey", "o_orderdate")}, dev)
    supplier = _df({k: np.asarray(v) for k, v in
                    data["supplier"].items()
                    if k in ("s_suppkey", "s_nationkey")}, dev)
    nation = _df({k: np.asarray(v) for k, v in data["nation"].items()
                  if k in ("n_nationkey", "n_name", "n_regionkey")}, dev)
    reg = _df({k: np.asarray(v) for k, v in data["region"].items()
               if k in ("r_regionkey", "r_name")}, dev)

    reg = reg.filter(_eq_str(reg, "r_name", region))[["r_regionkey"]]
    nat = nation.merge(reg, left_on="n_regionkey",
                       right_on="r_regionkey",
                       how="inner")[["n_nationkey", "n_name"]]
    sup = supplier.merge(nat, left_on="s_nationkey",
                         right_on="n_nationkey",
                         how="inner")[["s_suppkey", "s_nationkey",
                                       "n_name"]]
    od = orders.table.column("o_orderdate").data
    ords = orders.filter((od >= date_from) & (od < date_to))
    oc = ords[["o_orderkey", "o_custkey"]].merge(
        customer[["c_custkey", "c_nationkey"]],
        left_on="o_custkey", right_on="c_custkey", how="inner")
    oc = oc[["o_orderkey", "c_nationkey"]]

    need = ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"]

    def transform(chunk):
        li = _df(dict(chunk), dev)
        rev = (li.series("l_extendedprice")
               * (1 - li.series("l_discount")))
        t = li.table.add_column("revenue", rev.column)
        t = t.select(["l_orderkey", "l_suppkey", "revenue"])
        j = join(t, oc.table, left_on=["l_orderkey"],
                 right_on=["o_orderkey"], how="inner", ordered=False)
        return join(j, sup.table,
                    left_on=["l_suppkey", "c_nationkey"],
                    right_on=["s_suppkey", "s_nationkey"], how="inner",
                    ordered=False)

    from cylon_tpu_torch.outofcore import ooc_groupby

    out = ooc_groupby(lambda: lineitem_chunks(data, need, chunk_rows),
                      ["n_name"], [("revenue", "sum", "revenue")],
                      chunk_rows=chunk_rows, transform=transform,
                      resume_dir=resume_dir, device=dev)
    g = DataFrame._wrap(out).sort_values(["revenue"], ascending=[False])
    return g[["n_name", "revenue"]]
