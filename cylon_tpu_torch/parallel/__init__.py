"""Distributed execution of the port: communicators, shuffle, dist ops
(mirrors ``cylon_tpu/parallel``), with the pycylon-style
``distributed_*`` aliases.

``dtable.is_distributed``, ``local_capacity`` and ``dist_row_mask`` of
the JAX package are absent: they read a mesh-sharded table (one
``[W]`` row-count vector over W blocks) that the SPMD port does not
have. Here every table is one rank's shard: its ``capacity`` is the
local capacity and its valid rows are ``kernels.valid_mask(capacity,
nrows)``; :func:`dist_num_rows` and ``dtable.shard_sizes`` give the
world's counts.
"""

from cylon_tpu_torch.parallel.collectives import ReduceOp, all_reduce
from cylon_tpu_torch.parallel.dist_ops import (
    SortOptions, colocated_groupby, colocated_join, colocated_unique,
    dist_aggregate, dist_concat, dist_filter, dist_groupby, dist_head,
    dist_intersect, dist_join, dist_sort, dist_subtract, dist_union,
    dist_unique, repartition, shuffle)
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, dist_to_pandas,
                                             gather_table, scatter_table)
from cylon_tpu_torch.parallel.task_plan import (TASK_COL, LogicalTaskPlan,
                                                task_shuffle, task_tables,
                                                task_view)

__all__ = ["all_reduce", "colocated_groupby", "colocated_join",
           "colocated_unique", "dist_aggregate", "dist_concat", "dist_filter",
           "dist_groupby", "dist_head", "dist_intersect", "dist_join",
           "dist_num_rows", "dist_sort", "dist_subtract", "dist_to_pandas",
           "dist_union", "dist_unique", "gather_table", "LogicalTaskPlan",
           "ReduceOp", "repartition", "scatter_table", "shuffle",
           "SortOptions", "TASK_COL", "task_shuffle", "task_tables",
           "task_view", "distributed_join", "distributed_sort",
           "distributed_union", "distributed_intersect",
           "distributed_subtract", "distributed_unique",
           "distributed_concat"]

# pycylon-style names (table.pyx distributed_join/...): aliases so
# reference scripts port mechanically (``cylon_tpu/parallel/__init__.py:86``)
distributed_join = dist_join
distributed_sort = dist_sort
distributed_union = dist_union
distributed_intersect = dist_intersect
distributed_subtract = dist_subtract
distributed_unique = dist_unique
distributed_concat = dist_concat
