"""Distributed execution of the port: communicators, shuffle, dist ops
(mirrors ``cylon_tpu/parallel``)."""

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
           "task_view"]
