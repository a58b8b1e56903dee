"""Relational operators of the port (mirrors ``cylon_tpu/ops``). The
``join`` function stays ``cylon_tpu_torch.join``: here the name is its
module's."""

from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.aggregates import table_aggregate
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.ops.hash import hash_columns
from cylon_tpu_torch.ops.selection import (concat_tables, filter_table, head,
                                           sample, sort_table, take)
from cylon_tpu_torch.ops.setops import (equal_tables, intersect, subtract,
                                        union, unique)

__all__ = ["concat_tables", "equal_tables", "filter_table",
           "groupby_aggregate", "hash_columns", "head", "intersect",
           "kernels", "sample", "sort_table", "subtract", "table_aggregate",
           "take", "union", "unique"]
