"""Partition ids and the local split.

Port of ``cylon_tpu/ops/partition.py`` (parity:
``cpp/src/cylon/partition/partition.{hpp,cpp}``, ``MapToHashPartitions``
and ``Split``, and the kernels of ``arrow/arrow_partition_kernels.cpp``:
murmur ``HashPartitionKernel``, ``ModuloPartitionKernel``; the Java
surface's round robin, ``Table.java:191``). Range partitioning lives with
``dist_sort`` (:mod:`cylon_tpu_torch.parallel.dist_ops`), as in the
reference. ``Split``'s map of partition to table becomes a list of
capacity-bounded tables, each compacted by its partition's mask.
"""

from typing import Sequence

import torch

from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.hash import partition_ids
from cylon_tpu_torch.ops.selection import take_columns

__all__ = ["hash_partition_ids", "modulo_partition_ids",
           "round_robin_ids", "assign_partitions", "split_by_partition",
           "partition_table"]

#: murmur row hash % nparts (:func:`cylon_tpu_torch.ops.hash.partition_ids`)
hash_partition_ids = partition_ids


def modulo_partition_ids(arrays: Sequence[torch.Tensor],
                         num_partitions: int) -> torch.Tensor:
    """|first key mod nparts| as int32 (port of
    ``cylon_tpu/ops/partition.py:37``): the reference's cheap path for
    integer keys that are already uniform (one key column, as there)."""
    a = arrays[0]
    if a.is_floating_point() or a.is_complex() or a.dtype == torch.bool \
            or a.dim() != 1:
        raise InvalidArgument(
            f"modulo partitioning needs an integer key, got {a.dtype}")
    v = a.view(torch.int64) if a.dtype == torch.uint64 else a.to(torch.int64)
    return torch.abs(torch.remainder(v, num_partitions)).to(torch.int32)


def round_robin_ids(nrows_or_cap, num_partitions: int, offset=0,
                    device=None) -> torch.Tensor:
    """Row index plus ``offset``, modulo nparts (port of
    ``cylon_tpu/ops/partition.py:49``; parity ``roundRobinPartition``)."""
    cap = int(nrows_or_cap)
    return ((offset + torch.arange(cap, dtype=torch.int64, device=device))
            % num_partitions).to(torch.int32)


def assign_partitions(table, cols: Sequence[str], num_partitions: int,
                      mode: str = "hash") -> torch.Tensor:
    """[capacity] int32 partition id a row, by ``mode``: ``"hash"``,
    ``"modulo"`` or ``"round_robin"`` (port of
    ``cylon_tpu/ops/partition.py:58``)."""
    keys = [table.column(c).data for c in cols]
    vals = [table.column(c).validity for c in cols]
    if mode == "hash":
        return partition_ids(keys, num_partitions, vals)
    if mode == "modulo":
        return modulo_partition_ids(keys, num_partitions)
    if mode == "round_robin":
        return round_robin_ids(table.capacity, num_partitions,
                               device=table.device)
    raise InvalidArgument(f"unknown partition mode {mode!r}")


def split_by_partition(table, pid: torch.Tensor, num_partitions: int,
                       out_capacity: "int | None" = None) -> list:
    """One compacted table a partition id, rows in their order (port of
    ``cylon_tpu/ops/partition.py:73``; parity ``Split``,
    ``partition/partition.cpp:26-92``). Each has capacity
    ``out_capacity`` (default the input's); a partition with more rows is
    poisoned (``nrows = out_capacity + 1``), so that ``num_rows`` raises
    instead of truncating quietly."""
    cap = table.capacity
    out_cap = out_capacity if out_capacity is not None else cap
    vmask = kernels.valid_mask(cap, table.nrows, table.device)
    outs = []
    for p in range(num_partitions):
        perm, n = kernels.compact_mask(vmask & (pid == p), table.nrows)
        idx = perm[:out_cap] if out_cap <= cap else torch.cat(
            [perm, torch.zeros(out_cap - cap, dtype=perm.dtype,
                               device=perm.device)])
        outs.append(take_columns(table, idx,
                                 torch.where(n > out_cap, out_cap + 1, n)))
    return outs


def partition_table(table, cols: Sequence[str], num_partitions: int,
                    mode: str = "hash",
                    out_capacity: "int | None" = None) -> list:
    """``HashPartition`` (``table.hpp:338``): assign, then split (port of
    ``cylon_tpu/ops/partition.py:93``)."""
    pid = assign_partitions(table, cols, num_partitions, mode)
    return split_by_partition(table, pid, num_partitions, out_capacity)
