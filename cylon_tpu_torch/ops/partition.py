"""Partition ids by the first key modulo the number of partitions.

Port of ``modulo_partition_ids`` from ``cylon_tpu/ops/partition.py:37``
(parity: ``ModuloPartitionKernel``, ``arrow_partition_kernels.cpp:67``);
hash partition ids are :func:`cylon_tpu_torch.ops.hash.partition_ids`.
"""

from typing import Sequence

import torch

from cylon_tpu_torch.errors import InvalidArgument


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
