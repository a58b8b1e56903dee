"""cylon_tpu_torch: the PyTorch/CUDA port of cylon_tpu.

The JAX package ``cylon_tpu`` stays the reference; this package runs the
same relational engine on NVIDIA GPUs with hand-written CUDA kernels
(``csrc/``) where the JAX package has Pallas kernels. It imports torch and
numpy, never JAX. Tables are built on CUDA by default; pass
``device="cpu"`` to run on the CPU.

The port carries the distributed equi-join: hash partition
(``ops.hash``), exchange (``parallel.shuffle``), sort join (``ops.join``)
and bucketed hash join (``ops.hash_join``), output gather
(``ops.selection``) and ``dist_join``, on numeric keys and on string keys
in both storages: dictionary codes (``ops.dictenc``) and device bytes
(``ops.bytescol``; ``string_storage=`` at ingest).
"""

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column, Dictionary
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import (CylonError, DeviceUnavailable,
                                    InvalidArgument, KeyError_,
                                    NotImplemented_, OutOfCapacity,
                                    TypeError_)
from cylon_tpu_torch.ops.join import join
from cylon_tpu_torch.parallel.comm import LocalComm, ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import dist_join
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, gather_table,
                                             scatter_table)
from cylon_tpu_torch.row import Row
from cylon_tpu_torch.table import Table

__all__ = ["Column", "CylonEnv", "CylonError", "DeviceUnavailable",
           "Dictionary", "InvalidArgument", "KeyError_", "LocalComm",
           "NotImplemented_", "OutOfCapacity", "Row", "Table", "ThreadWorld",
           "TypeError_", "dist_join", "dist_num_rows", "dtypes",
           "gather_table", "join", "scatter_table"]
