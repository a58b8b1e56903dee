"""cylon_tpu_torch: the PyTorch/CUDA port of cylon_tpu.

The JAX package ``cylon_tpu`` stays the reference; this package runs the
same relational engine on NVIDIA GPUs with hand-written CUDA kernels
(``csrc/``) where the JAX package has Pallas kernels. It imports torch and
numpy, never JAX. Tables are built on CUDA by default; pass
``device="cpu"`` to run on the CPU.

The port carries:

- the distributed equi-join: hash partition (``ops.hash``), exchange
  (``parallel.shuffle``), sort join (``ops.join``) and bucketed hash join
  (``ops.hash_join``), output gather (``ops.selection``) and
  ``dist_join``;
- the generic ``shuffle`` (hash or modulo partitioning) and the
  round-robin ``repartition``;
- group-by and scalar aggregates: ``groupby_aggregate`` (``ops.groupby``),
  ``table_aggregate`` (``ops.aggregates``), ``dist_groupby`` and
  ``dist_aggregate``;
- sort, filter, concat, head, sample and take (``ops.selection``), the
  set ops and ``unique`` (``ops.setops``), partitioning
  (``ops.partition``), calendar fields (``ops.datetime_ops``); their
  distributed forms ``dist_sort`` (sample or histogram splitters,
  ``SortOptions``), ``dist_union``, ``dist_intersect``,
  ``dist_subtract``, ``dist_unique``, ``dist_filter``, ``dist_head``,
  ``dist_concat``, the ``colocated_*`` ops, and the collectives
  (``parallel.collectives``);
- numeric keys and string keys in both storages: dictionary codes
  (``ops.dictenc``) and device bytes (``ops.bytescol``;
  ``string_storage=`` at ingest);
- three communicators (``parallel.comm``): ``LocalComm`` (one rank),
  ``ThreadWorld`` (W ranks as threads, for tests) and
  ``ProcessGroupComm`` over ``torch.distributed`` (NCCL on the cards,
  gloo on the CPU), which ``CylonEnv(config=DistConfig())`` sets up:
  ``torchrun --nproc-per-node W prog.py`` runs W ranks; the two-tier
  (node x GPU) world of the JAX package's slice x worker mesh, whose
  table exchange moves rows inside each node first
  (``DistConfig(devices_per_slice=)``, or ``torchrun`` across nodes;
  ``ThreadWorld(W, devices_per_slice=L)`` in tests);
- the user-facing layer: ``DataFrame`` / ``Series`` (``frame``,
  ``series``; ``env=`` dispatches the distributed ops, and a
  distributed frame is this rank's shard), ``loc`` / ``iloc`` over
  value indexes (``indexing``), CSV / Parquet / JSON io (``io``), the
  streaming operator graph (``ops_graph``), the task overlay
  (``parallel.task_plan``), the option structs (``config``) and the
  eager regrow ladder (``plan``);
- the telemetry core (``telemetry``): the metric registry and its JSONL /
  Prometheus exporters (``CYLON_TPU_METRICS_DIR``), the flight recorder
  (``CYLON_TPU_TRACE``) with Chrome-trace export and critical-path
  attribution, device-memory sampling (``telemetry.memory``), and the
  spans, stage spans and counters the dist ops, the exchange, the join
  router, the operator graph and ``CompiledQuery`` feed them; logging
  and spans in ``utils``. The package logger ``cylon_tpu_torch``
  propagates to the application's logging until
  ``utils.init_logging()`` is called, which attaches the JAX package's
  glog-style stderr handler (rank prefix, ``CYLON_LOG_LEVEL``); the JAX
  package attaches it at import;
- resilience, deadlines and the spill path: fault plans, retry/backoff,
  row accounting, the spill store and checkpoints (``resilience``:
  ``FaultPlan``, ``FaultRule``, ``RetryPolicy``), deadline scopes and
  bounded sections with stall dumps (``watchdog``: ``deadline``), the
  prefetch and async-commit pipeline (``pipeline``), the out-of-core
  join, group-by and sort that spill partitions to host memory
  (``outofcore``), and the OOM→spill fallback with its TPC-H plans
  (``fallback``, ``tpch.twophase``, ``tpch.streaming``);
- the native host library (``native``, imported by name, as in
  ``cylon_tpu``): the C++ host runtime behind the JAX package's C ABI,
  built with ``g++`` at first use, which ``read_csv(engine="native")``
  and ``catalog.to_native`` / ``from_native`` use.
"""

from cylon_tpu_torch import dtypes, plan, telemetry
from cylon_tpu_torch.column import Column, Dictionary
from cylon_tpu_torch.config import (CSVReadOptions, CSVWriteOptions,
                                    DeadlinePolicy, JoinAlgorithm,
                                    JoinConfig, JoinType, ParquetOptions,
                                    RetryPolicy)
from cylon_tpu_torch.context import CommConfig, CylonEnv, DistConfig, \
    LocalConfig
from cylon_tpu_torch.errors import (Code, CylonError, DataLossError,
                                    DeadlineExceeded, DeviceUnavailable,
                                    FailedPrecondition, IndexError_,
                                    InvalidArgument, IOError_, KeyError_,
                                    NotImplemented_, OutOfCapacity,
                                    ResourceExhausted, TransientError,
                                    TypeError_)
from cylon_tpu_torch.frame import (DataFrame, GroupByDataFrame, concat,
                                   merge)
from cylon_tpu_torch.indexing import IndexingType
from cylon_tpu_torch.io import (read_csv, read_csv_chunks, read_csv_sharded,
                                read_json, read_parquet, read_parquet_chunks,
                                write_csv, write_csv_sharded, write_parquet)
from cylon_tpu_torch.ops import (concat_tables, equal_tables, filter_table,
                                 groupby_aggregate, head, intersect, sample,
                                 sort_table, subtract, table_aggregate, take,
                                 union, unique)
from cylon_tpu_torch.ops.join import join
from cylon_tpu_torch.parallel import (ReduceOp, SortOptions, all_reduce,
                                      colocated_groupby, colocated_join,
                                      colocated_unique, dist_aggregate,
                                      dist_concat, dist_filter, dist_groupby,
                                      dist_head, dist_intersect, dist_join,
                                      dist_num_rows, dist_sort,
                                      dist_subtract, dist_to_pandas,
                                      dist_union, dist_unique, gather_table,
                                      repartition, scatter_table, shuffle)
from cylon_tpu_torch.parallel.comm import LocalComm, ProcessGroupComm, \
    ThreadWorld
from cylon_tpu_torch.parallel.task_plan import (LogicalTaskPlan,
                                                task_shuffle, task_tables)
from cylon_tpu_torch.resilience import FaultPlan, FaultRule
from cylon_tpu_torch.row import Row
from cylon_tpu_torch.series import Series
from cylon_tpu_torch.table import Table
from cylon_tpu_torch.watchdog import deadline
from cylon_tpu_torch import fallback, pipeline

__all__ = ["CSVReadOptions", "CSVWriteOptions", "Code", "Column",
           "CommConfig", "CylonEnv", "CylonError", "DataFrame",
           "DataLossError", "DeadlineExceeded", "DeadlinePolicy",
           "DeviceUnavailable", "Dictionary", "DistConfig",
           "FailedPrecondition", "FaultPlan", "FaultRule",
           "GroupByDataFrame", "IOError_", "IndexError_", "IndexingType",
           "InvalidArgument", "JoinAlgorithm", "JoinConfig", "JoinType",
           "KeyError_", "LocalComm", "LocalConfig", "LogicalTaskPlan",
           "NotImplemented_", "OutOfCapacity", "ParquetOptions",
           "ProcessGroupComm", "ReduceOp", "ResourceExhausted",
           "RetryPolicy", "Row", "Series", "SortOptions", "Table",
           "ThreadWorld", "TransientError", "TypeError_", "all_reduce",
           "colocated_groupby", "colocated_join", "colocated_unique", "concat",
           "concat_tables", "dist_aggregate", "dist_concat", "dist_filter",
           "dist_groupby", "dist_head", "dist_intersect", "dist_join",
           "dist_num_rows", "dist_sort", "dist_subtract", "dist_to_pandas",
           "dist_union", "dist_unique", "dtypes", "deadline", "equal_tables",
           "filter_table", "gather_table", "groupby_aggregate", "head",
           "intersect", "join", "merge", "pipeline", "plan", "read_csv", "read_csv_chunks",
           "read_csv_sharded", "read_json", "read_parquet",
           "read_parquet_chunks", "repartition", "sample", "scatter_table",
           "shuffle", "sort_table", "subtract", "table_aggregate", "take",
           "task_shuffle", "task_tables", "telemetry", "union", "unique",
           "write_csv", "write_csv_sharded", "write_parquet"]
