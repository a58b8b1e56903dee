"""Op-graph streaming execution engine (the reference's L7).

Port of ``cylon_tpu/ops_graph`` (parity: ``cpp/src/cylon/ops/``): a
push-based dataflow of ``Op`` nodes with per-tag input queues and
finalize propagation (``ops/api/parallel_op.hpp:32-183``), execution
strategies (``ops/execution/execution.hpp:28-110``) and the prebuilt
graphs ``DisJoinOp`` / ``DisUnionOp`` (``ops/dis_join_op.cpp:21-72``).

A chunk is a capacity-bounded device table. Locally (``env=None``) the
graph partitions chunks by key hash into logical partitions; with
``env`` every rank streams its own chunks and :class:`ShuffleOp` moves
each chunk over the world as it arrives, so every rank must insert the
same number of chunks (:func:`chunk_stream` with ``env`` cuts them so).
``Op.processed`` counts each op's chunks, and the telemetry counter
``ops_graph.chunks{op=}`` counts them for the process, as in the JAX
package.
"""

from cylon_tpu_torch.ops_graph.execution import (Execution, JoinExecution,
                                                 PriorityExecution,
                                                 RoundRobinExecution,
                                                 SequentialExecution)
from cylon_tpu_torch.ops_graph.graph import (DisJoinOp, DisUnionOp,
                                             GroupByOp, JoinOp, PartitionOp,
                                             ShuffleOp, UnionOp,
                                             chunk_stream)
from cylon_tpu_torch.ops_graph.op import Op, RootOp, TableChunk

__all__ = ["DisJoinOp", "DisUnionOp", "Execution", "GroupByOp",
           "JoinExecution", "JoinOp", "Op", "PartitionOp",
           "PriorityExecution", "RootOp", "RoundRobinExecution",
           "SequentialExecution", "ShuffleOp", "TableChunk", "UnionOp",
           "chunk_stream"]
