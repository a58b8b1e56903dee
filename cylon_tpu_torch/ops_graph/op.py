"""Op base class: a push-based dataflow node.

Port of ``cylon_tpu/ops_graph/op.py`` (parity:
``ops/api/parallel_op.hpp:32-183``): an ``Op`` queues ``(tag, table)``
chunks (``InsertTable``), ``progress`` runs one through ``execute`` and
pushes the results to its children, ``finish`` propagates once every
parent has finished. ``RootOp``, the sink, collects the final chunks
(``WaitForCompletion``, ``parallel_op.hpp:176``).
"""

import collections
from typing import Callable, Iterable, Optional

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.table import Table


class TableChunk:
    """One unit of streamed work: a table and its routing tag (the
    reference passes ``(tag, arrow::Table)`` pairs; the tag is a logical
    partition or relation id)."""

    __slots__ = ("tag", "table")

    def __init__(self, tag: int, table: Table):
        self.tag = tag
        self.table = table

    def __repr__(self):
        return f"TableChunk(tag={self.tag}, {self.table!r})"


class Op:
    """Dataflow node (parity: ``cylon::Op``, parallel_op.hpp:32).
    Subclasses override :meth:`execute` (one chunk in, zero or more out)
    and :meth:`on_finalize` (flush what they accumulated); ``execute``
    may also be given as a callable."""

    def __init__(self, op_id: int, execute: Optional[Callable] = None,
                 name: "str | None" = None):
        self.id = op_id
        self.name = name or type(self).__name__
        self._children: list = []
        #: the parents' count, which the finalize protocol needs; a child
        #: keeps no reference to its parents, so a graph holds no
        #: reference cycle and its chunks are freed when the graph is
        #: dropped, not at the next cyclic collection
        self._n_parents = 0
        self._queue: collections.deque = collections.deque()
        self._finalized_parents = 0
        self._did_finalize = False
        self._execute_fn = execute
        #: chunks this op has processed
        self.processed = 0

    # -- graph wiring ----------------------------------------------------
    def add_child(self, child: "Op") -> "Op":
        """Parity: ``Op::AddChild`` (parallel_op.hpp:101)."""
        self._children.append(child)
        child._n_parents += 1
        return child

    @property
    def children(self) -> list:
        return list(self._children)

    # -- data path -------------------------------------------------------
    def insert(self, tag: int, table: Table) -> None:
        """Parity: ``Op::InsertTable`` (parallel_op.hpp:120)."""
        if self._did_finalize:
            raise InvalidArgument(f"{self.name}: insert after finalize")
        self._queue.append(TableChunk(tag, table))

    def execute(self, tag: int, table: Table) -> Iterable[TableChunk]:
        """Process one chunk, yielding output chunks (parity:
        ``Op::Execute``, parallel_op.hpp:128). Identity by default."""
        if self._execute_fn is not None:
            out = self._execute_fn(tag, table)
            if out is None:
                return ()
            if isinstance(out, Table):
                return (TableChunk(tag, out),)
            return out
        return (TableChunk(tag, table),)

    def on_finalize(self) -> Iterable[TableChunk]:
        """Flush accumulated state once every input is done."""
        return ()

    # -- progress loop ---------------------------------------------------
    def progress(self) -> bool:
        """Process at most one queued chunk (parity: ``Op::Progress``,
        parallel_op.hpp:128-144); True if it did. Each processed chunk
        counts into ``ops_graph.chunks{op=}`` (tenant-labeled under an
        ambient :func:`cylon_tpu_torch.telemetry.tenant_scope`), so a
        mixed workload's streaming progress is attributable per
        tenant."""
        if not self._queue:
            return False
        chunk = self._queue.popleft()
        for out in self.execute(chunk.tag, chunk.table):
            self._emit(out)
        self.processed += 1
        telemetry.counter("ops_graph.chunks", op=self.name,
                          **telemetry.tenant_labels()).inc()
        return True

    def _emit(self, chunk: TableChunk) -> None:
        for child in self._children:
            child.insert(chunk.tag, chunk.table)

    @property
    def has_work(self) -> bool:
        return bool(self._queue)

    def done(self) -> bool:
        """Parity: ``Op::IsComplete``: finalized and drained."""
        return self._did_finalize and not self._queue

    # -- finalize protocol ----------------------------------------------
    def finish(self) -> None:
        """End of stream from one parent (or the caller, for a source);
        the reference's finalize propagation (parallel_op.hpp:146-162)."""
        self._finalized_parents += 1
        needed = max(self._n_parents, 1)
        if self._finalized_parents >= needed and not self._did_finalize:
            while self.progress():
                pass
            for out in self.on_finalize():
                self._emit(out)
            self._did_finalize = True
            for child in self._children:
                child.finish()

    def __repr__(self):
        return (f"{self.name}(id={self.id}, queued={len(self._queue)}, "
                f"final={self._did_finalize})")


class RootOp(Op):
    """Graph sink collecting result chunks (parity: ``RootOp``,
    parallel_op.hpp:166-183)."""

    def __init__(self, op_id: int = 0, callback: Optional[Callable] = None):
        super().__init__(op_id, name="RootOp")
        self.results: list = []
        self._callback = callback

    def execute(self, tag: int, table: Table):
        self.results.append(TableChunk(tag, table))
        if self._callback is not None:
            self._callback(tag, table)
        return ()

    def wait_for_completion(self, execution) -> list:
        """Drive ``execution`` until the graph drains (parity:
        ``RootOp::WaitForCompletion``, execution.hpp:33-37)."""
        while not execution.is_complete():
            pass
        while self.progress():
            pass
        return self.results

    def tables(self) -> list:
        return [c.table for c in self.results]
