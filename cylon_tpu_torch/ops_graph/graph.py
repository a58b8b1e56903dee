"""Concrete streaming ops and the prebuilt distributed graphs.

Port of ``cylon_tpu/ops_graph/graph.py`` (parity: ``cpp/src/cylon/ops/``
``PartitionOp``, ``JoinOp`` / ``UnionOp`` and the builders ``DisJoinOP``
/ ``DisUnionOp``, ``ops/dis_join_op.cpp:21-72``: per relation, partition
-> shuffle -> split -> shared join).

Two modes:

* local (``env=None``): partitioning is tag routing (a chunk's tag is
  its logical partition);
* distributed (``env=CylonEnv``): every rank inserts its own chunks, the
  same number on every rank. :class:`ShuffleOp` moves each chunk over
  the world as it arrives (the port's ``shuffle``: ``row_hash``
  partition ids, then ``shuffle_local`` over ``env.comm``), and the
  terminal op finishes with rank-local work on the co-located
  accumulation (``colocated_join`` / ``colocated_unique`` /
  ``colocated_groupby``).

Keys hash by value: a dictionary column by its values' hashes, so
chunks ingested apart (each with its own dictionary) send equal strings
to one partition.
"""

from typing import Callable, Iterable, Sequence

import torch

from cylon_tpu_torch.ops import setops as _setops
from cylon_tpu_torch.ops.groupby import groupby_aggregate
from cylon_tpu_torch.ops.hash import partition_ids
from cylon_tpu_torch.ops.join import join as _join
from cylon_tpu_torch.ops.selection import (concat_tables, filter_table,
                                           take_columns)
from cylon_tpu_torch.ops_graph.op import Op, RootOp, TableChunk
from cylon_tpu_torch.parallel import dist_ops
from cylon_tpu_torch.table import Table


def chunk_stream(table: Table, chunk_rows: int,
                 env=None) -> Iterable[Table]:
    """Cut a table into chunks of capacity ``chunk_rows`` (the ingest side
    of the streaming graph; the reference streams arrow record batches).
    With ``env`` the table is this rank's shard and every rank yields
    as many chunks as the largest shard needs (one all-gather of the
    counts; a rank that runs out yields empty chunks), so that the
    per-chunk collectives of a distributed graph line up."""
    n = table.num_rows
    total = n
    if env is not None:
        from cylon_tpu_torch.parallel.dtable import shard_counts

        total = max(shard_counts(env, table))
    for lo in range(0, max(total, 1), chunk_rows):
        idx = torch.arange(lo, lo + chunk_rows, dtype=torch.int32,
                           device=table.device)
        yield take_columns(table, torch.clamp(idx, 0, max(n - 1, 0)),
                           min(max(n - lo, 0), chunk_rows))


def _lossless(env, table: Table) -> int:
    """The world's receive bound that no exchange of a chunk can pass:
    every rank's whole chunk on one rank."""
    return table.capacity * env.world_size * env.world_size


def _value_keys(table: Table, names: Sequence[str]):
    vh = dist_ops._value_hash_tables(table, names)
    return dist_ops._value_partition_keys(table, names, vh)


class PartitionOp(Op):
    """Hash-partition each chunk into ``n_partitions`` sub-chunks, tagged
    by partition id (parity: ``ops/partition_op.cpp`` +
    ``ops/kernels/partition.cpp``)."""

    def __init__(self, op_id: int, key_cols: Sequence[str],
                 n_partitions: int):
        super().__init__(op_id, name="PartitionOp")
        self._keys = list(key_cols)
        self._n = n_partitions

    def execute(self, tag: int, table: Table):
        keys, vals = _value_keys(table, self._keys or table.column_names)
        pid = partition_ids(keys, self._n, vals)
        for p in range(self._n):
            yield TableChunk(p, filter_table(table, pid == p))


class ShuffleOp(Op):
    """The exchange stage of the distributed graph: every incoming chunk
    hash-shuffles over the world at once (``dist_ops.shuffle``), leaving
    a key-co-located chunk on each rank (the AllToAllOp of
    ``DisJoinOP``, ``ops/dis_join_op.cpp:34-71``). The receive bound is
    lossless: at worst every rank's chunk lands on one rank, so a rank's
    bound is the world's chunk capacity (``out_capacity``, the world's
    bound, is W times that)."""

    def __init__(self, op_id: int, key_cols: Sequence[str], env):
        super().__init__(op_id, name="ShuffleOp")
        self._keys = list(key_cols)
        self._env = env

    def execute(self, tag: int, table: Table):
        keys = self._keys or table.column_names
        yield TableChunk(tag, dist_ops.shuffle(
            self._env, table, keys,
            out_capacity=_lossless(self._env, table)))


class _SidePort(Op):
    """Adapter routing chunks into one side of a binary op."""

    def __init__(self, op_id: int, target: "JoinOp", side: int):
        super().__init__(op_id, name=f"Port{side}")
        self._target = target
        self._side = side
        self.add_child(target)

    def execute(self, tag: int, table: Table):
        self._target.accept(self._side, tag, table)
        return ()


def _concat(env, tables: list) -> Table:
    if len(tables) == 1:
        return tables[0]
    if env is not None:
        return dist_ops.dist_concat(env, tables)
    return concat_tables(tables)


class JoinOp(Op):
    """Per-partition accumulate, then join (parity: ``ops/join_op.cpp`` +
    ``ops/kernels/join_kernel.cpp``: the reference also concatenates a
    relation's chunks before the local join)."""

    def __init__(self, op_id: int, env=None, **join_kw):
        super().__init__(op_id, name="JoinOp")
        self._kw = join_kw
        self._env = env
        self._buf: dict = {}

    def left_port(self, op_id: int) -> Op:
        return _SidePort(op_id, self, 0)

    def right_port(self, op_id: int) -> Op:
        return _SidePort(op_id, self, 1)

    def accept(self, side: int, tag: int, table: Table) -> None:
        self._buf.setdefault(tag, ([], []))[side].append(table)

    def on_finalize(self):
        for tag in sorted(self._buf):
            lefts, rights = self._buf[tag]
            if not lefts or not rights:
                # partitioning emits every partition a chunk, so an
                # absent side means that relation got no input
                continue
            lt, rt = _concat(self._env, lefts), _concat(self._env, rights)
            if self._env is not None:
                # co-located by ShuffleOp: each rank joins its own shards
                res = dist_ops.colocated_join(self._env, lt, rt, **self._kw)
            else:
                res = _join(lt, rt, **self._kw)
                res.num_rows  # raises OutOfCapacity on overflow
            yield TableChunk(tag, res)


class UnionOp(Op):
    """Per-partition set union (parity: ``ops/union_op.cpp``)."""

    def __init__(self, op_id: int, out_capacity: "int | None" = None,
                 env=None):
        super().__init__(op_id, name="UnionOp")
        self._buf: dict = {}
        self._out_capacity = out_capacity
        self._env = env

    def execute(self, tag: int, table: Table):
        self._buf.setdefault(tag, []).append(table)
        return ()

    def on_finalize(self):
        for tag in sorted(self._buf):
            t = _concat(self._env, self._buf[tag])
            if self._env is not None:
                res = dist_ops.colocated_unique(
                    self._env, t, out_capacity=self._out_capacity)
            else:
                res = _setops.unique(t, out_capacity=self._out_capacity)
            yield TableChunk(tag, res)


class GroupByOp(Op):
    """Streaming group-by: each chunk is pre-combined on arrival and the
    partials re-aggregated at finalize, the pre-combine -> final combine
    of ``DistributedHashGroupBy`` (``groupby/groupby.cpp:62-78``) over
    chunks. With ``env`` the partials (or raw rows, for aggregates that
    do not decompose) shuffle as they arrive."""

    _MERGE = {"sum": "sum", "count": "sum", "size": "sum",
              "min": "min", "max": "max"}

    def __init__(self, op_id: int, by: Sequence[str], aggs,
                 out_capacity: "int | None" = None, env=None):
        super().__init__(op_id, name="GroupByOp")
        self._by = list(by)
        self._aggs = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[0]}_{a[1]}")
                      for a in (tuple(x) for x in aggs)]
        self._out_capacity = out_capacity
        self._decomposable = all(op in self._MERGE
                                 for _, op, _ in self._aggs)
        self._env = env
        self._buf: dict = {}

    def execute(self, tag: int, table: Table):
        part = groupby_aggregate(table, self._by, self._aggs) \
            if self._decomposable else table
        if self._env is not None:
            part = dist_ops.shuffle(self._env, part, self._by,
                                    out_capacity=_lossless(self._env, part))
        self._buf.setdefault(tag, []).append(part)
        return ()

    def on_finalize(self):
        final = [(out, self._MERGE[op], out) for _, op, out in self._aggs] \
            if self._decomposable else self._aggs
        for tag in sorted(self._buf):
            t = _concat(self._env, self._buf[tag])
            if self._env is not None:
                res = dist_ops.colocated_groupby(
                    self._env, t, self._by, final,
                    out_capacity=self._out_capacity)
            else:
                res = groupby_aggregate(t, self._by, final,
                                        out_capacity=self._out_capacity)
            yield TableChunk(tag, res)


class DisJoinOp:
    """Prebuilt join graph (parity: ``DisJoinOP``, dis_join_op.cpp:21-72:
    per relation partition -> [shuffle] -> shared join -> callback).
    ``n_partitions`` logical partitions bound a partition's working set
    in the local graph; with ``env`` the world is the partitioning.
    Chunks stream in through ``insert_left`` / ``insert_right``; the
    result comes at :meth:`result`."""

    def __init__(self, key_cols, n_partitions: int = 4,
                 callback: "Callable | None" = None, env=None, **join_kw):
        keys = [key_cols] if isinstance(key_cols, str) else list(key_cols)
        join_kw.setdefault("on", keys if len(keys) > 1 else keys[0])
        self.root = RootOp(0, callback)
        self.join = JoinOp(1, env=env, **join_kw)
        self.join.add_child(self.root)
        lport = self.join.left_port(2)
        rport = self.join.right_port(3)
        if env is not None:
            self.left_partition = ShuffleOp(4, keys, env)
            self.right_partition = ShuffleOp(5, keys, env)
        else:
            self.left_partition = PartitionOp(4, keys, n_partitions)
            self.right_partition = PartitionOp(5, keys, n_partitions)
        self.left_partition.add_child(lport)
        self.right_partition.add_child(rport)
        self.ops = [self.left_partition, self.right_partition, lport, rport,
                    self.join, self.root]
        self._env = env

    def insert_left(self, table: Table, tag: int = 0):
        self.left_partition.insert(tag, table)

    def insert_right(self, table: Table, tag: int = 0):
        self.right_partition.insert(tag, table)

    def finish(self):
        self.left_partition.finish()
        self.right_partition.finish()

    def result(self, execution=None) -> Table:
        """Drive the graph to completion and concatenate the partitions'
        results (with ``env``: this rank's shard of the join)."""
        from cylon_tpu_torch.ops_graph.execution import JoinExecution

        if execution is None:
            execution = JoinExecution(
                [self.left_partition], [self.right_partition],
                [self.join, self.root])
        self.finish()
        tables = [c.table for c in self.root.wait_for_completion(execution)]
        if not tables:
            raise ValueError("join produced no partitions")
        return _concat(self._env, tables)


class DisUnionOp:
    """Prebuilt union graph (parity: ``DisUnionOp``,
    ``ops/dis_union_op.cpp``)."""

    def __init__(self, n_partitions: int = 4,
                 callback: "Callable | None" = None,
                 out_capacity: "int | None" = None,
                 key_cols: "Sequence[str] | None" = None, env=None):
        self.root = RootOp(0, callback)
        self.union = UnionOp(1, out_capacity, env=env)
        self.union.add_child(self.root)
        self._keys = key_cols
        self._n = n_partitions
        self._env = env
        self._partitions: list = []

    def add_input(self, key_cols: "Sequence[str] | None" = None) -> Op:
        keys = list(key_cols or self._keys or ())
        op_id = 10 + len(self._partitions)
        p = ShuffleOp(op_id, keys, self._env) if self._env is not None \
            else PartitionOp(op_id, keys, self._n)
        p.add_child(self.union)
        self._partitions.append(p)
        return p

    def finish(self):
        for p in self._partitions:
            p.finish()

    def result(self, execution=None) -> Table:
        from cylon_tpu_torch.ops_graph.execution import RoundRobinExecution

        if execution is None:
            execution = RoundRobinExecution(
                self._partitions + [self.union, self.root])
        self.finish()
        tables = [c.table for c in self.root.wait_for_completion(execution)]
        if not tables:
            raise ValueError("union produced no partitions")
        return _concat(self._env, tables)
