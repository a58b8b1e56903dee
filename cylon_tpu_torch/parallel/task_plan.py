"""Task-parallelism overlay: many logical tasks a worker.

Port of ``cylon_tpu/parallel/task_plan.py`` (parity:
``cpp/src/cylon/arrow/arrow_task_all_to_all.{h,cpp}``:
``LogicalTaskPlan``, :24-47, and ``ArrowTaskAllToAll``, :56-75). Rows
carry a target task id; the plan maps tasks to workers; one ordinary
exchange (the port's ``shuffle_local`` over ``env.comm``) moves each row
to the worker owning its task, the task id riding along as
``TASK_COL``; each worker splits its rows by task.

SPMD, as the rest of the port: the input is this rank's shard, and
:func:`task_tables` gives this rank's tasks only.
"""

from typing import Mapping, Sequence

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.errors import InvalidArgument

#: the carried task tag (dropped by :func:`task_view`)
TASK_COL = "__task__"


class LogicalTaskPlan:
    """Static mapping of logical task ids onto workers (the reference's
    constructor fields, arrow_task_all_to_all.h:27-46)."""

    def __init__(self, task_sources: Sequence[int],
                 task_targets: Sequence[int],
                 worker_sources: Sequence[int],
                 worker_targets: Sequence[int],
                 task_to_worker: Mapping[int, int]):
        self.task_sources = list(task_sources)
        self.task_targets = list(task_targets)
        self.worker_sources = list(worker_sources)
        self.worker_targets = list(worker_targets)
        self.task_to_worker = dict(task_to_worker)
        for t in self.task_targets:
            if t not in self.task_to_worker:
                raise InvalidArgument(f"target task {t} has no worker")

    @staticmethod
    def round_robin(num_tasks: int, world: int) -> "LogicalTaskPlan":
        """Tasks 0..n-1 dealt over workers 0..w-1."""
        tasks = list(range(num_tasks))
        return LogicalTaskPlan(tasks, tasks, list(range(world)),
                               list(range(world)),
                               {t: t % world for t in tasks})

    def worker_of(self) -> np.ndarray:
        """Dense [max_task + 1] task -> worker lookup (int32; -1 unmapped)."""
        out = np.full(max(self.task_to_worker) + 1, -1, np.int32)
        for t, w in self.task_to_worker.items():
            out[t] = w
        return out

    def tasks_of(self, worker: int) -> list:
        return sorted(t for t, w in self.task_to_worker.items()
                      if w == worker)


def task_shuffle(env, table, task_ids, plan: LogicalTaskPlan,
                 out_capacity: "int | None" = None):
    """Route each row of this rank's shard to the worker owning its
    target task (parity: ``ArrowTaskAllToAll::InsertTable(table,
    task_target)``). ``task_ids`` is a column name, or one id a row of
    the shard's capacity. Returns this rank's received rows with
    ``TASK_COL``; split them with :func:`task_view` / :func:`task_tables`.

    A live row whose task id is unmapped or out of range stays on its
    rank and marks that rank's result as overflowed, so that the host
    check (:func:`task_tables`, on every rank) raises rather than
    dropping or misrouting it. ``out_capacity`` bounds
    the world's result (default: twice the even share of the world's
    capacity a rank); an overflow raises at the host check. A
    collective."""
    from cylon_tpu_torch.ops import kernels
    from cylon_tpu_torch.parallel.dist_ops import _out_cap_local
    from cylon_tpu_torch.parallel.dtable import world_layout_sized
    from cylon_tpu_torch.parallel.shuffle import (checked_recv, poison,
                                                  shuffle_local)

    if isinstance(task_ids, str):
        tid_name, work = task_ids, table
    else:
        tid_name = TASK_COL
        tid = task_ids if torch.is_tensor(task_ids) \
            else from_host(np.asarray(task_ids), table.device)
        if tid.shape[0] != table.capacity:
            raise InvalidArgument(
                f"task_ids length {tid.shape[0]} != table capacity "
                f"{table.capacity} (pass one id per buffered row, or a "
                f"column name)")
        work = table.add_column(TASK_COL, Column(
            tid.to(device=table.device, dtype=torch.int64), None,
            dtypes.int64))
    work, _, caps = world_layout_sized(env, work)
    lookup = from_host(plan.worker_of(), work.device)
    out_l = _out_cap_local(env, sum(caps), out_capacity)
    lt, inof = checked_recv(work, work.capacity)
    tcol = lt.column(tid_name).data.to(torch.int64)
    pid = lookup[torch.clamp(tcol, 0, lookup.shape[0] - 1)]
    live = kernels.valid_mask(lt.capacity, lt.nrows, lt.device)
    bad = live & ((tcol < 0) | (tcol >= lookup.shape[0]) | (pid < 0))
    pid = torch.where(bad, torch.full_like(pid, env.rank), pid)
    res, of = checked_recv(shuffle_local(env.comm, lt, pid, out_l), out_l)
    out = poison(res, inof, of, bad.any())
    if tid_name != TASK_COL:
        out = out.rename({tid_name: TASK_COL})
    return out


def task_view(shuffled, task: int):
    """One task's rows of a received shard, without ``TASK_COL``."""
    from cylon_tpu_torch.ops.selection import filter_table

    mask = shuffled.column(TASK_COL).data.to(torch.int64) == task
    return filter_table(shuffled, mask).drop([TASK_COL])


def task_tables(env, shuffled, plan: LogicalTaskPlan) -> dict:
    """This rank's received rows split by task: one table for each task
    the plan gives this rank (the receive callback's delivery a task,
    arrow_task_all_to_all.cpp onReceive). Raises OutOfCapacity on every
    rank if any rank's result overflowed or a row had no worker. A
    collective."""
    from cylon_tpu_torch.parallel.dtable import shard_counts

    shard_counts(env, shuffled)
    return {task: task_view(shuffled, task)
            for task in plan.tasks_of(env.rank)}
