"""Execution strategies: the order in which op nodes are progressed.

A copy of ``cylon_tpu/ops_graph/execution.py`` (backend-neutral; the
port never imports the JAX package). Parity:
``ops/execution/execution.hpp:28-110`` — ``RoundRobinExecution``
(:43), ``PriorityExecution`` (weighted repeats, :57), ``JoinExecution``
(drain two subtrees, then the join tail, :83), ``SequentialExecution``
(:103). The reference spins these on the main thread between MPI
progress calls; here a progress step runs one chunk's device work, so
the schedule sets how host ingest and device compute interleave.
"""

from typing import Sequence

from cylon_tpu_torch.ops_graph.op import Op


class Execution:
    """Parity: ``Execution`` (execution.hpp:28-37).

    The reference builds one Execution per query graph. A long-lived
    one whose op set churns (the JAX package's serving layer) adds and
    retires ops with :meth:`add_op` / :meth:`remove_op` on the mutable
    schedules (RoundRobin / Priority)."""

    def progress(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def is_complete(self) -> bool:
        """One scheduling sweep; True when every op is drained+finalized."""
        raise NotImplementedError


class RoundRobinExecution(Execution):
    """Each op progresses once per sweep (execution.hpp:43-55) — the
    serve layer's fair-share default: every live query advances one
    step per sweep regardless of how many steps it still holds."""

    def __init__(self, ops: Sequence[Op] = ()):
        self._ops = list(ops)

    def add_op(self, op: Op) -> None:
        self._ops.append(op)

    def remove_op(self, op: Op) -> None:
        """Retire a completed op from the schedule (no-op if absent) —
        the long-lived serving loop retires finished queries instead of
        rebuilding the execution each sweep."""
        try:
            self._ops.remove(op)
        except ValueError:
            pass

    @property
    def ops(self) -> list[Op]:
        return list(self._ops)

    def progress(self) -> bool:
        did = False
        for op in list(self._ops):
            did |= op.progress()
        return did

    def is_complete(self) -> bool:
        self.progress()
        return all(op.done() for op in self._ops)


class PriorityExecution(Execution):
    """Ops progress proportionally to integer priorities
    (execution.hpp:57-81 — the reference expands priorities into a
    round-robin multiset). The serve layer maps tenant weight onto the
    priority: a weight-3 tenant's query takes three steps per sweep to
    a weight-1 tenant's one."""

    def __init__(self, ops_with_priority: Sequence[tuple[Op, int]] = ()):
        self._ops: list[Op] = []
        self._schedule: list[Op] = []
        for op, prio in ops_with_priority:
            self.add_op(op, prio)

    def add_op(self, op: Op, priority: int = 1) -> None:
        self._ops.append(op)
        self._schedule.extend([op] * max(int(priority), 1))

    def remove_op(self, op: Op) -> None:
        try:
            self._ops.remove(op)
        except ValueError:
            return
        self._schedule = [o for o in self._schedule if o is not op]

    @property
    def ops(self) -> list[Op]:
        return list(self._ops)

    def progress(self) -> bool:
        did = False
        for op in list(self._schedule):
            did |= op.progress()
        return did

    def is_complete(self) -> bool:
        self.progress()
        return all(op.done() for op in self._ops)


class SequentialExecution(Execution):
    """Fully drain each op before moving to the next
    (execution.hpp:103-110)."""

    def __init__(self, ops: Sequence[Op] = ()):
        self._ops = list(ops)

    def add_op(self, op: Op) -> None:
        self._ops.append(op)

    def progress(self) -> bool:
        for op in self._ops:
            if op.progress():
                return True
        return False

    def is_complete(self) -> bool:
        for op in self._ops:
            while op.progress():
                pass
        return all(op.done() for op in self._ops)


class JoinExecution(Execution):
    """Alternate between the two relation subtrees, then drain the join
    tail (execution.hpp:83-101)."""

    def __init__(self, left_ops: Sequence[Op], right_ops: Sequence[Op],
                 tail_ops: Sequence[Op]):
        self._left = list(left_ops)
        self._right = list(right_ops)
        self._tail = list(tail_ops)

    def progress(self) -> bool:
        did = False
        for l, r in zip(self._left, self._right):
            did |= l.progress()
            did |= r.progress()
        for extra in (self._left[len(self._right):],
                      self._right[len(self._left):]):
            for op in extra:
                did |= op.progress()
        for op in self._tail:
            did |= op.progress()
        return did

    def is_complete(self) -> bool:
        self.progress()
        return all(op.done()
                   for op in self._left + self._right + self._tail)
