"""Tenant sessions: a named client of the engine with pinned residency.

Port of ``cylon_tpu/serve/session.py`` on the port's catalog. A
:class:`Session` is the unit of tenancy the serving layer hands a
client: it names the tenant (every request it submits is admitted,
scheduled, metered and traced under that label), carries the tenant's
scheduling weight (``priority`` — the
:class:`~cylon_tpu_torch.ops_graph.execution.PriorityExecution`
multiplier under the ``priority`` schedule), and holds **session pins**
on the resident tables the tenant works against: for the session's
lifetime :func:`cylon_tpu_torch.catalog.drop` on those tables fails with
a :class:`~cylon_tpu_torch.errors.FailedPrecondition` naming this
session as the holder, instead of a concurrent query discovering the
loss as a late ``KeyError``.

    with engine.session("alice", priority=2,
                        tables=["tpch/lineitem"]) as s:
        t1 = s.submit(my_query, resident)
        t2 = s.submit(other_query, resident)
        r1, r2 = t1.result(), t2.result()

Per-request pins (``submit(tables=...)``) stack on top of session pins —
both are plain refcounts in the catalog.
"""

import itertools

from cylon_tpu_torch import catalog
from cylon_tpu_torch.errors import InvalidArgument

__all__ = ["Session"]


class Session:
    """One tenant's handle on a
    :class:`~cylon_tpu_torch.serve.ServeEngine` (construct via
    :meth:`~cylon_tpu_torch.serve.ServeEngine.session`; port of
    ``cylon_tpu/serve/session.py`` ``Session``)."""

    _ids = itertools.count(1)

    def __init__(self, engine, tenant: str, priority: int = 1,
                 tables=()):
        if priority < 1:
            raise InvalidArgument(
                f"priority must be >= 1, got {priority}")
        self._engine = engine
        self.tenant = str(tenant)
        self.priority = int(priority)
        self.holder = f"session:{self.tenant}#{next(self._ids)}"
        self._pins: list[str] = []
        self._closed = False
        try:
            for tid in tables:
                self.attach(tid)
        except Exception:
            self.close()
            raise

    # --------------------------------------------------- residency pins
    def attach(self, table_id: str) -> None:
        """Pin ``table_id`` for this session's lifetime."""
        if self._closed:
            raise InvalidArgument(f"session {self.holder} is closed")
        catalog.pin(table_id, holder=self.holder)
        self._pins.append(table_id)

    def detach(self, table_id: str) -> None:
        """Release one session pin on ``table_id``."""
        self._pins.remove(table_id)  # raises if never attached
        catalog.unpin(table_id, holder=self.holder)

    def table(self, table_id: str):
        """The resident table (must be attached — a session only reads
        tables it pinned, so nothing it touches can vanish mid-query)."""
        if table_id not in self._pins:
            raise InvalidArgument(
                f"table {table_id!r} is not attached to session "
                f"{self.holder}; attach() it first")
        return catalog.get_table(table_id)

    @property
    def tables(self) -> list:
        return list(self._pins)

    # ------------------------------------------------------- submission
    def submit(self, fn, *args, slo: "float | None" = None,
               tables=(), fault_plan=None, **kwargs):
        """Submit under this session's tenant + priority (see
        :meth:`cylon_tpu_torch.serve.ServeEngine.submit`)."""
        if self._closed:
            raise InvalidArgument(f"session {self.holder} is closed")
        return self._engine.submit(
            fn, *args, tenant=self.tenant, priority=self.priority,
            slo=slo, tables=tables, fault_plan=fault_plan, **kwargs)

    # -------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release every session pin (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for tid in self._pins:
            try:
                catalog.unpin(tid, holder=self.holder)
            except Exception:  # table force-cleared under us
                pass
        self._pins.clear()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (f"Session({self.tenant!r}, priority={self.priority}, "
                f"tables={self._pins})")
