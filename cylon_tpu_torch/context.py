"""Execution context: one rank of a world of communicating ranks.

Port of ``cylon_tpu/context.py`` (parity: ``ctx/cylon_context.hpp``). The
JAX package is single-controller over a device mesh; the port is SPMD
like the reference: every rank runs the same program on its own shard and
talks to its peers through a communicator
(:mod:`cylon_tpu_torch.parallel.comm`). The config picks the
communicator, as the reference's ``MPIConfig`` / ``GlooConfig`` do
(``ctx/cylon_context.cpp:36-57``): :class:`LocalConfig` the world of one
rank, :class:`DistConfig` a ``torch.distributed`` process group (the
JAX package's ``TPUConfig`` stands here).

Run W processes with ``torchrun --nproc-per-node W prog.py``, each
calling ``CylonEnv(config=DistConfig())`` (NCCL on the cards), or
``CylonEnv(config=DistConfig(), device="cpu")`` (gloo on the CPU).
"""

import dataclasses
import itertools
import os
import threading
from typing import Optional

import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch.errors import DeviceUnavailable, InvalidArgument
from cylon_tpu_torch.parallel.comm import LocalComm, ProcessGroupComm


class CommConfig:
    """Parity: ``net/comm_config.hpp``; a subclass selects the
    communicator."""


@dataclasses.dataclass
class LocalConfig(CommConfig):
    """The world of one rank (reference CommType::LOCAL)."""


@dataclasses.dataclass
class DistConfig(CommConfig):
    """A ``torch.distributed`` process group as the world (where
    ``cylon_tpu/context.py``'s ``TPUConfig`` stands; the reference's
    ``MPIConfig`` / ``GlooConfig``). Every field
    left None takes ``init_process_group``'s default: the backend is
    ``"nccl"`` for a CUDA env and ``"gloo"`` for ``device="cpu"``;
    ``init_method`` is ``"env://"`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them)."""

    backend: Optional[str] = None
    init_method: Optional[str] = None
    world_size: Optional[int] = None
    rank: Optional[int] = None


class CylonEnv:
    """Parity: CylonContext + pycylon CylonEnv.

    ``comm`` passes a communicator as it is (``ThreadWorld`` ranks in the
    tests; a :class:`CommConfig` in its place is taken as ``config``, so
    that ``CylonEnv(LocalConfig())`` reads as in the JAX package);
    otherwise ``config`` picks one: :class:`LocalConfig` (the
    default) or :class:`DistConfig`, which initialises the default
    process group unless one exists and, on CUDA, makes the device
    ``LOCAL_RANK`` names the current one. ``device`` is the rank's device
    (``None``: CUDA), where the default backend comes from. NCCL without
    a card raises :class:`DeviceUnavailable`: it never becomes gloo.
    :attr:`device` is where an entry point that builds tables from host
    data for this env (the TPC-H queries given a raw mapping) puts
    them."""

    def __init__(self, comm=None, *, config: "CommConfig | None" = None,
                 device=None):
        if isinstance(comm, CommConfig) and config is None:
            comm, config = None, comm
        if comm is not None and config is not None:
            raise InvalidArgument("CylonEnv: pass a config or a comm, "
                                  "not both")
        self._owns_group = False
        self._device = device
        self._fault_plan = None
        if comm is None and isinstance(config, DistConfig):
            comm = self._join_group(config, device)
        elif comm is None and config is not None \
                and not isinstance(config, LocalConfig):
            raise InvalidArgument(f"CylonEnv: unknown config {config!r}")
        self.comm = LocalComm() if comm is None else comm
        self._kv: "dict[str, str]" = {}
        self._finalized = False
        self._clock_offset: "float | None" = None
        from cylon_tpu_torch.utils.logging import set_world

        # the log prefix names this rank ("[r/w] "); the ThreadWorld ranks
        # of one process share the logger, so there the last one set wins
        set_world(self.rank, self.world_size)

    def _join_group(self, config: DistConfig, device) -> ProcessGroupComm:
        import torch.distributed as dist

        dev = _device.resolve(device)
        backend = config.backend or ("nccl" if dev.type == "cuda"
                                     else "gloo")
        if backend == "nccl" and not torch.cuda.is_available():
            raise DeviceUnavailable("DistConfig: the nccl backend needs a "
                                    "CUDA device; pass device='cpu' for "
                                    "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if dist.is_initialized():
            if dist.get_backend() != backend:
                raise InvalidArgument(
                    f"DistConfig: the process group runs "
                    f"{dist.get_backend()!r}, not {backend!r}")
        else:
            self._bootstrap(dist, backend, config)
            self._owns_group = True
        return ProcessGroupComm()

    def _bootstrap(self, dist, backend: str, config: DistConfig) -> None:
        """``init_process_group`` with the JAX package's bootstrap
        resilience (``cylon_tpu/context.py:110-180``): each attempt hits
        the ``worker`` injection point and runs as the watchdog's
        ``bootstrap`` section (retryable: a preempted peer may rejoin),
        and :func:`~cylon_tpu_torch.resilience.retrying` re-attempts
        transient failures (a refused or timed-out rendezvous included)
        with backoff. An attempt abandoned at its deadline may still
        finish; a later attempt that finds the group initialised claims
        it instead of initialising twice."""
        from cylon_tpu_torch import resilience, telemetry, watchdog
        from cylon_tpu_torch.errors import DeadlineExceeded

        abandoned = {"n": 0}

        def _init():
            resilience.inject("worker", "process group bootstrap",
                              env=self)
            if abandoned["n"] and dist.is_initialized():
                return  # the late success of an abandoned attempt
            dist.init_process_group(
                backend, init_method=config.init_method or "env://",
                world_size=-1 if config.world_size is None
                else config.world_size,
                rank=-1 if config.rank is None else config.rank)

        def _attempt():
            telemetry.counter("bootstrap.attempts").inc()
            try:
                return watchdog.bounded(
                    _init, "bootstrap",
                    detail="torch.distributed.init_process_group")
            except DeadlineExceeded:
                abandoned["n"] += 1
                raise

        def _retryable(e):
            return resilience.is_retryable(e) or isinstance(
                e, getattr(dist, "DistNetworkError", ()))

        resilience.retrying(_attempt, label="process group bootstrap",
                            retry_on=_retryable)

    @property
    def device(self) -> torch.device:
        """The rank's device, resolved when read (``None``: CUDA, which
        raises :class:`DeviceUnavailable` without a card)."""
        return _device.resolve(self._device)

    @property
    def world_size(self) -> int:
        return self.comm.world_size

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    # -- string KV config store (parity: ctx/cylon_context.hpp:32,69-77
    #    AddConfig/GetConfig/GetConfigs) ---------------------------------
    def add_config(self, key: str, value: str) -> None:
        self._kv[str(key)] = str(value)

    def get_config(self, key: str, default: "str | None" = None) \
            -> "str | None":
        return self._kv.get(str(key), default)

    def get_configs(self) -> "dict[str, str]":
        return dict(self._kv)

    @property
    def context(self) -> "CylonEnv":
        """pycylon exposes ``env.context`` (the CylonContext); here env
        and context are one object."""
        return self

    def get_neighbours(self, rank: "int | None" = None,
                       include_self: bool = False) -> list:
        """The ranks of the world (parity: ``ctx GetNeighbours``),
        without ``rank`` unless ``include_self``. ``rank`` defaults to
        this rank: the port is SPMD, so it has the ambient self the
        reference has (the JAX package's single controller has none, and
        there ``rank=None`` returns every index)."""
        me = self.rank if rank is None else int(rank)
        return [r for r in range(self.world_size)
                if include_self or r != me]

    # -- resilience (no parity: the reference has no recovery story) ----
    def set_fault_plan(self, plan) -> "CylonEnv":
        """Register a :class:`cylon_tpu_torch.resilience.FaultPlan` on
        this env: the ops that take an env (``shuffle``, ``dist_join``,
        ...) check it at their injection points before the context's and
        the process-wide plan. ``None`` clears it."""
        self._fault_plan = plan
        return self

    @property
    def fault_plan(self):
        """The plan :meth:`set_fault_plan` registered, or None."""
        return self._fault_plan

    # -- lifecycle (parity: Barrier/Finalize) -----------------------------
    def barrier(self, timeout: "float | None" = None) -> None:
        """Wait until every rank reaches the barrier and this rank's
        device work is done (parity: ``ctx Barrier``): one all-reduce
        through the communicator, then a synchronize of the current
        stream of the env's device (no other device). Timed by the
        ``barrier.wait_seconds`` timer.

        The wait is the watchdog's ``barrier`` section
        (:func:`cylon_tpu_torch.watchdog.bounded`,
        ``cylon_tpu/context.py:348-360``): ``timeout`` (seconds), an
        ambient ``watchdog.deadline`` scope or
        ``CYLON_TPU_DEADLINE_BARRIER`` bounds it, and on expiry the
        watchdog dumps all-thread stacks and raises
        :class:`~cylon_tpu_torch.errors.DeadlineExceeded` (section
        ``"barrier"``, never retryable: a peer that missed the barrier
        left the world unrecoverable). With no bound the wait runs inline
        and blocks for as long as it takes. The wait hits the ``worker``
        injection point first, where a hang rule stands for a peer that
        never arrives."""
        from cylon_tpu_torch import resilience, telemetry, watchdog

        dev = self.device

        def _drain():
            resilience.inject("worker", "barrier", env=self)
            self.comm.all_reduce(torch.ones(1, dtype=torch.int32,
                                            device=dev), "sum")
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

        with telemetry.timer("barrier.wait_seconds").time():
            watchdog.bounded(_drain, "barrier", timeout=timeout,
                             detail=f"world={self.world_size}")

    def clock_offset(self) -> float:
        """Barrier-anchored estimate of this rank's wall-clock offset
        from rank 0, in seconds — the term the trace merge subtracts so
        per-rank timelines line up across hosts
        (:func:`cylon_tpu_torch.telemetry.trace.merge_timelines`).

        Ranks that are processes (``ProcessGroupComm``) pass one
        :meth:`barrier`, read ``time.time()`` on its exit and all-gather
        the readings: the offset is ``own - rank0``, within the
        collective's completion jitter. Cached on the env; exactly 0 in
        one process (``LocalComm``, and the ``ThreadWorld`` ranks,
        which share one clock). Offsets drift: construct a fresh env
        (or clear ``_clock_offset``) for multi-hour traces."""
        if self._clock_offset is None:
            import time as _time

            from cylon_tpu_torch.telemetry.aggregate import _gathers

            if not _gathers(self):
                self._clock_offset = 0.0
            else:
                self.barrier()
                t = _time.time()
                ts = self.comm.all_gather(torch.tensor(
                    [t], dtype=torch.float64, device=self.device))
                self._clock_offset = float(t - float(ts.reshape(-1)[0]))
        return self._clock_offset

    def finalize(self) -> None:
        """Destroy the process group this env initialised, if it did
        (parity: ``CylonContext::Finalize``)."""
        self._finalized = True
        if self._owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_group = False

    @property
    def is_finalized(self) -> bool:
        return self._finalized

    _seq = itertools.count()
    _seq_lock = threading.Lock()

    @classmethod
    def get_next_sequence(cls) -> int:
        """A process-wide increasing sequence number (parity:
        ``ctx GetNextSequence``)."""
        with cls._seq_lock:
            return next(cls._seq)

    def __repr__(self):
        return f"CylonEnv(rank={self.rank}, world_size={self.world_size})"
