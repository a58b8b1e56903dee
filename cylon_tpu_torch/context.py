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
import os
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
        if comm is None and isinstance(config, DistConfig):
            comm = self._join_group(config, device)
        elif comm is None and config is not None \
                and not isinstance(config, LocalConfig):
            raise InvalidArgument(f"CylonEnv: unknown config {config!r}")
        self.comm = LocalComm() if comm is None else comm

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
            dist.init_process_group(
                backend, init_method=config.init_method or "env://",
                world_size=-1 if config.world_size is None
                else config.world_size,
                rank=-1 if config.rank is None else config.rank)
            self._owns_group = True
        return ProcessGroupComm()

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

    def finalize(self) -> None:
        """Destroy the process group this env initialised, if it did
        (parity: ``CylonContext::Finalize``)."""
        if self._owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_group = False

    def __repr__(self):
        return f"CylonEnv(rank={self.rank}, world_size={self.world_size})"
