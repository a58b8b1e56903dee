"""Execution context: one rank of a world of communicating ranks.

Port of ``cylon_tpu/context.py`` (parity: ``ctx/cylon_context.hpp``). The
JAX package is single-controller over a device mesh; the port is SPMD
like the reference: every rank runs the same program on its own shard and
talks to its peers through a communicator
(:mod:`cylon_tpu_torch.parallel.comm`).
"""

from cylon_tpu_torch.parallel.comm import LocalComm


class CylonEnv:
    """Parity: CylonContext + pycylon CylonEnv. ``comm`` defaults to the
    world of one rank."""

    def __init__(self, comm=None):
        self.comm = LocalComm() if comm is None else comm

    @property
    def world_size(self) -> int:
        return self.comm.world_size

    @property
    def rank(self) -> int:
        return self.comm.rank

    def __repr__(self):
        return f"CylonEnv(rank={self.rank}, world_size={self.world_size})"
