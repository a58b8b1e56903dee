"""Communicators: the two collectives the distributed join needs.

The port's counterpart of the reference's ``net/communicator.hpp`` (the
JAX package has none: its collectives are mesh primitives inside
``shard_map``). A communicator has a ``world_size``, a ``rank`` and two
collectives:

- :meth:`all_gather` of a 1-D vector (counts, a layout summary, a
  dictionary's padded bytes; the same length and dtype on every rank)
  -> ``[W, len]``, row s from rank s;
- :meth:`exchange` of a ``[rows, words]`` int32 word matrix whose rows are
  grouped by destination, with the per-destination send counts and the
  per-sender receive counts -> the received rows grouped by sender in rank
  order, each sender's order kept.

:class:`LocalComm` is the world of one rank: on the card the exchange is
a device copy. :class:`ThreadWorld` runs W ranks as threads of one
process with collectives built on a barrier; it plays, for the CPU tests,
the role the 8-device virtual CPU mesh plays for the JAX package. An NCCL
communicator over ``torch.distributed`` is a later slice.
"""

import threading
from typing import Callable, Sequence

import torch


class LocalComm:
    """World of one rank."""

    world_size = 1
    rank = 0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(1, -1).clone()

    def exchange(self, send: torch.Tensor, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
        return send[:int(send_counts[0])].clone()


class _RankComm:
    """One rank's view of a :class:`ThreadWorld`."""

    def __init__(self, world: "ThreadWorld", rank: int):
        self._world = world
        self.rank = rank
        self.world_size = world.world_size

    def _share(self, value):
        """Publish ``value`` and return every rank's, in rank order."""
        w = self._world
        w.slots[self.rank] = value
        w.barrier.wait()
        out = list(w.slots)
        w.barrier.wait()   # nobody overwrites a slot before all have read
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack([s.reshape(-1) for s in self._share(t)])

    def exchange(self, send: torch.Tensor, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
        counts = [int(c) for c in send_counts]
        parts = []
        for s_send, s_counts in self._share((send, counts)):
            off = sum(s_counts[:self.rank])
            parts.append(s_send[off:off + s_counts[self.rank]])
        got = torch.cat(parts).to(send.device)
        if got.shape[0] != sum(int(c) for c in recv_counts):
            raise RuntimeError(f"rank {self.rank}: received {got.shape[0]} "
                               f"rows, the counts said {sum(recv_counts)}")
        return got


class ThreadWorld:
    """W ranks as threads of one process; :meth:`run` calls ``fn(comm)``
    on every rank and returns the results in rank order."""

    def __init__(self, world_size: int, timeout: float = 120.0):
        self.world_size = world_size
        self.barrier = threading.Barrier(world_size, timeout=timeout)
        self.slots = [None] * world_size

    def comms(self) -> list:
        return [_RankComm(self, r) for r in range(self.world_size)]

    def run(self, fn: Callable) -> list:
        results = [None] * self.world_size
        errors = []

        def rank_main(comm):
            try:
                results[comm.rank] = fn(comm)
            except BaseException as e:   # noqa: BLE001 -- re-raised below
                errors.append(e)
                self.barrier.abort()     # free the ranks waiting on us

        threads = [threading.Thread(target=rank_main, args=(c,))
                   for c in self.comms()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = next((e for e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise first
        return results
