"""Communicators: the collectives of the distributed operators.

The port's counterpart of the reference's ``net/communicator.hpp`` (the
JAX package has none: its collectives are mesh primitives inside
``shard_map``). A communicator has a ``world_size``, a ``rank`` and three
collectives:

- :meth:`all_gather` of a 1-D vector (counts, a layout summary, a
  dictionary's padded bytes; the same length and dtype on every rank)
  -> ``[W, len]``, row s from rank s;
- :meth:`exchange` of a ``[rows, words]`` int32 word matrix whose rows are
  grouped by destination, with the per-destination send counts and the
  per-sender receive counts -> the received rows grouped by sender in rank
  order, each sender's order kept;
- :meth:`all_reduce` of a tensor by ``"sum"``, ``"min"`` or ``"max"``
  (the JAX package's ``psum`` / ``pmin`` / ``pmax``): an all-gather, then
  a fold in rank order, so that every rank holds the same bits, as a
  replicated JAX result does. A backend's own all-reduce is not used: its
  order of summation is its own choice.

:class:`LocalComm` is the world of one rank: on the card the exchange is
a device copy. :class:`ThreadWorld` runs W ranks as threads of one
process with collectives built on a barrier; it plays, for the CPU tests,
the role the 8-device virtual CPU mesh plays for the JAX package.
:class:`ProcessGroupComm` runs the collectives over ``torch.distributed``:
NCCL between processes on the cards, gloo between processes on the CPU
(see :class:`cylon_tpu_torch.context.DistConfig`).
"""

import threading
from typing import Callable, Sequence

import torch

from cylon_tpu_torch.errors import InvalidArgument

_FOLDS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _reduce_gathered(gathered: torch.Tensor, op: str, shape) -> torch.Tensor:
    """Fold the rows of an all-gather ``[W, n]`` in rank order into one
    tensor of ``shape``: the same operations in the same order on every
    rank, hence the same bits."""
    if op not in _FOLDS:
        raise InvalidArgument(f"all_reduce: unknown op {op!r}")
    fold = _FOLDS[op]
    acc = gathered[0]
    for row in gathered[1:]:
        acc = fold(acc, row)
    return acc.reshape(shape)


class LocalComm:
    """World of one rank."""

    world_size = 1
    rank = 0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(1, -1).clone()

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return _reduce_gathered(self.all_gather(t), op, t.shape)

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

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return _reduce_gathered(self.all_gather(t), op, t.shape)

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


class ProcessGroupComm:
    """The collectives over a ``torch.distributed`` process group (the
    default group unless ``group`` names another): one process a rank,
    NCCL on the cards, gloo on the CPU. Tensors must lie where the
    backend reads them (NCCL: the rank's CUDA device; gloo: the CPU).

    - :meth:`all_gather`: ``all_gather_into_tensor`` into one flat
      buffer, or a list ``all_gather`` for a backend without it; bool
      travels as uint8;
    - :meth:`exchange`: ``all_to_all_single`` over the ``[rows, words]``
      matrix with the split sizes in rows. NCCL takes the split sizes on
      the host, so the count matrix reaches the host before the payload
      moves (``parallel.shuffle.exchange_arrays``);
    - :meth:`all_reduce`: an all-gather and a fold in rank order."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise InvalidArgument(
                "ProcessGroupComm: no process group; call "
                "torch.distributed.init_process_group or pass "
                "CylonEnv(config=DistConfig(...))")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        flat = t.reshape(-1).contiguous()
        wire = flat.view(torch.uint8) if flat.dtype == torch.bool else flat
        w = self.world_size
        out = torch.empty(w * wire.numel(), dtype=wire.dtype,
                          device=wire.device)
        # every rank holds the same length, so every rank skips alike
        if wire.numel():
            if self.backend in ("gloo", "nccl"):
                dist.all_gather_into_tensor(out, wire, group=self.group)
            else:
                dist.all_gather(list(out.view(w, wire.numel()).unbind(0)),
                                wire, group=self.group)
        out = out.view(w, wire.numel())
        return out.view(torch.bool) if flat.dtype == torch.bool else out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return _reduce_gathered(self.all_gather(t), op, t.shape)

    def exchange(self, send: torch.Tensor, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
        import torch.distributed as dist

        send_counts = [int(c) for c in send_counts]
        recv_counts = [int(c) for c in recv_counts]
        send = send[:sum(send_counts)].contiguous()
        recv = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]),
                           dtype=send.dtype, device=send.device)
        dist.all_to_all_single(recv, send, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts,
                               group=self.group)
        return recv
