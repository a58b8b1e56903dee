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

**Two tiers.** A world of S slices of L ranks (a slice is a node, the
ranks in it share its fast links; the JAX package's slice x worker
mesh, ``cylon_tpu/context.py:213-230``) numbers its ranks slice-major,
``rank = slice * L + local``, which is ``torchrun``'s order. Each rank's
communicator then also carries two sub-communicators: ``intra``, over
the L ranks of its slice (rank ``local``), and ``inter``, over the S
ranks with its local index (rank ``slice``). The table exchange stages
through them (:func:`cylon_tpu_torch.parallel.shuffle.exchange_arrays`);
the world-level collectives stay over the whole world. A flat
communicator has ``intra = inter = None``.
"""

import threading
from typing import Callable, Sequence

import torch

from cylon_tpu_torch.errors import InvalidArgument

_FOLDS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def slice_size(world_size: int, devices_per_slice) -> int:
    """The ranks a slice of a two-tier world holds, or 0 for a flat
    world: ``devices_per_slice`` None, or at least ``world_size``.
    A size that does not divide the world raises, as the JAX package's
    ``_slice_split`` does."""
    if devices_per_slice is None:
        return 0
    per = int(devices_per_slice)
    if per <= 0 or world_size % per:
        raise InvalidArgument(f"devices_per_slice={per} does not divide "
                              f"the {world_size}-rank world")
    return per if per < world_size else 0


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
    intra = inter = None

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(1, -1).clone()

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return _reduce_gathered(self.all_gather(t), op, t.shape)

    def exchange(self, send: torch.Tensor, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
        return send[:int(send_counts[0])].clone()


class _RankComm:
    """One rank's view of a :class:`ThreadWorld` (or of one of its
    sub-worlds)."""

    intra = inter = None

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
    on every rank and returns the results in rank order.

    ``devices_per_slice=L`` (dividing W, below it) makes the world two
    tiers of W / L slices: each rank's communicator carries ``intra``
    and ``inter``, each a rank of a sub-world with its own barrier and
    slots (the module docstring)."""

    def __init__(self, world_size: int, timeout: float = 120.0,
                 devices_per_slice: "int | None" = None):
        self.world_size = world_size
        self.barrier = threading.Barrier(world_size, timeout=timeout)
        self.slots = [None] * world_size
        per = self._per = slice_size(world_size, devices_per_slice)
        self._intra = [ThreadWorld(per, timeout)
                       for _ in range(world_size // per)] if per else []
        self._inter = [ThreadWorld(world_size // per, timeout)
                       for _ in range(per)]

    def comms(self) -> list:
        out = []
        per = self._per
        for r in range(self.world_size):
            comm = _RankComm(self, r)
            if per:
                comm.intra = _RankComm(self._intra[r // per], r % per)
                comm.inter = _RankComm(self._inter[r % per], r // per)
            out.append(comm)
        return out

    def _abort(self) -> None:
        """Break this world's barrier and every sub-world's, so that no
        rank waits out the timeout on a peer that raised."""
        self.barrier.abort()
        for sub in self._intra + self._inter:
            sub.barrier.abort()

    def run(self, fn: Callable) -> list:
        results = [None] * self.world_size
        errors = []

        def rank_main(comm):
            try:
                results[comm.rank] = fn(comm)
            except BaseException as e:   # noqa: BLE001 -- re-raised below
                errors.append(e)
                self._abort()            # free the ranks waiting on us

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
    - :meth:`all_reduce`: an all-gather and a fold in rank order.

    ``devices_per_slice=L`` (of the default group only) makes the world
    two tiers: every rank creates the slices' groups and then the local
    indices' groups, in one order
    (``torch.distributed.new_subgroups_by_enumeration``), and ``intra``
    and ``inter`` wrap its own two."""

    intra = inter = None

    def __init__(self, group=None, devices_per_slice: "int | None" = None):
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
        per = slice_size(self.world_size, devices_per_slice)
        if per and group is not None:
            raise InvalidArgument("ProcessGroupComm: devices_per_slice "
                                  "splits the default group only")
        if per:
            w = self.world_size
            slices = [list(range(s, s + per)) for s in range(0, w, per)]
            lanes = [list(range(j, w, per)) for j in range(per)]
            mine, _ = dist.new_subgroups_by_enumeration(slices)
            self.intra = ProcessGroupComm(mine)
            mine, _ = dist.new_subgroups_by_enumeration(lanes)
            self.inter = ProcessGroupComm(mine)

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
