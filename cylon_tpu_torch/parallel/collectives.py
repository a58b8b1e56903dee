"""Scalar and array collectives over a world of ranks.

Port of ``cylon_tpu/parallel/collectives.py`` (parity:
``cpp/src/cylon/net/comm_operations.hpp:27-31`` ``ReduceOp`` and
``net/mpi/mpi_operations.cpp``'s ``mpi::AllReduce``). The JAX package's
functions run inside ``shard_map`` over a mesh axis; here each rank calls
them with its :class:`~cylon_tpu_torch.context.CylonEnv`, and they go
through ``env.comm``. Every reduction is an all-gather and a fold in rank
order (``parallel.comm``), so every rank holds the same bits, as a
replicated JAX result does.
"""

import enum

import torch

_MIN64 = -(1 << 63)


class ReduceOp(enum.Enum):
    """Parity: ``net/comm_operations.hpp`` ReduceOp (port of
    ``cylon_tpu/parallel/collectives.py:19``)."""

    SUM = "sum"
    MIN = "min"
    MAX = "max"
    PROD = "prod"
    LAND = "land"
    LOR = "lor"
    BAND = "band"
    BOR = "bor"


_FOLDS = {ReduceOp.PROD: torch.mul, ReduceOp.LAND: torch.logical_and,
          ReduceOp.LOR: torch.logical_or, ReduceOp.BAND: torch.bitwise_and,
          ReduceOp.BOR: torch.bitwise_or}


def reduce_tensor(comm, val: torch.Tensor, op) -> torch.Tensor:
    """``val`` reduced over the ranks of ``comm`` by ``op`` (a
    :class:`ReduceOp` or its value): sum, min and max by
    ``comm.all_reduce``, unsigned values folded as int64 (uint64 on its
    bit pattern, its top bit flipped for min and max so that signed
    order is unsigned order; torch's CPU comparisons lack the unsigned
    types); the other ops by an all-gather folded in rank order (the
    logical ones give bool, as the JAX package's do)."""
    op = ReduceOp(op)
    dt = val.dtype
    if op in _FOLDS:
        rows = comm.all_gather(val).unbind(0)
        acc = rows[0]
        for r in rows[1:]:
            acc = _FOLDS[op](acc, r)
        return acc.reshape(val.shape)
    kind = op.value
    if dt in (torch.uint16, torch.uint32):
        return comm.all_reduce(val.to(torch.int64), kind).to(dt)
    if dt == torch.uint64:
        bits = val.view(torch.int64)
        if kind == "sum":
            return comm.all_reduce(bits, kind).view(torch.uint64)
        return (comm.all_reduce(bits ^ _MIN64, kind) ^ _MIN64).view(
            torch.uint64)
    return comm.all_reduce(val, kind)


def all_reduce(env, x: torch.Tensor, op=ReduceOp.SUM) -> torch.Tensor:
    """AllReduce over every rank of ``env`` (port of
    ``cylon_tpu/parallel/collectives.py:59``; parity ``mpi::AllReduce``,
    ``net/mpi/mpi_operations.cpp:37``)."""
    return reduce_tensor(env.comm, torch.as_tensor(x), op)


def rank(env) -> int:
    """This rank's index in the world (port of
    ``cylon_tpu/parallel/collectives.py:111``; parity
    ``CylonContext::GetRank``)."""
    return env.rank


def world(env) -> int:
    """The world's size (port of
    ``cylon_tpu/parallel/collectives.py:118``)."""
    return env.world_size
