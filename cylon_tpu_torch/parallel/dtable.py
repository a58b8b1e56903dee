"""Distributed tables: each rank holds its own shard.

Port of ``cylon_tpu/parallel/dtable.py:79-150``. The JAX package keeps one
global table laid out over the mesh; here, as in the reference ("one Arrow
table per MPI rank", ``docs/docs/arch.md:41-48``), a distributed table on a
rank IS that rank's local shard: an ordinary :class:`Table`.
"""

import torch

from cylon_tpu_torch.errors import OutOfCapacity
from cylon_tpu_torch.parallel.shuffle import _pack_words, _unpack_words


def scatter_table(env, table, local_cap: "int | None" = None):
    """This rank's contiguous row block of a (local, whole) table: rows
    ``[rank * local_cap, (rank + 1) * local_cap)``, with
    ``local_cap = ceil(capacity / W)`` as in ``dtable.py:93-98``."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    w, r = env.world_size, env.rank
    cap = table.capacity
    if local_cap is None:
        local_cap = -(-cap // w)
    padded = table.with_capacity(w * local_cap)
    lo, hi = r * local_cap, (r + 1) * local_cap
    cols = {n: Column(c.data[lo:hi],
                      None if c.validity is None else c.validity[lo:hi],
                      c.dtype, c.dictionary)
            for n, c in padded.columns.items()}
    nrows = torch.clamp(table.nrows - lo, 0, local_cap)
    return Table(cols, nrows)


def shard_counts(env, table) -> list:
    """Every rank's valid-row count, in rank order (one host sync).
    Raises OutOfCapacity if any rank's shard overflowed its capacity."""
    counts = env.comm.all_gather(table.nrows.reshape(1)).reshape(-1).tolist()
    if any(c > table.capacity for c in counts):
        raise OutOfCapacity(
            f"shard row counts {counts} exceed local capacity "
            f"{table.capacity}; re-run with a larger out_capacity")
    return counts


def dist_num_rows(env, table) -> int:
    """Total valid rows across ranks."""
    return sum(shard_counts(env, table))


def gather_table(env, table):
    """Every rank's valid rows, in rank order, as one local table on every
    rank (capacity ``W * shard capacity``)."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    w = env.world_size
    counts = shard_counts(env, table)
    n = counts[env.rank]
    arrays = []
    for c in table.columns.values():
        arrays.append(c.data[:n])
        if c.validity is not None:
            arrays.append(c.validity[:n])
    packed, spec = _pack_words(arrays)
    # every rank sends its rows to every rank: the exchange's send matrix
    # holds W copies, one per destination
    got = env.comm.exchange(packed.repeat(w, 1), [n] * w, counts)
    total = sum(counts)
    buf = torch.zeros((w * table.capacity, packed.shape[1]),
                      dtype=torch.int32, device=packed.device)
    buf[:total] = got
    outs = iter(_unpack_words(buf, spec))
    cols = {}
    for name, c in table.columns.items():
        data = next(outs)
        validity = next(outs) if c.validity is not None else None
        cols[name] = Column(data, validity, c.dtype, c.dictionary)
    return Table(cols, total)
