"""Distributed tables: each rank holds its own shard.

Port of ``cylon_tpu/parallel/dtable.py:79-150``. The JAX package keeps one
global table laid out over the mesh; here, as in the reference ("one Arrow
table per MPI rank", ``docs/docs/arch.md:41-48``), a distributed table on a
rank IS that rank's local shard: an ordinary :class:`Table`.
"""

import hashlib

import numpy as np
import torch

from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
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


def shard_sizes(env, table) -> tuple:
    """Every rank's valid-row count and capacity, in rank order, as two
    lists (one all-gather, one host sync). Ranks that ingest their own
    rows hold different capacities."""
    mine = torch.stack([table.nrows.reshape(()).to(torch.int64),
                        torch.tensor(table.capacity, dtype=torch.int64,
                                     device=table.device)])
    got = env.comm.all_gather(mine).reshape(-1, 2).tolist()
    return [c for c, _ in got], [k for _, k in got]


def _checked_sizes(env, table) -> tuple:
    """:func:`shard_sizes`, raising OutOfCapacity if any rank's shard
    overflowed its capacity."""
    counts, caps = shard_sizes(env, table)
    if any(c > k for c, k in zip(counts, caps)):
        raise OutOfCapacity(
            f"shard row counts {counts} exceed local capacities {caps}; "
            "re-run with a larger out_capacity")
    return counts, caps


def shard_counts(env, table) -> list:
    """Every rank's valid-row count, in rank order (one host sync).
    Raises OutOfCapacity if any rank's shard overflowed its capacity."""
    return _checked_sizes(env, table)[0]


def dist_num_rows(env, table) -> int:
    """Total valid rows across ranks."""
    return sum(shard_counts(env, table))


def _value_blob(dictionary) -> tuple:
    """A dictionary's values as ``(lengths, blob)``: each value's bytes
    behind a tag byte (``s`` and its UTF-8 for a str, ``b`` and itself
    for bytes) and their concatenation, the form in which ranks gather
    each other's dictionaries."""
    raw = []
    for v in ([] if dictionary is None else dictionary.values):
        if isinstance(v, str):
            raw.append(b"s" + v.encode())
        elif isinstance(v, bytes):
            raw.append(b"b" + v)
        else:
            raise InvalidArgument(
                f"dictionary value {v!r}: only str and bytes values are "
                "exchanged between ranks")
    return (np.array([len(b) for b in raw], np.int64),
            np.frombuffer(b"".join(raw), np.uint8))


def _digest(lengths, blob) -> int:
    """64 bits of the sha-256 of a value blob, as a signed int."""
    h = hashlib.sha256(lengths.tobytes() + blob.tobytes()).digest()
    return int.from_bytes(h[:8], "little", signed=True)


def _gather_dictionaries(env, device, lengths, blob) -> list:
    """Every rank's dictionary, in rank order, from each rank's value blob
    (three all-gathers: the sizes, then the lengths and the bytes padded
    to the largest)."""
    from cylon_tpu_torch.column import Dictionary

    comm = env.comm
    sizes = comm.all_gather(torch.tensor([len(lengths), len(blob)],
                                         dtype=torch.int64, device=device))
    sizes = sizes.reshape(-1, 2).tolist()
    nmax = max(n for n, _ in sizes)
    bmax = max(b for _, b in sizes)
    lpad = np.zeros(nmax, np.int64)
    lpad[:len(lengths)] = lengths
    bpad = np.zeros(bmax, np.uint8)
    bpad[:len(blob)] = blob
    all_l = comm.all_gather(torch.from_numpy(lpad).to(device)).cpu().numpy()
    all_b = comm.all_gather(torch.from_numpy(bpad).to(device)).cpu().numpy()
    out = []
    for (n, nb), ls, bs in zip(sizes, all_l, all_b):
        ends = np.cumsum(ls[:n])
        raw = bs[:nb].tobytes()
        vals = [raw[e - ln:e] for ln, e in zip(ls[:n], ends)]
        vals = [v[1:].decode() if v[:1] == b"s" else v[1:] for v in vals]
        out.append(Dictionary(np.array(vals, object)))
    return out


def world_layout(env, table):
    """``table`` brought to the layout every rank's shard shares, so that
    rows exchanged between ranks line up and read back as they were
    sent. Ranks that ingest their own rows hold different layouts of one
    table: another width for a device-bytes column, a validity mask on
    some ranks only, another dictionary (a code read against another
    rank's dictionary names another string). Each bytes column is padded
    to the widest word count any rank holds, a validity mask is added
    where any rank has one, and each dictionary column whose dictionary
    differs between ranks is re-encoded onto the merge of all of them
    (:func:`cylon_tpu_torch.ops.dictenc.merge_dictionaries`, in rank
    order, so every rank takes the same codes). One all-gather of a
    per-column summary; three more for each dictionary that differs.
    A column stored one way on one rank and another way on another (bytes
    against codes, say) is refused."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.dtypes import string_bytes
    from cylon_tpu_torch.ops.bytescol import WORD, pad_words
    from cylon_tpu_torch.ops.dictenc import merge_dictionaries, remap_codes

    if env.world_size == 1:
        return table
    names = table.column_names
    blobs, summary = {}, []
    for n in names:
        c = table.column(n)
        digest = 0
        if c.dtype.is_dictionary:
            blobs[n] = _value_blob(c.dictionary)
            digest = _digest(*blobs[n])
        summary.append([2 if c.dtype.is_dictionary else int(c.dtype.is_bytes),
                        c.data.shape[1] if c.dtype.is_bytes else 0,
                        int(c.validity is not None), digest])
    mine = torch.tensor(summary, dtype=torch.int64, device=table.device)
    ranks = env.comm.all_gather(mine.reshape(-1)).reshape(
        env.world_size, len(names), 4)
    for i, n in enumerate(names):
        kinds, widths, masks, digests = ranks[:, i].T.tolist()
        c = table.column(n)
        if len(set(kinds)) > 1:
            raise InvalidArgument(
                f"column {n!r} is stored differently across ranks (by "
                f"rank: {kinds}; 0 fixed width, 1 device bytes, 2 "
                "dictionary codes): ingest every shard with one "
                "string_storage")
        if c.dtype.is_bytes and c.data.shape[1] < max(widths):
            nw = max(widths)
            c = Column(pad_words(c.data, nw), c.validity,
                       string_bytes(nw * WORD), None)
        if c.validity is None and any(masks):
            c = Column(c.data, torch.ones(c.capacity, dtype=torch.bool,
                                          device=c.data.device),
                       c.dtype, c.dictionary)
        if c.dtype.is_dictionary and len(set(digests)) > 1:
            dicts = _gather_dictionaries(env, table.device, *blobs[n])
            shared, remaps = merge_dictionaries(dicts)
            c = remap_codes(c, remaps[env.rank], shared)
        if c is not table.column(n):
            table = table.add_column(n, c)
    return table


def gather_table(env, table):
    """Every rank's valid rows, in rank order, as one local table on every
    rank (its capacity the sum of the ranks'), in the layout of
    :func:`world_layout`."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    w = env.world_size
    table = world_layout(env, table)
    counts, caps = _checked_sizes(env, table)
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
    buf = torch.zeros((sum(caps), packed.shape[1]),
                      dtype=torch.int32, device=packed.device)
    buf[:total] = got
    outs = iter(_unpack_words(buf, spec))
    cols = {}
    for name, c in table.columns.items():
        data = next(outs)
        validity = next(outs) if c.validity is not None else None
        cols[name] = Column(data, validity, c.dtype, c.dictionary)
    return Table(cols, total)
