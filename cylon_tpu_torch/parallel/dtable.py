"""Distributed tables: each rank holds its own shard.

Port of ``cylon_tpu/parallel/dtable.py:79-150``. The JAX package keeps one
global table laid out over the mesh; here, as in the reference ("one Arrow
table per MPI rank", ``docs/docs/arch.md:41-48``), a distributed table on a
rank IS that rank's local shard: an ordinary :class:`Table`.
"""

import hashlib

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.dtypes import Layout, string_bytes
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.ops.bytescol import WORD, pad_words, width_words
from cylon_tpu_torch.parallel.shuffle import _pack_words, _unpack_words
from cylon_tpu_torch.utils.tracing import host_read


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
    cap = host_read("stage", lambda: torch.tensor(
        table.capacity, dtype=torch.int64, device=table.device))
    mine = torch.stack([table.nrows.reshape(()).to(torch.int64), cap])
    got = host_read("shard_sizes", lambda: env.comm.all_gather(
        mine).reshape(-1, 2).tolist())
    return [c for c, _ in got], [k for _, k in got]


def _check_fit(counts, caps) -> None:
    """Raise OutOfCapacity if any rank's row count passes its capacity
    (an upstream op overflowed)."""
    if any(c > k for c, k in zip(counts, caps)):
        raise OutOfCapacity(
            f"shard row counts {counts} exceed local capacities {caps}; "
            "re-run with a larger out_capacity")


def _checked_sizes(env, table) -> tuple:
    """:func:`shard_sizes`, raising OutOfCapacity if any rank's shard
    overflowed its capacity."""
    counts, caps = shard_sizes(env, table)
    _check_fit(counts, caps)
    return counts, caps


def shard_counts(env, table) -> list:
    """Every rank's valid-row count, in rank order (one host sync).
    Raises OutOfCapacity if any rank's shard overflowed its capacity."""
    return _checked_sizes(env, table)[0]


def dist_num_rows(env, table) -> int:
    """Total valid rows across ranks."""
    return sum(shard_counts(env, table))


def _value_blob(values) -> tuple:
    """Values as ``(lengths, blob)``: each value's bytes behind a tag
    byte (``s`` and its UTF-8 for a str, ``b`` and itself for bytes) and
    their concatenation, the form in which ranks gather each other's
    dictionaries, column names and type names."""
    raw = []
    for v in values:
        if isinstance(v, str):
            raw.append(b"s" + v.encode())
        elif isinstance(v, bytes):
            raw.append(b"b" + v)
        else:
            raise InvalidArgument(
                f"value {v!r}: only str and bytes values are exchanged "
                "between ranks")
    return (np.array([len(b) for b in raw], np.int64),
            np.frombuffer(b"".join(raw), np.uint8))


def _digest(lengths, blob) -> int:
    """64 bits of the sha-256 of a value blob, as a signed int."""
    h = hashlib.sha256(lengths.tobytes() + blob.tobytes()).digest()
    return int.from_bytes(h[:8], "little", signed=True)


def _values_digest(values) -> int:
    return _digest(*_value_blob(values))


def _gather_values(env, device, values) -> list:
    """Every rank's ``values`` (a list of str or bytes), in rank order, as
    object arrays (three all-gathers: the sizes, then the lengths and the
    bytes padded to the largest)."""
    lengths, blob = _value_blob(values)
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
    all_l = comm.all_gather(from_host(lpad, device)).cpu().numpy()
    all_b = comm.all_gather(from_host(bpad, device)).cpu().numpy()
    out = []
    for (n, nb), ls, bs in zip(sizes, all_l, all_b):
        ends = np.cumsum(ls[:n])
        raw = bs[:nb].tobytes()
        vals = [raw[e - ln:e] for ln, e in zip(ls[:n], ends)]
        vals = [v[1:].decode() if v[:1] == b"s" else v[1:] for v in vals]
        out.append(np.array(vals, object))
    return out


def _dictionary_values(c) -> list:
    return [] if c.dictionary is None else list(c.dictionary.values)


def _type_name(dtype) -> str:
    """The logical type a column must share across ranks: its dtype's
    name, a string column's kind whatever its storage."""
    return dtype.kind.name.lower() if dtype.layout == Layout.VARIABLE_WIDTH \
        else repr(dtype)


def _in_rank0_order(env, table) -> tuple:
    """``table`` with its columns in rank 0's order, and every rank's row
    count and capacity in rank order. A fixed-size header goes first (the
    column count, a digest of the set of names and one of their order,
    the capacity, the row count), so that tables of different widths
    never mis-shape a gather; the names themselves are gathered only
    where the headers differ. A different set of names raises on every
    rank."""
    names = table.column_names
    header = torch.cat([
        torch.tensor([len(names), _values_digest(sorted(names)),
                      _values_digest(names), table.capacity],
                     dtype=torch.int64, device=table.device),
        table.nrows.reshape(1).to(torch.int64)])
    heads = env.comm.all_gather(header).tolist()
    counts, caps = [h[4] for h in heads], [h[3] for h in heads]
    if all(h[:3] == heads[0][:3] for h in heads):
        return table, counts, caps
    every = _gather_values(env, table.device, names)
    if any(h[:2] != heads[0][:2] for h in heads):
        raise InvalidArgument(
            "the ranks' tables hold different columns (by rank: "
            f"{[list(e) for e in every]}): every shard of a distributed "
            "table needs the same column names")
    return table.select(list(every[0])), counts, caps


def _check_types(env, table, digests) -> None:
    """Raise on every rank if a column's logical type differs between
    ranks; ``digests`` [W, ncols] are every rank's type-name digests."""
    bad = [i for i in range(digests.shape[1])
           if len(set(digests[:, i].tolist())) > 1]
    if not bad:
        return
    names = table.column_names
    every = _gather_values(env, table.device,
                           [_type_name(table.column(n).dtype)
                            for n in names])
    detail = "; ".join(f"column {names[i]!r}: "
                       f"{[str(e[i]) for e in every]}" for i in bad)
    raise InvalidArgument(
        f"column dtypes differ across ranks (by rank) -- {detail}: cast "
        "every shard to one dtype first")


def _bytes_words(c) -> "tuple[bool, int]":
    """Could this string column be device bytes, and in how many words?
    A bytes column is; a dictionary column is when every value is a str
    without a NUL byte (the case ``choose_storage`` sends to dictionary
    codes)."""
    if c.dtype.is_bytes:
        return True, c.data.shape[1]
    vals = _dictionary_values(c)
    ok = all(isinstance(v, str) and "\x00" not in v for v in vals)
    nbytes = max((len(v.encode()) for v in vals), default=0) if ok else 0
    return ok, width_words(nbytes)


def _one_storage(env, table, mixed: list) -> dict:
    """String columns stored as device bytes on some ranks and as
    dictionary codes on others, each brought to one storage chosen alike
    on every rank: device bytes at the widest width any rank needs, or
    dictionary codes where any rank's values cannot be bytes. One
    all-gather. Returns ``{name: column}``, this rank's columns in the
    chosen storage."""
    mine = torch.tensor([_bytes_words(table.column(n)) for n in mixed],
                        dtype=torch.int64, device=table.device)
    got = env.comm.all_gather(mine.reshape(-1)).reshape(
        env.world_size, len(mixed), 2)
    out = {}
    for i, n in enumerate(mixed):
        c = table.column(n)
        oks, words = got[:, i].T.tolist()
        if all(oks):
            out[n] = c.astype(string_bytes(max(words) * WORD))
        else:
            out[n] = c.astype(dtypes.string) if c.dtype.is_bytes else c
    return out


#: a column's storage in the layout summary
_FIXED, _BYTES, _DICT = 0, 1, 2


def world_layout(env, table):
    """:func:`world_layout_sized` without the sizes."""
    return world_layout_sized(env, table)[0]


def world_layout_sized(env, table) -> tuple:
    """``table`` brought to the layout every rank's shard shares, so that
    rows exchanged between ranks line up and read back as they were
    sent. Ranks that ingest their own rows hold different layouts of one
    table: their columns in another order, another width for a
    device-bytes column, a validity mask on some ranks only, another
    dictionary (a code read against another rank's dictionary names
    another string), or another storage for a string column
    (``string_storage="auto"`` decides per rank).

    Each rank's columns take rank 0's order. A string column stored as
    device bytes on some ranks and as codes on others converts to one
    storage (:func:`_one_storage`). Each bytes column is padded to the
    widest word count any rank holds, a validity mask is added where any
    rank has one, and each dictionary column whose dictionary differs
    between ranks is re-encoded onto the merge of all of them
    (:func:`cylon_tpu_torch.ops.dictenc.merge_dictionaries`, in rank
    order, so every rank takes the same codes). Another set of column
    names, or a column whose logical type differs between ranks (int64
    against float64, a string against a number), raises
    :class:`InvalidArgument` on every rank: nothing is cast.

    Collectives: one all-gather of a fixed-size header and one of a
    per-column summary; the column or type names where they differ, one
    more for columns of mixed storage, three more for each dictionary
    that differs.

    Returns the table, every rank's row count and every rank's capacity,
    in rank order (from the header: the operators read their sizes here
    and gather none of their own). A world of one reads its count on the
    host."""
    from cylon_tpu_torch.column import Column, Dictionary
    from cylon_tpu_torch.ops.dictenc import merge_dictionaries, remap_codes

    if env.world_size == 1:
        return table, [host_read("shard_sizes", lambda: int(table.nrows))], \
            [table.capacity]
    table, counts, caps = _in_rank0_order(env, table)
    names = table.column_names
    summary = []
    for n in names:
        c = table.column(n)
        kind = _DICT if c.dtype.is_dictionary else \
            _BYTES if c.dtype.is_bytes else _FIXED
        summary.append([
            kind, c.data.shape[1] if c.dtype.is_bytes else 0,
            int(c.validity is not None),
            _values_digest(_dictionary_values(c)) if kind == _DICT else 0,
            _values_digest([_type_name(c.dtype)])])
    mine = torch.tensor(summary, dtype=torch.int64, device=table.device)
    ranks = env.comm.all_gather(mine.reshape(-1)).reshape(
        env.world_size, len(names), 5)
    _check_types(env, table, ranks[:, :, 4])
    mixed = [n for i, n in enumerate(names)
             if set(ranks[:, i, 0].tolist()) == {_BYTES, _DICT}]
    converted = _one_storage(env, table, mixed) if mixed else {}
    for i, n in enumerate(names):
        _, widths, masks, digests = ranks[:, i, :4].T.tolist()
        c = converted.get(n, table.column(n))
        if c.dtype.is_bytes and c.data.shape[1] < max(widths):
            nw = max(widths)
            c = Column(pad_words(c.data, nw), c.validity,
                       string_bytes(nw * WORD), None)
        if c.validity is None and any(masks):
            c = Column(c.data, torch.ones(c.capacity, dtype=torch.bool,
                                          device=c.data.device),
                       c.dtype, c.dictionary)
        # a column that became codes on the bytes ranks took a dictionary
        # no digest saw
        if c.dtype.is_dictionary and (len(set(digests)) > 1 or n in mixed):
            dicts = [Dictionary(v) for v in _gather_values(
                env, table.device, _dictionary_values(c))]
            shared, remaps = merge_dictionaries(dicts)
            c = remap_codes(c, remaps[env.rank], shared)
        if c is not table.column(n):
            table = table.add_column(n, c)
    return table, counts, caps


def gather_table(env, table):
    """Every rank's valid rows, in rank order, as one local table on every
    rank (its capacity the sum of the ranks'), in the layout of
    :func:`world_layout`."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    w = env.world_size
    table, counts, caps = world_layout_sized(env, table)
    _check_fit(counts, caps)
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


def dist_to_pandas(env, table):
    """Every rank's valid rows, in rank order, as one pandas DataFrame on
    every rank (port of ``cylon_tpu/parallel/dtable.py:150``)."""
    return gather_table(env, table).to_pandas()
