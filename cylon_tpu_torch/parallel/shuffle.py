"""The table shuffle: exact-count row exchange between ranks.

Port of ``cylon_tpu/parallel/shuffle.py`` with ONE path, the exact-count
exchange of its ragged route (``shuffle.py:131-152``), which replaces the
reference's streaming all-to-all (``net/ops/all_to_all.hpp:65-170``):

1. **count exchange**: every rank counts its rows by destination and
   all-gathers the [W] vector, so every rank knows the W x W matrix;
2. **payload exchange**: one stable destination sort, every column packed
   into ONE [rows, words] u32 word matrix (int32 bit patterns), one
   exchange of exactly the rows each pair needs, unpack.

Received rows are grouped by sender rank, each sender's order kept.
A receive larger than ``out_cap`` is truncated and reported as
``nrows = out_cap + 1``, exactly as in JAX. On a two-tier world the
exchange runs in two stages, inside the slices and then between them
(:func:`_exchange_hier`), with the same result.
"""

import typing

import torch

from cylon_tpu_torch.column import Column
from cylon_tpu_torch.kernels import gather_rows
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.selection import _dense
from cylon_tpu_torch.telemetry import trace
from cylon_tpu_torch.utils.tracing import span


def exchange_arrays(comm, arrays, pid: torch.Tensor, n_local, out_cap: int,
                    ledger: "list | None" = None):
    """Send row i of every array to rank ``pid[i]``; receive the peers'.

    arrays: [cap] tensors sharing the row dim; pid: [cap] int32
    destinations; n_local: valid leading rows. Returns ``(out_arrays,
    n_recv)`` with the arrays at capacity ``out_cap`` and ``n_recv`` the
    0-d int32 received count, or ``out_cap + 1`` on overflow. On a
    two-tier comm (``comm.intra``) the rows go in two stages
    (:func:`_exchange_hier`), with the same result.

    ``ledger``, when given, receives one :class:`Stage` an exchange
    stage: the host row counts every rank of the stage's group already
    holds, and the u32 words a row, which the dist ops' telemetry prices
    the exchange from (no transfer of its own).
    """
    if comm.intra is not None:
        return _exchange_hier(comm, arrays, pid, n_local, out_cap, ledger)
    return _exchange(comm, arrays, pid, n_local, out_cap, ledger, "flat",
                     list(range(comm.world_size)))


class Stage(typing.NamedTuple):
    """One exchange stage as the ledger keeps it: ``stage`` is
    ``"flat"``, ``"intra"`` or ``"inter"``; ``cmat`` the host ``[n send,
    n dest]`` row counts of the stage's group; ``words`` the u32 words a
    row on the wire (the intra stage's rider included); ``ranks`` the
    group's members as global ranks, in group order."""

    stage: str
    cmat: torch.Tensor
    words: int
    ranks: list


def _exchange(comm, arrays, pid, n_local, out_cap, ledger, stage, ranks):
    """The exact-count exchange over one communicator. ``out_cap`` None
    receives exactly the rows sent (a stage's middle buffer: it cannot
    overflow)."""
    w = comm.world_size
    cap = pid.shape[0]
    dev = pid.device
    valid = kernels.valid_mask(cap, n_local, dev)
    pid = torch.where(valid, pid.to(torch.int32), w)

    # group rows by destination: one stable sort (parity: the
    # reference's per-target Split kernels, partition/partition.cpp:26);
    # no valid row holds the maximum key, so a mask n_local is exact too
    order = kernels.sort_perm([kernels.order_key(pid)], valid)
    counts = torch.bincount(pid.to(torch.int64), minlength=w + 1)[:w]
    cmat = comm.all_gather(counts.to(torch.int32)).cpu()   # [W send, W dest]
    send_counts = cmat[comm.rank].tolist()
    recv_counts = cmat[:, comm.rank].tolist()
    n_send = sum(send_counts)
    n_recv_true = sum(recv_counts)

    packed, spec = _pack_words(arrays)
    # the path the exchange took (``cylon_tpu/parallel/shuffle.py:59``):
    # the port has one, the exact-count route the JAX package calls
    # "ragged"; its CYLON_TPU_SHUFFLE override has no counterpart here
    trace.instant("shuffle.path", cat="exchange", path="ragged",
                  mode="exact", stage=stage)
    if ledger is not None:
        ledger.append(Stage(stage, cmat, int(packed.shape[1]), ranks))
    got = comm.exchange(gather_rows(packed.contiguous(), order[:n_send]),
                        send_counts, recv_counts)
    if out_cap is None:
        return (_unpack_words(got, spec),
                torch.tensor(n_recv_true, dtype=torch.int32, device=dev))
    buf = torch.zeros((out_cap, packed.shape[1]), dtype=torch.int32,
                      device=dev)
    k = min(n_recv_true, out_cap)
    buf[:k] = got[:k]
    n_recv = out_cap + 1 if n_recv_true > out_cap else n_recv_true
    return (_unpack_words(buf, spec),
            torch.tensor(n_recv, dtype=torch.int32, device=dev))


def _exchange_hier(comm, arrays, pid, n_local, out_cap, ledger):
    """The two-stage exchange of a two-tier world (port of
    ``cylon_tpu/parallel/shuffle.py:346-406``), L ranks a slice:

    1. **intra** (over ``comm.intra``, the slice's fast links): each row
       goes to the rank of its slice whose local index is the row's
       final one, ``pid % L``, with ``pid`` riding as one int32 column;
    2. **inter** (over ``comm.inter``): each row goes to the slice
       ``rider // L``, between ranks of one local index, and the rider is
       dropped.

    Every transfer between slices is then between ranks of one local
    index: L parallel streams, where a flat exchange would put
    ``(S - 1) * L`` of every rank's W peer streams on the slow tier.

    The received rows come out grouped by the sender's global rank
    (slice-major), each sender's order kept, as the flat exchange's:
    stage 1 groups the rows by in-slice sender, and stage 2's stable
    destination sort keeps that order inside each slice's block. So a
    two-tier world and a flat one of the same W give every rank the same
    bits.

    Stage 1 receives the exact count its own count matrix gives, so it
    cannot overflow, and only stage 2 applies ``out_cap``: the JAX
    package's stage-1 probe (``_probe_hier_mid``), which sizes a padded
    middle buffer, and its poisoning of every shard on a stage-1
    overflow have nothing to do here.
    """
    per = comm.intra.world_size
    me = comm.rank
    pid = pid.to(torch.int32)
    with span("shuffle.intra", cat="exchange"):
        mids, n_mid = _exchange(
            comm.intra, list(arrays) + [pid], pid % per, n_local, None,
            ledger, "intra", [me - me % per + i for i in range(per)])
    with span("shuffle.inter", cat="exchange"):
        return _exchange(
            comm.inter, mids[:-1], mids[-1] // per, n_mid, out_cap, ledger,
            "inter", [me % per + s * per
                      for s in range(comm.inter.world_size)])


def transport_words(table) -> int:
    """u32 words per row that the exchange moves for ``table`` (the
    :func:`_pack_words` widths)."""
    n = 0
    for c in table.columns.values():
        if c.data.dim() == 2:
            n += c.data.shape[1]
        else:
            n += 2 if c.data.element_size() == 8 else 1
        if c.validity is not None:
            n += 1
    return n


def checked_recv(table, out_cap: int):
    """Split a shuffled table into (usable table, overflow flag): the
    count clamps to ``out_cap`` and the flag carries the overflow on."""
    of = table.nrows > out_cap
    return table.with_nrows(torch.clamp(table.nrows, max=out_cap)), of


def poison(table, *flags):
    """Mark a result table invalid (``nrows = capacity + 1``) if any
    upstream shuffle on this rank overflowed."""
    bad = flags[0]
    for f in flags[1:]:
        bad = bad | f
    return table.with_nrows(torch.where(
        bad, table.capacity + 1,
        torch.clamp(table.nrows, max=table.capacity + 1)))


def _pack_words(arrays):
    """All arrays bit-packed into ONE [cap, words] int32 matrix, plus the
    spec for :func:`_unpack_words`. A device-bytes column ([cap, nwords]
    int32 words) rides as its words, the spec keeping its width (the JAX
    ``words`` kind); 64-bit values ride as their (lo, hi) words (the JAX
    ``i64pair`` and non-TPU ``bits64`` kinds), 32-bit ones as one word,
    bool and 8/16-bit values zero-extended into one word."""
    mats, spec = [], []
    for a in arrays:
        dt = a.dtype
        size = a.element_size()
        if a.dim() == 2:
            if dt != torch.int32:
                raise TypeError(f"_pack_words: a 2-D array must be int32 "
                                f"words, got {dt}")
            mats.append(a)
            spec.append(("words", a.shape[1], dt))
        elif dt == torch.bool:
            mats.append(a.to(torch.int32)[:, None])
            spec.append(("bool", 1, dt))
        elif size == 8:
            mats.append(a.contiguous().view(torch.int32).view(-1, 2))
            spec.append(("bits64" if a.is_floating_point() else "i64pair",
                         2, dt))
        elif size == 4:
            mats.append(a.contiguous().view(torch.int32)[:, None])
            spec.append(("bits32", 1, dt))
        else:
            unsigned = torch.uint8 if size == 1 else torch.int16
            mats.append((a.contiguous().view(unsigned).to(torch.int32)
                         & ((1 << (8 * size)) - 1))[:, None])
            spec.append(("small", 1, dt))
    packed = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
    return packed, spec


def _unpack_words(m: torch.Tensor, spec) -> list:
    outs = []
    off = 0
    for kind, w, dt in spec:
        sl = m[:, off:off + w]
        off += w
        if kind == "words":
            outs.append(sl)
        elif kind == "bool":
            outs.append(sl[:, 0] != 0)
        elif kind in ("bits64", "i64pair"):
            outs.append(_dense(sl).view(dt).view(-1))
        elif kind == "bits32":
            outs.append(sl[:, 0].contiguous().view(dt))
        else:
            narrow = torch.uint8 if dt.itemsize == 1 else torch.int16
            outs.append(sl[:, 0].to(narrow).view(dt))
    return outs


def shuffle_local(comm, table, pid: torch.Tensor, out_cap: int,
                  ledger: "list | None" = None):
    """Rank-local table shuffle: every valid row moves to rank pid[row].
    Parity: ``shuffle_table_by_hashing`` (``table.cpp:134``). ``ledger``
    as :func:`exchange_arrays`'."""
    from cylon_tpu_torch.table import Table

    arrays = []
    layout = []   # (name, has_validity)
    for name, c in table.columns.items():
        arrays.append(c.data)
        if c.validity is not None:
            arrays.append(c.validity)
        layout.append((name, c.validity is not None))
    outs, n_recv = exchange_arrays(comm, arrays, pid, table.nrows, out_cap,
                                   ledger)
    cols = {}
    i = 0
    for name, has_v in layout:
        c = table.columns[name]
        data = outs[i]
        i += 1
        validity = None
        if has_v:
            validity = outs[i]
            i += 1
        cols[name] = Column(data, validity, c.dtype, c.dictionary)
    return Table(cols, n_recv)
