"""Shared primitives of the join and group-by paths: order keys,
lexicographic sorts, group numbering, segment reductions, compaction,
scans and fills.

Port of ``cylon_tpu/ops/kernels.py:89-609``. Rows are grouped by
lexicographic dense rank (sort-based, collision-free). Tables are padded
to ``capacity`` and carry ``nrows``; padding rows sort last, in
:func:`sort_perm` by taking each key's maximum, in :func:`group_sort`
through an explicit padding key.

``lax.sort(operands, num_keys=k)`` has no torch counterpart. It becomes a
least-significant-first chain of stable ``torch.sort`` passes over the
packed key words (:func:`lexsort_perm`), which gives the lexicographic
order with ties in row order -- exactly the JAX order whenever the JAX
sort is stable or its keys are a total order.
"""

from typing import NamedTuple, Sequence

import torch

from cylon_tpu_torch.kernels import scan
from cylon_tpu_torch.ops.hash import M32, canonical_float, hash_columns

_MIN64 = -(1 << 63)
_MAX64 = (1 << 63) - 1
_BITS = {torch.bool: 8, torch.uint8: 8, torch.int8: 8, torch.uint16: 16,
         torch.int16: 16, torch.float16: 16, torch.uint32: 32,
         torch.int32: 32, torch.float32: 32, torch.uint64: 64,
         torch.int64: 64, torch.float64: 64}
_SIGNED_VIEW = {16: torch.int16, 32: torch.int32, 64: torch.int64}


class OrderKey(NamedTuple):
    """An unsigned sort key of ``bits`` bits whose unsigned order is the
    value order. ``value`` is int64: the key itself below 64 bits, the
    u64 bit pattern at 64."""

    value: torch.Tensor
    bits: int


def _ones(bits: int) -> int:
    return -1 if bits == 64 else (1 << bits) - 1


def order_key(data: torch.Tensor, ascending: bool = True) -> OrderKey:
    """Map values to an unsigned key whose order is the value order:
    signed ints get the sign bit flipped, floats the IEEE total-order
    transform after canonicalisation (NaN sorts above +inf), bools widen
    to 8 bits. ``ascending=False`` inverts every bit.

    A device-bytes column (``[cap, nwords]`` int32 words) keys each word
    as UNSIGNED 32 bits, as the JAX package's uint32 words are: the
    signed order of the int32 bit patterns would put a byte >= 0x80
    ("é") before ASCII. The key is then 2-D, one 32-bit key a word;
    :func:`pack_order_keys` splits it into its words, earlier first.
    Any other 2-D input raises ``TypeError``."""
    dt = data.dtype
    if data.dim() == 2:
        if dt != torch.int32:
            raise TypeError(f"order_key: a 2-D key must be int32 bytes "
                            f"words, got {dt}")
        key = data.to(torch.int64) & M32
        return OrderKey(key if ascending else ~key & M32, 32)
    if data.dim() != 1:
        raise TypeError(f"order_key: unsortable {data.dim()}-D input")
    if dt not in _BITS:
        raise TypeError(f"unsortable dtype {dt}")
    bits = _BITS[dt]
    if dt == torch.bool or dt in (torch.uint8, torch.uint16, torch.uint32):
        key = data.to(torch.int64)
    elif dt == torch.uint64:
        key = data.view(torch.int64)
    elif data.is_floating_point():
        b = canonical_float(data).view(_SIGNED_VIEW[bits]).to(torch.int64)
        if bits == 64:
            key = torch.where(b < 0, ~b, b | _MIN64)
        else:
            sign = 1 << (bits - 1)
            b = b & _ones(bits)
            key = torch.where((b & sign) != 0, ~b & _ones(bits), b | sign)
    elif bits == 64:
        key = data ^ _MIN64
    else:
        key = data.to(torch.int64) + (1 << (bits - 1))
    if not ascending:
        key = ~key if bits == 64 else ~key & _ones(bits)
    return OrderKey(key, bits)


def sortable(k: OrderKey) -> torch.Tensor:
    """int64 whose signed order is ``k``'s unsigned order."""
    return k.value ^ _MIN64 if k.bits == 64 else k.value


def valid_mask(cap: int, nrows, device=None) -> torch.Tensor:
    """[cap] bool valid-row mask. ``nrows`` is a count ("first n rows are
    valid") or already a [cap] bool mask (passed through)."""
    if torch.is_tensor(nrows) and nrows.dim() == 1:
        return nrows
    if device is None:
        device = nrows.device if torch.is_tensor(nrows) else "cpu"
    return torch.arange(cap, dtype=torch.int32, device=device) < nrows


def split_order_keys(okeys: Sequence[OrderKey]) -> list:
    """Expand 2-D order keys ([cap, w], device-bytes words) into one key a
    word, earlier words first."""
    out = []
    for k in okeys:
        if k.value.dim() == 2:
            out.extend(OrderKey(k.value[:, i], k.bits)
                       for i in range(k.value.shape[1]))
        else:
            out.append(k)
    return out


def pack_order_keys(okeys: Sequence[OrderKey]) -> list:
    """Greedily merge adjacent keys into shared words of at most 64 bits
    (earlier fields take the higher bits, so word order is field order --
    lossless). Fewer words mean fewer sort passes. A 2-D key (a
    device-bytes column's words) splits into its words first."""
    groups: list = []
    for k in split_order_keys(okeys):
        if groups and groups[-1][1] + k.bits <= 64:
            groups[-1][0].append(k)
            groups[-1][1] += k.bits
        else:
            groups.append([[k], k.bits])
    packed = []
    for fields, bits in groups:
        if len(fields) == 1:
            packed.append(fields[0])
            continue
        word = fields[0].value
        for f in fields[1:]:
            word = (word << f.bits) | f.value   # wraps into the u64 pattern
        packed.append(OrderKey(word, bits))
    return packed


def lexsort_perm(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation sorting rows by ``operands`` (int64, most
    significant first), ties in row order: one stable torch.sort per
    operand, least significant first."""
    perm = None
    for k in reversed(list(operands)):
        kk = k if perm is None else k[perm]
        idx = torch.sort(kk, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def sort_perm(okeys: Sequence[OrderKey], nrows) -> torch.Tensor:
    """int64 permutation sorting rows by the order keys ``okeys`` (most
    significant first), valid rows first, padding last; stable. Parity:
    ``SortIndicesMultiColumns`` (``arrow_kernels.hpp:134-140``).

    Padding takes no key of its own: every packed operand takes its
    maximum on the padding rows, so a padding row ties at most with a
    valid row holding the maximum tuple. Where the padding trails
    (``nrows`` a count), the stable sort keeps that valid row, whose
    index is lower, first. A mask ``nrows`` with padding between valid
    rows is exact only where no valid row holds the maximum tuple."""
    cap = okeys[0].value.shape[0] if okeys else 0
    packed = pack_order_keys(okeys)
    if not packed:
        return torch.arange(cap, dtype=torch.int64,
                            device=nrows.device if torch.is_tensor(nrows)
                            else None)
    dev = packed[0].value.device
    valid = valid_mask(cap, nrows, dev)
    return lexsort_perm([torch.where(valid, sortable(k), _MAX64 if
                                     k.bits == 64 else _ones(k.bits))
                         for k in packed])


def compact_mask(mask: torch.Tensor, nrows):
    """Stable-partition selected valid rows to the front. Returns
    ``(perm, count)``: ``perm[:count]`` lists the selected rows in
    original order."""
    valid = mask & valid_mask(mask.shape[0], nrows, mask.device)
    perm = torch.sort((~valid).to(torch.int8), stable=True).indices
    return perm, valid.sum(dtype=torch.int32)


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum in x's dtype; gated 32-bit arrays take the scan
    kernel (the plain version on the CPU)."""
    if scan.scan32_ok(x):
        return scan.scan32(x, "add")
    return torch.cumsum(x, 0, dtype=x.dtype)


def fast_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max; gated 32-bit arrays take the scan kernel."""
    if scan.scan32_ok(x):
        return scan.scan32(x, "max")
    return torch.cummax(x, 0).values


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return fast_cumsum(x) - x


def group_sort(keys: Sequence[torch.Tensor], nrows,
               validities: "Sequence[torch.Tensor | None] | None" = None,
               payloads: Sequence[torch.Tensor] = (),
               suborder: Sequence[OrderKey] = (),
               hash_first: bool = False):
    """One lexicographic sort that groups rows by key and carries
    ``payloads`` into group order.

    Null keys equal each other and rank last at their level (the key
    takes its maximum word, then an inverted-validity word breaks the tie
    with a genuine maximum). A device-bytes key ([cap, nwords] words) is
    its words in order, each keyed as UNSIGNED 32 bits (the int32 bit
    patterns' signed order would put bytes >= 0x80 before ASCII); a null
    row zeroes every word, and its first word takes the maximum and the
    inverted-validity tiebreak, so the empty string sorts first and null
    last, as in pandas. ``suborder`` keys rank below the key columns
    and order rows within a group without splitting it; their sorted
    values lead the returned payloads.

    ``hash_first`` orders groups by murmur row hash instead of key rank
    (the JAX package's rendition of the reference's HASH join): the u32
    hash leads the key words, which then only break collisions, so group
    identity stays exact but group ids are not in key order.

    Returns ``(gid_sorted [cap] int32, num_groups 0-d int32,
    sorted_payloads)``; ``gid_sorted`` is monotone over valid rows and
    ``cap`` on padding.
    """
    cap = keys[0].shape[0]
    dev = keys[0].device
    full = []
    if hash_first:
        full.append(OrderKey(hash_columns(keys, validities).to(torch.int64)
                             & M32, 32))
    for i, k in enumerate(keys):
        v = validities[i] if validities is not None else None
        if k.dim() == 2:
            if v is not None:
                k = torch.where(v[:, None], k, 0)
            keys_u = split_order_keys([order_key(k)])
            if v is not None:
                keys_u[0] = OrderKey(torch.where(v, keys_u[0].value, M32),
                                     32)
                keys_u.insert(1, OrderKey((~v).to(torch.int64), 8))
            full.extend(keys_u)
            continue
        nk = order_key(k)
        if v is None:
            full.append(nk)
            continue
        full.append(OrderKey(torch.where(
            v, nk.value, torch.full((), _ones(nk.bits), dtype=torch.int64,
                                    device=dev)), nk.bits))
        full.append(OrderKey((~v).to(torch.int64), 8))
    vmask = valid_mask(cap, nrows, dev)
    total_valid = vmask.sum(dtype=torch.int32)
    key_ops = [sortable(k) for k in pack_order_keys(
        [OrderKey((~vmask).to(torch.int64), 8)] + full)]
    perm = lexsort_perm(key_ops + [sortable(k) for k in suborder])
    sorted_keys = [k[perm] for k in key_ops]
    sorted_payloads = [k.value[perm] for k in suborder] \
        + [p[perm] for p in payloads]
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    valid_sorted = iota < total_valid
    # the padding flag is 0 across valid rows, so boundaries on the packed
    # words are boundaries on the raw key tuple there
    neq_prev = torch.zeros(cap, dtype=torch.bool, device=dev)
    for k in sorted_keys:
        neq_prev |= k != torch.roll(k, 1)   # in place: a fresh mask
    boundary = ((iota == 0) | neq_prev) & valid_sorted
    gid_sorted = fast_cumsum(boundary.to(torch.int32)) - 1
    if cap:
        num_groups = torch.where(total_valid > 0, gid_sorted[-1] + 1,
                                 0).to(torch.int32)
    else:
        num_groups = torch.zeros((), dtype=torch.int32, device=dev)
    gid_sorted = torch.where(valid_sorted, gid_sorted, cap)
    return gid_sorted, num_groups, sorted_payloads


def forward_fill(mark: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Broadcast ``val`` forward from marked positions (the most recent
    mark wins); positions before the first mark get 0. Returns int32.

    One running max over (position, value) pairs: gated sizes take the
    pair_max_scan kernel; below the gate a u64 cummax (packed into int64:
    positions stay below 2^31)."""
    cap = val.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=val.device)
    if scan.scan32_ok(val):
        zero = torch.zeros((), dtype=torch.int32, device=val.device)
        hi = torch.where(mark, iota, zero)
        lo = torch.where(mark, val.to(torch.int32), zero)
        _, filled = scan.pair_max_scan(hi, lo)
        return filled
    enc = torch.where(mark, (iota.to(torch.int64) << 32)
                      | (val.to(torch.int64) & M32),
                      torch.zeros((), dtype=torch.int64, device=val.device))
    filled = torch.cummax(enc, 0).values
    return (filled & M32).to(torch.int32)


def reverse_fill(mark: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Broadcast ``val`` backward from marked positions (the nearest
    following mark wins); positions after the last mark get 0."""
    return forward_fill(mark.flip(0), val.flip(0)).flip(0)


def carry_overflow(out, *inputs):
    """If any input's ``nrows`` exceeds its capacity (an upstream bounded
    operator overflowed), mark ``out`` the same way (``nrows = capacity +
    1``) so that its host-side ``num_rows`` raises."""
    bad = None
    for t in inputs:
        b = t.nrows > t.capacity
        bad = b if bad is None else bad | b
    return out.with_nrows(torch.where(bad, out.capacity + 1, out.nrows))


def dense_group_ids(keys: Sequence[torch.Tensor], nrows,
                    validities: "Sequence[torch.Tensor | None] | None" = None,
                    hash_first: bool = False):
    """Each valid row's dense group id in ``[0, num_groups)``, in row
    order (port of ``cylon_tpu/ops/kernels.py:258``): two rows share an
    id iff their key tuples are equal (a null equals a null), ids in key
    order (hash order with ``hash_first``), padding rows id
    ``capacity``. :func:`group_sort` seen in row order: one more scatter,
    of unique indices.

    Returns ``(gid [cap] int32, num_groups, perm)``, ``perm`` the
    grouping permutation (valid rows first)."""
    cap = keys[0].shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=keys[0].device)
    gid_sorted, num_groups, (perm,) = group_sort(
        keys, nrows, validities, payloads=[iota], hash_first=hash_first)
    gid = torch.empty_like(gid_sorted).scatter_(0, perm.to(torch.int64),
                                                gid_sorted)
    return gid, num_groups, perm


def _segment_offsets(gid_s: torch.Tensor, out_cap: int) -> torch.Tensor:
    """[out_cap + 1] int64 bounds of the groups of a group-sorted layout:
    group g's rows are ``[off[g], off[g + 1])``, empty for an id that no
    row holds. ``gid_s`` is nondecreasing, with ids >= its length on
    padding rows, which no group takes."""
    cap = gid_s.shape[0]
    q = torch.arange(out_cap + 1, dtype=gid_s.dtype, device=gid_s.device)
    return torch.minimum(torch.searchsorted(gid_s, q),
                         torch.searchsorted(gid_s, cap))


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """A sum's dtype: floats keep theirs (at least float32), unsigned
    integers sum in uint64, other integers and bools in int64."""
    if dt.is_floating_point:
        return dt if dt.itemsize >= 4 else torch.float32
    if dt in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return torch.uint64
    return torch.int64


def _segment_sum(val: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``val`` over the bounds ``off``. Floats take
    ``torch.segment_reduce`` (each segment summed in row order on the
    CPU; on the card one block a segment, in a fixed order: the same
    bits on every call). Integers take a prefix sum differenced at the
    bounds, exact because integer wrap-around is modular: an int32 count
    through :func:`fast_cumsum` (the ``scan32`` kernel on the card),
    wider values through an int64 cumsum (uint64 by its bit pattern)."""
    if val.is_floating_point():
        return torch.segment_reduce(val, "sum", offsets=off, unsafe=True)
    dt = val.dtype
    if dt == torch.int32:
        pre = fast_cumsum(val)
    else:
        v = val.view(torch.int64) if dt == torch.uint64 \
            else val.to(torch.int64)
        pre = torch.cumsum(v, 0)
    pre = torch.cat([torch.zeros(1, dtype=pre.dtype, device=pre.device),
                     pre])
    out = pre[off[1:]] - pre[off[:-1]]
    return out.view(torch.uint64) if dt == torch.uint64 else out


def _scatter_extreme(val: torch.Tensor, slot: torch.Tensor, out_cap: int,
                     kind: str) -> torch.Tensor:
    """Per-group min or max of integer (or bool) values: a
    ``scatter_reduce`` into ``out_cap`` slots plus one that takes the
    rows of no group. Integer atomics give the same result in any
    order."""
    dt = val.dtype
    v = (val.view(torch.int64) ^ _MIN64) if dt == torch.uint64 \
        else val.to(torch.int64)
    fill = _MAX64 if kind == "min" else _MIN64
    buf = torch.full((out_cap + 1,), fill, dtype=torch.int64,
                     device=val.device)
    buf.scatter_reduce_(0, slot, v, "amin" if kind == "min" else "amax")
    buf = buf[:out_cap]
    if dt == torch.uint64:
        return (buf ^ _MIN64).view(torch.uint64)
    return buf.to(dt)


def segmented_totals(gid_s: torch.Tensor, out_cap: int, channels,
                     extras=()):
    """Per-group reductions over a group-sorted layout (port of
    ``cylon_tpu/ops/kernels.py:390``).

    gid_s: [cap] nondecreasing group ids, padding rows ``cap``.
    channels: ``(kind, value)`` pairs, kind ``"sum"``, ``"min"`` or
        ``"max"`` over a [cap] value, or ``"first"`` / ``"last"`` over a
        ``(data, has)`` pair: the first / last row of the group whose
        ``has`` is set.
    extras: [cap] arrays read at each group's first row.

    Returns ``(outputs, extra_outputs)``: per channel a tuple of
    [out_cap] tensors aligned to the group id (``(total,)``, or
    ``(data, found)`` for first / last), and the extras. Slots of no
    group hold unspecified values: mask them with a group-validity test.

    The JAX package fuses every channel into one segmented
    ``lax.associative_scan`` and a compaction sort, because segment ops
    are the TPU's slowest primitive. Here the ids are monotone, so the
    group bounds come from one ``searchsorted`` (:func:`_segment_offsets`)
    and each channel is reduced over them (:func:`_segment_sum`; float
    min / max by ``torch.segment_reduce``, integer ones and first / last
    by an integer ``scatter_reduce``). No float atomic is used: two calls
    give the same bits. Float sums run in row order on the CPU, as the
    JAX package's CPU segment sums do."""
    cap = gid_s.shape[0]
    dev = gid_s.device
    off = _segment_offsets(gid_s, out_cap)
    slot = None
    outputs = []
    for kind, val in channels:
        if kind == "sum":
            outputs.append((_segment_sum(val, off),))
            continue
        if kind in ("min", "max") and val.is_floating_point():
            outputs.append((torch.segment_reduce(val, kind, offsets=off,
                                                 unsafe=True),))
            continue
        if slot is None:
            slot = torch.where(gid_s < out_cap, gid_s,
                               out_cap).to(torch.int64)
        if kind in ("min", "max"):
            outputs.append((_scatter_extreme(val, slot, out_cap, kind),))
        elif kind in ("first", "last"):
            data, has = val
            iota = torch.arange(cap, dtype=torch.int64, device=dev)
            if kind == "first":
                pos = _scatter_extreme(torch.where(has, iota, cap), slot,
                                       out_cap, "min")
            else:
                pos = _scatter_extreme(torch.where(has, iota, -1), slot,
                                       out_cap, "max")
            found = (pos >= 0) & (pos < cap)
            outputs.append((_rows_at(data, pos, out_cap), found))
        else:
            raise ValueError(f"segmented_totals: unknown channel {kind!r}")
    extra = [_rows_at(e, off[:-1], out_cap) for e in extras]
    return outputs, extra


def _rows_at(data: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """``data[pos]`` with ``pos`` clamped into range; zeros from a
    ``data`` of no rows."""
    cap = data.shape[0]
    if cap == 0:
        return torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                           device=data.device)
    return data[torch.clamp(pos, 0, cap - 1)]
