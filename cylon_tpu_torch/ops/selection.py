"""Row selection and movement: take, filter, sort, concat, head,
sample, and the missing-value flags the reductions skip
(``_null_flags``).

Port of ``cylon_tpu/ops/selection.py``. Every fixed-width column (and
validity flag) is bit-packed into ONE [cap, words] u32 matrix (int32 bit
patterns) and row-gathered in a single pass, so one wide gather replaces
ncols narrow ones (the reference's ``build_final_table``,
``join/join_utils.hpp:34``).

Every reordering is a sorted permutation and then that one gather
(:func:`permute_by_sort`), at any width. The JAX package carries narrow
tables through ``lax.sort`` as payload and switches to the gather past a
crossover it measured on a TPU (``PAYLOAD_SORT_MAX_WORDS``,
``PAYLOAD_GATHER_MIN_ROWS``); ``torch.sort`` returns its indices and
carries no payload, so the port has no crossover to copy.
"""

import math
from typing import Sequence

import torch

from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.kernels import gather_rows
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.utils.tracing import (count_on_device, device_counting,
                                           traced)


def _packable(data: torch.Tensor) -> bool:
    """1-D fixed-width columns ride the packed gather, and so does a
    device-bytes column, whose [cap, nwords] int32 words already are
    words. Unlike the JAX package, float64 rides too: it stays out there
    only because the TPU's x64 emulation cannot bitcast doubles, and a
    GPU can."""
    return data.dim() == 1 or (data.dim() == 2 and data.dtype == torch.int32)


def _to_words(data: torch.Tensor) -> torch.Tensor:
    """[cap] column -> [cap, w] int32 words (bit-preserving; 8- and
    16-bit values zero-extend); a bytes column is its words."""
    if data.dim() == 2:
        return data
    size = data.element_size()
    if data.dtype == torch.bool:
        return data.to(torch.int32)[:, None]
    if size == 8:
        return data.contiguous().view(torch.int32).view(-1, 2)
    if size == 4:
        return data.contiguous().view(torch.int32)[:, None]
    if size == 2:
        return (data.contiguous().view(torch.int16).to(torch.int32)
                & 0xFFFF)[:, None]
    return data.contiguous().view(torch.uint8).to(torch.int32)[:, None]


def _dense(words: torch.Tensor) -> torch.Tensor:
    """``words`` [rows, 2] with row stride 2 at an even offset, as a view
    to 8-byte values needs. ``.contiguous()`` keeps a one-row slice of a
    wider matrix as it is (its row stride does not matter to it), so
    such a slice is copied."""
    w = words.contiguous()
    if w.stride(0) != 2 or w.storage_offset() % 2:
        w = w.clone(memory_format=torch.contiguous_format)
    return w


def _from_words(words: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_to_words` for a [rows, w] int32 word slice."""
    if dt == torch.bool:
        return words[:, 0] != 0
    size = dt.itemsize
    if size == 8:
        return _dense(words).view(dt).view(-1)
    if size == 4:
        return words[:, 0].contiguous().view(dt)
    if size == 2:
        return words[:, 0].to(torch.int16).view(dt)   # truncates to 16 bits
    return words[:, 0].to(torch.uint8).view(dt)


@traced("gather", device=True)
def take_columns(table, idx: torch.Tensor, nrows_out,
                 null_mask: "torch.Tensor | None" = None,
                 names: "Sequence[str] | None" = None):
    """Gather rows by index into a new table of capacity ``len(idx)``.

    ``null_mask`` marks output slots whose row is all-null (the unmatched
    side of an outer join; its payload is zeroed). Runs under the
    device-timed span ``gather``; while that records, ``gather.bytes``
    counts the least bytes of the call: per row of the result its 8-byte
    index, one source row read and one output row written."""
    from cylon_tpu_torch.table import Table

    if table.capacity == 0:
        # no row to read: every slot reads one zero row of padding
        table = table.with_capacity(1)
    use = list(names if names is not None else table.column_names)

    layout = []   # (name, column, word slice | None, validity word | None)
    word_arrays = []
    w = 0
    for name in use:
        c = table.column(name)
        sl = None
        if _packable(c.data):
            cw = _to_words(c.data)
            word_arrays.append(cw)
            sl = slice(w, w + cw.shape[1])
            w += cw.shape[1]
        vslot = None
        if c.validity is not None:
            word_arrays.append(c.validity.to(torch.int32)[:, None])
            vslot = w
            w += 1
        layout.append((name, c, sl, vslot))

    out_words = None
    row_bytes = 4 * w
    if word_arrays:
        packed = torch.cat(word_arrays, dim=1)
        out_words = gather_rows(packed, idx)

    cols = {}
    for name, c, sl, vslot in layout:
        if sl is None:   # a 2-D column of other than int32 words
            safe = torch.clamp(idx, 0, table.capacity - 1).to(torch.int64)
            data = c.data.index_select(0, safe)
            row_bytes += math.prod(c.data.shape[1:]) * c.data.element_size()
        elif c.data.dim() == 2:   # bytes: the words are the data
            data = out_words[:, sl]
        else:
            data = _from_words(out_words[:, sl], c.data.dtype)
        validity = None if vslot is None else out_words[:, vslot] != 0
        if null_mask is not None:
            base = torch.ones_like(null_mask) if validity is None \
                else validity
            validity = base & ~null_mask
            nm = null_mask.reshape(null_mask.shape + (1,) * (data.dim() - 1))
            data = torch.where(nm, torch.zeros((), dtype=data.dtype,
                                               device=data.device), data)
        cols[name] = Column(data, validity, c.dtype, c.dictionary)
    out = Table(cols, nrows_out)
    if device_counting():
        count_on_device("gather.bytes", out.nrows, idx.shape[0],
                        8 + 2 * row_bytes)
    return out


def _null_flags(c: Column) -> "torch.Tensor | None":
    """[capacity] uint8, 1 where the row's value is missing: a null by
    validity, or a float NaN (pandas' skipna). None when no row can be
    missing. A device-bytes column is missing only by validity."""
    flags = None
    if c.validity is not None:
        flags = (~c.validity).to(torch.uint8)
    if c.data.is_floating_point() and c.data.dim() == 1:
        nan = torch.isnan(c.data).to(torch.uint8)
        flags = nan if flags is None else flags | nan
    return flags


def permute_by_sort(table, operands, nrows_out):
    """Reorder a table by a stable sort on ``operands`` (order keys, most
    significant first; port of ``cylon_tpu/ops/selection.py:227``): one
    sorted permutation (:func:`kernels.lexsort_perm`), then one packed
    row gather (:func:`take_columns`)."""
    ops = [kernels.sortable(k) for k in kernels.pack_order_keys(operands)]
    return take_columns(table, kernels.lexsort_perm(ops), nrows_out)


@traced("filter")
def filter_table(table, mask: torch.Tensor):
    """Keep the valid rows where ``mask`` holds, in their order (port of
    ``cylon_tpu/ops/selection.py:249``; parity: the filter path of
    ``python/pycylon/data/compute.pyx:212``): a stable compaction, then
    one gather."""
    perm, count = kernels.compact_mask(mask.to(torch.bool), table.nrows)
    return kernels.carry_overflow(take_columns(table, perm, count), table)


@traced("sort")
def sort_table(table, by: Sequence[str], ascending=True,
               na_position: str = "last"):
    """Lexicographic multi-column sort (port of
    ``cylon_tpu/ops/selection.py:262``; parity: ``Table::Sort``; pandas
    ``sort_values(kind="stable")`` semantics: NaN and null keys go last
    whatever the direction, or first with ``na_position="first"``)."""
    by = [by] if isinstance(by, str) else list(by)
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    if na_position not in ("first", "last"):
        raise InvalidArgument(f"na_position={na_position!r}")
    return _sort_compiled(table, by=tuple(by), ascending=tuple(ascending),
                          na_position=na_position)


def sort_key_operands(c: Column, asc: bool,
                      na_position: str = "last") -> list:
    """The order keys that sort one column with pandas semantics (port of
    ``cylon_tpu/ops/selection.py:273``): a missing-value flag word
    (nulls and NaNs last, or first, whatever the direction), then the
    column's order key, zeroed under the flag (a null slot's bytes are
    arbitrary, and pandas keeps null rows in their order). A
    device-bytes column's key is its words, unsigned (2-D; the packing
    splits it). Shared by the local sort and ``dist_sort``'s splitter
    tuples: the partition order must be the local sort order."""
    okeys = []
    nulls = _null_flags(c)
    key = kernels.order_key(c.data, asc)
    if nulls is not None:
        flag = nulls if na_position == "last" else 1 - nulls
        okeys.append(kernels.OrderKey(flag.to(torch.int64), 8))
        nz = nulls == 0
        if key.value.dim() == 2:
            nz = nz[:, None]
        key = kernels.OrderKey(torch.where(nz, key.value, 0), key.bits)
    okeys.append(key)
    return okeys


def _sort_compiled(table, *, by, ascending, na_position):
    """The sort at static arguments (port of
    ``cylon_tpu/ops/selection.py:300``; eager, the name kept). The
    padding rows trail, so they take no key of their own
    (:func:`kernels.sort_perm`)."""
    okeys = []
    for name, asc in zip(by, ascending):
        okeys.extend(sort_key_operands(table.column(name), asc,
                                       na_position))
    if not okeys:
        return table
    perm = kernels.sort_perm(okeys, table.nrows)
    return take_columns(table, perm, table.nrows)


def concat_tables(tables: Sequence, capacity: "int | None" = None):
    """Row-wise concatenation (port of
    ``cylon_tpu/ops/selection.py:325``; parity: ``Table::Merge`` /
    pycylon ``concat``, ``table.pyx:2368``). Schemas must match by name
    and dtype; dictionary columns take one merged dictionary and string
    columns of mixed storage one storage first. Each input's valid rows
    land at its offset, the counts read on the host (an overflowed input
    raises here, as the JAX package's eager call does); rows past
    ``capacity`` are dropped and the count keeps them, so that
    ``num_rows`` raises."""
    from cylon_tpu_torch.ops.bytescol import align_table_strings
    from cylon_tpu_torch.ops.dictenc import unify_table_dictionaries
    from cylon_tpu_torch.table import Table

    if not tables:
        raise InvalidArgument("concat of no tables")
    counts = [t.num_rows for t in tables]
    names = tables[0].column_names
    for t in tables[1:]:
        if t.column_names != names:
            raise InvalidArgument(
                f"schema mismatch: {t.column_names} vs {names}")
    tables = align_table_strings(unify_table_dictionaries(list(tables)))
    cap_out = capacity if capacity is not None \
        else sum(t.capacity for t in tables)
    dev = tables[0].device
    cols = {}
    for name in names:
        c0 = tables[0].column(name)
        for t in tables[1:]:
            if t.column(name).data.dtype != c0.data.dtype:
                raise InvalidArgument(
                    f"dtype mismatch in column {name}: "
                    f"{t.column(name).data.dtype} vs {c0.data.dtype}")
        any_validity = any(t.column(name).validity is not None
                           for t in tables)
        data = torch.zeros((cap_out,) + tuple(c0.data.shape[1:]),
                           dtype=c0.data.dtype, device=dev)
        validity = torch.zeros(cap_out, dtype=torch.bool, device=dev) \
            if any_validity else None
        off = 0
        for t, n in zip(tables, counts):
            k = max(min(n, cap_out - off), 0)
            c = t.column(name)
            data[off:off + k] = c.data[:k]
            if validity is not None:
                validity[off:off + k] = True if c.validity is None \
                    else c.validity[:k]
            off += n
        cols[name] = Column(data, validity, c0.dtype, c0.dictionary)
    return Table(cols, sum(counts))


def head(table, n: int):
    """The first ``n`` valid rows (port of
    ``cylon_tpu/ops/selection.py:381``): valid rows lead, so only the
    count changes. Below the capacity the first ``n`` slots are copied
    into a table of capacity ``n``, so that a small head (a query's
    ``LIMIT``) does not keep its source's storage alive while it is
    kept."""
    from cylon_tpu_torch.table import Table

    if not 0 <= n < table.capacity:
        return table.with_nrows(torch.clamp(table.nrows, max=n))
    cut = table.with_capacity(n)
    cols = {}
    for name in cut.column_names:
        c = cut.column(name)
        cols[name] = Column(c.data.clone(), None if c.validity is None
                            else c.validity.clone(), c.dtype, c.dictionary)
    return Table(cols, cut.nrows)


def sample(table, n: int):
    """Deterministic systematic sample of up to ``n`` rows (port of
    ``cylon_tpu/ops/selection.py:386``; parity ``util::SampleArray``):
    row ``floor(i * nrows / min(nrows, n))`` for i < n, computed in
    float32 as the JAX package does, so that both take the same rows."""
    nr = table.nrows
    take_n = torch.clamp(nr, max=n)
    f = torch.float32
    pos = torch.arange(n, dtype=f, device=table.device)
    idx = torch.where(take_n > 0, pos * nr.to(f)
                      / torch.clamp(take_n, min=1).to(f), 0.0)
    idx = torch.minimum(idx.to(torch.int32).clamp(min=0),
                        torch.clamp(nr - 1, min=0))
    return take_columns(table, idx, take_n)


def take(table, idx: torch.Tensor):
    """Public gather by indices (port of
    ``cylon_tpu/ops/selection.py:403``; parity: arrow Take)."""
    return take_columns(table, idx, idx.shape[0])
