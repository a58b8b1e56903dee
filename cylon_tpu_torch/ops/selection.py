"""Row gathers: ``take_columns`` with its u32 word packing, and the
missing-value flags the reductions skip (``_null_flags``).

Port of ``cylon_tpu/ops/selection.py:23-123, 311-322``. Every
fixed-width column (and validity flag) is bit-packed into ONE [cap,
words] u32 matrix (int32 bit patterns) and row-gathered in a single
pass, so one wide gather replaces ncols narrow ones (the reference's
``build_final_table``, ``join/join_utils.hpp:34``).
"""

from typing import Sequence

import torch

from cylon_tpu_torch.column import Column


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


def _from_words(words: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_to_words` for a [rows, w] int32 word slice."""
    if dt == torch.bool:
        return words[:, 0] != 0
    size = dt.itemsize
    if size == 8:
        return words.contiguous().view(dt).view(-1)
    if size == 4:
        return words[:, 0].contiguous().view(dt)
    if size == 2:
        return words[:, 0].to(torch.int16).view(dt)   # truncates to 16 bits
    return words[:, 0].to(torch.uint8).view(dt)


def take_columns(table, idx: torch.Tensor, nrows_out,
                 null_mask: "torch.Tensor | None" = None,
                 names: "Sequence[str] | None" = None):
    """Gather rows by index into a new table of capacity ``len(idx)``.

    ``null_mask`` marks output slots whose row is all-null (the unmatched
    side of an outer join; its payload is zeroed)."""
    from cylon_tpu_torch.table import Table

    if table.capacity == 0:
        # no row to read: every slot reads one zero row of padding
        table = table.with_capacity(1)
    safe = torch.clamp(idx, 0, table.capacity - 1).to(torch.int64)
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
    if word_arrays:
        packed = torch.cat(word_arrays, dim=1)
        out_words = packed.index_select(0, safe)

    cols = {}
    for name, c, sl, vslot in layout:
        if sl is None:
            data = c.data.index_select(0, safe)
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
    return Table(cols, nrows_out)


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
