"""Dictionary (string) column alignment.

Port of ``cylon_tpu/ops/dictenc.py``. Device tables hold int32 codes; the
values live on the host (:class:`cylon_tpu_torch.column.Dictionary`,
sorted, so code order is value order). An operator that compares string
columns across tables (join keys, concat, set ops) first re-encodes them
onto one shared sorted dictionary: a host step on the values whose device
part is one gather, ``new_code = remap[old_code]``.
"""

import numpy as np
import torch

from cylon_tpu_torch.column import Column, Dictionary


def _remap(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """``remap[codes]`` on the codes' device (codes clamped into range);
    the map is a host constant (:func:`~cylon_tpu_torch.plan.staged`)."""
    from cylon_tpu_torch import plan

    table = plan.staged(remap.astype(np.int32), codes.device)
    return table[torch.clamp(codes, 0, len(remap) - 1).to(torch.int64)]


def merge_dictionaries(dicts: list) -> tuple:
    """``(shared, remaps)``: the sorted merge of ``dicts`` (None reads as
    empty) and, for each input, the numpy array that maps its codes onto
    ``shared``. Deterministic in the inputs and their order, so ranks that
    merge the same dictionaries agree on every code."""
    # ONE factorize merges and remaps: uniques come back in pandas'
    # safe-sorted order, the order ingest uses, and mixed-type object
    # values are handled
    import pandas as pd

    vals = [(d.values if d is not None else np.asarray([], object))
            for d in dicts]
    # use_na_sentinel=False: a NaN dictionary VALUE must keep a real code
    flat_codes, merged = pd.factorize(np.concatenate(vals), sort=True,
                                      use_na_sentinel=False)
    merged = np.asarray(merged, dtype=object)
    flat_codes = np.asarray(flat_codes)
    na = np.asarray(pd.isna(merged))
    if na.any():
        # code order == value order, NA last
        order = np.concatenate([np.flatnonzero(~na), np.flatnonzero(na)])
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        merged = merged[order]
        flat_codes = inv[flat_codes]
    offsets = np.cumsum([0] + [len(v) for v in vals])
    return Dictionary(merged), [flat_codes[offsets[i]:offsets[i + 1]]
                                for i in range(len(vals))]


def remap_codes(col: Column, remap: np.ndarray, shared: Dictionary):
    """``col`` re-encoded onto ``shared`` through ``remap``."""
    codes = _remap(col.data, remap) if len(remap) else col.data
    return Column(codes, col.validity, col.dtype, shared)


def unify_dictionaries(cols: list) -> list:
    """Re-encode dictionary columns onto one merged sorted dictionary.
    Other columns pass through unchanged."""
    dict_cols = [c for c in cols if c.dtype.is_dictionary]
    if not dict_cols:
        return cols
    dicts = [c.dictionary for c in dict_cols]
    first = dicts[0]
    # content equality: relations ingested apart over one value set share
    # codes already and need no remap
    if first is not None and all(d == first for d in dicts):
        return cols
    shared, remaps = merge_dictionaries(dicts)
    remaps = iter(remaps)
    return [remap_codes(c, next(remaps), shared) if c.dtype.is_dictionary
            else c for c in cols]


def unify_table_dictionaries(tables: list) -> list:
    """Column-name-wise dictionary unification across tables."""
    from cylon_tpu_torch.table import Table

    if len(tables) < 2:
        return list(tables)
    names = tables[0].column_names
    new_cols = [{} for _ in tables]
    for name in names:
        unified = unify_dictionaries([t.column(name) for t in tables])
        for i, c in enumerate(unified):
            new_cols[i][name] = c
    return [Table(new_cols[i], t.nrows) for i, t in enumerate(tables)]


def reencode_values(col: Column, new_values) -> Column:
    """Replace the dictionary's values with ``new_values`` (one per old
    code, e.g. after an elementwise map), restoring the sorted-unique
    invariant with a device code remap."""
    vals = np.asarray(new_values, dtype=object)
    uniq, inverse = np.unique(vals, return_inverse=True)
    codes = _remap(col.data, inverse) if len(inverse) else col.data
    return Column(codes, col.validity, col.dtype, Dictionary(uniq))


def encode_fill_value(col: Column, value):
    """Resolve ``value`` to a code of ``col``'s dictionary, extending and
    re-sorting the dictionary (with a device code remap) when the value
    is absent. Returns ``(column, code)``; used by fillna."""
    values = col.dictionary.values if col.dictionary is not None \
        else np.array([], dtype=object)
    hit = np.where(values == value)[0]
    if len(hit):
        return col, int(hit[0])
    merged = np.unique(np.concatenate([values, np.array([value], object)]))
    remap = np.searchsorted(merged, values)
    code = int(np.searchsorted(merged, np.array([value], object))[0])
    codes = _remap(col.data, remap) if len(remap) \
        else torch.zeros_like(col.data)
    return Column(codes, col.validity, col.dtype, Dictionary(merged)), code
