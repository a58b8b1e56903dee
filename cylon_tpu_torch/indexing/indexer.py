"""loc / iloc indexers over DataFrame.

Port of ``cylon_tpu/indexing/indexer.py`` (parity:
``ArrowLocIndexer`` / ``ArrowILocIndexer``,
``indexing/indexer.hpp:76,123``; the ``PyLocIndexer`` facade,
``python/pycylon/indexing/index.pyx:71-371``). Keys: a scalar value, a
list of values, a closed value range (slice) or a boolean mask, each
with an optional column, list of columns or column slice as the second
element of a tuple. Both indexers work on the local frame: on a
distributed frame they gather it first (a collective every rank calls).
"""

import numpy as np
import torch

from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.errors import IndexError_, KeyError_
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.selection import take_columns


def _split_key(key):
    if isinstance(key, tuple) and len(key) == 2:
        return key[0], key[1]
    return key, None


def _col_subset(df, cols):
    if cols is None:
        return df.columns
    if isinstance(cols, str):
        return [cols]
    if isinstance(cols, slice):
        names = df.columns
        lo = 0 if cols.start is None else names.index(cols.start)
        hi = len(names) - 1 if cols.stop is None else names.index(cols.stop)
        return names[lo:hi + 1]
    return list(cols)


def _take_with_index(df, idx, nrows, cols):
    from cylon_tpu_torch.frame import DataFrame

    t = df.table
    idx = idx if torch.is_tensor(idx) \
        else from_host(np.asarray(idx, np.int32), t.device)
    idx = idx.to(torch.int32)
    out = take_columns(t, idx, nrows, names=cols)
    # labels ride along the gather: an implicit RangeIndex becomes a
    # LinearIndex of the old positions (pandas keeps the labels)
    return DataFrame._wrap(out, index=df.index.take(idx, nrows))


class LocIndexer:
    """Value-based row selection (parity: ``ArrowLocIndexer``,
    indexing/indexer.hpp:76)."""

    def __init__(self, df):
        self._df = df

    def __getitem__(self, key):
        rows, cols = _split_key(key)
        df = self._df._materialized()
        names = _col_subset(df, cols)
        index = df.index
        t = df.table

        if isinstance(rows, slice):
            if rows.step is not None:
                raise IndexError_("loc slices do not support a step")
            if rows.start is None and rows.stop is None:
                mask = t.row_mask()
            else:
                vals = index.to_numpy()
                start, stop = rows.start, rows.stop
                if start is None:
                    start = vals.min() if len(vals) else 0
                if stop is None:
                    stop = vals.max() if len(vals) else 0
                mask = index.mask_range(t.capacity, start, stop)
            perm, count = kernels.compact_mask(mask, t.nrows)
            return _take_with_index(df, perm, count, names)

        single = np.isscalar(rows) or isinstance(rows, (str, bytes))
        probe = [rows] if single else list(rows)
        arr = np.asarray(probe)
        if arr.dtype == bool:   # boolean mask, as pandas takes it
            mask = torch.zeros(t.capacity, dtype=torch.bool,
                               device=t.device)
            mask[:len(arr)] = from_host(arr, t.device)
            perm, count = kernels.compact_mask(mask & t.row_mask(), t.nrows)
            return _take_with_index(df, perm, count, names)

        pos, found = index.locate(probe)
        ok = found.cpu().numpy()
        if not ok.all():
            missing = [p for p, f in zip(probe, ok) if not f]
            raise KeyError_(f"labels not found in index: {missing}")
        return _take_with_index(df, pos, len(probe), names)


class ILocIndexer:
    """Position-based row selection (parity: ``ArrowILocIndexer``,
    indexing/indexer.hpp:123)."""

    def __init__(self, df):
        self._df = df

    def __getitem__(self, key):
        rows, cols = _split_key(key)
        df = self._df._materialized()
        names = _col_subset(df, cols)
        n = df.table.num_rows

        if isinstance(rows, (bool, np.bool_)):
            raise IndexError_("iloc position cannot be a bool")
        if isinstance(rows, slice):
            idx = np.arange(n)[rows]
        elif np.isscalar(rows):
            r = int(rows)
            if r < 0:
                r += n
            if not 0 <= r < n:
                raise IndexError_(f"position {rows} out of range [0, {n})")
            idx = np.array([r])
        else:
            idx = np.asarray(rows)
            if idx.dtype == bool:
                idx = np.nonzero(idx[:n])[0]
            else:
                idx = np.where(idx < 0, idx + n, idx)
                if ((idx < 0) | (idx >= n)).any():
                    raise IndexError_(f"positions out of range [0, {n})")
        return _take_with_index(df, idx, len(idx), names)
