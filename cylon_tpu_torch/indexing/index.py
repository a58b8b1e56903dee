"""Index structures: value -> row position on the device.

Port of ``cylon_tpu/indexing/index.py`` (parity: ``indexing/index.hpp``:
``IndexingType`` :36-42, ``BaseArrowIndex`` :108,
``ArrowNumericHashIndex`` / ``ArrowBinaryHashIndex`` :246,
``ArrowRangeIndex`` :393, ``ArrowLinearIndex`` :425, builders :455-521).
"""

import enum

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.errors import InvalidArgument


class IndexingType(enum.Enum):
    """Parity: ``indexing/index.hpp:36-42``. BINARY_TREE and BTREE take
    the sorted (HASH) index: a sorted permutation is the search tree."""

    RANGE = 0
    LINEAR = 1
    HASH = 2
    BINARY_TREE = 3
    BTREE = 4


def _valid_rows(column: Column, nrows) -> torch.Tensor:
    cap = column.capacity
    valid = torch.arange(cap, dtype=torch.int32,
                         device=column.device) < nrows
    if column.validity is not None:
        valid = valid & column.validity
    return valid


class BaseIndex:
    """Parity: ``BaseArrowIndex`` (indexing/index.hpp:108): resolves index
    values to row positions with vectorised device probes."""

    indexing_type: IndexingType
    name: "str | None"

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def locate(self, values) -> tuple:
        """values -> (positions int32, found bool): the first matching
        row a probe (parity: LocationByValue)."""
        raise NotImplementedError

    def mask_range(self, capacity: int, start, stop) -> torch.Tensor:
        """Row mask for index values in [start, stop], closed at both ends
        as pandas ``.loc`` slices are."""
        raise NotImplementedError

    def to_numpy(self) -> np.ndarray:
        raise NotImplementedError

    def values_column(self) -> "Column | None":
        """The backing column (None for a RangeIndex)."""
        return None

    def take(self, idx: torch.Tensor, nrows) -> "BaseIndex":
        """Index entries gathered by row position (keeps the index aligned
        through filters and gathers)."""
        raise NotImplementedError


class RangeIndex(BaseIndex):
    """Positions 0..n-1 (parity: ``ArrowRangeIndex``, index.hpp:393)."""

    indexing_type = IndexingType.RANGE

    def __init__(self, nrows, name: "str | None" = None, device=None):
        self._nrows = int(nrows)
        self.name = name
        self._device = torch.device("cpu") if device is None else device

    def __len__(self):
        return self._nrows

    def locate(self, values):
        vals = from_host(np.atleast_1d(np.asarray(values, np.int32)),
                         self._device)
        return vals, (vals >= 0) & (vals < self._nrows)

    def mask_range(self, capacity: int, start, stop):
        pos = torch.arange(capacity, dtype=torch.int32, device=self._device)
        return (pos >= start) & (pos <= stop) & (pos < self._nrows)

    def to_numpy(self):
        return np.arange(self._nrows)

    def take(self, idx, nrows):
        # a taken range index keeps the old positions as labels (pandas
        # keeps labels), as a linear index over them
        idx = torch.as_tensor(idx)
        col = Column(idx.to(torch.int64), None, dtypes.int64)
        return LinearIndex(col, nrows, self.name)


class LinearIndex(BaseIndex):
    """Full-scan index (parity: ``ArrowLinearIndex``, index.hpp:425)."""

    indexing_type = IndexingType.LINEAR

    def __init__(self, column: Column, nrows, name: "str | None" = None):
        self.column = column
        self._nrows = nrows
        self.name = name

    def __len__(self):
        return int(self._nrows)

    def _encode_probe(self, values) -> torch.Tensor:
        vals = np.atleast_1d(np.asarray(values, dtype=object))
        if self.column.dtype.is_dictionary:
            lut = {v: i for i, v in enumerate(self.column.dictionary.values)}
            codes = np.array([lut.get(v, -1) for v in vals], np.int32)
            return from_host(codes, self.column.device)
        np_dt = self.column.data.cpu()[:0].numpy().dtype
        return from_host(vals.astype(np_dt), self.column.device)

    def locate(self, values):
        probe = self._encode_probe(values)
        valid = _valid_rows(self.column, self._nrows)
        eq = (self.column.data[None, :] == probe[:, None]) & valid[None, :]
        found = eq.any(dim=1)
        pos = torch.argmax(eq.to(torch.int8), dim=1).to(torch.int32)
        return pos, found

    def mask_range(self, capacity: int, start, stop):
        if self.column.dtype.is_dictionary:
            # a bound need not be a value: the sorted dictionary maps it
            # onto the code range
            vals = self.column.dictionary.values
            lo = int(np.searchsorted(vals, start, side="left"))
            hi = int(np.searchsorted(vals, stop, side="right")) - 1
        else:
            lo = self._encode_probe([start])[0]
            hi = self._encode_probe([stop])[0]
        data = self.column.data
        return (data >= lo) & (data <= hi) \
            & _valid_rows(self.column, self._nrows)[:capacity]

    def mask_isin(self, capacity: int, values):
        probe = self._encode_probe(values)
        return (self.column.data[:, None] == probe[None, :]).any(dim=1) \
            & _valid_rows(self.column, self._nrows)

    def to_numpy(self):
        return self.column.to_numpy(int(self._nrows))

    def values_column(self):
        return self.column

    def take(self, idx, nrows):
        c = self.column
        safe = torch.clamp(torch.as_tensor(idx, device=c.device), 0,
                           max(c.capacity - 1, 0)).to(torch.int64)
        col = Column(c.data[safe],
                     None if c.validity is None else c.validity[safe],
                     c.dtype, c.dictionary)
        return type(self)(col, nrows, self.name)


class HashIndex(LinearIndex):
    """Sorted-permutation index probed by ``searchsorted`` (parity:
    ``ArrowNumericHashIndex`` / ``ArrowBinaryHashIndex``, index.hpp:246).
    Padding and nulls take the high sentinel; the invalid flag sorts as
    the second key (valid rows first among equal keys), so that a real
    row holding the sentinel value is still found. ``jax.lax.sort`` over
    (values, invalid, iota) becomes two stable ``torch.sort`` passes
    and a gather."""

    indexing_type = IndexingType.HASH

    def __init__(self, column: Column, nrows, name: "str | None" = None):
        super().__init__(column, nrows, name)
        key = column.data
        valid = _valid_rows(column, nrows)
        sent = torch.tensor(dtypes.sentinel_high(key.dtype), dtype=key.dtype,
                            device=key.device)
        masked = torch.where(valid, key, sent)
        invalid = (~valid).to(torch.uint8)
        by_flag = torch.sort(invalid, stable=True).indices
        by_key = torch.sort(masked[by_flag], stable=True).indices
        self._perm = by_flag[by_key].to(torch.int32)
        self._sorted = masked[self._perm.to(torch.int64)]
        self._sorted_valid = invalid[self._perm.to(torch.int64)] == 0

    def locate(self, values):
        probe = self._encode_probe(values).to(self._sorted.dtype)
        slot = torch.searchsorted(self._sorted, probe)
        slot = torch.clamp(slot, 0, max(self._sorted.shape[0] - 1, 0))
        found = (self._sorted[slot] == probe) & self._sorted_valid[slot]
        return self._perm[slot], found


def build_index(column: Column, nrows,
                indexing_type: IndexingType = IndexingType.HASH,
                name: "str | None" = None) -> BaseIndex:
    """Parity: the builders of ``indexing/index.hpp:455-521``. BINARY_TREE
    and BTREE take the sorted (HASH) index."""
    if indexing_type == IndexingType.RANGE:
        return RangeIndex(int(nrows), name, column.device)
    if indexing_type == IndexingType.LINEAR:
        return LinearIndex(column, nrows, name)
    if indexing_type in (IndexingType.HASH, IndexingType.BINARY_TREE,
                         IndexingType.BTREE):
        return HashIndex(column, nrows, name)
    raise InvalidArgument(f"unknown indexing type {indexing_type}")
