"""Device-resident columnar Table.

Port of ``cylon_tpu/table.py`` (parity: ``cpp/src/cylon/table.hpp:46-200``),
with its contract (``table.py:8-19``): a Table carries

- ``capacity``: the static padded row count (the tensors' leading dim), and
- ``nrows``: a 0-d int32 device tensor -- how many leading rows are real.

Rows in ``[nrows, capacity)`` are padding that every operator masks with
order-inert sentinels. ``nrows == capacity + 1`` marks a result that
overflowed its bound; :attr:`Table.num_rows` raises on it.

Tables are built on CUDA by default (``device=None``); tests pass
``device="cpu"``.
"""

import collections
from typing import Mapping, Sequence

import numpy as np
import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, KeyError_, OutOfCapacity


class Table:
    """Named device columns + a device valid-row count."""

    def __init__(self, columns: Mapping[str, Column], nrows):
        self._columns = collections.OrderedDict(columns)
        caps = {c.capacity for c in self._columns.values()}
        if len(caps) > 1:
            raise InvalidArgument(f"column capacities differ: {caps}")
        devs = {c.data.device for c in self._columns.values()}
        if len(devs) > 1:
            raise InvalidArgument(f"columns lie on several devices: {devs}")
        dev = next(iter(devs)) if devs else torch.device("cpu")
        if not torch.is_tensor(nrows):
            nrows = torch.tensor(int(nrows), dtype=torch.int32, device=dev)
        self.nrows = nrows.to(device=dev, dtype=torch.int32).reshape(())

    # -- shape / schema --------------------------------------------------
    @property
    def capacity(self) -> int:
        if not self._columns:
            return 0
        return next(iter(self._columns.values())).capacity

    @property
    def device(self) -> torch.device:
        return self.nrows.device

    def _check_overflow(self, n: int) -> int:
        if n > self.capacity:
            raise OutOfCapacity(
                f"result has {n} rows but static capacity is "
                f"{self.capacity}; re-run with a larger out_capacity")
        return n

    @property
    def num_rows(self) -> int:
        """Concrete row count (one device -> host sync). Raises
        OutOfCapacity if an operator overflowed its static bound."""
        return self._check_overflow(int(self.nrows))

    @property
    def column_names(self) -> list:
        return list(self._columns)

    @property
    def columns(self) -> "collections.OrderedDict[str, Column]":
        return self._columns

    def column(self, name: str) -> Column:
        if name not in self._columns:
            raise KeyError_(f"no column {name!r}; have {self.column_names}")
        return self._columns[name]

    # -- schema ops ------------------------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.column(n) for n in names}, self.nrows)

    def add_column(self, name: str, col: Column) -> "Table":
        out = collections.OrderedDict(self._columns)
        out[name] = col
        return Table(out, self.nrows)

    def with_nrows(self, nrows) -> "Table":
        return Table(self._columns, nrows)

    def with_capacity(self, capacity: int) -> "Table":
        """Pad (zeros, validity False) or trim the static capacity."""
        cur = self.capacity
        if capacity == cur:
            return self
        cols = {}
        for n, c in self._columns.items():
            if capacity > cur:
                data = torch.zeros((capacity,) + tuple(c.data.shape[1:]),
                                   dtype=c.data.dtype, device=c.data.device)
                data[:cur] = c.data
                validity = None
                if c.validity is not None:
                    validity = torch.zeros(capacity, dtype=torch.bool,
                                           device=c.data.device)
                    validity[:cur] = c.validity
            else:
                data = c.data[:capacity]
                validity = None if c.validity is None \
                    else c.validity[:capacity]
            cols[n] = Column(data, validity, c.dtype, c.dictionary)
        return Table(cols, torch.clamp(self.nrows, max=capacity))

    # -- host bridges ----------------------------------------------------
    @staticmethod
    def _storage_of(string_storage, name: str) -> str:
        """A plain string applies to every string column; a mapping
        names a column's storage, ``"dict"`` by default."""
        if isinstance(string_storage, Mapping):
            return string_storage.get(name, "dict")
        return string_storage

    @staticmethod
    def from_pydict(data: Mapping[str, object],
                    capacity: "int | None" = None, device=None,
                    string_storage="dict") -> "Table":
        """Host arrays -> Table on ``device`` (``None``: CUDA).
        ``string_storage``: ``"dict"``, ``"bytes"``, ``"auto"`` or a
        mapping of column name to one of them (see
        :meth:`Column.from_numpy`)."""
        dev = _device.resolve(device)
        arrays = {n: np.asarray(v) for n, v in data.items()}
        n = len(next(iter(arrays.values()))) if arrays else 0
        for name, a in arrays.items():
            if len(a) != n:
                raise InvalidArgument(f"column {name} length {len(a)} != {n}")
        cols = {name: Column.from_numpy(
            a, capacity, device=dev,
            string_storage=Table._storage_of(string_storage, name))
            for name, a in arrays.items()}
        return Table(cols, torch.tensor(n, dtype=torch.int32, device=dev))

    @staticmethod
    def from_numpy(names: Sequence[str], arrays: Sequence[np.ndarray],
                   capacity: "int | None" = None, device=None,
                   string_storage="dict") -> "Table":
        return Table.from_pydict(dict(zip(names, arrays)), capacity, device,
                                 string_storage)

    @staticmethod
    def from_pandas(df, capacity: "int | None" = None, device=None,
                    string_storage="dict") -> "Table":
        """pandas DataFrame -> Table; nullable extension columns (Int64,
        Float64, boolean, ...) keep their type and carry their mask as
        validity. String columns (object or pandas' ``str`` dtype, whose
        missing values read back as NaN) take ``string_storage`` as in
        :meth:`from_pydict`, with None, NaN and pd.NA as nulls."""
        dev = _device.resolve(device)
        cols = {}
        for name in df.columns:
            s = df[name]
            if str(s.dtype).startswith(("Int", "UInt", "Float", "boolean")):
                mask = s.isna().to_numpy()
                fill = False if str(s.dtype) == "boolean" else 0
                col = Column.from_numpy(s.fillna(fill).to_numpy(), capacity,
                                        device=dev)
                if mask.any():
                    v = np.zeros(col.capacity, dtype=bool)
                    v[:len(mask)] = ~mask
                    col = Column(col.data, torch.from_numpy(v).to(dev),
                                 col.dtype, col.dictionary)
                cols[str(name)] = col
                continue
            cols[str(name)] = Column.from_numpy(
                s.to_numpy(), capacity, device=dev,
                string_storage=Table._storage_of(string_storage, str(name)))
        return Table(cols, torch.tensor(len(df), dtype=torch.int32,
                                        device=dev))

    def _host_columns(self) -> "collections.OrderedDict[str, np.ndarray]":
        """Every column's valid prefix decoded on the host. Raises
        OutOfCapacity like :attr:`num_rows`."""
        n = self.num_rows
        out = collections.OrderedDict()
        for name, c in self._columns.items():
            data = c.data[:n].cpu().numpy()
            validity = None if c.validity is None \
                else c.validity[:n].cpu().numpy()
            out[name] = c.decode_host(data, validity)
        return out

    def to_pandas(self):
        """Valid rows as a DataFrame: string columns of both storages as
        object columns of str with None for null."""
        import pandas as pd

        return pd.DataFrame(self._host_columns())

    def row(self, i: int):
        """Typed host view of row ``i`` (parity: ``cylon::Row``,
        ``row.hpp:23``): one-element slices of every column, decoded on
        the host."""
        from cylon_tpu_torch.row import Row

        n = self.num_rows
        if not -n <= i < n:
            raise IndexError(f"row {i} out of range [0, {n})")
        i %= n
        values = []
        for c in self._columns.values():
            validity = None if c.validity is None \
                else c.validity[i:i + 1].cpu().numpy()
            v = c.decode_host(c.data[i:i + 1].cpu().numpy(), validity)[0]
            values.append(v.item() if hasattr(v, "item") else v)
        return Row(list(self._columns), values)

    def __repr__(self):
        try:
            n = str(self.num_rows)
        except OutOfCapacity:
            n = f"OVERFLOW({int(self.nrows)})"
        schema = ", ".join(f"{name}: {c.dtype!r}"
                           for name, c in self._columns.items())
        return f"Table[{n}/{self.capacity} rows]({schema})"
