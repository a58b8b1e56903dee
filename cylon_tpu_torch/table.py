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
from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column, Dictionary
from cylon_tpu_torch.errors import InvalidArgument, KeyError_, OutOfCapacity
from cylon_tpu_torch.utils import pow2_bucket
from cylon_tpu_torch.utils.tracing import host_read


def _arrow_dict_column(arr, capacity, device) -> Column:
    """A pyarrow string array as a dictionary column, encoded and sorted
    by pyarrow: the same codes, sorted values and validity as
    ``Column.from_numpy`` of ``arr.to_numpy()`` (a null takes the empty
    string's code there too), without a Python sort of every value."""
    import pyarrow.compute as pc

    valid = None
    if arr.null_count:
        valid = arr.is_valid().to_numpy(zero_copy_only=False)
        arr = pc.fill_null(arr, "")
    enc = arr.dictionary_encode()
    order = pc.sort_indices(enc.dictionary).to_numpy()
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = rank[enc.indices.to_numpy(zero_copy_only=False)]
    values = enc.dictionary.take(order).to_numpy(zero_copy_only=False)
    return Column._pad(codes, valid, dtypes.string, Dictionary(values),
                       capacity, device)


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
        # a table of no columns lies where its count does
        dev = next(iter(devs)) if devs else (
            nrows.device if torch.is_tensor(nrows) else torch.device("cpu"))
        if not torch.is_tensor(nrows):
            # a fill on the device, not a copy from the host: it captures
            nrows = torch.full((), int(nrows), dtype=torch.int32,
                               device=dev)
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

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    @property
    def column_count(self) -> int:
        return self.num_columns

    @property
    def row_count(self) -> int:
        """Alias of :attr:`num_rows` (table.pyx ``row_count``)."""
        return self.num_rows

    @property
    def schema(self) -> dict:
        """name -> logical dtype (parity: table.pyx ``schema``)."""
        return {n: c.dtype for n, c in self._columns.items()}

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.column(key)
        if isinstance(key, (list, tuple)):
            return self.select(key)
        raise KeyError_(f"bad key {key!r}")

    def __contains__(self, name):
        return name in self._columns

    def row_mask(self) -> torch.Tensor:
        """[capacity] bool: True for real rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.nrows

    # -- schema ops (parity: table.pyx project/rename/drop) --------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.column(n) for n in names}, self.nrows)

    def project(self, cols: Sequence) -> "Table":
        """Select columns by index or name (parity: ``Project``)."""
        return self.select([self.column_names[c] if isinstance(c, int)
                            else c for c in cols])

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._columns.items()},
                     self.nrows)

    def drop(self, names: Sequence[str]) -> "Table":
        names = set(names)
        return Table({n: c for n, c in self._columns.items()
                      if n not in names}, self.nrows)

    def add_prefix(self, prefix: str) -> "Table":
        return self.rename({n: prefix + n for n in self.column_names})

    def add_suffix(self, suffix: str) -> "Table":
        return self.rename({n: n + suffix for n in self.column_names})

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

    def shrink_to_fit(self, min_capacity: int = 1024,
                      only_above: int = 1 << 16) -> "Table":
        """Trim the capacity to the power-of-two bucket of the row count
        (``cylon_tpu/table.py:141``): a selective filter or join leaves
        the buffer mostly padding, and the sorts downstream cost
        O(capacity log capacity) whatever the real rows. One host sync
        and a copy of the kept prefix; tables of capacity at most
        ``only_above`` are left alone, and so is an overflowed table
        (its mark must reach the host check that reports it)."""
        if self.capacity <= only_above:
            return self
        try:
            n = host_read("shrink", lambda: self.num_rows)
        except OutOfCapacity:
            return self
        bucket = pow2_bucket(n, min_capacity)
        if bucket < self.capacity:
            return self.with_capacity(bucket)
        return self

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

    @staticmethod
    def from_arrow(atable, capacity: "int | None" = None, device=None,
                   string_storage="dict") -> "Table":
        """pyarrow Table -> Table (``cylon_tpu/table.py:217``; parity
        ``table.pyx`` from_arrow). Nullable integer and bool columns keep
        their type and carry Arrow's null mask as validity."""
        import pyarrow as pa
        import pyarrow.compute as pc

        dev = _device.resolve(device)
        cols = {}
        for name in atable.column_names:
            arr = atable.column(name).combine_chunks()
            if pa.types.is_string(arr.type) \
                    or pa.types.is_large_string(arr.type):
                storage = Table._storage_of(string_storage, str(name))
                cols[str(name)] = _arrow_dict_column(arr, capacity, dev) \
                    if storage == "dict" else Column.from_numpy(
                        arr.to_numpy(zero_copy_only=False), capacity,
                        device=dev, string_storage=storage)
                continue
            if arr.null_count and (pa.types.is_integer(arr.type)
                                   or pa.types.is_boolean(arr.type)):
                isnull = arr.is_null().to_numpy(zero_copy_only=False)
                fill = False if pa.types.is_boolean(arr.type) else 0
                col = Column.from_numpy(
                    pc.fill_null(arr, fill).to_numpy(zero_copy_only=False),
                    capacity, device=dev)
                v = np.zeros(col.capacity, dtype=bool)
                v[:len(isnull)] = ~isnull
                col = Column(col.data, _device.from_host(v, dev), col.dtype,
                             col.dictionary)
            else:
                col = Column.from_numpy(arr.to_numpy(zero_copy_only=False),
                                        capacity, device=dev)
            cols[str(name)] = col
        return Table(cols, torch.tensor(atable.num_rows, dtype=torch.int32,
                                        device=dev))

    @staticmethod
    def from_list(col_names: Sequence[str], cols: Sequence,
                  device=None) -> "Table":
        """Build from a column-major list of lists (parity: table.pyx
        ``from_list``)."""
        return Table.from_numpy(col_names, cols, device=device)

    # -- thin op surface (parity: table.pyx methods) ---------------------
    def filter(self, mask) -> "Table":
        """Keep rows where ``mask`` holds (compacted)."""
        from cylon_tpu_torch.ops.selection import filter_table

        return filter_table(self, mask)

    def sort(self, by, ascending=True) -> "Table":
        from cylon_tpu_torch.ops.selection import sort_table

        by = [by] if isinstance(by, str) else list(by)
        return sort_table(self, by, ascending=ascending)

    def join(self, right: "Table", **kw) -> "Table":
        from cylon_tpu_torch.ops.join import join

        return join(self, right, **kw)

    def union(self, other: "Table", out_capacity=None) -> "Table":
        from cylon_tpu_torch.ops import setops

        if out_capacity is None:
            out_capacity = self.capacity + other.capacity
        return setops.union(self, other, out_capacity)

    def intersect(self, other: "Table", out_capacity=None) -> "Table":
        from cylon_tpu_torch.ops import setops

        return setops.intersect(self, other, out_capacity or self.capacity)

    def subtract(self, other: "Table", out_capacity=None) -> "Table":
        from cylon_tpu_torch.ops import setops

        return setops.subtract(self, other, out_capacity or self.capacity)

    def unique(self, cols=None, keep: str = "first") -> "Table":
        from cylon_tpu_torch.ops import setops

        return setops.unique(self, cols, keep=keep)

    def show(self, n: int = 10) -> None:
        """Print the first ``n`` rows (parity: table.pyx ``show``)."""
        print(self.to_string(n))

    def to_string(self, n: "int | None" = None) -> str:
        from cylon_tpu_torch.ops.selection import head

        t = self if n is None else head(self, n)
        return t.to_pandas().to_string()

    def to_csv(self, path, **kw) -> None:
        from cylon_tpu_torch.io import write_csv

        write_csv(self, path, **kw)

    def iterrows(self):
        """Host Rows, one fetch of every column first."""
        from cylon_tpu_torch.row import Row

        names = list(self._columns)
        mats = list(self._host_columns().values())
        for i in range(len(mats[0]) if mats else 0):
            yield Row(names, [m[i].item() if hasattr(m[i], "item")
                              else m[i] for m in mats])

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

    def to_pydict(self) -> dict:
        return {name: a.tolist() for name, a in self._host_columns().items()}

    def to_arrow(self):
        import pyarrow as pa

        return pa.table(dict(self._host_columns()))

    def to_numpy(self) -> np.ndarray:
        """[nrows, ncols] host matrix (parity: table.pyx to_numpy)."""
        return np.stack(list(self._host_columns().values()), axis=1)

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
