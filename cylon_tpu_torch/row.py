"""Row view: typed access to one table row.

A copy of ``cylon_tpu/row.py`` (backend-neutral; the port never imports
the JAX package). Parity: ``cpp/src/cylon/row.{hpp,cpp}``: ``Row`` with
per-type getters (``row.hpp:23``: GetInt8..GetInt64, GetFloat/GetDouble,
GetBool, GetString) addressed by column index or name. Rows are host
views that :meth:`cylon_tpu_torch.table.Table.row` fetches; columnar
access stays the fast path.
"""

from typing import Any, Iterator

import numpy as np


class Row:
    """One row of a :class:`cylon_tpu_torch.table.Table` (host view)."""

    __slots__ = ("_names", "_values")

    def __init__(self, names, values):
        self._names = names
        self._values = values

    # -- generic access --------------------------------------------------
    def __getitem__(self, key) -> Any:
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._names.index(key)]

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def keys(self):
        return list(self._names)

    def to_dict(self) -> dict:
        return dict(zip(self._names, self._values))

    def __repr__(self):
        inner = ", ".join(f"{n}={v!r}"
                          for n, v in zip(self._names, self._values))
        return f"Row({inner})"

    def __eq__(self, other):
        if isinstance(other, Row):
            return (self._names == other._names
                    and self._values == other._values)
        return NotImplemented

    def __hash__(self):
        # value-based, like __eq__ (hash(1) == hash(1.0) in Python, so
        # the hash/eq contract holds across int/float typed columns)
        return hash((tuple(self._names), tuple(self._values)))

    # -- typed getters (row.hpp:23 surface) ------------------------------
    def _typed(self, i: int, kinds, exclude=()) -> Any:
        v = self._values[i if isinstance(i, int) else self._names.index(i)]
        bad = not isinstance(v, kinds) or isinstance(v, exclude)
        if bad and v is not None:
            raise TypeError(f"column {i}: {type(v).__name__} is not "
                            f"{'/'.join(k.__name__ for k in kinds)}")
        return v

    def get_int64(self, i) -> int | None:
        # bool is an int subclass in Python; the typed surface keeps
        # them distinct like the reference's per-type getters
        return self._typed(i, (int, np.integer), exclude=(bool, np.bool_))

    get_int8 = get_int16 = get_int32 = get_int64
    get_uint8 = get_uint16 = get_uint32 = get_uint64 = get_int64

    def get_double(self, i) -> float | None:
        return self._typed(i, (float, np.floating))

    get_float = get_half_float = get_double

    def get_bool(self, i) -> bool | None:
        return self._typed(i, (bool, np.bool_))

    def get_string(self, i) -> str | None:
        return self._typed(i, (str,))
