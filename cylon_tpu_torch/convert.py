"""Data carried across from the JAX package: the port's counterpart of
weights.

A ``cylon_tpu.Table`` travels as plain numpy arrays,
``{name: (data, validity or None, logical dtype name)}`` plus ``nrows``,
so the port never imports ``cylon_tpu`` (which imports JAX). The dtype
name is the JAX package's spelling (``repr`` of its ``DType``: ``int64``,
``float64``, ``timestamp[ns]``, ``string[bytes:20]``, ...). A device-bytes
column travels as the JAX package's ``[cap, nwords]`` uint32 words; the
port holds them as int32 bit patterns, taken with ``ndarray.view`` (exact)
and never with a value cast. Tests feed the same inputs to both packages
through this module.
"""

from typing import Mapping

import numpy as np

from cylon_tpu_torch import device as _device
from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column, Dictionary
from cylon_tpu_torch.table import Table


def from_arrays(columns: Mapping[str, tuple], nrows: int, device=None,
                dictionaries: "Mapping[str, object] | None" = None) -> Table:
    """Build a port Table from a JAX table's arrays. ``dictionaries``
    gives the host values of dictionary-coded columns."""
    dev = _device.resolve(device)
    dictionaries = dictionaries or {}
    cols = {}
    for name, (data, validity, dtype_name) in columns.items():
        dt = dtypes.from_name(dtype_name)
        data = np.array(data)
        if dt.is_bytes:
            data = data.astype(np.uint32, copy=False).view(np.int32)
        t = _device.from_host(data, dev, dt.physical)
        v = None if validity is None else _device.from_host(
            np.array(validity, dtype=bool), dev)
        d = Dictionary(dictionaries[name]) if name in dictionaries else None
        cols[name] = Column(t, v, dt, d)
    return Table(cols, int(nrows))


def to_arrays(table: Table) -> "tuple[dict, int]":
    """The inverse: a port Table as ``({name: (data, validity, dtype
    name)}, nrows)`` of host numpy arrays at full capacity (bytes columns
    as uint32 words, as the JAX package holds them)."""
    cols = {}
    for name, c in table.columns.items():
        data = c.data.cpu().numpy()
        cols[name] = (data.view(np.uint32) if c.dtype.is_bytes else data,
                      None if c.validity is None
                      else c.validity.cpu().numpy(), repr(c.dtype))
    return cols, int(table.nrows)
