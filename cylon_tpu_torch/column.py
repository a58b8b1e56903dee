"""Device column: one fixed-width tensor + optional validity + host
dictionary.

Port of ``cylon_tpu/column.py`` (parity: ``cpp/src/cylon/column.hpp:31``).
A column is a single contiguous device buffer; nulls are a separate bool
validity tensor (True = non-null). String columns take one of two
storages: int32 codes on the device with their values on the host in a
:class:`Dictionary`, or device bytes (:mod:`cylon_tpu_torch.ops.bytescol`:
each row's UTF-8 bytes as ``[capacity, nwords]`` big-endian u32 words,
held as int32 bit patterns).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.device import from_host
from cylon_tpu_torch.errors import TypeError_


class Dictionary:
    """Host-side values of a STRING/BINARY column, sorted ascending so that
    code order is value order. Hash and equality are by content."""

    __slots__ = ("values", "_key", "_hash", "_vhash")

    def __init__(self, values):
        arr = np.array(values, dtype=object)
        arr.flags.writeable = False
        self.values = arr
        self._key = None
        self._hash = None
        self._vhash = {}

    def value_hashes(self, device) -> torch.Tensor:
        """[len] uint32 tensor on ``device`` of each value's stable hash,
        the crc32 of its string form (port of
        ``cylon_tpu/column.py:53``), computed on the host once and cached
        per device. The generic shuffle maps codes through it, so that
        relations ingested apart send equal strings to the same rank
        whatever their codes."""
        device = torch.device(device)
        if device not in self._vhash:
            import zlib

            hv = np.array([zlib.crc32(str(v).encode())
                           for v in self.values], np.uint32)
            self._vhash[device] = from_host(hv, device)
        return self._vhash[device]

    def _content_key(self) -> tuple:
        if self._key is None:
            self._key = tuple(self.values.tolist())
        return self._key

    def __hash__(self):
        # kept: a compiled query's graph key hashes every dictionary of
        # its inputs at each call
        if self._hash is None:
            self._hash = hash(self._content_key())
        return self._hash

    def __eq__(self, other):
        return self is other or (isinstance(other, Dictionary)
                                 and self._content_key()
                                 == other._content_key())

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        return f"Dictionary(n={len(self.values)})"


@dataclasses.dataclass
class Column:
    """data: [capacity, ...] tensor of ``dtype.physical``; validity:
    [capacity] bool or None (all valid); dtype: logical type; dictionary:
    host values of a dictionary-coded column."""

    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    dtype: dtypes.DType = dtypes.int64
    dictionary: Optional[Dictionary] = None

    @staticmethod
    def from_numpy(arr, capacity: "int | None" = None, *,
                   device: torch.device,
                   string_storage: str = "dict") -> "Column":
        """Host array -> Column on ``device`` (already resolved). Strings
        take the storage ``string_storage`` names: ``"dict"`` (int32
        codes and a host dictionary), ``"bytes"`` (device bytes) or
        ``"auto"`` (:func:`~cylon_tpu_torch.ops.bytescol.choose_storage`
        picks by sampled cardinality). None, NaN, pd.NA and NaT become
        validity, except that float NaN in a float column stays NaN
        (pandas semantics). Pads to ``capacity``."""
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            import pandas as pd

            from cylon_tpu_torch.ops import bytescol

            if string_storage == "auto":
                string_storage = bytescol.choose_storage(arr)
            if string_storage == "bytes":
                return bytescol.from_numpy(arr, capacity, device=device)
            if string_storage != "dict":
                raise TypeError_(f"unknown string_storage "
                                 f"{string_storage!r}")
            isnull = np.asarray(pd.isna(arr))
            if isnull.ndim == 0:
                isnull = np.broadcast_to(isnull, arr.shape).copy()
            filled = np.where(isnull, "", arr.astype(object))
            codes, uniq = pd.factorize(filled, sort=True)
            return Column._pad(codes.astype(np.int32),
                               ~isnull if isnull.any() else None,
                               dtypes.string, Dictionary(uniq), capacity,
                               device)
        if arr.dtype.kind in ("M", "m"):
            isnat = np.isnat(arr)
            data = np.where(isnat, 0, arr.view(np.int64))
            return Column._pad(data, ~isnat if isnat.any() else None,
                               dtypes.from_numpy_dtype(arr.dtype), None,
                               capacity, device)
        return Column._pad(arr, None, dtypes.from_numpy_dtype(arr.dtype),
                           None, capacity, device)

    @staticmethod
    def _pad(data, validity, dtype, dictionary, capacity, device):
        n = len(data)
        cap = n if capacity is None else capacity
        if cap < n:
            raise TypeError_(f"capacity {cap} < data length {n}")
        buf = np.zeros((cap,) + data.shape[1:], dtype=data.dtype)
        buf[:n] = data
        vbuf = None
        if validity is not None:
            vbuf = np.zeros(cap, dtype=bool)
            vbuf[:n] = validity
        t = from_host(buf, device, dtype.physical)
        v = None if vbuf is None else from_host(vbuf, device)
        return Column(t, v, dtype, dictionary)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to_numpy(self, nrows: "int | None" = None) -> np.ndarray:
        """The first ``nrows`` rows (default: all) decoded on the host."""
        n = self.capacity if nrows is None else nrows
        validity = None if self.validity is None \
            else self.validity[:n].cpu().numpy()
        return self.decode_host(self.data[:n].cpu().numpy(), validity)

    def decode_host(self, data: np.ndarray,
                    validity: "np.ndarray | None") -> np.ndarray:
        """Decode fetched host arrays: bytes words to str, dictionary
        lookup, temporal views, null substitution (NaN for floats, NaT
        for temporals, None otherwise)."""
        if self.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            return bytescol.decode_host(data, validity)
        if self.dtype.is_dictionary:
            if self.dictionary is None:
                raise TypeError_("dictionary column without dictionary")
            ncodes = len(self.dictionary)
            out = (self.dictionary.values[np.clip(data, 0, ncodes - 1)]
                   if ncodes else np.full(len(data), None, object))
            out = np.asarray(out, dtype=object)
        elif self.dtype.kind in (dtypes.Kind.TIMESTAMP, dtypes.Kind.DURATION,
                                 dtypes.Kind.DATE64):
            ch = "m" if self.dtype.kind == dtypes.Kind.DURATION else "M"
            out = data.view(f"{ch}8[{self.dtype.unit or 'ns'}]")
        else:
            out = data
        if validity is not None and (~validity).any():
            mask = ~validity
            if out.dtype.kind == "f":
                out = out.copy()
                out[mask] = np.nan
            elif out.dtype.kind in "Mm":
                out = out.copy()
                out[mask] = np.datetime64("NaT") if out.dtype.kind == "M" \
                    else np.timedelta64("NaT")
            else:
                out = out.astype(object)
                out[mask] = None
        return out

    def astype(self, dtype: dtypes.DType) -> "Column":
        """Cast (parity: ``table.pyx:2446`` astype). Between the two
        string storages: dictionary -> bytes is a device gather of the
        host-encoded values; bytes -> dictionary a host round trip; bytes
        -> bytes pads or truncates to the declared width."""
        if self.dtype.is_bytes or dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            if self.dtype.is_dictionary and dtype.is_bytes:
                return bytescol.dict_to_bytes(self, dtype.bytes_width)
            if self.dtype.is_bytes and dtype.is_bytes:
                nw = dtype.bytes_width // bytescol.WORD
                cur = self.data.shape[1]
                if nw == cur:
                    return self
                # narrowing truncates to the declared width
                data = bytescol.pad_words(self.data, nw) if nw > cur \
                    else self.data[:, :nw]
                return Column(data, self.validity, dtypes.string_bytes(
                    nw * bytescol.WORD), None)
            if self.dtype.is_bytes and dtype.is_dictionary:
                return bytescol.bytes_to_dict(self, self.capacity)
            raise TypeError_("cast between string bytes and non-string "
                             "requires host round-trip")
        if self.dtype.is_dictionary != dtype.is_dictionary:
            raise TypeError_(
                "cast between string and non-string requires host round-trip")
        return Column(self.data.to(dtype.physical), self.validity, dtype,
                      self.dictionary if dtype.is_dictionary else None)

    def __repr__(self):
        return (f"Column({self.dtype!r}, cap={self.capacity}"
                f"{', nullable' if self.validity is not None else ''})")
