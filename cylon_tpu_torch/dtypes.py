"""Logical type system mapped onto torch dtypes.

Port of ``cylon_tpu/dtypes.py`` (parity: ``cpp/src/cylon/data_types.hpp``).
Every device column is one fixed-width tensor. STRING/BINARY columns are
dictionary codes (int32 on the device, values on the host) or device
bytes (``[cap, nwords]`` big-endian u32 words held as int32 bit patterns,
:mod:`cylon_tpu_torch.ops.bytescol`). Temporal types are int64 on the
device with their unit here.
"""

import dataclasses
import enum

import numpy as np
import torch


class Kind(enum.IntEnum):
    """Parity: ``data_types.hpp:25-90`` ``Type::type``."""

    BOOL = 0
    UINT8 = 1
    INT8 = 2
    UINT16 = 3
    INT16 = 4
    UINT32 = 5
    INT32 = 6
    UINT64 = 7
    INT64 = 8
    HALF_FLOAT = 9
    FLOAT = 10
    DOUBLE = 11
    STRING = 12
    BINARY = 13
    FIXED_SIZE_BINARY = 14
    DATE32 = 15
    DATE64 = 16
    TIMESTAMP = 17
    TIME32 = 18
    TIME64 = 19
    DURATION = 21


class Layout(enum.IntEnum):
    FIXED_WIDTH = 1
    VARIABLE_WIDTH = 2


_PHYSICAL = {
    Kind.BOOL: torch.bool,
    Kind.UINT8: torch.uint8,
    Kind.INT8: torch.int8,
    Kind.UINT16: torch.uint16,
    Kind.INT16: torch.int16,
    Kind.UINT32: torch.uint32,
    Kind.INT32: torch.int32,
    Kind.UINT64: torch.uint64,
    Kind.INT64: torch.int64,
    Kind.HALF_FLOAT: torch.float16,
    Kind.FLOAT: torch.float32,
    Kind.DOUBLE: torch.float64,
    Kind.STRING: torch.int32,   # dictionary codes
    Kind.BINARY: torch.int32,   # dictionary codes
    Kind.FIXED_SIZE_BINARY: torch.int32,
    Kind.DATE32: torch.int32,
    Kind.DATE64: torch.int64,
    Kind.TIMESTAMP: torch.int64,
    Kind.TIME32: torch.int32,
    Kind.TIME64: torch.int64,
    Kind.DURATION: torch.int64,
}


@dataclasses.dataclass(frozen=True)
class DType:
    """Logical dtype. Parity: ``cylon::DataType``. ``bytes_width`` set
    means the device-bytes string layout."""

    kind: Kind
    unit: "str | None" = None
    bytes_width: "int | None" = None

    @property
    def physical(self) -> torch.dtype:
        if self.bytes_width is not None:
            return torch.int32
        return _PHYSICAL[self.kind]

    @property
    def layout(self) -> Layout:
        if self.kind in (Kind.STRING, Kind.BINARY):
            return Layout.VARIABLE_WIDTH
        return Layout.FIXED_WIDTH

    @property
    def is_dictionary(self) -> bool:
        return (self.kind in (Kind.STRING, Kind.BINARY)
                and self.bytes_width is None)

    @property
    def is_bytes(self) -> bool:
        return self.bytes_width is not None

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            Kind.UINT8, Kind.INT8, Kind.UINT16, Kind.INT16, Kind.UINT32,
            Kind.INT32, Kind.UINT64, Kind.INT64, Kind.HALF_FLOAT, Kind.FLOAT,
            Kind.DOUBLE)

    @property
    def is_floating(self) -> bool:
        return self.kind in (Kind.HALF_FLOAT, Kind.FLOAT, Kind.DOUBLE)

    def __repr__(self):
        if self.bytes_width is not None:
            return f"{self.kind.name.lower()}[bytes:{self.bytes_width}]"
        u = f"[{self.unit}]" if self.unit else ""
        return f"{self.kind.name.lower()}{u}"


bool_ = DType(Kind.BOOL)
uint8 = DType(Kind.UINT8)
int8 = DType(Kind.INT8)
uint16 = DType(Kind.UINT16)
int16 = DType(Kind.INT16)
uint32 = DType(Kind.UINT32)
int32 = DType(Kind.INT32)
uint64 = DType(Kind.UINT64)
int64 = DType(Kind.INT64)
float16 = DType(Kind.HALF_FLOAT)
float32 = DType(Kind.FLOAT)
float64 = DType(Kind.DOUBLE)
string = DType(Kind.STRING)
binary = DType(Kind.BINARY)
date32 = DType(Kind.DATE32)
date64 = DType(Kind.DATE64)


def string_bytes(width: int) -> DType:
    """Device-bytes string dtype (``width`` padded bytes per row)."""
    if width % 4:
        width += 4 - width % 4
    return DType(Kind.STRING, None, int(width))


def timestamp(unit: str = "ns") -> DType:
    return DType(Kind.TIMESTAMP, unit)


def duration(unit: str = "ns") -> DType:
    return DType(Kind.DURATION, unit)


_NUMPY_TO_KIND = {
    np.dtype(np.bool_): Kind.BOOL,
    np.dtype(np.uint8): Kind.UINT8,
    np.dtype(np.int8): Kind.INT8,
    np.dtype(np.uint16): Kind.UINT16,
    np.dtype(np.int16): Kind.INT16,
    np.dtype(np.uint32): Kind.UINT32,
    np.dtype(np.int32): Kind.INT32,
    np.dtype(np.uint64): Kind.UINT64,
    np.dtype(np.int64): Kind.INT64,
    np.dtype(np.float16): Kind.HALF_FLOAT,
    np.dtype(np.float32): Kind.FLOAT,
    np.dtype(np.float64): Kind.DOUBLE,
}

#: logical type names as the JAX package spells them (``repr`` of its
#: DType), for :mod:`cylon_tpu_torch.convert`
BY_NAME = {d.kind.name.lower(): d for d in (
    bool_, uint8, int8, uint16, int16, uint32, int32, uint64, int64,
    float16, float32, float64, string, binary, date32, date64)}


def from_numpy_dtype(dt) -> DType:
    """numpy dtype -> logical DType (parity: ``arrow_types.cpp``)."""
    dt = np.dtype(dt)
    if dt.kind in ("U", "S", "O"):
        return string
    if dt.kind == "M":
        return timestamp(np.datetime_data(dt)[0])
    if dt.kind == "m":
        return duration(np.datetime_data(dt)[0])
    kind = _NUMPY_TO_KIND.get(dt)
    if kind is None:
        raise TypeError(f"unsupported numpy dtype {dt}")
    return DType(kind)


#: torch dtype -> numpy dtype, for the types numpy has
_TORCH_TO_NUMPY = {
    torch.bool: np.dtype(np.bool_), torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8), torch.uint16: np.dtype(np.uint16),
    torch.int16: np.dtype(np.int16), torch.uint32: np.dtype(np.uint32),
    torch.int32: np.dtype(np.int32), torch.uint64: np.dtype(np.uint64),
    torch.int64: np.dtype(np.int64), torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64)}


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (no tensor made)."""
    if dt not in _TORCH_TO_NUMPY:
        raise TypeError(f"torch dtype {dt} has no numpy dtype")
    return _TORCH_TO_NUMPY[dt]


def from_torch_dtype(dt: torch.dtype) -> DType:
    """Physical torch dtype -> logical DType (numeric and bool)."""
    return from_numpy_dtype(numpy_dtype(dt))


def from_name(name: str) -> DType:
    """Parse a logical type name: ``int64``, ``timestamp[ns]``,
    ``string[bytes:16]``."""
    base, _, rest = name.partition("[")
    rest = rest.rstrip("]")
    if rest.startswith("bytes:"):
        return string_bytes(int(rest[len("bytes:"):]))
    if base in ("timestamp", "duration"):
        return DType(Kind[base.upper()], rest or "ns")
    if base not in BY_NAME:
        raise TypeError(f"unknown logical type {name!r}")
    return BY_NAME[base]


def sentinel_high(phys: torch.dtype):
    """Largest value of a physical dtype: the fill that a min reduction
    never picks over a real value."""
    if phys == torch.bool:
        return True
    if phys.is_floating_point:
        return float("inf")
    return torch.iinfo(phys).max


def sentinel_low(phys: torch.dtype):
    """Smallest value of a physical dtype (the max reduction's fill)."""
    if phys == torch.bool:
        return False
    if phys.is_floating_point:
        return float("-inf")
    return torch.iinfo(phys).min
