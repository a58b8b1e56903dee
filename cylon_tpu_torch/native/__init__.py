"""ctypes bindings for the native host runtime (``cylon_host.cpp``).

Port of ``cylon_tpu/native/__init__.py``. The host runtime (memory pool,
murmur3, a fixed thread pool, the chunk-parallel CSV parser, the
string-id catalog and its host hash join) is C++ behind a plain C ABI
(``cylon_host.h``, the JAX package's ABI byte for byte); this module is
its ctypes client, and builds the port's tables from what it returns.

The shared library builds at first use with ``g++`` into
``cylon_tpu_torch/_build/`` (listed in ``.gitignore``), named
``libcylon_host_<hash>.so`` where the hash covers both sources and the
flags, so a stale library is never loaded. It is linked with
``-Wl,-Bsymbolic`` and loaded ``RTLD_LOCAL``: the JAX package's library
exports the same ``cylon_*`` symbols, and each library keeps its own
catalog registry when both are loaded in one process.

Nothing here falls back quietly: every entry point raises
:class:`NativeBuildError` when the library cannot be built.
:func:`available` only answers ``cylon_tpu_torch.io``'s routing rule for
``engine="auto"``.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from itertools import repeat
from pathlib import Path

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column, Dictionary
from cylon_tpu_torch.device import from_host, resolve
from cylon_tpu_torch.errors import (CylonError, InvalidArgument, IOError_,
                                    KeyError_)
from cylon_tpu_torch.table import Table

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "cylon_host.cpp", _HERE / "cylon_host.h")
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-Wl,-Bsymbolic")

_lib = None
_lock = threading.Lock()
_build_error: "str | None" = None
#: what the build in this process did: seconds and library path (empty
#: when an earlier process had built the current sources)
last_build: dict = {}


class NativeBuildError(CylonError, RuntimeError):
    """``g++`` is missing or refused the host runtime's source."""


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256()
    for p in _SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcylon_host_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile under a per-process name and rename into place, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}_{os.getpid()}_{threading.get_ident()}.so"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SOURCES[0])]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ unavailable: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build failed: {proc.stderr[-2000:]}")
    os.replace(tmp, path)
    last_build.update(seconds=time.perf_counter() - t0, path=str(path))


def _load():
    """The loaded library, built on first use. Raises
    :class:`NativeBuildError` (the same one on every later call) when it
    cannot be built or loaded."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise NativeBuildError(_build_error)
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
            except OSError as e:
                raise NativeBuildError(str(e)) from e
        except NativeBuildError as e:
            _build_error = str(e)
            raise
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib):
    c = ctypes
    lib.cylon_pool_create.restype = c.c_void_p
    lib.cylon_pool_create.argtypes = [c.c_int64]
    lib.cylon_pool_destroy.argtypes = [c.c_void_p]
    lib.cylon_pool_alloc.restype = c.c_void_p
    lib.cylon_pool_alloc.argtypes = [c.c_void_p, c.c_int64]
    lib.cylon_pool_free.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.cylon_pool_stats.argtypes = [c.c_void_p] + [c.POINTER(c.c_int64)] * 4

    lib.cylon_murmur3_x86_32.restype = c.c_uint32
    lib.cylon_murmur3_x86_32.argtypes = [c.c_void_p, c.c_int, c.c_uint32]
    lib.cylon_murmur3_int64_array.argtypes = [
        c.c_void_p, c.c_int64, c.c_uint32, c.c_void_p]

    lib.cylon_threadpool_create.restype = c.c_void_p
    lib.cylon_threadpool_create.argtypes = [c.c_int]
    lib.cylon_threadpool_destroy.argtypes = [c.c_void_p]
    lib.cylon_threadpool_wait.argtypes = [c.c_void_p]

    lib.cylon_csv_read.restype = c.c_void_p
    lib.cylon_csv_read.argtypes = [c.c_char_p, c.c_char, c.c_int, c.c_int]
    lib.cylon_csv_read_opts.restype = c.c_void_p
    lib.cylon_csv_read_opts.argtypes = [
        c.c_char_p, c.c_char, c.c_int, c.c_int, c.c_char, c.c_char_p,
        c.c_char_p, c.c_int]
    lib.cylon_csv_error.restype = c.c_char_p
    lib.cylon_csv_error.argtypes = [c.c_void_p]
    lib.cylon_csv_num_rows.restype = c.c_int64
    lib.cylon_csv_num_rows.argtypes = [c.c_void_p]
    lib.cylon_csv_num_cols.restype = c.c_int32
    lib.cylon_csv_num_cols.argtypes = [c.c_void_p]
    lib.cylon_csv_col_name.restype = c.c_char_p
    lib.cylon_csv_col_name.argtypes = [c.c_void_p, c.c_int32]
    lib.cylon_csv_col_type.restype = c.c_int32
    lib.cylon_csv_col_type.argtypes = [c.c_void_p, c.c_int32]
    for fn in (lib.cylon_csv_col_i64, lib.cylon_csv_col_f64,
               lib.cylon_csv_col_codes, lib.cylon_csv_col_validity):
        fn.argtypes = [c.c_void_p, c.c_int32, c.c_void_p]
    lib.cylon_csv_dict_size.restype = c.c_int32
    lib.cylon_csv_dict_size.argtypes = [c.c_void_p, c.c_int32]
    lib.cylon_csv_dict_value.restype = c.c_char_p
    lib.cylon_csv_dict_value.argtypes = [c.c_void_p, c.c_int32, c.c_int32]
    lib.cylon_csv_free.argtypes = [c.c_void_p]

    lib.cylon_catalog_put.restype = c.c_int32
    lib.cylon_catalog_put.argtypes = [
        c.c_char_p, c.c_int32, c.POINTER(c.c_char_p),
        c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_void_p),
        c.POINTER(c.c_int64), c.POINTER(c.c_void_p)]
    lib.cylon_catalog_rows.restype = c.c_int64
    lib.cylon_catalog_rows.argtypes = [c.c_char_p]
    lib.cylon_catalog_ncols.restype = c.c_int32
    lib.cylon_catalog_ncols.argtypes = [c.c_char_p]
    lib.cylon_catalog_col_info.restype = c.c_int32
    lib.cylon_catalog_col_info.argtypes = [
        c.c_char_p, c.c_int32, c.c_char_p, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.POINTER(c.c_int32)]
    lib.cylon_catalog_col_read.restype = c.c_int32
    lib.cylon_catalog_col_read.argtypes = [
        c.c_char_p, c.c_int32, c.c_void_p, c.c_int64, c.c_void_p]
    lib.cylon_catalog_join.restype = c.c_int32
    lib.cylon_catalog_join.argtypes = [
        c.c_char_p, c.c_char_p, c.c_char_p, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32]
    lib.cylon_catalog_remove.restype = c.c_int32
    lib.cylon_catalog_remove.argtypes = [c.c_char_p]
    lib.cylon_catalog_size.restype = c.c_int32
    lib.cylon_catalog_size.argtypes = []
    lib.cylon_catalog_ids.restype = c.c_int64
    lib.cylon_catalog_ids.argtypes = [c.c_char_p, c.c_int64]
    lib.cylon_catalog_clear.argtypes = []


def available() -> bool:
    """Does the library build and load here? (``read_csv``'s routing
    rule for ``engine="auto"``.)"""
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def build_error() -> "str | None":
    """Why the library cannot be built or loaded, or None."""
    available()
    return _build_error


# ---------------------------------------------------------------- pool
class MemoryPool:
    """Aligned host allocator with stats (parity:
    ``ctx/memory_pool.hpp:24-60``)."""

    def __init__(self, pool_limit_bytes: int = 0):
        self._lib = _load()
        self._h = self._lib.cylon_pool_create(pool_limit_bytes)

    def alloc(self, size: int) -> int:
        return self._lib.cylon_pool_alloc(self._h, size)

    def free(self, ptr: int, size: int) -> None:
        self._lib.cylon_pool_free(self._h, ptr, size)

    def stats(self) -> dict:
        vals = [ctypes.c_int64() for _ in range(4)]
        self._lib.cylon_pool_stats(self._h, *[ctypes.byref(v) for v in vals])
        return {"bytes_allocated": vals[0].value,
                "max_memory": vals[1].value,
                "num_allocations": vals[2].value,
                "pooled_bytes": vals[3].value}

    def close(self):
        if self._h:
            self._lib.cylon_pool_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# -------------------------------------------------------------- murmur3
def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Parity: ``util::MurmurHash3_x86_32``."""
    return int(_load().cylon_murmur3_x86_32(data, len(data), seed))


def murmur3_int64(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Bulk int64 row hash (parity: the per-row murmur loop of
    ``arrow_partition_kernels.cpp:140``)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), dtype=np.uint32)
    lib.cylon_murmur3_int64_array(
        keys.ctypes.data_as(ctypes.c_void_p), len(keys), seed,
        out.ctypes.data_as(ctypes.c_void_p))
    return out


# ------------------------------------------------------------ csv loader
_COL_INT64, _COL_FLOAT64, _COL_STRING = 0, 1, 2

#: ColType ints of the native parser (cylon_host.h)
_NATIVE_TYPES = {"int64": 0, "float64": 1, "str": 2, "string": 2}


def csv_dtype_ok(t) -> bool:
    """Can the native csv engine represent dtype override ``t``?
    (int64 / float64 / str only: the rule ``read_csv``'s routing and the
    spec encoder below share.)"""
    if t in ("str", "string", str):
        return True
    try:
        return str(np.dtype(t)) in ("int64", "float64")
    except TypeError:
        return False


def _native_type_spec(column_types) -> "bytes | None":
    if not column_types:
        return None
    parts = []
    for name, t in column_types.items():
        if not csv_dtype_ok(t):
            raise InvalidArgument(
                f"native csv engine cannot represent dtype {t!r} for "
                f"column {name!r} (int64/float64/str only); use "
                f"engine='arrow'")
        code = 2 if t in ("str", "string", str) \
            else _NATIVE_TYPES[str(np.dtype(t))]
        parts.append(f"{name}\x1f{code}")
    return (";".join(parts)).encode()


def read_csv_native(path: str, delimiter: str = ",", header: bool = True,
                    n_threads: int = 0, quote_char: "str | None" = None,
                    na_values=None, column_types=None,
                    strings_can_be_null: bool = False) -> dict:
    """Chunk-parallel CSV parse -> dict of host columns.

    Returns ``{name: payload}``: ``("i64", int64 array, validity)``,
    ``("f64", float64 array, validity)`` or ``("str", int32 codes,
    validity, sorted values)``, each validity a bool array.
    ``n_threads`` 0 takes the host's hardware concurrency.

    ``quote_char`` / ``na_values`` / ``column_types`` /
    ``strings_can_be_null`` mirror the reference's UseQuoting /
    NullValues / WithColumnTypes / StringsCanBeNull
    (``csv_read_config.hpp:80-141``).

    (``cylon_tpu/native/__init__.py`` ``read_csv_native``)"""
    lib = _load()
    if quote_char or na_values or column_types:
        na = ("\x1f".join(na_values).encode() if na_values else None)
        h = lib.cylon_csv_read_opts(
            path.encode(), delimiter.encode(), 1 if header else 0,
            n_threads, (quote_char or "\x00").encode(), na,
            _native_type_spec(column_types),
            1 if strings_can_be_null else 0)
    else:
        h = lib.cylon_csv_read(path.encode(), delimiter.encode(),
                               1 if header else 0, n_threads)
    try:
        err = lib.cylon_csv_error(h)
        if err:
            raise IOError_(err.decode())
        n = lib.cylon_csv_num_rows(h)
        ncols = lib.cylon_csv_num_cols(h)
        out = {}
        for col in range(ncols):
            name = lib.cylon_csv_col_name(h, col).decode()
            typ = lib.cylon_csv_col_type(h, col)
            validity = np.empty(n, dtype=np.uint8)
            lib.cylon_csv_col_validity(
                h, col, validity.ctypes.data_as(ctypes.c_void_p))
            vmask = validity.astype(bool)
            if typ == _COL_INT64:
                data = np.empty(n, dtype=np.int64)
                lib.cylon_csv_col_i64(
                    h, col, data.ctypes.data_as(ctypes.c_void_p))
                out[name] = ("i64", data, vmask)
            elif typ == _COL_FLOAT64:
                data = np.empty(n, dtype=np.float64)
                lib.cylon_csv_col_f64(
                    h, col, data.ctypes.data_as(ctypes.c_void_p))
                out[name] = ("f64", data, vmask)
            else:
                codes = np.empty(n, dtype=np.int32)
                lib.cylon_csv_col_codes(
                    h, col, codes.ctypes.data_as(ctypes.c_void_p))
                k = lib.cylon_csv_dict_size(h, col)
                values = np.array(
                    [v.decode() for v in map(lib.cylon_csv_dict_value,
                                             repeat(h, k), repeat(col, k),
                                             range(k))], dtype=object)
                out[name] = ("str", codes, vmask, values)
        return out
    finally:
        lib.cylon_csv_free(h)


def _padded_validity(vmask: np.ndarray, capacity: int, device):
    """A column's validity tensor, or None when every row is valid."""
    if vmask.all():
        return None
    v = np.zeros(capacity, bool)
    v[:len(vmask)] = vmask
    return from_host(v, device)


def _raw_to_table(raw: dict, capacity: "int | None" = None, device=None):
    """:func:`read_csv_native`'s columns -> a port ``Table`` on
    ``device`` (None: CUDA). String columns become dictionary columns
    with their sorted dictionaries; nulls become validity masks."""
    dev = resolve(device)
    cols = {}
    n = 0
    for name, payload in raw.items():
        data, vmask = payload[1], payload[2]
        n = len(data)
        col = Column.from_numpy(data, capacity, device=dev)
        validity = _padded_validity(vmask, col.capacity, dev)
        if payload[0] == "str":
            cols[name] = Column(col.data, validity, dtypes.string,
                                Dictionary(payload[3]))
        else:
            cols[name] = Column(col.data, validity, col.dtype)
    return Table(cols, torch.tensor(n, dtype=torch.int32, device=dev))


def csv_to_table(path: str, delimiter: str = ",", header: bool = True,
                 n_threads: int = 0, capacity: "int | None" = None,
                 quote_char: "str | None" = None, na_values=None,
                 column_types=None, strings_can_be_null: bool = False,
                 device=None):
    """Native CSV -> port ``Table`` on ``device`` (None: CUDA). The
    parse and the copy to the device run under the spans
    ``native.csv_parse`` and ``native.csv_to_device``.

    (``cylon_tpu/native/__init__.py`` ``csv_to_table``)"""
    from cylon_tpu_torch.utils import tracing

    dev = resolve(device)
    with tracing.span("native.csv_parse"):
        raw = read_csv_native(path, delimiter, header, n_threads,
                              quote_char=quote_char, na_values=na_values,
                              column_types=column_types,
                              strings_can_be_null=strings_can_be_null)
    with tracing.span("native.csv_to_device"):
        return _raw_to_table(raw, capacity, dev)


# ------------------------------------------------------------- catalog
# Parity: table_api.{hpp,cpp} PutTable/GetTable/RemoveTable (:38-90),
# the registry the reference's Java JNI binding drives
# (Table.java:289-307). The same C symbols are bindable from JNI/cffi/
# .NET; this is the ctypes client. Wire format per column: a raw byte
# buffer + dtype code + optional uint8 validity; dictionary columns ship
# their codes plus two companion pseudo-columns (utf8 blob, int64
# offsets) named "<col>\x01blob" / "<col>\x01offs". The tags and the
# wire format are the JAX package's, so either binding reads the
# other's images.

#: dtype tag = Kind enum value | (temporal-unit index << 8); opaque to C.
_UNITS = [None, "s", "ms", "us", "ns", "D", "h", "m", "W"]
_DICT_BLOB = "\x01blob"
_DICT_OFFS = "\x01offs"

#: numpy dtype of each physical torch dtype (``dtypes._PHYSICAL``)
_NUMPY_OF = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.uint16: np.uint16, torch.int16: np.int16,
    torch.uint32: np.uint32, torch.int32: np.int32,
    torch.uint64: np.uint64, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64}


def _dtype_tag(dt) -> int:
    if dt.unit not in _UNITS:
        raise InvalidArgument(f"temporal unit {dt.unit!r} not "
                              f"representable in the catalog tag (known: "
                              f"{_UNITS[1:]})")
    return int(dt.kind.value) | (_UNITS.index(dt.unit) << 8)


def _tag_dtype(tag: int):
    return dtypes.DType(dtypes.Kind(tag & 0xFF), _UNITS[(tag >> 8) & 0xFF])


def catalog_put(table_id: str, table) -> None:
    """Copy a port Table's valid rows to the host and into the native
    catalog (parity: ``PutTable``, table_api.hpp:38). A string column in
    device-bytes storage has no image in the wire format and raises
    :class:`InvalidArgument`: cast it to dictionary storage first.

    (``cylon_tpu/native/__init__.py`` ``catalog_put``)"""
    lib = _load()
    for name, c in table.columns.items():
        if c.dtype.is_bytes:
            raise InvalidArgument(
                f"column {name!r} holds strings as device bytes "
                f"({c.dtype!r}), which the native catalog cannot carry: "
                f"cast it to dictionary storage "
                f"(column.astype(dtypes.string)) first")
    n = table.num_rows
    names, dtags, bufs, lens, vals = [], [], [], [], []

    def add(name, arr, tag, validity=None):
        arr = np.ascontiguousarray(arr)
        names.append(name.encode())
        dtags.append(tag)
        bufs.append(arr)
        lens.append(arr.nbytes)
        vals.append(validity)

    for name, c in table.columns.items():
        data = c.data[:n].cpu().numpy()
        validity = None
        if c.validity is not None:
            validity = np.ascontiguousarray(
                c.validity[:n].cpu().numpy(), dtype=np.uint8)
        add(name, data, _dtype_tag(c.dtype), validity)
        if c.dtype.is_dictionary and c.dictionary is not None:
            blobs = [str(v).encode() for v in c.dictionary.values]
            offs = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=offs[1:])
            blob = (np.frombuffer(b"".join(blobs), np.uint8).copy()
                    if blobs else np.zeros(0, np.uint8))
            add(name + _DICT_BLOB, blob, _dtype_tag(dtypes.uint8))
            add(name + _DICT_OFFS, offs, _dtype_tag(dtypes.int64))

    nc = len(names)
    c_names = (ctypes.c_char_p * nc)(*names)
    c_dtypes = (ctypes.c_int32 * nc)(*dtags)
    c_bufs = (ctypes.c_void_p * nc)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
    c_lens = (ctypes.c_int64 * nc)(*lens)
    c_vals = (ctypes.c_void_p * nc)(
        *[(v.ctypes.data_as(ctypes.c_void_p).value if v is not None else None)
          for v in vals])
    rc = lib.cylon_catalog_put(table_id.encode(), nc, c_names, c_dtypes,
                               n, c_bufs, c_lens, c_vals)
    if rc != 0:
        raise CylonError(f"catalog put failed rc={rc}")


def catalog_get(table_id: str, device=None):
    """Rebuild a port Table on ``device`` (None: CUDA) from a native
    catalog entry (parity: ``GetTable``, table_api.hpp:44).

    (``cylon_tpu/native/__init__.py`` ``catalog_get``)"""
    lib = _load()
    dev = resolve(device)
    n = lib.cylon_catalog_rows(table_id.encode())
    if n < 0:
        raise KeyError_(table_id)
    nc = lib.cylon_catalog_ncols(table_id.encode())
    raw = {}
    for i in range(nc):
        cap = 512
        while True:
            name_buf = ctypes.create_string_buffer(cap)
            tag = ctypes.c_int32()
            nbytes = ctypes.c_int64()
            hasv = ctypes.c_int32()
            rc = lib.cylon_catalog_col_info(table_id.encode(), i, name_buf,
                                            cap, ctypes.byref(tag),
                                            ctypes.byref(nbytes),
                                            ctypes.byref(hasv))
            if rc < 0:
                raise CylonError(f"catalog col_info failed rc={rc}")
            if rc < cap:  # the full name fit
                break
            cap = rc + 1
        dt = _tag_dtype(tag.value)
        npdt = np.dtype(_NUMPY_OF[dt.physical])
        if nbytes.value % npdt.itemsize:
            raise InvalidArgument(
                f"column {i} of {table_id!r}: byte length {nbytes.value} "
                f"not a multiple of {npdt} itemsize (foreign writer bug?)")
        data = np.empty(nbytes.value // npdt.itemsize, npdt)
        validity = np.empty(n, np.uint8) if hasv.value else None
        rc = lib.cylon_catalog_col_read(
            table_id.encode(), i, data.ctypes.data_as(ctypes.c_void_p),
            data.nbytes,
            validity.ctypes.data_as(ctypes.c_void_p)
            if validity is not None else None)
        if rc != 0:
            raise CylonError(f"catalog col_read failed rc={rc}")
        raw[name_buf.value.decode()] = (dt, data, validity)

    cols = {}
    for name, (dt, data, validity) in raw.items():
        if _DICT_BLOB in name or _DICT_OFFS in name:
            continue
        vmask = (None if validity is None
                 else from_host(validity.astype(bool), dev))
        dictionary = None
        if name + _DICT_BLOB in raw:
            _, blob, _ = raw[name + _DICT_BLOB]
            _, offs, _ = raw[name + _DICT_OFFS]
            b = blob.tobytes()
            dictionary = Dictionary(np.array(
                [b[offs[j]:offs[j + 1]].decode()
                 for j in range(len(offs) - 1)], object))
        cols[name] = Column(from_host(data, dev), vmask, dt, dictionary)
    return Table(cols, torch.tensor(n, dtype=torch.int32, device=dev))


def catalog_ids() -> list:
    lib = _load()
    need = lib.cylon_catalog_ids(None, 0)
    while True:
        buf = ctypes.create_string_buffer(int(need) + 1)
        got = lib.cylon_catalog_ids(buf, need + 1)
        if got <= need:  # fit (a concurrent put may have grown the set)
            break
        need = got
    s = buf.value.decode()
    return sorted(s.split("\n")) if s else []


def catalog_remove(table_id: str) -> None:
    if _load().cylon_catalog_remove(table_id.encode()) != 0:
        raise KeyError_(table_id)


def catalog_clear() -> None:
    _load().cylon_catalog_clear()
