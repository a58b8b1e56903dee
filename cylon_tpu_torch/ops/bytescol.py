"""Device-bytes string columns.

Port of ``cylon_tpu/ops/bytescol.py``. The layout is the JAX package's:

    data: [capacity, nwords] -- each row's UTF-8 bytes, zero-padded to a
    static per-column byte width and packed BIG-ENDIAN into u32 words.

Here the words are int32 tensors holding the u32 bit patterns, as every
word stream of the port is (:mod:`cylon_tpu_torch.ops.hash`). Big-endian
packing makes UNSIGNED word order equal byte order, so the unsigned
lexicographic order of a row's words is its string order, a prefix
ranking before its extensions. Every sort, group, join and partition path
consumes a bytes column as ``nwords`` extra u32 key words, keyed unsigned
(``kernels.group_sort``: never the signed order of int32); the exchange
and the row gathers move it as words.

The representable set: NUL-free byte strings (checked at ingest: a value
holding ``\\x00`` cannot be told from its padding; such data takes
dictionary storage). A row's length is the offset of its last non-zero
byte. Null rows are all-zero words with validity False, like the empty
string: only the validity (and the sort's tiebreak) tells them apart.

The host codec (``encode_host``, ``decode_host``, ``encode_scalar``)
stays numpy and yields the JAX package's uint32 words; the device parts
take torch tensors on the column's device. Dictionary codes win for
low-cardinality columns, bytes where the value set grows with the data;
``string_storage="auto"`` samples cardinality at ingest
(:func:`choose_storage`).
"""

from typing import Sequence

import numpy as np
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, TypeError_

#: bytes per word; widths round up to whole words
WORD = 4
_M32 = 0xFFFFFFFF


def width_words(nbytes: int) -> int:
    return max(1, -(-int(nbytes) // WORD))


# --------------------------------------------------------------- host codec
def encode_host(values, width: "int | None" = None
                ) -> "tuple[np.ndarray, np.ndarray | None, int]":
    """Object/str array -> ([n, nwords] uint32 big-endian words,
    validity or None, byte width). None, NaN and pd.NA become all-zero
    rows with validity False. Raises :class:`TypeError_` for an embedded
    NUL byte (not representable: use dictionary storage)."""
    import pandas as pd

    arr = np.asarray(values, dtype=object)
    isnull = np.asarray(pd.isna(arr))
    if isnull.ndim == 0:
        isnull = np.broadcast_to(isnull, arr.shape).copy()
    filled = np.where(isnull, "", arr)
    # np.char.encode takes non-ASCII (utf-8); .astype("S") does not
    sbytes = np.char.encode(filled.astype(str), "utf-8")
    maxlen = sbytes.dtype.itemsize
    if width is not None:
        if maxlen > width:
            raise InvalidArgument(
                f"string of {maxlen} bytes exceeds declared width {width}")
        maxlen = width
    nw = width_words(maxlen)
    n = len(sbytes)
    padded = np.zeros((n, nw * WORD), np.uint8)
    if n:
        raw = sbytes.astype(f"S{nw * WORD}")   # zero-pads (numpy S)
        padded = np.frombuffer(raw.tobytes(), np.uint8).reshape(n, nw * WORD)
    if _embedded_nul(padded).any():
        raise TypeError_(
            "string contains NUL byte; device-bytes storage cannot "
            "represent it -- use string_storage='dict'")
    words = padded.view(">u4").astype(np.uint32)
    validity = None
    if isnull.any():
        validity = ~isnull
        words = np.where(isnull[:, None], np.uint32(0), words)
    return words, validity, nw * WORD


def _embedded_nul(padded: np.ndarray) -> np.ndarray:
    """[n] bool: rows with a zero byte before a non-zero byte."""
    if padded.size == 0:
        return np.zeros(padded.shape[0], bool)
    nz = padded != 0
    # any non-zero byte strictly after position j
    suf = np.flip(np.maximum.accumulate(np.flip(nz, 1), 1), 1)
    later = np.concatenate(
        [suf[:, 1:], np.zeros((padded.shape[0], 1), bool)], axis=1)
    return ((padded == 0) & later).any(axis=1)


def decode_host(words: np.ndarray, validity: "np.ndarray | None"
                ) -> np.ndarray:
    """[n, nwords] u32 words (uint32, or int32 bit patterns) -> object
    array of str (trailing NULs stripped; null rows -> None)."""
    words = np.ascontiguousarray(words)
    n, nw = words.shape
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    raw = words.astype(">u4").tobytes()
    sarr = np.frombuffer(raw, dtype=f"S{nw * WORD}")  # strips trailing NUL
    out = np.asarray(np.char.decode(sarr, "utf-8"), dtype=object)
    if validity is not None and (~validity).any():
        out[~validity] = None
    return out


def encode_scalar(value: str, nwords: int) -> np.ndarray:
    """One value -> [nwords] uint32 (zero-padded), for device compares."""
    b = str(value).encode("utf-8")
    if b"\x00" in b:
        raise TypeError_("NUL byte in comparison value")
    if len(b) > nwords * WORD:
        raise InvalidArgument(
            f"value of {len(b)} bytes exceeds column width {nwords * WORD}")
    padded = b + b"\x00" * (nwords * WORD - len(b))
    return np.frombuffer(padded, ">u4").astype(np.uint32)


def _device_words(words: np.ndarray, device) -> torch.Tensor:
    """uint32 host words -> int32 bit patterns on ``device`` (a view,
    never a value cast)."""
    return torch.from_numpy(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


# ----------------------------------------------------------- column factory
def from_numpy(arr, capacity: "int | None" = None,
               width: "int | None" = None, *, device) -> Column:
    """Host string array -> device-bytes Column on ``device``."""
    words, validity, bw = encode_host(arr, width)
    return Column._pad(words.view(np.int32), validity,
                       dtypes.string_bytes(bw), None, capacity,
                       torch.device(device))


def pad_words(data: torch.Tensor, nw: int) -> torch.Tensor:
    """[cap, w] words -> [cap, nw] with zero words appended (a zero word
    ranks below any byte, so padding never changes order)."""
    if data.shape[1] >= nw:
        return data
    pad = torch.zeros((data.shape[0], nw - data.shape[1]), dtype=data.dtype,
                      device=data.device)
    return torch.cat([data, pad], dim=1)


def dict_to_bytes(col: Column, width: "int | None" = None) -> Column:
    """Dictionary column -> device-bytes column: the dictionary's values
    are encoded on the host once ([ndict, nwords]), then one device
    gather maps codes to word rows. Nulls stay nulls."""
    if not col.dtype.is_dictionary:
        raise TypeError_("dict_to_bytes on non-dictionary column")
    vals = (col.dictionary.values if col.dictionary is not None
            else np.asarray([], object))
    if len(vals):
        words, dvalid, bw = encode_host(vals, width)
        if dvalid is not None:   # a null dictionary value
            words = np.where(dvalid[:, None], words, np.uint32(0))
    else:
        bw = width or WORD
        words = np.zeros((0, width_words(bw)), np.uint32)
    nw = width_words(bw if width is None else width)
    if words.shape[1] < nw:
        words = np.pad(words, ((0, 0), (0, nw - words.shape[1])))
    dev = col.data.device
    if len(vals):
        table = _device_words(words, dev)
        data = table[torch.clamp(col.data, 0, len(vals) - 1).to(torch.int64)]
    else:
        data = torch.zeros((col.capacity, nw), dtype=torch.int32, device=dev)
    if col.validity is not None:
        data = torch.where(col.validity[:, None], data,
                           torch.zeros((), dtype=data.dtype, device=dev))
    return Column(data, col.validity, dtypes.string_bytes(nw * WORD), None)


def bytes_to_dict(col: Column, nrows: int) -> Column:
    """Device-bytes -> dictionary column (a host round trip that builds
    the dictionary this storage avoids: explicit casts only)."""
    return Column.from_numpy(col.to_numpy(nrows), col.capacity,
                             device=col.data.device)


def align_widths(cols: Sequence[Column]) -> list:
    """Pad every device-bytes column to the widest word count."""
    bcols = [c for c in cols if c.dtype.is_bytes]
    if not bcols:
        return list(cols)
    nw = max(c.data.shape[1] for c in bcols)
    out = []
    for c in cols:
        if c.dtype.is_bytes and c.data.shape[1] < nw:
            out.append(Column(pad_words(c.data, nw), c.validity,
                              dtypes.string_bytes(nw * WORD), None))
        else:
            out.append(c)
    return out


def align_storages(cols: Sequence[Column]) -> list:
    """STRING columns of mixed storage on one device layout: if any is
    device bytes, dictionary peers convert to bytes (a device gather of
    their host-encoded values), and the widths align."""
    if not any(c.dtype.is_bytes for c in cols):
        return list(cols)
    return align_widths([dict_to_bytes(c) if c.dtype.is_dictionary else c
                         for c in cols])


def align_table_strings(tables) -> list:
    """Column-name-wise storage alignment across tables (the bytes
    counterpart of ``dictenc.unify_table_dictionaries``): a column that
    is device bytes in one table becomes device bytes in all, at one
    width."""
    from cylon_tpu_torch.table import Table

    tables = list(tables)
    if len(tables) < 2:
        return tables
    names = tables[0].column_names
    touched = [n for n in names
               if any(n in t.columns and t.column(n).dtype.is_bytes
                      for t in tables)]
    if not touched:
        return tables
    new_cols = [dict(t.columns) for t in tables]
    for name in touched:
        aligned = align_storages([t.column(name) for t in tables])
        for i, c in enumerate(aligned):
            new_cols[i][name] = c
    return [Table(new_cols[i], t.nrows) for i, t in enumerate(tables)]


# ------------------------------------------------------------ device parts
def byte_matrix(data: torch.Tensor) -> torch.Tensor:
    """[cap, nwords] words -> [cap, nwords*4] int32 byte values (0..255),
    first byte first."""
    # (24, 16, 8, 0), made on the device
    shifts = 24 - 8 * torch.arange(4, dtype=torch.int32, device=data.device)
    b = (data.to(torch.int32)[:, :, None] >> shifts) & 0xFF
    return b.reshape(data.shape[0], -1)


def _lengths_of(b: torch.Tensor) -> torch.Tensor:
    """[cap] int32 byte length from a byte matrix."""
    idx = torch.arange(1, b.shape[1] + 1, dtype=torch.int32, device=b.device)
    return torch.where(b != 0, idx, 0).amax(dim=1)


def char_lengths(data: torch.Tensor) -> torch.Tensor:
    """[cap] int32 CHARACTER count: a byte starts a UTF-8 code point iff
    it is not a continuation byte ((b & 0xC0) != 0x80). Matches pandas
    ``Series.str.len``."""
    b = byte_matrix(data)
    start = (b != 0) & ((b & 0xC0) != 0x80)
    return start.sum(dim=1, dtype=torch.int32)


def _pat_bytes(pat: str) -> np.ndarray:
    b = str(pat).encode("utf-8")
    if b"\x00" in b:
        raise TypeError_("NUL byte in pattern")
    return np.frombuffer(b, np.uint8).astype(np.int32)


def _pat_tensor(pat: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(pat).to(device)


def startswith(col: Column, prefix: str) -> torch.Tensor:
    """[cap] bool: rows whose value starts with ``prefix``."""
    pat = _pat_bytes(prefix)
    m = len(pat)
    if m == 0:
        return _all_valid(col)
    b = byte_matrix(col.data)
    if m > b.shape[1]:
        return torch.zeros(col.capacity, dtype=torch.bool,
                           device=col.data.device)
    mask = (b[:, :m] == _pat_tensor(pat, b.device)[None, :]).all(dim=1)
    return _and_valid(col, mask)


def endswith(col: Column, suffix: str) -> torch.Tensor:
    pat = _pat_bytes(suffix)
    m = len(pat)
    if m == 0:
        return _all_valid(col)
    b = byte_matrix(col.data)
    if m > b.shape[1]:
        return torch.zeros(col.capacity, dtype=torch.bool,
                           device=col.data.device)
    ln = _lengths_of(b)
    # each row's window [ln - m, ln)
    pos = ln[:, None] - m + torch.arange(m, dtype=torch.int32,
                                         device=b.device)[None, :]
    safe = torch.clamp(pos, 0, b.shape[1] - 1).to(torch.int64)
    window = torch.gather(b, 1, safe)
    mask = (window == _pat_tensor(pat, b.device)[None, :]).all(dim=1) \
        & (ln >= m)
    return _and_valid(col, mask)


def _windows(b: torch.Tensor, patb: np.ndarray,
             ln: torch.Tensor) -> torch.Tensor:
    """[cap, width-m+1] bool: the pattern at every start offset; starts
    whose window would run past the row's length are False."""
    m = len(patb)
    nwin = b.shape[1] - m + 1
    acc = torch.ones((b.shape[0], nwin), dtype=torch.bool, device=b.device)
    for j in range(m):
        acc &= b[:, j:j + nwin] == int(patb[j])   # in place: a fresh mask
    starts = torch.arange(nwin, dtype=torch.int32, device=b.device)
    return acc & (starts[None, :] <= (ln[:, None] - m))


def contains(col: Column, pat: str) -> torch.Tensor:
    """Literal substring search."""
    patb = _pat_bytes(pat)
    if len(patb) == 0:
        return _all_valid(col)
    b = byte_matrix(col.data)
    if len(patb) > b.shape[1]:
        return torch.zeros(col.capacity, dtype=torch.bool,
                           device=col.data.device)
    return _and_valid(col, _windows(b, patb, _lengths_of(b)).any(dim=1))


def contains_seq(col: Column, first: str, second: str) -> torch.Tensor:
    """SQL ``LIKE '%first%second%'``: ``second`` occurs after the first
    occurrence of ``first``."""
    p1, p2 = _pat_bytes(first), _pat_bytes(second)
    if len(p1) == 0:
        return contains(col, second)
    if len(p2) == 0:
        return contains(col, first)
    b = byte_matrix(col.data)
    if len(p1) + len(p2) > b.shape[1]:
        return torch.zeros(col.capacity, dtype=torch.bool,
                           device=col.data.device)
    ln = _lengths_of(b)
    m1 = _windows(b, p1, ln)
    m2 = _windows(b, p2, ln)
    has1 = m1.any(dim=1)
    first_pos = torch.argmax(m1.to(torch.int32), dim=1)   # first start
    thresh = first_pos + len(p1)
    starts2 = torch.arange(m2.shape[1], device=b.device)[None, :]
    ok2 = (m2 & (starts2 >= thresh[:, None])).any(dim=1)
    return _and_valid(col, has1 & ok2)


def cmp_scalar(col: Column, value: str):
    """(lt, eq) masks of rows against a scalar, by unsigned big-endian
    word order (= bytewise string order). A value longer than the column
    width compares by its truncated prefix, then ranks greater on
    equality."""
    nw = col.data.shape[1]
    b = str(value).encode("utf-8")
    truncated = len(b) > nw * WORD
    sw = np.frombuffer((b + b"\x00" * (nw * WORD))[:nw * WORD],
                       ">u4").astype(np.uint32)
    dev = col.data.device
    lt = torch.zeros(col.capacity, dtype=torch.bool, device=dev)
    eq = torch.ones(col.capacity, dtype=torch.bool, device=dev)
    for i in range(nw):
        w = col.data[:, i].to(torch.int64) & _M32
        s = int(sw[i])
        lt = lt | (eq & (w < s))
        eq = eq & (w == s)
    if truncated:   # rows equal to the prefix are below the longer value
        lt = lt | eq
        eq = torch.zeros_like(eq)
    return lt, eq


def isin(col: Column, values) -> torch.Tensor:
    """[cap] bool: rows whose value is among ``values``; a null-ish probe
    value (pandas ``isin([None])``) matches the null rows."""
    has_null = any(is_nullish(v) for v in values)
    dev = col.data.device
    mask = torch.zeros(col.capacity, dtype=torch.bool, device=dev)
    nw = col.data.shape[1]
    rows = []
    for v in values:
        if not isinstance(v, str):
            continue
        try:
            rows.append(encode_scalar(v, nw))
        except InvalidArgument:
            pass   # longer than any stored value: no match possible
    if rows:
        probe = _device_words(np.stack(rows), dev)   # [k, nw]
        mask = (col.data[:, None, :] == probe[None, :, :]).all(-1).any(1)
        mask = _and_valid(col, mask)
    if has_null and col.validity is not None:
        mask = mask | ~col.validity
    return mask


def replace_where(col: Column, keep: torch.Tensor, value: str,
                  validity) -> Column:
    """Rows where ``keep`` is False take ``value`` (widening the column
    where the value is longer). Shared by fillna and ``where``."""
    b = str(value).encode("utf-8")
    nw = max(col.data.shape[1], width_words(len(b)))
    data = pad_words(col.data, nw)
    sw = _device_words(encode_scalar(value, nw), data.device)
    data = torch.where(keep[:, None], data, sw[None, :])
    return Column(data, validity, dtypes.string_bytes(nw * WORD), None)


def fill_value(col: Column, value: str) -> Column:
    """fillna: null rows take ``value``."""
    if col.validity is None:
        return col
    return replace_where(col, col.validity, value, None)


def _all_valid(col: Column) -> torch.Tensor:
    if col.validity is None:
        return torch.ones(col.capacity, dtype=torch.bool,
                          device=col.data.device)
    return col.validity


def _and_valid(col: Column, mask: torch.Tensor) -> torch.Tensor:
    return mask & col.validity if col.validity is not None else mask


def is_nullish(v) -> bool:
    """None / NaN / pd.NA / NaT: the scalars pandas ``isin`` treats as
    matching null rows."""
    if v is None:
        return True
    if isinstance(v, float):
        return v != v
    if isinstance(v, (str, bytes, int, bool)):
        return False
    import pandas as pd

    r = pd.isna(v)
    return bool(r) if isinstance(r, (bool, np.bool_)) else False


# --------------------------------------------------------------- auto policy
def choose_storage(arr: np.ndarray, sample: int = 8192,
                   card_threshold: float = 0.5) -> str:
    """The ingest policy of ``string_storage="auto"``: a column whose
    sampled distinct-value ratio exceeds ``card_threshold`` takes device
    bytes (its dictionary would grow with the data), else dictionary
    codes. The sample is STRIDED across the whole column, so a column
    sorted or clustered by value is not under-counted. An embedded NUL
    in the sample forces ``"dict"``."""
    import pandas as pd

    n = len(arr)
    if n == 0:
        return "dict"
    take = arr[:: max(1, -(-n // sample))] if n > sample else arr
    try:
        uniq = pd.unique(take[~np.asarray(pd.isna(take))])
    except TypeError:   # unhashable values: dictionary
        return "dict"
    ratio = len(uniq) / max(len(take), 1)
    if ratio <= card_threshold:
        return "dict"
    try:
        sb = np.char.encode(np.where(pd.isna(take), "", take).astype(str),
                            "utf-8")
        w = sb.dtype.itemsize or 1
        flat = np.frombuffer(sb.astype(f"S{w}").tobytes(),
                             np.uint8).reshape(len(sb), w)
        if _embedded_nul(flat).any():
            return "dict"
    except (TypeError, ValueError):   # not encodable: dictionary
        return "dict"
    return "bytes"
