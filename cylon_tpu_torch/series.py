"""Series: one named device column with elementwise compute.

Port of ``cylon_tpu/series.py`` (parity: ``python/pycylon/series.py``
and the single-column part of ``compute.pyx``: comparisons and math
:455-700, ``is_in`` :702, ``drop_na`` :728). Elementwise math runs on
the padded tensor with the JAX package's result types and values
(:mod:`cylon_tpu_torch.ops.elementwise`); validity propagates as Arrow's
validity bitmaps do.

A Series taken from a distributed frame wraps this rank's shard of the
column (``env`` set): its elementwise ops stay shard-local; ``len``,
reductions, ``dropna`` and host maps on it raise.
"""

import re
import threading
from typing import Callable

import numpy as np
import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch import dtypes, plan
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, TypeError_
from cylon_tpu_torch.ops import elementwise as ew

#: ``torch.set_default_dtype`` is process-wide: one map at a time holds it
_DEFAULT_DTYPE_LOCK = threading.Lock()


def map_device(fn: Callable, data: torch.Tensor) -> torch.Tensor:
    """``fn`` mapped over ``data`` with ``torch.func.vmap``, with Python
    floats taken as float64 as JAX's x64 mode takes them (``x * 1.5`` on
    int64 is float64). Raises what ``fn`` raises when it cannot be
    vmapped; the callers then map it on the host."""
    with _DEFAULT_DTYPE_LOCK:
        old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            out = torch.func.vmap(fn)(data)
        finally:
            torch.set_default_dtype(old)
    if not torch.is_tensor(out) or out.shape[:1] != data.shape[:1]:
        raise TypeError_("map: the function gives no value a row")
    return out


class Series:
    """One named column + valid-row count (parity: pycylon ``Series``)."""

    def __init__(self, data=None, name: str = "",
                 capacity: "int | None" = None, nrows=None, device=None):
        self._env = None
        if isinstance(data, Series):
            self._col, self._nrows = data._col, data._nrows
            self._env = data._env
            self.name = name or data.name
            return
        if isinstance(data, Column):
            # a bare Column carries no row count: pass nrows when its
            # capacity holds padding
            self._col = data
            self._nrows = torch.tensor(
                data.capacity if nrows is None else int(nrows),
                dtype=torch.int32, device=data.device)
        else:
            arr = np.asarray(data)
            dev = _device.resolve(device)
            self._col = Column.from_numpy(arr, capacity, device=dev)
            self._nrows = torch.tensor(len(arr), dtype=torch.int32,
                                       device=dev)
        self.name = name

    @staticmethod
    def _wrap(col: Column, nrows, name: str = "", env=None) -> "Series":
        s = object.__new__(Series)
        s._col, s._nrows, s.name, s._env = col, nrows, name, env
        return s

    def _like(self, col: Column) -> "Series":
        return Series._wrap(col, self._nrows, self.name, self._env)

    # -- accessors -------------------------------------------------------
    @property
    def column(self) -> Column:
        return self._col

    @property
    def dtype(self) -> dtypes.DType:
        return self._col.dtype

    @property
    def nrows(self):
        return self._nrows

    @property
    def is_distributed(self) -> bool:
        return self._env is not None

    def _require_local(self, what: str):
        if self._env is not None:
            raise InvalidArgument(
                f"{what} on a distributed Series; use the DataFrame "
                "reductions with env= (dist_aggregate) or gather the "
                "frame first")

    def __len__(self):
        self._require_local("len()")
        return int(self._nrows)

    @property
    def shape(self):
        return (len(self),)

    @property
    def values(self) -> np.ndarray:
        return self.to_numpy()

    def to_numpy(self) -> np.ndarray:
        return self._col.to_numpy(len(self))

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self.to_numpy(), name=self.name or None)

    def __repr__(self):
        return f"Series(name={self.name!r}, {self.to_numpy()!r})"

    # -- elementwise engine ---------------------------------------------
    def _operand(self, other):
        if isinstance(other, Series):
            return other._col.data, other._col.validity
        if isinstance(other, Column):
            return other.data, other.validity
        return other, None

    def _binop(self, other, op: str, reverse: bool = False,
               out_kind=None) -> "Series":
        c = self._col
        if c.dtype.is_dictionary or c.dtype.is_bytes:
            raise TypeError_("math on string series requires codes/decode")
        o, ov = self._operand(other)
        data = ew.binary(op, c.data, o, reverse)
        validity = c.validity
        if ov is not None:
            validity = ov if validity is None else (validity & ov)
        dt = dtypes.from_torch_dtype(data.dtype) \
            if out_kind is None else out_kind
        return self._like(Column(data, validity, dt))

    def _unop(self, op: str, out_kind=None) -> "Series":
        c = self._col
        if c.dtype.is_dictionary or c.dtype.is_bytes:
            raise TypeError_("math on string series requires codes/decode")
        data = ew.unary(op, c.data)
        dt = dtypes.from_torch_dtype(data.dtype) \
            if out_kind is None else out_kind
        return self._like(Column(data, c.validity, dt))

    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._binop(o, "add", True)
    def __sub__(self, o): return self._binop(o, "subtract")
    def __rsub__(self, o): return self._binop(o, "subtract", True)
    def __mul__(self, o): return self._binop(o, "multiply")
    def __rmul__(self, o): return self._binop(o, "multiply", True)
    def __truediv__(self, o): return self._binop(o, "true_divide")
    def __rtruediv__(self, o): return self._binop(o, "true_divide", True)
    def __floordiv__(self, o): return self._binop(o, "floor_divide")
    def __rfloordiv__(self, o): return self._binop(o, "floor_divide", True)
    def __mod__(self, o): return self._binop(o, "mod")
    def __pow__(self, o): return self._binop(o, "power")
    def __neg__(self): return self._unop("negative")
    def __abs__(self): return self._unop("abs")

    def _cmp_op(self, o, name: str) -> "Series":
        """Comparison dispatch: device-bytes columns compare by
        big-endian word order (bytewise string order); everything else
        goes through the elementwise engine."""
        c = self._col
        if c.dtype.is_bytes and isinstance(o, str):
            from cylon_tpu_torch.ops import bytescol

            lt, eq = bytescol.cmp_scalar(c, o)
            m = {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
                 "gt": ~(lt | eq), "ge": ~lt}[name]
            if c.validity is not None:
                # pandas: null != x is True, every other comparison False
                m = (m | ~c.validity) if name == "ne" else (m & c.validity)
            return self._like(Column(m, None, dtypes.bool_))
        if c.dtype.is_bytes and isinstance(o, (Series, Column)) \
                and name in ("eq", "ne"):
            from cylon_tpu_torch.ops import bytescol

            oc = o._col if isinstance(o, Series) else o
            if oc.dtype.is_bytes or oc.dtype.is_dictionary:
                ca, cb = bytescol.align_storages([c, oc])
                m = (ca.data == cb.data).all(dim=1)
                for v in (ca.validity, cb.validity):
                    if v is not None:
                        m = m & v
                if name == "ne":
                    m = ~m
                return self._like(Column(m, None, dtypes.bool_))
        return self._binop(o, _CMP[name], out_kind=dtypes.bool_)

    def __eq__(self, o): return self._cmp_op(o, "eq")
    def __ne__(self, o): return self._cmp_op(o, "ne")
    def __lt__(self, o): return self._cmp_op(o, "lt")
    def __le__(self, o): return self._cmp_op(o, "le")
    def __gt__(self, o): return self._cmp_op(o, "gt")
    def __ge__(self, o): return self._cmp_op(o, "ge")

    def __and__(self, o):
        return self._binop(o, "logical_and", out_kind=dtypes.bool_)

    def __or__(self, o):
        return self._binop(o, "logical_or", out_kind=dtypes.bool_)

    def __xor__(self, o):
        return self._binop(o, "logical_xor", out_kind=dtypes.bool_)

    def __invert__(self):
        return self._unop("logical_not", dtypes.bool_)

    def __hash__(self):  # __eq__ is elementwise; identity hashing
        return id(self)

    # -- null handling ---------------------------------------------------
    def null_flags(self) -> torch.Tensor:
        """[capacity] bool, True where missing (validity or float NaN)."""
        from cylon_tpu_torch.ops.selection import _null_flags

        f = _null_flags(self._col)
        return torch.zeros(self._col.capacity, dtype=torch.bool,
                           device=self._col.device) if f is None \
            else f.to(torch.bool)

    def isnull(self) -> "Series":
        return self._like(Column(self.null_flags(), None, dtypes.bool_))

    isna = isnull

    def notnull(self) -> "Series":
        return self._like(Column(~self.null_flags(), None, dtypes.bool_))

    notna = notnull

    def fillna(self, value) -> "Series":
        return self._like(fill_column(self._col, value))

    def dropna(self) -> "Series":
        from cylon_tpu_torch.ops import kernels

        self._require_local("dropna()")
        perm, count = kernels.compact_mask(~self.null_flags(), self._nrows)
        c = self._col
        safe = torch.clamp(perm, 0, max(c.capacity - 1, 0))
        col = Column(c.data[safe],
                     None if c.validity is None else c.validity[safe],
                     c.dtype, c.dictionary)
        return Series._wrap(col, count, self.name)

    # -- membership / map ------------------------------------------------
    def isin(self, values) -> "Series":
        """Parity: ``compute.pyx`` is_in (:702). A null-ish probe (None,
        NaN) matches null rows, as pandas ``isin([None])``; a probe of an
        incompatible type never matches but leaves the rest of the list
        in force."""
        from cylon_tpu_torch.ops.bytescol import is_nullish

        c = self._col
        vset = list(values)
        dev = c.device
        if c.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            return self._like(Column(bytescol.isin(c, vset), None,
                                     dtypes.bool_))
        has_null = any(is_nullish(v) for v in vset)
        vals = [v for v in vset if not is_nullish(v)]
        pdt = dtypes.numpy_dtype(c.data.dtype)
        probe = []
        if c.dtype.is_dictionary:
            dvals = [] if c.dictionary is None else c.dictionary.values
            lut = {v: i for i, v in enumerate(dvals)}
            probe = [lut[v] for v in vals if v in lut]
        elif c.dtype.kind in (dtypes.Kind.TIMESTAMP, dtypes.Kind.DURATION,
                              dtypes.Kind.DATE32, dtypes.Kind.DATE64):
            # temporal columns hold unit-scaled ints: probes go through
            # numpy's temporal types at the column's unit
            unit = c.dtype.unit or (
                "D" if c.dtype.kind == dtypes.Kind.DATE32 else "ms")
            cast = np.timedelta64 if c.dtype.kind == dtypes.Kind.DURATION \
                else np.datetime64
            for v in vals:
                if isinstance(v, (int, float, bool)):
                    continue  # pandas: a bare number never matches a date
                try:
                    probe.append(np.asarray(
                        cast(v, unit).astype(np.int64), pdt)[()])
                except (TypeError, ValueError):
                    continue
        else:
            for v in vals:
                try:
                    cv = np.asarray(v, pdt)[()]
                except (TypeError, ValueError, OverflowError):
                    continue
                if cv == v:  # 1.5 must not match int 1 by truncation
                    probe.append(cv)
        if probe:
            p = plan.staged(np.asarray(probe, pdt), dev)
            mask = (c.data[:, None] == p[None, :]).any(dim=1)
        else:
            mask = torch.zeros(c.capacity, dtype=torch.bool, device=dev)
        if c.validity is not None:
            mask = mask & c.validity
            if has_null:
                mask = mask | ~c.validity
        elif has_null and c.data.is_floating_point():
            # floats without validity carry nulls as NaN
            mask = mask | torch.isnan(c.data)
        return self._like(Column(mask, None, dtypes.bool_))

    def _dict_pred(self, pred: Callable) -> "Series":
        """Mask from a host predicate over a dictionary column's values,
        evaluated once a distinct value; the rows go through ``isin``
        over the matching codes."""
        c = self._col
        if not c.dtype.is_dictionary:
            raise TypeError_("string predicate on non-string column")
        vals = [] if c.dictionary is None else list(c.dictionary.values)
        return self.isin([v for v in vals if pred(v)])

    def _bytes_pred(self, mask) -> "Series":
        return self._like(Column(mask, None, dtypes.bool_))

    @property
    def str(self) -> "_StrAccessor":
        """pandas-style string accessor over both storages: device-bytes
        columns run byte windows on the device, dictionary columns
        evaluate once a distinct value on the host."""
        return _StrAccessor(self)

    def str_startswith(self, prefix: str) -> "Series":
        if self._col.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            return self._bytes_pred(bytescol.startswith(self._col, prefix))
        return self._dict_pred(lambda v: v is not None
                               and str(v).startswith(prefix))

    def str_endswith(self, suffix: str) -> "Series":
        if self._col.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            return self._bytes_pred(bytescol.endswith(self._col, suffix))
        return self._dict_pred(lambda v: v is not None
                               and str(v).endswith(suffix))

    def str_contains(self, pat: str, regex: bool = True) -> "Series":
        """Rows whose value contains ``pat``, a regex by default as in
        pandas. On device bytes a literal pattern (or a regex without
        metacharacters) runs the window compare on the device; a true
        regex decodes to the host."""
        if self._col.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            if not regex or not re.search(r"[.^$*+?{}\[\]\\|()]", pat):
                return self._bytes_pred(bytescol.contains(self._col, pat))
            rx = re.compile(pat)
            self._require_local("str_contains(regex) on device bytes")
            hits = np.array([v is not None and rx.search(str(v)) is not None
                             for v in self.to_numpy()], bool)
            mask = torch.zeros(self._col.capacity, dtype=torch.bool,
                               device=self._col.device)
            mask[:len(hits)] = _device.from_host(hits, mask.device)
            return self._bytes_pred(mask)
        if regex:
            rx = re.compile(pat)
            return self._dict_pred(lambda v: v is not None
                                   and rx.search(str(v)) is not None)
        return self._dict_pred(lambda v: v is not None and pat in str(v))

    def map(self, fn: Callable) -> "Series":
        """Elementwise map (parity: ``compute.pyx`` infer_map :805). A
        function that ``torch.func.vmap`` can trace runs on the device
        (:func:`map_device`); any other runs on the host a row at a
        time, as the JAX package falls back from ``jax.vmap``."""
        c = self._col
        if c.dtype.is_bytes:
            self._require_local("map() on device bytes")
            host = np.array([fn(v) for v in self.to_numpy()], object)
            storage = "bytes" if all(isinstance(v, str) or v is None
                                     for v in host) else "dict"
            return self._like(Column.from_numpy(
                host, c.capacity, device=c.device, string_storage=storage))
        if c.dtype.is_dictionary:
            from cylon_tpu_torch.ops.dictenc import reencode_values

            return self._like(reencode_values(
                c, [fn(v) for v in c.dictionary.values]))
        try:
            data = map_device(fn, c.data)
            dt = dtypes.from_torch_dtype(data.dtype)
            return self._like(Column(data, c.validity, dt))
        except Exception:   # noqa: BLE001 -- any trace failure: host loop
            self._require_local("map() of a host function")
            host = np.array([fn(v) for v in self.to_numpy()])
            return Series(host, self.name, device=c.device)

    applymap = map

    # -- reductions ------------------------------------------------------
    def _reduce(self, op: str):
        from cylon_tpu_torch.ops import aggregates
        from cylon_tpu_torch.table import Table

        self._require_local(f"{op}()")
        name = self.name or "x"
        res = aggregates.table_aggregate(Table({name: self._col},
                                               self._nrows), name, op)
        return res.cpu().numpy()[()]

    def sum(self): return self._reduce("sum")
    def count(self): return self._reduce("count")
    def min(self): return self._reduce("min")
    def max(self): return self._reduce("max")
    def mean(self): return self._reduce("mean")
    def var(self): return self._reduce("var")
    def std(self): return self._reduce("std")
    def nunique(self): return self._reduce("nunique")

    def unique(self) -> np.ndarray:
        """Distinct values in first-seen order, on the host (parity:
        ``table.pyx`` unique on one column)."""
        vals = self.to_numpy()
        seen, out = set(), []
        for v in vals:
            k = v if v == v else None  # NaN folds
            if k not in seen:
                seen.add(k)
                out.append(v)
        return np.asarray(out, dtype=vals.dtype)


_CMP = {"eq": "equal", "ne": "not_equal", "lt": "less", "le": "less_equal",
        "gt": "greater", "ge": "greater_equal"}


def fill_column(c: Column, value) -> Column:
    """``c`` with its missing values (nulls, and NaN in a float column)
    replaced by ``value``; shared by ``Series.fillna`` and
    ``DataFrame.fillna``."""
    if c.dtype.is_bytes:
        from cylon_tpu_torch.ops import bytescol

        return bytescol.fill_value(c, value)
    if c.dtype.is_dictionary:
        from cylon_tpu_torch.ops.dictenc import encode_fill_value

        if c.validity is None:
            return c
        c2, code = encode_fill_value(c, value)
        data = torch.where(c2.validity, c2.data,
                           _device.scalar(code, c2.data.dtype,
                                          c2.data.device))
        return Column(data, None, c2.dtype, c2.dictionary)
    data = c.data
    fill = _device.scalar(value, data.dtype, data.device)
    if data.is_floating_point():
        data = torch.where(torch.isnan(data), fill, data)
    if c.validity is not None:
        data = torch.where(c.validity, data, fill)
    return Column(data, None, c.dtype, c.dictionary)


class _StrAccessor:
    """``Series.str``: the pandas string-method namespace
    (``cylon_tpu/series.py:460``), dispatching on the column's storage."""

    def __init__(self, s: Series):
        self._s = s

    def startswith(self, prefix: str) -> Series:
        return self._s.str_startswith(prefix)

    def endswith(self, suffix: str) -> Series:
        return self._s.str_endswith(suffix)

    def contains(self, pat: str, regex: bool = True) -> Series:
        return self._s.str_contains(pat, regex=regex)

    def len(self) -> Series:
        """Length in characters for both storages (pandas semantics): a
        UTF-8 start-byte count on the device for bytes columns, a host
        map over distinct values for dictionary columns."""
        s = self._s
        c = s.column
        if c.dtype.is_bytes:
            from cylon_tpu_torch.ops import bytescol

            return s._like(Column(bytescol.char_lengths(c.data), c.validity,
                                  dtypes.int32))
        if c.dtype.is_dictionary:
            vals = [] if c.dictionary is None \
                else [len(str(v)) for v in c.dictionary.values]
            lut = _device.from_host(np.asarray(vals or [0], np.int32),
                                    c.device)
            data = lut[torch.clamp(c.data, 0, max(len(vals) - 1, 0))
                       .to(torch.int64)]
            return s._like(Column(data, c.validity, dtypes.int32))
        raise TypeError_("str.len() on non-string column")

    def _ascii_case(self, upper: bool) -> Series:
        s = self._s
        c = s.column
        if c.dtype.is_bytes:
            # flip bit 5 of the ASCII letters of the other case inside each
            # big-endian word; bytes >= 0x80 (UTF-8 payload) pass through
            lo, hi = (0x61, 0x7A) if upper else (0x41, 0x5A)
            words = c.data.to(torch.int64) & 0xFFFFFFFF
            out = torch.zeros_like(words)
            for shift in (24, 16, 8, 0):
                b = (words >> shift) & 0xFF
                b = torch.where((b >= lo) & (b <= hi), b ^ 0x20, b)
                out = out | (b << shift)
            data = torch.where(out >= 1 << 31, out - (1 << 32), out)
            return s._like(Column(data.to(torch.int32), c.validity,
                                  c.dtype))
        if c.dtype.is_dictionary:
            from cylon_tpu_torch.ops.dictenc import reencode_values

            fn = str.upper if upper else str.lower
            vals = [None if v is None else fn(str(v))
                    for v in (c.dictionary.values
                              if c.dictionary is not None else [])]
            return s._like(reencode_values(c, vals))
        raise TypeError_("str case transform on non-string column")

    def upper(self) -> Series:
        """ASCII upper case (on the device for bytes columns; other
        characters pass through)."""
        return self._ascii_case(True)

    def lower(self) -> Series:
        return self._ascii_case(False)
