"""Pandas-like DataFrame facade.

Port of ``cylon_tpu/frame.py`` (parity: ``python/pycylon/frame.py``:
``DataFrame`` :183 with ``merge`` :1516, ``join`` :1387, ``groupby``
:1813, ``sort_values`` :1272, ``drop_duplicates`` :1743, ``concat``
:1956, the math and compare dunders, ``isin`` / ``fillna`` / ``isnull``
/ ``rename`` / ``set_index``). Ops take ``env=None`` to run locally or
``env=CylonEnv`` to run distributed (``frame.py:1728-1743``).

The JAX frame is single-controller: it tells a distributed table by its
vector row count on a mesh. The port is SPMD like the reference: every
rank runs the same program, and a distributed frame holds this rank's
shard and the env it is sharded over. ``DataFrame(data, env=env)``
keeps this rank's contiguous block of ``data`` (every rank passes the
same data), and every ``env=`` op returns a frame sharded over its env.
A local frame given to an ``env=`` op is taken as the same whole table
on every rank and scattered first.

**Collectives.** On a distributed frame these methods gather or reduce
over the world, so every rank must call them, in the same order:
``len``, ``shape``, ``index``, ``to_pandas``, ``to_dict``,
``to_numpy``, ``to_arrow``, ``repr``, ``equals``, ``head``,
``set_index``, ``reset_index``, ``loc`` / ``iloc``, ``dropna``,
``where`` / ``mask``, ``applymap``, ``__setitem__`` (it gathers the
frame, which then stays local), the reductions (``sum`` ...) and every
local op (``env=None``) on it, which gathers first; and every ``env=``
op. Elementwise ops, column selection, ``filter`` on the frame's own
shard, ``isnull`` / ``fillna`` / ``isin`` and renames stay shard-local.
"""

from typing import Mapping, Sequence

import numpy as np
import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch import dtypes, plan
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.config import CSVReadOptions
from cylon_tpu_torch.errors import InvalidArgument, KeyError_
from cylon_tpu_torch.ops import aggregates as _aggregates
from cylon_tpu_torch.ops import elementwise as _ew
from cylon_tpu_torch.ops import groupby as _groupby_mod
from cylon_tpu_torch.ops import selection as _selection
from cylon_tpu_torch.ops import setops as _setops
from cylon_tpu_torch.ops.join import join as _join
from cylon_tpu_torch.parallel import dist_ops
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, dist_to_pandas,
                                             gather_table, scatter_table,
                                             shard_sizes)
from cylon_tpu_torch.series import Series, fill_column, map_device
from cylon_tpu_torch.table import Table

#: True turns the shrink after selective ops off (the JAX package reads
#: ``CYLON_TPU_NO_SHRINK``; the port keeps a module value, which tests
#: monkeypatch)
_NO_SHRINK = False


def _shrink(t: Table) -> Table:
    """Capacity shrink-to-fit after a selective local op
    (:meth:`Table.shrink_to_fit`: one host read of the row count); a
    no-op when :data:`_NO_SHRINK` is set. In capture mode
    (:func:`~cylon_tpu_torch.plan.settle`) the count is not read: the
    table is cut to its graph warm-up's capacity, its overflow past it
    registered, or, outside a graph, keeps the op's bound, as under a JAX
    trace. Distributed results keep their layout."""
    if _NO_SHRINK:
        return t

    def eager():
        s = t.shrink_to_fit()
        return s, s.capacity

    def fixed(cap):
        if cap is None or cap >= t.capacity:
            return t
        plan.note_overflow(t.nrows > cap)
        return t.with_capacity(cap)

    return plan.settle(("shrink", t.capacity), eager, fixed)


class DataFrame:
    """Columnar dataframe on the device (parity: pycylon ``DataFrame``).
    ``device=None`` builds on CUDA; pass ``device="cpu"`` for the CPU."""

    def __init__(self, data=None, env=None, capacity: "int | None" = None,
                 string_storage="dict", device=None):
        index, self._env = None, None
        if isinstance(data, DataFrame):
            table, index, self._env = data._table, data._index, data._env
        elif isinstance(data, Table):
            table = data
        elif data is None:
            dev = _device.resolve(device)
            table = Table({}, torch.zeros((), dtype=torch.int32, device=dev))
        elif isinstance(data, Mapping):
            table = Table.from_pydict(data, capacity, device, string_storage)
        else:
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                table = Table.from_pandas(data, capacity, device,
                                          string_storage)
            elif isinstance(data, np.ndarray):
                names = [f"c{i}" for i in range(data.shape[1])]
                table = Table.from_numpy(names, list(data.T), capacity,
                                         device)
            elif type(data).__module__.startswith("pyarrow"):
                table = Table.from_arrow(data, capacity, device,
                                         string_storage)
            else:
                raise InvalidArgument(
                    f"cannot build DataFrame from {type(data)}")
        if env is not None and self._env is None:
            table = scatter_table(env, table)
            self._env = env
        self._table = table
        self._index = index

    # -- construction helpers -------------------------------------------
    @staticmethod
    def _wrap(table: Table, index=None, env=None) -> "DataFrame":
        df = object.__new__(DataFrame)
        df._table, df._index, df._env = table, index, env
        return df

    # -- schema / introspection -----------------------------------------
    @property
    def table(self) -> Table:
        """This rank's table: the whole frame when local, its shard when
        distributed."""
        return self._table

    @property
    def env(self):
        """The env the frame is sharded over (None when local)."""
        return self._env

    @property
    def columns(self) -> list:
        return self._table.column_names

    @property
    def shape(self):
        return (len(self), self._table.num_columns)

    @property
    def dtypes(self) -> dict:
        return {n: c.dtype for n, c in self._table.columns.items()}

    @property
    def device(self) -> torch.device:
        return self._table.device

    @property
    def is_distributed(self) -> bool:
        return self._env is not None

    def __len__(self):
        if self.is_distributed:
            return dist_num_rows(self._env, self._table)
        return self._table.num_rows

    # -- layout ----------------------------------------------------------
    def _gathered(self) -> Table:
        """The whole table on this rank (a gather when distributed)."""
        if self.is_distributed:
            return gather_table(self._env, self._table)
        return self._table

    def _materialized(self) -> "DataFrame":
        """The local (gathered) frame; the index, always built on the
        local layout, rides along."""
        if self.is_distributed:
            return DataFrame._wrap(self._gathered(), self._index)
        return self

    def _sharded(self, env) -> Table:
        """This rank's shard for an ``env=`` op: the frame's own shard, or
        the block of a local frame (the same whole table on every rank)."""
        if self.is_distributed:
            return self._table
        return scatter_table(env, self._table)

    # -- indexing (parity: indexing/ + table.hpp:183 SetArrowIndex) ------
    @property
    def index(self):
        from cylon_tpu_torch.indexing import RangeIndex

        if self._index is None:
            return RangeIndex(len(self), device=self.device)
        return self._index

    def set_index(self, key: str, indexing_type=None,
                  drop: bool = True) -> "DataFrame":
        """A value index on ``key`` (parity: pycylon
        ``DataFrame.set_index``; ``indexing_type`` as ``IndexingType``,
        default HASH), built on the local frame."""
        from cylon_tpu_torch.indexing import IndexingType, build_index

        if indexing_type is None:
            indexing_type = IndexingType.HASH
        t = self._materialized().table
        idx = build_index(t.column(key), t.nrows, indexing_type, name=key)
        if drop:
            t = t.drop([key])
        return DataFrame._wrap(t, index=idx)

    def reset_index(self, drop: bool = False) -> "DataFrame":
        """Drop the value index, putting it back as the leading column
        unless ``drop`` (pandas: a RangeIndex becomes an ``index`` column
        of positions; a name collision raises)."""
        df = self._materialized()
        t, idx = df.table, df._index
        if not drop:
            vc = idx.values_column() if idx is not None else None
            if vc is None:
                name = "index"
                vc = Column(torch.arange(t.capacity, dtype=torch.int64,
                                         device=t.device), None,
                            dtypes.int64)
            else:
                name = idx.name or "index"
            if name in t:
                raise InvalidArgument(f"cannot insert {name}, already exists")
            cols = {name: vc}
            cols.update(t.columns)
            t = Table(cols, t.nrows)
        return DataFrame._wrap(t)

    @property
    def loc(self):
        from cylon_tpu_torch.indexing import LocIndexer

        return LocIndexer(self)

    @property
    def iloc(self):
        from cylon_tpu_torch.indexing import ILocIndexer

        return ILocIndexer(self)

    def __repr__(self):
        return f"DataFrame({self.to_pandas()!r})"

    # -- selection -------------------------------------------------------
    def __getitem__(self, key):
        # column selection keeps the rows, so the index rides along
        if isinstance(key, str):
            return self._like(self._table.select([key]), self._index)
        if isinstance(key, (list, tuple)):
            return self._like(self._table.select(list(key)), self._index)
        if isinstance(key, (DataFrame, Series, Column, torch.Tensor,
                            np.ndarray)):
            if self.is_distributed and not getattr(key, "is_distributed",
                                                   False):
                # only a mask built on the frame's shards has its layout
                raise InvalidArgument(
                    "boolean-mask selection on a distributed frame: use "
                    ".filter(mask) with a mask built on the frame "
                    "(shard-local, no gather)")
            return self.filter(key)
        raise KeyError_(
            f"bad key of type {type(key).__name__}; expected a column "
            f"name, list of names, or boolean mask "
            f"(columns: {list(self._table.column_names)!r})")

    def _like(self, table: Table, index=None) -> "DataFrame":
        """A frame of this one's layout (same env) over ``table``."""
        return DataFrame._wrap(table, index, self._env)

    def __setitem__(self, name, value):
        if isinstance(value, DataFrame) and value.is_distributed \
                and self.is_distributed \
                and value.table.capacity == self._table.capacity:
            # both sharded alike: the column joins its shard, no gather
            self._table = self._table.add_column(name,
                                                 value._single_column())
            return
        if self.is_distributed:
            # positional assignment is defined on the gathered layout
            self._table = self._gathered()
            self._env = None
        t = self._table
        if isinstance(value, DataFrame):
            col = value._materialized()._single_column()
        elif isinstance(value, Series):
            col = value.column
        elif isinstance(value, Column):
            col = value
        elif np.isscalar(value):
            np_dt = np.asarray(value).dtype
            col = Column(torch.full((t.capacity,), value,
                                    dtype=torch.from_numpy(
                                        np.zeros(0, np_dt)).dtype,
                                    device=t.device),
                         None, dtypes.from_numpy_dtype(np_dt))
        else:
            col = Column.from_numpy(np.asarray(value), t.capacity,
                                    device=t.device)
        self._table = t.add_column(name, col)

    def _single_column(self) -> Column:
        if self._table.num_columns != 1:
            raise InvalidArgument("expected a single-column frame")
        return next(iter(self._table.columns.values()))

    # -- relational ops (env dispatch, frame.py:1728) --------------------
    def merge(self, right: "DataFrame", how: str = "inner", on=None,
              left_on=None, right_on=None, suffixes=("_x", "_y"),
              env=None, out_capacity: "int | None" = None,
              algorithm: str = "sort") -> "DataFrame":
        """Parity: ``DataFrame.merge`` (frame.py:1516). With ``env``,
        ``dist_join`` over it. Locally, a defaulted capacity regrows as
        the JAX frame's does (:func:`cylon_tpu_torch.plan.regrow_eager`):
        an N:M join past ``left.capacity + right.capacity`` rows reruns at
        twice the scale; an explicit ``out_capacity`` keeps the
        raise-on-overflow contract."""
        if env is not None:
            t = dist_ops.dist_join(env, self._sharded(env),
                                   right._sharded(env), on=on,
                                   left_on=left_on, right_on=right_on,
                                   how=how, suffixes=suffixes,
                                   out_capacity=out_capacity,
                                   algorithm=algorithm)
            return DataFrame._wrap(t, env=env)
        lt, rt = self._gathered(), right._gathered()
        t = plan.regrow_eager(
            lambda: _join(lt, rt, on=on, left_on=left_on, right_on=right_on,
                          how=how, suffixes=suffixes,
                          out_capacity=out_capacity, algorithm=algorithm),
            bounded=out_capacity is not None)
        return DataFrame._wrap(_shrink(t))

    def join(self, right: "DataFrame", on=None, how: str = "left",
             lsuffix: str = "_l", rsuffix: str = "_r", env=None,
             **kw) -> "DataFrame":
        """Parity: ``DataFrame.join`` (frame.py:1387)."""
        return self.merge(right, how=how, on=on,
                          suffixes=(lsuffix, rsuffix), env=env, **kw)

    def groupby(self, by, env=None) -> "GroupByDataFrame":
        """Parity: ``DataFrame.groupby`` (frame.py:1813)."""
        by = [by] if isinstance(by, str) else list(by)
        return GroupByDataFrame(self, by, env)

    def sort_values(self, by, ascending=True, env=None,
                    **kw) -> "DataFrame":
        """Parity: ``DataFrame.sort_values`` (frame.py:1272); with ``env``
        the distributed sample sort (``dist_sort``; ``kw`` takes its
        ``options`` and ``out_capacity``)."""
        by = [by] if isinstance(by, str) else list(by)
        if env is not None:
            return DataFrame._wrap(dist_ops.dist_sort(
                env, self._sharded(env), by, ascending=ascending, **kw),
                env=env)
        return DataFrame._wrap(
            _selection.sort_table(self._gathered(), by, ascending=ascending))

    def drop_duplicates(self, subset=None, keep: str = "first", env=None,
                        out_capacity: "int | None" = None) -> "DataFrame":
        """Parity: ``DataFrame.drop_duplicates`` (frame.py:1743) /
        ``DistributedUnique`` (table.cpp:977)."""
        subset = [subset] if isinstance(subset, str) else subset
        if env is not None:
            return DataFrame._wrap(dist_ops.dist_unique(
                env, self._sharded(env), subset, out_capacity=out_capacity,
                keep=keep), env=env)
        return DataFrame._wrap(
            _shrink(_setops.unique(self._gathered(), subset, keep=keep)))

    def head(self, n: int = 5) -> "DataFrame":
        """The first ``n`` rows. On a distributed frame no row moves:
        ``dist_head`` changes the shards' counts (one all-gather)."""
        if self.is_distributed:
            return self._like(dist_ops.dist_head(self._env, self._table, n))
        return DataFrame._wrap(_selection.head(self._table, n))

    def filter(self, mask=None, env=None,
               items: "Sequence[str] | None" = None) -> "DataFrame":
        """Row filter or column selection.

        With ``items=`` (or a list of names) pandas ``DataFrame.filter``:
        columns by label. With a boolean tensor, array, Series or
        single-column frame: a row filter that keeps the layout; on a
        distributed frame each rank compacts its own shard (no gather;
        the mask is built on the shard). Null mask entries filter as
        False."""
        if items is not None:
            return self[list(items)]
        if isinstance(mask, (list, tuple)) and all(isinstance(x, str)
                                                   for x in mask):
            return self[list(mask)]
        if isinstance(mask, DataFrame):
            mask = mask._single_column()
        if isinstance(mask, Series):
            mask = mask.column
        t = self._table
        if isinstance(mask, Column):
            m = mask.data.to(torch.bool)
            mask = m if mask.validity is None else m & mask.validity
        if not torch.is_tensor(mask):
            host = np.asarray(mask, dtype=bool)
            mask = torch.zeros(t.capacity, dtype=torch.bool,
                               device=t.device)
            mask[:len(host)] = _device.from_host(host, t.device)
        if self.is_distributed:
            return self._like(dist_ops.dist_filter(env or self._env, t,
                                                   mask))
        return DataFrame._wrap(_shrink(_selection.filter_table(t, mask)))

    def sample_rows(self, n: int) -> "DataFrame":
        return DataFrame._wrap(_selection.sample(self._gathered(), n))

    def add_prefix(self, prefix: str) -> "DataFrame":
        return self._like(self._table.add_prefix(prefix), self._index)

    def add_suffix(self, suffix: str) -> "DataFrame":
        return self._like(self._table.add_suffix(suffix), self._index)

    def to_csv(self, path, **kw) -> None:
        """Parity: pycylon ``DataFrame.to_csv`` / ``WriteCSV``."""
        from cylon_tpu_torch.io import write_csv

        write_csv(self, path, **kw)

    def rename(self, columns: Mapping[str, str]) -> "DataFrame":
        return self._like(self._table.rename(columns), self._index)

    def drop(self, columns) -> "DataFrame":
        columns = [columns] if isinstance(columns, str) else list(columns)
        return self._like(self._table.drop(columns), self._index)

    def astype(self, mapping: "Mapping[str, dtypes.DType]") -> "DataFrame":
        t = self._table
        for name, dt in mapping.items():
            t = t.add_column(name, t.column(name).astype(dt))
        return self._like(t, self._index)

    # -- elementwise / predicates ----------------------------------------
    def _binop(self, other, op: str, reverse: bool = False) -> "DataFrame":
        t = self._table
        cols = {}
        for name, c in t.columns.items():
            o = other._table.column(name).data \
                if isinstance(other, DataFrame) else other
            data = _ew.binary(op, c.data, o, reverse)
            cols[name] = Column(data, c.validity,
                                dtypes.from_torch_dtype(data.dtype))
        return self._like(Table(cols, t.nrows))

    def _unop(self, op: str) -> "DataFrame":
        t = self._table
        cols = {}
        for name, c in t.columns.items():
            data = _ew.unary(op, c.data)
            cols[name] = Column(data, c.validity,
                                dtypes.from_torch_dtype(data.dtype))
        return self._like(Table(cols, t.nrows))

    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._binop(o, "add", True)
    def __sub__(self, o): return self._binop(o, "subtract")
    def __rsub__(self, o): return self._binop(o, "subtract", True)
    def __mul__(self, o): return self._binop(o, "multiply")
    def __rmul__(self, o): return self._binop(o, "multiply", True)
    def __truediv__(self, o): return self._binop(o, "true_divide")
    def __rtruediv__(self, o): return self._binop(o, "true_divide", True)
    def __floordiv__(self, o): return self._binop(o, "floor_divide")
    def __mod__(self, o): return self._binop(o, "mod")
    def __pow__(self, o): return self._binop(o, "power")
    def __neg__(self): return self._unop("negative")
    def __abs__(self): return self._unop("abs")
    # bitwise on ints, logical on bools (numpy / pandas semantics)
    def __invert__(self): return self._unop("invert")
    def __and__(self, o): return self._binop(o, "bitwise_and")
    def __or__(self, o): return self._binop(o, "bitwise_or")
    def __xor__(self, o): return self._binop(o, "bitwise_xor")
    def __eq__(self, o): return self._binop(o, "equal")
    def __ne__(self, o): return self._binop(o, "not_equal")
    def __lt__(self, o): return self._binop(o, "less")
    def __le__(self, o): return self._binop(o, "less_equal")
    def __gt__(self, o): return self._binop(o, "greater")
    def __ge__(self, o): return self._binop(o, "greater_equal")

    def __hash__(self):  # __eq__ is elementwise; identity hashing
        return id(self)

    def abs(self) -> "DataFrame":
        return self._unop("abs")

    def applymap(self, fn) -> "DataFrame":
        """Elementwise map over every column (parity: frame.py applymap /
        ``compute.pyx`` infer_map). A function ``torch.func.vmap`` can
        trace runs on the device with JAX's result type
        (:func:`~cylon_tpu_torch.series.map_device`); any other runs on
        the host a column at a time, as the JAX frame falls back from
        ``jnp.vectorize``. String columns map their values on the host."""
        from cylon_tpu_torch.ops.dictenc import reencode_values

        t = self._materialized().table
        cols = {}
        nrows = t.nrows
        host_cols = t._host_columns() \
            if any(c.dtype.is_bytes for c in t.columns.values()) else {}
        for name, c in t.columns.items():
            if c.dtype.is_bytes:
                host = np.array([fn(v) for v in host_cols[name]], object)
                st = "bytes" if all(isinstance(v, str) or v is None
                                    for v in host) else "dict"
                cols[name] = Column.from_numpy(host, t.capacity,
                                               device=t.device,
                                               string_storage=st)
                continue
            if c.dtype.is_dictionary:
                cols[name] = reencode_values(
                    c, [fn(v) for v in c.dictionary.values])
                continue
            try:
                data = map_device(fn, c.data)
                cols[name] = Column(data, c.validity,
                                dtypes.from_torch_dtype(data.dtype))
            except Exception:   # noqa: BLE001 -- any trace failure
                host = np.array([fn(v) for v in c.to_numpy(int(nrows))])
                cols[name] = Column.from_numpy(host, t.capacity,
                                               device=t.device)
        return DataFrame._wrap(Table(cols, nrows), self._index)

    map = applymap  # pandas 2.x name

    def series(self, name: str) -> Series:
        """One column as a :class:`~cylon_tpu_torch.series.Series`. On a
        distributed frame it wraps this rank's shard of the column:
        elementwise ops stay shard-local, reductions on it raise (use
        the frame's reductions with ``env=``)."""
        t = self._table
        return Series._wrap(t.column(name), t.nrows, name, self._env)

    def isnull(self) -> "DataFrame":
        """Parity: frame.py isnull."""
        t = self._table
        cols = {name: Column(self.series(name).null_flags(), None,
                             dtypes.bool_)
                for name in t.column_names}
        return self._like(Table(cols, t.nrows))

    def notnull(self) -> "DataFrame":
        return self.isnull()._binop(True, "not_equal")

    isna = isnull
    notna = notnull

    def fillna(self, value) -> "DataFrame":
        """Parity: frame.py fillna."""
        t = self._table
        return self._like(Table({n: fill_column(c, value)
                                 for n, c in t.columns.items()}, t.nrows))

    def dropna(self, axis: int = 0, how: str = "any",
               subset=None) -> "DataFrame":
        """Drop rows (axis=0) or columns (axis=1) with missing values
        (parity: ``compute.pyx`` drop_na :728)."""
        from cylon_tpu_torch.ops import kernels

        df = self._materialized()
        t = df.table
        names = ([subset] if isinstance(subset, str) else list(subset)
                 ) if subset is not None else t.column_names
        if not names:
            return df
        stack = torch.stack([df.series(n).null_flags() for n in names])
        if axis == 1:
            rm = t.row_mask()
            bad = [bool((f & rm).any()) if how == "any"
                   else bool((f | ~rm).all()) for f in stack]
            keep = {n for n, b in zip(names, bad) if not b}
            keep |= {n for n in t.column_names if n not in names}
            return DataFrame._wrap(
                t.select([n for n in t.column_names if n in keep]),
                df._index)
        null_row = stack.all(dim=0) if how == "all" else stack.any(dim=0)
        perm, count = kernels.compact_mask(~null_row, t.nrows)
        out = _selection.take_columns(t, perm, count)
        idx = df.index.take(perm, count) if df._index is not None else None
        return DataFrame._wrap(out, idx)

    def where(self, cond: "DataFrame", other=np.nan) -> "DataFrame":
        """Keep values where ``cond`` holds, else ``other`` (parity:
        frame.py where / mask). ``cond`` is a boolean frame of the same
        columns or one boolean column for every column; NaN (or None) as
        ``other`` makes non-float columns null."""
        import math

        nan_fill = other is None or (isinstance(other, float)
                                     and math.isnan(other))
        t = self._materialized().table
        cmat = cond._materialized() if isinstance(cond, DataFrame) else None
        cols = {}
        for name, c in t.columns.items():
            if cmat is not None:
                cc = cmat.table.column(name) if name in cmat.table \
                    else cmat._single_column()
                m = cc.data.to(torch.bool)
            else:
                m = torch.as_tensor(np.asarray(cond, bool), device=t.device)
            base = torch.ones(t.capacity, dtype=torch.bool,
                              device=t.device) if c.validity is None \
                else c.validity
            validity = None if c.validity is None else (base | ~m)
            if c.dtype.is_bytes:
                if nan_fill:
                    cols[name] = Column(c.data, base & m, c.dtype)
                else:
                    from cylon_tpu_torch.ops import bytescol

                    cols[name] = bytescol.replace_where(c, m, other,
                                                        validity)
            elif c.dtype.is_dictionary:
                if nan_fill:
                    cols[name] = Column(c.data, base & m, c.dtype,
                                        c.dictionary)
                else:
                    from cylon_tpu_torch.ops.dictenc import encode_fill_value

                    c2, code = encode_fill_value(c, other)
                    # cond False takes `other` even over a null
                    cols[name] = Column(
                        torch.where(m, c2.data, torch.full_like(c2.data,
                                                                code)),
                        validity, c2.dtype, c2.dictionary)
            elif not c.data.is_floating_point():
                if nan_fill:
                    # non-float columns take NaN as null (Arrow semantics)
                    cols[name] = Column(c.data, base & m, c.dtype)
                else:
                    fill = _device.scalar(other, c.data.dtype, t.device)
                    cols[name] = Column(torch.where(m, c.data, fill),
                                        validity, c.dtype)
            else:
                fill = _device.scalar(float("nan") if nan_fill else other,
                                      c.data.dtype, t.device)
                cols[name] = Column(torch.where(m, c.data, fill),
                                    c.validity if nan_fill else validity,
                                    c.dtype)
        return DataFrame._wrap(Table(cols, t.nrows), self._index)

    def mask(self, cond: "DataFrame", other=np.nan) -> "DataFrame":
        inv = ~cond if isinstance(cond, DataFrame) \
            else ~np.asarray(cond, bool)
        return self.where(inv, other)

    def equals(self, other: "DataFrame") -> bool:
        """Exact frame equality: schema and values, NaN equal to NaN.

        On the device (``setops.equal_tables(ordered=True)``, one scalar
        fetch); frames with a value index compare through pandas, whose
        equality reads the index. Two distributed frames with the same
        shard counts compare shard by shard with one all-reduce
        (``setops.dist_ordered_equal_compiled``, no gather); other
        distributed layouts gather first."""
        if not isinstance(other, DataFrame):
            return False
        if self._index is not None or other._index is not None:
            return bool(self.to_pandas().equals(other.to_pandas()))
        ta, tb = self._table, other._table
        if ta.column_names != tb.column_names:
            return False
        for n in ta.column_names:
            da, db = ta.column(n).dtype, tb.column(n).dtype
            stringish = ((da.is_bytes or da.is_dictionary)
                         and (db.is_bytes or db.is_dictionary))
            if da != db and not stringish:
                # a framework dtype mismatch (a nullable int against its
                # pandas round trip as strings): pandas decides
                return bool(self.to_pandas().equals(other.to_pandas()))
        if self.is_distributed and other.is_distributed:
            env = self._env
            ca, capa = shard_sizes(env, ta)
            cb, capb = shard_sizes(env, tb)
            if any(c > k for c, k in zip(ca + cb, capa + capb)):
                dist_num_rows(env, ta)   # raises with the shards' counts
                dist_num_rows(env, tb)
            if sum(ca) != sum(cb):
                return False
            if ca == cb:
                aligned = _setops.align_for_equal(ta, tb)
                flag = torch.zeros((), dtype=torch.int64, device=ta.device) \
                    if aligned is not None \
                    else torch.ones((), dtype=torch.int64, device=ta.device)
                # every rank must take the same branch: agree on the flag
                if int(env.comm.all_reduce(flag, "sum")):
                    return False
                return _setops.dist_ordered_equal_compiled(env, *aligned)
            # equal totals, different shard boundaries: positional
            # equality needs the concatenated view
        return _setops.equal_tables(self._gathered(), other._gathered(),
                                    ordered=True)

    def isin(self, values: Sequence) -> "DataFrame":
        """Parity: frame.py isin, a column at a time through
        :meth:`Series.isin`."""
        t = self._table
        vals = list(values)
        cols = {name: self.series(name).isin(vals).column
                for name in t.column_names}
        return self._like(Table(cols, t.nrows))

    # -- reductions ------------------------------------------------------
    def _reduce(self, op: str, env=None, quantile: float = 0.5) -> dict:
        out = {}
        local = None if env is not None else self._gathered()
        shard = self._sharded(env) if env is not None else None
        for name, c in self._table.columns.items():
            if not (c.dtype.is_numeric or op in ("count", "nunique")):
                continue
            if env is not None:
                out[name] = dist_ops.dist_aggregate(env, shard, name, op,
                                                    quantile=quantile)
            else:
                out[name] = _aggregates.table_aggregate(local, name, op,
                                                        quantile=quantile)
        return {k: v.cpu().numpy()[()] for k, v in out.items()}

    def sum(self, env=None): return self._reduce("sum", env)
    def count(self, env=None): return self._reduce("count", env)
    def min(self, env=None): return self._reduce("min", env)
    def max(self, env=None): return self._reduce("max", env)
    def mean(self, env=None): return self._reduce("mean", env)
    def var(self, env=None): return self._reduce("var", env)
    def std(self, env=None): return self._reduce("std", env)
    def nunique(self, env=None): return self._reduce("nunique", env)
    def median(self, env=None): return self._reduce("median", env)

    def quantile(self, q: float = 0.5, env=None):
        return self._reduce("quantile", env, quantile=q)

    # -- materialisation -------------------------------------------------
    def to_pandas(self):
        if self.is_distributed:
            return dist_to_pandas(self._env, self._table)
        return self._table.to_pandas()

    def to_dict(self):
        return self._gathered().to_pydict()

    def to_numpy(self):
        return self._gathered().to_numpy()

    def to_arrow(self):
        return self._gathered().to_arrow()

    def to_table(self) -> Table:
        return self._table


class GroupByDataFrame:
    """Parity: pycylon ``GroupByDataFrame`` (frame.py:120-180)."""

    def __init__(self, df: DataFrame, by: Sequence[str], env=None):
        self._df = df
        self._by = list(by)
        self._env = env

    def agg(self, spec=None, out_capacity: "int | None" = None,
            **named) -> DataFrame:
        """spec: {col: op | [ops]} (pandas style, outputs named
        ``col_op``), [(col, op[, name])], or pandas named aggregation,
        ``agg(out=("col", "op"), ...)``."""
        aggs = []
        if spec is None and not named:
            raise InvalidArgument(
                "agg() needs a spec ({col: op}, [(col, op[, name])]) or "
                "named aggregations (out=(col, op))")
        if named:
            if spec is not None:
                raise InvalidArgument(
                    "pass either a spec or named aggregations, not both")
            for name, co in named.items():
                if not isinstance(co, (tuple, list)) or len(co) != 2:
                    raise InvalidArgument(
                        f"named aggregation {name}=... must be a "
                        f"(column, op) pair, got {type(co).__name__}")
                aggs.append((co[0], co[1], name))
        elif isinstance(spec, Mapping):
            for col, ops in spec.items():
                ops = [ops] if isinstance(ops, str) else list(ops)
                aggs.extend((col, op, f"{col}_{op}") for op in ops)
        else:
            aggs = [tuple(a) for a in spec]
        if self._env is not None:
            t = dist_ops.dist_groupby(self._env, self._df._sharded(self._env),
                                      self._by, aggs,
                                      out_capacity=out_capacity)
            return DataFrame._wrap(t, env=self._env)
        t = _groupby_mod.groupby_aggregate(self._df._gathered(), self._by,
                                           aggs, out_capacity=out_capacity)
        return DataFrame._wrap(_shrink(t))

    def _all_value_cols(self, op):
        return self.agg([(c, op, c) for c in self._df.columns
                         if c not in self._by])

    def sum(self): return self._all_value_cols("sum")
    def count(self): return self._all_value_cols("count")
    def min(self): return self._all_value_cols("min")
    def max(self): return self._all_value_cols("max")
    def mean(self): return self._all_value_cols("mean")
    def std(self): return self._all_value_cols("std")
    def var(self): return self._all_value_cols("var")
    def nunique(self): return self._all_value_cols("nunique")
    def median(self): return self._all_value_cols("median")


def merge(left: DataFrame, right: DataFrame, **kw) -> DataFrame:
    """Module-level merge (pandas style)."""
    return left.merge(right, **kw)


def concat(frames: Sequence[DataFrame], env=None,
           out_capacity: "int | None" = None) -> DataFrame:
    """Parity: pycylon ``concat`` (frame.py:1956) / ``distributed_concat``
    (``table.pyx:2398``). With ``env`` every rank concatenates its own
    shards, no row moving (rank-major order, as the reference's); locally
    frame-major, as pandas. An explicit ``out_capacity`` concatenates the
    gathered frames at that capacity, then scatters over ``env``."""
    if env is not None and out_capacity is None:
        return DataFrame._wrap(dist_ops.dist_concat(
            env, [f._sharded(env) for f in frames]), env=env)
    t = _selection.concat_tables([f._gathered() for f in frames],
                                 capacity=out_capacity)
    if env is not None:
        return DataFrame._wrap(scatter_table(env, t), env=env)
    return DataFrame._wrap(t)


def read_csv(path, options: "CSVReadOptions | None" = None, env=None,
             **kw) -> DataFrame:
    """CSV ingest (parity: ``FromCSV``; the readers live in
    :mod:`cylon_tpu_torch.io`)."""
    from cylon_tpu_torch.io import read_csv as _read_csv

    return _read_csv(path, options, env=env, **kw)
