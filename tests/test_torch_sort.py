"""The port's sort and row selection against the JAX package's and pandas:
``sort_table`` on mixed keys (several columns, mixed directions,
nullable ``Int64``, floats with NaN and both zeros, ``na_position``
first and last, strings in both storages with bytes >= 0x80 and the
empty string), element for element; ``order_key`` on device-bytes
words; ``filter_table``, ``concat_tables`` (dictionaries unified,
storages mixed), ``head``, ``sample`` and ``take``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu.ops import selection as jsel
from cylon_tpu_torch import convert
from cylon_tpu_torch.ops import kernels, selection

NAMES = np.array(["apple", "éclair", "", "fig", "Zebra", "ärger", "fig!",
                  "quince"], object)


def to_port(jt):
    cols, dicts = {}, {}
    for n, c in jt.columns.items():
        cols[n] = (np.asarray(c.data),
                   None if c.validity is None else np.asarray(c.validity),
                   repr(c.dtype))
        if c.dictionary is not None:
            dicts[n] = c.dictionary.values
    return convert.from_arrays(cols, int(jt.nrows), device="cpu",
                               dictionaries=dicts)


def _frame(seed: int, n: int = 61):
    rng = np.random.default_rng(seed)
    k = pd.array(rng.integers(-3, 4, n), dtype="Int64")
    k[rng.random(n) < 0.15] = pd.NA
    f = rng.normal(size=n).round(1)
    f[rng.random(n) < 0.15] = np.nan
    f[:4] = [0.0, -0.0, np.inf, -np.inf][:n]
    s = NAMES[rng.integers(0, len(NAMES), n)]
    s[rng.random(n) < 0.1] = None
    return pd.DataFrame({"k": k, "f": f, "s": s,
                         "i": rng.integers(-2, 3, n).astype(np.int32),
                         "row": np.arange(n)})


def _cells(df):
    """A frame's cells as text, nulls as one tag (pandas' NaN, None and
    NA alike), for an element-for-element compare."""
    def cell(x):
        if x is None or x is pd.NA or (isinstance(x, float) and np.isnan(x)):
            return "<null>"
        return repr(float(x)) if isinstance(x, float) else str(x)
    return [[cell(x) for x in r] for r in df.itertuples(index=False)]


SORTS = [
    (["k", "f"], [True, False], "last"),
    (["f", "i"], [False, True], "first"),
    (["s", "k"], [True, True], "last"),
    (["s"], False, "first"),
    (["i", "s", "f"], [False, True, True], "last"),
]


@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_sort_table_matches_jax_and_pandas(storage):
    df = _frame(1)
    jt = jct.Table.from_pandas(df, string_storage=storage)
    tt = to_port(jt)
    for by, asc, na in SORTS:
        got = ct.sort_table(tt, by, asc, na).to_pandas()
        want = jsel.sort_table(jt, by, asc, na).to_pandas()
        assert _cells(got) == _cells(want), (by, asc, na)
        pdf = df.sort_values(by, ascending=asc, na_position=na,
                             kind="stable")
        # pandas orders floats by value: -0.0 and 0.0 tie, as here
        assert got["row"].tolist() == pdf["row"].tolist(), (by, asc, na)


def test_order_key_keys_bytes_words_unsigned():
    """A device-bytes column keys each word unsigned: "éclair" (0xC3...)
    sorts after "apple" ascending and before it descending, in both
    storages and through the public sort; a 2-D key of another dtype
    raises."""
    vals = np.array(["éclair", "apple", "", "ärger", "Zebra", "zz"], object)
    t = ct.Table.from_pydict({"s": vals}, device="cpu",
                             string_storage="bytes")
    words = t.column("s").data
    assert words[0, 0] < 0     # the int32 pattern of 0xC3A9... is negative
    up = kernels.order_key(words)
    assert up.bits == 32 and up.value.shape == words.shape
    assert bool((up.value >= 0).all()) and int(up.value[0, 0]) > \
        int(up.value[1, 0])
    down = kernels.order_key(words, ascending=False)
    assert torch.equal(down.value, ~up.value & 0xFFFFFFFF)
    with pytest.raises(TypeError):
        kernels.order_key(torch.zeros((4, 2), dtype=torch.int64))
    for storage in ("bytes", "dict"):
        t = ct.Table.from_pydict({"s": vals}, device="cpu",
                                 string_storage=storage)
        for asc in (True, False):
            got = ct.sort_table(t, ["s"], asc).to_pandas()["s"].tolist()
            assert got == sorted(vals, reverse=not asc), (storage, asc)


@pytest.mark.parametrize("padding", ["count", "trailing_mask",
                                     "scattered_mask"])
def test_sort_perm_puts_padding_last_after_maximum_ties(padding):
    """``sort_perm`` is numpy's stable lexsort of the valid rows, then the
    padding rows in order, with valid rows holding each key's maximum
    (which the padding rows take) kept ahead of the padding. A scattered
    mask is exact where no valid row holds the maximum tuple, as in the
    shuffle's destination sort."""
    rng = np.random.default_rng(11)
    cap, n = 53, 41
    a = rng.integers(-3, 3, cap).astype(np.int32)
    b = rng.integers(0, 4, cap).astype(np.int64)
    a[[2, 7, 30]] = np.iinfo(np.int32).max
    b[[2, 7, 30]] = np.iinfo(np.int64).min     # the maximum, descending
    if padding == "count":
        nrows, valid = torch.tensor(n, dtype=torch.int32), np.arange(cap) < n
    elif padding == "trailing_mask":
        valid = np.arange(cap) < n
        nrows = torch.from_numpy(valid)
    else:
        a[[2, 7, 30]] = 0
        valid = rng.random(cap) < 0.7
        nrows = torch.from_numpy(valid)
    perm = kernels.sort_perm([kernels.order_key(torch.from_numpy(a)),
                              kernels.order_key(torch.from_numpy(b),
                                                ascending=False)], nrows)
    rows = np.flatnonzero(valid)
    want = rows[np.lexsort((-b[rows].astype(np.float64), a[rows]))]
    want = np.concatenate([want, np.flatnonzero(~valid)])
    assert perm.tolist() == want.tolist()


def test_filter_head_sample_take_match_jax():
    df = _frame(2, 97)
    jt = jct.Table.from_pandas(df, capacity=128, string_storage="bytes")
    tt = to_port(jt)
    mask = np.random.default_rng(3).random(128) < 0.4
    got = ct.filter_table(tt, torch.from_numpy(mask)).to_pandas()
    want = jsel.filter_table(jt, _jmask(mask)).to_pandas()
    assert _cells(got) == _cells(want)
    assert got["row"].tolist() == df["row"][mask[:97]].tolist()
    for n in (0, 5, 97, 200):
        assert _cells(ct.head(tt, n).to_pandas()) == \
            _cells(jsel.head(jt, n).to_pandas())
    for n in (1, 7, 33, 97, 150):
        assert _cells(ct.sample(tt, n).to_pandas()) == \
            _cells(jsel.sample(jt, n).to_pandas()), n
    idx = np.array([5, 0, 96, 5, 40], np.int32)
    assert _cells(ct.take(tt, torch.from_numpy(idx)).to_pandas()) == \
        _cells(jsel.take(jt, _jmask(idx)).to_pandas())


@pytest.mark.parametrize("n, cap", [(0, 128), (5, 128), (127, 128),
                                    (128, 128), (200, 128)])
def test_a_head_below_the_capacity_owns_its_rows(n, cap):
    """Below the capacity a head copies its first ``n`` slots into a table
    of capacity ``n`` that shares no storage with its source, so keeping
    it keeps only those rows; at or past the capacity it is the source
    with its count clamped. Either way its rows are the source's first
    ``n`` valid rows."""
    t = ct.Table.from_pydict({"k": np.arange(97, dtype=np.int64),
                              "v": np.linspace(0.0, 1.0, 97)},
                             device="cpu").with_capacity(cap)
    got = ct.head(t, n)
    assert got.num_rows == min(n, 97)
    assert got.to_pandas().equals(t.to_pandas().head(n))
    own = n < cap
    assert got.capacity == (n if own else cap)
    for name in ("k", "v"):
        src = t.column(name).data.untyped_storage().data_ptr()
        mine = got.column(name).data.untyped_storage()
        assert (mine.data_ptr() != src) == own
        if own:
            assert mine.nbytes() == 8 * n


def _jmask(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def test_concat_tables_unifies_dictionaries_and_storages():
    """Three tables: dictionary strings over other value sets, one of
    device bytes; a nullable column on one side only; a capacity larger
    than the rows. Element for element as the JAX package, and as
    pandas' concat."""
    a = _frame(4, 20)
    b = _frame(5, 13).drop(columns=["k"]).assign(
        k=np.arange(13, dtype=np.int64))[a.columns]
    c = _frame(6, 9)
    jts = [jct.Table.from_pandas(a, capacity=32),
           jct.Table.from_pandas(b, string_storage="bytes"),
           jct.Table.from_pandas(c)]
    b_port = b.copy()
    b_port["k"] = pd.array(b["k"], dtype="Int64")
    got = ct.concat_tables([to_port(t) for t in jts]).to_pandas()
    want = jsel.concat_tables(jts).to_pandas()
    assert _cells(got) == _cells(want)
    pdf = pd.concat([a, b_port, c], ignore_index=True)
    assert _cells(got) == _cells(pdf)
    small = ct.concat_tables([to_port(t) for t in jts], capacity=16)
    with pytest.raises(ct.OutOfCapacity):
        small.num_rows
    with pytest.raises(ct.InvalidArgument):
        ct.concat_tables([to_port(jts[0]), to_port(jts[0]).select(["k"])])


def test_sort_of_empty_and_capacity_zero_tables():
    df = _frame(7, 0).astype({"s": object})
    for cap in (None, 8):
        t = ct.Table.from_pandas(df, capacity=cap, device="cpu")
        assert ct.sort_table(t, ["k", "s"]).num_rows == 0
        assert ct.concat_tables([t, t]).num_rows == 0
        assert ct.sample(t, 4).num_rows == 0


_COUNTERPARTS = (
    "ops.selection:sort_key_operands", "ops.selection:sort_table",
    "ops.selection:_sort_compiled", "ops.selection:permute_by_sort",
    "ops.selection:filter_table", "ops.selection:concat_tables",
    "ops.selection:head", "ops.selection:sample", "ops.selection:take",
    "ops.datetime_ops:civil_from_days", "ops.datetime_ops:year_of",
    "ops.datetime_ops:month_of", "ops.datetime_ops:day_of",
    "ops.partition:round_robin_ids", "ops.partition:assign_partitions",
    "ops.partition:split_by_partition", "ops.partition:partition_table",
    "ops.setops:_trim_capacity", "ops.setops:unique",
    "ops.setops:_two_table_gids", "ops.setops:_select_a_groups",
    "ops.setops:union", "ops.setops:intersect", "ops.setops:subtract",
    "ops.setops:equal_tables", "ops.setops:align_for_equal",
    "ops.setops:_columns_equal", "ops.setops:dist_ordered_equal_compiled",
    "parallel.collectives:ReduceOp", "parallel.collectives:all_reduce",
    "parallel.collectives:rank", "parallel.collectives:world",
    "parallel.dist_ops:SortOptions", "parallel.dist_ops:dist_sort",
    "parallel.dist_ops:_splitter_searchsorted",
    "parallel.dist_ops:_sort_body", "parallel.dist_ops:_dist_setop",
    "parallel.dist_ops:dist_union", "parallel.dist_ops:dist_intersect",
    "parallel.dist_ops:dist_subtract", "parallel.dist_ops:dist_unique",
    "parallel.dist_ops:colocated_join", "parallel.dist_ops:colocated_groupby",
    "parallel.dist_ops:colocated_unique", "parallel.dist_ops:dist_concat",
    "parallel.dist_ops:dist_filter", "parallel.dist_ops:dist_head",
    "parallel.dtable:dist_to_pandas",
)


@pytest.mark.parametrize("name", _COUNTERPARTS)
def test_slice_function_names_its_counterpart_and_is_exported(name):
    """Each function of the slice names its ``cylon_tpu`` counterpart,
    and the public ones are exported where the JAX package exports
    them (``cylon_tpu/ops/__init__.py``,
    ``cylon_tpu/parallel/__init__.py``)."""
    import importlib

    import cylon_tpu.ops as jops
    import cylon_tpu.parallel as jpar

    mod, _, attr = name.partition(":")
    obj = getattr(importlib.import_module("cylon_tpu_torch." + mod), attr)
    assert "cylon_tpu/" in (obj.__doc__ or ""), name
    pkg = mod.split(".")[0]
    exported = jops.__all__ if pkg == "ops" else jpar.__all__
    if attr in exported:
        port_pkg = importlib.import_module("cylon_tpu_torch." + pkg)
        assert getattr(port_pkg, attr) is obj, name
        assert attr in ct.__all__, name


def test_permute_by_sort_is_one_permutation_and_one_gather():
    """The port's ``permute_by_sort`` at any width: the stable order of
    its operands (``sort_key_operands`` of a bytes column, descending),
    every column carried, as the JAX package's and pandas'."""
    from cylon_tpu.ops import kernels as jkernels

    df = _frame(8, 40)
    jt = jct.Table.from_pandas(df, string_storage="bytes")
    t = to_port(jt)
    ops = selection.sort_key_operands(t.column("s"), False)
    got = selection.permute_by_sort(t, ops, t.nrows).to_pandas()
    want = jsel.permute_by_sort(jt, jkernels.pack_order_keys(
        jsel.sort_key_operands(jt.column("s"), False)), jt.nrows)
    assert _cells(got) == _cells(want.to_pandas())
    pdf = df.sort_values("s", ascending=False, na_position="last",
                         kind="stable")
    assert got["row"].tolist() == pdf["row"].tolist()


def test_one_row_gathers_and_exchanges_keep_8_byte_columns():
    """A one-row gather or receive of a table whose 8-byte column sits at
    an odd word of the packed rows: ``.contiguous()`` keeps a one-row
    slice's row stride, which a view to 8-byte values refuses."""
    from cylon_tpu_torch.parallel.comm import LocalComm
    from cylon_tpu_torch.parallel.shuffle import shuffle_local

    t = ct.Table.from_pydict({"i": np.array([3, 4], np.int32),
                              "k": np.array([-5, 1 << 40]),
                              "v": np.array([0.5, -2.0])}, device="cpu")
    for idx in ([1], [0]):
        got = ct.take(t, torch.tensor(idx)).to_pandas()
        assert got.values.tolist() == t.to_pandas().iloc[idx].values.tolist()
    one = ct.head(t, 1)
    got = shuffle_local(LocalComm(), one, torch.zeros(2, dtype=torch.int32),
                        1).to_pandas()
    assert got.values.tolist() == [[3, -5, 0.5]]
