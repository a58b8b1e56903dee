"""String columns in the port, both storages, against ``cylon_tpu``.

Device bytes (``ops.bytescol``: big-endian u32 words, held by the port as
int32 bit patterns) and dictionary codes (``ops.dictenc``) go through the
codec, the row hash, both join algorithms, the row gather and
``dist_join``. The same inputs, made with numpy from a seed, go to both
packages; hashes, words and join results match element for element.
Where the JAX path loses rows (a key nullable on one side only in the
bucketed join), the reference is pandas alone.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu import dtypes as jdtypes
from cylon_tpu.column import Column as JColumn
from cylon_tpu.ops import bytescol as jbc
from cylon_tpu.ops import dictenc as jde
from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops.join import join as jjoin
from cylon_tpu.ops.kernels import group_sort as jgroup_sort
from cylon_tpu.ops.selection import take_columns as jtake
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import dist_to_pandas as jdist_to_pandas
from cylon_tpu.parallel import scatter_table as jscatter
import cylon_tpu_torch as ct
from cylon_tpu_torch import convert, dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.errors import InvalidArgument, TypeError_
from cylon_tpu_torch.ops import bytescol, dictenc
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops.join import join as tjoin
from cylon_tpu_torch.ops.kernels import group_sort
from cylon_tpu_torch.ops.selection import take_columns as ttake
from cylon_tpu_torch.parallel.dist_ops import dist_join
from cylon_tpu_torch.parallel.dtable import gather_table, scatter_table, \
    world_layout
from test_torch_join import assert_same_table

#: values with non-ASCII bytes (>= 0x80), an empty string and a prefix
#: pair; the right side's pool reaches 20 bytes, the left's 16
LEFT_POOL = np.array(["apple", "Banana", "é", "日本", "", "app",
                      "cherry pie", "zebra", "Ωmega", "16 bytes exactly"],
                     object)
RIGHT_POOL = np.array(["apple", "é", "日本", "", "app", "zebra", "kiwi",
                       "Ωmega", "twenty bytes, yes!!!", "Banana"], object)


def _keys(rng, pool, n, null_share):
    k = pool[rng.integers(0, len(pool), n)].copy()
    k[rng.random(n) < null_share] = None
    return k


def _frames(seed, n=170, m=150, lnull=0.08, rnull=0.08):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": _keys(rng, LEFT_POOL, n, lnull),
                        "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k": _keys(rng, RIGHT_POOL, m, rnull),
                        "b": rng.integers(0, 50, m)})
    return ldf, rdf


def to_port(jt):
    """A cylon_tpu Table -> the same table in the port, on the CPU,
    dictionaries included."""
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    dicts = {n: c.dictionary.values for n, c in jt.columns.items()
             if c.dictionary is not None}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu",
                               dictionaries=dicts)


def assert_same_strings(jt, tt):
    """:func:`assert_same_table` (bytes as uint32 words, codes as
    codes), and the same dictionary values."""
    assert_same_table(jt, tt)
    for name, c in jt.columns.items():
        tc = tt.column(name)
        assert (tc.dictionary is None) == (c.dictionary is None), name
        if c.dictionary is not None:
            assert list(tc.dictionary.values) == list(c.dictionary.values)


def _norm(df: pd.DataFrame, cols=None, ordered=True) -> pd.DataFrame:
    """Strings as object with None for null (pandas' ``str`` dtype reads
    a null back as NaN), every other column as float64."""
    cols = list(df.columns) if cols is None else cols
    out = {}
    for c in cols:
        s = df[c]
        if s.map(lambda v: isinstance(v, str)).any():
            out[c] = s.astype(object).where(s.notna(), None)
        else:
            out[c] = pd.to_numeric(s).astype("float64")
    out = pd.DataFrame(out)
    if not ordered:
        out = out.sort_values(cols, na_position="last", key=lambda s: (
            s.map(lambda v: "\x00NULL" if v is None else v)
            if s.dtype == object else s))
    return out.reset_index(drop=True)


def _assert_rows(got, want, ordered=True):
    cols = list(want.columns)
    pd.testing.assert_frame_equal(_norm(got, cols, ordered),
                                  _norm(want, cols, ordered))


# ------------------------------------------------------------------- codec
CODEC = {
    "non_ascii": np.array(["apple", "Banana", "cherry pie", "", "Ümläût",
                           "日本語", "z" * 37], object),
    "nulls": np.array(["a", None, "b", float("nan"), pd.NA, ""], object),
    "fuzz": np.array(["".join(chr(c) for c in np.random.default_rng(
        i).integers(33, 0x3000, i % 17)) for i in range(300)], object),
}


@pytest.mark.parametrize("case", sorted(CODEC))
def test_codec_matches_jax_and_round_trips(case):
    vals = CODEC[case]
    words, validity, width = bytescol.encode_host(vals)
    jwords, jvalidity, jwidth = jbc.encode_host(vals)
    np.testing.assert_array_equal(words, jwords)
    assert width == jwidth
    assert (validity is None) == (jvalidity is None)
    col = Column.from_numpy(vals, device="cpu", string_storage="bytes")
    jcol = JColumn.from_numpy(vals, string_storage="bytes")
    assert col.data.dtype == torch.int32 and repr(col.dtype) == repr(
        jcol.dtype)
    np.testing.assert_array_equal(col.data.numpy().view(np.uint32),
                                  np.asarray(jcol.data))
    want = [None if pd.isna(v) else v for v in vals]
    assert list(col.to_numpy()) == want
    assert list(bytescol.decode_host(col.data.numpy(), validity)) == want
    t = ct.Table.from_pydict({"s": vals}, device="cpu",
                             string_storage="bytes")
    assert list(_norm(t.to_pandas())["s"]) == want
    assert t.row(1)["s"] == want[1]


def test_embedded_nul_is_refused_and_auto_takes_dict():
    vals = np.array(["ok", "bad\x00bad"], object)
    with pytest.raises(TypeError_):
        bytescol.encode_host(vals)
    with pytest.raises(Exception):
        jbc.encode_host(vals)
    assert bytescol.choose_storage(vals) == jbc.choose_storage(vals) \
        == "dict"
    col = Column.from_numpy(vals, device="cpu", string_storage="auto")
    assert col.dtype.is_dictionary
    assert list(col.to_numpy()) == ["ok", "bad\x00bad"]


def test_convert_carries_high_words_exactly():
    """Words with the top bit set (bytes >= 0x80 first in their word)
    travel through ``convert`` as a view: the int32 patterns are the
    uint32 words, both ways."""
    jt = jct.Table.from_pydict({"s": np.array(["é", "日本", "\xff"],
                                              object)},
                               string_storage="bytes")
    tt = to_port(jt)
    assert (tt.column("s").data < 0).any()
    assert_same_strings(jt, tt)
    assert list(tt.column("s").to_numpy()) == ["é", "日本", "\xff"]


def test_word_order_is_string_order():
    """Unsigned word order is UTF-8 byte order: bytes >= 0x80 sort after
    ASCII. The empty string sorts first and null last (pandas)."""
    rng = np.random.default_rng(3)
    vals = _keys(rng, np.concatenate([LEFT_POOL, RIGHT_POOL]), 300, 0.05)
    col = Column.from_numpy(vals, device="cpu", string_storage="bytes")
    n = len(vals)
    iota = torch.arange(n, dtype=torch.int32)
    _, _, (perm,) = group_sort([col.data], n, [col.validity],
                               payloads=[iota])
    got = vals[perm.numpy()]
    nonnull = [v for v in vals if v is not None]
    want = sorted(nonnull, key=lambda v: v.encode()) \
        + [None] * (n - len(nonnull))
    assert list(got) == want
    assert got[0] == ""
    # and the JAX package's group order on the same words
    jcol = JColumn.from_numpy(vals, string_storage="bytes")
    _, _, (jperm,) = jgroup_sort([jcol.data], jnp.int32(n), [jcol.validity],
                                 payloads=[jnp.arange(n, dtype=jnp.int32)])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


# --------------------------------------------------------- storage choice
STORAGE_CASES = {
    "low_card": (np.array(["red", "green", "blue"], object)[
        np.random.default_rng(7).integers(0, 3, 1000)], "dict"),
    "high_card": (np.array([f"val_{i}" for i in range(1000)], object),
                  "bytes"),
    # a head sample would see one value here; the strided one does not
    "clustered": (np.array(["dup"] * 8192 + [f"val{i:06d}" for i in
                                              range(8192, 20000)], object),
                  "bytes"),
    "nul_in_sample": (np.array([f"v{i}\x00x" for i in range(100)], object),
                      "dict"),
}


@pytest.mark.parametrize("case", sorted(STORAGE_CASES))
def test_choose_storage_matches_jax(case):
    arr, want = STORAGE_CASES[case]
    assert bytescol.choose_storage(arr) == jbc.choose_storage(arr) == want
    col = Column.from_numpy(arr, device="cpu", string_storage="auto")
    assert col.dtype.is_bytes == (want == "bytes")


def test_astype_between_storages_matches_jax():
    rng = np.random.default_rng(5)
    vals = _keys(rng, LEFT_POOL, 60, 0.1)
    jb = JColumn.from_numpy(vals, string_storage="bytes")
    tb = Column.from_numpy(vals, device="cpu", string_storage="bytes")
    cases = [(jdtypes.string, dtypes.string),
             (jdtypes.string_bytes(24), dtypes.string_bytes(24)),
             (jdtypes.string_bytes(8), dtypes.string_bytes(8))]
    for jdt, tdt in cases:
        jc, tc = jb.astype(jdt), tb.astype(tdt)
        assert repr(jc.dtype) == repr(tc.dtype)
        data = tc.data.numpy()
        np.testing.assert_array_equal(
            data.view(np.uint32) if tc.dtype.is_bytes else data,
            np.asarray(jc.data))
        if jc.dictionary is not None:
            assert list(tc.dictionary.values) == list(jc.dictionary.values)
    # dictionary -> bytes, back to the same strings
    td = tb.astype(dtypes.string)
    back = td.astype(dtypes.string_bytes(24))
    jback = jb.astype(jdtypes.string).astype(jdtypes.string_bytes(24))
    np.testing.assert_array_equal(back.data.numpy().view(np.uint32),
                                  np.asarray(jback.data))
    assert list(back.to_numpy()) == [None if v is None else v for v in vals]


# ------------------------------------------------------------ dictionaries
def test_dictionary_helpers_match_jax():
    rng = np.random.default_rng(9)
    a, b = _keys(rng, LEFT_POOL, 80, 0.1), _keys(rng, RIGHT_POOL, 70, 0.1)
    jcols = [JColumn.from_numpy(a), JColumn.from_numpy(b)]
    tcols = [Column.from_numpy(a, device="cpu"),
             Column.from_numpy(b, device="cpu")]
    for jc, tc in zip(jde.unify_dictionaries(jcols),
                      dictenc.unify_dictionaries(tcols)):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        assert list(tc.dictionary.values) == list(jc.dictionary.values)
    upper = [v.upper() for v in tcols[0].dictionary.values]
    jr = jde.reencode_values(jcols[0], upper)
    tr = dictenc.reencode_values(tcols[0], upper)
    np.testing.assert_array_equal(tr.data.numpy(), np.asarray(jr.data))
    assert list(tr.dictionary.values) == list(jr.dictionary.values)
    for value in ("apple", "aardvark"):
        jf, jcode = jde.encode_fill_value(jcols[0], value)
        tf, tcode = dictenc.encode_fill_value(tcols[0], value)
        assert tcode == jcode
        np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))


# --------------------------------------------------------------- hashing
HASH_CASES = ["bytes", "bytes_nullable", "bytes_and_int64", "wide_80_bytes"]


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_and_partition_ids_match_jax(case):
    rng = np.random.default_rng(HASH_CASES.index(case))
    n = 500
    null = 0.1 if case == "bytes_nullable" else 0.0
    if case == "wide_80_bytes":   # 20 words and a validity word: 2 chunks
        vals = np.array(["x" * int(rng.integers(60, 81)) + str(i)
                         for i in range(n)], object)[:n]
        vals = np.array([v[-80:] for v in vals], object)
        vals[rng.random(n) < 0.1] = None
    else:
        vals = _keys(rng, LEFT_POOL, n, null)
    jc = JColumn.from_numpy(vals, string_storage="bytes")
    tc = Column.from_numpy(vals, device="cpu", string_storage="bytes")
    jarr, jval = [jc.data], [jc.validity]
    tarr, tval = [tc.data], [tc.validity]
    if case == "bytes_and_int64":
        i64 = rng.integers(-2 ** 62, 2 ** 62, n)
        jarr.append(jnp.asarray(i64))
        tarr.append(torch.from_numpy(i64))
        jval.append(None)
        tval.append(None)
    if case == "wide_80_bytes":
        assert len(thash._row_words(tarr, tval)) == 21
    np.testing.assert_array_equal(
        thash.hash_columns(tarr, tval).numpy().view(np.uint32),
        np.asarray(jhash.hash_columns(jarr, jval)))
    for parts in (4, 7):
        np.testing.assert_array_equal(
            thash.partition_ids(tarr, parts, tval).numpy(),
            np.asarray(jhash.partition_ids(jarr, parts, jval)))


def test_paired_validities_on_a_bytes_key():
    key = torch.zeros((9, 5), dtype=torch.int32)
    other = torch.zeros(9, dtype=torch.bool)
    lv, rv = thash.paired_validities([key], [None], [key], [other])
    assert lv[0].shape == (9,) and bool(lv[0].all())
    assert rv[0] is other


# ----------------------------------------------------------------- joins
STORAGES = [("bytes", "bytes"), ("dict", "dict"), ("bytes", "dict"),
            ("dict", "bytes")]
HOWS = ["inner", "left", "right", "outer"]
# every how and both orders for bytes against bytes; the other storage
# pairs split them
JOIN_COMBOS = ([(STORAGES[0], h, o) for h in HOWS for o in (True, False)]
               + [(s, h, (i + j) % 2 == 0)
                  for j, s in enumerate(STORAGES[1:])
                  for i, h in enumerate(HOWS)])


def _tables(ldf, rdf, storages, lcap=None, rcap=None):
    jl = jct.Table.from_pandas(ldf, capacity=lcap,
                               string_storage=storages[0])
    jr = jct.Table.from_pandas(rdf, capacity=rcap,
                               string_storage=storages[1])
    return jl, jr


@pytest.mark.parametrize("storages,how,ordered", JOIN_COMBOS)
def test_join_matches_jax(storages, how, ordered):
    """Non-ASCII keys, empty strings against nulls, widths of 16 and 20
    bytes, each storage pair: the port's sort join equals the JAX
    package's element for element, and pandas' merge."""
    ldf, rdf = _frames(STORAGES.index(storages))
    jl, jr = _tables(ldf, rdf, storages, len(ldf) + 9, len(rdf) + 3)
    want = jjoin(jl, jr, on="k", how=how, ordered=ordered,
                 out_capacity=4096)
    got = tjoin(to_port(jl), to_port(jr), on="k", how=how, ordered=ordered,
                out_capacity=4096)
    assert got.capacity == want.capacity
    assert_same_strings(want, got)
    if "bytes" in storages:
        assert got.column("k").dtype.is_bytes
    _assert_rows(got.to_pandas(), ldf.merge(rdf, on="k", how=how), ordered)


HASH_COMBOS = [(impl, s, how, o) for impl in ("bucketed", "sort")
               for s, how, o in ((STORAGES[0], "inner", True),
                                 (STORAGES[0], "left", False),
                                 (STORAGES[1], "right", True),
                                 (STORAGES[2], "inner", False))]


@pytest.mark.parametrize("impl,storages,how,ordered", HASH_COMBOS)
def test_hash_join_matches_jax(impl, storages, how, ordered, monkeypatch):
    """``algorithm="hash"`` by both routes: the bucketed build / probe
    over the words (nulls on both sides: the JAX bucketed join pairs no
    masks) and the sort join grouped by hash first."""
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", impl)
    rng = np.random.default_rng(21)
    # unique build keys, so the chains stay within the width of 16
    pool = np.array([f"key-{i:03d}-é" for i in range(400)], object)
    ldf = pd.DataFrame({"k": pool[rng.permutation(400)[:170]],
                        "a": rng.normal(size=170)})
    ldf.loc[[3], "k"] = None
    rdf = pd.DataFrame({"k": _keys(rng, pool[:250], 150, 0.05),
                        "b": rng.integers(0, 50, 150)})
    jl, jr = _tables(ldf, rdf, storages, 192, 160)
    want = jjoin(jl, jr, on="k", how=how, algorithm="hash",
                 ordered=ordered, out_capacity=1024)
    got = tjoin(to_port(jl), to_port(jr), on="k", how=how, algorithm="hash",
                ordered=ordered, out_capacity=1024)
    assert_same_strings(want, got)
    _assert_rows(got.to_pandas(), ldf.merge(rdf, on="k", how=how), ordered)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_hash_join_key_nullable_on_one_side_only(how, monkeypatch):
    """Only the left bytes key has nulls. The port pairs an all-valid
    mask with the right key (a [cap] mask for the [cap, nwords] key), so
    equal strings meet; held against pandas."""
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")
    ldf, rdf = _frames(31, lnull=0.05, rnull=0.0)
    ldf = ldf.drop_duplicates("k").reset_index(drop=True)
    lt = ct.Table.from_pandas(ldf, device="cpu", string_storage="bytes")
    rt = ct.Table.from_pandas(rdf, device="cpu", string_storage="bytes")
    assert lt.column("k").validity is not None
    assert rt.column("k").validity is None
    got = ct.join(rt, lt, on="k", how=how, algorithm="hash",
                  out_capacity=2048)
    _assert_rows(got.to_pandas(), rdf.merge(ldf, on="k", how=how))


def test_string_vs_non_string_key_is_refused():
    t = ct.Table.from_pydict({"k": np.array(["a", "b"], object)},
                             device="cpu", string_storage="bytes")
    u = ct.Table.from_pydict({"k": np.array([1, 2])}, device="cpu")
    with pytest.raises(InvalidArgument):
        ct.join(t, u, on="k")


@pytest.mark.parametrize("with_null_mask", [False, True])
def test_take_columns_bytes_matches_jax(with_null_mask):
    rng = np.random.default_rng(13)
    n = 200
    df = pd.DataFrame({"s": _keys(rng, RIGHT_POOL, n, 0.1),
                       "d": _keys(rng, LEFT_POOL, n, 0.0),
                       "x": rng.integers(0, 50, n)})
    jt = jct.Table.from_pandas(df, capacity=n + 7,
                               string_storage={"s": "bytes"})
    idx = rng.integers(-3, n + 5, 256).astype(np.int32)
    mask = rng.random(256) < 0.3 if with_null_mask else None
    want = jtake(jt, jnp.asarray(idx), jnp.int32(230),
                 null_mask=None if mask is None else jnp.asarray(mask))
    got = ttake(to_port(jt), torch.from_numpy(idx), 230,
                null_mask=None if mask is None else torch.from_numpy(mask))
    assert got.column("s").data.shape == (256, 5)
    assert_same_strings(want, got)


# ------------------------------------------------------------ predicates
PRED_VALS = np.array(["PROMO brushed steel", "STANDARD brushed tin",
                      "PROMO anodized metal", "ECONOMY plated nickel", "",
                      "promo lowercase", None, "metal PROMO", "übung",
                      "日本語 metal"], object)
PREDICATES = {
    "startswith": lambda m, c: m.startswith(c, "PROMO"),
    "endswith": lambda m, c: m.endswith(c, "metal"),
    "contains": lambda m, c: m.contains(c, "brushed"),
    "contains_non_ascii": lambda m, c: m.contains(c, "本語"),
    "contains_seq": lambda m, c: m.contains_seq(c, "PROMO", "metal"),
    "cmp_scalar": lambda m, c: m.cmp_scalar(c, "PROMO anodized"),
    "cmp_scalar_long": lambda m, c: m.cmp_scalar(c, "z" * 99),
    "isin": lambda m, c: m.isin(c, ["übung", "", None, "nope"]),
    "char_lengths": lambda m, c: m.char_lengths(c.data),
    "byte_matrix": lambda m, c: m.byte_matrix(c.data),
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicates_match_jax(name):
    jc = JColumn.from_numpy(PRED_VALS, string_storage="bytes")
    tc = Column.from_numpy(PRED_VALS, device="cpu", string_storage="bytes")
    want = PREDICATES[name](jbc, jc)
    got = PREDICATES[name](bytescol, tc)
    pairs = zip(want, got) if isinstance(want, tuple) else [(want, got)]
    for w, g in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fill_value_and_replace_where_match_jax():
    jc = JColumn.from_numpy(PRED_VALS, string_storage="bytes")
    tc = Column.from_numpy(PRED_VALS, device="cpu", string_storage="bytes")
    for value in ("FILLED", "a replacement longer than any value"):
        jf, tf = jbc.fill_value(jc, value), bytescol.fill_value(tc, value)
        np.testing.assert_array_equal(tf.data.numpy().view(np.uint32),
                                      np.asarray(jf.data))
        assert tf.validity is None and repr(tf.dtype) == repr(jf.dtype)
    assert bytescol.is_nullish(pd.NA) and not bytescol.is_nullish("")


# ------------------------------------------------------------ dist_join
def _world(tl, tr, **kw):
    def rank(comm):
        env = ct.CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on="k", **kw)
        return gather_table(env, res).to_pandas()

    return ct.ThreadWorld(4).run(rank)[0]


@pytest.mark.parametrize("storages", STORAGES[:3])
def test_dist_join_w4_matches_pandas(storages):
    """Relations ingested apart (their own widths, their own
    dictionaries) co-locate equal strings: bytes hash by content,
    dictionary keys by their codes on the unified dictionary."""
    ldf, rdf = _frames(41 + STORAGES.index(storages), 260, 200)
    tl = ct.Table.from_pandas(ldf, device="cpu", string_storage=storages[0])
    tr = ct.Table.from_pandas(rdf, device="cpu", string_storage=storages[1])
    if storages == ("dict", "dict"):
        assert tl.column("k").dictionary != tr.column("k").dictionary
    _assert_rows(_world(tl, tr), ldf.merge(rdf, on="k"), ordered=False)


def test_dist_join_w4_bytes_matches_jax(env4):
    ldf, rdf = _frames(47, 240, 200)
    jl, jr = _tables(ldf, rdf, STORAGES[0])
    want = jdist_to_pandas(env4, jdist_join(env4, jscatter(env4, jl),
                                            jscatter(env4, jr), on="k"))
    got = _world(to_port(jl), to_port(jr))
    _assert_rows(got, want, ordered=False)


def _quarters(df):
    """``df`` cut into four rank shares; rank 0's share holds no null and
    no "apple", so its dictionary and validity differ from its peers'."""
    parts = [df.iloc[ix] for ix in np.array_split(np.arange(len(df)), 4)]
    k = parts[0]["k"]
    parts[0] = parts[0][k.notna() & (k != "apple")]
    return parts


@pytest.mark.parametrize("storages", STORAGES[:3])
def test_dist_join_w4_shards_ingested_per_rank(storages):
    """Each rank ingests its own rows, so its bytes widths, dictionaries
    and validity masks differ from its peers': dist_join brings them to
    one layout before any rows move, and the joined strings are the
    ones pandas joins."""
    ldf, rdf = _frames(53, 200, 160)
    lparts, rparts = _quarters(ldf), _quarters(rdf)

    def rank(comm):
        env = ct.CylonEnv(comm)
        lt = ct.Table.from_pandas(lparts[comm.rank], device="cpu",
                                  string_storage=storages[0])
        rt = ct.Table.from_pandas(rparts[comm.rank], device="cpu",
                                  string_storage=storages[1])
        res = dist_join(env, lt, rt, on="k")
        dict_side = lt if storages[0] == "dict" else rt
        return dict_side.column("k"), res.column("k"), \
            gather_table(env, res).to_pandas()

    out = ct.ThreadWorld(4).run(rank)
    if storages == ("bytes", "bytes"):
        assert {k.data.shape[1] for _, k, _ in out} == {5}
    else:
        assert len({tuple(k.dictionary.values) for k, _, _ in out}) > 1
    assert out[0][0].validity is None
    assert any(k.validity is not None for k, _, _ in out[1:])
    want = pd.concat(lparts).merge(pd.concat(rparts), on="k")
    for _, _, got in out:
        _assert_rows(got, want, ordered=False)


def test_gather_table_reconciles_per_rank_dictionaries():
    """Shards ingested apart, gathered: every rank's codes read back as
    the strings that rank ingested."""
    ldf, _ = _frames(59, 120, 8)
    parts = _quarters(ldf)

    def rank(comm):
        env = ct.CylonEnv(comm)
        t = ct.Table.from_pandas(parts[comm.rank], device="cpu")
        return gather_table(env, t).to_pandas()

    for got in ct.ThreadWorld(4).run(rank):
        _assert_rows(got, pd.concat(parts))


def test_world_layout_refuses_mixed_storages():
    """A column stored as device bytes on one rank and as dictionary
    codes on the others (``string_storage="auto"`` decides per rank) is
    no longer refused: every rank converts it to device bytes, at one
    width, and the strings read back as each rank ingested them."""
    vals = np.array(["a", "bb", None], object)
    more = np.array(["a much longer value é", "a", None], object)

    def rank(comm):
        env = ct.CylonEnv(comm)
        t = ct.Table.from_pydict({"k": more if comm.rank == 2 else vals},
                                 device="cpu",
                                 string_storage="bytes" if comm.rank == 2
                                 else "dict")
        k = world_layout(env, t).column("k")
        return repr(k.dtype), gather_table(env, t).to_pandas()

    want = pd.DataFrame({"k": np.concatenate([vals, vals, more, vals])})
    out = ct.ThreadWorld(4).run(rank)
    assert {d for d, _ in out} == {"string[bytes:24]"}
    for _, got in out:
        _assert_rows(got, want)


def test_world_layout_refuses_a_string_against_a_number():
    """A column that is a string on one rank and an integer on the others
    is a dtype mismatch: every rank raises, naming each rank's type."""
    def rank(comm):
        env = ct.CylonEnv(comm)
        k = np.array(["a", "b"], object) if comm.rank == 1 \
            else np.arange(2)
        t = ct.Table.from_pydict({"k": k}, device="cpu",
                                 string_storage="bytes")
        with pytest.raises(InvalidArgument,
                           match=r"'k': \['int64', 'string', 'int64'"):
            world_layout(env, t)
        return True

    assert ct.ThreadWorld(4, timeout=30).run(rank) == [True] * 4


def test_row_copy():
    t = ct.Table.from_pydict({"s": np.array(["é", None], object),
                              "x": np.array([1, 2])}, device="cpu",
                             string_storage="bytes")
    r = t.row(-1)
    assert r.get_string("s") is None and r.get_int64("x") == 2
    assert t.row(0).to_dict() == {"s": "é", "x": 1}
