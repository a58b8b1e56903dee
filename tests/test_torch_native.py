"""The port's native host runtime (``cylon_tpu_torch.native``) case for
case from ``tests/test_native.py``, each held against the JAX package's
``cylon_tpu.native`` on the same seeded inputs (or against pandas where
``ROADMAP.md`` C says the JAX package is wrong): the memory pool,
murmur3, the chunk-parallel CSV parser and ``read_csv(engine="native")``,
the string-id catalog and its host hash join, the catalog bridge, the
C and JNI clients built against the port's header and linked to the
port's library, and the two libraries' separate registries.

Nothing here skips: a host library that does not build fails these
tests. Port tables are built with ``device="cpu"``."""

import ctypes as c
import re
import subprocess
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu import dtypes as jdtypes
from cylon_tpu import native as jnative
from cylon_tpu_torch import Table, catalog, dtypes, io, native
from cylon_tpu_torch.config import CSVReadOptions
from cylon_tpu_torch.errors import InvalidArgument, KeyError_

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "cylon_tpu_torch" / "native"
JAX_DIR = ROOT / "cylon_tpu" / "native"


@pytest.fixture
def lib():
    """The port's library, built here or failing the test."""
    native.catalog_clear()
    jnative.catalog_clear()
    yield native._load()
    native.catalog_clear()
    jnative.catalog_clear()


def _frames_equal(port_table, jax_table):
    pd.testing.assert_frame_equal(port_table.to_pandas(),
                                  jax_table.to_pandas())


# ---------------------------------------------------------------- pool
def test_memory_pool_stats_and_reuse(lib):
    seen = []
    for mod in (native, jnative):
        p = mod.MemoryPool()
        try:
            a = p.alloc(1000)
            assert a != 0
            s1 = p.stats()
            p.free(a, 1000)
            s2 = p.stats()
            b = p.alloc(1000)
            assert b == a  # came from the free list
            s3 = p.stats()
            p.free(b, 1000)
        finally:
            p.close()
        assert s1["bytes_allocated"] == 1024  # 64B-aligned roundup
        assert s2 == {"bytes_allocated": 0, "max_memory": 1024,
                      "num_allocations": 1, "pooled_bytes": 1024}
        assert s3["pooled_bytes"] == 0
        seen.append((s1, s2, s3))
    assert seen[0] == seen[1]


# -------------------------------------------------------------- murmur3
def test_murmur3_known_vectors(lib):
    vectors = [(b"", 0, 0), (b"hello", 0, 0x248BFA47),
               (b"hello, world", 0, 0x149BBB7F),
               (b"The quick brown fox jumps over the lazy dog", 0x9747B28C,
                0x2FA826CD)]
    for data, seed, want in vectors:
        assert native.murmur3_32(data, seed) == want
        assert jnative.murmur3_32(data, seed) == want


def test_murmur3_bulk_matches_scalar(lib, rng):
    keys = np.concatenate([np.array([0, 1, -5, 2**40, -2**50], np.int64),
                           rng.integers(-2**62, 2**62, 995)])
    bulk = native.murmur3_int64(keys, seed=7)
    np.testing.assert_array_equal(bulk, jnative.murmur3_int64(keys, seed=7))
    for i, k in enumerate(keys[:5]):
        assert bulk[i] == native.murmur3_32(
            int(k).to_bytes(8, "little", signed=True), 7)


# ------------------------------------------------------------ csv
@pytest.mark.parametrize("n_threads", [1, 4])
def test_csv_loader_vs_pandas_and_jax(tmp_path, rng, lib, n_threads):
    n = 5000
    pdf = pd.DataFrame({
        "i": rng.integers(-1000, 1000, n),
        "f": rng.normal(size=n).round(6),
        "s": np.array(["v" + str(x) for x in rng.integers(0, 50, n)]),
    })
    path = tmp_path / "data.csv"
    pdf.to_csv(path, index=False)
    t = native.csv_to_table(str(path), n_threads=n_threads, device=CPU)
    pd.testing.assert_frame_equal(t.to_pandas(), pdf, check_dtype=False)
    _frames_equal(t, jnative.csv_to_table(str(path), n_threads=n_threads))
    assert t.device.type == "cpu" and t.capacity == n


def test_csv_loader_nulls(tmp_path, lib):
    path = tmp_path / "n.csv"
    path.write_text("a,b,s\n1,1.5,x\n2,,y\n,3.5,\n")
    t = native.csv_to_table(str(path), device=CPU)
    d = t.to_pydict()
    assert d["a"] == [1, 2, None]
    assert d["b"][0] == 1.5 and d["b"][2] == 3.5 and d["b"][1] != d["b"][1]
    assert d["s"] == ["x", "y", None]
    for name in ("a", "b", "s"):
        assert t.column(name).validity.tolist() == \
            jnative.csv_to_table(str(path)).column(name).validity.tolist()
    _frames_equal(t, jnative.csv_to_table(str(path)))


def test_csv_string_dictionary_sorted(tmp_path, lib):
    path = tmp_path / "s.csv"
    path.write_text("s\nzebra\napple\nmango\napple\n")
    t = native.csv_to_table(str(path), device=CPU)
    vals = list(t.column("s").dictionary.values)
    assert vals == sorted(vals)
    assert vals == list(jnative.csv_to_table(str(path)).columns["s"]
                        .dictionary.values)
    assert t.column("s").dtype == dtypes.string
    assert t.to_pydict()["s"] == ["zebra", "apple", "mango", "apple"]


def test_csv_crlf_and_empty_lines(tmp_path, lib):
    path = tmp_path / "c.csv"
    path.write_bytes(b"a,b\r\n1,2\r\n\r\n3,4\r\n")
    t = native.csv_to_table(str(path), device=CPU)
    assert t.to_pydict() == {"a": [1, 3], "b": [2, 4]}
    assert t.to_pydict() == jnative.csv_to_table(str(path)).to_pydict()


@pytest.mark.parametrize("strings_can_be_null", [False, True])
def test_csv_quotes_na_values_and_column_types(tmp_path, lib,
                                               strings_can_be_null):
    """Quoted fields with the delimiter and doubled quotes inside, null
    spellings (for strings only with ``strings_can_be_null``) and dtype
    overrides: the port's parse equals JAX's and the arrow engine's."""
    path = tmp_path / "q.csv"
    path.write_text('k,c,v,d\n1,"a, b",1.5,1995-03-15\n'
                    '2,"say ""hi""",NA,1996-01-02\n3,plain,2.5,NA\n')
    kw = dict(quote_char='"', na_values=["NA"],
              column_types={"k": "float64", "d": "str"},
              strings_can_be_null=strings_can_be_null)
    t = native.csv_to_table(str(path), device=CPU, **kw)
    _frames_equal(t, jnative.csv_to_table(str(path), **kw))
    d = t.to_pydict()
    assert d["c"] == ["a, b", 'say "hi"', "plain"]
    assert d["k"] == [1.0, 2.0, 3.0] and d["v"][1] != d["v"][1]
    assert d["d"] == ["1995-03-15", "1996-01-02",
                      None if strings_can_be_null else "NA"]
    opts = CSVReadOptions(na_values=["NA"],
                          column_types={"k": "float64", "d": "str"},
                          strings_can_be_null=strings_can_be_null)
    arrow = io.read_csv(str(path), opts, engine="arrow", device=CPU)
    pd.testing.assert_frame_equal(
        io.read_csv(str(path), opts, engine="native",
                    device=CPU).to_pandas(), arrow.to_pandas())


def test_read_csv_native_engine(tmp_path, lib):
    path = tmp_path / "e.csv"
    path.write_text("a,b\n1,2.5\n3,4.5\n")
    df = io.read_csv(str(path), engine="native", device=CPU)
    assert df.to_pandas()["a"].tolist() == [1, 3]
    pd.testing.assert_frame_equal(
        df.to_pandas(), jct.io.read_csv(str(path), engine="native")
        .to_pandas(), check_dtype=False)
    df2 = io.read_csv([str(path), str(path)], engine="native", device=CPU)
    assert len(df2) == 4
    assert df2.to_pandas()["b"].tolist() == [2.5, 4.5, 2.5, 4.5]
    cols = io.read_csv(str(path), CSVReadOptions(use_cols=["b"]),
                       engine="native", device=CPU)
    assert list(cols.to_pandas().columns) == ["b"]


def test_read_csv_auto_routes_plain_reads_to_native(tmp_path, lib,
                                                    monkeypatch):
    """``"auto"`` takes the native engine for plain options and arrow
    otherwise, as ``cylon_tpu/io/__init__.py:139`` does."""
    calls = []
    real = native.csv_to_table
    monkeypatch.setattr(native, "csv_to_table",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    path = tmp_path / "r.csv"
    path.write_text("junk\na,b\n1,x\n2,y\n")
    plain = io.read_csv(str(path), CSVReadOptions(), device=CPU)
    assert calls == [str(path)]
    skipped = io.read_csv(str(path), CSVReadOptions(skip_rows=1),
                          device=CPU)
    assert calls == [str(path)]  # skip_rows is not plain: arrow read it
    assert skipped.to_dict() == {"a": [1, 2], "b": ["x", "y"]}
    assert plain.to_dict() == {"junk": ["a", "1", "2"]}


def test_native_engine_raises_the_build_error(tmp_path, monkeypatch):
    """A library that does not build fails the native engine and every
    binding with the compiler's error; ``"auto"`` routes to arrow."""
    bad = tmp_path / "cylon_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_SOURCES", (bad, PORT_DIR / "cylon_host.h"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    path = tmp_path / "f.csv"
    path.write_text("a\n1\n")
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        io.read_csv(str(path), engine="native", device=CPU)
    with pytest.raises(native.NativeBuildError):
        native.catalog_ids()
    assert not native.available()
    assert "native build failed" in native.build_error()
    assert io.read_csv(str(path), device=CPU).to_dict() == {"a": [1]}


# ---------------------------------------------------------------- catalog
def _round_trip(df, tid="t", **kw):
    """The port's and JAX's catalog round trips of ``df``."""
    native.catalog_put(tid, Table.from_pandas(df, device=CPU, **kw))
    jnative.catalog_put(tid, jct.Table.from_pandas(df))
    return (native.catalog_get(tid, device=CPU),
            jnative.catalog_get(tid))


def test_catalog_roundtrip_numeric(lib, rng):
    df = pd.DataFrame({
        "i": rng.integers(-100, 100, 50).astype(np.int64),
        "f": rng.normal(size=50),
        "b": rng.integers(0, 2, 50).astype(bool),
        "i8": rng.integers(-100, 100, 50).astype(np.int8),
        "u32": rng.integers(0, 2**32, 50).astype(np.uint32),
        "f32": rng.normal(size=50).astype(np.float32),
    })
    got, jgot = _round_trip(df)
    pd.testing.assert_frame_equal(got.to_pandas(), df)
    _frames_equal(got, jgot)


def test_catalog_roundtrip_strings_and_nulls(lib):
    df = pd.DataFrame({
        "s": ["apple", None, "cherry", "apple", "beta"],
        "x": [1.0, 2.0, np.nan, 4.0, 5.0],
    })
    got, jgot = _round_trip(df, "t2")
    pd.testing.assert_frame_equal(got.to_pandas(), df)
    _frames_equal(got, jgot)
    assert got.column("s").dictionary == \
        type(got.column("s").dictionary)(jgot.column("s").dictionary.values)


def test_catalog_list_remove(lib):
    t = Table.from_pydict({"a": [1, 2, 3]}, device=CPU)
    native.catalog_put("x", t)
    native.catalog_put("y", t)
    assert native.catalog_ids() == ["x", "y"]
    native.catalog_remove("x")
    assert native.catalog_ids() == ["y"]
    with pytest.raises(KeyError_):
        native.catalog_remove("x")
    with pytest.raises(KeyError_):
        native.catalog_get("zz", device=CPU)


def test_catalog_overwrite(lib):
    native.catalog_put("t", Table.from_pydict({"a": [1, 2]}, device=CPU))
    native.catalog_put("t", Table.from_pydict({"a": [9, 8, 7]}, device=CPU))
    got = native.catalog_get("t", device=CPU).to_pandas()
    assert got["a"].tolist() == [9, 8, 7]


def test_catalog_timestamp_and_day_units(lib):
    df = pd.DataFrame({"ts": pd.to_datetime(
        ["2026-01-01", "2026-06-15", "2026-07-30"])})
    got, jgot = _round_trip(df, "tt")
    assert got.column("ts").dtype.kind.name == "TIMESTAMP"
    assert repr(got.column("ts").dtype) == repr(jgot.column("ts").dtype)
    _frames_equal(got, jgot)
    arr = np.array(["2026-01-01", "2026-07-30"], dtype="datetime64[D]")
    t = Table.from_pydict({"d": arr}, device=CPU)
    native.catalog_put("days", t)
    t2 = native.catalog_get("days", device=CPU)
    assert t2.column("d").dtype == t.column("d").dtype
    assert str(t2.to_pandas()["d"].iloc[1])[:10] == "2026-07-30"
    jnative.catalog_put("days", jct.Table.from_pydict({"d": arr}))
    _frames_equal(t2, jnative.catalog_get("days"))


def test_catalog_long_column_name(lib):
    name = "c" * 600  # > the 512-byte first-try buffer in catalog_get
    t = Table.from_pydict({name: [1, 2, 3], name[:-1] + "X": [4, 5, 6]},
                          device=CPU)
    native.catalog_put("long", t)
    got = native.catalog_get("long", device=CPU).to_pandas()
    assert got[name].tolist() == [1, 2, 3]
    assert got[name[:-1] + "X"].tolist() == [4, 5, 6]


def _put_raw(lib_, tid, names, tags, nrows, bufs, lens=None, valids=None):
    c_names = (c.c_char_p * len(names))(*[s.encode() for s in names])
    c_tags = (c.c_int32 * len(tags))(*tags)
    c_bufs = (c.c_void_p * len(bufs))(
        *[b.ctypes.data_as(c.c_void_p).value for b in bufs])
    c_lens = (c.c_int64 * len(bufs))(
        *(lens if lens is not None else [b.nbytes for b in bufs]))
    c_vals = None
    if valids is not None:
        c_vals = (c.c_void_p * len(bufs))(
            *[None if v is None else v.ctypes.data_as(c.c_void_p).value
              for v in valids])
    return lib_.cylon_catalog_put(tid.encode(), len(names), c_names,
                                  c_tags, nrows, c_bufs, c_lens, c_vals)


def test_catalog_unaligned_foreign_column_rejected(lib):
    buf = np.zeros(12, np.uint8)  # an int64 column of 12 bytes
    assert _put_raw(lib, "badt", ["bad"], [native._dtype_tag(dtypes.int64)],
                    1, [buf]) == 0
    with pytest.raises(InvalidArgument, match="not a multiple"):
        native.catalog_get("badt", device=CPU)


def _copy_image(src_lib, dst_lib, tid):
    """Copy one catalog image between two libraries through the C ABI:
    its names, tags, bytes and validity, untouched."""
    n = src_lib.cylon_catalog_rows(tid.encode())
    names, tags, bufs, valids = [], [], [], []
    for i in range(src_lib.cylon_catalog_ncols(tid.encode())):
        name = c.create_string_buffer(4096)
        tag, nbytes, hasv = c.c_int32(), c.c_int64(), c.c_int32()
        assert src_lib.cylon_catalog_col_info(
            tid.encode(), i, name, 4096, c.byref(tag), c.byref(nbytes),
            c.byref(hasv)) >= 0
        data = np.empty(nbytes.value, np.uint8)
        v = np.empty(n, np.uint8) if hasv.value else None
        assert src_lib.cylon_catalog_col_read(
            tid.encode(), i, data.ctypes.data_as(c.c_void_p), data.nbytes,
            None if v is None else v.ctypes.data_as(c.c_void_p)) == 0
        names.append(name.value.decode())
        tags.append(tag.value)
        bufs.append(data)
        valids.append(v)
    assert _put_raw(dst_lib, tid, names, tags, n, bufs, valids=valids) == 0


def test_catalog_images_read_the_same_in_either_binding(lib, rng):
    """An image the JAX binding wrote reads in the port's binding as the
    JAX binding reads it, and the other way round: the tags (Kind and
    unit) and the dictionary wire format agree."""
    df = pd.DataFrame({
        "k": rng.integers(0, 9, 20).astype(np.int64),
        "v": rng.normal(size=20),
        "s": rng.choice(["ant", "bee", "cat", None], 20),
        "d": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 400, 20), unit="D"),
        "n": rng.integers(0, 100, 20).astype(np.int16),
    })
    jlib = jnative._load()
    jnative.catalog_put("j", jct.Table.from_pandas(df))
    _copy_image(jlib, lib, "j")
    _frames_equal(native.catalog_get("j", device=CPU),
                  jnative.catalog_get("j"))
    native.catalog_put("p", Table.from_pandas(df, device=CPU))
    _copy_image(lib, jlib, "p")
    _frames_equal(native.catalog_get("p", device=CPU),
                  jnative.catalog_get("p"))
    pd.testing.assert_frame_equal(
        native.catalog_get("p", device=CPU).to_pandas(), df)


def test_two_libraries_keep_two_registries(lib):
    """Both libraries export the same ``cylon_*`` symbols; each keeps
    its own registry, so a put through one package is absent from the
    other's ids."""
    native.catalog_put("only_port", Table.from_pydict({"a": [1]},
                                                      device=CPU))
    jnative.catalog_put("only_jax", jct.Table.from_pydict({"a": [2]}))
    assert native.catalog_ids() == ["only_port"]
    assert jnative.catalog_ids() == ["only_jax"]
    with pytest.raises(KeyError):
        jnative.catalog_get("only_port")
    with pytest.raises(KeyError_):
        native.catalog_get("only_jax", device=CPU)
    native.catalog_clear()
    assert jnative.catalog_ids() == ["only_jax"]


def test_bytes_storage_column_refused_and_cast_round_trips(lib):
    """A string column in device-bytes storage has no image in the wire
    format (the JAX binding writes its words as one flat buffer and
    cannot read it back): the port refuses it by name, and the column
    cast to dictionary storage round trips equal to pandas."""
    df = pd.DataFrame({"s": ["apple", "banana", None, "kiwi"],
                       "x": [1, 2, 3, 4]})
    t = Table.from_pandas(df, device=CPU, string_storage="bytes")
    assert t.column("s").dtype.is_bytes
    with pytest.raises(InvalidArgument, match="'s'.*dictionary storage"):
        native.catalog_put("b", t)
    assert native.catalog_ids() == []
    catalog.put_table("b", t)
    try:
        with pytest.raises(InvalidArgument, match="'s'"):
            catalog.to_native("b")
    finally:
        catalog.clear()
    cast = t.add_column("s", t.column("s").astype(dtypes.string))
    native.catalog_put("b", cast)
    got = native.catalog_get("b", device=CPU).to_pandas()
    pd.testing.assert_frame_equal(got, df)
    # the JAX binding's image of the same bytes column is not readable
    jt = jct.Table.from_pandas(df, string_storage="bytes")
    jnative.catalog_put("b", jt)
    with pytest.raises(Exception):
        jnative.catalog_get("b").to_pandas()


def test_catalog_bridge_matches_jax(lib, rng):
    """``catalog.to_native`` / ``from_native`` against the JAX
    package's bridge on the same table."""
    from cylon_tpu import catalog as jcat

    df = pd.DataFrame({"k": rng.integers(0, 5, 30),
                       "s": rng.choice(["x", "y", None], 30),
                       "v": rng.normal(size=30)})
    catalog.put_table("br", Table.from_pandas(df, device=CPU))
    jcat.put_table("br", jct.Table.from_pandas(df))
    try:
        catalog.to_native("br")
        jcat.to_native("br")
        catalog.clear()
        jcat.clear()
        catalog.from_native("br", device=CPU)
        jcat.from_native("br")
        _frames_equal(catalog.get_table("br"), jcat.get_table("br"))
        pd.testing.assert_frame_equal(
            catalog.get_table("br").to_pandas(), df, check_dtype=False)
    finally:
        catalog.clear()
        jcat.clear()


# -------------------------------------------------------- the C ABI
def _sigs(text):
    out = {}
    for m in re.finditer(
            r"(?:^|\n)\s*((?:const\s+)?[\w*]+\**)\s+(cylon_\w+)"
            r"\s*\(([^)]*)\)", text):
        args = re.sub(r"\s+", " ", m.group(3)).strip()
        parts = []
        for a in args.split(","):
            a = a.strip()
            if not a or a == "void":
                continue
            toks = a.split(" ")
            if len(toks) > 1 and not toks[-1].startswith("*"):
                a = " ".join(toks[:-1]) + "*" * toks[-1].count("*")
            parts.append(a.replace(" *", "*").replace("* ", "*"))
        out[m.group(2)] = (m.group(1), tuple(parts))
    return out


def _code_of(text: str) -> str:
    """The source with its comments and blank runs taken out."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return "\n".join(ln.rstrip() for ln in text.splitlines() if ln.strip())


def test_header_matches_abi_and_the_jax_one():
    """``cylon_host.h`` declares exactly the extern-C surface of
    ``cylon_host.cpp``, the same surface as the JAX package's; and both
    sources differ from the JAX package's in comments only."""
    cpp = _sigs((PORT_DIR / "cylon_host.cpp").read_text())
    hdr = _sigs((PORT_DIR / "cylon_host.h").read_text())
    assert cpp, "no extern-C symbols found in cpp"
    mismatched = {n for n in set(cpp) | set(hdr) if cpp.get(n) != hdr.get(n)}
    assert not mismatched, mismatched
    assert hdr == _sigs((JAX_DIR / "cylon_host.h").read_text())
    for name in ("cylon_host.cpp", "cylon_host.h"):
        assert _code_of((PORT_DIR / name).read_text()) == \
            _code_of((JAX_DIR / name).read_text()), name


def test_library_builds_into_the_port_build_dir(lib):
    path = native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "cylon_tpu_torch" / "_build"
    assert re.fullmatch(r"libcylon_host_[0-9a-f]{16}\.so", path.name)


def test_catalog_pure_c_client(lib, tmp_path):
    """A non-Python FFI host drives the port's catalog ABI directly,
    linked to the port's library by full path."""
    src = tmp_path / "client.c"
    src.write_text(r'''
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include "%HEADER%"
int main(void) {
  int64_t ids[4] = {10, 20, 30, 40};
  double vs[4] = {1.5, 2.5, 3.5, 4.5};
  const char* names[2] = {"id", "v"};
  int32_t dtypes[2] = {%TAG_I64%, %TAG_F64%};
  const void* bufs[2] = {ids, vs};
  int64_t lens[2] = {sizeof ids, sizeof vs};
  if (cylon_catalog_put("cclient", 2, names, dtypes, 4, bufs, lens, 0))
    return 1;
  if (cylon_catalog_rows("cclient") != 4) return 2;
  int64_t back[4];
  if (cylon_catalog_col_read("cclient", 0, back, sizeof back, 0)) return 3;
  if (memcmp(back, ids, sizeof ids)) return 4;
  puts("C CLIENT OK");
  return 0;
}
'''.replace("%HEADER%", str(PORT_DIR / "cylon_host.h"))
       .replace("%TAG_I64%", str(native._dtype_tag(dtypes.int64)))
       .replace("%TAG_F64%", str(native._dtype_tag(dtypes.float64))))
    assert native._dtype_tag(dtypes.int64) == \
        jnative._dtype_tag(jdtypes.int64)
    exe = tmp_path / "client"
    subprocess.run(["gcc", str(src), str(native.library_path()), "-o",
                    str(exe)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, (out.returncode, out.stderr)
    assert "C CLIENT OK" in out.stdout


def _against_port_header(src: Path, dst: Path) -> Path:
    """A copy of ``src`` whose include of the JAX package's header names
    the port's header."""
    text = src.read_text()
    text, k = re.subn(r'#include "[./]*cylon_tpu/native/cylon_host\.h"',
                      f'#include "{PORT_DIR / "cylon_host.h"}"', text)
    assert k == 1, src
    dst.write_text(text)
    return dst


def test_c_client_round_trip(lib, tmp_path):
    """``examples/native/catalog_client.c`` built against the port's
    header, linked to the port's library by full path, runs its put,
    join and read back."""
    src = _against_port_header(ROOT / "examples/native/catalog_client.c",
                               tmp_path / "catalog_client.c")
    exe = tmp_path / "catalog_client"
    subprocess.run(["gcc", "-O2", "-Wall", "-Werror", str(src),
                    str(native.library_path()), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    assert "NATIVE-FFI-OK" in r.stdout


def test_jni_shim_builds_against_the_port(lib, tmp_path):
    """``java/src/main/native/cylon_jni.c`` compiles against the stub
    ``jni.h`` of ``tests/test_java.py`` and the port's header, and links
    to the port's library, every ``cylon_*`` symbol it needs found
    there."""
    from test_java import _STUB_JNI_H

    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "jni.h").write_text(_STUB_JNI_H)
    src = _against_port_header(ROOT / "java/src/main/native/cylon_jni.c",
                               tmp_path / "cylon_jni.c")
    so = tmp_path / "libcylon_jni.so"
    for cmd in (["-fsyntax-only", "-Wall", "-Werror"],
                ["-O2", "-shared", "-fPIC", "-o", str(so),
                 str(native.library_path()), "-Wl,--no-undefined"]):
        proc = subprocess.run(["gcc", f"-I{inc}", str(src), *cmd],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
    c.CDLL(str(so), mode=c.RTLD_LOCAL)


# -------------------------------------------------------- the host join
def test_native_catalog_join_vs_pandas(lib):
    """The native host hash join against the pandas oracle, nulls
    included, in every join type."""
    rng = np.random.default_rng(5)
    n, m = 300, 200
    lk = rng.integers(0, 40, n).astype(np.int64)
    lv = rng.normal(size=n)
    lv_valid = (rng.random(n) > 0.1).astype(np.uint8)
    rk = rng.integers(0, 40, m).astype(np.int64)
    rw = rng.normal(size=m)
    assert _put_raw(lib, "L", ["k", "v"], [0, 1], n, [lk, lv],
                    valids=[None, lv_valid]) == 0
    assert _put_raw(lib, "R", ["k", "w"], [0, 1], m, [rk, rw]) == 0
    ldf = pd.DataFrame({"k": lk, "v": np.where(lv_valid.astype(bool), lv,
                                                np.nan)})
    rdf = pd.DataFrame({"k": rk, "w": rw})
    key = (c.c_int32 * 1)(0)
    for jt, how in ((0, "inner"), (1, "left"), (2, "right"), (3, "outer")):
        assert lib.cylon_catalog_join(b"L", b"R", b"J", 1, key, key, jt) == 0
        want = ldf.merge(rdf, on="k", how=how)
        rows = lib.cylon_catalog_rows(b"J")
        assert rows == len(want), how
        outs = []
        for i, dt in enumerate((np.int64, np.float64, np.float64)):
            data = np.empty(rows, dt)
            val = np.ones(rows, np.uint8)
            assert lib.cylon_catalog_col_read(
                b"J", i, data.ctypes.data_as(c.c_void_p), data.nbytes,
                val.ctypes.data_as(c.c_void_p)) >= 0
            outs.append(np.where(val.astype(bool), data.astype(float),
                                 np.nan))
        cols = ["k", "v", "w"]
        got = pd.DataFrame(dict(zip(cols, outs))).sort_values(cols) \
            .reset_index(drop=True)
        want = want[cols].astype(float).sort_values(cols) \
            .reset_index(drop=True)
        pd.testing.assert_frame_equal(got, want)


def test_native_join_differing_key_names(lib):
    a = np.array([1, 2, 3], np.int64)
    b = np.array([2, 4], np.int64)
    i64 = native._dtype_tag(dtypes.int64)
    assert _put_raw(lib, "A", ["a"], [i64], 3, [a]) == 0
    assert _put_raw(lib, "B", ["b"], [i64], 2, [b]) == 0
    k0 = (c.c_int32 * 1)(0)
    assert lib.cylon_catalog_join(b"A", b"B", b"J", 1, k0, k0, 3) == 0
    assert lib.cylon_catalog_rows(b"J") == 4
    assert lib.cylon_catalog_ncols(b"J") == 2  # both key columns kept
    got = native.catalog_get("J", device=CPU).to_pydict()
    pairs = set(zip(got["a"], got["b"]))
    assert pairs == {(1, None), (2, 2), (3, None), (None, 4)}


def test_native_catalog_join_cross_binding_string_tags(lib):
    """The JNI writes raw tag 2 for string codes while the Python
    bindings write Kind.STRING (12): the join unifies the sidecar
    dictionaries by value; a side without sidecars is refused."""
    native.catalog_put("L", Table.from_pydict(
        {"k": np.array(["a", "c", "c"], object),
         "v": np.array([1.0, 2.0, 3.0])}, device=CPU))
    rvals = ["b", "c"]
    codes = np.array([0, 1, 1], np.int32)
    blob = np.frombuffer(b"".join(v.encode() for v in rvals), np.uint8)
    offs = np.array([0, 1, 2], np.int64)
    assert _put_raw(lib, "R", ["k", "k\x01blob", "k\x01offs"], [2, 1, 8], 3,
                    [codes, blob.copy(), offs]) == 0
    key = (c.c_int32 * 1)(0)
    assert lib.cylon_catalog_join(b"L", b"R", b"J", 1, key, key, 0) == 0
    got = native.catalog_get("J", device=CPU).to_pandas()
    assert len(got) == 4
    assert set(got["k"]) == {"c"} and set(got["v"]) == {2.0, 3.0}
    assert _put_raw(lib, "R2", ["k"], [2], 3, [codes]) == 0
    assert lib.cylon_catalog_join(b"L", b"R2", b"J2", 1, key, key, 0) == -4


def _both_joined(lt_data, rt_data):
    """The native join (inner, key column 0) of the same two tables
    published by each binding into its own library, read back by each."""
    out = []
    for mod, mk in ((native, lambda d: Table.from_pydict(d, device=CPU)),
                    (jnative, jct.Table.from_pydict)):
        mod.catalog_put("L", mk(lt_data))
        mod.catalog_put("R", mk(rt_data))
        key = (c.c_int32 * 1)(0)
        assert mod._load().cylon_catalog_join(b"L", b"R", b"J", 1, key,
                                              key, 0) == 0
        got = (mod.catalog_get("J", device=CPU) if mod is native
               else mod.catalog_get("J")).to_pandas()
        out.append(got.sort_values(list(got.columns))
                   .reset_index(drop=True))
    pd.testing.assert_frame_equal(out[0], out[1])
    return out[0]


def test_native_catalog_join_string_keys_unifies_dictionaries(lib):
    lt = {"k": np.array(["a", "c", "c"], object),
          "v": np.array([1.0, 2.0, 3.0])}
    rt = {"k": np.array(["b", "c"], object), "w": np.array([10.0, 20.0])}
    got = _both_joined(lt, rt)
    want = pd.DataFrame(lt).merge(pd.DataFrame(rt), on="k", how="inner")
    pd.testing.assert_frame_equal(
        got, want.sort_values(list(want.columns)).reset_index(drop=True))
    assert set(got["k"]) == {"c"}


def test_native_catalog_join_dict_value_columns_survive(lib):
    lt = {"k": np.arange(4, dtype=np.int64),
          "name": np.array(["x", "y", "x", "z"], object)}
    rt = {"k": np.array([2, 3, 5], np.int64),
          "tag": np.array(["p", "q", "r"], object)}
    got = _both_joined(lt, rt)
    want = pd.DataFrame(lt).merge(pd.DataFrame(rt), on="k", how="inner")
    pd.testing.assert_frame_equal(
        got, want.sort_values(list(want.columns)).reset_index(drop=True))


@pytest.mark.parametrize("dt", [np.int8, np.uint8, np.bool_, np.int16,
                                np.int32])
def test_native_catalog_join_narrow_int_keys(lib, dt):
    rng = np.random.default_rng(23)
    hi = 2 if dt == np.bool_ else 50
    lk = rng.integers(0, hi, 400).astype(dt)
    rk = rng.integers(0, hi, 300).astype(dt)
    got = _both_joined({"k": lk, "v": rng.normal(size=400)},
                       {"k": rk, "w": rng.normal(size=300)})
    want = pd.DataFrame({"k": lk}).merge(pd.DataFrame({"k": rk}), on="k")
    assert len(got) == len(want)
    assert sorted(got["k"].astype(np.int64).tolist()) == sorted(
        want["k"].astype(np.int64).tolist())


def test_native_catalog_join_rejects_missized_key(lib):
    short = np.arange(3, dtype=np.int64)
    assert _put_raw(lib, "L", ["k"], [0], 3, [short],
                    lens=[short.nbytes - 5]) == 0
    assert _put_raw(lib, "R", ["k"], [0], 3, [np.arange(3, dtype=np.int64)]
                    ) == 0
    key = (c.c_int32 * 1)(0)
    assert lib.cylon_catalog_join(b"L", b"R", b"J", 1, key, key, 0) == -4
