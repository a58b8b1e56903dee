"""The port's io (CSV, Parquet, JSON lines; one file or many; a rank a
file) against the JAX package's on the same files in ``tmp_path``, on
the CPU: the cases of ``tests/test_io.py`` that use no resilience hook,
each read compared with the JAX package's read of the same file and with
pandas (the native engine's own cases are in ``test_torch_native.py``); ``read_csv_sharded`` and
``write_csv_sharded`` at W = 4 on ``ThreadWorld``.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu.io as jio
import cylon_tpu_torch as ct
from cylon_tpu.config import CSVReadOptions as JCSVReadOptions
from cylon_tpu.config import ParquetOptions as JParquetOptions
from cylon_tpu_torch import io
from cylon_tpu_torch.config import CSVReadOptions, ParquetOptions
from cylon_tpu_torch.errors import (InvalidArgument, IOError_,
                                    NotImplemented_)
from cylon_tpu_torch.parallel.comm import ThreadWorld

CPU = "cpu"


def _world(fn, w: int = 4):
    return ThreadWorld(w).run(lambda comm: fn(ct.CylonEnv(comm)))


@pytest.fixture
def sample_df(rng):
    return pd.DataFrame({"k": rng.integers(0, 100, 50),
                         "v": rng.normal(size=50).round(6),
                         "s": rng.choice(["red", "green", "blue"], 50)})


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _both_csv(path, opts=None, **kw):
    """The port's and the JAX package's read of one CSV (arrow engine)."""
    mine = io.read_csv(path, opts and CSVReadOptions(**opts), device=CPU,
                       **kw)
    theirs = jio.read_csv(path, opts and JCSVReadOptions(**opts),
                          engine="arrow", **kw)
    pd.testing.assert_frame_equal(mine.to_pandas(), theirs.to_pandas())
    return mine


def test_csv_roundtrip(tmp_path, sample_df):
    p = tmp_path / "t.csv"
    sample_df.to_csv(p, index=False)
    df = _both_csv(str(p))
    pd.testing.assert_frame_equal(df.to_pandas(), sample_df,
                                  check_dtype=False)
    out = tmp_path / "out.csv"
    io.write_csv(df, str(out))
    pd.testing.assert_frame_equal(pd.read_csv(out), sample_df,
                                  check_dtype=False)
    df.to_csv(str(out))
    pd.testing.assert_frame_equal(pd.read_csv(out), sample_df,
                                  check_dtype=False)


def test_csv_multifile_threaded(tmp_path, sample_df):
    paths = []
    for i, part in enumerate([sample_df.iloc[0:20], sample_df.iloc[20:35],
                              sample_df.iloc[35:]]):
        p = tmp_path / f"part{i}.csv"
        part.to_csv(p, index=False)
        paths.append(str(p))
    df = _both_csv(paths)
    pd.testing.assert_frame_equal(df.to_pandas(),
                                  sample_df.reset_index(drop=True),
                                  check_dtype=False)


def test_csv_options(tmp_path):
    p = _write(tmp_path, "t.tsv", "a\t b\n1\t2\n3\t4\n")
    assert len(_both_csv(p, dict(delimiter="\t"))) == 2


def test_csv_distributed(tmp_path, sample_df):
    p = tmp_path / "t.csv"
    sample_df.to_csv(p, index=False)

    def rank(env):
        df = io.read_csv(str(p), env=env, device=CPU)
        return df.is_distributed, len(df), df.to_pandas()

    for dist, n, got in _world(rank):
        assert dist and n == 50
        pd.testing.assert_frame_equal(got, sample_df, check_dtype=False)


def test_csv_missing_file():
    with pytest.raises(IOError_):
        io.read_csv("/nonexistent/file.csv", device=CPU)


def test_csv_engines(tmp_path):
    """Every engine reads the file as the JAX package's native read
    does; the native engine refuses options it cannot honour."""
    p = _write(tmp_path, "e.csv", "a,s\n1,x\n2,y\n")
    want = jio.read_csv(p, engine="native").to_pandas()
    for engine in ("native", "auto", "arrow"):
        got = io.read_csv(p, engine=engine, device=CPU)
        assert got.to_dict() == {"a": [1, 2], "s": ["x", "y"]}, engine
        pd.testing.assert_frame_equal(got.to_pandas(), want,
                                      check_dtype=False)
    with pytest.raises(NotImplemented_, match="native csv engine"):
        io.read_csv(p, CSVReadOptions(skip_rows=1), engine="native",
                    device=CPU)
    with pytest.raises(InvalidArgument):
        io.read_csv(p, engine="pandas", device=CPU)


def test_readers_default_to_cuda(tmp_path, monkeypatch):
    import torch

    p = _write(tmp_path, "d.csv", "a\n1\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: io.read_csv(p), lambda: io.read_csv_chunks(p, 4),
               lambda: io.read_json(p), lambda: ct.DataFrame({"a": [1]}),
               lambda: ct.Series([1, 2])):
        with pytest.raises(ct.DeviceUnavailable):
            fn()


def test_parquet_roundtrip(tmp_path, sample_df):
    p = tmp_path / "t.parquet"
    sample_df.to_parquet(p)
    df = io.read_parquet(str(p), device=CPU)
    pd.testing.assert_frame_equal(df.to_pandas(),
                                  jio.read_parquet(str(p)).to_pandas())
    pd.testing.assert_frame_equal(df.to_pandas(), sample_df,
                                  check_dtype=False)
    out = tmp_path / "o.parquet"
    io.write_parquet(df, str(out))
    pd.testing.assert_frame_equal(pd.read_parquet(out), sample_df,
                                  check_dtype=False)


def test_parquet_columns(tmp_path, sample_df):
    p = tmp_path / "t.parquet"
    sample_df.to_parquet(p)
    assert io.read_parquet(str(p), columns=["k", "s"], device=CPU) \
        .columns == jio.read_parquet(str(p), columns=["k", "s"]).columns \
        == ["k", "s"]


def test_json_lines(tmp_path):
    p = _write(tmp_path, "t.jsonl", '{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n')
    got = io.read_json(p, device=CPU).to_dict()
    assert got == jio.read_json(p).to_dict() == {"a": [1, 2],
                                                 "b": ["x", "y"]}


# ---------------------------------------------------------- sharded ingest
def _shard_files(tmp_path, rng, w=4):
    frames, paths = [], []
    for s in range(w):
        n = int(rng.integers(3, 40))
        pdf = pd.DataFrame({
            "k": rng.integers(0, 50, n), "v": rng.normal(size=n).round(6),
            # values that differ a file: dictionaries must unify
            "s": [f"name{int(x)}" for x in rng.integers(s, s + 20, n)]})
        p = tmp_path / f"part_{s}.csv"
        pdf.to_csv(p, index=False)
        frames.append(pdf)
        paths.append(str(p))
    return frames, paths


def test_read_csv_sharded_parity(tmp_path, rng, env4):
    """Rank r parses paths[r]; the gathered frame is the concatenation in
    file order, as the JAX package's read on the 4-device mesh."""
    frames, paths = _shard_files(tmp_path, rng)
    want = pd.concat(frames).reset_index(drop=True)
    jgot = jio.read_csv_sharded(paths, env4).to_pandas()
    pd.testing.assert_frame_equal(jgot.reset_index(drop=True), want,
                                  check_dtype=False)

    def rank(env):
        df = io.read_csv_sharded(paths, env, device=CPU)
        return (df.is_distributed, df.table.num_rows, df.table.capacity,
                df.to_pandas())

    res = _world(rank)
    for r, (dist, n, cap, got) in enumerate(res):
        assert dist and n == len(frames[r])
        assert cap == res[0][2] >= max(len(f) for f in frames)
        pd.testing.assert_frame_equal(got, want, check_dtype=False)
        pd.testing.assert_frame_equal(got, jgot.reset_index(drop=True))


def test_read_csv_sharded_feeds_shard_local_ops(tmp_path, monkeypatch):
    """The sharded frame goes straight into rank-local ops and a
    distributed group-by: no gather."""
    from cylon_tpu_torch import frame as frame_mod

    paths = []
    for s in range(4):
        p = tmp_path / f"p{s}.csv"
        pd.DataFrame({"k": np.arange(s, s + 10),
                      "v": np.full(10, float(s))}).to_csv(p, index=False)
        paths.append(str(p))
    gathered = []
    real = frame_mod.gather_table
    monkeypatch.setattr(frame_mod, "gather_table",
                        lambda env, t: gathered.append(1) or real(env, t))

    def rank(env):
        df = io.read_csv_sharded(paths, env, device=CPU)
        f = df.filter(df["k"] >= 5)
        g = f.groupby(["v"], env=env).agg([("k", "sum", "ks")])
        none_yet = not gathered
        return none_yet, g.to_pandas()

    exp = pd.concat([pd.DataFrame({"k": np.arange(s, s + 10),
                                   "v": np.full(10, float(s))})
                     for s in range(4)])
    exp = exp[exp.k >= 5].groupby("v")["k"].sum().reset_index(name="ks")
    for none_yet, got in _world(rank):
        assert none_yet
        pd.testing.assert_frame_equal(
            got.sort_values("v").reset_index(drop=True), exp,
            check_dtype=False)


def test_read_csv_sharded_wrong_count_and_schema(tmp_path):
    p = _write(tmp_path, "x.csv", "a\n1\n")
    q = _write(tmp_path, "y.csv", "b\n1\n")
    with pytest.raises(InvalidArgument):
        _world(lambda env: io.read_csv_sharded([p] * 3, env, device=CPU))
    with pytest.raises(InvalidArgument, match="disagree"):
        _world(lambda env: io.read_csv_sharded([p, p, q, p], env,
                                               device=CPU))


def test_write_csv_sharded_roundtrip(tmp_path, rng):
    """Rank r writes its shard to paths[r]; the parts read back in rank
    order give the distributed frame."""
    n = 500
    df = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                       "v": rng.normal(size=n),
                       "s": rng.choice(["x", "yy", None], n)})
    paths = [str(tmp_path / f"part{s}.csv") for s in range(4)]

    def rank(env):
        d = ct.DataFrame(df, env=env, device=CPU)
        return io.write_csv_sharded(d, paths, env), len(d.table.to_pandas())

    res = _world(rank)
    assert [r[0] for r in res] == [[p] for p in paths]
    back = pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)
    pd.testing.assert_frame_equal(back, df, check_dtype=False)


# ------------------------------------------------- CSV options parity
@pytest.mark.parametrize("case", ["quoting", "na_values",
                                  "na_values_strings", "column_types",
                                  "true_false", "escaping_autogen",
                                  "newlines", "int32", "quoted_empty",
                                  "post_close_quotes", "quoted_cr"])
def test_csv_options_match_jax(tmp_path, case):
    text, opts, want = {
        "quoting": ('a,b\n1,"x,y"\n2,"he said ""hi"""\n3,plain\n', None,
                    {"a": [1, 2, 3],
                     "b": ["x,y", 'he said "hi"', "plain"]}),
        "na_values": ("a,b,s\n1,2.5,x\nNA,-99,NA\n3,4.5,z\n",
                      dict(na_values=["NA", "-99"]), None),
        "na_values_strings": ("a,b,s\n1,2.5,x\nNA,-99,NA\n3,4.5,z\n",
                              dict(na_values=["NA"],
                                   strings_can_be_null=True), None),
        "column_types": ("a,b\n1,2\n3,4\n",
                         dict(column_types={"a": "float64", "b": "str"}),
                         {"a": [1.0, 3.0], "b": ["2", "4"]}),
        "true_false": ("f\nYES\nNO\nYES\n",
                       dict(true_values=["YES"], false_values=["NO"]),
                       {"f": [True, False, True]}),
        "escaping_autogen": ('1,x\\,y\n2,z\n',
                             dict(use_escaping=True, use_quoting=False,
                                  auto_generate_column_names=True),
                             {"f0": [1, 2], "f1": ["x,y", "z"]}),
        "newlines": ('a,b\n1,"x\ny"\n', dict(has_newlines_in_values=True),
                     {"a": [1], "b": ["x\ny"]}),
        "int32": ("a\n1\n2\n", dict(column_types={"a": "int32"}), None),
        "quoted_empty": ('a,b\n1,""\n2,"x"yz\n', None,
                         {"a": [1, 2], "b": ["", "xyz"]}),
        "post_close_quotes": ('a,b\n1,"x"y"z"\n2,"x"y"\n', None,
                              {"a": [1, 2], "b": ['xy"z"', 'xy"']}),
        "quoted_cr": ('a,b\n1,"x\r"\r\n2,"y\r"\n', None,
                      {"a": [1, 2], "b": ["x\r", "y\r"]}),
    }[case]
    df = _both_csv(_write(tmp_path, f"{case}.csv", text), opts)
    if want is not None:
        assert df.to_dict() == want
    pdf = df.to_pandas()
    if case == "na_values":
        assert pdf["a"].isna().tolist() == [False, True, False]
        assert pdf["s"].tolist() == ["x", "NA", "z"]
    if case == "na_values_strings":
        assert pdf["s"].isna().tolist() == [False, True, False]
    if case == "int32":
        assert df.table.column("a").data.dtype.itemsize == 4


def test_csv_chunks_match_jax(tmp_path, sample_df):
    p = tmp_path / "c.csv"
    sample_df.to_csv(p, index=False)
    mine = list(io.read_csv_chunks(str(p), 16, device=CPU))
    theirs = list(jio.read_csv_chunks(str(p), 16))
    assert [c.capacity for c in mine] == [c.capacity for c in theirs] == \
        [16] * 4
    for a, b in zip(mine, theirs):
        pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())
    with pytest.raises(IOError_):
        io.read_csv_chunks(str(p), 0, device=CPU)
    with pytest.raises(IOError_):
        io.read_csv_chunks(str(tmp_path / "missing.csv"), 4, device=CPU)


def test_parquet_chunks_match_jax(tmp_path, sample_df):
    p = tmp_path / "c.parquet"
    sample_df.to_parquet(p)
    mine = list(io.read_parquet_chunks(str(p), 20, ["k", "v"], device=CPU))
    theirs = list(jio.read_parquet_chunks(str(p), 20, ["k", "v"]))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert a.capacity == b.capacity == 20
        pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())


def test_parquet_options_roundtrip(tmp_path, sample_df):
    import pyarrow.parquet as pq

    path = str(tmp_path / "opt.parquet")
    df = ct.DataFrame(sample_df, device=CPU)
    io.write_parquet(df, path, ParquetOptions(
        compression="zstd", row_group_size=3, use_dictionary=False))
    pf = pq.ParquetFile(path)
    assert pf.metadata.num_row_groups >= 2
    assert pf.metadata.row_group(0).column(0).compression.lower() == "zstd"
    back = io.read_parquet(path, device=CPU)
    pd.testing.assert_frame_equal(back.to_pandas(), df.to_pandas())
    io.write_parquet(df, path, ParquetOptions(write_cols=["k"]))
    assert io.read_parquet(path, device=CPU).columns == ["k"]
    proj = io.read_parquet(path, device=CPU, options=ParquetOptions(
        use_cols=["k"], concurrent_file_reads=False))
    jproj = jio.read_parquet(path, options=JParquetOptions(
        use_cols=["k"], concurrent_file_reads=False))
    pd.testing.assert_frame_equal(proj.to_pandas(), jproj.to_pandas())


@pytest.mark.parametrize("case", ["plain", "nulls", "empty", "large"])
def test_from_arrow_dictionary_encoding_matches_from_numpy(rng, case):
    """``Table.from_arrow`` encodes a string column with pyarrow; its
    codes, sorted dictionary and validity equal ``Column.from_numpy``'s
    of the same values (nulls take the empty string's code there)."""
    import pyarrow as pa

    from cylon_tpu_torch.column import Column

    pool = np.array(["", "a", "b", "ä", "zz", "Ωmega", "a b, c", "\"q\""],
                    object)
    vals = list(pool[rng.integers(0, len(pool), 200)])
    if case == "nulls":
        vals = [None if i % 7 == 0 else v for i, v in enumerate(vals)]
    if case == "empty":
        vals = []
    arr = pa.array(vals, pa.large_string() if case == "large"
                   else pa.string())
    got = ct.Table.from_arrow(pa.table({"s": arr}), device=CPU).column("s")
    want = Column.from_numpy(np.array(vals, object), device=CPU)
    assert got.dtype == want.dtype
    assert got.dictionary == want.dictionary
    assert torch_equal(got.data, want.data)
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        assert torch_equal(got.validity, want.validity)


def torch_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a, b)
