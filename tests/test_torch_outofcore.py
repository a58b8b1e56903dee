"""The port's out-of-core ops (``cylon_tpu_torch.outofcore``) against the
JAX package's (``cylon_tpu.outofcore``) and pandas, on the same numpy
inputs from a seed: the host partition phase bit for bit, ``ooc_join``,
``ooc_groupby`` and ``ooc_sort`` as row sets with exact counts (floats at
rtol 1e-9), their checkpoint/resume semantics, and one hard kill in a
child process resumed here. The port's partitions join on CPU tables.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import cylon_tpu.outofcore as joc
import cylon_tpu_torch as ct
from cylon_tpu_torch import outofcore, resilience, telemetry
from cylon_tpu_torch.errors import (DataLossError, InvalidArgument,
                                    TransientError)
from cylon_tpu_torch.outofcore import (host_partition_chunks, ooc_groupby,
                                       ooc_join, ooc_sort)
from cylon_tpu_torch.resilience import FaultPlan, FaultRule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    resilience.install(None)


def _rows(df, cols):
    return df[cols].sort_values(cols).reset_index(drop=True)


def _frames_equal(got, want, cols):
    pd.testing.assert_frame_equal(_rows(got, cols), _rows(want, cols),
                                  check_dtype=False, check_exact=False,
                                  rtol=1e-9)


# ------------------------------------------------------ partition phase
@pytest.mark.parametrize("kind", ["int64", "float64", "int32+float",
                                  "string", "datetime"])
def test_host_partitions_match_jax_bit_for_bit(kind):
    rng = np.random.default_rng(3)
    n = 3000
    if kind == "int64":
        cols = {"k": rng.integers(-2**62, 2**62, n), "v": rng.random(n)}
        keys = ["k"]
    elif kind == "float64":
        k = rng.normal(size=n)
        k[::17] = np.nan
        k[::29] = -0.0
        cols = {"k": k, "v": rng.random(n)}
        keys = ["k"]
    elif kind == "int32+float":
        cols = {"a": rng.integers(0, 50, n).astype(np.int32),
                "b": rng.random(n).astype(np.float32),
                "v": rng.random(n)}
        keys = ["a", "b"]
    elif kind == "string":
        names = np.array([f"name{i}" for i in range(40)], object)
        cols = {"k": names[rng.integers(0, 40, n)], "v": rng.random(n)}
        keys = ["k"]
    else:
        cols = {"d": np.datetime64("2020-01-01")
                + rng.integers(0, 90, n).astype("timedelta64[D]"),
                "v": rng.random(n)}
        keys = ["d"]
    chunks = [{c: v[lo:lo + 700] for c, v in cols.items()}
              for lo in range(0, n, 700)]
    got = host_partition_chunks(chunks, keys, 7)
    want = joc.host_partition_chunks(chunks, keys, 7)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in g:
            assert g[c].dtype == w[c].dtype
            assert g[c].tobytes() == w[c].tobytes() if g[c].dtype != object \
                else list(g[c]) == list(w[c])


def test_partition_scatter_rejects_ids_out_of_range():
    chunks = [{"k": np.arange(10)}]
    with pytest.raises(DataLossError, match="host_partition_chunks"):
        outofcore._scatter_chunks(chunks, lambda c: c["k"] % 5 + 1, 5)


# ------------------------------------------------------------- ooc_join
@pytest.mark.parametrize("how", ["inner", "left", "fullouter"])
def test_ooc_join_matches_jax_and_pandas(how):
    rng = np.random.default_rng(7)
    n, m = 3000, 2500
    left = {"k": rng.integers(0, 600, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 600, m).astype(np.int64),
             "b": rng.normal(size=m)}
    kw = dict(on="k", how=how, n_partitions=4, chunk_rows=1024)
    got_parts, want_parts = [], []
    total = ooc_join(left, right, sink=got_parts.append, **kw, **CPU)
    jtotal = joc.ooc_join(left, right, sink=want_parts.append, **kw)
    assert total == jtotal
    got = pd.concat(got_parts, ignore_index=True)
    jwant = pd.concat(want_parts, ignore_index=True)
    assert len(got) == total and list(got.columns) == list(jwant.columns)
    cols = list(jwant.columns)
    _frames_equal(got, jwant, cols)
    pw = pd.DataFrame(left).merge(pd.DataFrame(right), on="k",
                                  how="outer" if how == "fullouter"
                                  else how)
    assert total == len(pw)


def test_ooc_join_partitions_match_jax_one_for_one():
    """Partition p of the port joins exactly partition p's rows of the
    JAX package (same host hash): per-partition counts agree."""
    rng = np.random.default_rng(8)
    n = 4000
    left = {"k": rng.integers(0, 900, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 900, n).astype(np.int64),
             "b": rng.normal(size=n)}
    got, want = [], []
    kw = dict(on="k", n_partitions=5, chunk_rows=900)
    ooc_join(left, right, sink=lambda f: got.append(len(f)), **kw, **CPU)
    joc.ooc_join(left, right, sink=lambda f: want.append(len(f)), **kw)
    assert got == want


def test_ooc_join_string_keys():
    rng = np.random.default_rng(9)
    n = 2000
    keys = np.array([f"key{i:03d}" for i in range(50)], object)
    left = {"k": keys[rng.integers(0, 50, n)], "a": rng.normal(size=n)}
    right = {"k": keys[rng.integers(0, 50, n)], "b": rng.normal(size=n)}
    parts = []
    total = ooc_join(left, right, on="k", n_partitions=4, chunk_rows=512,
                     sink=parts.append, **CPU)
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="k")
    assert total == len(want)
    _frames_equal(pd.concat(parts, ignore_index=True), want,
                  ["k", "a", "b"])


def test_ooc_join_regrows_a_skewed_partition():
    """A hot key's fan-out outgrows the partition's first output buffer
    (the port's overflow mark, ``nrows == cap + 1``): the partition
    reruns at doubled capacity until it fits."""
    left = {"k": np.zeros(300, np.int64), "a": np.arange(300.0)}
    right = {"k": np.zeros(200, np.int64), "b": np.arange(200.0)}
    parts = []
    assert ooc_join(left, right, on="k", n_partitions=2, chunk_rows=128,
                    sink=parts.append, **CPU) == 300 * 200
    got = pd.concat(parts, ignore_index=True)
    assert got["a"].sum() == 200 * np.arange(300.0).sum()


def test_ooc_join_rejects_one_shot_iterators():
    rng = np.random.default_rng(10)
    n = 1000
    left = {"k": rng.integers(0, 50, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 50, n).astype(np.int64),
             "b": rng.normal(size=n)}

    def gen(d, step=500):
        return ({k: v[lo:lo + step] for k, v in d.items()}
                for lo in range(0, n, step))

    with pytest.raises(InvalidArgument, match="one-shot iterator"):
        ooc_join(gen(left), right, on="k", n_partitions=2, **CPU)
    with pytest.raises(InvalidArgument, match="ooc_join source"):
        ooc_join(object(), right, on="k", n_partitions=2, **CPU)
    total = ooc_join(list(gen(left)), lambda: gen(right), on="k",
                     n_partitions=2, chunk_rows=256, **CPU)
    assert total == len(pd.DataFrame(left).merge(pd.DataFrame(right),
                                                 on="k"))


def test_ooc_join_fault_kill_and_resume_identical(tmp_path):
    rng = np.random.default_rng(11)
    n = 4000
    left = {"k": rng.integers(0, 400, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 400, n).astype(np.int64),
             "b": rng.normal(size=n)}
    kw = dict(on="k", how="inner", n_partitions=4, chunk_rows=700, **CPU)
    want_parts: list = []
    want_total = ooc_join(left, right, sink=want_parts.append, **kw)
    rdir = str(tmp_path / "resume")
    plan = FaultPlan([FaultRule("spill_write", nth=3, times=0)])
    with resilience.active(plan):
        with pytest.raises(TransientError):
            ooc_join(left, right, sink=lambda f: None, resume_dir=rdir,
                     **kw)
    manifest = json.loads((tmp_path / "resume" / "manifest.json")
                          .read_text())
    assert 0 < len(manifest["completed"]) < 4
    telemetry.reset("ooc.units_resumed")
    got_parts: list = []
    assert ooc_join(left, right, sink=got_parts.append, resume_dir=rdir,
                    **kw) == want_total
    pd.testing.assert_frame_equal(pd.concat(got_parts, ignore_index=True),
                                  pd.concat(want_parts, ignore_index=True))
    assert telemetry.counter("ooc.units_resumed", op="join").value >= 1


def test_ooc_join_resume_detects_changed_source(tmp_path):
    rng = np.random.default_rng(12)
    n = 2000
    left = {"k": rng.integers(0, 100, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 100, n).astype(np.int64),
             "b": rng.normal(size=n)}
    rdir = str(tmp_path / "r")
    kw = dict(on="k", n_partitions=3, chunk_rows=600, resume_dir=rdir,
              **CPU)
    ooc_join(left, right, **kw)
    grown = {k: np.concatenate([v, v[:100]]) for k, v in left.items()}
    with pytest.raises(DataLossError, match="source changed"):
        ooc_join(grown, right, **kw)


def test_ooc_join_resume_fingerprint_names_the_join_kernel(tmp_path,
                                                           monkeypatch):
    """The effective join kernel changes the row order of a partition's
    output, so a resume under another kernel recomputes instead of
    mixing: the sort route and the bucketed hash route fingerprint
    apart."""
    rng = np.random.default_rng(13)
    left = {"k": rng.integers(0, 50, 500).astype(np.int64)}
    right = {"k": rng.integers(0, 50, 500).astype(np.int64)}
    rdir = str(tmp_path / "r")
    kw = dict(on="k", n_partitions=2, chunk_rows=200, resume_dir=rdir,
              **CPU)
    ooc_join(left, right, **kw)
    fp_sort = json.loads(open(os.path.join(rdir, "manifest.json")).read())
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")
    telemetry.reset("ooc.units_resumed")
    ooc_join(left, right, algorithm="hash", **kw)
    fp_hash = json.loads(open(os.path.join(rdir, "manifest.json")).read())
    assert fp_sort["fingerprint"] != fp_hash["fingerprint"]
    assert telemetry.total("ooc.units_resumed") == 0


_KILL_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from cylon_tpu_torch import resilience
from cylon_tpu_torch.outofcore import ooc_join
rng = np.random.default_rng(21)
n = 6000
left = {{"k": rng.integers(0, 700, n).astype(np.int64),
         "a": rng.normal(size=n)}}
right = {{"k": rng.integers(0, 700, n).astype(np.int64),
          "b": rng.normal(size=n)}}
plan = resilience.FaultPlan([resilience.FaultRule.kill("spill_write",
                                                        nth={nth})])
with resilience.active(plan), open({out!r}, "a") as f:
    ooc_join(left, right, on="k", n_partitions=6, chunk_rows=1500,
             resume_dir={rdir!r}, device="cpu",
             sink=lambda df: (f.write(str(len(df)) + "\n"), f.flush()))
"""


def test_ooc_join_hard_kill_in_a_child_resumes_byte_identical(tmp_path):
    """A child process dies by ``os._exit`` at the fourth partition's
    spill write; the resumed run here replays the three durable
    partitions and recomputes the rest, and its sink stream equals a
    fault-free run's, partition for partition, byte for byte."""
    rng = np.random.default_rng(21)
    n = 6000
    left = {"k": rng.integers(0, 700, n).astype(np.int64),
            "a": rng.normal(size=n)}
    right = {"k": rng.integers(0, 700, n).astype(np.int64),
             "b": rng.normal(size=n)}
    kw = dict(on="k", n_partitions=6, chunk_rows=1500, **CPU)
    want: list = []
    ooc_join(left, right, sink=lambda df: want.append(
        df.to_csv(index=False, float_format="%.17g")), **kw)
    rdir, out = str(tmp_path / "r"), str(tmp_path / "acks")
    code = _KILL_CHILD.format(root=ROOT, nth=4, out=out, rdir=rdir)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == resilience.KILL_EXIT_CODE, res.stderr[-2000:]
    acked = open(out).read().split()
    assert len(acked) == 3      # three partitions reached the sink
    telemetry.reset("ooc.units_resumed")
    got: list = []
    ooc_join(left, right, resume_dir=rdir, sink=lambda df: got.append(
        df.to_csv(index=False, float_format="%.17g")), **kw)
    assert got == want
    assert telemetry.counter("ooc.units_resumed", op="join").value == 3


# ----------------------------------------------------------- ooc_groupby
def test_ooc_groupby_matches_jax_and_pandas():
    rng = np.random.default_rng(14)
    n = 6000
    src = {"g": rng.integers(0, 37, n).astype(np.int64),
           "v": rng.normal(size=n)}
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("v", "min", "mn"),
            ("v", "max", "mx")]
    got = ooc_groupby(src, ["g"], aggs, chunk_rows=700, **CPU).to_pandas()
    jwant = joc.ooc_groupby(src, ["g"], aggs, chunk_rows=700).to_pandas()
    cols = ["g", "s", "c", "mn", "mx"]
    _frames_equal(got, jwant, cols)
    pw = (pd.DataFrame(src).groupby("g").agg(
        s=("v", "sum"), c=("v", "count"), mn=("v", "min"),
        mx=("v", "max")).reset_index())
    _frames_equal(got, pw, cols)


def test_ooc_groupby_rejects_non_decomposable_and_one_shot():
    src = {"g": np.arange(10) % 3, "v": np.ones(10)}
    with pytest.raises(InvalidArgument, match="non-decomposable"):
        ooc_groupby(src, ["g"], [("v", "mean")], **CPU)
    with pytest.raises(InvalidArgument, match="one-shot iterator"):
        ooc_groupby(iter([src]), ["g"], [("v", "sum")], **CPU)


def test_ooc_groupby_fault_kill_and_resume_identical(tmp_path):
    rng = np.random.default_rng(15)
    n = 3000
    src = {"g": rng.integers(0, 23, n).astype(np.int64),
           "v": rng.normal(size=n)}
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("v", "min", "mn")]
    kw = dict(chunk_rows=500, **CPU)
    want = ooc_groupby(src, ["g"], aggs, **kw).to_pandas()
    rdir = str(tmp_path / "r")
    plan = FaultPlan([FaultRule("chunk_source", nth=4, times=0)])
    with resilience.active(plan):
        with pytest.raises(TransientError):
            ooc_groupby(src, ["g"], aggs, resume_dir=rdir, **kw)
    done = len(json.loads((tmp_path / "r" / "manifest.json")
                          .read_text())["completed"])
    assert 0 < done < 6
    telemetry.reset("ooc.units_resumed")
    got = ooc_groupby(src, ["g"], aggs, resume_dir=rdir, **kw).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert telemetry.counter("ooc.units_resumed", op="groupby").value == \
        done
    poison = FaultPlan([FaultRule("spill_write", nth=1, times=0)])
    with resilience.active(poison):
        again = ooc_groupby(src, ["g"], aggs, resume_dir=rdir,
                            **kw).to_pandas()
    assert poison.hits("spill_write") == 0
    pd.testing.assert_frame_equal(again, want)


def test_ooc_groupby_resume_fingerprint_covers_transform(tmp_path):
    n = 1200
    rng = np.random.default_rng(16)
    src = {"g": rng.integers(0, 7, n).astype(np.int64), "v": np.ones(n)}
    rdir = str(tmp_path / "r")

    def doubled(chunk):
        return ct.Table.from_pydict({"g": chunk["g"],
                                     "v": chunk["v"] * 2.0}, device="cpu")

    p = ooc_groupby(src, ["g"], [("v", "sum", "s")], chunk_rows=400,
                    resume_dir=rdir, **CPU).to_pandas()
    t = ooc_groupby(src, ["g"], [("v", "sum", "s")], chunk_rows=400,
                    resume_dir=rdir, transform=doubled, **CPU).to_pandas()
    np.testing.assert_allclose(t["s"].to_numpy(), 2.0 * p["s"].to_numpy())


# --------------------------------------------------------------- ooc_sort
def test_ooc_sort_matches_jax_and_pandas():
    rng = np.random.default_rng(17)
    n = 20_000
    vals = rng.normal(size=n)
    vals[rng.integers(0, n, 200)] = np.nan
    src = {"k": rng.integers(0, 300, n).astype(np.int64), "v": vals,
           "payload": rng.integers(0, 1 << 40, n).astype(np.int64)}
    kw = dict(n_partitions=4, chunk_rows=3000, sample_stride=97)
    parts, jparts = [], []
    assert ooc_sort(src, ["k", "v"], sink=parts.append, **kw, **CPU) == n
    assert joc.ooc_sort(src, ["k", "v"], sink=jparts.append, **kw) == n
    # range order: the same bucket sizes, in the same order
    assert [len(p) for p in parts] == [len(p) for p in jparts]
    got = pd.concat(parts, ignore_index=True)
    want = pd.DataFrame(src).sort_values(["k", "v"]).reset_index(drop=True)
    np.testing.assert_array_equal(got["k"].to_numpy(), want["k"].to_numpy())
    gv, wv = got["v"].to_numpy(), want["v"].to_numpy()
    assert ((gv == wv) | (np.isnan(gv) & np.isnan(wv))).all()
    cols = ["k", "v", "payload"]
    pd.testing.assert_frame_equal(_rows(got, cols), _rows(want, cols),
                                  check_dtype=False)


def test_ooc_sort_callable_sources_and_empty():
    rng = np.random.default_rng(18)
    n = 3000
    data = {"k": rng.integers(0, 500, n).astype(np.int64),
            "v": rng.normal(size=n)}

    def dict_chunks():
        for lo in range(0, n, 1200):
            yield {k: v[lo:lo + 1200] for k, v in data.items()}

    def table_chunks():
        for lo in range(0, n, 700):
            yield ct.Table.from_pydict(
                {k: v[lo:lo + 700] for k, v in data.items()}, device="cpu")

    for src in (dict_chunks, table_chunks):
        parts = []
        assert ooc_sort(src, "k", n_partitions=3, sink=parts.append,
                        **CPU) == n
        np.testing.assert_array_equal(
            pd.concat(parts, ignore_index=True)["k"].to_numpy(),
            np.sort(data["k"]))
    assert ooc_sort({"k": np.empty(0, np.int64)}, "k", **CPU) == 0


def test_ooc_sort_inf_nan_and_big_ints():
    rng = np.random.default_rng(19)
    n = 4000
    v = rng.normal(size=n)
    v[rng.integers(0, n, 400)] = np.nan
    v[rng.integers(0, n, 50)] = np.inf
    v[rng.integers(0, n, 50)] = -np.inf
    src = {"v": v, "i": rng.integers(0, n, n).astype(np.int64)}
    parts = []
    assert ooc_sort(src, ["v"], n_partitions=4, chunk_rows=900,
                    sink=parts.append, sample_stride=31, **CPU) == n
    gv = pd.concat(parts, ignore_index=True)["v"].to_numpy()
    wv = np.sort(v)
    assert ((gv == wv) | (np.isnan(gv) & np.isnan(wv))).all()
    big = (1 << 60) + rng.integers(0, 64, 3000).astype(np.int64)
    parts2 = []
    assert ooc_sort({"k": big, "t": rng.normal(size=3000)}, ["k", "t"],
                    n_partitions=3, chunk_rows=800, sink=parts2.append,
                    sample_stride=17, **CPU) == 3000
    np.testing.assert_array_equal(
        pd.concat(parts2, ignore_index=True)["k"].to_numpy(), np.sort(big))


def test_ooc_sort_units_resumed_labelled_op_sort(tmp_path):
    rng = np.random.default_rng(20)
    src = {"k": rng.integers(0, 60, 1500).astype(np.int64)}
    kw = dict(n_partitions=3, chunk_rows=400,
              resume_dir=str(tmp_path / "r"), **CPU)
    assert ooc_sort(src, "k", **kw) == 1500
    telemetry.reset("ooc.units_resumed")
    assert ooc_sort(src, "k", **kw) == 1500
    assert telemetry.counter("ooc.units_resumed", op="sort").value == 3
