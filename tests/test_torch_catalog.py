"""The port's table catalog (``cylon_tpu_torch.catalog``) against the JAX
package's (``cylon_tpu.catalog``) on the same inputs: every case of
``tests/test_catalog.py`` (the native bridge round trip too), the
pin/drop refusals, the ``stats`` key set,
``table_version`` digests string-equal to JAX's, the append sequence
(``append``, ``deltas_since``, ``restore_version``, ``on_append``), the
OOM report's tables, and shards at W = 4 on ``ThreadWorld`` against
W = 1 and pandas.

By-id results compare as row sets (sorted rows); floats exactly, since
both packages compute the same rows from the same values."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
from cylon_tpu import catalog as jcat
from cylon_tpu_torch import Table, catalog
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import (FailedPrecondition, InvalidArgument,
                                    KeyError_)
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.telemetry import memory


@pytest.fixture(autouse=True)
def clean():
    catalog.clear()
    jcat.clear()
    yield
    catalog.clear()
    jcat.clear()


def _both(d):
    """The same columns as a port table on the CPU and a JAX table."""
    arrays = {k: np.asarray(v) for k, v in d.items()}
    return (Table.from_pydict(arrays, device="cpu"),
            jct.Table.from_pydict(arrays))


def _put(tid, d):
    pt, jt = _both(d)
    catalog.put_table(tid, pt)
    jcat.put_table(tid, jt)


def _rows(frame):
    """A frame's rows as a sorted list of tuples (a row set), a null
    (None or NaN) as one marker so that equal rows compare equal."""
    def cell(x):
        return ("<null>",) if pd.isna(x) else (x,)

    return sorted(tuple(cell(x) for x in r)
                  for r in frame.astype(object).itertuples(index=False))


def _same_rows(tid):
    got, want = catalog.get_table(tid).to_pandas(), \
        jcat.get_table(tid).to_pandas()
    assert list(got.columns) == list(want.columns)
    assert _rows(got) == _rows(want)


def test_put_get_remove():
    t = Table.from_pydict({"a": np.asarray([1, 2, 3])}, device="cpu")
    catalog.put_table("t1", t)
    assert catalog.get_table("t1") is t
    assert catalog.list_tables() == ["t1"]
    catalog.remove_table("t1")
    with pytest.raises(KeyError_, match="no table"):
        catalog.get_table("t1")
    with pytest.raises(InvalidArgument, match="not a Table"):
        catalog.put_table("t1", {"a": [1]})


def test_join_by_id_matches_jax():
    rng = np.random.default_rng(0)
    _put("left", {"k": rng.integers(0, 20, 60), "a": rng.normal(size=60)})
    # unique right keys: a 1:N join fits the default out capacity
    _put("right", {"k": rng.permutation(40)[:30],
                   "b": rng.integers(0, 9, 30)})
    for how in ("inner", "left", "outer"):
        catalog.join_tables("left", "right", "out", on="k", how=how)
        jcat.join_tables("left", "right", "out", on="k", how=how)
        _same_rows("out")


def test_join_by_id_with_config_matches_jax():
    from cylon_tpu.config import JoinConfig as JJoinConfig
    from cylon_tpu_torch.config import JoinConfig

    _put("l", {"x": [1, 2, 3, 3], "a": [10, 20, 30, 31]})
    _put("r", {"y": [3, 2, 9], "b": [300, 200, 900]})
    catalog.join_tables("l", "r", "o", JoinConfig.make(
        "left", left_on=["x"], right_on=["y"]))
    jcat.join_tables("l", "r", "o", JJoinConfig.make(
        "left", left_on=["x"], right_on=["y"]))
    _same_rows("o")


def test_setops_by_id_matches_jax():
    _put("a", {"x": [1, 2, 3, 3, 7]})
    _put("b", {"x": [2, 3, 4]})
    for op in ("intersect", "union", "subtract"):
        getattr(catalog, f"{op}_tables")("a", "b", op)
        getattr(jcat, f"{op}_tables")("a", "b", op)
        _same_rows(op)
    assert sorted(catalog.table_to_pydict("union")["x"]) == [1, 2, 3, 4, 7]
    assert catalog.table_to_pydict("subtract")["x"] == [1, 7]


def test_sort_unique_select_by_id_match_jax():
    _put("t", {"x": [3, 1, 2, 1], "y": [1, 2, 3, 4]})
    catalog.sort_table("t", "s", "x")
    jcat.sort_table("t", "s", "x")
    assert catalog.table_to_pydict("s") == jcat.table_to_pydict("s")
    assert catalog.table_to_pydict("s")["x"] == [1, 1, 2, 3]
    catalog.unique_table("t", "u", cols=["x"])
    jcat.unique_table("t", "u", cols=["x"])
    _same_rows("u")
    catalog.select_columns("t", "p", ["y"])
    assert list(catalog.get_table("p").column_names) == ["y"]


def test_read_csv_by_id(tmp_path):
    p = tmp_path / "f.csv"
    p.write_text("a,b\n1,x\n2,y\n")
    catalog.read_csv("csvt", str(p), device="cpu")
    jcat.read_csv("csvt", str(p))
    d = catalog.table_to_pydict("csvt")
    assert d == jcat.table_to_pydict("csvt")
    assert d["a"] == [1, 2] and d["b"] == ["x", "y"]


def test_native_bridge_waits_for_the_host_library():
    """The host library is here: ``to_native`` / ``from_native`` round
    trip a catalog entry through the native registry as the JAX
    package's bridge does; a sharded id raises without ``env``."""
    from cylon_tpu import native as jnative
    from cylon_tpu_torch import native

    data = {"a": np.array([3, 1, 2]), "s": np.array(["x", None, "y"],
                                                     object)}
    catalog.put_table("t", Table.from_pydict(data, device="cpu"))
    jcat.put_table("t", jct.Table.from_pydict(data))
    try:
        catalog.to_native("t")
        jcat.to_native("t")
        catalog.drop("t")
        jcat.drop("t")
        catalog.from_native("t", device="cpu")
        jcat.from_native("t")
        assert catalog.table_to_pydict("t") == jcat.table_to_pydict("t") \
            == {"a": [3, 1, 2], "s": ["x", None, "y"]}
    finally:
        native.catalog_clear()
        jnative.catalog_clear()

    def rank(env):
        catalog.put_table("sh", Table.from_pydict(
            {"a": np.arange(4)}, device="cpu"), env=env)
        return True

    ThreadWorld(2).run(lambda comm: rank(CylonEnv(comm, device="cpu")))
    with pytest.raises(InvalidArgument, match="shards"):
        catalog.to_native("sh")


def test_pin_unpin_drop_refusals_name_holders():
    for cat in (catalog, jcat):
        t = (Table.from_pydict({"a": [1, 2]}, device="cpu")
             if cat is catalog else jct.Table.from_pydict({"a": [1, 2]}))
        cat.put_table("t", t)
        cat.pin("t", holder="req-1")
        cat.pin("t", holder="req-1")
        with cat.pinned("t", holder="req-2") as got:
            assert got is t
            assert cat.pins("t") == {"req-1": 2, "req-2": 1}
        assert cat.pins("t") == {"req-1": 2}
        with pytest.raises(Exception, match=r"pinned by 2 holder\(s\) "
                                            r"\['req-1'\]") as e:
            cat.drop("t")
        assert type(e.value).__name__ == "FailedPrecondition"
        with pytest.raises(Exception, match="pinned"):
            cat.put_table("t", t)
        with pytest.raises(Exception, match="holds no pin"):
            cat.unpin("t", holder="nobody")
        cat.unpin("t", holder="req-1")
        cat.unpin("t", holder="req-1")
        cat.drop("t")
        assert cat.list_tables() == []
        with pytest.raises(Exception, match="no table"):
            cat.drop("t", if_exists=False)
        cat.drop("t")                        # if_exists: a no-op
    with pytest.raises(FailedPrecondition):
        catalog.put_table("p", Table.from_pydict({"a": [1]}, device="cpu"))
        catalog.get_table("p", pin_for="h")
        catalog.drop("p")


def test_stats_key_set_and_values_match_jax():
    _put("t", {"k": np.arange(10, dtype=np.int64),
               "v": np.arange(10.0)})
    catalog.pin("t", "h")
    jcat.pin("t", "h")
    got, want = catalog.stats()["t"], jcat.stats()["t"]
    assert set(got) == set(want)
    for key in ("rows", "columns", "distributed", "pins", "holders",
                "version"):
        assert got[key] == want[key], key
    assert got["bytes"] == 160 == sum(got["bytes_by_device"].values())
    assert got["bytes_by_device"] == {"cpu:0": 160}
    assert got["capacity"] == 10


@pytest.mark.parametrize("kind", ["int64", "float64", "string",
                                  "nullable_int", "datetime", "mixed"])
@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_table_version_digest_string_equal_to_jax(kind, storage):
    rng = np.random.default_rng(3)
    n = 40
    ni = pd.array(rng.integers(0, 9, n), dtype="Int64")
    ni[rng.random(n) < 0.25] = pd.NA
    cols = {"int64": rng.integers(-99, 99, n),
            "float64": rng.normal(size=n),
            "string": rng.choice(["ab", "c", "def", None], n),
            "nullable_int": ni,
            "datetime": pd.to_datetime(rng.integers(0, 10 ** 9, n),
                                       unit="s")}
    df = pd.DataFrame(cols if kind == "mixed" else {kind: cols[kind]})
    catalog.put_table("t", Table.from_pandas(df, device="cpu",
                                             string_storage=storage))
    jcat.put_table("t", jct.Table.from_pandas(df))
    got, want = catalog.table_version("t"), jcat.table_version("t")
    assert got == want
    assert isinstance(got["digest"], str) and len(got["digest"]) == 64


def _delta(k0, n=3):
    return pd.DataFrame({"k": np.arange(k0, k0 + n, dtype=np.int64),
                         "v": np.full(n, 0.5)})


def test_append_sequence_matches_jax():
    heard = {"port": [], "jax": []}
    catalog.on_append(lambda tid, g: heard["port"].append((tid, g)))
    jcat.on_append(lambda tid, g: heard["jax"].append((tid, g)))
    try:
        _put("t", {"k": np.arange(8, dtype=np.int64),
                   "v": np.arange(8.0)})
        for cat in (catalog, jcat):
            assert cat.deltas_since("t", 1) == []
            assert cat.append("t", _delta(50, 2)) == {
                "generation": 2, "delta_rows": 2, "rows": 10}
            assert cat.append("t", {"k": np.array([60]),
                                    "v": np.array([1.5])}) == {
                "generation": 3, "delta_rows": 1, "rows": 11}
        assert catalog.table_version("t") == jcat.table_version("t")
        for gen in (1, 2, 3):
            got = catalog.deltas_since("t", gen)
            want = jcat.deltas_since("t", gen)
            assert len(got) == len(want) == 3 - gen
            for a, b in zip(got, want):
                pd.testing.assert_frame_equal(a, b)
        for cat in (catalog, jcat):
            cat.restore_version("t", 7)
            assert cat.generation("t") == 7
            assert cat.append("t", _delta(70, 1))["generation"] == 8
            assert cat.stats()["t"]["rows"] == 12
        assert catalog.table_version("t") == jcat.table_version("t")
        assert heard["port"] == heard["jax"] == [("t", 2), ("t", 3),
                                                 ("t", 8)]
    finally:
        catalog._append_listeners.pop()
        jcat._append_listeners.pop()


def test_deltas_since_none_after_overwrite_and_at_keep_zero(monkeypatch):
    for cat, mk in ((catalog, lambda d: Table.from_pydict(d, device="cpu")),
                    (jcat, jct.Table.from_pydict)):
        t = {"k": np.arange(8, dtype=np.int64), "v": np.arange(8.0)}
        cat.put_table("t2", mk(t))
        cat.append("t2", _delta(100))
        cat.put_table("t2", mk({k: v[:4] for k, v in t.items()}))
        assert cat.deltas_since("t2", 1) is None
        assert cat.generation("t2") == 3
        monkeypatch.setenv("CYLON_TPU_CATALOG_DELTA_KEEP", "0")
        cat.put_table("t3", mk(t))
        cat.append("t3", _delta(100))
        assert cat.deltas_since("t3", 1) is None
        monkeypatch.delenv("CYLON_TPU_CATALOG_DELTA_KEEP")


def test_append_legal_while_pinned_and_rejects_schema_drift():
    catalog.put_table("t", Table.from_pydict(
        {"k": np.arange(8, dtype=np.int64), "v": np.arange(8.0)},
        device="cpu"))
    old = catalog.get_table("t", pin_for="reader-1")
    catalog.append("t", _delta(100, 2))
    assert catalog.get_table("t").num_rows == 10
    assert old.num_rows == 8            # the pinned generation is intact
    catalog.unpin("t", holder="reader-1")
    with pytest.raises(InvalidArgument, match="resident schema"):
        catalog.append("t", pd.DataFrame({"k": [1], "wrong": [2.0]}))
    with pytest.raises(KeyError_):
        catalog.append("missing", _delta(0))
    with pytest.raises(InvalidArgument, match="cannot append"):
        catalog.append("t", 42)


def test_append_keeps_device_storage_and_validity():
    """The merged table lies where the resident one does, each string
    column in its storage, a nullable column with its validity, and its
    digest equals JAX's for the same appends."""
    ni = pd.array([1, None, 3], dtype="Int64")
    df = pd.DataFrame({"s": ["a", "bb", None], "c": ["x", "y", "x"],
                       "n": ni, "t": pd.to_datetime([1, 2, 3], unit="D")})
    t = Table.from_pandas(df, device="cpu",
                          string_storage={"s": "bytes", "c": "dict"})
    catalog.put_table("t", t)
    jcat.put_table("t", jct.Table.from_pandas(df))
    delta = pd.DataFrame({"s": ["zzzzzzzz"], "c": ["w"],
                          "n": pd.array([None], dtype="Int64"),
                          "t": pd.to_datetime([9], unit="D")})
    catalog.append("t", delta)
    jcat.append("t", delta)
    new = catalog.get_table("t")
    assert new.device.type == "cpu"
    assert new.column("s").dtype.is_bytes
    assert new.column("c").dtype.is_dictionary
    assert new.column("n").validity is not None
    assert new.column("n").validity[:4].tolist() == [True, False, True,
                                                     False]
    assert str(new.column("n").data.dtype) == "torch.int64"
    assert catalog.table_version("t") == jcat.table_version("t")


def test_oom_report_names_the_largest_resident_tables():
    catalog.put_table("small", Table.from_pydict(
        {"a": np.arange(4, dtype=np.int64)}, device="cpu"))
    catalog.put_table("big", Table.from_pydict(
        {"a": np.arange(64, dtype=np.int64),
         "b": np.arange(64, dtype=np.float64)}, device="cpu"))
    catalog.pin("big", holder="q7")
    rep = memory.oom_report()
    assert [t["id"] for t in rep["tables"]] == ["big", "small"]
    assert rep["tables"][0] == {"id": "big", "bytes": 1024, "rows": 64,
                                "pins": 1, "holders": ["q7"]}
    assert memory.oom_report(limit=1)["tables"][0]["id"] == "big"
    text = memory.format_oom_report(rep)
    assert "table 'big': 1024 bytes, rows=64 pinned by ['q7']" in text
    catalog.unpin("big", holder="q7")


def test_oom_report_computes_no_digest():
    """The report reads bytes, rows and pins only: a table appended
    since its last read keeps its digest unset (no host fetch and
    sha256 on the way to the OOM retry), while ``stats()`` still
    computes it for its other callers."""
    catalog.put_table("t", Table.from_pydict(
        {"a": np.arange(8, dtype=np.int64)}, device="cpu"))
    catalog.table_version("t")
    catalog.append("t", pd.DataFrame({"a": np.arange(8, 12)}))
    key = ("t", None)
    assert catalog._versions[key]["digest"] is None
    rep = memory.oom_report()
    assert rep["tables"][0] == {"id": "t", "bytes": 96, "rows": 12,
                                "pins": 0, "holders": []}
    assert catalog._versions[key]["digest"] is None
    assert catalog.stats(version=False)["t"]["version"] == {
        "generation": 2, "digest": None}
    assert catalog.stats()["t"]["version"]["digest"] is not None


# ------------------------------------------------------------- shards
def _w4_sides(rng, n):
    return [pd.DataFrame({"k": rng.integers(0, n, n).astype(np.int64),
                          "v": rng.normal(size=n)}) for _ in range(2)]


def _shard(df, env):
    w, r = env.world_size, env.rank
    block = -(-len(df) // w)
    part = df.iloc[r * block:(r + 1) * block]
    return Table.from_pandas(part.reset_index(drop=True), device="cpu")


def test_w4_join_tables_equal_w1_and_pandas():
    """Four ThreadWorld ranks write their shards under one id without
    overwriting one another; the world's rows equal W = 1 and pandas."""
    rng = np.random.default_rng(5)
    left, right = _w4_sides(rng, 400)

    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        catalog.put_table("L", _shard(left, env), env=env)
        catalog.put_table("R", _shard(right, env), env=env)
        catalog.join_tables("L", "R", "J", on="k", env=env)
        st = catalog.stats(env=env)["J"]
        mine = catalog.get_table("J", env=env)
        assert catalog.is_shard("J", env)
        return (st, mine.to_pandas(),
                pd.DataFrame(catalog.table_to_pydict("J", env)))

    out = ThreadWorld(4).run(rank)
    assert sorted(k[1] for k in catalog._catalog if k[0] == "J") == \
        [0, 1, 2, 3]
    for st, part, _ in out:
        assert st["distributed"] and st["rows"] == len(part)
    world = pd.concat([p for _, p, _ in out], ignore_index=True)
    whole = out[0][2]
    want = left.merge(right, on="k", suffixes=("_x", "_y"))
    assert _rows(world) == _rows(whole) == _rows(want)
    # W = 1: the same ids, local tables
    catalog.clear()
    catalog.put_table("L", Table.from_pandas(left, device="cpu"))
    catalog.put_table("R", Table.from_pandas(right, device="cpu"))
    catalog.join_tables("L", "R", "J", on="k")
    assert _rows(catalog.get_table("J").to_pandas()) == _rows(want)
    # a sharded id without its env is refused, and stats sums its shards
    catalog.clear()
    ThreadWorld(4).run(lambda comm: catalog.put_table(
        "L", _shard(left, CylonEnv(comm, device="cpu")),
        env=CylonEnv(comm, device="cpu")))
    with pytest.raises(InvalidArgument, match="shards of a world of 4"):
        catalog.get_table("L")
    st = catalog.stats()["L"]
    assert st["distributed"] and st["rows"] == len(left)


def test_w4_shard_append_equals_w1_and_numpy():
    rng = np.random.default_rng(6)
    base, _ = _w4_sides(rng, 300)
    deltas = [pd.DataFrame({"k": np.arange(1000 + 10 * i, 1010 + 10 * i,
                                           dtype=np.int64),
                            "v": rng.normal(size=10)}) for i in range(2)]

    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        catalog.put_table("T", _shard(base, env), env=env)
        res = [catalog.append("T", d, env=env) for d in deltas]
        got = catalog.deltas_since("T", 1, env=env)
        whole = pd.DataFrame(catalog.table_to_pydict("T", env))
        return res, len(got), whole, catalog.table_version("T", env=env)

    out = ThreadWorld(4).run(rank)
    want = pd.concat([base] + deltas, ignore_index=True)
    for res, nd, whole, _ in out:
        assert [r["generation"] for r in res] == [2, 3]
        assert res[-1]["rows"] == len(want) and nd == 2
        assert _rows(whole) == _rows(want)
    # each rank's digest hashes its own shard plus its rank and world
    assert len({v["digest"] for *_, v in out}) == 4
    catalog.clear()
    catalog.put_table("T", Table.from_pandas(base, device="cpu"))
    for d in deltas:
        catalog.append("T", d)
    got = catalog.get_table("T").to_pandas()
    assert _rows(got) == _rows(want)
    np.testing.assert_array_equal(got["k"].to_numpy(), want["k"].to_numpy())


def test_shard_append_needs_env_and_local_tables_scatter_into_dist_ops():
    rng = np.random.default_rng(8)
    left, right = _w4_sides(rng, 200)
    catalog.put_table("L", Table.from_pandas(left, device="cpu"))
    catalog.put_table("R", Table.from_pandas(right, device="cpu"))

    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        # local tables enter the distributed join once, not once a rank
        catalog.join_tables("L", "R", "J", on="k", env=env)
        return catalog.get_table("J", env=env).to_pandas()

    parts = ThreadWorld(4).run(rank)
    want = left.merge(right, on="k", suffixes=("_x", "_y"))
    assert _rows(pd.concat(parts, ignore_index=True)) == _rows(want)
    with pytest.raises(InvalidArgument, match="pass the env"):
        catalog.append("J", _delta(0))
