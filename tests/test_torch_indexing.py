"""The port's indexing (``RangeIndex``, ``LinearIndex``, ``HashIndex``,
``loc`` / ``iloc``) against the JAX package's on the same frames, on the
CPU: every case of ``tests/test_indexing.py`` translated, each answer
compared with the JAX frame's and with pandas where the JAX case does.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu_torch as ct
from cylon_tpu import DataFrame as JDataFrame
from cylon_tpu.indexing import IndexingType as JIndexingType
from cylon_tpu.indexing import build_index as jbuild_index
from cylon_tpu_torch import DataFrame
from cylon_tpu_torch.indexing import (HashIndex, IndexingType, LinearIndex,
                                      RangeIndex, build_index)
from cylon_tpu_torch.parallel.comm import ThreadWorld

DATA = {"id": np.array([10, 7, 42, 3, 42, 19], np.int64),
        "v": np.array([0.5, 1.5, 2.5, 3.5, 4.5, 5.5]),
        "s": np.array(["a", "b", "c", "d", "e", "f"])}


@pytest.fixture
def both():
    """(port frame, JAX frame) over the same data."""
    return DataFrame(DATA, device="cpu"), JDataFrame(DATA)


def _same(fn, both):
    got, want = (fn(d).to_pandas() for d in both)
    pd.testing.assert_frame_equal(got, want)
    return got


@pytest.mark.parametrize("ityp", ["LINEAR", "HASH", "BINARY_TREE"])
def test_loc_scalar_and_list(both, ityp):
    mine, theirs = both
    d = (mine.set_index("id", indexing_type=IndexingType[ityp]),
         theirs.set_index("id", indexing_type=JIndexingType[ityp]))
    assert _same(lambda x: x.loc[42], d)["v"].tolist() == [2.5]
    got = _same(lambda x: x.loc[[3, 10]], d)
    assert got["v"].tolist() == [3.5, 0.5]
    assert got["s"].tolist() == ["d", "a"]


def test_loc_missing_raises(both):
    with pytest.raises(Exception, match="not found"):
        both[0].set_index("id").loc[999]


def test_loc_range_inclusive(both):
    d = [x.set_index("id", indexing_type=t, drop=False) for x, t in
         zip(both, (IndexingType.LINEAR, JIndexingType.LINEAR))]
    got = _same(lambda x: x.loc[7:19], d)
    assert sorted(got["id"].tolist()) == [7, 10, 19]
    _same(lambda x: x.loc[:10], d)
    _same(lambda x: x.loc[:], d)


def test_loc_column_subset(both):
    d = [x.set_index("id") for x in both]
    assert list(_same(lambda x: x.loc[[42], "v"], d).columns) == ["v"]
    assert list(_same(lambda x: x.loc[[42], ["v", "s"]], d).columns) == \
        ["v", "s"]


def test_loc_bool_mask(both):
    mask = np.array([True, False, True, False, False, True])
    got = _same(lambda x: x.set_index("id").loc[mask], both)
    assert got["v"].tolist() == pd.DataFrame(DATA)[mask]["v"].tolist()


def test_loc_string_index(both):
    got = _same(lambda x: x.set_index("s").loc[["d", "b"]], both)
    assert got["id"].tolist() == [3, 7]
    mine, theirs = both
    linear = (mine.set_index("s", indexing_type=IndexingType.LINEAR),
              theirs.set_index("s", indexing_type=JIndexingType.LINEAR))
    assert _same(lambda x: x.loc["b":"e"], linear)["id"].tolist() == \
        [7, 42, 3, 42]


def test_iloc(both):
    for key in (2, -1, slice(1, 4), slice(None, None, 2), [4, 0],
                np.array([True, False, True, False, False, False])):
        _same(lambda x: x.iloc[key], both)
    assert both[0].iloc[[4, 0]].to_pandas()["v"].tolist() == [4.5, 0.5]
    with pytest.raises(Exception, match="out of range"):
        both[0].iloc[17]


def test_iloc_cols(both):
    got = _same(lambda x: x.iloc[1:3, ["s"]], both)
    assert got["s"].tolist() == ["b", "c"]
    assert list(_same(lambda x: x.iloc[0:6, "id":"v"], both).columns) == \
        ["id", "v"]


def test_index_survives_selection(both):
    got = _same(lambda x: x.set_index("id").iloc[[3, 2]].loc[[42]], both)
    assert got["v"].tolist() == [2.5]


def test_set_index_drop_and_reset(both):
    d = [x.set_index("id") for x in both]
    assert "id" not in d[0].columns
    back = _same(lambda x: x.reset_index(), d)
    assert back.columns[0] == "id"
    assert back["id"].tolist() == [10, 7, 42, 3, 42, 19]


def test_reset_index_range_and_collision(both):
    back = _same(lambda x: x.reset_index(), both)
    assert back.columns[0] == "index"
    assert back["index"].tolist() == list(range(6))
    with pytest.raises(Exception, match="already exists"):
        both[0].set_index("id", drop=False).reset_index()


def test_index_survives_column_selection(both):
    d = [x.set_index("id") for x in both]
    assert _same(lambda x: x[["v"]].loc[[42]], d)["v"].tolist() == [2.5]
    assert _same(lambda x: x.rename({"v": "w"}).loc[42], d)["w"] \
        .tolist() == [2.5]


def test_hash_index_sentinel_probe():
    big = np.iinfo(np.int64).max
    d = DataFrame(pd.DataFrame({"k": pd.array([1, None, 3], dtype="Int64"),
                                "v": [10, 20, 30]}), device="cpu")
    idx = build_index(d.table.column("k"), d.table.nrows, IndexingType.HASH)
    _, found = idx.locate([big])
    assert not bool(found[0])
    d2 = DataFrame({"k": np.array([5, big], np.int64),
                    "v": np.array([1, 2])}, device="cpu")
    idx2 = build_index(d2.table.column("k"), d2.table.nrows,
                       IndexingType.HASH)
    pos, found = idx2.locate([big])
    assert bool(found[0]) and int(pos[0]) == 1


def test_range_index_basics(both):
    idx = both[0].index
    assert isinstance(idx, RangeIndex) and len(idx) == 6
    _, found = idx.locate([2, 99])
    assert found.tolist() == [True, False]
    assert idx.to_numpy().tolist() == list(range(6))


@pytest.mark.parametrize("probe", [[42], [3, 2, 19, 100], [7]])
def test_build_index_types_match_jax(both, probe):
    mine, theirs = both
    for ityp, cls in [("LINEAR", LinearIndex), ("HASH", HashIndex),
                      ("BTREE", HashIndex)]:
        idx = build_index(mine.table.column("id"), mine.table.nrows,
                          IndexingType[ityp])
        jidx = jbuild_index(theirs.table.column("id"), theirs.table.nrows,
                            JIndexingType[ityp])
        assert type(idx) is cls
        pos, found = idx.locate(probe)
        jpos, jfound = jidx.locate(probe)
        assert found.tolist() == np.asarray(jfound).tolist()
        ok = found.numpy()
        assert pos.numpy()[ok].tolist() == np.asarray(jpos)[ok].tolist()


def test_hash_index_with_nulls():
    df = pd.DataFrame({"k": pd.array([1, None, 3, None, 5], dtype="Int64"),
                       "v": [10, 20, 30, 40, 50]})
    d, jd = DataFrame(df, device="cpu"), JDataFrame(df)
    idx = build_index(d.table.column("k"), d.table.nrows, IndexingType.HASH)
    jidx = jbuild_index(jd.table.column("k"), jd.table.nrows,
                        JIndexingType.HASH)
    pos, found = idx.locate([3, 2])
    assert found.tolist() == np.asarray(jidx.locate([3, 2])[1]).tolist() \
        == [True, False]
    assert int(pos[0]) == 2


def test_loc_on_distributed_gathers():
    def rank(comm):
        env = ct.CylonEnv(comm)
        d = DataFrame(pd.DataFrame(DATA), env=env, device="cpu")
        return d.set_index("id").loc[[42]].to_pandas()["v"].tolist()

    assert ThreadWorld(4).run(rank) == [[2.5]] * 4
