"""The port's hash join (``join(algorithm="hash")``) against the JAX
package's, and against pandas.

Both routes of ``algorithm="hash"`` are held element for element against
``cylon_tpu``: the bucketed build / probe (``CYLON_TPU_JOIN_HASH_IMPL=
bucketed``) and the default murmur-bucket-first sort join ("sort"); both
are deterministic from the same hashes, so ``ordered=False`` matches
exactly too. The JAX side runs its jnp twins of the bucket kernels, which
``tests/test_torch_kernels.py`` pins to the Pallas kernels in interpret
mode. The rest ports the cases of ``tests/test_hash_join.py``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.ops import hash_join as jhj
from cylon_tpu.ops.join import join as jjoin
from cylon_tpu_torch import kernels as tk
from cylon_tpu_torch.errors import InvalidArgument
from cylon_tpu_torch.ops import hash_join as thj
from cylon_tpu_torch.ops import join as tjoin_mod
from cylon_tpu_torch.ops.join import join as tjoin
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.parallel.dist_ops import dist_join
from cylon_tpu_torch.parallel.dtable import gather_table, scatter_table
from cylon_tpu_torch.table import Table
from test_torch_join import assert_same_table, to_port


@pytest.fixture
def bucketed(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "bucketed")


@pytest.fixture
def spy(monkeypatch):
    """Records which routine each port join ran: the host pre-check's
    verdicts and the bucketed core's calls."""
    seen = {"precheck": [], "bucketed": 0, "hash_first": []}
    real_check = thj.chain_overflow
    real_core = thj.bucketed_join_indices
    real_sort = tjoin_mod._join_indices

    def check(*a, **k):
        seen["precheck"].append(real_check(*a, **k))
        return seen["precheck"][-1]

    def core(*a, **k):
        seen["bucketed"] += 1
        return real_core(*a, **k)

    def sort(*a, **k):
        seen["hash_first"].append(k.get("hash_first", False))
        return real_sort(*a, **k)

    monkeypatch.setattr(thj, "chain_overflow", check)
    monkeypatch.setattr(thj, "bucketed_join_indices", core)
    monkeypatch.setattr(tjoin_mod, "_join_indices", sort)
    return seen


def _key(rng, n, dtype, nulls, hi=200):
    if dtype == "f64":
        col = pd.Series(rng.integers(0, hi, n).astype(np.float64),
                        dtype="Float64" if nulls else np.float64)
    else:
        col = pd.Series(rng.integers(0, hi, n),
                        dtype="Int64" if nulls else np.int64)
    if nulls and n:
        # every null of a build side lands in one bucket: few enough
        # that the chain stays within the width of 16
        col = col.mask(rng.random(n) < 0.04)
    return col


def _frames(rng, n, m, dtype="i64", nulls=True):
    ldf = pd.DataFrame({"k": _key(rng, n, dtype, nulls),
                        "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k": _key(rng, m, dtype, nulls),
                        "b": rng.normal(size=m)})
    return ldf, rdf


def _port(df, cap=None):
    return Table.from_pandas(df, capacity=cap, device="cpu")


def _floats(df: pd.DataFrame) -> pd.DataFrame:
    """Nulls read back as None (integers) or NaN (floats), where pandas
    writes <NA>: compare every column as float64."""
    return pd.DataFrame({c: pd.to_numeric(df[c]).astype("float64")
                         for c in df.columns})


def _assert_pandas(got: pd.DataFrame, want: pd.DataFrame, ordered=True):
    """Equal frames; with ``ordered=False`` equal as row sets."""
    got, want = _floats(got), _floats(want)
    if not ordered:
        cols = list(want.columns)
        got, want = got.sort_values(cols), want.sort_values(cols)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


# ------------------------------------------------- parity with the JAX package

@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_bucketed_join_indices_match_jax(how, ordered):
    """The core, element for element: (left_idx, right_idx, total)."""
    rng = np.random.default_rng(3)
    nl, nr, out_cap = 300, 260, 2048
    lk = rng.integers(0, 90, nl)
    rk = rng.integers(0, 90, nr)
    lv = rng.random(nl) > 0.1
    rv = rng.random(nr) > 0.1
    want = jhj.bucketed_join_indices(
        [jnp.asarray(lk)], [jnp.asarray(lv)], jnp.int32(nl - 7),
        [jnp.asarray(rk)], [jnp.asarray(rv)], jnp.int32(nr), how, out_cap,
        ordered)
    got = thj.bucketed_join_indices(
        [torch.from_numpy(lk)], [torch.from_numpy(lv)],
        torch.tensor(nl - 7, dtype=torch.int32), [torch.from_numpy(rk)],
        [torch.from_numpy(rv)], torch.tensor(nr, dtype=torch.int32), how,
        out_cap, ordered)
    assert int(got[2]) == int(want[2]) > 0
    for w, g in zip(want[:2], got[:2]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


COMBOS = [(impl, how, ordered) for impl in ("bucketed", "sort")
          for how in ("inner", "left", "right") for ordered in (True, False)]


@pytest.mark.parametrize("impl,how,ordered", COMBOS)
def test_join_hash_matches_jax(impl, how, ordered, monkeypatch, spy):
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", impl)
    rng = np.random.default_rng(11)
    ldf, rdf = _frames(rng, 173, 240)
    jl = jct.Table.from_pandas(ldf, capacity=256)
    jr = jct.Table.from_pandas(rdf, capacity=256)
    want = jjoin(jl, jr, on="k", how=how, algorithm="hash", ordered=ordered,
                 out_capacity=4096)
    got = tjoin(to_port(jl), to_port(jr), on="k", how=how, algorithm="hash",
                ordered=ordered, out_capacity=4096)
    assert_same_table(want, got)
    if impl == "bucketed":
        assert spy["precheck"] == [False] and spy["bucketed"] == 1
    else:
        assert spy["precheck"] == [] and spy["hash_first"] == [True]
    if ordered:
        _assert_pandas(got.to_pandas(), ldf.merge(rdf, on="k", how=how))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_key_nullable_on_one_side_only(rng, bucketed, spy, how):
    """Only the left key has a validity mask. The port pairs it with an
    all-valid mask on the right, so both sides hash and compare the same
    words; the JAX package's bucketed join uses the masks as they are, so
    its build and probe hashes differ and it loses matches. The reference
    here is pandas alone."""
    n = 200
    lk = pd.array(rng.integers(0, 150, n), dtype="Int64")
    lk[rng.random(n) < 0.05] = pd.NA
    ldf = pd.DataFrame({"k": lk, "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 150, n),
                        "b": rng.normal(size=n)})
    lt, rt = _port(ldf), _port(rdf)
    assert lt.column("k").validity is not None
    assert rt.column("k").validity is None
    got = tjoin(lt, rt, on="k", how=how, algorithm="hash",
                out_capacity=4096).to_pandas()
    _assert_pandas(got, ldf.merge(rdf, on="k", how=how))
    assert spy["bucketed"] == 1


def test_chain_overflow_matches_jax(rng):
    for keys, width in ((np.zeros(40, np.int64), 8),
                        (np.arange(40, dtype=np.int64), 8),
                        (np.repeat(np.arange(20), 3).astype(np.int64), 2),
                        (np.repeat(np.arange(20), 3).astype(np.int64), 3)):
        want = jhj.chain_overflow([jnp.asarray(keys)], [None],
                                  jnp.int32(len(keys)), width=width)
        got = thj.chain_overflow([torch.from_numpy(keys)], [None],
                                 torch.tensor(len(keys), dtype=torch.int32),
                                 width=width)
        assert got == want
    # padding rows never count
    assert not thj.chain_overflow([torch.zeros(40, dtype=torch.int64)],
                                  [None], torch.tensor(8, dtype=torch.int32),
                                  width=8)


def test_routing_switches_match_jax(monkeypatch):
    for env in ({}, {"CYLON_TPU_JOIN_HASH_IMPL": "bucketed",
                     "CYLON_TPU_JOIN_BUCKET_WIDTH": "4",
                     "CYLON_TPU_JOIN_ALGORITHM": "hash"},
                {"CYLON_TPU_JOIN_HASH_IMPL": "junk",
                 "CYLON_TPU_JOIN_BUCKET_WIDTH": "99"}):
        for k in ("CYLON_TPU_JOIN_HASH_IMPL", "CYLON_TPU_JOIN_BUCKET_WIDTH",
                  "CYLON_TPU_JOIN_ALGORITHM"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert thj.describe_routing() == jhj.describe_routing()
    assert thj.DEFAULT_HASH_IMPL == jhj.DEFAULT_HASH_IMPL == "sort"
    for cap in (0, 1, 16, 17, 1000, 1 << 20):
        assert thj.table_slots(cap) == jhj.table_slots(cap)


# -------------------------------------------------- cases of the JAX suite

@pytest.mark.parametrize("how", ["inner", "left", "right"])
@pytest.mark.parametrize("dtype", ["i64", "f64"])
def test_fuzz_oracle(rng, bucketed, spy, how, dtype):
    ldf, rdf = _frames(rng, 173, 240, dtype)
    got = tjoin(_port(ldf, 256), _port(rdf, 256), on="k", how=how,
                algorithm="hash", out_capacity=4096).to_pandas()
    want = ldf.merge(rdf, on="k", how=how)
    assert len(want) > 0
    _assert_pandas(got, want)
    assert spy["bucketed"] == 1


@pytest.mark.parametrize("how", ["inner", "left"])
def test_empty_and_tiny_tables(rng, bucketed, how):
    for n, m in ((0, 9), (9, 0), (1, 1), (0, 0)):
        ldf, rdf = _frames(rng, n, m)
        got = tjoin(_port(ldf, 16), _port(rdf, 16), on="k", how=how,
                    algorithm="hash", out_capacity=64).to_pandas()
        _assert_pandas(got, ldf.merge(rdf, on="k", how=how))


def test_all_duplicate_keys_take_the_sort_fallback(rng, bucketed, spy):
    n = 64
    ldf = pd.DataFrame({"k": np.zeros(n, np.int64), "a": rng.normal(size=n)})
    # the build side (the smaller capacity) holds a 40-long chain > 16
    rdf = pd.DataFrame({"k": np.zeros(40, np.int64),
                        "b": rng.normal(size=40)})
    before = tk.launch_counts()
    got = tjoin(_port(ldf), _port(rdf), on="k", how="inner",
                algorithm="hash", out_capacity=4096).to_pandas()
    _assert_pandas(got, ldf.merge(rdf, on="k"))
    assert spy["precheck"] == [True] and spy["bucketed"] == 0
    assert spy["hash_first"] == [False]   # the plain sort join
    assert tk.launch_counts() == before   # CPU: no kernel ever launches


@pytest.mark.parametrize("dups", [1, 2, 3])
def test_capacity_straddles_the_width(rng, bucketed, spy, monkeypatch, dups):
    """At width 2, chains of 1 or 2 equal keys fit (unless two keys share
    a bucket); 3 never do. Every case matches pandas."""
    monkeypatch.setenv("CYLON_TPU_JOIN_BUCKET_WIDTH", "2")
    n = 40
    k = np.repeat(np.arange(n // dups + 1), dups)[:n].astype(np.int64)
    ldf = pd.DataFrame({"k": k, "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k": rng.integers(0, n, n).astype(np.int64),
                        "b": rng.normal(size=n)})
    lt, rt = _port(ldf), _port(rdf)
    got = tjoin(lt, rt, on="k", how="inner", algorithm="hash",
                out_capacity=512).to_pandas()
    pd.testing.assert_frame_equal(
        got, tjoin(lt, rt, on="k", out_capacity=512).to_pandas())
    _assert_pandas(got, ldf.merge(rdf, on="k"), ordered=False)
    assert len(spy["precheck"]) == 1
    assert spy["bucketed"] == (0 if spy["precheck"][0] else 1)
    if dups > 2:
        assert spy["precheck"] == [True]


def test_multi_key_mixed_dtypes(rng, bucketed, spy):
    n, m = 120, 90
    ldf = pd.DataFrame({"k1": rng.integers(0, 6, n).astype(np.int64),
                        "k2": rng.integers(0, 6, n).astype(np.float64),
                        "k3": rng.integers(0, 3, n).astype(np.int32),
                        "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k1": rng.integers(0, 6, m).astype(np.int64),
                        "k2": rng.integers(0, 6, m).astype(np.float64),
                        "k3": rng.integers(0, 3, m).astype(np.int32),
                        "b": rng.normal(size=m)})
    on = ["k1", "k2", "k3"]
    got = tjoin(_port(ldf), _port(rdf), on=on, how="inner",
                algorithm="hash", out_capacity=4096).to_pandas()
    _assert_pandas(got, ldf.merge(rdf, on=on))
    assert spy["bucketed"] == 1


def test_fullouter_downgrades_with_one_warning(rng, bucketed, spy, caplog):
    tjoin_mod._warned.discard("hash-fullouter")
    ldf, rdf = _frames(rng, 30, 40)
    lt, rt = _port(ldf), _port(rdf)
    with caplog.at_level(logging.WARNING, logger="cylon_tpu_torch"):
        for _ in range(2):
            got = tjoin(lt, rt, on="k", how="outer", algorithm="hash",
                        out_capacity=512).to_pandas()
    want = tjoin(lt, rt, on="k", how="outer", out_capacity=512).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    warns = [r for r in caplog.records
             if "bucketed hash join" in r.getMessage()]
    assert len(warns) == 1
    assert spy["bucketed"] == 0 and spy["precheck"] == []


def test_env_algorithm_overrides_the_hint(rng, bucketed, spy, monkeypatch):
    ldf, rdf = _frames(rng, 50, 50, nulls=False)
    lt, rt = _port(ldf), _port(rdf)
    want = tjoin(lt, rt, on="k", out_capacity=512).to_pandas()
    assert spy["bucketed"] == 0
    monkeypatch.setenv("CYLON_TPU_JOIN_ALGORITHM", "hash")
    got = tjoin(lt, rt, on="k", algorithm="sort", out_capacity=512
                ).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert spy["bucketed"] == 1
    monkeypatch.setenv("CYLON_TPU_JOIN_ALGORITHM", "sort")
    tjoin(lt, rt, on="k", algorithm="hash", out_capacity=512)
    assert spy["bucketed"] == 1


def test_hash_impl_sort_keeps_hash_sort(rng, spy, monkeypatch):
    monkeypatch.setenv("CYLON_TPU_JOIN_HASH_IMPL", "sort")
    ldf, rdf = _frames(rng, 64, 64, nulls=False)
    lt, rt = _port(ldf), _port(rdf)
    got = tjoin(lt, rt, on="k", algorithm="hash", out_capacity=512
                ).to_pandas()
    want = tjoin(lt, rt, on="k", out_capacity=512).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert spy["hash_first"] == [True, False] and spy["bucketed"] == 0


def test_chain_entries_ascend_by_row_id(rng):
    bids = torch.from_numpy(rng.integers(0, 8, 120).astype(np.int32))
    table, overflow = tk.bucket_build(bids, 8, 30)
    assert int(overflow) == 0
    t = table.numpy()
    for b in range(8):
        chain = t[:, b][t[:, b] >= 0]
        assert len(chain) == int((bids == b).sum())
        assert (np.diff(chain) > 0).all()


def test_ordered_false_gives_the_same_row_set(rng, bucketed):
    ldf, rdf = _frames(rng, 150, 170)
    lt, rt = _port(ldf, 256), _port(rdf, 256)
    want = tjoin(lt, rt, on="k", ordered=False, out_capacity=4096)
    got = tjoin(lt, rt, on="k", algorithm="hash", ordered=False,
                out_capacity=4096)
    _assert_pandas(got.to_pandas(), want.to_pandas(), ordered=False)


def test_sort_fallback_of_the_core(rng):
    """With ``sort_fallback``, an overflowing build returns the fallback's
    result (the eager counterpart of the JAX ``lax.cond``)."""
    k = torch.zeros(40, dtype=torch.int64)
    rows = torch.tensor(40, dtype=torch.int32)
    marker = (torch.zeros(1), torch.zeros(1), torch.tensor(-5))
    out = thj.bucketed_join_indices([k], [None], rows, [k], [None], rows,
                                    "inner", 64, True,
                                    sort_fallback=lambda: marker)
    assert out is marker
    ok = thj.bucketed_join_indices([k[:4]], [None], torch.tensor(4),
                                   [k[:4]], [None], torch.tensor(4),
                                   "inner", 64, True,
                                   sort_fallback=lambda: marker)
    assert int(ok[2]) == 16


@pytest.mark.parametrize("hi", [1000, 3])   # clean / every chain overflows
def test_dist_join_w4_hash_matches_pandas(rng, bucketed, spy, hi):
    n = 160
    ldf = pd.DataFrame({"k": rng.integers(0, hi, n).astype(np.int64),
                        "a": rng.normal(size=n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 1000, n).astype(np.int64),
                        "b": rng.normal(size=n)})
    tl, tr = _port(ldf), _port(rdf)

    def rank(comm):
        env = CylonEnv(comm)
        res = dist_join(env, scatter_table(env, tl), scatter_table(env, tr),
                        on="k", algorithm="hash")
        return gather_table(env, res).to_pandas()

    got = ThreadWorld(4).run(rank)[0]
    _assert_pandas(got, ldf.merge(rdf, on="k"), ordered=False)
    # one host pre-check a rank and attempt (the regrow loop may retry);
    # each clean rank takes the bucketed core, the others the sort join
    assert len(spy["precheck"]) % 4 == 0
    assert spy["bucketed"] == spy["precheck"].count(False)
    assert (hi == 3) == any(spy["precheck"])


def test_dist_join_w1_hash_is_the_local_join(rng, bucketed, spy):
    ldf, rdf = _frames(rng, 90, 120)
    got = dist_join(CylonEnv(), _port(ldf), _port(rdf), on="k",
                    algorithm="hash")
    _assert_pandas(got.to_pandas(), ldf.merge(rdf, on="k"), ordered=False)
    assert spy["bucketed"] == 1


def test_string_keys_still_raise():
    """String keys join by hash now (``tests/test_torch_strings.py``);
    a string key against a numeric one still raises."""
    t = Table.from_pydict({"k": np.array(["a", "b"], dtype=object)},
                          device="cpu")
    u = Table.from_pydict({"k": np.array([1, 2])}, device="cpu")
    with pytest.raises(InvalidArgument):
        tjoin(t, u, on="k", algorithm="hash")
    assert tjoin(t, t, on="k", algorithm="hash").num_rows == 2
