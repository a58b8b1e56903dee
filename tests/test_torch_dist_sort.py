"""The port's distributed sort, set ops and rank-local ops at W = 4
(``ThreadWorld``) against the JAX package's on the 4-device CPU mesh
(``env4``):

- ``dist_sort``: the gathered table element for element and each rank's
  count equal to the JAX shard's, on the sample path (several keys,
  mixed directions, null keys, bytes keys, one key value holding half
  the rows, which spreads over adjacent ranks) and on the histogram path
  (int64 keys whose order keys lie in the top half of u64, float keys
  descending with NaN, a bytes key's 8-byte prefix);
- ``dist_union``, ``dist_intersect``, ``dist_subtract`` and
  ``dist_unique`` as row sets; the JAX fault C3 (a column nullable on
  one side only loses rows) held against pandas;
- ``dist_filter``, ``dist_head``, ``dist_concat``, ``colocated_join``,
  ``colocated_groupby``, ``colocated_unique``, ``dist_to_pandas`` and
  ``dist_ordered_equal_compiled`` rank by rank, and the collectives.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu import parallel as jpar
from cylon_tpu.config import SortOptions as JSortOptions
from cylon_tpu.ops import setops as jset
from cylon_tpu_torch.parallel import collectives
from cylon_tpu_torch.parallel.dtable import gather_table, scatter_table
from tests.test_torch_dist_shuffle import _rows, _shard_frame, _world
from tests.test_torch_sort import _cells, to_port

NAMES = np.array(["apple", "éclair", "", "fig", "ärger", "Zebra",
                  "Customer#0001", "Customer#0002"], object)


def _frame(seed: int = 31, n: int = 203):
    rng = np.random.default_rng(seed)
    k = pd.array(rng.integers(0, 9, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    v = rng.integers(-20, 20, n).astype(np.float64)
    v[rng.random(n) < 0.08] = np.nan
    s = NAMES[rng.integers(0, len(NAMES), n)]
    s[rng.random(n) < 0.06] = None
    hot = rng.integers(0, 50, n)
    hot[rng.random(n) < 0.5] = 7
    return pd.DataFrame({"k": k, "v": v, "s": s, "h": hot,
                         "m": rng.integers(0, 1 << 40, n),
                         "row": np.arange(n)})


#: by, ascending, histogram bins (0: the sample path), string storage
SORTS = {
    "sample_three_keys_dict": (["k", "s", "v"], [True, False, False], 0,
                               "dict"),
    "sample_bytes_desc": (["s", "row"], [False, True], 0, "bytes"),
    "sample_hot_key": (["h"], True, 0, "bytes"),
    "hist_int64": (["m"], True, 16, "dict"),
    "hist_float_desc": (["v"], False, 8, "bytes"),
    "hist_bytes": (["s"], True, 8, "bytes"),
}


@pytest.mark.parametrize("case", sorted(SORTS))
def test_dist_sort_w4_matches_jax(env4, case):
    by, asc, nbins, storage = SORTS[case]
    df = _frame()
    jt = jct.Table.from_pandas(df, string_storage=storage)
    want = jpar.dist_sort(env4, jpar.scatter_table(env4, jt), by, asc,
                          options=JSortOptions(num_bins=nbins))
    want_counts = np.asarray(want.nrows).reshape(-1).tolist()
    tt = to_port(jt)

    def rank(env):
        out = ct.dist_sort(env, scatter_table(env, tt), by, asc,
                           options=ct.SortOptions(num_bins=nbins))
        return out.num_rows, gather_table(env, out).to_pandas()

    got = _world(rank)
    assert [c for c, _ in got] == want_counts, case
    whole = got[0][1]
    assert _cells(whole) == _cells(jpar.dist_to_pandas(env4, want)), case
    assert sum(want_counts) == len(df)
    if case == "sample_hot_key":
        # the hot value (half the rows) spreads over adjacent ranks
        holders = [s for s in range(4) if (_shard_frame(want, s)["h"]
                                            == 7).any()]
        assert len(holders) >= 2 and holders == list(
            range(holders[0], holders[-1] + 1))
    # and the whole sort is pandas' stable sort
    pdf = df.sort_values(by, ascending=asc, na_position="last",
                         kind="stable")
    if case.startswith("sample"):
        assert whole["row"].tolist() == pdf["row"].tolist(), case
    else:
        assert sorted(whole["row"]) == sorted(pdf["row"])


def test_dist_sort_w1_and_options():
    """A world of one sorts locally; ``out_capacity`` keeps the
    raise-on-overflow contract; ``num_samples`` changes the splitters,
    never the sorted result."""
    df = _frame(32, 120)
    tt = ct.Table.from_pandas(df, device="cpu")
    env = ct.CylonEnv(device="cpu")
    got = ct.dist_sort(env, tt, ["k", "v"]).to_pandas()
    assert _cells(got) == _cells(ct.sort_table(tt, ["k", "v"]).to_pandas())
    with pytest.raises(ct.OutOfCapacity):
        ct.dist_sort(env, tt, "k", out_capacity=50).num_rows

    def rank(e):
        out = ct.dist_sort(e, scatter_table(e, tt), ["v", "k"],
                           options=ct.SortOptions(num_samples=3))
        return gather_table(e, out).to_pandas()

    assert _cells(_world(rank)[0]) == \
        _cells(ct.sort_table(tt, ["v", "k"]).to_pandas())


@pytest.mark.parametrize("storages", [("dict", "dict"), ("bytes", "dict")])
def test_dist_set_ops_w4_match_jax_as_row_sets(env4, storages):
    a = _frame(33, 120).drop(columns=["row", "m", "h"])
    b = pd.concat([a.iloc[::2], _frame(34, 60).drop(
        columns=["row", "m", "h"])], ignore_index=True)
    ja = jct.Table.from_pandas(a, string_storage=storages[0])
    jb = jct.Table.from_pandas(b.astype({"s": object}),
                               string_storage=storages[1])
    ta, tb = to_port(ja), to_port(jb)
    sa, sb = jpar.scatter_table(env4, ja), jpar.scatter_table(env4, jb)
    ops = ("dist_union", "dist_intersect", "dist_subtract")

    def rank(env):
        xa, xb = scatter_table(env, ta), scatter_table(env, tb)
        out = {op: gather_table(env, getattr(ct, op)(env, xa, xb))
               .to_pandas() for op in ops}
        out["dist_unique"] = gather_table(env, ct.dist_unique(
            env, xa, ["k", "s"])).to_pandas()
        return out

    got = _world(rank)[0]
    for op in ops:
        want = jpar.dist_to_pandas(env4, getattr(jpar, op)(env4, sa, sb))
        assert _rows(got[op]) == _rows(want), op
    want = jpar.dist_to_pandas(env4, jpar.dist_unique(env4, sa, ["k", "s"]))
    assert _rows(got["dist_unique"]) == _rows(want)
    assert len(got["dist_unique"]) == len(a.drop_duplicates(["k", "s"]))


def test_dist_intersect_key_nullable_on_one_side_only():
    """ROADMAP C3: 64 keys as pandas ``Int64`` (a mask) against the same
    keys as int64 (no mask). Each rank's partition hashes both sides'
    rows alike, so all 64 meet, as pandas finds; the JAX package's
    ``dist_intersect`` gives 12 here."""
    keys = np.arange(64, dtype=np.int64) * 7919
    a = pd.DataFrame({"k": pd.array(keys, dtype="Int64")})
    b = pd.DataFrame({"k": keys[::-1].copy()})
    ta = ct.Table.from_pandas(a, device="cpu")
    tb = ct.Table.from_pandas(b, device="cpu")
    assert ta.column("k").validity is None   # no null: pandas drops it
    ta = ta.add_column("k", ct.Column(ta.column("k").data,
                                      torch.ones(64, dtype=torch.bool),
                                      ta.column("k").dtype))
    want = pd.merge(a.astype(np.int64), b, on="k").drop_duplicates()

    def rank(env):
        out = ct.dist_intersect(env, scatter_table(env, ta),
                                scatter_table(env, tb))
        union = ct.dist_union(env, scatter_table(env, ta),
                              scatter_table(env, tb))
        sub = ct.dist_subtract(env, scatter_table(env, ta),
                               scatter_table(env, tb))
        return (gather_table(env, out).to_pandas(), ct.dist_num_rows(
            env, union), ct.dist_num_rows(env, sub))

    got, n_union, n_sub = _world(rank)[0]
    assert len(got) == len(want) == 64
    assert sorted(got["k"].tolist()) == sorted(want["k"].tolist())
    assert (n_union, n_sub) == (64, 0)


def test_rank_local_ops_w4_match_jax(env4):
    df = _frame(35, 150)
    jt = jct.Table.from_pandas(df)
    tt = to_port(jt)
    st = jpar.scatter_table(env4, jt)
    cap_l = st.capacity // 4
    mask = np.random.default_rng(5).random(st.capacity) < 0.5
    import jax.numpy as jnp

    want_filter = jpar.dist_filter(env4, st, jnp.asarray(mask))
    want_head = jpar.dist_head(st, 70)
    want_concat = jpar.dist_concat(env4, [st, st])
    keyed = jpar.shuffle(env4, st, ["k"])
    right = jpar.shuffle(env4, jpar.scatter_table(env4, jct.Table.from_pandas(
        df[["k", "v"]].rename(columns={"v": "w"}).iloc[:40])), ["k"])
    want_join = jpar.colocated_join(env4, keyed, right, on="k")
    want_gb = jpar.colocated_groupby(env4, keyed, ["k"],
                                     [("v", "sum"), ("row", "count")])
    want_uq = jpar.colocated_unique(env4, keyed, ["k"])
    tr = to_port(jct.Table.from_pandas(
        df[["k", "v"]].rename(columns={"v": "w"}).iloc[:40]))

    def rank(env):
        mine = scatter_table(env, tt)
        r = env.rank
        m = torch.from_numpy(mask[r * cap_l:(r + 1) * cap_l].copy())
        k = ct.shuffle(env, mine, ["k"])
        kr = ct.shuffle(env, scatter_table(env, tr), ["k"])
        return {"filter": ct.dist_filter(env, mine, m).to_pandas(),
                "head": ct.dist_head(env, mine, 70).to_pandas(),
                "concat": ct.dist_concat(env, [mine, mine]).to_pandas(),
                "join": ct.colocated_join(env, k, kr, on="k").to_pandas(),
                "groupby": ct.colocated_groupby(
                    env, k, ["k"], [("v", "sum"), ("row", "count")]
                ).to_pandas(),
                "unique": ct.colocated_unique(env, k, ["k"]).to_pandas(),
                "pandas": ct.dist_to_pandas(env, mine)}

    got = _world(rank)
    for s in range(4):
        for name, want in (("filter", want_filter), ("head", want_head),
                           ("concat", want_concat)):
            assert _cells(got[s][name]) == _cells(_shard_frame(want, s)), \
                (name, s)
        for name, want in (("join", want_join), ("groupby", want_gb),
                           ("unique", want_uq)):
            assert _rows(got[s][name]) == _rows(_shard_frame(want, s)), \
                (name, s)
        assert _cells(got[s]["pandas"]) == _cells(jpar.dist_to_pandas(
            env4, st))
    assert sum(len(g["head"]) for g in got) == 70


def test_dist_ordered_equal_and_collectives_w4(env4):
    """``dist_ordered_equal_compiled``: the same answer on every rank,
    False where one rank's rows differ; the collectives against the JAX
    package's inside ``shard_map`` (sum, prod, bitwise or, rank, world),
    and min and max of uint64 across the sign bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cylon_tpu.parallel.collectives import all_reduce, rank, world
    from cylon_tpu_torch.ops.setops import dist_ordered_equal_compiled

    frames = [_frame(36, 80), _frame(36, 80).assign(
        v=lambda d: d["v"].where(d["row"] != 70, 1e9))]
    jts = [jpar.scatter_table(env4, jct.Table.from_pandas(f))
           for f in frames]
    jwant = [bool(jset.dist_ordered_equal_compiled(jts[0], t))
             for t in jts]
    assert jwant == [True, False]
    tt, other = [to_port(jct.Table.from_pandas(f)) for f in frames]

    def body(x):
        r = rank()
        return (r[None], jnp.int32(world())[None], all_reduce(x.sum())[None],
                all_reduce(x.sum() + 1, "prod")[None],
                all_reduce(jnp.int32(1) << (r % 8), "bor")[None])

    spec = P(env4.world_axes)
    want = [np.asarray(a).tolist() for a in jax.jit(jax.shard_map(
        body, mesh=env4.mesh, in_specs=(spec,), out_specs=(spec,) * 5))(
        jnp.ones(4, jnp.int32))]

    def rank_fn(env):
        mine = scatter_table(env, tt)
        r = torch.tensor(collectives.rank(env), dtype=torch.int32)
        one = torch.ones((), dtype=torch.int32)
        # ranks 1 and 3 hold 2^63 + rank: negative as int64 bits
        u = torch.tensor([env.rank - (1 << 63) if env.rank % 2 else
                          env.rank]).view(torch.uint64)
        return ([collectives.rank(env), collectives.world(env),
                 int(collectives.all_reduce(env, one)),
                 int(collectives.all_reduce(env, one + 1, "prod")),
                 int(collectives.all_reduce(env, one << (r % 8),
                                            ct.ReduceOp.BOR))],
                [int(collectives.all_reduce(env, u, op).view(torch.int64))
                 for op in ("min", "max")],
                dist_ordered_equal_compiled(env, mine, mine),
                dist_ordered_equal_compiled(env, mine,
                                            scatter_table(env, other)))

    got = _world(rank_fn)
    for s in range(4):
        assert [got[s][0][i] for i in range(5)] == [want[i][s]
                                                    for i in range(5)]
        assert got[s][1] == [0, (1 << 63) + 3 - (1 << 64)]
        assert [got[s][2], got[s][3]] == jwant
