"""The two-tier (slice x worker) world of the port against the JAX
package's hierarchical mesh and against the port's own flat world.

The JAX package builds a 2-slice x 4-worker mesh out of the 8 virtual
CPU devices (``CylonEnv(TPUConfig(devices_per_slice=4))``) and stages
every table exchange through it (``cylon_tpu/parallel/shuffle.py``
``_exchange_hier``). The port's counterpart is ``ThreadWorld(8,
devices_per_slice=4)``: each rank's communicator carries an ``intra``
sub-communicator over its slice and an ``inter`` one over the ranks of
its local index. Every distributed operator on it gives each rank the
same bits as the flat ``ThreadWorld(8)``; ``shuffle`` equals the JAX
mesh shard for shard, element for element; the rest equal pandas as row
sets. Inputs are the JAX tests' sizes (n = 2000, 120 keys).
"""

import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu_torch import Table, convert, plan, telemetry
from cylon_tpu_torch.context import CylonEnv, DistConfig
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.ops.hash import partition_ids
from cylon_tpu_torch.ops_graph import DisJoinOp, chunk_stream
from cylon_tpu_torch.parallel import collectives
from cylon_tpu_torch.parallel.comm import LocalComm, ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import (dist_aggregate, dist_groupby,
                                               dist_join, dist_sort,
                                               dist_union, dist_unique,
                                               repartition, shuffle)
from cylon_tpu_torch.parallel.dtable import (dist_num_rows, dist_to_pandas,
                                             scatter_table)

W, L = 8, 4
HOWS = ("inner", "left", "outer")


def _frames(seed: int = 17, n: int = 2000, nkeys: int = 120):
    rng = np.random.default_rng(seed)
    lp = pd.DataFrame({"k": rng.integers(0, nkeys, n).astype(np.int64),
                       "a": rng.normal(size=n)})
    rp = pd.DataFrame({"k": rng.integers(0, nkeys, n).astype(np.int64),
                       "b": rng.normal(size=n)})
    xa = pd.DataFrame({"x": rng.integers(0, 50, 600).astype(np.int64)})
    xb = pd.DataFrame({"x": rng.integers(25, 75, 600).astype(np.int64)})
    return lp, rp, xa, xb


LP, RP, XA, XB = _frames()


def _port(df):
    return Table.from_pandas(df, device="cpu")


def _valid(table):
    """A table's valid rows as host arrays: ``{name: data}``."""
    cols, n = convert.to_arrays(table)
    return {k: d[:n] for k, (d, _, _) in cols.items()}


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _run(env) -> dict:
    """Every distributed operator of the slice on this rank's shards."""
    lt, rt = scatter_table(env, _port(LP)), scatter_table(env, _port(RP))
    xa, xb = scatter_table(env, _port(XA)), scatter_table(env, _port(XB))
    out = {"shuffle": _valid(shuffle(env, lt, ["k"]))}
    for how in HOWS:
        out[f"join_{how}"] = _valid(dist_join(env, lt, rt, on="k", how=how))
    out["groupby"] = _valid(dist_groupby(
        env, lt, ["k"], [("a", "sum"), ("a", "count"), ("a", "min")]))
    out["sort"] = _valid(dist_sort(env, lt, "k"))
    out["union"] = _valid(dist_union(env, xa, xb))
    out["unique"] = _valid(dist_unique(env, xa))
    out["repartition"] = _valid(repartition(env, lt))
    out["aggregate_sum"] = {"v": dist_aggregate(env, lt, "a", "sum").numpy()}
    out["aggregate_count"] = {
        "v": dist_aggregate(env, lt, "a", "count").numpy()}
    out["collectives"] = {
        "rank": np.array([collectives.rank(env)]),
        "world": np.array([collectives.world(env)]),
        "sum": collectives.all_reduce(
            env, torch.tensor([env.rank + 1])).numpy(),
        "bor": collectives.all_reduce(
            env, torch.tensor([1 << env.rank]), "bor").numpy()}
    return out


def _world(fn, per=None, **kw):
    return ThreadWorld(W, devices_per_slice=per, **kw).run(
        lambda comm: fn(CylonEnv(comm)))


@pytest.fixture(scope="module")
def worlds():
    """``(hierarchical results, flat results)``, a dict a rank each."""
    return _world(_run, L), _world(_run)


@pytest.fixture(scope="module")
def henv():
    """The JAX package's 2 slices x 4 workers over the 8 CPU devices."""
    return jct.CylonEnv(jct.TPUConfig(devices_per_slice=4))


def _gathered(results, name) -> pd.DataFrame:
    return pd.concat([pd.DataFrame(r[name]) for r in results],
                     ignore_index=True)


def _sorted(df, cols):
    return df[cols].sort_values(cols).reset_index(drop=True)


# ----------------------------------------------------------- topology
def test_topology():
    def rank(env):
        c = env.comm
        return (env.is_hierarchical, env.n_slices, env.devices_per_slice,
                env.world_size, c.intra.rank, c.intra.world_size,
                c.inter.rank, c.inter.world_size)

    got = _world(rank, L)
    assert got == [(True, 2, 4, 8, r % 4, 4, r // 4, 2) for r in range(W)]


def test_flat_default():
    """A world without ``devices_per_slice``, or with a slice of the
    whole world, is flat, as is the world of one rank."""
    def rank(env):
        return (env.is_hierarchical, env.n_slices, env.devices_per_slice,
                env.comm.intra, env.comm.inter)

    want = [(False, 1, W, None, None)] * W
    assert _world(rank) == want
    assert _world(rank, W) == want
    env = CylonEnv(LocalComm())
    assert (env.is_hierarchical, env.n_slices, env.devices_per_slice) \
        == (False, 1, 1)


def test_devices_per_slice_must_divide_the_world():
    for per in (3, 5, 0, -4):
        with pytest.raises(InvalidArgument):
            ThreadWorld(W, devices_per_slice=per)
        with pytest.raises(InvalidArgument):
            DistConfig(devices_per_slice=per).slice_split(W)
    with pytest.raises(ValueError):   # the JAX package's rule
        jct.CylonEnv(jct.TPUConfig(devices_per_slice=3))


def test_dist_config_split_rules(monkeypatch):
    """``_slice_split``'s rules: None splits by ``devices_per_slice`` or
    by ``torchrun``'s ``LOCAL_WORLD_SIZE`` below the world; False stays
    flat; True with neither raises (no quiet flat world)."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert DistConfig().slice_split(8) is None
    assert DistConfig(devices_per_slice=4).slice_split(8) == 4
    assert DistConfig(hierarchical=False,
                      devices_per_slice=4).slice_split(8) is None
    with pytest.raises(InvalidArgument):
        DistConfig(hierarchical=True).slice_split(8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")   # one node of 8
    assert DistConfig().slice_split(8) is None
    with pytest.raises(InvalidArgument):
        DistConfig(hierarchical=True).slice_split(8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")   # four nodes of 2
    assert DistConfig().slice_split(8) == 2
    assert DistConfig(hierarchical=True).slice_split(8) == 2
    assert DistConfig(devices_per_slice=4).slice_split(8) == 4
    assert DistConfig(hierarchical=False).slice_split(8) is None


def test_hierarchical_true_on_one_node_raises(tmp_path, monkeypatch):
    """``DistConfig(hierarchical=True)`` on a world of one node with no
    ``devices_per_slice`` raises, and leaves no process group behind."""
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(InvalidArgument):
        CylonEnv(config=DistConfig(
            backend="gloo", init_method=f"file://{tmp_path / 'store'}",
            world_size=1, rank=0, hierarchical=True), device="cpu")
    assert not dist.is_initialized()


def test_comm_without_a_sub_communicator_raises():
    comm = ThreadWorld(W, devices_per_slice=L).comms()[5]
    comm.inter = None
    with pytest.raises(InvalidArgument):
        CylonEnv(comm)
    comm = ThreadWorld(W, devices_per_slice=L).comms()[5]
    comm.intra, comm.inter = comm.inter, comm.intra   # not slice-major
    with pytest.raises(InvalidArgument):
        CylonEnv(comm)


# ---------------------------------------------- the operators, hier = flat
@pytest.mark.parametrize("name", [
    "shuffle", "join_inner", "join_left", "join_outer", "groupby", "sort",
    "union", "unique", "repartition", "aggregate_sum", "aggregate_count",
    "collectives"])
def test_hierarchical_bits_equal_flat(worlds, name):
    hier, flat = worlds
    for r in range(W):
        assert _same_bits(hier[r][name], flat[r][name]), (name, r)


def test_shuffle_matches_jax_hierarchical_mesh(worlds, henv):
    """Each rank's rows equal the JAX hierarchical shard's valid rows,
    element for element."""
    hier, _ = worlds
    want = jshuffle(henv, jscatter(henv, jct.Table.from_pandas(LP)), ["k"])
    counts = np.asarray(want.nrows).reshape(-1)
    cap_l = want.capacity // W
    for s in range(W):
        for c in ("k", "a"):
            col = np.asarray(want.column(c).data)[s * cap_l:
                                                  s * cap_l + counts[s]]
            np.testing.assert_array_equal(hier[s]["shuffle"][c], col)
    keys = [set(h["shuffle"]["k"].tolist()) for h in hier]
    assert all(not (keys[i] & keys[j]) for i in range(W)
               for j in range(i + 1, W))


@pytest.mark.parametrize("how", HOWS)
def test_join_matches_pandas(worlds, how):
    got = _gathered(worlds[0], f"join_{how}")
    want = LP.merge(RP, on="k", how=how)
    cols = ["k", "a", "b"]
    pd.testing.assert_frame_equal(_sorted(got, cols), _sorted(want, cols),
                                  check_dtype=False)


def test_groupby_sort_union_unique_match_pandas(worlds):
    hier, _ = worlds
    g = _gathered(hier, "groupby").sort_values("k").reset_index(drop=True)
    want = LP.groupby("k", as_index=False).agg(
        a_sum=("a", "sum"), a_count=("a", "count"), a_min=("a", "min"))
    np.testing.assert_array_equal(g["k"], want["k"])
    np.testing.assert_allclose(g["a_sum"], want["a_sum"], rtol=1e-12)
    np.testing.assert_array_equal(g["a_count"], want["a_count"])
    np.testing.assert_array_equal(g["a_min"], want["a_min"])
    # dist_sort: each rank sorted, the ranks in key order
    np.testing.assert_array_equal(
        np.concatenate([h["sort"]["k"] for h in hier]), np.sort(LP["k"]))
    np.testing.assert_array_equal(np.sort(_gathered(hier, "union")["x"]),
                                  np.union1d(XA["x"], XB["x"]))
    np.testing.assert_array_equal(np.sort(_gathered(hier, "unique")["x"]),
                                  np.unique(XA["x"]))


def test_aggregate_repartition_and_collectives_span_the_world(worlds):
    hier, _ = worlds
    for r, h in enumerate(hier):
        np.testing.assert_allclose(h["aggregate_sum"]["v"], LP["a"].sum(),
                                   rtol=1e-12)
        assert int(h["aggregate_count"]["v"]) == len(LP)
        c = h["collectives"]
        assert (int(c["rank"][0]), int(c["world"][0])) == (r, W)
        assert int(c["sum"][0]) == W * (W + 1) // 2
        assert int(c["bor"][0]) == (1 << W) - 1
    counts = [len(h["repartition"]["k"]) for h in hier]
    assert sum(counts) == len(LP) and max(counts) - min(counts) <= 1


# ---------------------------------------------------- capacity and skew
def test_overflow_raises_out_of_capacity():
    """All keys 0: every row goes to one rank, far past ``out_capacity``
    64 (8 a rank). The stage-1 receive is exact and cannot overflow; the
    final one does, and the count raises."""
    t = _port(pd.DataFrame({"k": np.zeros(512, np.int64),
                            "v": np.arange(512, dtype=np.float64)}))

    def rank(env):
        sh = shuffle(env, scatter_table(env, t), ["k"], out_capacity=64)
        with pytest.raises(OutOfCapacity):
            dist_num_rows(env, sh)
        return True

    assert _world(rank, L) == [True] * W


def _gateway_concentration_keys():
    """The JAX test's keys (``tests/test_hierarchical.py:225-253``):
    slice 0's rows lean on local index 2 (destinations 2 and 6), so its
    gateway (0, 2) takes 900 rows in stage 1, 1.5x the 600-row final
    buffer of the JAX package's skew sizing, while no destination takes
    more than 600."""
    rng = np.random.default_rng(7)
    cand = np.arange(200_000, dtype=np.int64)
    pid = partition_ids([torch.from_numpy(cand)], W).numpy()
    by_pid = {p: cand[pid == p] for p in range(W)}
    s0 = np.concatenate([by_pid[2][:400], by_pid[6][:400]]
                        + [by_pid[p][1000:1050] for p in range(W)])
    s1 = np.concatenate([by_pid[p][2000:2150] for p in range(W)])
    keys = np.concatenate([rng.permutation(s0), rng.permutation(s1)])
    fin = np.bincount(partition_ids([torch.from_numpy(keys)], W).numpy(),
                      minlength=W)
    assert fin.max() <= 600, fin
    assert (partition_ids([torch.from_numpy(keys[:1200])], W).numpy()
            % L == 2).sum() == 900
    return keys


def test_gateway_concentration_needs_no_regrow_of_its_own():
    """Gateway concentration completes with the flat world's regrows
    and the flat world's final capacity: the stage-1 receive is sized
    from its own exact counts, so the gateway's 900 rows cost no
    regrow."""
    keys = _gateway_concentration_keys()
    t = _port(pd.DataFrame({"k": keys,
                            "v": np.arange(len(keys), dtype=np.int64)}))

    def rank(env):
        res = shuffle(env, scatter_table(env, t), ["k"])
        return res.capacity, dist_num_rows(env, res), _valid(res)

    got = {}
    for per in (L, None):
        before = telemetry.total("exchange.fallback_regrows")
        got[per] = (_world(rank, per),
                    telemetry.total("exchange.fallback_regrows") - before)
    (hier, hier_regrows), (flat, flat_regrows) = got[L], got[None]
    assert hier_regrows == flat_regrows
    assert [h[0] for h in hier] == [f[0] for f in flat]
    assert all(h[1] == len(keys) for h in hier)
    assert all(_same_bits(h[2], f[2]) for h, f in zip(hier, flat))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([h[2]["k"] for h in hier])), np.sort(keys))


# --------------------------------------------- arguments and telemetry
def test_bucket_cap_raises_on_a_hierarchical_world():
    lt = _port(LP.head(200))

    def rank(env):
        mine = scatter_table(env, lt)
        if env.is_hierarchical:
            with pytest.raises(InvalidArgument):
                shuffle(env, mine, ["k"], bucket_cap=64)
        else:
            shuffle(env, mine, ["k"], bucket_cap=64)
        return True

    assert _world(rank, L) == [True] * W
    assert _world(rank) == [True] * W


def test_pad_ratio_prices_both_stages_and_the_rider():
    """For rows of w u32 words each row crosses stage 1 with its rider
    (w + 1 words) and stage 2 without (w): the ratio is (2w + 1) / w on
    every rank, and the world's true bytes are the flat world's.
    The ledger keeps each stage with its group's count matrix."""
    from cylon_tpu_torch.parallel.shuffle import exchange_arrays

    lt = _port(LP)
    t3 = _port(pd.DataFrame({"k": LP["k"], "i": LP["k"].astype(np.int32)}))
    for table, words in ((lt, 4), (t3, 3)):
        totals = {}
        for per in (L, None):
            telemetry.reset("exchange.")
            _world(lambda env: shuffle(env, scatter_table(env, table),
                                       ["k"]).capacity, per)
            snap = telemetry.snapshot()
            path = "hier" if per else "ragged"
            assert snap[f"exchange.calls{{op=shuffle,path={path}}}"][
                "value"] == W
            totals[per] = (telemetry.total("exchange.bytes_true"),
                           telemetry.total("exchange.bytes_padded"),
                           snap["exchange.pad_ratio{op=shuffle}"]["value"])
        assert totals[L][0] == totals[None][0] == len(LP) * words * 4
        assert totals[L][2] == (2 * words + 1) / words
        assert totals[L][1] == len(LP) * (2 * words + 1) * 4
        assert totals[None][1] == totals[None][0]

    def rank(env):
        ledger = []
        lt_ = scatter_table(env, lt)
        exchange_arrays(env.comm, [lt_.column("k").data],
                        partition_ids([lt_.column("k").data], W),
                        lt_.nrows, 1024, ledger)
        return [(s.stage, tuple(s.cmat.shape), s.words, s.ranks)
                for s in ledger]

    got = _world(rank, L)
    for r, stages in enumerate(got):
        sl, j = divmod(r, L)
        assert stages == [
            ("intra", (L, L), 3, [sl * L + i for i in range(L)]),
            ("inter", (W // L, W // L), 2, [j, j + L])]


# ------------------------------------------- the streaming graph, plans
def test_streaming_join_and_compiled_query():
    """``DisJoinOp``'s per-chunk exchange and a ``CompiledQuery`` ride
    the two stages; each equals pandas."""
    lp, rp = LP.head(1200), RP.head(1200)
    lt, rt = _port(lp), _port(rp)

    def q(env, lt_, rt_):
        return dist_aggregate(env, dist_join(env, lt_, rt_, on="k"), "a",
                              "sum")

    compiled = plan.compile_query(q)

    def rank(env):
        g = DisJoinOp("k", env=env, how="inner")
        for c in chunk_stream(scatter_table(env, lt), 256, env):
            g.insert_left(c)
        for c in chunk_stream(scatter_table(env, rt), 256, env):
            g.insert_right(c)
        streamed = dist_to_pandas(env, g.result())
        total = compiled(env, scatter_table(env, lt),
                         scatter_table(env, rt))
        return streamed, float(total)

    want = lp.merge(rp, on="k")
    cols = ["k", "a", "b"]
    for streamed, total in _world(rank, L):
        pd.testing.assert_frame_equal(_sorted(streamed, cols),
                                      _sorted(want, cols),
                                      check_dtype=False)
        np.testing.assert_allclose(total, want["a"].sum(), rtol=1e-12)


# --------------------------------------------------------- failure
def test_a_rank_that_raises_mid_stage_frees_its_peers():
    """Rank 5 raises inside the inter stage of a shuffle: its lane peer
    waits on the inter sub-world's barrier, the others on the world's.
    ``run`` breaks every barrier, so the world raises within seconds,
    not at the 30 s timeout."""
    lt = _port(LP)

    def boom(*args, **kwargs):
        raise RuntimeError("rank 5 fails mid-stage")

    def rank(comm):
        if comm.rank == 5:
            comm.inter.exchange = boom
        env = CylonEnv(comm)
        return shuffle(env, scatter_table(env, lt), ["k"])

    before = threading.active_count()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="mid-stage"):
        ThreadWorld(W, timeout=30, devices_per_slice=L).run(rank)
    assert time.monotonic() - t0 < 10
    assert threading.active_count() == before
