"""The communicators against each other: ``ProcessGroupComm`` over gloo
in W real processes (W = 4 and W = 1; ``spawn`` start method, rendezvous
through a ``FileStore`` in a temporary directory, every process joined
under a timeout) against ``ThreadWorld`` on the same inputs. W = 4 also
runs as two tiers, 2 slices of 2 ranks: by ``DistConfig(devices_per_slice
=2)`` and by ``torchrun``'s variables (``LOCAL_WORLD_SIZE=2``,
``WORLD_SIZE=4``), each against the flat ``ThreadWorld(4)``.

Collectives: ``all_gather`` (int64 and bool), ``all_reduce`` (sum, min
and max of int64 and float64: the same bits on every rank) and
``exchange`` with ragged splits and zero rows between some pairs. Then
``dist_join``, ``shuffle``, ``repartition``, ``dist_groupby`` (both
paths) and ``dist_aggregate`` through each: per rank bit for bit.

No JAX here: every spawned process imports this module.
"""

import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest
import torch

from cylon_tpu_torch import Table, convert
from cylon_tpu_torch.context import CylonEnv, DistConfig, LocalConfig
from cylon_tpu_torch.errors import DeviceUnavailable, InvalidArgument
from cylon_tpu_torch.parallel.comm import LocalComm, ProcessGroupComm, \
    ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import (dist_aggregate, dist_groupby,
                                               dist_join, repartition,
                                               shuffle)
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.telemetry.aggregate import _gathers

#: seconds a world of processes may take, start to end
TIMEOUT = 180
FLOATS = (0.1, 1e16, -1e16, 1 / 3, 2.5e-8)


def _tables():
    rng = np.random.default_rng(31)
    n = 300
    names = np.array(["ant", "bee", "", "cow", "éclair"], object)
    left = Table.from_pydict({
        "k": rng.integers(0, 50, n), "s": names[rng.integers(0, 5, n)],
        "v": rng.normal(size=n)}, device="cpu")
    right = Table.from_pydict({
        "k": rng.integers(0, 50, n // 2),
        "w": rng.integers(-99, 99, n // 2)}, device="cpu")
    return left, right


def _valid(table):
    """A table's valid rows as host arrays: ``(nrows, {name: (data,
    validity)})``."""
    cols, n = convert.to_arrays(table)
    return n, {k: (d[:n], None if v is None else v[:n])
               for k, (d, v, _) in cols.items()}


def _collectives(env) -> dict:
    comm = env.comm
    r, w = env.rank, env.world_size
    out = {"all_gather": comm.all_gather(
               torch.arange(3, dtype=torch.int64) + 10 * r).numpy(),
           "all_gather_bool": comm.all_gather(
               torch.tensor([r % 2 == 0, True, r == 0])).numpy(),
           "all_gather_empty": comm.all_gather(
               torch.zeros(0, dtype=torch.int64)).numpy()}
    for dt in (torch.int64, torch.float64):
        x = (torch.tensor(FLOATS, dtype=torch.float64) * (r + 1) * 7).to(dt)
        for op in ("sum", "min", "max"):
            out[f"all_reduce_{op}_{dt}"] = comm.all_reduce(x, op).numpy()
    out["all_reduce_0d"] = comm.all_reduce(
        torch.tensor(FLOATS[r % len(FLOATS)], dtype=torch.float64),
        "sum").numpy()
    # ragged: (s + d) % 3 rows from rank s to rank d, zero for some pairs
    send_counts = [(r + d) % 3 for d in range(w)]
    rows = sum(send_counts)
    send = torch.arange(2 * rows, dtype=torch.int32).view(rows, 2) + 1000 * r
    out["exchange"] = comm.exchange(send, send_counts,
                                    [(s + r) % 3 for s in range(w)]).numpy()
    return out


def _operators(env) -> dict:
    left, right = _tables()
    lt, rt = scatter_table(env, left), scatter_table(env, right)
    out = {
        "dist_join": _valid(dist_join(env, lt, rt, on="k")),
        "shuffle": _valid(shuffle(env, lt, ["s"])),
        "shuffle_modulo": _valid(shuffle(env, lt, ["k"],
                                         partitioning="modulo")),
        "repartition": _valid(repartition(env, rt)),
        "dist_groupby": _valid(dist_groupby(
            env, lt, ["s"], [("v", "sum"), ("v", "std"), ("k", "max")])),
        "dist_groupby_raw": _valid(dist_groupby(
            env, lt, ["k"], [("v", "median"), ("s", "nunique")])),
    }
    for op in ("sum", "mean", "var", "min", "nunique", "median"):
        out[f"dist_aggregate_{op}"] = dist_aggregate(env, lt, "v",
                                                     op).numpy()
    out["dist_aggregate_sketch"] = dist_aggregate(
        env, lt, "v", "quantile", quantile=0.9, exact=False).numpy()
    return out


def _run(env) -> dict:
    return {**_collectives(env), **_operators(env)}


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               tiers: "str | None") -> None:
    """One spawned rank: join the gloo group (two tiers of slices of 2
    when ``tiers`` is ``"config"`` or ``"torchrun"``), run everything,
    write the results where the parent reads them."""
    per = None
    if tiers == "config":
        per = 2
    elif tiers == "torchrun":
        os.environ.update(LOCAL_WORLD_SIZE="2", WORLD_SIZE=str(world))
    env = CylonEnv(config=DistConfig(backend="gloo",
                                     init_method=f"file://{store}",
                                     world_size=world, rank=rank,
                                     devices_per_slice=per),
                   device="cpu")
    try:
        assert isinstance(env.comm, ProcessGroupComm)
        res = _run(env)
        res["topology"] = (env.is_hierarchical, env.n_slices,
                           env.devices_per_slice, _gathers(env))
    finally:
        env.finalize()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _spawn_world(world: int, tmp, tiers: "str | None" = None) -> list:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp / "store"), str(tmp), tiers))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks still ran after " \
        f"{TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module",
                params=[(4, None), (1, None), (4, "config"),
                        (4, "torchrun")],
                ids=["w4", "w1", "w4_tiers", "w4_torchrun_tiers"])
def worlds(request, tmp_path_factory):
    """``(gloo results, ThreadWorld results)``, a dict a rank each; the
    threads are a flat world, whatever the gloo world's tiers."""
    w, tiers = request.param
    gloo = _spawn_world(w, tmp_path_factory.mktemp(f"gloo{w}"), tiers)
    threads = ThreadWorld(w).run(lambda comm: _run(CylonEnv(comm)))
    return gloo, threads


def test_topology(worlds, request):
    """The two-tier gloo worlds are 2 slices of 2 ranks; the others
    flat. Each rank of a world of processes, two-tier or not, holds a
    registry of its own, so telemetry gathers over it."""
    gloo, _ = worlds
    w, tiers = request.node.callspec.params["worlds"]
    want = (True, 2, 2, True) if tiers else (False, 1, w, w > 1)
    assert [res["topology"] for res in gloo] == [want] * w


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bits(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    if a is None or isinstance(a, int):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object:
        return a.shape == b.shape and a.tolist() == b.tolist()
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_all_gather(worlds):
    gloo, _ = worlds
    w = len(gloo)
    want = np.arange(3) + 10 * np.arange(w)[:, None]
    for res in gloo:
        np.testing.assert_array_equal(res["all_gather"], want)
        assert res["all_gather_bool"].dtype == np.bool_
        np.testing.assert_array_equal(
            res["all_gather_bool"],
            [[s % 2 == 0, True, s == 0] for s in range(w)])
        assert res["all_gather_empty"].shape == (w, 0)


def test_all_reduce_same_bits_on_every_rank(worlds):
    """Folded in rank order: every rank's result has the same bits, those
    of a sequential fold from rank 0, in gloo and in threads alike."""
    gloo, threads = worlds
    w = len(gloo)
    base = np.array(FLOATS)
    ranks = [base * (r + 1) * 7 for r in range(w)]
    for name in [k for k in gloo[0] if k.startswith("all_reduce")]:
        for res in gloo + threads:
            assert _same_bits(res[name], gloo[0][name]), name
    for dt, cast in (("torch.int64", np.int64), ("torch.float64", None)):
        vals = [x.astype(np.int64) if cast else x for x in ranks]
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        assert _same_bits(gloo[0][f"all_reduce_sum_{dt}"], acc)
        assert _same_bits(gloo[0][f"all_reduce_min_{dt}"],
                          np.min(vals, axis=0))
        assert _same_bits(gloo[0][f"all_reduce_max_{dt}"],
                          np.max(vals, axis=0))


def test_exchange_ragged_and_empty_splits(worlds):
    gloo, threads = worlds
    w = len(gloo)
    for r, res in enumerate(gloo):
        parts = []
        for s in range(w):
            counts = [(s + d) % 3 for d in range(w)]
            send = np.arange(2 * sum(counts), dtype=np.int32).reshape(-1, 2) \
                + 1000 * s
            off = sum(counts[:r])
            parts.append(send[off:off + counts[r]])
        want = np.concatenate(parts)
        assert res["exchange"].shape == (sum((s + r) % 3 for s in range(w)),
                                         2)
        np.testing.assert_array_equal(res["exchange"], want)
        assert _same_bits(res["exchange"], threads[r]["exchange"])


@pytest.mark.parametrize("name", [
    "dist_join", "shuffle", "shuffle_modulo", "repartition", "dist_groupby",
    "dist_groupby_raw", "dist_aggregate_sum", "dist_aggregate_mean",
    "dist_aggregate_var", "dist_aggregate_min", "dist_aggregate_nunique",
    "dist_aggregate_median", "dist_aggregate_sketch"])
def test_operator_bits_equal_thread_world(worlds, name):
    gloo, threads = worlds
    for r, (a, b) in enumerate(zip(gloo, threads)):
        assert _same_bits(a[name], b[name]), (name, r)
    if name.startswith("dist_aggregate"):
        assert all(_same_bits(res[name], gloo[0][name]) for res in gloo)


def test_dist_config_without_a_card(monkeypatch):
    """NCCL (the default for a CUDA env) without a card raises and never
    becomes gloo; no process group is left behind."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        CylonEnv(config=DistConfig(init_method="file:///nonexistent",
                                   world_size=1, rank=0))
    with pytest.raises(DeviceUnavailable):
        CylonEnv(config=DistConfig(backend="nccl"), device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(InvalidArgument):
        ProcessGroupComm()


def test_local_config_and_comm():
    assert isinstance(CylonEnv().comm, LocalComm)
    assert isinstance(CylonEnv(LocalConfig()).comm, LocalComm)
    assert isinstance(CylonEnv(config=LocalConfig()).comm, LocalComm)
    comm = LocalComm()
    assert CylonEnv(comm).comm is comm
    with pytest.raises(InvalidArgument):
        CylonEnv(comm, config=LocalConfig())
    x = torch.tensor([1.5, -2.0], dtype=torch.float64)
    assert _same_bits(comm.all_reduce(x, "sum").numpy(), x.numpy())
    with pytest.raises(InvalidArgument):
        comm.all_reduce(x, "prod")


def test_layout_header_carries_row_counts():
    """``world_layout_sized`` reads every rank's row count with its
    capacity from its one header gather: shards of other capacities, an
    empty one and a poisoned one (``nrows == capacity + 1``)."""
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.parallel.dtable import world_layout_sized

    caps, rows = [5, 0, 9, 3], [4, 0, 9, 4]

    def rank(comm):
        r = comm.rank
        t = Table({"k": Column(torch.arange(caps[r]), None, dtypes.int64)},
                  rows[r])
        return world_layout_sized(CylonEnv(comm), t)[1:]

    assert ThreadWorld(4).run(rank) == [(rows, caps)] * 4


@pytest.mark.parametrize("op", ["shuffle", "repartition", "dist_groupby",
                                "dist_join"])
def test_exchange_operators_gather_no_sizes_of_their_own(monkeypatch, op):
    """At W > 1 an exchange operator takes its inputs' row counts from
    the layout's header gather: the one other size gather a rank makes
    is the regrow check of its output (the join on unique keys, which
    never regrows)."""
    import threading

    from cylon_tpu_torch.parallel import dist_ops

    calls, lock = [0] * 4, threading.Lock()
    real = dist_ops.shard_sizes

    def counting(env, table):
        with lock:
            calls[env.rank] += 1
        return real(env, table)

    monkeypatch.setattr(dist_ops, "shard_sizes", counting)
    left, _ = _tables()
    unique = Table.from_pydict({"k": np.arange(200)[::-1]}, device="cpu")

    def rank(comm):
        env = CylonEnv(comm)
        lt, ut = scatter_table(env, left), scatter_table(env, unique)
        return {"shuffle": lambda: shuffle(env, lt, ["k"]),
                "repartition": lambda: repartition(env, lt),
                "dist_groupby": lambda: dist_groupby(env, lt, ["k"],
                                                     [("v", "sum")]),
                "dist_join": lambda: dist_join(env, ut, ut, on="k")}[op]()

    ThreadWorld(4).run(rank)
    assert calls == [1] * 4
