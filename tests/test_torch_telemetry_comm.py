"""The telemetry's gathers over real processes: ``gather_metrics``,
``gather_traces``, ``CylonEnv.clock_offset`` and ``barrier`` through
``ProcessGroupComm`` over gloo in 4 spawned processes. Each process
holds its own registry and recorder; the gathered world view must sum
the ranks' counters to what the 4 ``ThreadWorld`` ranks of one process
count in their one shared registry, on the same inputs.

No JAX here: every spawned process imports this module.
"""

import multiprocessing
import os
import pickle
import time

import numpy as np

from cylon_tpu_torch import Table, telemetry
from cylon_tpu_torch.context import CylonEnv, DistConfig
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import dist_join, shuffle
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.telemetry import trace
from test_torch_comm import TIMEOUT

WORLD = 4


def _ops(env) -> None:
    rng = np.random.default_rng(51)
    n = 400
    t = Table.from_pydict({"k": rng.integers(0, 40, n),
                           "v": rng.normal(size=n)}, device="cpu")
    mine = scatter_table(env, t)
    shuffle(env, mine, ["k"])
    dist_join(env, mine, mine, on="k")


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    os.environ["CYLON_TPU_TRACE"] = "1"
    env = CylonEnv(config=DistConfig(backend="gloo",
                                     init_method=f"file://{store}",
                                     world_size=WORLD, rank=rank),
                   device="cpu")
    try:
        _ops(env)
        env.barrier()
        res = {"local_rows": telemetry.total("exchange.rows"),
               "world": telemetry.gather_metrics(env),
               "buffers": telemetry.gather_traces(env),
               "offset": env.clock_offset(),
               "barriers": telemetry.metric("barrier.wait_seconds").count}
    finally:
        env.finalize()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def test_gathers_over_gloo_sum_what_thread_world_counts(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} ranks still ran after {TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    got = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))

    telemetry.reset("exchange.")
    ThreadWorld(WORLD).run(lambda comm: _ops(CylonEnv(comm, device="cpu")))
    want = telemetry.snapshot()
    telemetry.reset("exchange.")
    keys = [k for k in want if k.startswith("exchange.")]
    assert keys
    for g in got:
        # every rank holds the same merged view: each process counted its
        # own rows, and the merge sums them to the shared registry's
        for k in keys:
            assert g["world"][k]["value"] == want[k]["value"], k
        assert g["world"] == got[0]["world"]
        assert sum(x["local_rows"] for x in got) == \
            g["world"]["exchange.rows{op=dist_join}"]["value"] + \
            g["world"]["exchange.rows{op=shuffle}"]["value"]
        # one buffer a process, in rank order, each with its own events
        assert [b["rank"] for b in g["buffers"]] == list(range(WORLD))
        for r, b in enumerate(g["buffers"]):
            assert b["world"] == WORLD
            assert b["events"] and all(e.get("rank") == r
                                       for e in b["events"])
            assert abs(b["clock_offset"]) < 5.0
        assert isinstance(g["offset"], float) and abs(g["offset"]) < 5.0
        assert g["barriers"] >= 2          # ours and clock_offset's
    merged = trace.merge_timelines(got[0]["buffers"])
    cp = trace.critical_path(merged)
    assert set(cp["rank_walls"]) == set(range(WORLD))
    for b in got[0]["buffers"]:
        cov = trace.stage_coverage(b["events"], "dist_join")
        assert cov is not None and cov > 0.5
