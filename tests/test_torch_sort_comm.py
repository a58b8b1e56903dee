"""The sort and set-op slice over real processes: ``dist_sort`` (both
partitioners), the distributed set ops, ``dist_unique``, ``dist_head``,
``dist_concat``, ``dist_ordered_equal_compiled`` and the collectives
through ``ProcessGroupComm`` over gloo in 4 spawned processes, each
rank's result bit for bit as ``ThreadWorld``'s on the same inputs.

No JAX here: every spawned process imports this module.
"""

import multiprocessing
import os
import pickle
import time

import numpy as np
import pandas as pd
import torch

from cylon_tpu_torch import SortOptions, Table
from cylon_tpu_torch.context import CylonEnv, DistConfig
from cylon_tpu_torch.ops.setops import dist_ordered_equal_compiled
from cylon_tpu_torch.parallel import collectives
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dist_ops import (dist_concat, dist_head,
                                               dist_intersect, dist_sort,
                                               dist_subtract, dist_union,
                                               dist_unique)
from cylon_tpu_torch.parallel.dtable import scatter_table
from test_torch_comm import TIMEOUT, _same_bits, _valid

WORLD = 4


def _tables():
    rng = np.random.default_rng(41)
    n = 240
    names = np.array(["ant", "bee", "", "éclair", None], object)
    k = pd.array(rng.integers(0, 30, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    a = pd.DataFrame({"k": k, "s": names[rng.integers(0, 5, n)],
                      "v": rng.integers(-5, 5, n).astype(np.float64)})
    b = pd.concat([a.iloc[::3], a.iloc[:40].assign(v=1.5)],
                  ignore_index=True)
    return (Table.from_pandas(a, device="cpu", string_storage="bytes"),
            Table.from_pandas(b, device="cpu"))


def _run(env) -> dict:
    ta, tb = _tables()
    a, b = scatter_table(env, ta), scatter_table(env, tb)
    one = torch.tensor([env.rank + 1], dtype=torch.int64)
    return {
        "sort_sample": _valid(dist_sort(env, a, ["s", "k"], [False, True])),
        "sort_hist": _valid(dist_sort(env, a, "v",
                                      options=SortOptions(num_bins=8))),
        "union": _valid(dist_union(env, a, b)),
        "intersect": _valid(dist_intersect(env, a, b)),
        "subtract": _valid(dist_subtract(env, a, b)),
        "unique": _valid(dist_unique(env, a, ["k"], keep="last")),
        "head": _valid(dist_head(env, a, 100)),
        "concat": _valid(dist_concat(env, [a, b.select(a.column_names)])),
        "equal": dist_ordered_equal_compiled(env, a, a),
        "prod": collectives.all_reduce(env, one, "prod").numpy(),
        "bor": collectives.all_reduce(env, torch.ones_like(one) << env.rank,
                                      collectives.ReduceOp.BOR).numpy(),
    }


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    env = CylonEnv(config=DistConfig(backend="gloo",
                                     init_method=f"file://{store}",
                                     world_size=WORLD, rank=rank),
                   device="cpu")
    try:
        res = _run(env)
    finally:
        env.finalize()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def test_sort_and_set_ops_over_gloo_match_thread_world(tmp_path):
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
    gloo = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            gloo.append(pickle.load(f))
    threads = ThreadWorld(WORLD).run(lambda comm: _run(CylonEnv(comm)))
    for r in range(WORLD):
        for name in threads[r]:
            assert _same_bits(gloo[r][name], threads[r][name]), (r, name)
    assert gloo[0]["equal"] is True
    assert gloo[0]["prod"].tolist() == [24] and \
        gloo[0]["bor"].tolist() == [15]
    assert sum(g["head"][0] for g in gloo) == 100
