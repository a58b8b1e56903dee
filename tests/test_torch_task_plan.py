"""The port's task overlay (``LogicalTaskPlan``, ``task_shuffle``,
``task_tables``) against the JAX package's on the same rows, on the CPU:
the cases of ``tests/test_task_plan.py`` translated, the JAX shuffle on
the 4-device mesh ``env4`` and the port's at W = 4 on ``ThreadWorld``
(each rank routing its own shard). Every row lands, intact, on the
worker owning its task, each task's rows equal to the JAX package's.
"""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu.parallel import LogicalTaskPlan as JPlan
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu.parallel import task_shuffle as jtask_shuffle
from cylon_tpu.parallel import task_tables as jtask_tables
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.parallel import (TASK_COL, LogicalTaskPlan,
                                      task_shuffle, task_tables)
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.parallel.dtable import scatter_table

W = 4


def _world(fn):
    return ThreadWorld(W).run(lambda comm: fn(ct.CylonEnv(comm)))


def _rows(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def test_plan_validates_mapping():
    with pytest.raises(InvalidArgument):
        LogicalTaskPlan([0], [0, 1], [0], [0], {0: 0})


def test_round_robin_plan_matches_jax():
    p, jp = LogicalTaskPlan.round_robin(10, 4), JPlan.round_robin(10, 4)
    assert p.tasks_of(0) == jp.tasks_of(0) == [0, 4, 8]
    assert p.tasks_of(3) == jp.tasks_of(3) == [3, 7]
    assert p.worker_of().tolist() == jp.worker_of().tolist() == \
        [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]


def test_task_shuffle_routes_rows(env4, rng):
    n, ntasks = 320, 8   # two tasks a worker
    df = pd.DataFrame({"k": rng.integers(0, 1000, n).astype(np.int64),
                       "v": rng.normal(size=n)})
    df[TASK_COL] = rng.integers(0, ntasks, n).astype(np.int64)
    jplan = JPlan.round_robin(ntasks, env4.world_size)
    jsh = jtask_shuffle(env4, jscatter(env4, jct.Table.from_pandas(df)),
                        TASK_COL, jplan, out_capacity=8 * n)
    jper = {t: tab.to_pandas() for t, tab in
            jtask_tables(env4, jsh, jplan).items()}
    plan = LogicalTaskPlan.round_robin(ntasks, W)
    whole = ct.Table.from_pandas(df, device="cpu")

    def rank(env):
        sh = task_shuffle(env, scatter_table(env, whole), TASK_COL, plan,
                          out_capacity=8 * n)
        return {t: tab.to_pandas()
                for t, tab in task_tables(env, sh, plan).items()}

    per_rank = _world(rank)
    assert [sorted(r) for r in per_rank] == [plan.tasks_of(r)
                                            for r in range(W)]
    for r, tasks in enumerate(per_rank):
        for t, got in tasks.items():
            want = df[df[TASK_COL] == t].drop(columns=TASK_COL)
            pd.testing.assert_frame_equal(_rows(got), _rows(want))
            pd.testing.assert_frame_equal(_rows(got), _rows(jper[t]))


def test_task_shuffle_skewed_ownership(env4, rng):
    n = 160
    df = pd.DataFrame({"k": np.arange(n, dtype=np.int64)})
    df[TASK_COL] = rng.integers(0, 4, n)
    owners = {t: 0 for t in range(4)}
    jsh = jtask_shuffle(env4, jscatter(env4, jct.Table.from_pandas(df)),
                        TASK_COL, JPlan([0], list(range(4)), [0], [0],
                                        owners), out_capacity=16 * n)
    plan = LogicalTaskPlan([0], list(range(4)), [0], [0], owners)
    whole = ct.Table.from_pandas(df, device="cpu")
    counts = _world(lambda env: task_shuffle(
        env, scatter_table(env, whole), TASK_COL, plan,
        out_capacity=16 * n).num_rows)
    assert counts == [n, 0, 0, 0] == np.asarray(jsh.nrows).tolist()


def test_unmapped_task_poisons(rng):
    n = 80
    df = pd.DataFrame({"k": np.arange(n, dtype=np.int64)})
    df[TASK_COL] = rng.integers(0, 8, n)
    df.loc[0, TASK_COL] = 99   # out of range: rank 0's row
    plan = LogicalTaskPlan.round_robin(8, W)
    whole = ct.Table.from_pandas(df, device="cpu")

    def rank(env):
        sh = task_shuffle(env, scatter_table(env, whole), TASK_COL, plan,
                          out_capacity=8 * n)
        with pytest.raises(OutOfCapacity):   # on every rank
            task_tables(env, sh, plan)
        return True

    assert _world(rank) == [True] * W


def test_task_ids_array_path(rng):
    n = 160
    whole = ct.Table.from_pandas(pd.DataFrame(
        {"k": np.arange(n, dtype=np.int64)}), device="cpu")
    plan = LogicalTaskPlan.round_robin(8, W)

    def rank(env):
        mine = scatter_table(env, whole)
        tids = np.random.default_rng(env.rank).integers(0, 8, mine.capacity)
        sh = task_shuffle(env, mine, tids, plan, out_capacity=8 * n)
        return sum(t.num_rows for t in task_tables(env, sh, plan).values())

    assert sum(_world(rank)) == n


def test_task_ids_wrong_length_raises():
    whole = ct.Table.from_pandas(pd.DataFrame(
        {"k": np.arange(16, dtype=np.int64)}), device="cpu")
    plan = LogicalTaskPlan.round_robin(8, W)

    def rank(env):
        with pytest.raises(InvalidArgument):
            task_shuffle(env, scatter_table(env, whole),
                         np.zeros(3, np.int64), plan)
        return True

    assert _world(rank) == [True] * W
