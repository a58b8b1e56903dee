"""The port's exchange against the JAX package's, shard by shard.

W=1: ``shuffle_local`` through ``LocalComm`` against the JAX
``shuffle_local`` on a 1-device mesh. W=4: four ranks of a
``ThreadWorld`` against the JAX ``shuffle`` on the 4-device CPU mesh
(``env4``). Received rows are grouped by sender with each sender's order
kept, in both packages, so the shards must match element-wise.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import PartitionSpec as P

import cylon_tpu as jct
from cylon_tpu.ops.hash import partition_ids as jpartition_ids
from cylon_tpu.parallel import scatter_table as jscatter
from cylon_tpu.parallel import shuffle as jshuffle
from cylon_tpu.parallel.shuffle import shuffle_local as jshuffle_local
from cylon_tpu_torch import convert, dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.ops.hash import partition_ids
from cylon_tpu_torch.parallel.comm import LocalComm, ThreadWorld
from cylon_tpu_torch.parallel.dtable import scatter_table
from cylon_tpu_torch.parallel.shuffle import shuffle_local
from cylon_tpu_torch.table import Table


def _frame(rng, n):
    k = pd.array(rng.integers(0, 200, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({
        "k": k,
        "f64": rng.normal(size=n),
        "i32": rng.integers(-9, 9, n).astype(np.int32),
        "i16": rng.integers(-300, 300, n).astype(np.int16),
        "b": rng.random(n) < 0.5,
    })


def to_port(jt):
    cols = {n: (np.asarray(c.data),
                None if c.validity is None else np.asarray(c.validity),
                repr(c.dtype)) for n, c in jt.columns.items()}
    return convert.from_arrays(cols, int(jt.nrows), device="cpu")


def assert_shard_equal(jt, shard: int, tt):
    """JAX shard ``shard`` of a distributed table (rows
    ``[shard * cap_l, shard * cap_l + nrows[shard])``) == the port's rank
    table ``tt``, valid rows element-wise."""
    counts = np.asarray(jt.nrows).reshape(-1)
    cap_l = jt.capacity // counts.shape[0]
    n = int(counts[shard])
    assert int(tt.nrows) == n
    lo = shard * cap_l
    got, _ = convert.to_arrays(tt)
    assert list(got) == jt.column_names
    for name, c in jt.columns.items():
        data, validity, _ = got[name]
        want = np.asarray(c.data)[lo:lo + min(n, cap_l)]
        np.testing.assert_array_equal(data[:len(want)], want, err_msg=name)
        if c.validity is not None:
            np.testing.assert_array_equal(
                validity[:len(want)],
                np.asarray(c.validity)[lo:lo + len(want)])


def _jax_shuffle_local_w1(jt, out_cap):
    env = jct.CylonEnv(jct.TPUConfig(n_devices=1))
    ax = env.world_axes

    def body(t):
        lt = t.with_nrows(t.nrows[0])
        kc = lt.column("k")
        pid = jpartition_ids([kc.data], 1, [kc.validity])
        res = jshuffle_local(lt, pid, out_cap, axis_name=ax)
        return res.with_nrows(res.nrows.reshape(1))

    fn = jax.jit(jax.shard_map(body, mesh=env.mesh, in_specs=(P(ax),),
                               out_specs=P(ax)))
    return fn(jscatter(env, jt))


@pytest.mark.parametrize("out_cap", [1024, 700])
def test_shuffle_local_w1_matches_jax(out_cap):
    """out_cap=700 < 800 valid rows: the receive overflows, and both
    packages report nrows == out_cap + 1 over the same truncated rows."""
    rng = np.random.default_rng(out_cap)
    jt = jct.Table.from_pandas(_frame(rng, 800), capacity=850)
    want = _jax_shuffle_local_w1(jt, out_cap)
    tt = to_port(jt)
    kc = tt.column("k")
    got = shuffle_local(LocalComm(), tt, partition_ids([kc.data], 1,
                                                       [kc.validity]),
                        out_cap)
    assert got.capacity == out_cap
    expect_rows = 800 if out_cap >= 800 else out_cap + 1
    assert int(np.asarray(want.nrows)[0]) == expect_rows
    assert_shard_equal(want, 0, got)


def test_shuffle_w4_matches_jax(env4):
    rng = np.random.default_rng(4)
    n = 1000
    jt = jct.Table.from_pandas(_frame(rng, n), capacity=1010)
    out_capacity = 4 * 600
    want = jshuffle(env4, jscatter(env4, jt), ["k"],
                    out_capacity=out_capacity)
    tt = to_port(jt)

    def rank(comm):
        env = CylonEnv(comm)
        shard = scatter_table(env, tt)
        assert shard.capacity == -(-1010 // 4)
        kc = shard.column("k")
        pid = partition_ids([kc.data], 4, [kc.validity])
        return shuffle_local(comm, shard, pid, out_capacity // 4)

    got = ThreadWorld(4).run(rank)
    assert sum(int(g.nrows) for g in got) == n
    for s in range(4):
        assert_shard_equal(want, s, got[s])


def test_shuffle_w4_overflow_marks_only_full_ranks():
    """A receive buffer smaller than a rank's share: that rank reports
    nrows == out_cap + 1 and keeps the first out_cap rows."""
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.integers(0, 1000, 400))
    v = torch.arange(400, dtype=torch.float64)

    def rank(comm):
        env = CylonEnv(comm)
        t = Table({"k": Column(k, None, dtypes.int64),
                   "v": Column(v, None, dtypes.float64)}, 400)
        shard = scatter_table(env, t)
        pid = partition_ids([shard.column("k").data], 4)
        return shuffle_local(comm, shard, pid, 90)

    got = ThreadWorld(4).run(rank)
    pid_all = partition_ids([k], 4)
    for s, g in enumerate(got):
        true = int((pid_all == s).sum())
        assert int(g.nrows) == (91 if true > 90 else true)
    assert any(int(g.nrows) == 91 for g in got)
