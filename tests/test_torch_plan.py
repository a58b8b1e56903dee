"""Whole queries in the port (``cylon_tpu_torch.plan``) on the CPU: the
compiled TPC-H queries equal the eager ones (locally and at W = 4), a
scalar query gives a 0-d tensor, the scale memo makes a second call of a
query that regrew run each op once, an overflowed explicit bound never
comes back as a poisoned scalar, ``shared_compiled`` is one object
across threads and ``invalidate`` clears the memo."""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu_torch import (CylonEnv, DataFrame, OutOfCapacity, ThreadWorld,
                             frame, plan, tpch)
from cylon_tpu_torch.parallel import dist_ops
from cylon_tpu_torch.tpch import queries as Q
from test_tpch import SEED, SF

W = 4


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF, SEED)


@pytest.fixture(scope="module")
def frames(data):
    return tpch.ingest(data, device="cpu")


@pytest.mark.parametrize("qn", ["q1", "q3", "q5"])
def test_compiled_equals_eager(qn, frames):
    eager = getattr(tpch, qn)(frames).to_pandas()
    comp = tpch.compiled(qn)(frames)
    assert isinstance(comp, DataFrame)
    pd.testing.assert_frame_equal(comp.to_pandas().reset_index(drop=True),
                                  eager.reset_index(drop=True))
    # the result comes back shrunk to the bucket of its rows
    assert comp.table.capacity <= 1024


def test_compiled_equals_eager_at_w4(data):
    def rank(env):
        eager = tpch.q3(data, env=env).to_pandas()
        comp = tpch.compiled("q3")(data, env=env)
        assert comp.env is env
        return eager, comp.to_pandas()

    for eager, comp in ThreadWorld(W, timeout=120).run(
            lambda comm: rank(CylonEnv(comm, device="cpu"))):
        pd.testing.assert_frame_equal(comp.reset_index(drop=True),
                                      eager.reset_index(drop=True))


def test_compiled_raw_mapping_builds_only_the_manifest_columns(
        data, frames, monkeypatch):
    """A raw mapping reaches the compiled query as it is, which prunes it
    before it builds it: no column the manifest leaves out (the comments
    among them) is ever put on the device."""
    from cylon_tpu_torch.tpch.manifest import MANIFEST

    built = []
    real = Q._df

    def recording(x, device=None):
        if not isinstance(x, DataFrame):
            built.append(sorted(x))
        return real(x, device)

    monkeypatch.setattr(Q, "_df", recording)
    got = ThreadWorld(1, timeout=120).run(lambda comm: tpch.compiled("q3")(
        data, env=CylonEnv(comm, device="cpu")).to_pandas())[0]
    want = {n: sorted(Q.manifest_keep(n, data[n], cols))
            for n, cols in MANIFEST["q3"].items()}
    assert sorted(built) == sorted(want.values())
    assert not any("comment" in c for cols in built for c in cols)
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True),
        tpch.q3(frames).to_pandas().reset_index(drop=True))


def test_eager_groupby_after_a_compiled_query_keeps_its_own_scale(
        monkeypatch):
    """A group-by inside a compiled query that regrew its join runs at the
    query's scale; the group-by's own memo keeps only what its ladder
    climbed to, so a later eager group-by of that shape still starts at
    the optimistic bound."""
    from cylon_tpu_torch.ops import groupby as tgroupby

    monkeypatch.setattr(tgroupby, "_EAGER_SCALE_MEMO", {})
    caps = []
    inner = tgroupby._groupby_compiled

    def counting(*args, **kw):
        caps.append(kw["out_cap"])
        return inner(*args, **kw)

    monkeypatch.setattr(tgroupby, "_groupby_compiled", counting)
    k = np.random.default_rng(6).integers(0, 10, 20000)
    data = {**_nm_frames(),
            "t": DataFrame({"k": k, "v": np.ones(20000)}, device="cpu")}

    def q(d):
        d["a"].merge(d["b"], on="k")
        return d["t"].groupby("k").agg({"v": "sum"})

    cq = plan.compile_query(q)
    cq(data)
    caps.clear()
    second = cq(data)
    assert max(cq._scale_memo.values()) > 1
    assert caps[0] > 8192            # the group-by ran at the query's scale
    caps.clear()
    eager = data["t"].groupby("k").agg({"v": "sum"})
    assert caps == [8192]            # ...and the eager one at its own
    pd.testing.assert_frame_equal(eager.to_pandas(), second.to_pandas())


def test_compiled_scalar_is_a_0d_tensor(frames):
    eager = tpch.q6(frames)
    assert isinstance(eager, float)
    comp = tpch.compiled("q6")(frames)
    assert torch.is_tensor(comp) and comp.dim() == 0
    assert comp.device.type == "cpu"
    np.testing.assert_allclose(float(comp), eager, rtol=1e-12)
    got = tpch.compiled("q14")(frames)
    assert torch.is_tensor(got) and got.dim() == 0
    np.testing.assert_allclose(float(got), tpch.q14(frames), rtol=1e-12)


def _nm_frames(n: int = 64):
    """Two frames whose ``k`` is 0 on every row: an n x n join, past the
    default bound of 2n rows."""
    side = {"k": np.zeros(n, np.int64), "v": np.arange(n, dtype=np.float64)}
    return {"a": DataFrame(side, device="cpu"),
            "b": DataFrame(side, device="cpu")}


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def nm_query(data):
    return data["a"].merge(data["b"], on="k")


def test_second_call_starts_at_the_memoized_scale(monkeypatch):
    joins = _count_calls(monkeypatch, frame, "_join")
    cq = plan.compile_query(nm_query)
    data = _nm_frames()
    first = cq(data)
    assert len(first) == 64 * 64
    assert len(joins) > 1            # the join regrew on the first call
    assert list(cq._scale_memo.values()) == [2 ** (len(joins) - 1)]
    joins.clear()
    second = cq(data)
    assert len(joins) == 1           # ...and runs once on the second
    assert second.to_pandas().equals(first.to_pandas())
    cq.invalidate()
    assert cq._scale_memo == {}
    joins.clear()
    cq(data)
    assert len(joins) > 1


def test_second_call_at_w4_runs_each_exchange_once(monkeypatch):
    """The same at W = 4: every key lands on one rank, so the exchange's
    receive buffer regrows on the first call (``dist_ops._adaptive``);
    each rank's second call, with its env, runs its join once."""
    joins = _count_calls(monkeypatch, dist_ops, "_join_fn")
    mu = threading.Lock()
    by_rank = {}

    def q(data, env):
        with mu:
            by_rank[env.rank] = by_rank.get(env.rank, 0) + 1
        return data["a"].merge(data["b"], on="k", env=env)

    cq = plan.compile_query(q)
    data = _nm_frames(256)

    def rank(env):
        rows = [len(cq(data, env=env))]
        first = by_rank[env.rank]
        rows.append(len(cq(data, env=env)))
        return rows, first, by_rank[env.rank] - first

    runs = ThreadWorld(W, timeout=120).run(
        lambda c: rank(CylonEnv(c, device="cpu")))
    assert all(r == [256 * 256] * 2 for r, _, _ in runs)
    assert len(joins) > 2 * W
    # the first call ran the query once (the exchange regrew inside it),
    # the second once, its ladder starting at the memoized scale
    assert [(f, s) for _, f, s in runs] == [(1, 1)] * W
    # rungs 1, 2, ..., the memoized scale on the first call, one on the
    # second, on every rank
    scale = max(cq._scale_memo.values())
    assert scale > 1
    assert len(joins) == (scale.bit_length() + 1) * W


def overflowed_scalar(data, env=None):
    j = data["a"].merge(data["b"], on="k", out_capacity=16, env=env)
    return Q._agg_scalar(j, "v_x", "sum", env)


def test_scalar_over_an_overflowed_bound_raises_not_nan():
    data = _nm_frames(8)
    # eagerly the local scalar carries the poison (NaN), as in JAX
    assert np.isnan(overflowed_scalar(data))
    with pytest.raises(OutOfCapacity):
        plan.compile_query(overflowed_scalar)(data)


def test_scalar_over_an_overflowed_bound_raises_at_w4():
    data = _nm_frames(8)
    cq = plan.compile_query(overflowed_scalar)

    def rank(env):
        with pytest.raises(OutOfCapacity):
            overflowed_scalar(data, env=env)        # eager: raises
        with pytest.raises(OutOfCapacity):
            cq(data, env=env)                       # compiled: raises
        return True

    assert ThreadWorld(W, timeout=120).run(
        lambda c: rank(CylonEnv(c, device="cpu"))) == [True] * W


def test_note_overflow_is_a_no_op_outside_a_compiled_query():
    assert not plan.in_compiled()
    plan.note_overflow(True)
    plan.note_scale(8)
    flags, reached = [], []
    with plan._collect_flags(flags, reached):
        assert plan.in_compiled()
        plan.note_overflow(torch.tensor(True))
        plan.note_scale(4)
    assert len(flags) == 1 and bool(flags[0]) and reached == [4]
    assert not plan.in_compiled()


def test_shared_compiled_is_one_object_across_threads():
    got, mu = [], threading.Lock()
    start = threading.Barrier(8)

    def fetch():
        start.wait()
        cq = plan.shared_compiled(nm_query)
        with mu:
            got.append(cq)

    threads = [threading.Thread(target=fetch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(cq is got[0] for cq in got)
    assert plan.shared_compiled(lambda d: nm_query(d)) is not got[0]
    assert tpch.compiled("q6") is plan.shared_compiled(Q.q6)
    assert tpch.compiled(Q.q6) is tpch.compiled("q6")
    assert tpch.compiled("q6").__wrapped__ is Q.q6


def test_static_arguments_key_the_memo(frames):
    cq = plan.compile_query(Q.q3)
    cq(frames, limit=5)
    cq(frames, limit=7)
    keys = list(cq._scale_memo)
    assert len(keys) == 2
    assert {dict(k[1])["limit"] for k in keys} == {5, 7}
