"""Distributed TPC-H in the port on the CPU: all 22 queries at W = 4 on
``ThreadWorld`` (every rank calls the query with the same data, SPMD)
equal to W = 1 and to the pandas oracles of ``test_tpch``, and no gather
in a query's body: only the final ``to_pandas`` gathers."""

import threading

import numpy as np
import pytest

from cylon_tpu_torch import CylonEnv, ThreadWorld, tpch
from cylon_tpu_torch.parallel import dtable
from test_torch_tpch import case, result

W = 4
DIST = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def data():
    from test_tpch import SEED, SF

    return tpch.generate(SF, SEED)


@pytest.fixture(scope="module")
def pdfs():
    from test_tpch import SEED, SF

    return tpch.generate_pandas(SF, SEED)


def run_world(fn, w: int = W):
    """``fn(env)`` on every rank of a ``ThreadWorld`` of ``w`` ranks on the
    CPU; every rank's return, in rank order."""
    return ThreadWorld(w, timeout=120).run(
        lambda comm: fn(CylonEnv(comm, device="cpu")))


@pytest.mark.parametrize("qn", DIST)
def test_query_w4_matches_w1_and_pandas(qn, data, pdfs):
    kw, data2, want, check = case(qn, pdfs, data)
    raw = data if data2 is None else data2
    q = getattr(tpch, qn)
    # W = 4 from the raw mapping: each rank builds it on the env's
    # device and keeps its block; every rank gathers the result
    w4 = run_world(lambda env: result(q(raw, env=env, **kw)))
    w1 = result(q(tpch.ingest(raw, device="cpu"),
                  env=CylonEnv(device="cpu"), **kw))
    check(w1, want)
    for got in w4:
        check(got, want)
        check(got, w1)


@pytest.mark.parametrize("qn", ["q3", "q16"])
def test_query_w4_on_frames_sharded_per_rank(qn, data, pdfs):
    """Inputs already sharded over the env (each rank ingests the whole
    table and keeps its block first) pass through as shards."""
    from cylon_tpu_torch import DataFrame
    from cylon_tpu_torch.tpch.queries import TPCH_STRING_STORAGE

    kw, _, want, check = case(qn, pdfs, data)

    def rank(env):
        shards = {k: DataFrame(v, env=env, device="cpu",
                               string_storage=TPCH_STRING_STORAGE)
                  for k, v in data.items()}
        return result(getattr(tpch, qn)(shards, env=env, **kw))

    for got in run_world(rank):
        check(got, want)


@pytest.fixture
def gathers(monkeypatch):
    """Count ``gather_table`` calls by thread (the frame reaches it through
    its own name for it, ``dist_to_pandas`` through the module's)."""
    from cylon_tpu_torch import frame

    log, mu = [], threading.Lock()
    real = dtable.gather_table

    def counted(env, table):
        with mu:
            log.append(env.rank)
        return real(env, table)

    monkeypatch.setattr(dtable, "gather_table", counted)
    monkeypatch.setattr(frame, "gather_table", counted)
    return log


@pytest.mark.parametrize("qn", ["q1", "q3", "q5", "q6"])
def test_no_gather_before_the_final_to_pandas(qn, data, gathers):
    """The query body gathers nothing on any rank; the result's
    ``to_pandas`` gathers once a rank, and a scalar query never
    (``tests/test_no_gather.py``)."""
    barrier = threading.Barrier(W)

    def rank(env):
        out = getattr(tpch, qn)(data, env=env)
        barrier.wait()
        body = len(gathers)
        barrier.wait()
        res = result(out)
        return body, res

    runs = run_world(rank)
    assert [b for b, _ in runs] == [0] * W, gathers
    if qn == "q6":
        assert gathers == []
        assert all(np.isfinite(r) for _, r in runs)
    else:
        assert sorted(gathers) == list(range(W))
