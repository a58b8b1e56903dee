"""The port's incremental materialized views (``cylon_tpu_torch.views``)
against the JAX package's (``cylon_tpu.views``) on the same inputs.

The merge-algebra proofs of ``tests/test_views.py`` run on both
packages' combiners with the same frames; a view with a pandas query
function digests its state string-equal to JAX's after the same
appends; TPC-H views of q1, q3 and q6 whose query function is the
port's ``fallback.tpch_fallback`` on the CPU (SF 0.002, seed 3, two
RF1-style rounds: new orders with their lineitems, keys offset past the
base) equal the full recompute and the JAX package's own views; then
co-partition pruning, a broken delta span, the refresh registry and its
telemetry, a world of four ranks on ``ThreadWorld``, and a refresh
killed in a child process and resumed byte for byte.

Float sums re-associate across a merge, so float columns compare at
``rtol=1e-9``; keys, counts and row order exactly."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from cylon_tpu import catalog as jcat
from cylon_tpu import fallback as jfallback
from cylon_tpu import views as jviews
from cylon_tpu.table import Table as JTable
from cylon_tpu.tpch import ingest as jingest
from cylon_tpu_torch import catalog, fallback, telemetry, tpch, views
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import InvalidArgument, KeyError_
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.resilience import KILL_EXIT_CODE
from cylon_tpu_torch.table import Table
from cylon_tpu_torch.tpch import dbgen
from cylon_tpu_torch.tpch.manifest import FALLBACK, MANIFEST

REPO = pathlib.Path(__file__).resolve().parents[1]
#: each package's view layer, for the cases run on both
PKGS = [pytest.param(views, id="port"), pytest.param(jviews, id="jax")]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (catalog, views, jcat, jviews):
        mod.clear()
    yield
    for mod in (catalog, views, jcat, jviews):
        mod.clear()


def _frames_equal(got, want, float_cols=()):
    """Exact on keys/counts, rtol=1e-9 on re-associated float sums."""
    got = got.reset_index(drop=True)[list(want.columns)]
    want = want.reset_index(drop=True)
    assert len(got) == len(want)
    for c in want.columns:
        if c in float_cols:
            np.testing.assert_allclose(got[c].to_numpy(),
                                       want[c].to_numpy(), rtol=1e-9)
        else:
            assert list(got[c]) == list(want[c]), c


def _results_equal(got, want):
    if isinstance(want, float) or want is None:
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=1e-9)
        return
    _frames_equal(got, want, float_cols=[c for c in want.columns
                                         if want[c].dtype.kind == "f"])


# ====================================================== merge algebra
GB_SPEC = {"merge": "groupby", "by": ["k"],
           "aggs": {"s": "sum", "mx": "max",
                    "avg": ("wmean", "n"), "n": "sum"},
           "sort": ["k"]}


def _gb_view(df):
    """A q1-shaped partial: sums, a max, a mean with its count weight."""
    if not len(df):
        return df.head(0).assign(s=0.0, mx=0.0, avg=0.0, n=0.0)[
            ["k", "s", "mx", "avg", "n"]]
    g = df.groupby("k", as_index=False, sort=False)
    out = g.agg(s=("v", "sum"), mx=("v", "max"), avg=("v", "mean"),
                n=("v", "size"))
    out["n"] = out["n"].astype(np.float64)
    return out


def _rand(rng, n, keys):
    return pd.DataFrame({"k": rng.choice(keys, size=n),
                         "v": rng.normal(size=n)})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_groupby_merge_equals_view_of_concat_and_jax(seed):
    rng = np.random.default_rng(seed)
    base = _rand(rng, 200, np.arange(6))
    delta = _rand(rng, 57, np.arange(3, 9))      # overlap + new groups
    got = views.present(views.merge_delta(_gb_view(base), _gb_view(delta),
                                          GB_SPEC), GB_SPEC)
    want = views.present(_gb_view(pd.concat([base, delta],
                                            ignore_index=True)), GB_SPEC)
    _frames_equal(got, want, float_cols=("s", "mx", "avg"))
    jgot = jviews.present(jviews.merge_delta(
        _gb_view(base), _gb_view(delta), GB_SPEC), GB_SPEC)
    pd.testing.assert_frame_equal(got, jgot)


def test_groupby_merge_empty_delta_and_all_duplicate_keys():
    rng = np.random.default_rng(3)
    base = _rand(rng, 120, np.arange(4))
    for mod in (views, jviews):
        got = mod.present(mod.merge_delta(
            _gb_view(base), _gb_view(base.head(0)), GB_SPEC), GB_SPEC)
        _frames_equal(got, mod.present(_gb_view(base), GB_SPEC),
                      float_cols=("s", "mx", "avg"))
    delta = _rand(rng, 50, np.arange(4))
    got = views.present(views.merge_delta(_gb_view(base), _gb_view(delta),
                                          GB_SPEC), GB_SPEC)
    want = views.present(_gb_view(pd.concat([base, delta],
                                            ignore_index=True)), GB_SPEC)
    assert len(got) == base["k"].nunique()
    _frames_equal(got, want, float_cols=("s", "mx", "avg"))
    pd.testing.assert_frame_equal(got, jviews.present(jviews.merge_delta(
        _gb_view(base), _gb_view(delta), GB_SPEC), GB_SPEC))


C_SPEC = {"merge": "concat", "sort": ["rev", "k"],
          "ascending": [False, True], "partition": {"t": "k"}}


def _c_view(df):
    """A q3-shaped partial: one output row per partition-closed key."""
    if not len(df):
        return pd.DataFrame({"k": np.empty(0, np.int64),
                             "rev": np.empty(0, np.float64)})
    return df.groupby("k", as_index=False, sort=False).agg(
        rev=("v", "sum"))


def test_concat_merge_topk_exact_across_sides():
    rng = np.random.default_rng(4)
    base = _rand(rng, 150, np.arange(0, 10))
    delta = _rand(rng, 80, np.arange(10, 18))    # partition-closed
    state = views.merge_delta(_c_view(base), _c_view(delta), C_SPEC)
    got = views.present(state, C_SPEC, limit=5)
    want = views.present(_c_view(pd.concat([base, delta],
                                           ignore_index=True)),
                         C_SPEC, limit=5)
    assert len(got) == 5 and len(state) == 18
    _frames_equal(got, want, float_cols=("rev",))
    pd.testing.assert_frame_equal(got, jviews.present(jviews.merge_delta(
        _c_view(base), _c_view(delta), C_SPEC), C_SPEC, limit=5))


@pytest.mark.parametrize("mod", PKGS)
def test_sum_merge_is_addition_and_none_is_zero(mod):
    assert mod.merge_delta(2.5, 1.25, {"merge": "sum"}) == 3.75
    assert mod.merge_delta(None, 3.0, {"merge": "sum"}) == 3.0
    assert mod.merge_delta(3.0, None, {"merge": "sum"}) == 3.0
    assert mod.present(3.75, {"merge": "sum"}) == 3.75


@pytest.fixture(scope="module")
def tiny_tpch():
    return dbgen.generate(sf=0.002, seed=0)


def _split_rows(t, alias, mask):
    lo, hi = dict(t), dict(t)
    lo[alias] = {c: np.asarray(a)[mask] for c, a in t[alias].items()}
    hi[alias] = {c: np.asarray(a)[~mask] for c, a in t[alias].items()}
    return lo, hi


@pytest.mark.parametrize("query,alias", [("q14", "lineitem"),
                                         ("q8", "lineitem"),
                                         ("q16", "partsupp")])
def test_twophase_combine_matches_full_phase1_and_jax(tiny_tpch, query,
                                                      alias):
    """combine(phase1(base), phase1(delta)) finalizes to phase1 over all
    rows, in both packages alike. q14/q8 partials are row-associative;
    q16's split is supplier-closed (its COUNT(DISTINCT) contract)."""
    from cylon_tpu.tpch.twophase import PLANS as JPLANS
    from cylon_tpu_torch.tpch.twophase import PLANS

    if query == "q16":
        mask = np.asarray(tiny_tpch["partsupp"]["ps_suppkey"]) % 2 == 0
    else:
        rows = len(np.asarray(next(iter(tiny_tpch[alias].values()))))
        mask = np.arange(rows) < rows // 2
    lo, hi = _split_rows(tiny_tpch, alias, mask)
    plan = PLANS[query]
    state = views.combine_partials(query, [
        plan.phase1(lo, device="cpu"), plan.phase1(hi, device="cpu")])
    got = views.finalize_twophase(query, state)
    _results_equal(got, views.finalize_twophase(
        query, plan.phase1(dict(tiny_tpch), device="cpu")))
    jplan = JPLANS[query]
    jstate = jviews.combine_partials(query, [jplan.phase1(lo),
                                             jplan.phase1(hi)])
    _results_equal(got, jviews.finalize_twophase(query, jstate))


def test_twophase_combine_empty_and_refusals(tiny_tpch):
    from cylon_tpu_torch.tpch.twophase import PLANS

    p = PLANS["q14"].phase1(tiny_tpch, device="cpu")
    state = views.combine_partials("q14", [None, p])
    np.testing.assert_allclose(views.finalize_twophase("q14", state),
                               views.finalize_twophase("q14", p),
                               rtol=1e-9)
    for q in ("q11", "q15", "q22"):
        for mod in (views, jviews):
            with pytest.raises(Exception, match="not view-maintainable"):
                mod.combine_partials(q, [p])
            with pytest.raises(Exception, match="phase-2"):
                mod.finalize_twophase(q, p)


# ============================================= views over the catalog
def _gb_qf(tables):
    return _gb_view(tables["t"])


def _seed_both(rng, n=200):
    df = _rand(rng, n, np.arange(6))
    cols = {c: df[c].to_numpy() for c in df.columns}
    catalog.put_table("t", Table.from_pydict(cols, device="cpu"))
    jcat.put_table("t", JTable.from_pydict(cols))
    return df


def test_pandas_view_state_digest_string_equal_to_jax():
    rng = np.random.default_rng(10)
    base = _seed_both(rng)
    views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    jviews.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    assert views.view_version("agg") == jviews.view_version("agg")
    deltas = [_rand(rng, 40, np.arange(2, 8)), _rand(rng, 0, [0]),
              _rand(rng, 17, np.arange(9))]
    for d in deltas:
        for cat, mod in ((catalog, views), (jcat, jviews)):
            cat.append("t", d)
            out = mod.refresh("agg")
            assert out["refreshed"] and not out["full_recompute"]
            assert out["delta_rows"] == len(d)
        assert views.view_version("agg") == jviews.view_version("agg")
    got = views.read("agg")
    want = views.present(_gb_view(pd.concat([base] + deltas,
                                            ignore_index=True)), GB_SPEC)
    _frames_equal(got["result"], want, float_cols=("s", "mx", "avg"))
    assert got["lag"] == 0 and got["generations"] == {"t": 4}
    assert views.stats()["agg"]["refreshes"] == 3


def test_refresh_idempotent_and_empty_delta_advances_watermark():
    rng = np.random.default_rng(11)
    _seed_both(rng)
    views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    assert views.refresh("agg")["refreshed"] is False
    d0 = views.view_version("agg")["digest"]
    catalog.append("t", _rand(rng, 0, np.arange(6)))
    out = views.refresh("agg")
    assert out["refreshed"] and out["delta_rows"] == 0
    assert out["generations"] == {"t": 2}
    assert views.view_version("agg")["digest"] == d0
    assert views.refresh("agg")["refreshed"] is False


def test_broken_delta_span_full_recomputes(monkeypatch):
    rng = np.random.default_rng(12)
    base = _seed_both(rng)
    views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    monkeypatch.setenv("CYLON_TPU_CATALOG_DELTA_KEEP", "0")
    delta = _rand(rng, 25, np.arange(6))
    catalog.append("t", delta)
    out = views.refresh("agg")
    assert out["refreshed"] and out["full_recompute"]
    assert out["delta_rows"] is None
    want = views.present(_gb_view(pd.concat([base, delta],
                                            ignore_index=True)), GB_SPEC)
    _frames_equal(views.read("agg")["result"], want,
                  float_cols=("s", "mx", "avg"))
    # an overwrite of the source breaks the span the same way
    monkeypatch.delenv("CYLON_TPU_CATALOG_DELTA_KEEP")
    catalog.put_table("t", Table.from_pandas(base, device="cpu"))
    assert views.refresh("agg")["full_recompute"]
    _frames_equal(views.read("agg")["result"],
                  views.present(_gb_view(base), GB_SPEC),
                  float_cols=("s", "mx", "avg"))


def test_read_lag_memo_and_invalidate_hook():
    rng = np.random.default_rng(13)
    _seed_both(rng)
    calls = []

    class QF:
        def __call__(self, tables):
            return _gb_view(tables["t"])

        def invalidate(self):
            calls.append("inv")

    views.register_view("agg", QF(), GB_SPEC, sources={"t": "t"})
    r1 = views.read("agg")
    assert r1["lag"] == 0
    assert views.read("agg")["result"] is r1["result"]       # memo hit
    catalog.append("t", _rand(rng, 5, np.arange(6)))
    assert calls == ["inv"]
    r2 = views.read("agg")
    assert r2["lag"] == 1 and r2["generations"] == {"t": 1}
    views.refresh("agg")
    assert views.read("agg")["lag"] == 0


def test_register_validation_and_registry_ops():
    rng = np.random.default_rng(14)
    _seed_both(rng)
    with pytest.raises(InvalidArgument, match="sum/concat/groupby"):
        views.register_view("v", _gb_qf, {"merge": "nope"},
                            sources={"t": "t"})
    with pytest.raises(InvalidArgument, match="maintainable"):
        views.register_view("v", _gb_qf,
                            {"merge": "twophase", "query": "q11"},
                            sources={"t": "t"})
    with pytest.raises(InvalidArgument, match="ambiguous"):
        views.register_view("v", _gb_qf, GB_SPEC,
                            sources={"t": "t", "u": "t"})
    with pytest.raises(InvalidArgument, match="not in sources"):
        views.register_view("v", _gb_qf, GB_SPEC, sources={"t": "t"},
                            delta_source="u")
    views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    with pytest.raises(InvalidArgument, match="already registered"):
        views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    with pytest.raises(KeyError_, match="no view"):
        views.read("ghost")
    assert views.list_views() == ["agg"]
    st = views.stats()["agg"]
    assert st["merge"] == "groupby" and st["refreshes"] == 0
    assert st["generations"] == {"t": 1} and st["state_rows"] >= 1
    assert set(st) == set(jviews.stats().get("agg", st))
    views.drop_view("agg")
    assert views.list_views() == []
    with pytest.raises(KeyError_):
        views.drop_view("agg", if_exists=False)
    with pytest.raises(ZeroDivisionError):
        views.register_view("boom", lambda t: 1 / 0, GB_SPEC,
                            sources={"t": "t"})
    assert views.list_views() == []


def test_copartition_prune_shrinks_dimension_to_delta_keys():
    catalog.put_table("ord", Table.from_pydict(
        {"ok": np.arange(100, dtype=np.int64), "w": np.ones(100)},
        device="cpu"))
    catalog.put_table("li", Table.from_pydict(
        {"lk": np.arange(100, dtype=np.int64), "v": np.ones(100)},
        device="cpu"))
    seen = []

    def qf(tables):
        seen.append({a: len(f) for a, f in tables.items()})
        j = tables["li"].merge(tables["ord"], left_on="lk", right_on="ok")
        return float((j["v"] * j["w"]).sum())

    spec = {"merge": "sum", "partition": {"li": "lk", "ord": "ok"}}
    views.register_view("rev", qf, spec, sources={"li": "li", "ord": "ord"},
                        delta_source="li")
    assert seen[-1] == {"li": 100, "ord": 100}
    catalog.append("ord", pd.DataFrame({"ok": [100, 101], "w": [2.0, 2.0]}))
    catalog.append("li", pd.DataFrame({"lk": [100, 101], "v": [3.0, 4.0]}))
    out = views.refresh("rev")
    assert out["refreshed"] and not out["full_recompute"]
    assert seen[-1] == {"li": 2, "ord": 2}
    assert views.read("rev")["result"] == 100.0 + 3.0 * 2 + 4.0 * 2


def test_refresh_emits_telemetry_and_events(monkeypatch):
    from cylon_tpu_torch.telemetry import events

    monkeypatch.setenv("CYLON_TPU_EVENTS", "1")
    events.clear()
    try:
        rng = np.random.default_rng(15)
        _seed_both(rng)
        views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
        before = telemetry.total("view.delta_rows")
        catalog.append("t", _rand(rng, 9, np.arange(6)))
        views.refresh("agg")
        assert telemetry.total("view.delta_rows") == before + 9
        assert telemetry.counter("catalog.appends", table="t").value >= 1
        assert telemetry.metric("view.refresh_seconds",
                                view="agg") is not None
        kinds = [e["kind"] for e in events.events()]
        assert "append" in kinds and "view_refresh" in kinds
        vr = [e for e in events.events() if e["kind"] == "view_refresh"][-1]
        assert vr["view"] == "agg" and vr["delta_rows"] == 9
        assert vr["generation"] == 2 and vr["full_recompute"] is False
    finally:
        events.clear()


# ============================================== TPC-H RF1 views (q1/q3/q6)
RF1_SF, RF1_SEED, RF1_DELTA_SF, RF1_ROUNDS = 0.002, 3, 0.0005, 2
RF1_QUERIES = ("q1", "q3", "q6")


def _rf1_keep():
    keep: dict = {}
    for q in RF1_QUERIES:
        for t, cols in MANIFEST[q].items():
            keep.setdefault(t, set()).update(cols)
    keep.setdefault("orders", set()).add("o_orderkey")
    keep.setdefault("lineitem", set()).add("l_orderkey")
    return {t: frozenset(c) for t, c in keep.items()}


@pytest.fixture(scope="module")
def rf1_data():
    """The base and two RF1 rounds: each round's new orders and their
    lineitems, order keys offset past the base and every earlier
    round."""
    keep = _rf1_keep()
    base = dbgen.generate(RF1_SF, RF1_SEED, keep=keep)
    n_base = len(base["orders"]["o_orderkey"])
    rounds = []
    for r in range(RF1_ROUNDS):
        d = dbgen.generate(RF1_DELTA_SF, RF1_SEED + 1 + r, keep=keep)
        off = n_base + r * len(d["orders"]["o_orderkey"])
        d["orders"]["o_orderkey"] = d["orders"]["o_orderkey"] + off
        d["lineitem"]["l_orderkey"] = d["lineitem"]["l_orderkey"] + off
        rounds.append({t: pd.DataFrame(d[t]) for t in ("orders",
                                                       "lineitem")})
    return base, rounds


def _port_qf(q, env):
    def qf(tables):
        data = {name: {c: df[c].to_numpy() for c in df.columns}
                for name, df in tables.items()}
        rows = len(next(iter(data["lineitem"].values())))
        return fallback.tpch_fallback(
            q, data, env=env, compiled=False,
            n_partitions=1 if rows < 100_000 else None)
    return qf


def _jax_qf(q):
    def qf(tables):
        data = {name: {c: df[c].to_numpy() for c in df.columns}
                for name, df in tables.items()}
        rows = len(next(iter(data["lineitem"].values())))
        return jfallback.tpch_fallback(
            q, data, compiled=False,
            n_partitions=1 if rows < 100_000 else None)
    return qf


@pytest.mark.parametrize("q", RF1_QUERIES)
def test_tpch_rf1_view_equals_full_recompute_and_jax(rf1_data, q):
    base, rounds = rf1_data
    env = CylonEnv(device="cpu")
    frames = tpch.ingest(base, device="cpu")
    jframes = jingest(base)
    for name in MANIFEST[q]:
        catalog.put_table(f"tpch/{name}", frames[name].table)
        jcat.put_table(f"tpch/{name}", jframes[name].table)
    spec = FALLBACK[q]
    limit = fallback._resolve_limit(getattr(tpch, q), spec, {})
    sources = {t: f"tpch/{t}" for t in MANIFEST[q]}
    views.register_view(f"view/{q}", _port_qf(q, env), spec,
                        sources=sources, delta_source="lineitem",
                        limit=limit)
    views.register_view(f"full/{q}", _port_qf(q, env), spec,
                        sources=sources, delta_source="lineitem",
                        limit=limit)
    jviews.register_view(f"view/{q}", _jax_qf(q), spec, sources=sources,
                         delta_source="lineitem", limit=limit)
    for r, delta in enumerate(rounds):
        for t in ("orders", "lineitem"):
            if t in MANIFEST[q]:
                catalog.append(f"tpch/{t}", delta[t][list(
                    catalog.get_table(f"tpch/{t}").column_names)])
                jcat.append(f"tpch/{t}", delta[t][list(
                    jcat.get_table(f"tpch/{t}").column_names)])
        out = views.refresh(f"view/{q}")
        assert out["refreshed"] and not out["full_recompute"]
        assert out["delta_rows"] == len(delta["lineitem"])
        assert views.refresh(f"full/{q}", full=True)["full_recompute"]
        jviews.refresh(f"view/{q}")
        got = views.read(f"view/{q}")
        assert got["lag"] == 0
        assert got["generations"]["lineitem"] == r + 2
        _results_equal(got["result"], views.read(f"full/{q}")["result"])
        _results_equal(got["result"], jviews.read(f"view/{q}")["result"])
    # and the in-core eager query on the appended data
    whole = {t: pd.concat([pd.DataFrame(base[t])]
                          + [rd[t] for rd in rounds], ignore_index=True)
             if t in ("orders", "lineitem") else pd.DataFrame(base[t])
             for t in MANIFEST[q]}
    eager = getattr(tpch, q)(tpch.ingest(
        {t: {c: f[c].to_numpy() for c in f.columns}
         for t, f in whole.items()}, device="cpu"))
    eager = eager if isinstance(eager, float) else \
        eager.to_pandas().reset_index(drop=True)
    _results_equal(views.read(f"view/{q}")["result"], eager)


# ================================================= a world of 4 ranks
def test_w4_view_over_shards_refreshes_in_step_and_equals_w1():
    rng = np.random.default_rng(16)
    base = _rand(rng, 240, np.arange(10))
    deltas = [_rand(rng, 30, np.arange(5, 14)) for _ in range(2)]

    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        block = -(-len(base) // env.world_size)
        part = base.iloc[env.rank * block:(env.rank + 1) * block]
        catalog.put_table("t", Table.from_pandas(
            part.reset_index(drop=True), device="cpu"), env=env)
        views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"},
                            env=env)
        outs = []
        for d in deltas:
            catalog.append("t", d, env=env)
            outs.append(views.refresh("agg", env=env))
        return outs, views.read("agg", env=env), \
            views.stats(env=env)["agg"]

    got = ThreadWorld(4).run(rank)
    assert sorted(views.materialized._views) == [("agg", r) for r in range(4)]
    want = views.present(_gb_view(pd.concat([base] + deltas,
                                            ignore_index=True)), GB_SPEC)
    for outs, rd, st in got:
        assert [o["full_recompute"] for o in outs] == [False, False]
        assert rd["generations"] == {"t": 3} and rd["lag"] == 0
        assert rd["digest"] == got[0][1]["digest"]
        assert st["refreshes"] == 2
        _frames_equal(rd["result"], want, float_cols=("s", "mx", "avg"))
    views.clear()
    catalog.clear()
    catalog.put_table("t", Table.from_pandas(base, device="cpu"))
    views.register_view("agg", _gb_qf, GB_SPEC, sources={"t": "t"})
    for d in deltas:
        catalog.append("t", d)
        views.refresh("agg")
    assert views.view_version("agg")["digest"] == got[0][1]["digest"]


# ============================================= kill-mid-refresh chaos
V_DRIVER = '''
def run(resume_dir, out_path):
    import numpy as np
    import pandas as pd

    from cylon_tpu_torch import catalog, views
    from cylon_tpu_torch.table import Table

    catalog.clear()
    views.clear()
    rng = np.random.default_rng(7)
    catalog.put_table("t", Table.from_pydict({
        "k": rng.integers(0, 8, 400),
        "v": rng.normal(size=400)}, device="cpu"))

    def qf(tables):
        df = tables["t"]
        g = df.groupby("k", as_index=False, sort=False)
        out = g.agg(s=("v", "sum"), n=("v", "size"))
        out["n"] = out["n"].astype(np.float64)
        return out

    views.register_view("agg", qf, {
        "merge": "groupby", "by": ["k"],
        "aggs": {"s": "sum", "n": "sum"}, "sort": ["k"]},
        sources={"t": "t"})
    catalog.append("t", pd.DataFrame({
        "k": rng.integers(0, 8, 120),
        "v": rng.normal(size=120)}))
    views.refresh("agg", resume_dir=resume_dir)
    r = views.read("agg")
    text = (r["result"].to_csv(index=False, float_format="%.17g")
            + r["digest"])
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    return text
'''

V_CHILD = V_DRIVER + '''

if __name__ == "__main__":
    import os
    import sys

    from cylon_tpu_torch import resilience, telemetry

    rdir, out_path = sys.argv[1:3]
    kill = os.environ.get("VIEW_KILL")
    if kill:
        point, nth = kill.rsplit(":", 1)
        resilience.install(resilience.FaultPlan(
            [resilience.FaultRule.kill(point, nth=int(nth))]))
    run(rdir or None, out_path or None)
    print(f"RESUMED={telemetry.total('ooc.units_resumed')}")
'''


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("VIEW_KILL", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("kill,completed", [("global_merge:1", 1),
                                            ("plan:2", 0)])
def test_kill_mid_refresh_resumes_byte_identical(tmp_path, kill,
                                                 completed):
    """A kill at the refresh's merge dies after the delta partial
    checkpointed (unit 0) and before the swap; one at the delta compute
    (registration took plan hit 1) dies before any unit. A fresh child
    resumes and lands a view byte-identical (CSV + content digest) to a
    fault-free run."""
    ns: dict = {}
    exec(V_DRIVER, ns)
    want = ns["run"](None, None)
    script = tmp_path / "view_child.py"
    script.write_text(V_CHILD)
    rdir, out = tmp_path / "ckpt", tmp_path / "out.txt"
    p1 = subprocess.run([sys.executable, str(script), str(rdir), str(out)],
                        env=_child_env(VIEW_KILL=kill), cwd=str(REPO),
                        capture_output=True, text=True, timeout=240)
    assert p1.returncode == KILL_EXIT_CODE, p1.stderr[-2000:]
    assert "injected HARD KILL" in p1.stderr
    if completed:
        manifest = json.loads((rdir / "manifest.json").read_text())
        assert len(manifest["completed"]) == completed
    assert not out.exists()
    p2 = subprocess.run([sys.executable, str(script), str(rdir), str(out)],
                        env=_child_env(), cwd=str(REPO),
                        capture_output=True, text=True, timeout=240)
    assert p2.returncode == 0, p2.stderr[-2000:]
    resumed = int(p2.stdout.split("RESUMED=")[1].split()[0])
    assert resumed >= completed
    assert out.read_text() == want
