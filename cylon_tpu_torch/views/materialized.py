"""Materialized views: named incremental queries over appendable,
version-digested catalog tables.

Port of ``cylon_tpu/views/materialized.py`` on the port's catalog,
snapshot frames, fallback checkpoints and telemetry. A view's query
function runs wherever it runs (the TPC-H views of the card run the
port's ``fallback.tpch_fallback`` there); its state is a host result.

**Worlds.** A view whose ``env`` spans W > 1 ranks reads its sharded
sources with ``dist_to_pandas`` (collective), so every rank registers,
refreshes and reads it in step; ``ThreadWorld`` ranks share this
module, so such a view is registered per rank (each call of this
module's entry points takes the rank's ``env``). A view with no env, or
an env of one rank, is one registry entry, readable from any thread.

A registered view holds a RESIDENT host result (its *state*) plus a
per-source generation watermark. When :func:`cylon_tpu_torch.catalog.append`
lands a delta on the view's delta source, :func:`refresh` runs the
view's query over **the delta rows only** (dimension sources ride
along in full, so join closure — RF1-style "new orders arrive with
their lineitems" — keeps the delta result exact) and folds the delta
partial into the state through the fallback merge combiners
(:mod:`cylon_tpu_torch.views.combiners`). Cost per refresh is therefore
o(resident data): proportional to the delta, not the table.

**Consistency.** The state, its watermark and its content digest swap
under one view mutex hold — :func:`read` captures
``(result, generations, digest)`` atomically, so a serve read is
generation-consistent by construction: the returned result is exactly
the from-scratch answer at the returned generations, never a blend.
Appends invalidate the presented-result memo (and any
``query_fn.invalidate()`` plan memo — see
:meth:`cylon_tpu_torch.plan.CompiledQuery.invalidate`) through the
catalog's on-append hook.

**Durability.** ``refresh(resume_dir=...)`` checkpoints through
:class:`cylon_tpu_torch.resilience.CheckpointedRun` — unit 0 is the delta
partial, unit 1 the merged state, fingerprinted by (view, spec, base
and target generations, base-state digest). A hard kill mid-refresh
(the ``plan`` / ``global_merge`` injection points fire inside it)
resumes to a byte-identical state; the resident view is only swapped
AFTER the merge completes, so a killed refresh never corrupts it.

**Watermark semantics.** ``applied[delta_source]`` advances by exactly
the deltas applied; a watermark older than the catalog's delta
retention window (or an intervening full ``put_table`` overwrite)
triggers a full recompute — never a silent under-application.
"""

import threading
import time

import numpy as np
import pandas as pd

from cylon_tpu_torch.errors import InvalidArgument, KeyError_
from cylon_tpu_torch.views import combiners

__all__ = ["MaterializedView", "register_view", "refresh", "read",
           "view_version", "drop_view", "list_views", "stats",
           "clear"]

_reg_mu = threading.Lock()
#: (view name, rank of a world of W > 1 ranks or None) -> view
_views: "dict[tuple, MaterializedView]" = {}

#: (table_id, rank or None, generation) -> host pandas frame; bounded.
#: Dimension sources re-read every refresh would otherwise re-gather the
#: full table; the on-append hook evicts superseded generations. The
#: rank keeps a ThreadWorld's ranks apart: each rank's gather is a
#: collective its peers join, so no rank may skip it on a peer's hit.
_HOST_CACHE: "dict[tuple, object]" = {}
_HOST_CACHE_CAP = 16


class MaterializedView:
    """One registered view: query + merge spec + resident state."""

    __slots__ = ("name", "query_fn", "spec", "sources", "delta_source",
                 "limit", "env", "state", "applied", "state_digest",
                 "refreshes", "last_refresh_s", "_mu", "_present_memo")

    def __init__(self, name, query_fn, spec, sources, delta_source,
                 limit, env):
        self.name = str(name)
        self.query_fn = query_fn
        self.spec = spec
        self.sources = dict(sources)
        self.delta_source = delta_source
        self.limit = limit
        self.env = env
        self.state = None
        self.applied: "dict[str, int]" = {}
        self.state_digest = None
        self.refreshes = 0
        self.last_refresh_s = None
        self._mu = threading.Lock()
        self._present_memo = None


def _state_digest(state) -> str:
    """Content digest of a view state — the same fingerprint scheme
    the catalog versions tables with, so "byte-identical view" is a
    string comparison."""
    from cylon_tpu_torch.fallback import _cols_fingerprint

    if state is None:
        return "empty"
    if isinstance(state, float):
        return _cols_fingerprint(
            {"__scalar__": np.asarray([state], np.float64)})
    return _cols_fingerprint(
        {c: state[c].to_numpy() for c in state.columns})


def _host_state(out):
    """Materialize a query_fn result to host state: frames to pandas,
    scalars to float."""
    if out is None or isinstance(out, float):
        return out
    if isinstance(out, pd.DataFrame):
        return out.reset_index(drop=True)
    if hasattr(out, "to_pandas"):
        return out.to_pandas().reset_index(drop=True)
    arr = np.asarray(out)
    if arr.ndim == 0:
        return float(arr)
    raise InvalidArgument(
        f"view query returned un-materializable {type(out).__name__}")


def _vkey(name: str, env) -> tuple:
    """The registry key of view ``name`` as ``env``'s rank sees it."""
    if env is None or int(env.world_size) == 1:
        return (str(name), None)
    return (str(name), int(env.rank))


def _host_frame(table_id: str, env=None):
    """``(generation, host frame)`` of a catalog table, read
    consistently (generation re-checked after the fetch; retries a
    racing append) and cached per generation. A shard gathers the
    world's rows (the catalog's shard record decides, read through
    :meth:`CatalogSnapshot._host_frame`).

    (``cylon_tpu/views/materialized.py`` ``_host_frame``)"""
    from cylon_tpu_torch import catalog
    from cylon_tpu_torch.serve.durability import CatalogSnapshot

    rank = None if env is None else int(env.rank)
    while True:
        gen = catalog.generation(table_id, env=env)
        key = (table_id, rank, gen)
        hit = _HOST_CACHE.get(key)
        if hit is not None:
            return gen, hit
        t = catalog.get_table(table_id, env=env)
        pdf = CatalogSnapshot._host_frame(
            t, env, env is not None and catalog.is_shard(table_id, env))
        if catalog.generation(table_id, env=env) != gen:
            continue  # an append swapped the table under the fetch
        if len(_HOST_CACHE) >= _HOST_CACHE_CAP:
            _HOST_CACHE.pop(next(iter(_HOST_CACHE)), None)
        _HOST_CACHE[key] = pdf
        return gen, pdf


def _on_append(table_id: str, gen: int) -> None:
    """Catalog on-append hook: evict superseded host-frame cache
    entries and every dependent view's presented-result memo (the
    result memos keyed on the now-stale version), plus the view
    query's own plan memos when it exposes ``invalidate()``."""
    for key in [k for k in list(_HOST_CACHE)
                if k[0] == table_id and k[2] != gen]:
        _HOST_CACHE.pop(key, None)
    with _reg_mu:
        dependents = [v for v in _views.values()
                      if table_id in v.sources.values()]
    for v in dependents:
        with v._mu:
            v._present_memo = None
        inv = getattr(v.query_fn, "invalidate", None)
        if callable(inv):
            try:
                inv()
            except Exception:  # pragma: no cover - hook must not fail
                pass


def _install_hook() -> None:
    from cylon_tpu_torch import catalog

    catalog.on_append(_on_append)


_install_hook()


def _view(name: str, env=None) -> MaterializedView:
    with _reg_mu:
        v = _views.get(_vkey(name, env))
    if v is None:
        raise KeyError_(f"no view registered under {name!r} "
                        f"(known: {list_views()})")
    return v


def _spec_fp(spec: dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in spec.items()))


def register_view(name: str, query_fn, refresh_plan: dict, *,
                  sources, delta_source: "str | None" = None,
                  limit=None, env=None) -> MaterializedView:
    """Register a materialized view and compute its initial state.

    ``query_fn(tables)`` takes ``{alias: host pandas frame}`` and
    returns the view's UNTRUNCATED merge-state partial (lift any row
    limit — reads re-apply it via ``limit=``); for two-phase plans it
    returns the associative phase-1 partial. ``refresh_plan`` is a
    fallback merge spec (:data:`cylon_tpu_torch.tpch.manifest.FALLBACK`
    entry or hand-built: ``merge`` in sum/concat/groupby/twophase plus
    by/aggs/sort/distinct; twophase specs carry a ``query`` key naming
    the :data:`~cylon_tpu_torch.tpch.twophase.PLANS` entry). ``sources``
    maps query aliases to catalog table ids; ``delta_source`` names
    the ONE appendable alias whose deltas drive incremental refresh
    (defaults to the spec's sole partitioned table) — other sources
    are join-closed dimensions. ``env`` reads the sources as its rank
    sees them (a shard gathers the world's rows) and keys the view by
    that rank in a world of W > 1 ranks (``cylon_tpu/views/
    materialized.py`` ``register_view``).
    """
    name = str(name)
    spec = dict(refresh_plan)
    if spec.get("merge") not in ("sum", "concat", "groupby",
                                 "twophase"):
        raise InvalidArgument(
            f"refresh_plan merge {spec.get('merge')!r} not one of "
            "sum/concat/groupby/twophase")
    if spec["merge"] == "twophase":
        q = spec.get("query")
        if q not in combiners.TWOPHASE_COMBINE_BY:
            raise InvalidArgument(
                "twophase refresh_plan needs query= naming a "
                f"maintainable plan "
                f"{sorted(combiners.TWOPHASE_COMBINE_BY)}; got {q!r}")
    sources = dict(sources)
    if not sources:
        raise InvalidArgument("a view needs at least one source table")
    if delta_source is None:
        part = [a for a in spec.get("partition", {}) if a in sources]
        if len(part) == 1:
            delta_source = part[0]
        elif len(sources) == 1:
            delta_source = next(iter(sources))
        else:
            raise InvalidArgument(
                f"ambiguous delta_source among {sorted(sources)}; "
                "pass delta_source=")
    if delta_source not in sources:
        raise InvalidArgument(
            f"delta_source {delta_source!r} not in sources "
            f"{sorted(sources)}")
    v = MaterializedView(name, query_fn, spec, sources, delta_source,
                         limit, env)
    key = _vkey(name, env)
    with _reg_mu:
        if key in _views:
            raise InvalidArgument(
                f"view {name!r} already registered; drop_view() first")
        _views[key] = v
    try:
        with v._mu:
            _recompute_locked(v)
    except BaseException:
        with _reg_mu:
            _views.pop(key, None)
        raise
    return v


def _recompute_locked(v: MaterializedView) -> dict:
    """Full from-scratch state compute (initial registration, or a
    watermark the delta log no longer covers). Caller holds ``v._mu``.
    The generation capture re-checks after the read so a racing append
    is either fully in the state or fully pending — never half."""
    from cylon_tpu_torch import resilience

    while True:
        inputs, target = {}, {}
        for alias, tid in v.sources.items():
            target[alias], inputs[alias] = _host_frame(tid, v.env)
        from cylon_tpu_torch import catalog

        if all(catalog.generation(tid, env=v.env) == target[a]
               for a, tid in v.sources.items()):
            break
    resilience.inject("plan", f"view.{v.name}.recompute")
    v.state = _host_state(v.query_fn(inputs))
    v.applied = target
    v.state_digest = _state_digest(v.state)
    v._present_memo = None
    return target


def _copartition_prune(v: MaterializedView, inputs: dict) -> None:
    """Semi-join pushdown over the spec's co-partition keys: the merge
    spec declares which sources hash-co-partition on a shared key
    domain (``spec["partition"]``, e.g. orders on ``o_orderkey`` with
    lineitem on ``l_orderkey``) — the exactness contract already
    requires every key group to land wholly in the base or wholly in
    one delta, so a co-partitioned dimension row whose key is absent
    from the delta CANNOT contribute to the delta-only result. Pruning
    those rows turns the refresh from O(dimension) into O(delta) — on
    an RF1 round the full orders table shrinks to just the new orders.
    Broadcast sources (no partition key) stay whole. In place, on
    fresh frames (the host cache is never mutated).

    (``cylon_tpu/views/materialized.py`` ``_copartition_prune``)"""
    part = v.spec.get("partition") or {}
    dkey = part.get(v.delta_source)
    dframe = inputs.get(v.delta_source)
    if (dkey is None or dframe is None
            or dkey not in getattr(dframe, "columns", ())):
        return
    dvals = dframe[dkey].unique()
    for alias, frame in list(inputs.items()):
        if alias == v.delta_source:
            continue
        akey = part.get(alias)
        if akey and akey in getattr(frame, "columns", ()):
            inputs[alias] = (frame[frame[akey].isin(dvals)]
                             .reset_index(drop=True))


def refresh(name: str, *, resume_dir: "str | None" = None,
            full: bool = False, env=None) -> dict:
    """Bring view ``name`` up to date with its sources' current
    generations. Incremental when the catalog's delta log covers the
    span (query over the delta only + combiner merge); full recompute
    when it does not (or ``full=True``). Returns ``{"view",
    "refreshed", "full_recompute", "delta_rows", "generations",
    "digest", "wall_s"}`` (``cylon_tpu/views/materialized.py``
    ``refresh``). ``env``: the rank's env for a view of a world of W > 1
    ranks (every rank refreshes in step)."""
    from cylon_tpu_torch import catalog, resilience, telemetry, watchdog
    from cylon_tpu_torch.fallback import (_encode_partial,
                                    _partial_schema_meta,
                                    _resume_partial)
    from cylon_tpu_torch.telemetry import events as _events

    v = _view(name, env)
    t0 = time.perf_counter()
    with v._mu:
        delta_tid = v.sources[v.delta_source]
        base_wm = int(v.applied.get(v.delta_source, 0))
        deltas = (None if full
                  else catalog.deltas_since(delta_tid, base_wm,
                                            env=v.env))
        full_recompute = deltas is None
        if full_recompute:
            target = _recompute_locked(v)
            delta_rows = None
        else:
            delta_rows = int(sum(len(f) for f in deltas))
            target = {a: catalog.generation(tid, env=v.env)
                      for a, tid in v.sources.items()
                      if a != v.delta_source}
            # the watermark advances by exactly the deltas applied —
            # an append racing this refresh stays pending
            target[v.delta_source] = base_wm + len(deltas)
            if target == v.applied:
                return {"view": v.name, "refreshed": False,
                        "full_recompute": False, "delta_rows": 0,
                        "generations": dict(v.applied),
                        "digest": v.state_digest, "wall_s": 0.0}
            if delta_rows:
                inputs = {a: _host_frame(tid, v.env)[1]
                          for a, tid in v.sources.items()
                          if a != v.delta_source}
                inputs[v.delta_source] = pd.concat(
                    deltas, ignore_index=True)
                _copartition_prune(v, inputs)
                ckpt = None
                if resume_dir is not None:
                    ckpt = resilience.CheckpointedRun(
                        resume_dir, f"view_{v.name}",
                        (_spec_fp(v.spec),
                         tuple(sorted(v.applied.items())),
                         tuple(sorted(target.items())),
                         v.state_digest))
                meta = {"delta_rows": delta_rows}
                if ckpt is not None and 0 in ckpt.completed:
                    ckpt.verify_meta(0, f"view[{v.name}] delta",
                                     **meta)
                    partial = _resume_partial(ckpt, 0,
                                              op=f"view_{v.name}")
                else:
                    resilience.inject("plan", f"view.{v.name}.delta")
                    partial = _host_state(v.query_fn(inputs))
                    if ckpt is not None:
                        cols, rows = _encode_partial(partial)
                        ckpt.complete(0, cols, rows,
                                      meta=_partial_schema_meta(
                                          partial, meta))
                if ckpt is not None and 1 in ckpt.completed:
                    merged = _resume_partial(ckpt, 1,
                                             op=f"view_{v.name}")
                else:
                    def _merge():
                        resilience.inject("global_merge",
                                          f"view.{v.name}")
                        return combiners.merge_delta(v.state, partial,
                                                     v.spec)

                    # the merge runs bounded like the fallback's own
                    # global merge — a hang dumps stacks, not wedges
                    merged = watchdog.bounded(
                        _merge, "fallback_merge",
                        detail=f"view.{v.name}")
                    if ckpt is not None:
                        cols, rows = _encode_partial(merged)
                        ckpt.complete(1, cols, rows,
                                      meta=_partial_schema_meta(
                                          merged, meta))
                # the swap: state + watermark + digest publish
                # together under v._mu — a reader sees the old view or
                # the new view, never a blend
                v.state = merged
                v.state_digest = _state_digest(merged)
            v.applied = target
            v._present_memo = None
        v.refreshes += 1
        wall = time.perf_counter() - t0
        v.last_refresh_s = wall
        gens = dict(v.applied)
        digest = v.state_digest
    telemetry.histogram("view.refresh_seconds",
                        view=v.name).observe(wall)
    if delta_rows:
        telemetry.counter("view.delta_rows",
                          view=v.name).inc(delta_rows)
    _events.emit("view_refresh", view=v.name,
                 generation=int(gens.get(v.delta_source, 0)),
                 delta_rows=(-1 if delta_rows is None else delta_rows),
                 wall_s=round(wall, 6), full_recompute=full_recompute)
    return {"view": v.name, "refreshed": True,
            "full_recompute": full_recompute,
            "delta_rows": delta_rows, "generations": gens,
            "digest": digest, "wall_s": wall}


def read(name: str, env=None) -> dict:
    """Generation-consistent read: ``{"result", "generations",
    "digest", "lag"}`` captured under one view-mutex hold — the result
    IS the view at exactly those generations. ``lag`` is how many
    generations the freshest source has advanced past the state
    (0 = fully current). The presented result (sort + row limit, or a
    two-phase finalize) memoizes per watermark; appends evict the
    memo (``cylon_tpu/views/materialized.py`` ``read``)."""
    from cylon_tpu_torch import catalog

    v = _view(name, env)
    with v._mu:
        applied = dict(v.applied)
        memo = v._present_memo
        if memo is not None and memo[0] == applied:
            result = memo[1]
        else:
            result = combiners.present(v.state, v.spec, v.limit)
            v._present_memo = (applied, result)
        digest = v.state_digest
    lag = 0
    for alias, tid in v.sources.items():
        try:
            lag = max(lag, catalog.generation(tid, env=v.env)
                      - applied.get(alias, 0))
        except (KeyError_, InvalidArgument):
            pass  # source dropped: lag is undefined, not an error
    return {"view": v.name, "result": result, "generations": applied,
            "digest": digest, "lag": int(lag)}


def view_version(name: str, env=None) -> dict:
    """``{"generations", "digest"}`` without materializing the
    presented result.

    (``cylon_tpu/views/materialized.py`` ``view_version``)"""
    v = _view(name, env)
    with v._mu:
        return {"generations": dict(v.applied),
                "digest": v.state_digest}


def list_views() -> "list[str]":
    with _reg_mu:
        return sorted({k[0] for k in _views})


def stats(env=None) -> "dict[str, dict]":
    """Per-view inventory (the serve ``/views`` payload): sources,
    watermarks, digest, refresh count, state size — of the views
    ``env``'s rank holds (with no env, or one of one rank, the views
    registered so).

    (``cylon_tpu/views/materialized.py`` ``stats``)"""
    rank = _vkey("", env)[1]
    with _reg_mu:
        items = [(k[0], v) for k, v in _views.items() if k[1] == rank]
    out = {}
    for name, v in items:
        with v._mu:
            state = v.state
            out[name] = {
                "sources": dict(v.sources),
                "delta_source": v.delta_source,
                "merge": v.spec["merge"],
                "generations": dict(v.applied),
                "digest": v.state_digest,
                "refreshes": int(v.refreshes),
                "last_refresh_s": v.last_refresh_s,
                "state_rows": (None if state is None else
                               1 if isinstance(state, float)
                               else int(len(state))),
            }
    return out


def drop_view(name: str, *, if_exists: bool = True, env=None) -> None:
    """Forget view ``name`` (as ``env``'s rank holds it); an unknown
    name is a no-op unless ``if_exists=False``.

    (``cylon_tpu/views/materialized.py`` ``drop_view``)"""
    key = _vkey(name, env)
    with _reg_mu:
        if key not in _views:
            if if_exists:
                return
            raise KeyError_(f"no view registered under {name!r}")
        del _views[key]


def clear() -> None:
    """Drop every view + the host-frame cache (test/teardown hatch)."""
    with _reg_mu:
        _views.clear()
    _HOST_CACHE.clear()
