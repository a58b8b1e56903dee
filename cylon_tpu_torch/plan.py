"""Capacity scale, the eager regrow ladder and whole queries.

Port of ``cylon_tpu/plan.py``. Operators with a defaulted result bound
(the local ``join``'s ``left.capacity + right.capacity``, the exchanges'
receive buffers) multiply it by the ambient :func:`current_scale`;
:func:`regrow_eager` runs one local op, reads its row count and, on an
overflow, runs it again at twice the scale, up to :data:`MAX_SCALE`.

:func:`compile_query` wraps a whole query (tables or frames in, tables,
frames or scalars out) into a :class:`CompiledQuery`. The JAX package
traces the query into one XLA program, whose row counts the host cannot
read until the end, so only the whole-query ladder can regrow there. The
port runs the query eagerly (CUDA graphs are a later option): every op's
count is concrete, so each op's ladder still regrows on its own, seeded
from the ambient scale. A :class:`CompiledQuery` keeps what the JAX one
promises its callers:

- one host transfer after the call reads every result table's row count,
  the overflow flags the ops registered (:func:`note_overflow`) and the
  small result scalars; an overflow reruns the whole query at twice the
  scale, or raises :class:`OutOfCapacity` past :data:`MAX_SCALE`;
- a scale memo per static arguments and input shapes, widen-only: the
  ladders report the highest scale they reached (:func:`note_scale`), so
  a second call starts where the first settled and runs each op once;
- scalar aggregates inside it stay 0-d tensors, and local result tables
  come back shrunk to the power-of-two bucket of their rows.

Its telemetry is the JAX package's (``cylon_tpu/plan.py:495-571``):
``plan.cache_hits`` / ``plan.cache_misses`` / ``plan.cache_evictions``
read off the scale memo (a hit is a run at the scale the memo holds for
its static key and input shapes; a miss, the eager "compile", counts in
``plan.compile_count`` with a ``plan.compile`` instant),
``plan.dispatch`` and ``plan.fetch`` stage spans each under
:func:`~cylon_tpu_torch.telemetry.memory.forensics`, and the
whole-query regrow's ``plan.overflow_events`` /
``plan.capacity_rescales`` with their ``capacity.*`` instants. The memo
keeps the ``_MEMO_ENTRIES`` most recently used entries (the JAX
package's ``CYLON_TPU_PLAN_CACHE_ENTRIES`` bounds its compiled
programs, which the eager port has none of).

Left out, with the reasons in ``ROADMAP.md``: the row hint (the port's
exchanges size from real counts), the result-size memo and its slicer
(eager results are already shrunk), the ``CYLON_TPU_ADAPTIVE`` and
``CYLON_TPU_TIGHT`` switches (the port's ladders and tight sizing are
always on), and the watchdog and fault hooks (with their modules).
"""

import collections
import contextlib
import contextvars
import functools
import threading

import numpy as np
import torch

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.tracing import span as _span

__all__ = ["CompiledQuery", "MAX_SCALE", "capacity_scale", "compile_query",
           "current_scale", "in_compiled", "note_overflow", "note_scale",
           "plan_cache_stats", "query_fingerprint", "regrow_eager",
           "shared_compiled"]

#: regrow ceiling: 1024x the default budget (``cylon_tpu/plan.py:58``)
MAX_SCALE = 1024

#: entries a query's scale memo keeps, least recently used evicted
#: first: far above any sane shape churn, so that a pathological
#: workload cannot grow the memo without bound
_MEMO_ENTRIES = 4096

_SCALE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_capacity_scale", default=1)

#: the overflow flags registered by the ops of the running
#: :class:`CompiledQuery` (``cylon_tpu/plan.py:71``); None outside one.
#: A query that returns only a scalar has no table whose count could
#: carry an overflow, so the scalar aggregates register theirs here.
_FLAGS: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_overflow_flags", default=None)

#: the scales the ladders of the running :class:`CompiledQuery` settled
#: at; None outside one
_REACHED: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_reached_scales", default=None)


def note_overflow(flag) -> None:
    """Register an overflow indicator (a bool, or a 0-d or 1-element bool
    tensor) with the enclosing :class:`CompiledQuery` (port of
    ``cylon_tpu/plan.py:75``); a no-op outside one. Ops whose result
    cannot carry the overflow in a row count (scalar aggregates) must
    call it."""
    flags = _FLAGS.get()
    if flags is not None:
        flags.append(torch.as_tensor(flag).reshape(()))


def note_scale(scale: int) -> None:
    """Report the scale a regrow ladder settled at to the enclosing
    :class:`CompiledQuery`, whose memo keeps the highest; a no-op outside
    one."""
    reached = _REACHED.get()
    if reached is not None:
        reached.append(int(scale))


def in_compiled() -> bool:
    """Whether a :class:`CompiledQuery` is running the caller."""
    return _FLAGS.get() is not None


@contextlib.contextmanager
def _collect_flags(flags: list, reached: list):
    """Collect the overflow flags and the ladders' scales of one run
    (``cylon_tpu/plan.py:90``)."""
    tok_f, tok_r = _FLAGS.set(flags), _REACHED.set(reached)
    try:
        yield
    finally:
        _REACHED.reset(tok_r)
        _FLAGS.reset(tok_f)


@contextlib.contextmanager
def capacity_scale(scale: int):
    """Ambient multiplier for defaulted capacity bounds
    (``cylon_tpu/plan.py:99``)."""
    tok = _SCALE.set(int(scale))
    try:
        yield
    finally:
        _SCALE.reset(tok)


def current_scale() -> int:
    """The ambient scale (``cylon_tpu/plan.py:108``); 1 outside
    :func:`capacity_scale`."""
    return _SCALE.get()


def regrow_eager(run, *, bounded: bool):
    """Regrow ladder for one eager local op (``cylon_tpu/plan.py:730``).

    ``run()`` builds and runs the op, reading :func:`current_scale` for
    its defaulted bounds, and returns a local Table. ``bounded=True``
    (the caller passed an explicit capacity) keeps the raise-on-overflow
    contract: the result is returned unchecked. Otherwise the row count
    is read (one host sync) and an overflow reruns at twice the scale;
    the scale that fitted is reported (:func:`note_scale`)."""
    scale = current_scale()
    while True:
        with capacity_scale(scale):
            t = run()
        if bounded:
            return t
        try:
            t.num_rows
        except OutOfCapacity:
            if scale >= MAX_SCALE:
                raise
            scale *= 2
            continue
        note_scale(scale)
        return t


# ------------------------------------------------------------ whole queries
def _is_frame(x) -> bool:
    from cylon_tpu_torch.frame import DataFrame

    return isinstance(x, DataFrame)


def _result_tables(out) -> list:
    """``(table, env)`` of every table and frame in a query result (nested
    in lists, tuples and dicts), in visiting order; ``env`` is the frame's
    (None for a local frame or a bare table)."""
    from cylon_tpu_torch.table import Table

    found = []

    def visit(x):
        if isinstance(x, Table):
            found.append((x, None))
        elif _is_frame(x):
            found.append((x.table, x.env))
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(out)
    return found


#: tensors this small in a result ride the overflow check's transfer
#: (scalar aggregates and tiny vectors, never column buffers;
#: ``cylon_tpu/plan.py:190``)
_PREFETCH_ELEMS = 512


def _result_scalars(out) -> list:
    """Small bare tensors in a query result, not table columns."""
    found = []

    def visit(x):
        if torch.is_tensor(x):
            if x.numel() <= _PREFETCH_ELEMS:
                found.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(out)
    return found


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """A tensor as int64 elements that keep its values (integers and
    bools) or its bits (floats), flat."""
    x = x.reshape(-1)
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    return x.to(torch.int64)


def _check_overflow(out, flags: list) -> list:
    """Raise :class:`OutOfCapacity` if a registered flag fired or a result
    table overflowed (``cylon_tpu/plan.py:246``); else return the local
    result tables' row counts (None for a distributed one).

    One host transfer: the flags, every result table's count and
    capacity (a distributed table's gathered over its env in one
    all-gather, so every rank takes the same decision) and the small
    result scalars are stacked into one tensor, and ``.cpu()`` is called
    once. Its one sync also completes the scalars, so the caller's
    ``float()`` of one is a copy, not a wait for the query. A wedged card
    hangs exactly there, so the transfer is the watchdog's
    ``overflow_fetch`` section (:func:`cylon_tpu_torch.watchdog.bounded`,
    ``cylon_tpu/plan.py:288``; never retryable)."""
    # imported here: the resilience layer's config imports the dist ops,
    # which import this module
    from cylon_tpu_torch import watchdog

    tables = _result_tables(out)
    scalars = _result_scalars(out)
    envs = {id(env): env for _, env in tables if env is not None}
    if len(envs) > 1:
        raise InvalidArgument("a query's distributed results lie on "
                              "several envs; the overflow check needs one")
    env = next(iter(envs.values()), None)
    dev = next((t.device for t, _ in tables), None) or next(
        (x.device for x in scalars + flags), torch.device("cpu"))
    # every piece is made on the device (a fill, never a copy from the
    # host, which would sync the stream once a piece)
    flag = torch.zeros(1, dtype=torch.int64, device=dev)
    for f in flags:
        flag = flag | f.to(device=dev, dtype=torch.int64).reshape(1)
    parts = [flag]
    for t, _ in tables:
        parts.append(t.nrows.to(torch.int64).reshape(1))
        parts.append(torch.full((1,), t.capacity, dtype=torch.int64,
                                device=dev))
    parts.extend(_as_words(s.to(dev)) for s in scalars)
    local = torch.cat(parts)
    if env is not None:
        # the flags and counts of every rank, so the decision is the
        # world's (the scalars ride along: a distributed scalar is the
        # same on every rank)
        gathered = env.comm.all_gather(local).reshape(env.world_size, -1)
        host = watchdog.bounded(lambda: gathered.cpu().numpy(),
                                "overflow_fetch",
                                detail=f"{gathered.numel()} words")
        mine = host[env.rank]
        bad = bool(host[:, 0].any())
    else:
        mine = watchdog.bounded(lambda: local.cpu().numpy(),
                                "overflow_fetch",
                                detail=f"{local.numel()} words")
        bad = bool(mine[0])
    if bad:
        raise OutOfCapacity("an op inside the compiled query overflowed "
                            "its capacity bound")
    counts = []
    for i, (t, tenv) in enumerate(tables):
        if tenv is not None:
            sizes = host[:, 1 + 2 * i:3 + 2 * i]
            if (sizes[:, 0] > sizes[:, 1]).any():
                raise OutOfCapacity(
                    f"result shard row counts {sizes[:, 0].tolist()} exceed "
                    f"their capacities {sizes[:, 1].tolist()}")
            counts.append(None)
            continue
        n, cap = int(mine[1 + 2 * i]), int(mine[2 + 2 * i])
        if n > cap:
            raise OutOfCapacity(f"result rows {n} exceed capacity {cap}")
        counts.append(n)
    return counts


def _shrink_results(out, counts: list):
    """The query result with its local tables trimmed to the power-of-two
    bucket of their rows (``cylon_tpu/plan.py:327``,
    ``shrink_to_fit(only_above=0)``), from the counts the overflow check
    fetched: no further sync. Distributed results keep their shard;
    frames are rewrapped. Tables are visited in
    :func:`_result_tables`' order."""
    from cylon_tpu_torch.frame import DataFrame
    from cylon_tpu_torch.table import Table
    from cylon_tpu_torch.utils import pow2_bucket

    it = iter(counts)

    def shrink(t):
        n = next(it)
        if n is None:
            return t
        bucket = pow2_bucket(n, 1024)
        return t.with_capacity(bucket) if bucket < t.capacity else t

    def walk(x):
        if isinstance(x, Table):
            return shrink(x)
        if isinstance(x, DataFrame):
            return DataFrame._wrap(shrink(x.table), x._index, x.env)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(out)


def _is_dynamic(x) -> bool:
    """Tables, frames, tensors and arrays (nested ok) are the query's
    data; everything else is a static argument
    (``cylon_tpu/plan.py:686``)."""
    from cylon_tpu_torch.table import Table

    if isinstance(x, Table) or _is_frame(x):
        return True
    if isinstance(x, (list, tuple)):
        return any(_is_dynamic(v) for v in x)
    if isinstance(x, dict):
        return any(_is_dynamic(v) for v in x.values())
    return isinstance(x, (torch.Tensor, np.ndarray))


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, set):
        return frozenset(_hashable(x) for x in v)
    return v


def _split_args(args, kwargs):
    """The call's arguments as ``(dynamic positional, static positional as
    (index, value) pairs, static keywords, dynamic keywords)``, the
    statics made hashable (``cylon_tpu/plan.py:700``)."""
    dyn_pos, static_pos = [], []
    for i, v in enumerate(args):
        if _is_dynamic(v):
            dyn_pos.append(v)
        else:
            static_pos.append((i, _hashable(v)))
    static_kw, dyn_kw = [], {}
    for k, v in kwargs.items():
        if _is_dynamic(v):
            dyn_kw[k] = v
        else:
            static_kw.append((k, _hashable(v)))
    return dyn_pos, tuple(static_pos), tuple(sorted(static_kw)), dyn_kw


def _leaves(x) -> list:
    """The tensors and arrays of the dynamic arguments, in a fixed order:
    a table's columns (data, then validity) and its row count."""
    from cylon_tpu_torch.table import Table

    if _is_frame(x):
        x = x.table
    if isinstance(x, Table):
        out = []
        for c in x.columns.values():
            out.append(c.data)
            if c.validity is not None:
                out.append(c.validity)
        return out + [x.nrows]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x, key=repr) for leaf in _leaves(x[k])]
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    return []


def _shape_signature(dyn_pos, dyn_kw) -> tuple:
    return tuple((tuple(x.shape), str(x.dtype))
                 for x in _leaves((list(dyn_pos), dyn_kw)))


class CompiledQuery:
    """A whole query with one overflow check and a scale memo (port of
    ``cylon_tpu/plan.py:374``, eager; see the module docstring).

    Call it like the function. Tables, frames, tensors and arrays
    (positional or keyword, nested in dicts and lists) are the data;
    every other argument must be hashable and joins the memo key with
    the data's shapes and dtypes."""

    def __init__(self, fn):
        self._fn = fn
        #: one lock for the memo: a CompiledQuery is shared across
        #: threads (:func:`shared_compiled`, ``ThreadWorld`` ranks), and
        #: each read-modify-write of the memo holds it; the query itself
        #: runs outside it
        self._mu = threading.Lock()
        #: (static key, input shapes) -> the highest scale a run settled
        #: at; least recently used first, at most ``_MEMO_ENTRIES``
        self._scale_memo: "collections.OrderedDict" = \
            collections.OrderedDict()

    def invalidate(self) -> None:
        """Drop the memo (``cylon_tpu/plan.py:449``)."""
        with self._mu:
            self._scale_memo.clear()

    def __call__(self, *args, **kwargs):
        dyn_pos, static_pos, static_kw, dyn_kw = _split_args(args, kwargs)
        key = (static_pos, static_kw, _shape_signature(dyn_pos, dyn_kw))
        with self._mu:
            hit = key in self._scale_memo
            scale = self._scale_memo.get(key, 1)
            if hit:
                self._scale_memo.move_to_end(key)
        while True:
            telemetry.counter("plan.cache_hits" if hit
                              else "plan.cache_misses").inc()
            if not hit:
                telemetry.counter("plan.compile_count").inc()
                _trace.instant("plan.compile", cat="plan", scale=scale,
                               fn=getattr(self._fn, "__name__", "?"))
            flags, reached = [], [scale]
            # the dispatch span covers the eager query (its device work
            # queued, its ops' own syncs included); the fetch span is
            # the one transfer of the overflow check. An allocation
            # failure in either gets the resident-consumer forensics
            # dump (telemetry.memory) before it propagates.
            with _span("plan.dispatch", cat="stage", cache_hit=hit), \
                    _memory.forensics("plan.dispatch"), \
                    capacity_scale(scale), _collect_flags(flags, reached):
                # seeded-fault hook (the "plan" injection point,
                # cylon_tpu/plan.py:522-525): the OOM→spill fallback's
                # tests inject allocation failures where a real one
                # surfaces
                from cylon_tpu_torch import resilience

                resilience.inject("plan", getattr(self._fn, "__name__",
                                                  "?"))
                out = self._fn(*args, **kwargs)
            try:
                with _span("plan.fetch", cat="stage"), \
                        _memory.forensics("plan.fetch"):
                    counts = _check_overflow(out, flags)
            except OutOfCapacity:
                telemetry.counter("plan.overflow_events",
                                  site="compiled").inc()
                _trace.instant("capacity.overflow", cat="capacity",
                               site="compiled", scale=scale)
                if scale >= MAX_SCALE:
                    raise
                scale *= 2
                hit = False
                telemetry.counter("plan.capacity_rescales",
                                  site="compiled").inc()
                _trace.instant("capacity.regrow", cat="capacity",
                               site="compiled", scale=scale)
                continue
            with self._mu:
                # widen-only: a concurrent call that settled higher is
                # never clobbered back down (``cylon_tpu/plan.py:577``)
                top = max(reached)
                if top > self._scale_memo.get(key, 0):
                    self._scale_memo[key] = top
                self._scale_memo.move_to_end(key)
                evicted = 0
                while len(self._scale_memo) > _MEMO_ENTRIES:
                    self._scale_memo.popitem(last=False)
                    evicted += 1
            if evicted:
                telemetry.counter("plan.cache_evictions").inc(evicted)
            return _shrink_results(out, counts)


#: the process-wide compiled queries: fn -> CompiledQuery
#: (``cylon_tpu/plan.py:623``)
_SHARED_MU = threading.Lock()
_SHARED: "dict[object, CompiledQuery]" = {}


def shared_compiled(fn) -> CompiledQuery:
    """Get or create the process-wide :class:`CompiledQuery` of ``fn``
    (``cylon_tpu/plan.py:627``): every caller shares one memo."""
    with _SHARED_MU:
        cq = _SHARED.get(fn)
        if cq is None:
            cq = _SHARED[fn] = functools.wraps(fn)(CompiledQuery(fn))
    return cq


def plan_cache_stats() -> dict:
    """Hit/miss/eviction totals of the compiled-query memos plus the
    derived hit rate (``cylon_tpu/plan.py:645``)."""
    hits = telemetry.total("plan.cache_hits")
    misses = telemetry.total("plan.cache_misses")
    looked = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "evictions": telemetry.total("plan.cache_evictions"),
        "hit_rate": (hits / looked) if looked else 0.0,
        "shared_queries": len(_SHARED),
    }


def query_fingerprint(name: str, args=(), kwargs=None) -> "str | None":
    """Stable fingerprint of a registered query invocation
    (``cylon_tpu/plan.py:660``): sha256 of the query NAME plus the
    canonical JSON of its arguments, so two processes derive the SAME
    fingerprint for the same logical request without sharing any
    in-memory state. None when the arguments are not JSON-canonical
    (closures, tensors, ...): such an invocation has no stable identity
    and must never be coalesced or cached."""
    import hashlib
    import json

    try:
        blob = json.dumps(
            {"name": str(name), "args": list(args),
             "kwargs": dict(kwargs or {})},
            sort_keys=True, separators=(",", ":"), allow_nan=False)
    except (TypeError, ValueError):
        return None
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def compile_query(fn):
    """Decorator or wrapper: a :class:`CompiledQuery` of ``fn``
    (``cylon_tpu/plan.py:766``)."""
    return functools.wraps(fn)(CompiledQuery(fn))
