"""Capacity scale, the eager regrow ladder and whole queries.

Port of ``cylon_tpu/plan.py``. Operators with a defaulted result bound
(the local ``join``'s ``left.capacity + right.capacity``, the exchanges'
receive buffers) multiply it by the ambient :func:`current_scale`;
:func:`regrow_eager` runs one local op, reads its row count and, on an
overflow, runs it again at twice the scale, up to :data:`MAX_SCALE`.

:func:`compile_query` wraps a whole query (tables or frames in, tables,
frames or scalars out) into a :class:`CompiledQuery`. The JAX package
traces the query into one XLA program: one dispatch, one fetch of the
row counts and overflow flags, and a whole-query regrow on an overflow.
On a CUDA device the port does the same with one CUDA graph a query:

- the query runs in *capture mode* (:func:`capture_mode`), the port's
  counterpart of a JAX trace: no op reads a count on the host, each op
  of a bound or a shrink takes its size from :func:`settle` and
  registers its overflow with :func:`note_overflow` (at its one-rung
  default under a bare capture mode: the group-by takes one rung,
  frames do not shrink), scalars stay 0-d tensors, host constants come
  from :func:`staged`; the flags, the result tables' row counts and the
  small result scalars are packed into one device tensor;
- the first call at a scale is the graph's warm-up: the query runs
  eagerly with its ladders and shrinks, reading counts on the host, and
  each op's settled size is kept in order on a :class:`SizeTape` (it
  builds and warms the kernels, and its fetch settles the scale: an
  overflow reruns it at twice the scale). Then the query is captured
  into one ``torch.cuda.CUDAGraph`` (:data:`GRAPH_CLASS`) with each op
  given its size back from the tape, so the graph runs at the eager
  route's capacities with no host read;
- a later call on inputs of the same shapes replays the graph: the
  call's tensors are copied into the graph's own input buffers, one
  graph launch, one fetch of the packed tensor, and the results shrunk
  to the power-of-two bucket of their rows, copied out of the graph's
  memory pool.

A graph serves any input of its key, as a JAX executable serves any
input of its shapes. The key is the memo key (:func:`_describe`: static
arguments, schema, shapes and dtypes) with each input tensor's strides
and storage offset and which inputs share a storage (:func:`_layout`),
each column's dictionary by content (``column.Dictionary`` hashes by
its values) and a frame's env by identity. A graph is captured on its
own input buffers (:class:`_InputBuffers`), not on the caller's tensors:
one buffer a storage the inputs share, each input a view at its offset
and strides, so an int64 column's halves stay 8-byte aligned
(``kernels.bucket.one_int64_key``). Before each replay the call's
tensors are copied in, one copy a storage, after the turn event on the
replay's stream; the copy is skipped when they are the tensors last
copied in and unchanged (a weak reference and ``_version``). The
buffers lie outside the shared pool and belong to the graph, which holds
no reference to a caller's tensor: a graph is let go on
:meth:`CompiledQuery.invalidate` or :func:`release_shared_graphs`, by a
serve engine's close, past :data:`GRAPH_ENTRIES` graphs a query (least
recently used first), or with its :class:`CompiledQuery`.

Every decision the warm-up took from the data is guarded on the device,
so a replay on new data never returns a stale answer. A replay whose
fetched flags show an overflow (new data past a size the warm-up
recorded, or a result past its capacity) drops its graph and the call
warms up and captures again at the same scale; the scale doubles only
when that warm-up's own fetch overflows. The audit of what a warm-up
decides:

- sizes on the :class:`SizeTape`, each registered as an overflow flag by
  its op's ``fixed`` branch: the regrow ladders (``"regrow"``: the join,
  the set ops and ``dist_join`` at W = 1 through :func:`regrow_eager`),
  the group-by's bound (``ops.groupby``; a bound of the whole capacity
  cannot overflow), ``frame._shrink`` (a cut below the op's bound), the
  exchanges' scales (``parallel.dist_ops._adaptive``);
- the hash join's route (``ops.join``, ``CYLON_TPU_JOIN_HASH_IMPL=
  bucketed``): recorded on the tape; the bucketed route registers the
  build's overflow count as a flag, the sort route fits any data;
- :func:`staged` constants, each a function of the key: dictionary
  remaps (``ops.dictenc``: dictionary content), ``Series.isin``'s probe
  (the call's values and the dictionary), TPC-H's ``_dict_mask`` codes
  (dictionary content and static arguments), Q16's sizes (a static
  argument). A capture takes constants only from its warm-up's cache,
  frozen: a constant made from data misses it and raises
  :class:`CaptureFailed`;
- dictionary unification (``dictenc.unify_dictionaries``): content, in
  the key;
- the W = 1 paths of ``dist_ops``: ``dist_aggregate`` registers the
  poison flag and computes on the device (its exact-median gate reads
  capacities, its nunique ladder reads a count on the host, so a
  capture of it fails rather than replaying); ``dist_head`` clips on
  the device by its static ``n``; ``dist_unique`` bounds by its static
  ``out_capacity`` and carries the poison in its row count.

The eager route is today's ladder of per-op regrows and one overflow
check after the query. It runs, and counts ``plan.eager_runs{reason}``,
by rule: for CPU tensors and host arrays (``reason="cpu"``) and for an
env of more than one rank (``"world"``: the ranks' counts cross on the
host). A capture or replay that fails raises; nothing falls back to the
eager route.

A :class:`CompiledQuery` keeps what the JAX one promises its callers:

- one host transfer after the call reads every result table's row count,
  the overflow flags the ops registered and the small result scalars; an
  overflow reruns the whole query at twice the scale, or raises
  :class:`OutOfCapacity` past :data:`MAX_SCALE`;
- a scale memo per static arguments and input schema and shapes,
  widen-only: the ladders report the highest scale they reached
  (:func:`note_scale`), so a second call starts where the first
  settled;
- scalar aggregates inside it stay 0-d tensors, and local result tables
  come back shrunk to the power-of-two bucket of their rows.

``compile_query(check=False)`` (``CompiledQuery(fn, check=False)``,
``shared_compiled(fn, check=False)``, a separate shared object from the
checked one) is the JAX package's unchecked mode, for callers that
inspect ``num_rows`` themselves: no overflow check after the call, so
no host transfer, no regrow and no shrink.

- A replay waits on the device's turn event, copies the call's tensors
  in, launches the graph and copies the results out at their full
  capacities, then records the turn event: no host read and no sync, so
  a caller can enqueue many calls back to back. The flags of word 0 of
  the packed tensor are folded into the copies on the device: where one
  fired, each result table's (and each shard's) row count becomes
  ``capacity + 1``, so ``num_rows`` raises :class:`OutOfCapacity`, and
  each bare tensor NaN (floats), ``iinfo.min`` (integers) or False
  (bool), the poison of the JAX package's scalar results. A graph whose
  flags fired is not let go (the host never learns it):
  :meth:`CompiledQuery.invalidate` does that.
- A key with no graph yet warms up and captures as a checked call does,
  and returns the warm-up's result, shrunk from the warm-up's own
  fetch: where the JAX package's first unchecked call compiles with no
  device sync, the port's warm-up reads sizes on the host.
- The eager route runs the query once at the memo's scale and returns
  its result as it comes, without settling the memo; the ops' own host
  reads (their ladders, the exchanges' count matrices at W > 1) stay.

Its telemetry is the JAX package's (``cylon_tpu/plan.py:495-571``):
``plan.cache_hits`` / ``plan.cache_misses`` / ``plan.cache_evictions``
(a hit is a replay, on the call's tensors or on new ones copied in, or
on the eager route a run at the memo's scale; a capture, or an eager run
at a new key, counts in ``plan.compile_count`` with a ``plan.compile``
instant), ``plan.dispatch`` and ``plan.fetch`` stage spans each under
:func:`~cylon_tpu_torch.telemetry.memory.forensics` (an unchecked call
has no fetch span), and
``plan.overflow_events`` / ``plan.capacity_rescales`` with their
``capacity.*`` instants: a flagged replay, or a warm-up whose fetch
overflows, is an overflow event; only a doubled scale is a rescale. The memo
keeps the ``_MEMO_ENTRIES`` most recently used entries.

Left out, with the reasons in ``ROADMAP.md``: the row hint (the port's
exchanges size from real counts), the result-size memo and its slicer
(results are shrunk from the fetched counts), and the
``CYLON_TPU_ADAPTIVE`` and ``CYLON_TPU_TIGHT`` switches (the port's
ladders and tight sizing are always on).
"""

import collections
import contextlib
import contextvars
import copy
import functools
import threading
import types
import weakref

import numpy as np
import torch

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import InvalidArgument, OutOfCapacity
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.tracing import host_read
from cylon_tpu_torch.utils.tracing import span as _span

__all__ = ["CaptureFailed", "CompiledQuery", "GRAPH_ENTRIES", "MAX_SCALE",
           "SizeTape", "capacity_scale", "capture_mode", "capturing",
           "compile_query", "current_scale", "in_compiled", "note_overflow",
           "note_scale", "plan_cache_stats", "query_fingerprint",
           "regrow_eager", "release_shared_graphs", "run_captured", "rung",
           "settle", "shared_compiled", "staged"]

#: regrow ceiling: 1024x the default budget (``cylon_tpu/plan.py:58``)
MAX_SCALE = 1024

#: entries a query's scale memo keeps, least recently used evicted
#: first: far above any sane shape churn, so that a pathological
#: workload cannot grow the memo without bound
_MEMO_ENTRIES = 4096

#: graphs a :class:`CompiledQuery` keeps, least recently used let go
#: first: each holds its memory pool, so the bound is small
GRAPH_ENTRIES = 8

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


#: True while a query runs in capture mode (:func:`capture_mode`)
_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_capture_mode", default=False)

#: the sizes of the graph being warmed or captured (:class:`SizeTape`);
#: None outside one
_TAPE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_size_tape", default=None)

#: the host constants of the graph being warmed or captured
#: (:func:`staged`): content -> device tensor, a dict while the warm-up
#: fills it, a read-only view of it while the graph is captured (a miss
#: there raises); None outside one
_STAGED: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_staged_constants", default=None)

#: the set of :class:`CompiledQuery` objects that captured a graph for
#: the caller's owner (a serve engine, which lets go of them on close);
#: None outside one (:func:`own_graphs`)
_OWNER: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_torch_graph_owner", default=None)

#: set while :func:`staged` itself builds a tensor from host data (the
#: host-read lint of the tests tells it from any other upload)
_STAGING = threading.local()


class CaptureFailed(RuntimeError):
    """Capturing a query into a CUDA graph failed; the message names the
    query and the op, the cause is chained."""


def capturing() -> bool:
    """Whether the caller runs in capture mode: no host read of a device
    value, no shrink, one rung a ladder (see the module docstring)."""
    return _CAPTURE.get()


@contextlib.contextmanager
def capture_mode():
    """Run the enclosed query in capture mode, the port's counterpart of
    a JAX trace (``cylon_tpu/plan.py:747``)."""
    tok = _CAPTURE.set(True)
    try:
        yield
    finally:
        _CAPTURE.reset(tok)


class SizeTape:
    """The sizes a graph's warm-up run settled its ops at (their capacity
    bounds and shrinks), in the order the ops asked for them
    (:func:`settle`): recorded while the warm-up reads counts eagerly,
    given back to the same ops in the same order while the graph is
    captured (:meth:`replaying`). An op of a ladder (a join under a
    regrow) records after the ladder's own entry, and only its last
    run's sizes stay (:func:`rung`)."""

    def __init__(self):
        #: ``(site, size)`` an op
        self.sizes: list = []
        #: the next size to give back; None while recording
        self.pos: "int | None" = None
        #: while recording, where the entries of the ops inside each
        #: enclosing :func:`settle` begin, innermost last
        self.marks: list = []

    def replaying(self) -> "SizeTape":
        """A tape that gives these sizes back from the first."""
        tape = SizeTape()
        tape.sizes, tape.pos = self.sizes, 0
        return tape

    def take(self, site):
        if self.pos >= len(self.sizes) or self.sizes[self.pos][0] != site:
            had = self.sizes[self.pos][0] if self.pos < len(self.sizes) \
                else "nothing"
            raise CaptureFailed(f"op {self.pos} of the capture is {site}, "
                                f"its warm-up's was {had}")
        self.pos += 1
        return self.sizes[self.pos - 1][1]

    def check_done(self) -> None:
        if self.pos is not None and self.pos != len(self.sizes):
            raise CaptureFailed(f"the capture asked {self.pos} sizes, its "
                                f"warm-up {len(self.sizes)}")


def settle(site, eager, fixed):
    """An op of a bound or a shrink at its size. ``eager()`` runs the op
    eagerly, finding its size by reading counts on the host (its ladder,
    its shrink), and returns ``(result, size)``; ``fixed(size)`` runs it
    at ``size`` with no host read, registering its overflow
    (:func:`note_overflow`), its one-rung default for ``size=None``.

    Outside capture mode ``eager()`` runs. In capture mode: under a
    recording :class:`SizeTape` (a graph's warm-up) ``eager()`` runs
    and its size is recorded under ``site``; under a replaying one (the
    capture) ``fixed`` takes the recorded size back, which must be
    ``site``'s; with no tape ``fixed(None)``."""
    if not capturing():
        return eager()[0]
    tape = _TAPE.get()
    if tape is None:
        return fixed(None)
    if tape.pos is None:
        slot = len(tape.sizes)
        tape.sizes.append((site, None))
        tape.marks.append(slot + 1)
        try:
            out, size = eager()
        finally:
            tape.marks.pop()
        tape.sizes[slot] = (site, size)
        return out
    return fixed(tape.take(site))


def rung() -> None:
    """A ladder's next run of its op begins: while a graph's warm-up
    records, the sizes the ops inside the ladder's earlier runs recorded
    are dropped, so that the capture, which runs the op once, finds only
    the last run's. Every ladder under :func:`settle` calls it before
    each run."""
    tape = _TAPE.get()
    if tape is not None and tape.pos is None and tape.marks:
        del tape.sizes[tape.marks[-1]:]


def own_graphs(owner: "weakref.WeakSet") -> None:
    """Record in ``owner`` every :class:`CompiledQuery` that captures a
    graph in the caller's context from now on (a thread's top-level
    function calls it once)."""
    _OWNER.set(owner)


def in_staging() -> bool:
    """Whether :func:`staged` is building a tensor from host data."""
    return getattr(_STAGING, "on", False)


def staged(values, device, dtype=None) -> torch.Tensor:
    """A constant made on the host (a list of codes, a lookup table) as a
    tensor on ``device``: the one way such a constant enters a query.

    Outside a graph it is uploaded. While a graph is warmed (its eager
    capture-mode run) the upload is kept, keyed by the constant's
    content, with the graph (:data:`_STAGED`); while it is captured the
    kept tensor is returned, so the capture holds no host-to-device copy
    and the constant lives as long as the graph. A constant first seen
    inside a capture raises :class:`CaptureFailed`: it was made from
    the data, which a replay on new inputs would not see, and not from
    the graph's key."""
    from cylon_tpu_torch.device import from_host

    arr = np.ascontiguousarray(np.asarray(values))
    device = torch.device(device)
    cache = _STAGED.get()
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(device),
           str(dtype))
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
        if not isinstance(cache, dict):
            raise CaptureFailed(
                f"a host constant of shape {arr.shape} that the graph's "
                "warm-up did not stage: made from the data, not from the "
                "static arguments, schema or dictionaries")
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise CaptureFailed(
            f"a host constant of shape {arr.shape} first seen inside a "
            "capture: its warm-up run did not stage it")
    _STAGING.on = True
    try:
        t = host_read("stage", lambda: from_host(arr, device, dtype))
    finally:
        _STAGING.on = False
    if cache is not None:
        cache[key] = t
    return t


def note_overflow(flag) -> None:
    """Register an overflow indicator (a bool, or a 0-d or 1-element bool
    tensor) with the enclosing :class:`CompiledQuery` (port of
    ``cylon_tpu/plan.py:75``); a no-op outside one. Ops whose result
    cannot carry the overflow in a row count (scalar aggregates) must
    call it."""
    flags = _FLAGS.get()
    if flags is not None:
        flags.append(flag.reshape(()) if torch.is_tensor(flag)
                     else bool(flag))


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
    the scale that fitted is reported (:func:`note_scale`). In capture
    mode (:func:`settle`) the count is not read: the op runs at its
    warm-up's scale, or the ambient one, its overflow is registered
    (:func:`note_overflow`) and the whole query regrows
    (``cylon_tpu/plan.py:747``)."""
    if bounded:
        return run()

    def ladder():
        scale = current_scale()
        while True:
            rung()
            with capacity_scale(scale):
                t = run()
            try:
                host_read("count", lambda: t.num_rows)
            except OutOfCapacity:
                if scale >= MAX_SCALE:
                    raise
                scale *= 2
                continue
            note_scale(scale)
            return t, scale

    def fixed(scale):
        with capacity_scale(current_scale() if scale is None else scale):
            t = run()
        note_overflow(t.nrows > t.capacity)
        return t

    return settle("regrow", ladder, fixed)


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


def _pack(out, flags: list):
    """The one tensor the overflow check fetches, on the device: the
    flags OR-ed into word 0, each result table's count and capacity, the
    small result scalars as words; for a distributed result, every
    rank's row of it (one all-gather, so every rank takes the same
    decision; a distributed scalar is the same on every rank). Returns
    ``(packed, env)``. Every piece is made on the device (a fill, never
    a copy from the host), so packing holds no sync and captures."""
    tables = _result_tables(out)
    scalars = _result_scalars(out)
    envs = {id(env): env for _, env in tables if env is not None}
    if len(envs) > 1:
        raise InvalidArgument("a query's distributed results lie on "
                              "several envs; the overflow check needs one")
    env = next(iter(envs.values()), None)
    dev = next((t.device for t, _ in tables), None) or next(
        (x.device for x in scalars + [f for f in flags if torch.is_tensor(f)]),
        torch.device("cpu"))
    fired = any(bool(f) for f in flags if not torch.is_tensor(f))
    flag = torch.full((1,), int(fired), dtype=torch.int64, device=dev)
    for f in flags:
        if torch.is_tensor(f):
            flag = flag | f.to(device=dev, dtype=torch.int64).reshape(1)
    parts = [flag]
    for t, _ in tables:
        parts.append(t.nrows.to(torch.int64).reshape(1))
        parts.append(torch.full((1,), t.capacity, dtype=torch.int64,
                                device=dev))
    parts.extend(_as_words(s.to(dev)) for s in scalars)
    local = torch.cat(parts)
    if env is None:
        return local, None
    return env.comm.all_gather(local).reshape(env.world_size, -1), env


def _fetch(packed: torch.Tensor):
    """The one device-to-host transfer of a call. A wedged card hangs
    exactly there, so it is the watchdog's ``overflow_fetch`` section
    (:func:`cylon_tpu_torch.watchdog.bounded`, ``cylon_tpu/plan.py:288``;
    never retryable)."""
    # imported here: the resilience layer's config imports the dist ops,
    # which import this module
    from cylon_tpu_torch import watchdog

    return watchdog.bounded(
        lambda: host_read("fetch", lambda: packed.cpu().numpy()),
        "overflow_fetch", detail=f"{packed.numel()} words")


def _decide(out, host, env) -> list:
    """Raise :class:`OutOfCapacity` if a registered flag fired or a result
    table overflowed (``cylon_tpu/plan.py:246``); else return the local
    result tables' row counts (None for a distributed one), from the
    fetched words of :func:`_pack`."""
    tables = _result_tables(out)
    if env is not None:
        mine = host[env.rank]
        bad = bool(host[:, 0].any())
    else:
        mine = host
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


def _check_overflow(out, flags: list) -> list:
    """The overflow check after an eager query
    (``cylon_tpu/plan.py:246``): :func:`_pack`, one ``.cpu()`` (whose
    sync also completes the scalars, so the caller's ``float()`` of one
    is a copy, not a wait for the query), then :func:`_decide`."""
    packed, env = _pack(out, flags)
    return _decide(out, _fetch(packed), env)


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


def _inputs(x, leaves: list, pins: list):
    """What a query sees of its dynamic arguments ``x``, hashable: each
    table's column names in order with their logical dtypes, a frame's
    index, a container's keys and the static values inside it. Appends
    their tensors and arrays to ``leaves`` in a fixed order (a column's
    data then its validity, a table's row count after its columns, a
    frame's index after its table) and the host objects a result depends
    on by identity (a column's dictionary, a frame's env) to ``pins``."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.indexing.index import BaseIndex
    from cylon_tpu_torch.table import Table

    def walk(x):
        if _is_frame(x):
            if x.env is not None:
                pins.append(x.env)
            return ("frame", walk(x.table), walk(x._index))
        if isinstance(x, Table):
            cols = tuple((n, walk(c)) for n, c in x.columns.items())
            leaves.append(x.nrows)
            return ("table", cols)
        if isinstance(x, Column):
            leaves.append(x.data)
            if x.validity is not None:
                leaves.append(x.validity)
            if x.dictionary is not None:
                pins.append(x.dictionary)
            return (x.dtype, x.validity is not None,
                    x.dictionary is not None)
        if isinstance(x, BaseIndex):
            return (type(x).__name__,
                    tuple((k, walk(v)) for k, v in sorted(vars(x).items())))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(x[k])) for k in sorted(x, key=repr)))
        if isinstance(x, (torch.Tensor, np.ndarray)):
            leaves.append(x)
            return "array"
        return ("static", _hashable(x))

    return walk(x)


def _describe(args, kwargs):
    """``(memo key, leaves, pins)`` of a call: the key holds its static
    arguments and its inputs' schema and shapes (:func:`_inputs`)."""
    dyn_pos, static_pos, static_kw, dyn_kw = _split_args(args, kwargs)
    leaves, pins = [], []
    schema = _inputs((list(dyn_pos), dyn_kw), leaves, pins)
    shapes = tuple((tuple(x.shape), str(x.dtype)) for x in leaves)
    return (static_pos, static_kw, schema, shapes), leaves, pins


def _rebind(x, new):
    """``x`` (a call's dynamic arguments) with each of its tensors and
    arrays replaced by the next of the iterator ``new``, in
    :func:`_inputs`' order; everything else is kept."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.frame import DataFrame
    from cylon_tpu_torch.indexing.index import BaseIndex
    from cylon_tpu_torch.table import Table

    if _is_frame(x):
        table = _rebind(x.table, new)
        return DataFrame._wrap(table, _rebind(x._index, new), x.env)
    if isinstance(x, Table):
        cols = {n: _rebind(c, new) for n, c in x.columns.items()}
        return Table(cols, next(new))
    if isinstance(x, Column):
        data = next(new)
        validity = None if x.validity is None else next(new)
        return Column(data, validity, x.dtype, x.dictionary)
    if isinstance(x, BaseIndex):
        y = copy.copy(x)
        for k, v in sorted(vars(x).items()):
            setattr(y, k, _rebind(v, new))
        return y
    if isinstance(x, (list, tuple)):
        vals = [_rebind(v, new) for v in x]
        return vals if isinstance(x, list) else tuple(vals)
    if isinstance(x, dict):
        vals = {k: _rebind(x[k], new) for k in sorted(x, key=repr)}
        return {k: vals[k] for k in x}
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return next(new)
    return x


def _bind(args, kwargs, leaves):
    """``(args, kwargs)`` of a call with its leaves (:func:`_describe`)
    replaced by ``leaves``, in order."""
    new = iter(leaves)
    args = [_rebind(v, new) if _is_dynamic(v) else v for v in args]
    dyn = {k: _rebind(kwargs[k], new) for k in sorted(
        (k for k, v in kwargs.items() if _is_dynamic(v)), key=repr)}
    if next(new, None) is not None:
        raise CaptureFailed("the call's inputs did not rebind in order")
    return args, {k: dyn.get(k, v) for k, v in kwargs.items()}


def _layout(leaves) -> tuple:
    """What a graph sees of its inputs' memory beside their shapes: each
    leaf's storage (numbered in order of first sight, so leaves that
    share one show it), storage offset and strides."""
    seen: dict = {}
    return tuple((seen.setdefault(x.untyped_storage().data_ptr(), len(seen)),
                  x.storage_offset(), tuple(x.stride())) for x in leaves)


def _pin_key(p):
    """A pin in a graph's key: a dictionary by content, an env by
    identity (the entry holds it, so its id is not reused)."""
    from cylon_tpu_torch.column import Dictionary

    return p if isinstance(p, Dictionary) else ("id", id(p))


#: a graph's input buffers keep each leaf's byte offset modulo this from
#: its storage's start; both caching allocators align a storage to at
#: least this (64 bytes on the CPU, 512 on CUDA), so a leaf keeps its
#: address alignment
_ALIGN = 64


def _extent(x: torch.Tensor) -> int:
    """Bytes from a tensor's first element to past its last (0 if
    empty)."""
    if x.numel() == 0:
        return 0
    return (sum((n - 1) * st for n, st in zip(x.shape, x.stride())) + 1) \
        * x.element_size()


class _InputBuffers:
    """A graph's own copies of its inputs: one buffer a storage the
    leaves share, holding the bytes from its first leaf's start to its
    last leaf's end, and each leaf a view into it at its offset and
    strides. :meth:`copy_in` copies a call's leaves in, one copy a
    storage. The buffers are allocated outside a graph's pool."""

    def __init__(self, leaves):
        groups: dict = {}
        for i, x in enumerate(leaves):
            groups.setdefault(x.untyped_storage().data_ptr(), []).append(i)
        self.leaves = [None] * len(leaves)
        #: ``(first leaf, lo, hi, destination)``: a storage's bytes
        #: [lo, hi) and where they go
        self.spans = []
        self.nbytes = 0
        for idx in groups.values():
            live = []
            for i in idx:
                x = leaves[i]
                if x.numel():
                    live.append(i)
                else:
                    self.leaves[i] = torch.empty_strided(
                        x.shape, x.stride(), dtype=x.dtype, device=x.device)
            if not live:
                continue
            offs = {i: leaves[i].storage_offset() * leaves[i].element_size()
                    for i in live}
            lo = min(offs.values())
            hi = max(offs[i] + _extent(leaves[i]) for i in live)
            base = lo - lo % _ALIGN
            buf = torch.empty(hi - base, dtype=torch.uint8,
                              device=leaves[live[0]].device)
            self.nbytes += buf.numel()
            for i in live:
                x = leaves[i]
                self.leaves[i] = torch.empty(
                    0, dtype=x.dtype, device=x.device).set_(
                    buf.untyped_storage(),
                    (offs[i] - base) // x.element_size(), x.shape,
                    x.stride())
            self.spans.append((live[0], lo, hi, buf[lo - base:]))
        #: weak references to the leaves last copied in, and their
        #: ``_version`` then
        self._last: list = []

    def current(self, leaves) -> bool:
        """Whether ``leaves`` are the tensors last copied in, unchanged
        since."""
        return len(self._last) == len(leaves) and all(
            r() is x and x._version == v
            for (r, v), x in zip(self._last, leaves))

    def copy_in(self, leaves, force: bool = False) -> int:
        """Copy ``leaves`` in on the current stream, unless they are
        :meth:`current` (``force`` copies anyway); the bytes copied."""
        if not force and self.current(leaves):
            return 0
        n = 0
        for i, lo, hi, dst in self.spans:
            src = torch.empty(0, dtype=torch.uint8, device=dst.device).set_(
                leaves[i].untyped_storage(), lo, (hi - lo,), (1,))
            dst.copy_(src)
            n += hi - lo
        self._last = [(weakref.ref(x), x._version) for x in leaves]
        return n


def _map_tables(out, table_fn):
    """``out`` with every table (bare or in a frame) replaced by
    ``table_fn(table)``, nested lists, tuples and dicts rebuilt, and bare
    tensors passed to ``table_fn`` too."""
    from cylon_tpu_torch.frame import DataFrame
    from cylon_tpu_torch.table import Table

    def walk(x):
        if isinstance(x, Table) or torch.is_tensor(x):
            return table_fn(x)
        if isinstance(x, DataFrame):
            return DataFrame._wrap(table_fn(x.table), x._index, x.env)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(out)


def _walk_frames(out, fn) -> None:
    """Call ``fn`` on every frame of a query result (nested in lists,
    tuples and dicts)."""
    if _is_frame(out):
        fn(out)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _walk_frames(v, fn)
    elif isinstance(out, dict):
        for v in out.values():
            _walk_frames(v, fn)


def _copy_tensors(pick):
    """A ``table_fn`` for :func:`_map_tables` that clones each tensor
    ``pick`` selects (a table's columns and row count, or a bare
    tensor) and keeps the others."""
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.table import Table

    def cp(x):
        return x.clone() if pick(x) else x

    def table_fn(x):
        if torch.is_tensor(x):
            return cp(x)
        cols = {n: Column(cp(c.data),
                          None if c.validity is None else cp(c.validity),
                          c.dtype, c.dictionary)
                for n, c in x.columns.items()}
        return Table(cols, cp(x.nrows))

    return table_fn


def _poisoned_copies(packed: torch.Tensor):
    """A ``table_fn`` for :func:`_map_tables` that copies a replay's
    results out of the pool with the overflow flags of ``packed`` (word
    0 of each rank's row, :func:`_pack`) folded in on the device: where
    one fired, each table's row count becomes ``capacity + 1`` (its
    ``num_rows`` raises :class:`OutOfCapacity`) and each bare tensor NaN,
    ``iinfo.min`` or False (the scalar aggregates' poison). No host
    read."""
    from cylon_tpu_torch.ops.aggregates import _poisoned

    bad = packed.reshape(-1, packed.shape[-1])[:, 0].any()
    copy = _copy_tensors(lambda x: x.dim() > 0)

    def table_fn(x):
        if torch.is_tensor(x):
            return _poisoned(x, bad)
        t = copy(x)
        return t.with_nrows(t.nrows.masked_fill(bad, t.capacity + 1))

    return table_fn


def run_captured(fn, args=(), kwargs=None, scale: int = 1,
                 tape: "SizeTape | None" = None):
    """Run the query ``fn(*args, **kwargs)`` in capture mode at
    ``scale`` and pack what its one fetch reads: returns ``(out,
    packed, env)`` (:func:`_pack`). This is the program a
    :class:`CompiledQuery` warms (``tape`` recording), captures and
    replays (``tape`` replaying); the tests run it on CPU tensors under
    their host-read lint."""
    flags = []
    tok = _TAPE.set(tape)
    try:
        with capture_mode(), capacity_scale(scale), \
                _collect_flags(flags, []):
            out = fn(*args, **(kwargs or {}))
            if tape is not None:
                tape.check_done()
            packed, env = _pack(out, flags)
    finally:
        _TAPE.reset(tok)
    return out, packed, env


#: the live graphs of each CUDA device (weakly: a graph whose
#: CompiledQuery is dropped goes with it), which share one memory pool: a
#: graph's temporaries may lie where another graph's lay, so the pools
#: of N queries cost about the largest query's working set, not N of
#: them. That is safe because replays take turns (:data:`_GRAPH_MU`,
#: :data:`_TURN`) and each copies its results out before the next one
#: runs. A capture joins the pool of a live graph; with none live it
#: takes a new pool, never the id of one whose graphs are all gone (its
#: last tensors may not be collected yet, and PyTorch refuses it)
_LIVE: "dict[int, weakref.WeakSet]" = {}

#: held while a graph is captured and while one is replayed, fetched and
#: copied out: graphs that share a pool never run over each other
_GRAPH_MU = threading.RLock()

#: per CUDA device, an event recorded after the last replay's copy-out;
#: the next replay's stream waits on it, so turns hold on the device
#: when callers replay from several streams
_TURN: dict = {}


class _CudaGraph:
    """One ``torch.cuda.CUDAGraph`` in its device's shared pool
    (:data:`_LIVE`); the :data:`GRAPH_CLASS` the package uses.
    ``device_type`` is the device whose tensors take the graph route.
    :meth:`capture` runs ``program`` (the query in capture mode on the
    graph's input buffers) once into the graph and returns its result,
    whose tensors every :meth:`replay` writes again."""

    device_type = "cuda"

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()
        self._device = torch.cuda.current_device()
        self.pool_bytes = 0

    def capture(self, program):
        # torch.cuda.graph empties the cache on entry too; emptied here
        # first, the reserved bytes' growth is what this capture added to
        # the pool. thread_local: another thread's work (a serve
        # engine's scheduler, a client) is not an error of this capture.
        # Called under _GRAPH_MU, as reset is
        live = _LIVE.setdefault(self._device, weakref.WeakSet())
        other = next(iter(live), None)
        pool = other._graph.pool() if other is not None else \
            torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        with torch.cuda.graph(self._graph, pool=pool,
                              capture_error_mode="thread_local"):
            result = program()
        self.pool_bytes = torch.cuda.memory_reserved() - before
        live.add(self)
        return result

    def replay(self) -> None:
        self._graph.replay()

    def reset(self) -> None:
        _LIVE.get(self._device, weakref.WeakSet()).discard(self)
        self._graph.reset()


#: the graph class of the graph route; tests put a stand-in here
GRAPH_CLASS = _CudaGraph

#: what a replay returns when its graph overflowed, or was let go by
#: another thread before it ran
_OVERFLOWED = object()
_RELEASED = object()


class _Entry:
    """One captured graph: its input buffers (:class:`_InputBuffers`),
    the host objects its key names (held), the pool-resident result and
    packed words it writes, and each kernel's launches a replay makes."""

    def __init__(self, gkey, graph, inputs, pins, out, packed, env,
                 launches, stage, scale):
        self.gkey = gkey
        self.graph = graph
        self.inputs = inputs
        # held: while the graph lives, no other env takes their ids
        self.pins = pins
        self.out, self.packed, self.env = out, packed, env
        self.launches = launches
        self.stage = stage
        self.scale = scale
        self.replays = 0

    def release(self) -> None:
        """Let go of the graph, its input buffers and every tensor of its
        pool; never while it is replayed (:data:`_GRAPH_MU`)."""
        with _GRAPH_MU:
            if self.graph is not None:
                self.graph.reset()
            self.graph = self.out = self.packed = self.stage = None
            self.inputs = self.pins = None

    def stats(self) -> dict:
        return {"scale": self.scale, "replays": self.replays,
                "launches": dict(self.launches),
                "pool_bytes": getattr(self.graph, "pool_bytes", 0),
                "input_bytes": self.inputs.nbytes if self.inputs else 0}


def _world_size(x) -> int:
    """The world size of an env or of a frame's env in ``x`` (nested);
    1 when there is none."""
    if _is_frame(x):
        x = x.env
    if isinstance(x, (list, tuple)):
        return max((_world_size(v) for v in x), default=1)
    if isinstance(x, dict):
        return max((_world_size(v) for v in x.values()), default=1)
    n = getattr(x, "world_size", 1)
    return n if isinstance(n, int) else 1


def _add_launches(delta: dict) -> None:
    from cylon_tpu_torch import kernels

    for w in kernels.WRAPPERS:
        w.launches += delta.get(w.__name__, 0)


class CompiledQuery:
    """A whole query: one CUDA graph a query on the card, one overflow
    check and a scale memo everywhere (port of ``cylon_tpu/plan.py:374``;
    see the module docstring).

    Call it like the function. Tables, frames, tensors and arrays
    (positional or keyword, nested in dicts and lists) are the data;
    every other argument must be hashable and joins the memo key with
    the data's schema, shapes and dtypes (:func:`_describe`).
    ``check=False`` is the unchecked mode of the module docstring: no
    host read after the call, the overflow carried in the result."""

    def __init__(self, fn, *, check: bool = True):
        self._fn = fn
        self._check = bool(check)
        #: one lock for the memo and the graphs: a CompiledQuery is
        #: shared across threads (:func:`shared_compiled`, ``ThreadWorld``
        #: ranks, a serve engine), and each read-modify-write of them
        #: holds it; the query itself runs outside it
        self._mu = threading.Lock()
        #: (static key, input shapes) -> the highest scale a run settled
        #: at; least recently used first, at most ``_MEMO_ENTRIES``
        self._scale_memo: "collections.OrderedDict" = \
            collections.OrderedDict()
        #: (memo key, layout, pins) -> _Entry, least recently used
        #: first
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()

    @property
    def _name(self) -> str:
        return getattr(self._fn, "__name__", "?")

    # -- graph bookkeeping ---------------------------------------------
    def _drop_locked(self, gkey) -> None:
        e = self._graphs.pop(gkey, None)
        if e is not None:
            e.release()

    def release_graphs(self) -> None:
        """Let go of every graph and its pool; the memo stays."""
        with self._mu:
            while self._graphs:
                self._graphs.popitem(last=False)[1].release()

    def invalidate(self) -> None:
        """Drop the memo and let go of every graph
        (``cylon_tpu/plan.py:449``)."""
        with self._mu:
            self._scale_memo.clear()
        self.release_graphs()

    def graph_stats(self) -> list:
        """Per graph held: its scale, replays, launches a replay, pool
        bytes and input buffers' bytes."""
        with self._mu:
            return [e.stats() for e in self._graphs.values()]

    # -- calls -----------------------------------------------------------
    def _eager_reason(self, args, kwargs, leaves) -> "str | None":
        if _world_size(list(args) + list(kwargs.values())) > 1:
            return "world"
        want = GRAPH_CLASS.device_type
        if not leaves or any(not torch.is_tensor(x) or x.device.type != want
                             for x in leaves):
            return "cpu"
        return None

    def _memo_lookup(self, key):
        """``(hit, scale)`` for ``key``, recording a first sight at its
        lookup: threads racing on one new key count one miss between
        them (``cylon_tpu/plan.py``'s no-double-count rule)."""
        hit = key in self._scale_memo
        scale = self._scale_memo.get(key, 1)
        if hit:
            self._scale_memo.move_to_end(key)
        else:
            self._scale_memo[key] = scale
        return hit, scale

    def _memo_settle(self, key, top: int) -> None:
        """Widen-only: a concurrent call that settled higher is never
        clobbered back down (``cylon_tpu/plan.py:577``)."""
        with self._mu:
            if top > self._scale_memo.get(key, 0):
                self._scale_memo[key] = top
            self._scale_memo.move_to_end(key)
            evicted = 0
            while len(self._scale_memo) > _MEMO_ENTRIES:
                self._scale_memo.popitem(last=False)
                evicted += 1
        if evicted:
            telemetry.counter("plan.cache_evictions").inc(evicted)

    def _overflowed(self, scale: int) -> None:
        """Count a whole-query overflow at ``scale``."""
        telemetry.counter("plan.overflow_events", site="compiled").inc()
        _trace.instant("capacity.overflow", cat="capacity",
                       site="compiled", scale=scale)

    def _regrow(self, scale: int) -> int:
        """Count a whole-query overflow at ``scale``; the next scale, or
        raise past :data:`MAX_SCALE`."""
        self._overflowed(scale)
        if scale >= MAX_SCALE:
            raise OutOfCapacity("an op inside the compiled query "
                                f"overflowed its bound at scale {scale}")
        telemetry.counter("plan.capacity_rescales", site="compiled").inc()
        _trace.instant("capacity.regrow", cat="capacity", site="compiled",
                       scale=scale * 2)
        return scale * 2

    def _inject(self) -> None:
        # seeded-fault hook (the "plan" injection point,
        # cylon_tpu/plan.py:522-525): the OOM→spill fallback's tests
        # inject allocation failures where a real one surfaces
        from cylon_tpu_torch import resilience

        resilience.inject("plan", self._name)

    def __call__(self, *args, **kwargs):
        key, leaves, pins = _describe(args, kwargs)
        reason = self._eager_reason(args, kwargs, leaves)
        if reason is not None:
            telemetry.counter("plan.eager_runs", reason=reason).inc()
            return self._run_eager(key, args, kwargs)
        return self._run_graph(key, leaves, pins, args, kwargs)

    def _run_eager(self, key, args, kwargs):
        """The eager route: the query with its per-op ladders, one
        overflow check, a whole-query regrow on an overflow. Unchecked,
        the query's result as it comes, at the memo's scale, which it
        does not settle (``cylon_tpu/plan.py:529-530``)."""
        with self._mu:
            hit, scale = self._memo_lookup(key)
        while True:
            telemetry.counter("plan.cache_hits" if hit
                              else "plan.cache_misses").inc()
            if not hit:
                telemetry.counter("plan.compile_count").inc()
                _trace.instant("plan.compile", cat="plan", scale=scale,
                               fn=self._name)
            flags, reached = [], [scale]
            # the dispatch span covers the eager query (its device work
            # queued, its ops' own syncs included); the fetch span is
            # the one transfer of the overflow check. An allocation
            # failure in either gets the resident-consumer forensics
            # dump (telemetry.memory) before it propagates.
            with _span("plan.dispatch", cat="stage", cache_hit=hit), \
                    _memory.forensics("plan.dispatch"), \
                    capacity_scale(scale), _collect_flags(flags, reached):
                self._inject()
                out = self._fn(*args, **kwargs)
            if not self._check:
                return out
            try:
                with _span("plan.fetch", cat="stage"), \
                        _memory.forensics("plan.fetch"):
                    counts = _check_overflow(out, flags)
            except OutOfCapacity:
                scale = self._regrow(scale)
                hit = False
                continue
            self._memo_settle(key, max(reached))
            return _shrink_results(out, counts)

    def _run_graph(self, key, leaves, pins, args, kwargs):
        """The graph route: replay the graph of this key on the call's
        inputs, or warm and capture one. A replay whose flags fire drops
        its graph, and the call warms and captures again at its scale."""
        gkey = (key, _layout(leaves), tuple(_pin_key(p) for p in pins))
        with self._mu:
            entry = self._graphs.get(gkey)
            if entry is not None:
                self._graphs.move_to_end(gkey)
            _, scale = self._memo_lookup(key)
        if entry is not None:
            out = self._replay(entry, leaves)
            if out is not _RELEASED:
                telemetry.counter("plan.cache_hits").inc()
                if out is not _OVERFLOWED:
                    return out
                with self._mu:
                    if self._graphs.get(gkey) is entry:
                        self._drop_locked(gkey)
                # the new data passed a size the warm-up recorded: its
                # own warm-up decides the sizes, at the same scale
                self._overflowed(entry.scale)
                scale = entry.scale
            else:
                telemetry.counter("plan.cache_misses").inc()
        else:
            telemetry.counter("plan.cache_misses").inc()
        return self._warm_and_capture(key, gkey, leaves, pins, args,
                                      kwargs, scale)

    def _replay(self, entry, leaves):
        """The call's inputs copied in, one graph launch, one fetch, the
        copy-out; :data:`_OVERFLOWED` on an overflow, :data:`_RELEASED`
        when another thread let go of the graph first. Unchecked, no
        fetch: the flags are folded into the copy-out on the device
        (:func:`_poisoned_copies`), which keeps the full capacities."""
        with _GRAPH_MU:
            if entry.graph is None:
                return _RELEASED
            dev = entry.packed.device
            cuda = dev.type == "cuda"
            with _span("plan.dispatch", cat="stage", cache_hit=True), \
                    _memory.forensics("plan.dispatch"):
                self._inject()
                if cuda and dev.index in _TURN:
                    torch.cuda.current_stream(dev).wait_event(
                        _TURN[dev.index])
                with _span("plan.copy_in", device=True):
                    entry.inputs.copy_in(leaves)
                entry.graph.replay()
                entry.replays += 1
                _add_launches(entry.launches)
            if self._check:
                with _span("plan.fetch", cat="stage"), \
                        _memory.forensics("plan.fetch"):
                    host = _fetch(entry.packed)
                try:
                    counts = _decide(entry.out, host, entry.env)
                except OutOfCapacity:
                    return _OVERFLOWED
                out = _map_tables(_shrink_results(entry.out, counts),
                                  _copy_tensors(lambda x: True))
            else:
                out = _map_tables(entry.out, _poisoned_copies(entry.packed))
            if cuda:
                turn = torch.cuda.Event()
                turn.record(torch.cuda.current_stream(dev))
                _TURN[dev.index] = turn
            return out

    def _warm_and_capture(self, key, gkey, leaves, pins, args, kwargs,
                          scale: int):
        """The warm-up: the query eagerly on the call's tensors, its sizes
        recorded, until it fits (its result is the call's); then the
        capture at that scale and those sizes."""
        stage: dict = {}
        while True:
            tape = SizeTape()
            tok = _STAGED.set(stage)
            try:
                with _span("plan.dispatch", cat="stage", cache_hit=False), \
                        _memory.forensics("plan.dispatch"):
                    self._inject()
                    out, packed, env = run_captured(self._fn, args, kwargs,
                                                    scale, tape=tape)
            finally:
                _STAGED.reset(tok)
            try:
                with _span("plan.fetch", cat="stage"), \
                        _memory.forensics("plan.fetch"):
                    counts = _decide(out, _fetch(packed), env)
            except OutOfCapacity:
                scale = self._regrow(scale)
                continue
            break
        result = _shrink_results(out, counts)
        del out, packed
        self._memo_settle(key, scale)
        entry = self._capture(gkey, leaves, pins, args, kwargs, scale,
                              stage, tape)
        with self._mu:
            self._drop_locked(gkey)
            self._graphs[gkey] = entry
            while len(self._graphs) > GRAPH_ENTRIES:
                self._graphs.popitem(last=False)[1].release()
        return result

    def _capture(self, gkey, leaves, pins, args, kwargs, scale: int,
                 stage: dict, tape: SizeTape):
        """The query captured on its own input buffers, the call's
        tensors copied in, at the warm-up's ``scale`` and sizes
        (``tape``), with its constants (``stage``) frozen."""
        from cylon_tpu_torch import kernels
        from cylon_tpu_torch.kernels import build

        telemetry.counter("plan.compile_count").inc()
        _trace.instant("plan.compile", cat="plan", scale=scale,
                       fn=self._name)
        inputs = _InputBuffers(leaves)
        inputs.copy_in(leaves)
        bargs, bkwargs = _bind(args, kwargs, inputs.leaves)
        frozen = types.MappingProxyType(stage)

        def program():
            tok = _STAGED.set(frozen)
            try:
                return run_captured(self._fn, bargs, bkwargs, scale,
                                    tape=tape.replaying())
            finally:
                _STAGED.reset(tok)

        graph = GRAPH_CLASS()
        try:
            # a capture runs nothing: this thread's launches into it are
            # tallied apart and count at each replay
            with _GRAPH_MU, build.graph_tally() as tally:
                out, packed, env = graph.capture(program)
        except Exception as exc:
            raise CaptureFailed(
                f"capturing {self._name} at scale {scale} failed: "
                f"{type(exc).__name__}: {exc}") from exc
        indexed = []
        _walk_frames(out, lambda f: indexed.append(f._index is not None))
        if any(indexed):
            with _GRAPH_MU:
                graph.reset()
            raise CaptureFailed(f"{self._name} returns a frame with an "
                                "index, whose tensors a replay would not "
                                "copy out of the graph's pool")
        owner = _OWNER.get()
        if owner is not None:
            owner.add(self)
        launches = {w.__name__: tally.get(w.__name__, 0)
                    for w in kernels.WRAPPERS}
        return _Entry(gkey, graph, inputs, pins, out, packed, env, launches,
                      stage, scale)


#: the process-wide compiled queries: (fn, check) -> CompiledQuery
#: (``cylon_tpu/plan.py:623``)
_SHARED_MU = threading.Lock()
_SHARED: "dict[tuple, CompiledQuery]" = {}


def shared_compiled(fn, *, check: bool = True) -> CompiledQuery:
    """Get or create the process-wide :class:`CompiledQuery` of ``fn``
    and ``check`` (``cylon_tpu/plan.py:627``): every caller shares one
    memo and its graphs."""
    key = (fn, bool(check))
    with _SHARED_MU:
        cq = _SHARED.get(key)
        if cq is None:
            cq = _SHARED[key] = functools.wraps(fn)(
                CompiledQuery(fn, check=check))
    return cq


def release_shared_graphs() -> None:
    """Let go of every graph of the process-wide compiled queries and its
    input buffers (their memos stay): a graph outlives the inputs it
    served, so a caller done with a workload frees its memory here."""
    with _SHARED_MU:
        queries = list(_SHARED.values())
    for cq in queries:
        cq.release_graphs()


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


def compile_query(fn=None, *, check: bool = True):
    """Decorator or wrapper: a :class:`CompiledQuery` of ``fn``
    (``cylon_tpu/plan.py:766``), as ``@compile_query`` or
    ``@compile_query(check=False)``. ``check=False`` skips the overflow
    check and its one host transfer, for callers that inspect
    ``num_rows`` themselves (the module docstring's unchecked mode)."""
    if fn is None:
        return functools.partial(compile_query, check=check)
    return functools.wraps(fn)(CompiledQuery(fn, check=check))
