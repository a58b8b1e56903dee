"""Pipelined out-of-core execution: bounded prefetch + async commit.

Port of ``cylon_tpu/pipeline.py`` (host code). The out-of-core and
fallback passes read unit k, compute unit k and spill unit k; this module
overlaps the host stages with the device work, shared by every long pass
(:mod:`cylon_tpu_torch.outofcore`, :mod:`cylon_tpu_torch.fallback`, the
``tpch`` streaming drivers):

1. **Bounded prefetch** (:func:`prefetched` / :func:`prefetch_map`): unit
   k+1's ingest (chunk pull, host partition slicing, the table's
   assembly and copy to the device) runs on a worker thread while unit k
   computes. Lookahead is bounded by ``CYLON_TPU_OOC_PREFETCH_DEPTH``
   (default 1, double buffering; 0 disables the pipeline, the
   sequential control). The worker copies the caller's ``contextvars``
   context, so deadline scopes, tenant labels and scoped fault plans
   apply inside it, and runs on the caller's CUDA stream (see
   :class:`_Prefetcher`); each ingest runs under the ``ooc_prefetch``
   watchdog section.

2. **Async commit** (:class:`AsyncCommitter`): durable unit commits
   (spill-store writes, checkpoint completions, ordered ``sink(...)``
   calls) run on ONE FIFO writer thread while the next unit computes.
   Closures run strictly in submission order on one thread, so the
   manifest is never written concurrently and sink calls keep unit
   order; :meth:`AsyncCommitter.drain` blocks until every commit is
   durable, and a writer failure re-raises on the next ``submit`` or
   ``drain``.

Observability: spans ``ooc.prefetch`` (the worker's thread; inline at
depth 0), ``spill.write_async`` (the writer's), and the passes'
``ooc.compute``; counters ``ooc.prefetch_hits`` / ``ooc.prefetch_misses``,
``ooc.overlap_seconds`` (ingest seconds hidden behind compute) and
``plan.prefetch_bytes``.
"""

import contextlib
import contextvars
import os
import queue
import threading
import time
from typing import Iterable, Mapping

import torch

from cylon_tpu_torch import telemetry, watchdog
from cylon_tpu_torch.utils.tracing import span as _span

__all__ = [
    "prefetch_depth", "async_write_enabled", "prefetched",
    "prefetch_map", "AsyncCommitter", "committer", "sequential",
]

#: queue sentinel: source exhausted
_DONE = object()

#: context-local depth override (None = use the env knob). Installed
#: by :func:`sequential` on paths that must not grow their footprint —
#: the OOM-retry spill route runs under it, since doubling the
#: per-partition device tables is self-defeating right after the
#: allocator said no.
_DEPTH_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_pipeline_depth", default=None)


@contextlib.contextmanager
def sequential():
    """Force the fully-sequential pipeline (depth 0: no prefetch, no
    async writes) for the enclosed scope — contextvar-scoped, so
    concurrent callers are unaffected. Used by
    :func:`cylon_tpu_torch.fallback.run_with_fallback` around the retry that
    follows an IN-FLIGHT device OOM: lookahead there would hold two
    partitions' device tables in an allocator that just exhausted
    (the preflight-routed spill keeps the pipeline — its partitions
    are sized against free device memory with headroom)."""
    tok = _DEPTH_OVERRIDE.set(0)
    try:
        yield
    finally:
        _DEPTH_OVERRIDE.reset(tok)


def prefetch_depth() -> int:
    """Lookahead units the prefetch worker may run ahead of the
    consumer (``CYLON_TPU_OOC_PREFETCH_DEPTH``). Default 1 =
    double-buffering: unit k+1 ingests while k computes, and AT MOST
    depth+1 units are live at once (a slot semaphore counts mid-ingest
    work against the bound). Where the ingest stage builds DEVICE
    tables (ooc_join/ooc_sort per-partition ingest), that bound is
    device memory: depth 1 doubles the per-partition device footprint vs the
    sequential pass — under tight device memory set depth 0 (or raise
    ``n_partitions`` so 2 partitions fit where 1 did). 0 disables the
    pipeline entirely — prefetch AND async writes — restoring the
    sequential execution the overlap A/B uses as its control (the
    :func:`sequential` scope forces 0 context-locally)."""
    override = _DEPTH_OVERRIDE.get()
    if override is not None:
        return override
    try:
        d = int(os.environ.get("CYLON_TPU_OOC_PREFETCH_DEPTH", "1"))
    except ValueError:
        d = 1
    return max(d, 0)


def async_write_enabled() -> bool:
    """Async spill/checkpoint commits on? Exactly when prefetch is
    (:func:`prefetch_depth` > 0), so the depth-0 control arm and a
    :func:`sequential` scope are FULLY sequential."""
    return prefetch_depth() > 0


def _item_nbytes(item) -> int:
    """Host byte size of one ingested unit, for the
    ``plan.prefetch_bytes`` honesty counter (best effort — tuples from
    :func:`prefetch_map` count their array-bearing members)."""
    import numpy as np

    try:
        if isinstance(item, Mapping):
            return int(sum(np.asarray(v).nbytes for v in item.values()))
        if isinstance(item, tuple):
            return int(sum(_item_nbytes(x) for x in item))
        if isinstance(item, torch.Tensor):
            return item.numel() * item.element_size()
        cols = getattr(item, "columns", None)
        if isinstance(cols, dict):  # a device Table
            return int(sum(_item_nbytes(c.data)
                           + (_item_nbytes(c.validity)
                              if c.validity is not None else 0)
                           for c in cols.values()))
        return int(getattr(item, "nbytes", 0))
    except Exception:
        return 0


class _Prefetcher:
    """Bounded lookahead over an iterator on one daemon worker.

    The worker pulls AT MOST ``depth`` items ahead of the consumer —
    a slot semaphore is acquired BEFORE each pull and released when
    the consumer retrieves the item, so the live-unit bound (queued +
    mid-ingest, on top of the one the consumer holds) is exactly
    ``depth``, not depth+1: this matters when the ingested unit is
    DEVICE-resident (ooc_join/ooc_sort build device tables in the
    ingest stage — see their ``_ingest`` docstrings). Each pull runs
    under the ``ooc_prefetch`` watchdog section + an ``ooc.prefetch``
    span; items cross to the consumer through a queue as ``(item,
    ingest_seconds)``; exceptions (including a worker-side
    ``DeadlineExceeded``) cross the same queue and re-raise on the
    consumer. The worker runs on the consumer's current CUDA stream,
    captured at construction (a new thread's current stream is the
    default stream): the ingest's copies are ordered with the
    consumer's compute as in a sequential pass, so a tensor the worker
    made is never read before its copy landed and no block it frees
    can be handed out while the consumer's queued work still reads it.
    The host half of an ingest (the numpy slicing, the table assembly)
    is what overlaps the consumer's device work; the copies themselves
    do not overlap compute. ``close()`` abandons the worker: the stop flag is
    polled at every slot wait and queue put, and an active ambient
    deadline bounds the pull itself via the watched section — a
    worker stuck INSIDE a hung source pull cannot be interrupted
    (daemon thread, the same abandon contract as
    ``watchdog.bounded``) but exits at the first poll point after the
    pull returns and never delivers past the close."""

    def __init__(self, it, depth: int, op: str):
        self._it = iter(it)
        self._op = op
        self._q: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(max(depth, 1))
        self._stop = threading.Event()
        self._stream = watchdog._caller_stream()
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=ctx.run, args=(self._run,),
            name=f"cylon-ooc-prefetch-{op}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        if self._stream is None:
            self._loop()
            return
        with torch.cuda.stream(self._stream):
            self._loop()

    def _put(self, payload) -> bool:
        if self._stop.is_set():
            return False
        self._q.put(payload)  # unbounded put: the semaphore is the cap
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            # take a lookahead slot BEFORE pulling: at most `depth`
            # units exist beyond the one the consumer holds
            if not self._slots.acquire(timeout=0.05):
                continue
            t0 = time.perf_counter()
            try:
                with watchdog.watched_section("ooc_prefetch",
                                              detail=self._op):
                    with _span("ooc.prefetch", cat="stage", op=self._op):
                        item = next(self._it)
            except StopIteration:
                self._put((_DONE, None, 0.0))
                return
            except BaseException as e:  # re-raised on the consumer
                self._put((None, e, 0.0))
                return
            telemetry.counter("plan.prefetch_bytes").inc(
                _item_nbytes(item))
            if not self._put((item, None, time.perf_counter() - t0)):
                return  # abandoned mid-pass: drop the lookahead

    def get(self):
        """Next ``(item, ingest_seconds, waited_seconds, hit)`` —
        raises ``StopIteration`` at the end, or the worker's error."""
        waited = 0.0
        try:
            payload = self._q.get_nowait()
            hit = True
        except queue.Empty:
            hit = False
            t0 = time.perf_counter()
            while True:
                # cooperative deadline checkpoint while starved: the
                # consumer must not out-wait its own pass budget just
                # because the worker is stuck in a slow source
                watchdog.check(detail=f"prefetch wait [{self._op}]")
                try:
                    payload = self._q.get(timeout=0.05)
                    break
                except queue.Empty:
                    continue
            waited = time.perf_counter() - t0
        item, err, dur = payload
        if err is not None:
            raise err
        if item is _DONE:
            raise StopIteration
        # the consumer now owns this unit: free its lookahead slot
        self._slots.release()
        return item, dur, waited, hit

    def close(self) -> None:
        # the worker polls the flag at every slot wait / put, and an
        # ambient deadline bounds the pull via the watched section; a
        # pull hung in an uninterruptible source leaves an abandoned
        # daemon (the watchdog.bounded contract) that can never
        # deliver, which is why join() takes a timeout
        self._stop.set()
        self._thread.join(timeout=5.0)


def prefetched(it: Iterable, *, op: str = "ooc",
               depth: "int | None" = None):
    """Iterate ``it`` with bounded lookahead on a prefetch worker.

    THE shared ingest funnel for every out-of-core pass: yields ``it``'s items in order while the worker
    pulls up to ``depth`` items ahead (default
    :func:`prefetch_depth`). ``depth <= 0`` iterates inline —
    sequential, thread-free — but still wraps each pull in the
    ``ooc.prefetch`` span so A/B trace timelines stay comparable.
    Counts ``ooc.prefetch_hits`` / ``ooc.prefetch_misses`` and
    accumulates ``ooc.overlap_seconds`` (ingest time hidden behind the
    consumer's compute: full ingest duration on a hit, the already-
    elapsed portion on a miss)."""
    depth = prefetch_depth() if depth is None else int(depth)
    if depth <= 0:
        src = iter(it)
        while True:
            with _span("ooc.prefetch", cat="stage", op=op):
                try:
                    item = next(src)
                except StopIteration:
                    return
            telemetry.counter("plan.prefetch_bytes").inc(
                _item_nbytes(item))
            yield item
    pf = _Prefetcher(it, depth, op)
    try:
        while True:
            try:
                item, dur, waited, hit = pf.get()
            except StopIteration:
                return
            if hit:
                telemetry.counter("ooc.prefetch_hits", op=op).inc()
                hidden = dur
            else:
                telemetry.counter("ooc.prefetch_misses", op=op).inc()
                hidden = max(dur - waited, 0.0)
            if hidden >= 1e-3:  # sub-ms "overlap" is scheduler noise
                telemetry.counter("ooc.overlap_seconds",
                                  op=op).inc(float(hidden))
            yield item
    finally:
        pf.close()


def prefetch_map(items: Iterable, fn, *, op: str = "ooc",
                 depth: "int | None" = None):
    """Yield ``(item, fn(item))`` in order, running ``fn(item_{k+1})``
    on the prefetch worker while the consumer processes item k — the
    per-unit ingest stage of a pipelined pass (``fn`` builds the
    device tables / host slices for one partition). Same depth, span,
    counter and deadline semantics as :func:`prefetched`."""
    return prefetched(((item, fn(item)) for item in items),
                      op=op, depth=depth)


class AsyncCommitter:
    """One FIFO writer thread for durable unit commits.

    ``submit(fn)`` enqueues a zero-arg closure — a
    ``CheckpointedRun.complete`` + ordered ``sink`` call, typically —
    that the writer runs strictly in submission order under a
    ``spill.write_async`` span, overlapping the caller's next unit of
    compute. When async writes are disabled
    (:func:`async_write_enabled`) ``submit`` runs the closure inline
    and no thread ever starts — byte-for-byte the sequential
    behaviour. ``drain()`` blocks until every pending commit is
    durable (THE manifest-flush barrier: a pass may only return/merge
    after it) and re-raises the first writer failure; a recorded
    failure also re-raises on the next ``submit`` so a dead spill
    store aborts the pass promptly. After a failure the writer drains
    remaining closures WITHOUT running them — producers never block on
    a dead writer, and no unit is recorded out of order past the
    failure point."""

    def __init__(self, op: str = "ooc", depth: int = 2):
        self.op = op
        self._enabled = async_write_enabled()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: "BaseException | None" = None
        self._err_raised = False
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # overlap accounting: commit seconds spent on the writer thread
        # minus consumer seconds spent BLOCKED on it (a full queue in
        # submit, the drain barrier) = write time genuinely hidden
        # behind compute; folded into ooc.overlap_seconds at drain
        self._busy_s = 0.0
        self._blocked_s = 0.0

    def _ensure_thread(self) -> None:
        if self._thread is None:
            ctx = contextvars.copy_context()
            self._thread = threading.Thread(
                target=ctx.run, args=(self._loop,),
                name=f"cylon-ooc-writer-{self.op}", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                fn = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                if fn is _DONE:
                    return
                # stop set = the pass bailed without draining (a body
                # exception): DISCARD queued commits rather than race
                # them against the caller's exception handling — under
                # the old sequential code nothing past the raise ever
                # ran, and a discarded unit just recomputes on resume
                if self._err is None and not self._stop.is_set():
                    t0 = time.perf_counter()
                    with _span("spill.write_async", cat="stage",
                               op=self.op):
                        fn()
                    self._busy_s += time.perf_counter() - t0
            except BaseException as e:
                self._err = e
            finally:
                self._q.task_done()

    def _check_err(self) -> None:
        # sticky: once a commit failed, EVERY later submit/drain raises
        # and the writer refuses all queued closures — no unit is ever
        # recorded (and no sink is ever called) past the failure point
        if self._err is not None:
            self._err_raised = True  # surfaced: close() need not log
            raise self._err

    def submit(self, fn) -> None:
        """Queue one durable commit (runs inline when async writes are
        off). Raises any failure a PREVIOUS commit recorded."""
        self._check_err()
        if not self._enabled:
            fn()
            return
        self._ensure_thread()
        t0 = time.perf_counter()
        self._q.put(fn)
        self._blocked_s += time.perf_counter() - t0

    def drain(self) -> None:
        """Block until every submitted commit is durably complete —
        the barrier between a pass's last unit and its return/merge —
        then re-raise the first writer failure, if any."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._q.join()
            self._blocked_s += time.perf_counter() - t0
            hidden = max(self._busy_s - self._blocked_s, 0.0)
            if hidden >= 1e-3:  # sub-ms "overlap" is scheduler noise
                telemetry.counter("ooc.overlap_seconds",
                                  op=self.op).inc(float(hidden))
            self._busy_s = self._blocked_s = 0.0
        self._check_err()

    def close(self) -> None:
        """Stop the writer. The in-flight commit finishes (it cannot
        be interrupted mid-fsync); commits still QUEUED are discarded
        — on the clean path :func:`committer` drains first so nothing
        is queued here, and on the exception path discarding matches
        the sequential semantics (nothing past the raise ever ran; the
        units recompute on resume). A swallowed writer error is logged
        (close runs in ``finally`` and must not mask the body's
        exception)."""
        if self._thread is not None:
            self._stop.set()
            try:
                self._q.put_nowait(_DONE)
            except queue.Full:
                pass
            self._thread.join(timeout=10.0)
            if self._err is not None and not self._err_raised:
                # genuinely swallowed (the pass bailed before any
                # submit/drain could surface it) — log it; a failure
                # already raised to the caller must not double-report
                # as a second, phantom data-loss incident
                from cylon_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    "async committer [%s] closed with an unraised "
                    "commit failure (%s: %s) — the failed unit was "
                    "not recorded and will recompute on resume",
                    self.op, type(self._err).__name__, self._err)


@contextlib.contextmanager
def committer(op: str = "ooc", depth: int = 2):
    """``with pipeline.committer("sort") as com: ... com.submit(...)``
    — drains on clean exit (the manifest-flush barrier), stops the
    writer on any exit. On a body exception the in-flight commit
    finishes (an fsync cannot be interrupted) but commits still QUEUED
    are DISCARDED, not run: under the old sequential code nothing past
    the raise ever executed, and racing queued sink calls against the
    caller's exception handling would break that contract — the
    discarded units simply recompute on resume
    (``tests/test_pipeline.py`` pins this)."""
    com = AsyncCommitter(op=op, depth=depth)
    try:
        yield com
        com.drain()
    finally:
        com.close()
