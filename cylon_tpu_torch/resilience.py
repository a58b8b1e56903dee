"""Resilience layer: fault injection, retry/backoff, loss accounting.

Port of ``cylon_tpu/resilience.py`` (host code, copied with its imports
pointed at the port). The reference threads ``cylon::Status{code, msg}``
through every call (``cpp/src/cylon/status.hpp``) but has no recovery
story: a failed rank fails the job. This layer adds what a long pass
needs:

1. **Deterministic fault injection** (:class:`FaultPlan`): named
   injection points threaded through the spill store, chunk sources, IO
   readers, the exchanges, the process-group bootstrap and the query
   dispatch. A plan raises a configured error on the Nth hit of a point
   (or from a seeded RNG), sleeps there (:meth:`FaultRule.hang`) or ends
   the process (:meth:`FaultRule.kill`); ``reset()`` replays the same
   schedule.

2. **Retry/backoff** (:func:`retrying`): exponential backoff with
   deterministic jitter (:class:`cylon_tpu_torch.config.RetryPolicy`),
   driven by :func:`is_retryable` over ``errors.Code``:
   ``Code.Unavailable`` / :class:`~cylon_tpu_torch.errors.TransientError`
   retry, everything else raises at once. A CUDA out-of-memory error is
   not retryable here; :mod:`cylon_tpu_torch.fallback` routes it to the
   spill path.

3. **Loss accounting** (:class:`RowAccount`): multi-pass pipelines and
   the row-preserving exchanges count rows in against rows out and raise
   :class:`~cylon_tpu_torch.errors.DataLossError` on a mismatch.

:class:`SpillStore` and :class:`CheckpointedRun` round the layer out: a
directory-backed unit spill with a fingerprinted completion manifest
written atomically (tmp + fsync + rename), so a pass killed at any
instant, ``os._exit`` included, resumes at the first incomplete unit and
produces output byte-identical to a fault-free run (every
:mod:`cylon_tpu_torch.outofcore` pass takes ``resume_dir=``).

Nothing here waits on a device.
"""

import contextlib
import contextvars
import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time

import numpy as np

from cylon_tpu_torch import config as _config
from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import (Code, CylonError, DataLossError,
                                    DeadlineExceeded, InvalidArgument,
                                    TransientError)
from cylon_tpu_torch.telemetry import trace as _trace

__all__ = [
    "INJECTION_POINTS", "KILL_EXIT_CODE", "FaultRule", "FaultPlan",
    "install", "active", "scoped", "active_plan", "inject",
    "is_retryable", "default_policy", "backoff_delays", "retrying",
    "RowAccount", "check_conservation",
    "atomic_write_json", "SpillStore", "CheckpointedRun",
    "fingerprint_arrays",
]

#: exit status of a hard-kill FaultRule firing (``FaultRule.kill``) —
#: distinct from every status the interpreter or pytest uses, so a
#: chaos driver can assert "the child died AT the seeded fault point"
#: rather than "the child died".
KILL_EXIT_CODE = 43

#: Named places the engine agrees to fail on demand. Each maps to a real
#: failure domain: ``spill_write``/``spill_read`` — the out-of-core
#: spill store; ``chunk_source`` — every chunk an out-of-core pass pulls
#: (``outofcore._as_chunks``); ``io_read`` — the CSV/Parquet readers;
#: ``exchange`` — the mesh shuffle dispatch; ``worker`` — worker
#: preemption (exercised by the multihost bootstrap); ``plan`` — the
#: compiled-query dispatch (``plan.CompiledQuery.__call__`` and the
#: fallback executor's in-core attempt), where a seeded
#: ``MemoryError`` is the deterministic twin of a device
#: RESOURCE_EXHAUSTED — the injection the OOM→spill fallback tests
#: drive; ``global_merge`` — the two-phase fallback executor's global
#: merge step (``fallback._two_phase``), the blocking scalar
#: computation between the partial pass and the apply pass, so chaos
#: harnesses can kill a run exactly at the phase boundary.
INJECTION_POINTS = ("spill_write", "spill_read", "chunk_source",
                    "io_read", "exchange", "worker", "plan",
                    "global_merge")


# ------------------------------------------------------------ fault plans
@dataclasses.dataclass
class FaultRule:
    """One configured failure. Counting rules (the default) fire on hits
    ``nth .. nth + times - 1`` of ``point`` (``times <= 0`` = every hit
    from ``nth`` on — a permanently-dead resource). ``prob > 0`` fires
    probabilistically instead, drawing from the plan's seeded RNG so a
    ``reset()`` replays the identical schedule. ``error`` is the
    exception instance (or class) to raise; default is a
    :class:`~cylon_tpu_torch.errors.TransientError` describing the hit —
    i.e. a simulated preemption the retry engine may absorb.

    ``delay > 0`` is **delay mode**: a firing hit SLEEPS ``delay``
    seconds at the fault point instead of raising (pass ``error`` too
    for a slow *failing* call) — the deterministic way to inject a
    hang, since a hang never raises and only the watchdog layer
    (:mod:`cylon_tpu_torch.watchdog`) can see it. Which hits fire follows
    the same counting/seeded-prob schedule as raising rules, so delay
    schedules replay exactly too. :meth:`hang` is the documented
    alias for an effectively-unbounded delay.

    ``exit_code`` (non-None) is **kill mode**: a firing hit
    ``os._exit``\\ s the whole process at the fault point — no
    exception, no ``finally`` blocks, no atexit flushes. This is the
    injectable twin of a preemption or an OOM kill, the failure class
    retries cannot absorb and only a checkpoint/resume layer
    (:class:`CheckpointedRun`) survives.
    :meth:`kill` is the documented constructor (fixed
    :data:`KILL_EXIT_CODE` so chaos drivers can assert the death was
    the seeded one)."""

    point: str
    nth: int = 1
    times: int = 1
    error: "Exception | type | None" = None
    prob: float = 0.0
    delay: float = 0.0
    exit_code: "int | None" = None

    @classmethod
    def hang(cls, point: str, seconds: float = 3600.0,
             **kw) -> "FaultRule":
        """A rule that HANGS at ``point`` (sleeps ``seconds``, default
        an hour — far past any sane deadline) instead of raising: the
        injectable twin of a wedged peer or dead mount, detectable
        only by ``watchdog.deadline`` bounds."""
        return cls(point, delay=float(seconds), **kw)

    @classmethod
    def kill(cls, point: str, nth: int = 1, **kw) -> "FaultRule":
        """A rule that HARD-KILLS the process (``os._exit``, status
        :data:`KILL_EXIT_CODE`) on hit ``nth`` of ``point`` — the
        chaos-harness preemption. Nothing downstream of the fault
        point runs: no cleanup, no manifest flush beyond what is
        already durable, which is exactly the window checkpoint/resume
        must survive."""
        return cls(point, nth=nth, exit_code=KILL_EXIT_CODE, **kw)


class FaultPlan:
    """A deterministic, replayable failure schedule.

    Register process-wide with :func:`install` / :func:`active`, or on a
    :class:`~cylon_tpu_torch.context.CylonEnv` via ``env.set_fault_plan`` for
    the mesh-op points. ``fired`` records every (point, hit#, detail)
    that raised; ``reset()`` rewinds counters AND the RNG, so driving
    the same workload twice produces the same ``fired`` log — the
    replay-determinism contract the tests pin down.
    """

    def __init__(self, rules=(), seed: int = 0):
        self.rules = [r if isinstance(r, FaultRule) else FaultRule(**r)
                      for r in rules]
        for r in self.rules:
            if r.point not in INJECTION_POINTS:
                raise InvalidArgument(
                    f"unknown injection point {r.point!r}; valid: "
                    f"{INJECTION_POINTS}")
            if r.prob == 0.0 and r.nth < 1:
                raise InvalidArgument(f"nth must be >= 1, got {r.nth}")
            if not 0.0 <= r.prob <= 1.0:
                raise InvalidArgument(f"prob {r.prob} not in [0, 1]")
            if r.delay < 0:
                raise InvalidArgument(
                    f"delay must be >= 0, got {r.delay}")
            if r.exit_code is not None and not 0 <= r.exit_code <= 255:
                raise InvalidArgument(
                    f"exit_code must be in [0, 255], got {r.exit_code}")
        self.seed = seed
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> "FaultPlan":
        """Rewind hit counters and the RNG: the next run replays the
        exact same failure schedule."""
        with self._lock:
            self._hits = {p: 0 for p in INJECTION_POINTS}
            self._rng = np.random.default_rng(self.seed)
            self._fired: list[tuple] = []
        return self

    @property
    def fired(self) -> list:
        """Log of every firing: (point, hit number, detail)."""
        return list(self._fired)

    def hits(self, point: str) -> int:
        return self._hits[point]

    def check(self, point: str, detail: str = "") -> None:
        """Record one hit of ``point``; raise — or, for delay-mode
        rules, sleep — if any rule fires (first matching rule wins)."""
        with self._lock:
            self._hits[point] += 1
            k = self._hits[point]
            hit = None
            for r in self.rules:
                if r.point != point:
                    continue
                if r.prob > 0.0:
                    # draw EVERY hit (not only when firing) so the
                    # stream position — and therefore the schedule —
                    # depends only on the hit sequence
                    fire = bool(self._rng.random() < r.prob)
                else:
                    hi = None if r.times <= 0 else r.nth + r.times - 1
                    fire = k >= r.nth and (hi is None or k <= hi)
                if fire and hit is None:
                    self._fired.append((point, k, detail))
                    hit = r
        if hit is None:
            return
        # tenant label: under the serve layer's ambient tenant scope
        # the firing is attributed to the tenant whose query stream hit
        # it — the "unpolluted metrics" half of fault isolation
        telemetry.counter("resilience.faults_injected", point=point,
                          **telemetry.tenant_labels()).inc()
        _trace.instant("resilience.fault", cat="resilience",
                       point=point, hit=k, detail=detail,
                       delay=hit.delay)
        if hit.delay > 0:
            # injected hang: sleep OUTSIDE the plan lock so other
            # threads' injection points stay live while this one stalls
            time.sleep(hit.delay)
        if hit.exit_code is not None:
            # kill mode: die RIGHT HERE, like a preemption would — no
            # exception propagation, no finally blocks. One stderr
            # line first so a chaos run's death site is diagnosable.
            import sys

            print(f"cylon_tpu_torch.resilience: injected HARD KILL at "
                  f"{point!r} (hit {k}, exit {hit.exit_code})",
                  file=sys.stderr, flush=True)
            os._exit(hit.exit_code)
        err = hit.error() if isinstance(hit.error, type) else hit.error
        if err is None and hit.delay == 0:
            err = TransientError(
                f"injected fault at {point!r} (hit {k}"
                + (f": {detail}" if detail else "") + ")")
        if err is not None:
            raise err


_LOCK = threading.Lock()
_ACTIVE: "FaultPlan | None" = None

#: monotonic suffix for per-attempt spill tmp files (see
#: SpillStore.write_bucket — concurrent attempts must never share one)
_TMP_SEQ = itertools.count()


def install(plan: "FaultPlan | None") -> "FaultPlan | None":
    """Set the process-wide active plan (None clears). Returns the
    previous plan so callers can restore it."""
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, plan
    return prev


def active_plan() -> "FaultPlan | None":
    return _ACTIVE


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with resilience.active(plan): ...`` — scoped installation of
    the PROCESS-WIDE plan (every thread sees it; the chaos-drill
    shape). For a plan that must only apply to the current execution
    context — one serve request among concurrent workloads — use
    :func:`scoped`."""
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)


#: context-local fault-plan overlay: visible only to the installing
#: context (and workers spawned with ``copy_context`` — the request's
#: own bounded calls), NEVER to unrelated threads. The serving layer
#: installs per-request plans here so one tenant's injected faults
#: cannot leak into another workload running concurrently in the
#: process.
_SCOPED_PLAN: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_fault_plan", default=None)


@contextlib.contextmanager
def scoped(plan: "FaultPlan | None"):
    """``with resilience.scoped(plan): ...`` — context-local
    installation (contextvar, not the process global): injection
    points consult it only from this context, after any env-registered
    plan and before the process-wide one."""
    tok = _SCOPED_PLAN.set(plan)
    try:
        yield plan
    finally:
        _SCOPED_PLAN.reset(tok)


def inject(point: str, detail: str = "", env=None) -> None:
    """Instrumentation hook: a no-op unless a plan is active.
    Precedence: a plan registered on the op's CylonEnv, then the
    context-local :func:`scoped` plan, then the process-wide
    :func:`install`/:func:`active` plan."""
    if point not in _POINT_SET:
        raise InvalidArgument(f"unknown injection point {point!r}")
    plan = getattr(env, "_fault_plan", None) if env is not None else None
    if plan is None:
        plan = _SCOPED_PLAN.get()
    plan = plan if plan is not None else _ACTIVE
    if plan is not None:
        plan.check(point, detail)


_POINT_SET = frozenset(INJECTION_POINTS)


# ---------------------------------------------------------- retry engine
#: codes whose failures are worth re-attempting; everything else is
#: deterministic (bad input, capacity, real data loss) and re-raises
_RETRYABLE_CODES = frozenset({Code.Unavailable})
#: transient OS-level failures (tunneled/remote IO); NOT FileNotFoundError
#: etc. — a missing file does not appear on retry
_RETRYABLE_OS = (ConnectionError, TimeoutError, InterruptedError)


def is_retryable(exc: BaseException) -> bool:
    """Classification over ``errors.Code``: TransientError and any
    CylonError carrying ``Code.Unavailable`` retry; other CylonErrors
    never do; transient OS errors (connection/timeout/EINTR) retry.
    DeadlineExceeded defers to its per-section flag
    (``watchdog.SECTIONS``): bootstrap/spill-IO deadlines retry, a
    deadline mid-collective never does — the mesh state is
    unrecoverable."""
    if isinstance(exc, DeadlineExceeded):
        return bool(getattr(exc, "retryable", False))
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, CylonError):
        return exc.code in _RETRYABLE_CODES
    return isinstance(exc, _RETRYABLE_OS)


def default_policy() -> "_config.RetryPolicy":
    """The process default :class:`~cylon_tpu_torch.config.RetryPolicy`:
    the struct's defaults (the JAX package's ``CYLON_TPU_RETRY_*``
    overrides are not read; pass a policy to change them)."""
    return _config.RetryPolicy()


def backoff_delays(policy: "_config.RetryPolicy"):
    """Infinite generator of backoff delays for ``policy``:
    ``min(base * multiplier**k, max_delay)`` with deterministic +-jitter
    drawn from ``policy.seed`` — the same policy always yields the same
    sequence (exposed for tests and for reasoning about worst cases)."""
    rng = np.random.default_rng(policy.seed)
    d = float(policy.base_delay)
    while True:
        j = 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
        yield min(d, policy.max_delay) * j
        d = min(d * policy.multiplier, policy.max_delay)


def retrying(fn, policy: "_config.RetryPolicy | None" = None, *,
             retry_on=None, sleep_fn=None, label: str | None = None):
    """Call ``fn()`` with retry/backoff; return its result.

    Retries only failures ``retry_on`` (default :func:`is_retryable`)
    classifies as transient, up to ``policy.max_attempts`` total
    attempts, sleeping a :func:`backoff_delays` step between attempts
    (``sleep_fn`` overrides ``time.sleep`` — tests pass a recorder).
    The final failure re-raises the original exception unchanged."""
    policy = policy or default_policy()
    classify = retry_on or is_retryable
    sleep = time.sleep if sleep_fn is None else sleep_fn
    delays = backoff_delays(policy)
    attempts = max(int(policy.max_attempts), 1)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= attempts or not classify(e):
                raise
            d = next(delays)
            code = getattr(getattr(e, "code", None), "name", None) \
                or type(e).__name__
            telemetry.counter("resilience.retries", code=code,
                              **telemetry.tenant_labels()).inc()
            _trace.instant("resilience.retry", cat="resilience",
                           code=code, attempt=attempt,
                           label=label or "", backoff_s=d)
            from cylon_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "%sattempt %d/%d failed (%s: %s); retrying in %.3fs",
                f"{label}: " if label else "", attempt, attempts,
                type(e).__name__, e, d)
            sleep(d)


# ------------------------------------------------------- loss accounting
class RowAccount:
    """Rows-in vs rows-out invariant for a multi-pass pipeline."""

    def __init__(self, label: str):
        self.label = label
        self.rows_in = 0
        self.rows_out = 0

    def add_in(self, n) -> "RowAccount":
        self.rows_in += int(n)
        return self

    def add_out(self, n) -> "RowAccount":
        self.rows_out += int(n)
        return self

    def verify(self, what: str = "rows") -> None:
        if self.rows_in != self.rows_out:
            raise DataLossError(
                f"{self.label}: {self.rows_in} {what} in vs "
                f"{self.rows_out} out — data was silently dropped or "
                "duplicated")


def check_conservation(label: str, rows_in, rows_out,
                       what: str = "rows") -> None:
    """One-shot :class:`RowAccount`."""
    RowAccount(label).add_in(rows_in).add_out(rows_out).verify(what)


# ----------------------------------------------------------- spill store
def atomic_write_json(path: str, obj) -> None:
    """Crash-safe JSON write: unique tmp + ``flush`` + ``fsync`` +
    ``os.replace``. At EVERY instant the target path holds either the
    previous complete document or the new complete document — a hard
    kill (``os._exit``, SIGKILL, power loss) mid-write can only strand
    a tmp file, never a torn target. This is the ONE write primitive
    every manifest/journal/sentinel site uses (the atomicity audit in
    ``tests/test_torch_resilience.py`` pins the fsync-before-replace order)."""
    tmp = (f"{path}.tmp{os.getpid()}_"
           f"{threading.get_ident()}_{next(_TMP_SEQ)}")
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class SpillStore:
    """Directory-backed bucket spill with a completion manifest.

    One ``bucket<p>.npz`` per completed range/partition plus
    ``manifest.json`` recording ``{bucket: rows}`` — updated atomically
    (tmp + rename) AFTER the bucket's data is durably written, so a kill
    at any instant leaves either a complete, recorded bucket or nothing.
    A ``fingerprint`` (hash of the pass's keys/splitters) guards reuse:
    a store opened with a different fingerprint discards stale state
    instead of resuming against the wrong plan.

    Writes and reads run under :func:`retrying` and hit the
    ``spill_write`` / ``spill_read`` injection points — this is the
    "out-of-core spill store" the retry engine wraps. Each attempt is
    additionally bounded by the ``spill_io`` watchdog section
    (:func:`cylon_tpu_torch.watchdog.bounded`): under a deadline, a hung
    mount raises a *retryable* DeadlineExceeded, so the retry engine
    absorbs IO hangs exactly like raised IO errors.
    """

    MANIFEST = "manifest.json"

    def __init__(self, root: str, fingerprint: str = "",
                 policy: "_config.RetryPolicy | None" = None):
        self.root = str(root)
        self._policy = policy or default_policy()
        os.makedirs(self.root, exist_ok=True)
        self._mpath = os.path.join(self.root, self.MANIFEST)
        m = self._load_manifest()
        if m is None or m.get("fingerprint") != fingerprint:
            # discard stale state — but ONLY files this store's naming
            # scheme owns (bucketNNNNN.npz + manifest); a resume_dir
            # accidentally pointed at a directory of unrelated .npz
            # data must never be wiped
            import re

            own = re.compile(r"^bucket\d{5}\.npz(\.tmp\S*)?$")
            for f in os.listdir(self.root):
                if own.match(f) or f == self.MANIFEST \
                        or f.startswith(self.MANIFEST + ".tmp"):
                    os.unlink(os.path.join(self.root, f))
            m = {"fingerprint": fingerprint, "completed": {}}
            self._write_manifest(m)
        self._m = m

    def _load_manifest(self):
        try:
            with open(self._mpath) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_manifest(self, m) -> None:
        atomic_write_json(self._mpath, m)

    def _bucket_path(self, p: int) -> str:
        return os.path.join(self.root, f"bucket{int(p):05d}.npz")

    @property
    def completed(self) -> dict:
        """{bucket index: rows} for every durably completed bucket."""
        return {int(k): int(v) for k, v in self._m["completed"].items()}

    def completed_rows(self, p: int) -> "int | None":
        v = self._m["completed"].get(str(int(p)))
        return None if v is None else int(v)

    def bucket_meta(self, p: int) -> "dict | None":
        """Per-unit metadata recorded at completion (e.g. the input
        sizes a resumed ``ooc_join`` partition must re-verify)."""
        return self._m.get("meta", {}).get(str(int(p)))

    def write_bucket(self, p: int, cols: dict, rows: int,
                     meta: "dict | None" = None) -> None:
        """Durably spill one bucket's columns, then record completion
        (plus optional ``meta``, kept in the manifest next to the row
        count). Empty buckets record 0 rows with no file."""
        path = self._bucket_path(p)

        def _write():
            inject("spill_write", f"bucket {p}")
            # per-attempt unique tmp: a deadline-abandoned worker may
            # still be writing ITS tmp when the retry starts — a shared
            # name would interleave two writers in one inode and
            # os.replace could install the torn file as a "completed"
            # bucket. Distinct inodes + atomic replace keep whichever
            # rename lands last a complete, valid write; the fsync
            # means the bytes are durable BEFORE the rename can make
            # the manifest point at them.
            tmp = (f"{path}.tmp{os.getpid()}_"
                   f"{threading.get_ident()}_{next(_TMP_SEQ)}")
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **cols)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        if rows:
            from cylon_tpu_torch import watchdog

            with telemetry.timer("spill.write_seconds").time(), \
                    _trace.span("spill.write", cat="spill", bucket=p):
                retrying(lambda: watchdog.bounded(
                    _write, "spill_io", detail=f"write bucket {p}"),
                    self._policy, label=f"spill_write[{p}]")
            nb = int(sum(np.asarray(v).nbytes for v in cols.values()))
            telemetry.counter("spill.write_bytes").inc(nb)
            telemetry.counter("spill.write_buckets").inc()
            _trace.instant("spill.write", cat="spill", bucket=p,
                           bytes=nb, rows=int(rows))
        self._m["completed"][str(int(p))] = int(rows)
        if meta is not None:
            self._m.setdefault("meta", {})[str(int(p))] = dict(meta)
        self._write_manifest(self._m)

    def read_bucket(self, p: int) -> dict:
        """Reload a completed bucket's columns (insertion order kept)."""
        path = self._bucket_path(p)

        def _read():
            inject("spill_read", f"bucket {p}")
            with np.load(path, allow_pickle=True) as z:
                return {k: z[k] for k in z.files}

        from cylon_tpu_torch import watchdog

        with telemetry.timer("spill.read_seconds").time(), \
                _trace.span("spill.read", cat="spill", bucket=p):
            out = retrying(lambda: watchdog.bounded(
                _read, "spill_io", detail=f"read bucket {p}"),
                self._policy, label=f"spill_read[{p}]")
        nb = int(sum(a.nbytes for a in out.values()))
        telemetry.counter("spill.read_bytes").inc(nb)
        telemetry.counter("spill.read_buckets").inc()
        _trace.instant("spill.read", cat="spill", bucket=p, bytes=nb)
        return out


class CheckpointedRun:
    """Generic checkpoint/resume for a multi-unit pass.

    Factors the resumable-manifest machinery ``ooc_sort`` pioneered
    into the reusable shape every long pass threads through
    (``ooc_join``/``ooc_groupby`` partitions and chunks): a run is identified by a **fingerprint** —
    ``op`` plus the partitioning *plan* (keys, splitters, partition
    counts, transform identity…) — and made of numbered **units**,
    each completed atomically (data durable + fsynced BEFORE the
    manifest records it, via :class:`SpillStore`). The guarantees:

    * a process hard-killed at ANY instant leaves every recorded unit
      complete and valid — a re-invocation with the same arguments
      replays recorded units byte-identically and recomputes only the
      rest, so the final output equals a fault-free run's;
    * a directory whose fingerprint does not match (different op,
      keys, plan, data-derived splitters) is DISCARDED, never resumed
      against the wrong plan;
    * per-unit ``meta`` recorded at completion lets the resuming run
      re-verify source stability (e.g. partition input sizes) and
      raise :class:`~cylon_tpu_torch.errors.DataLossError` instead of
      silently mixing two generations of the source.

    Every resumed unit counts ``ooc.units_resumed{op=}``.
    """

    def __init__(self, root: str, op: str, plan=(),
                 policy: "_config.RetryPolicy | None" = None):
        self.op = str(op)
        self.fingerprint = fingerprint_arrays(self.op, *plan)
        self.store = SpillStore(root, fingerprint=self.fingerprint,
                                policy=policy)

    @property
    def completed(self) -> dict:
        """{unit: rows} for every durably completed unit."""
        return self.store.completed

    def completed_rows(self, unit: int) -> "int | None":
        """Recorded row count of ``unit`` (None = not completed)."""
        return self.store.completed_rows(unit)

    def unit_meta(self, unit: int) -> "dict | None":
        return self.store.bucket_meta(unit)

    def complete(self, unit: int, cols: dict, rows: int,
                 meta: "dict | None" = None) -> None:
        """Durably record ``unit`` done: columns spilled + fsynced,
        then the manifest updated atomically — a kill between the two
        just recomputes the unit."""
        self.store.write_bucket(unit, cols, int(rows), meta=meta)

    def note_resumed(self, unit: int) -> None:
        """Count a completed unit as resumed (no IO) — the metrics
        half of :meth:`resume_unit`, for callers that skip the data
        (count-only runs with no sink)."""
        telemetry.counter("ooc.units_resumed", op=self.op).inc()
        _trace.instant("ckpt.resume", cat="resilience", op=self.op,
                       unit=int(unit))
        telemetry.events.emit("checkpoint_resume", op=self.op,
                              unit=int(unit))

    def load_unit(self, unit: int) -> dict:
        """A completed unit's columns from the durable spill ({} for
        0-row units) — no counting; pair with :meth:`note_resumed`."""
        rows = self.store.completed_rows(unit)
        return self.store.read_bucket(unit) if rows else {}

    def resume_unit(self, unit: int) -> dict:
        """Replay a completed unit's columns from the durable spill
        ({} for 0-row units) and count it as resumed."""
        self.note_resumed(unit)
        return self.load_unit(unit)

    def verify_meta(self, unit: int, label: str, **expect) -> None:
        """Raise :class:`~cylon_tpu_torch.errors.DataLossError` if ``unit``'s
        recorded meta disagrees with the re-derived values — the
        source changed since the manifest was written."""
        meta = self.unit_meta(unit) or {}
        bad = {k: (meta.get(k), v) for k, v in expect.items()
               if meta.get(k) != v}
        if bad:
            raise DataLossError(
                f"{label}: resume manifest for unit {unit} recorded "
                f"{ {k: got for k, (got, _) in bad.items()} } but the "
                f"re-derived source has "
                f"{ {k: want for k, (_, want) in bad.items()} } — the "
                "source changed since the checkpoint was written; "
                "clear the resume_dir")


def fingerprint_arrays(*parts) -> str:
    """Stable hex digest of heterogeneous plan state (key names, ints,
    numpy scalars/arrays) — the spill-store reuse guard."""
    h = hashlib.sha256()
    for part in parts:
        if isinstance(part, (list, tuple)):
            h.update(fingerprint_arrays(*part).encode())
        elif isinstance(part, np.ndarray) or isinstance(part, np.generic):
            a = np.asarray(part)
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(part).encode())
        h.update(b"|")
    return h.hexdigest()
