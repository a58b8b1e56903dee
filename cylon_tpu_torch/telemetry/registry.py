"""The metric registry: typed instruments with label support.

The reference scatters ``std::chrono`` timings and glog lines at op
boundaries (shuffle timings ``table.cpp:167-177``, per-rank ``j_t``/
``w_t`` in the bench binaries) — no counters, no aggregation, no
export. This registry is the single process-local source of truth the
rebuild's three ad-hoc registries (tracing spans, watchdog section
timings, bench dicts) fold into:

- :class:`Counter` — monotonically increasing value (bytes moved,
  retries fired, overflow events).
- :class:`Gauge` — last-written value (pad ratio of the most recent
  exchange, current scale).
- :class:`Histogram` — fixed log-spaced (power-of-2) buckets shared by
  EVERY histogram in the process, so merging histograms across ranks
  is a plain per-bucket add (associative by construction).
- :class:`Timer` — a Histogram of seconds with a context-manager
  ``time()``; subsumes ``tracing.span``'s accumulation role.

Instruments are named and labeled: ``counter("exchange.bytes_true",
op="dist_join")`` and ``counter("exchange.bytes_true", op="shuffle")``
are distinct series of one metric. Lookup is get-or-create and
thread-safe; the hot path after creation is one dict ``get`` plus one
locked scalar update — no threads, no IO, nothing else (the watchdog
fast-path design). Exporters (:mod:`cylon_tpu_torch.telemetry.export`) are
armed lazily and ONLY when ``CYLON_TPU_METRICS_DIR`` is set.

The registry also owns a small bounded record store
(:meth:`MetricRegistry.add_record`) for subsystems that need the raw
completion events behind their aggregates — the watchdog's
``SectionTiming`` history lives there, so ``telemetry.reset()`` clears
aggregates and histories in one operation (no second source of truth).
"""

import bisect
import collections
import contextlib
import contextvars
import threading

__all__ = [
    "BUCKET_BOUNDS", "Counter", "Gauge", "Histogram", "Timer",
    "MetricRegistry", "registry", "counter", "gauge", "histogram",
    "timer", "metric", "instruments", "snapshot", "delta", "reset",
    "total", "add_record", "get_records", "tenant_scope",
    "current_tenant", "tenant_labels", "merge_histograms",
]

#: ambient tenant attribution for multi-tenant serving
#: (:mod:`cylon_tpu_torch.serve`): while a scope is active, the span timers
#: (``utils.tracing.span``), watchdog section metrics, resilience
#: fault/retry counters and flight-recorder events all gain a
#: ``tenant`` label/key, so one mixed-workload registry/recording can
#: be sliced per tenant after the fact. Contextvar-propagated: worker
#: threads spawned with ``copy_context`` (watchdog bounded calls)
#: inherit it; unrelated threads see None — no label, the historical
#: series keys.
_TENANT: contextvars.ContextVar = contextvars.ContextVar(
    "cylon_tenant", default=None)


def current_tenant() -> "str | None":
    return _TENANT.get()


@contextlib.contextmanager
def tenant_scope(tenant: "str | None"):
    """Attribute every instrumented event in this scope to ``tenant``
    (None = explicitly clear an inherited attribution)."""
    tok = _TENANT.set(None if tenant is None else str(tenant))
    try:
        yield
    finally:
        _TENANT.reset(tok)


def tenant_labels() -> dict:
    """``{"tenant": t}`` when a tenant scope is active, else ``{}`` —
    splice into instrument label kwargs (one shared spelling, so every
    layer labels identically and per-tenant filters match)."""
    t = _TENANT.get()
    return {} if t is None else {"tenant": t}


def merge_histograms(insts) -> "Histogram | None":
    """One Histogram holding the elementwise bucket/count/sum merge of
    ``insts`` (associative by the shared-ladder construction) — how a
    metric split across tenant label series is re-aggregated for
    whole-process quantiles. None when ``insts`` is empty."""
    insts = [h for h in insts if isinstance(h, Histogram)]
    if not insts:
        return None
    out = Histogram()
    for h in insts:
        with h._lock:
            out.count += h.count
            out.sum += h.sum
            if h.min is not None:
                out.min = h.min if out.min is None else min(out.min, h.min)
            if h.max is not None:
                out.max = h.max if out.max is None else max(out.max, h.max)
            for i, n in enumerate(h.buckets):
                out.buckets[i] += n
    return out

#: Shared histogram bucket upper bounds: powers of two from 2^-20
#: (~1 µs if the unit is seconds; ~1 B if bytes) to 2^30 (~12 days /
#: 1 GiB). One fixed log-spaced ladder for every histogram in the
#: process keeps cross-rank merges associative (equal buckets add
#: elementwise) and the export schema stable across PRs.
BUCKET_BOUNDS: "tuple[float, ...]" = tuple(
    float(2.0 ** e) for e in range(-20, 31))


class Counter:
    """Monotonically increasing metric."""

    __slots__ = ("_lock", "value")
    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n=1) -> None:
        # the lock (not bare `+=`) is the lose-no-updates contract the
        # 8-thread test pins down; one uncontended acquire is ~100 ns
        with self._lock:
            self.value += n

    def dump(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-written value."""

    __slots__ = ("_lock", "value")
    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def dump(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed log-spaced-bucket histogram with count/sum/min/max.

    Non-finite observations count into the overflow bucket but are
    excluded from ``sum``/``min``/``max``, so exports stay JSON-finite
    (the ``SpanStat.min_s = inf`` class of bug cannot re-enter through
    this door).
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "buckets")
    kind = "histogram"

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        # len(BUCKET_BOUNDS) + 1: the last slot is the +inf overflow
        self.buckets = [0] * (len(BUCKET_BOUNDS) + 1)

    def observe(self, v) -> None:
        v = float(v)
        finite = v == v and v not in (float("inf"), float("-inf"))
        i = (bisect.bisect_left(BUCKET_BOUNDS, v) if finite
             else len(BUCKET_BOUNDS))
        with self._lock:
            self.count += 1
            self.buckets[i] += 1
            if finite:
                self.sum += v
                self.min = v if self.min is None else min(self.min, v)
                self.max = v if self.max is None else max(self.max, v)

    def dump(self) -> dict:
        with self._lock:
            # sparse: only non-empty buckets, keyed by upper bound —
            # compact on the wire, lossless to merge (absent == 0)
            bks = {("+inf" if i == len(BUCKET_BOUNDS)
                    else repr(BUCKET_BOUNDS[i])): n
                   for i, n in enumerate(self.buckets) if n}
            return {"type": self.kind, "count": self.count,
                    "sum": self.sum, "min": self.min, "max": self.max,
                    "buckets": bks}

    def quantile(self, q: float) -> "float | None":
        """Bucket-resolution quantile estimate: the upper bound of the
        first bucket whose cumulative count reaches ``q * count``,
        clamped to the observed [min, max] (so p50 of a single
        observation is that observation, not its pow2 ceiling, and the
        overflow bucket cannot report +inf). None with no finite
        observations. Resolution is one pow2 bucket — tail columns in
        ``tracing.report`` trade exactness for zero per-observation
        cost, like every other read of this histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} not in [0, 1]")
        with self._lock:
            if self.min is None:
                return None
            finite = sum(self.buckets[:len(BUCKET_BOUNDS)])
            target = q * finite
            cum = 0
            for i, n in enumerate(self.buckets[:len(BUCKET_BOUNDS)]):
                cum += n
                if n and cum >= target:
                    return min(max(BUCKET_BOUNDS[i], self.min),
                               self.max)
            return self.max


class Timer(Histogram):
    """A Histogram of seconds with a context-manager clock."""

    __slots__ = ()
    kind = "timer"

    def time(self):
        import contextlib
        import time as _time

        @contextlib.contextmanager
        def _cm():
            t0 = _time.perf_counter()
            try:
                yield
            finally:
                self.observe(_time.perf_counter() - t0)

        return _cm()


_KINDS = {c.kind: c for c in (Counter, Gauge, Histogram, Timer)}


def render_key(name: str, labels: "tuple[tuple[str, str], ...]") -> str:
    """``name{k=v,...}`` — the stable series key used by snapshots."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricRegistry:
    """Named, labeled, thread-safe instrument store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "dict[tuple, object]" = {}
        self._records: "dict[str, collections.deque]" = {}
        self._armed = False
        #: callables run before every snapshot, which bring series up to
        #: date (the device-timed spans' pending event pairs)
        self._flush: list = []

    # ------------------------------------------------- get-or-create
    def _get(self, cls, name: str, labels: dict):
        key = (name, tuple(sorted((str(k), str(v))
                                  for k, v in labels.items())))
        inst = self._metrics.get(key)  # GIL-safe fast path: one lookup
        if inst is None:
            with self._lock:
                inst = self._metrics.get(key)
                if inst is None:
                    inst = self._metrics[key] = cls()
            self._maybe_arm()
        if not isinstance(inst, cls) and not (
                cls is Histogram and isinstance(inst, Timer)):
            raise TypeError(
                f"metric {render_key(*key)!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, /, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def timer(self, name: str, /, **labels) -> Timer:
        return self._get(Timer, name, labels)

    def metric(self, name: str, /, **labels):
        """Lookup WITHOUT creating: the instrument, or None."""
        key = (name, tuple(sorted((str(k), str(v))
                                  for k, v in labels.items())))
        return self._metrics.get(key)

    def _maybe_arm(self) -> None:
        """Arm the exporters exactly once, and ONLY when
        ``CYLON_TPU_METRICS_DIR`` is configured — otherwise the fast
        path stays thread-free and IO-free by construction."""
        if self._armed:
            return
        import os

        if not os.environ.get("CYLON_TPU_METRICS_DIR"):
            return
        with self._lock:
            if self._armed:
                return
            self._armed = True
        from cylon_tpu_torch.telemetry import export

        export.arm_exporters(self)

    # ------------------------------------------------------ snapshots
    def instruments(self, name: "str | None" = None):
        """[(name, labels dict, instrument)] — a point-in-time list."""
        with self._lock:
            items = list(self._metrics.items())
        return [(n, dict(ls), inst) for (n, ls), inst in items
                if name is None or n == name]

    def add_flush(self, fn) -> None:
        """Run ``fn()`` before every :meth:`snapshot` (and so every
        :meth:`delta` and export)."""
        self._flush.append(fn)

    def snapshot(self) -> dict:
        """``{series key: dump dict}`` — every entry carries ``name``
        and ``labels`` so merges and exporters need no key parsing. The
        :meth:`add_flush` callables run first."""
        for fn in self._flush:
            fn()
        out = {}
        for (n, ls), inst in list(self._metrics.items()):
            d = inst.dump()
            d["name"] = n
            d["labels"] = dict(ls)
            out[render_key(n, ls)] = d
        return out

    def delta(self, prev: dict) -> dict:
        """Snapshot minus ``prev``: counters and histogram counts/sums/
        buckets subtract (series absent from ``prev`` count from zero);
        gauges and min/max report their current values."""
        cur = self.snapshot()
        out = {}
        for k, d in cur.items():
            p = prev.get(k)
            d = dict(d)
            if p is None or p.get("type") != d["type"]:
                out[k] = d
                continue
            if d["type"] == "counter":
                d["value"] = d["value"] - p["value"]
            elif d["type"] in ("histogram", "timer"):
                d["count"] = d["count"] - p["count"]
                d["sum"] = d["sum"] - p["sum"]
                pb = p.get("buckets", {})
                d["buckets"] = {
                    le: n - pb.get(le, 0)
                    for le, n in d.get("buckets", {}).items()
                    if n - pb.get(le, 0)}
            out[k] = d
        return out

    def total(self, name: str):
        """Sum of a counter metric across all its label series (0 when
        the metric does not exist) — the aggregate tests and the bench
        block read."""
        t = 0
        for _, _, inst in self.instruments(name):
            if isinstance(inst, Counter):
                t += inst.value
        return t

    def reset(self, prefix: "str | None" = None) -> None:
        """Drop instruments (and records) whose name starts with
        ``prefix``; everything when None. This IS ``clear_timings`` for
        the subsystems folded in here — one reset, no second registry
        to clear."""
        with self._lock:
            if prefix is None:
                self._metrics.clear()
                self._records.clear()
                return
            for key in [k for k in self._metrics
                        if k[0].startswith(prefix)]:
                del self._metrics[key]
            for key in [k for k in self._records
                        if k.startswith(prefix)]:
                del self._records[key]

    # ------------------------------------------------------- records
    def add_record(self, name: str, obj, maxlen: int = 1024) -> None:
        """Append a raw event record under ``name`` (bounded history)."""
        with self._lock:
            dq = self._records.get(name)
            if dq is None:
                dq = self._records[name] = collections.deque(
                    maxlen=maxlen)
            dq.append(obj)

    def get_records(self, name: str) -> list:
        with self._lock:
            dq = self._records.get(name)
            return list(dq) if dq is not None else []


#: the process-default registry every helper below targets
registry = MetricRegistry()


def counter(name: str, /, **labels) -> Counter:
    return registry.counter(name, **labels)


def gauge(name: str, /, **labels) -> Gauge:
    return registry.gauge(name, **labels)


def histogram(name: str, /, **labels) -> Histogram:
    return registry.histogram(name, **labels)


def timer(name: str, /, **labels) -> Timer:
    return registry.timer(name, **labels)


def metric(name: str, /, **labels):
    return registry.metric(name, **labels)


def instruments(name: "str | None" = None):
    return registry.instruments(name)


def snapshot() -> dict:
    return registry.snapshot()


def delta(prev: dict) -> dict:
    return registry.delta(prev)


def total(name: str):
    return registry.total(name)


def reset(prefix: "str | None" = None) -> None:
    registry.reset(prefix)


def add_record(name: str, obj, maxlen: int = 1024) -> None:
    registry.add_record(name, obj, maxlen=maxlen)


def get_records(name: str) -> list:
    return registry.get_records(name)
