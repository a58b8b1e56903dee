"""Sliding-window metric views: the time axis the registry deliberately
dropped.

Every instrument in :mod:`cylon_tpu_torch.telemetry.registry` is cumulative
since process start — perfect for associative cross-rank merges,
useless for the questions a router (or an operator mid-incident) asks:
"what is the p99 over the last 30 seconds?", "what is the error *rate*
this window?". This module is the standard control-plane answer — a
bounded in-memory time-series store (à la Monarch's in-memory leaves)
over the existing registry:

* :class:`MetricHistory` — a bounded ring of registry snapshot
  **deltas**. Each :meth:`~MetricHistory.sample` diffs the registry
  against the previous sample (:meth:`MetricRegistry.delta`) and
  stores only the change, stamped with the interval it covers. A
  windowed view is then the merge of the deltas inside the window:
  counters and histogram buckets ADD (the one fixed power-of-2 ladder
  makes bucket deltas associative — :data:`registry.BUCKET_BOUNDS`),
  gauges take the newest value. Because a merged window view has the
  exact shape of a registry snapshot, the existing
  :func:`cylon_tpu_torch.telemetry.aggregate.merge_snapshots` merges
  windowed views ACROSS RANKS unchanged — windowed p99 of the fleet
  is one bucket-add away.

* :class:`EventWindow` / :class:`BurnRate` — the light half: a
  time-bucketed sliding event counter (O(slots) memory regardless of
  event volume) and the multi-window SLO burn-rate accounting built
  on it (Google SRE workbook: ``burn = bad_fraction / error_budget``
  per window). The serve layer's circuit breaker and per-tenant SLO
  tracking both ride these, so "how many failures in the last W
  seconds" has ONE implementation.

Sampling cadence: the history never starts a thread. Samples are taken
by the existing metrics-interval exporter daemon
(``CYLON_TPU_METRICS_INTERVAL`` — already armed only under
``CYLON_TPU_METRICS_DIR``) and ON DEMAND by the windowed readers (a
router polling ``/health`` or ``/metrics/window`` IS the cadence; each
read refreshes the ring if the last sample is stale). Fast-path
contract (same as trace/introspect): a process where nothing ever
reads a window allocates NOTHING here — :data:`_HISTORY` stays None,
:func:`armed` is one attribute read, and the env knobs are read only
when the first reader arms the ring (pinned by
``tests/test_timeseries.py``).

Knobs:

=====================================  ============================ =======
env                                    meaning                      default
=====================================  ============================ =======
``CYLON_TPU_METRICS_HISTORY_WINDOW``   seconds of history retained  ``300``
``CYLON_TPU_METRICS_HISTORY_SLOTS``    max ring slots (bounds both
                                       memory and the finest
                                       windowed resolution)         ``128``
=====================================  ============================ =======
"""

import collections
import os
import threading
import time

from cylon_tpu_torch.telemetry import registry as _r

__all__ = [
    "MetricHistory", "EventWindow", "BurnRate", "history", "armed",
    "sample", "window_view", "window_total", "rate", "quantile",
    "reset", "quantile_from_buckets", "DEFAULT_WINDOW_S",
    "DEFAULT_SLOTS",
]

DEFAULT_WINDOW_S = 300.0
DEFAULT_SLOTS = 128


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def quantile_from_buckets(buckets: "dict[str, int]",
                          q: float) -> "float | None":
    """Quantile from a sparse ``{le: count}`` bucket dict (the
    snapshot/delta wire shape), **log-linearly interpolated** inside
    the power-of-2 bucket the target falls in: the old
    upper-bound answer could overstate a windowed p99 by up to 2×
    (BENCH_r08 recorded 8.0s against a 4.8s exact p99 — a 1.67× lie
    the router's health verdict consumed). The shared ladder doubles
    every bound, so each bucket spans ``(le/2, le]``; assuming
    observations spread log-uniformly inside it, the quantile at
    in-bucket fraction ``f`` is ``(le/2) * 2**f`` — exact at both
    edges, and never past the bound the observation provably fits
    under. Overflow (``+inf``) observations still resolve to the
    largest finite bound — windowed views carry no min/max to clamp
    by. None when the window holds no observations."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} not in [0, 1]")
    finite = [(float(le), n) for le, n in buckets.items()
              if le != "+inf" and n]
    overflow = sum(n for le, n in buckets.items() if le == "+inf")
    finite.sort()
    total = sum(n for _, n in finite) + overflow
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for le, n in finite:
        if cum + n >= target:
            # in-bucket fraction of the target, clamped so q=0 maps
            # to the lower edge and a full bucket to its bound
            frac = min(max((target - cum) / n, 0.0), 1.0)
            return (le / 2.0) * (2.0 ** frac)
        cum += n
    # target falls in the overflow bucket: the ladder cannot resolve
    # past its top — report the largest finite bound seen
    return finite[-1][0] if finite else float(_r.BUCKET_BOUNDS[-1])


def _merge_delta(into: dict, delta: dict) -> None:
    """Accumulate one sample delta into a window view IN TIME ORDER:
    counters and histogram count/sum/buckets add (associative by the
    shared ladder), gauges take the newest value (this is a window of
    one rank's own history — "latest wins" is the honest read; the
    cross-RANK merge of finished views still goes through
    ``aggregate.merge_snapshots`` with its max-gauge semantics)."""
    for key, d in delta.items():
        cur = into.get(key)
        if cur is None:
            e = dict(d)
            if d.get("type") in ("histogram", "timer"):
                e["buckets"] = dict(d.get("buckets") or {})
                # min/max in a registry delta are CUMULATIVE extremes,
                # not windowed ones — drop them rather than lie
                e.pop("min", None)
                e.pop("max", None)
            into[key] = e
            continue
        t = d.get("type")
        if t == "counter":
            cur["value"] = cur.get("value", 0) + d.get("value", 0)
        elif t == "gauge":
            if d.get("value") is not None:
                cur["value"] = d["value"]
        elif t in ("histogram", "timer"):
            cur["count"] = cur.get("count", 0) + d.get("count", 0)
            cur["sum"] = cur.get("sum", 0.0) + d.get("sum", 0.0)
            bks = cur.setdefault("buckets", {})
            for le, n in (d.get("buckets") or {}).items():
                bks[le] = bks.get(le, 0) + n


class MetricHistory:
    """Bounded ring of ``(t0, t1, delta)`` registry samples.

    ``sample()`` is throttled to one diff per ``min_spacing`` seconds
    (window / slots) so a hot poller cannot burn CPU re-diffing the
    registry; ``force=True`` bypasses (tests, end-of-run flushes).
    Thread-safe: one lock around the ring and the previous-snapshot
    cursor."""

    def __init__(self, window_s: "float | None" = None,
                 slots: "int | None" = None, reg=None):
        self.window_s = float(window_s if window_s is not None
                              else _env_float(
                                  "CYLON_TPU_METRICS_HISTORY_WINDOW",
                                  DEFAULT_WINDOW_S))
        if self.window_s <= 0:
            self.window_s = DEFAULT_WINDOW_S
        n = int(slots if slots is not None
                else _env_float("CYLON_TPU_METRICS_HISTORY_SLOTS",
                                DEFAULT_SLOTS))
        self.slots = max(n, 2)
        self.min_spacing = self.window_s / self.slots
        self._reg = reg if reg is not None else _r.registry
        self._mu = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.slots)
        self._prev: "dict | None" = None
        self._prev_ts: "float | None" = None

    # ------------------------------------------------------- sampling
    def sample(self, force: bool = False,
               now: "float | None" = None) -> bool:
        """Take one delta sample (True when a new slot was recorded;
        False when throttled). ``now`` is injectable for tests."""
        now = time.monotonic() if now is None else float(now)
        with self._mu:
            if (not force and self._prev_ts is not None
                    and now - self._prev_ts < self.min_spacing):
                return False
            snap = self._reg.snapshot()
            if self._prev is None:
                # baseline sample: establishes t0 — no delta to store
                self._prev, self._prev_ts = snap, now
                return True
            # diff the two snapshots we hold (not the live registry)
            # so the stored slot covers exactly (prev_ts, now]
            delta = _snapshot_diff(snap, self._prev)
            self._ring.append((self._prev_ts, now, delta))
            self._prev, self._prev_ts = snap, now
            return True

    # -------------------------------------------------------- reading
    def _slots_in(self, window: "float | None",
                  now: "float | None" = None):
        now = time.monotonic() if now is None else float(now)
        w = self.window_s if window is None else float(window)
        lo = now - w
        with self._mu:
            return [s for s in self._ring if s[1] > lo]

    def window_view(self, window: "float | None" = None,
                    now: "float | None" = None) -> dict:
        """The merged windowed delta: ``{"window_s": covered seconds,
        "samples": n, "series": {key: entry}}`` where ``series`` has
        the registry-snapshot shape (so
        ``aggregate.merge_snapshots([a["series"], b["series"]])``
        merges views across ranks)."""
        slots = self._slots_in(window, now)
        series: dict = {}
        for _, _, delta in slots:
            _merge_delta(series, delta)
        covered = (slots[-1][1] - slots[0][0]) if slots else 0.0
        return {"window_s": covered, "samples": len(slots),
                "series": series}

    def window_total(self, name: str, window: "float | None" = None,
                     now: "float | None" = None, **labels):
        """Windowed counter delta summed across the metric's label
        series (restricted to series matching ``labels`` when given)."""
        view = self.window_view(window, now)
        total = 0
        for e in view["series"].values():
            if e.get("name") != name or e.get("type") != "counter":
                continue
            el = e.get("labels") or {}
            if any(el.get(k) != str(v) for k, v in labels.items()):
                continue
            total += e.get("value", 0)
        return total

    def rate(self, name: str, window: "float | None" = None,
             now: "float | None" = None, **labels) -> "float | None":
        """Windowed counter delta / covered seconds (None when the
        ring holds no samples in the window)."""
        view = self.window_view(window, now)
        if view["window_s"] <= 0:
            return None
        return self.window_total(name, window, now, **labels) \
            / view["window_s"]

    def quantile(self, name: str, q: float,
                 window: "float | None" = None,
                 now: "float | None" = None,
                 **labels) -> "float | None":
        """Windowed quantile from merged histogram bucket deltas
        (bucket-resolution; series matching ``labels`` merge first —
        associative by the shared ladder)."""
        view = self.window_view(window, now)
        buckets: dict = {}
        for e in view["series"].values():
            if e.get("name") != name or \
                    e.get("type") not in ("histogram", "timer"):
                continue
            el = e.get("labels") or {}
            if any(el.get(k) != str(v) for k, v in labels.items()):
                continue
            for le, n in (e.get("buckets") or {}).items():
                buckets[le] = buckets.get(le, 0) + n
        return quantile_from_buckets(buckets, q)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._prev = self._prev_ts = None


def _snapshot_diff(cur: dict, prev: dict) -> dict:
    """``cur - prev`` over two snapshot dicts (same semantics as
    ``MetricRegistry.delta`` but between two frozen snapshots): only
    CHANGED series survive, so ring slots stay sparse."""
    out = {}
    for k, d in cur.items():
        p = prev.get(k)
        d = dict(d)
        if p is None or p.get("type") != d["type"]:
            if d["type"] in ("histogram", "timer"):
                d["buckets"] = dict(d.get("buckets") or {})
            if _delta_nonzero(d):
                out[k] = d
            continue
        t = d["type"]
        if t == "counter":
            d["value"] = d["value"] - p["value"]
        elif t in ("histogram", "timer"):
            d["count"] = d["count"] - p["count"]
            d["sum"] = d["sum"] - p["sum"]
            pb = p.get("buckets", {})
            d["buckets"] = {le: n - pb.get(le, 0)
                            for le, n in (d.get("buckets") or {}).items()
                            if n - pb.get(le, 0)}
        elif t == "gauge":
            if d.get("value") == p.get("value"):
                continue  # unchanged gauge: not part of the delta
        if _delta_nonzero(d):
            out[k] = d
    return out


def _delta_nonzero(d: dict) -> bool:
    t = d.get("type")
    if t == "counter":
        return bool(d.get("value"))
    if t in ("histogram", "timer"):
        return bool(d.get("count"))
    return d.get("value") is not None


# ------------------------------------------------------- process history
_LOCK = threading.Lock()
_HISTORY: "MetricHistory | None" = None


def armed() -> bool:
    """Has anything armed the history ring? (One attribute read — the
    entire cost in a process that never uses windowed views.)"""
    return _HISTORY is not None


def history() -> MetricHistory:
    """The process history ring, created on first use from the
    ``CYLON_TPU_METRICS_HISTORY_*`` knobs. Arming is driven by the
    READERS (windowed endpoints, the interval exporter daemon, tests)
    — hot instrument paths never reach here."""
    global _HISTORY
    h = _HISTORY
    if h is None:
        with _LOCK:
            if _HISTORY is None:
                _HISTORY = MetricHistory()
            h = _HISTORY
    return h


def sample(force: bool = False) -> bool:
    """Sample the process history (arming it on first call)."""
    return history().sample(force=force)


def window_view(window: "float | None" = None) -> dict:
    """Freshen the ring if stale, then return the merged window view
    (the ``/metrics/window`` payload)."""
    h = history()
    h.sample()  # on-demand cadence: the poller IS the sampler
    return h.window_view(window)


def window_total(name: str, window: "float | None" = None, **labels):
    h = history()
    h.sample()
    return h.window_total(name, window, **labels)


def rate(name: str, window: "float | None" = None,
         **labels) -> "float | None":
    h = history()
    h.sample()
    return h.rate(name, window, **labels)


def quantile(name: str, q: float, window: "float | None" = None,
             **labels) -> "float | None":
    h = history()
    h.sample()
    return h.quantile(name, q, window, **labels)


def reset() -> None:
    """Drop the process history entirely (tests) — the next reader
    re-arms from the env knobs."""
    global _HISTORY
    with _LOCK:
        _HISTORY = None


# ------------------------------------------------------ event windows
class EventWindow:
    """Time-bucketed sliding event counter: ``count()`` over the last
    ``window_s`` seconds in O(slots) memory regardless of event volume
    (the deque-of-timestamps it replaces grew with the storm it was
    supposed to measure). NOT internally locked — callers that share
    one across threads hold their own lock (the circuit breaker and
    SLO tracker already do)."""

    __slots__ = ("window_s", "slots", "_width", "_buckets")

    def __init__(self, window_s: float, slots: int = 32):
        self.window_s = float(window_s)
        self.slots = max(int(slots), 4)
        self._width = self.window_s / self.slots
        #: deque of [bucket_index, count]
        self._buckets: collections.deque = collections.deque()

    def _evict(self, now: float) -> None:
        # evict on bucket END, not start: a bucket whose span still
        # overlaps the window may hold events younger than the edge —
        # dropping it would UNDERcount (a breaker that misses its trip
        # threshold), so the granularity error over-approximates
        # instead (events up to one bucket-width older than the
        # window are retained)
        lo = (now - self.window_s) / self._width
        while self._buckets and self._buckets[0][0] + 1 <= lo:
            self._buckets.popleft()

    def add(self, n: int = 1, now: "float | None" = None) -> None:
        now = time.monotonic() if now is None else float(now)
        idx = int(now / self._width)
        self._evict(now)
        if self._buckets and self._buckets[-1][0] == idx:
            self._buckets[-1][1] += n
        else:
            self._buckets.append([idx, n])

    def count(self, now: "float | None" = None) -> int:
        now = time.monotonic() if now is None else float(now)
        self._evict(now)
        return sum(c for _, c in self._buckets)

    def clear(self) -> None:
        self._buckets.clear()


class BurnRate:
    """Multi-window SLO burn-rate accounting (SRE workbook chapter 5):
    ``burn(w) = bad_fraction_over_w / error_budget`` where
    ``error_budget = 1 - objective``. Burn 1.0 = consuming exactly the
    budget; a sustained burn of 10 exhausts a 30-day budget in 3 days
    — multi-window alerting reads a SHORT window (fast detection) and
    a LONG one (de-flapping) together, which is why this class keeps
    one good/bad :class:`EventWindow` pair per window. Not internally
    locked (see :class:`EventWindow`)."""

    __slots__ = ("objective", "windows", "_good", "_bad")

    def __init__(self, objective: float, windows):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO objective must be in (0, 1), got {objective}")
        self.objective = float(objective)
        self.windows = tuple(float(w) for w in windows)
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(
                f"burn windows must be positive, got {windows}")
        self._good = {w: EventWindow(w) for w in self.windows}
        self._bad = {w: EventWindow(w) for w in self.windows}

    def record(self, good: bool, now: "float | None" = None) -> None:
        tgt = self._good if good else self._bad
        for w in self.windows:
            tgt[w].add(1, now=now)

    def burn(self, window: float,
             now: "float | None" = None) -> "float | None":
        """Burn rate over ``window`` (None with no events in it)."""
        g = self._good[window].count(now)
        b = self._bad[window].count(now)
        if g + b == 0:
            return None
        return (b / (g + b)) / (1.0 - self.objective)

    def burns(self, now: "float | None" = None) -> dict:
        """``{window_s: burn}`` for every configured window (events-
        free windows report None)."""
        return {w: self.burn(w, now) for w in self.windows}
