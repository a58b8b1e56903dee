"""Op tracing: wall-clock spans + PyTorch profiler hooks.

Port of ``cylon_tpu/utils/tracing.py``. The reference has no tracer — it
inlines ``std::chrono`` timing and glog INFO lines at op boundaries
(shuffle timings ``table.cpp:167-177``; bench binaries log ``j_t``/
``w_t`` per rank,
``cpp/src/examples/bench/table_join_dist_test.cpp:38-56``). The rebuild
formalises that: every public op runs under a :func:`span`, spans
accumulate into the process telemetry registry
(:mod:`cylon_tpu_torch.telemetry` — one registry for spans, section
timings and engine counters, exportable as JSONL/Prometheus), and the
same spans open a ``torch.profiler.record_function`` range so they line
up with the CUDA kernels in a ``torch.profiler`` trace
(:func:`profile_to`).

When the flight recorder is armed (``CYLON_TPU_TRACE`` —
:mod:`cylon_tpu_torch.telemetry.trace`), every span additionally emits
begin/end events with parent nesting into the trace buffer, so the
same instrumentation feeds the histogram aggregates AND the
Chrome-trace timelines; with the recorder off, the only addition over
the pre-recorder span is one env read.

CUDA launches are asynchronous, so a span around device work measures
*host orchestration* unless ``sync=`` names tensors to wait for: the
span then synchronizes the current stream of their device (never every
device, and never without ``sync``).

A span opened with ``device=True`` also times its device work without a
sync, while a ``torch.profiler`` session runs or the flight recorder is
armed: a CUDA event pair on the current stream, resolved later into the
series ``<span>.device`` (:func:`resolve_device_spans`).

:func:`host_read` runs each blocking transfer between host and device
that the port makes on purpose under a span ``host_read.<site>`` and
counts it in ``host.reads{site}``, so that a profile names the call site
of every host sync (:data:`HOST_READ_SITES`).
"""

import collections
import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.logging import get_logger

#: the telemetry series spans record into (label ``name`` = span name)
SPAN_METRIC = "tracing.span_seconds"

#: the call sites of :func:`host_read`, each a static range name
#: ``host_read.<site>``: ``count``, a regrow ladder's row count
#: (``plan.regrow_eager``, the group-by's ladder); ``groupby_bound``, the
#: group-by input's count after an overflow; ``shrink``,
#: ``Table.shrink_to_fit``'s row count; ``shard_sizes``, every rank's row
#: count and capacity (``dtable.shard_sizes``, read at each rung of the
#: dist ops' ladder); ``chain_check``, the bucketed hash join's chain
#: pre-check; ``build_overflow``, its build's overflow count; ``fetch``,
#: a compiled query's one fetch; ``stage``, a host constant copied to
#: the device from pageable memory, which waits for the stream too
HOST_READ_SITES = ("count", "groupby_bound", "shrink", "shard_sizes",
                   "chain_check", "build_overflow", "fetch", "stage")

_READ_SPANS = {site: f"host_read.{site}" for site in HOST_READ_SITES}

#: a span's stand-in for its profiler range while no session records one
_NO_RANGE = contextlib.nullcontext()


@dataclass
class SpanStat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = field(default=float("inf"))
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    def to_json(self) -> dict:
        """Strict-JSON-safe dict: an empty stat's ``min_s`` default of
        ``float("inf")`` would serialise as invalid-JSON ``Infinity``
        (``json.dumps`` emits it happily), so fields normalise through
        the one canonical coercion, :func:`telemetry.json_safe`."""
        return telemetry.json_safe(
            {"count": self.count, "total_s": self.total_s,
             "min_s": self.min_s, "max_s": self.max_s})


def _sync_streams(sync) -> None:
    """Wait for the device work of the tensors in ``sync`` (a tensor or
    a nesting of lists, tuples and dicts of them): one synchronize of
    the current stream of each CUDA device they lie on. CPU tensors
    need no wait."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(sync)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()


# ------------------------------------------------ device-timed spans
#: event pairs of device-timed spans not resolved yet, oldest first:
#: ``(series name, labels, start event, end event)``
_PENDING: collections.deque = collections.deque()
_RESOLVING = threading.Lock()
#: whether the process sees a CUDA device (looked up once, when a device
#: span first finds a profiler or the recorder armed)
_CUDA: "bool | None" = None


def _cuda_ready() -> bool:
    global _CUDA
    if _CUDA is None:
        _CUDA = torch.cuda.is_available()
    return _CUDA


def _capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph, which an
    event with timing may not be recorded into, and whose capture an
    event query on this thread would break."""
    return _cuda_ready() and torch.cuda.is_current_stream_capturing()


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def resolve_device_spans(wait: bool = False) -> int:
    """Observe the device time of every pending event pair whose end has
    completed into :data:`SPAN_METRIC` under ``<span>.device``; with
    ``wait``, wait for every pending pair first. Returns the pairs
    resolved. Span exits call it without waiting; ``telemetry.snapshot()``
    calls it with ``wait``, the one place that waits, and only when
    pairs are pending. Nothing is resolved while this thread's stream
    captures a CUDA graph."""
    done = 0
    if not _PENDING or _capturing() \
            or not _RESOLVING.acquire(blocking=wait):
        return done
    try:
        while _PENDING:
            name, labels, start, end = _PENDING[0]
            if wait:
                end.synchronize()
            elif not end.query():
                break   # later pairs ran after this one on the stream
            _PENDING.popleft()
            telemetry.timer(SPAN_METRIC, name=name, **labels).observe(
                start.elapsed_time(end) / 1e3)
            done += 1
    finally:
        _RESOLVING.release()
    return done


telemetry.registry.add_flush(lambda: resolve_device_spans(wait=True))


#: sums on the card of counters whose amounts lie there, by ``(counter,
#: device)``, and the keys added to since the last snapshot
_DEVICE_SUMS: dict = {}
_DIRTY: set = set()
_SUMS = threading.Lock()


def device_counting() -> bool:
    """Whether :func:`count_on_device` counts now: while a ``torch.profiler``
    session is active or the flight recorder is armed, as device-timed
    spans record, and not while the current stream captures a CUDA
    graph (a replay runs no Python to count it)."""
    return (_trace.enabled() or torch._C._autograd._profiler_enabled()) \
        and not _capturing()


def count_on_device(name: str, amount: torch.Tensor, at_most: int,
                    scale: int) -> None:
    """Add ``min(amount, at_most) * scale`` to the counter ``name``
    without a sync: ``amount``, an integer tensor of one value, is summed
    on its device, and ``telemetry.snapshot()`` folds the sum into the
    counter (one wait for each device added to since the last). Callers
    check :func:`device_counting` first."""
    key = (name, amount.device)
    with _SUMS:
        acc = _DEVICE_SUMS.get(key)
        if acc is None:
            acc = _DEVICE_SUMS[key] = torch.zeros(
                (), dtype=torch.int64, device=amount.device)
        acc.add_(torch.clamp(amount.reshape(()), max=at_most), alpha=scale)
        _DIRTY.add(key)


def _fold_device_sums() -> None:
    with _SUMS:
        keys = list(_DIRTY)
        _DIRTY.clear()
        if keys and _capturing():   # a read would break the capture
            _DIRTY.update(keys)
            return
        for name, dev in keys:
            acc = _DEVICE_SUMS[(name, dev)]
            if dev.type == "cuda":   # adds of every stream
                torch.cuda.synchronize(dev)
            got = int(acc)
            acc.zero_()
            telemetry.counter(name).inc(got)


telemetry.registry.add_flush(_fold_device_sums)


@contextlib.contextmanager
def span(name: str, sync=None, cat: "str | None" = None,
         device: bool = False, **targs):
    """Time a named region; optionally wait for ``sync`` (tensors, or
    lists/tuples/dicts of them) so their device work is included in the
    measurement: the current stream of each of their CUDA devices is
    synchronized, and no other device. Without ``sync`` the span adds no
    device sync.

    ``device=True`` times the region's work on the card as well, without
    a sync: while a ``torch.profiler`` session is active or the flight
    recorder is armed, and the current stream is not capturing a CUDA
    graph, a CUDA event pair is recorded on the current stream at enter
    and exit, and :func:`resolve_device_spans` observes its elapsed time
    into :data:`SPAN_METRIC` under ``<name>.device``. Otherwise the
    option costs one boolean check.

    ``cat``/``**targs`` annotate the flight-recorder event when tracing
    is armed (``cat="stage"`` marks the span as a stage for
    :func:`cylon_tpu_torch.telemetry.trace.critical_path` attribution);
    they cost nothing when it is off. The per-span completion line logs
    at DEBUG — at millions of spans an INFO line per span is pure noise
    on hot paths; aggregate visibility is :func:`report`'s job.

    The ``record_function`` range opens only while a ``torch.profiler``
    session is active on this thread, the only time one is recorded:
    entering it costs about half of a span's host time otherwise."""
    t0 = time.perf_counter()
    tok = _trace.begin(name, cat=cat, **targs) if _trace.enabled() \
        else None
    profiled = torch._C._autograd._profiler_enabled()
    start = None
    if device and (tok is not None or profiled) and _cuda_ready() \
            and not _capturing():
        start = _new_event()
        start.record()
    try:
        with record_function(name) if profiled else _NO_RANGE:
            try:
                yield
            finally:
                if sync is not None:
                    _sync_streams(sync)
                dt = time.perf_counter() - t0
                # the ambient tenant (serve layer) splits the series so
                # per-tenant latency is reportable; outside a tenant
                # scope the labels are {} — the historical series key
                labels = telemetry.tenant_labels()
                telemetry.timer(SPAN_METRIC, name=name,
                                **labels).observe(dt)
                if start is not None:
                    end = _new_event()
                    end.record()
                    _PENDING.append((f"{name}.device", labels, start, end))
                if _PENDING:
                    resolve_device_spans()
                get_logger().debug("%s: %.3f ms", name, dt * 1e3)
    finally:
        _trace.end(tok)


def traced(name: str | None = None, device: bool = False):
    """Decorator: run the function under a :func:`span` (host timing;
    ``device=True`` times its device work too)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label, device=device):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def host_read(site: str, fn):
    """``fn()``, one blocking transfer between host and device (a device
    value read on the host, or a host value copied in from pageable
    memory), under the span ``host_read.<site>``, counted in
    ``host.reads{site}`` on every device. ``site`` is one of
    :data:`HOST_READ_SITES`."""
    name = _READ_SPANS[site]
    telemetry.counter("host.reads", site=site).inc()
    with span(name):
        return fn()


def timings(tenant: "str | None" = None) -> dict[str, SpanStat]:
    """Snapshot of accumulated span statistics — a view over the
    telemetry registry's :data:`SPAN_METRIC` series. Series that differ
    only by ``tenant`` label merge per span name; ``tenant=`` restricts
    the view to one tenant's series (the serve layer's per-tenant
    latency slice). Device spans whose work has completed are resolved
    first (:func:`resolve_device_spans`, no wait)."""
    resolve_device_spans()
    out = {}
    for _, labels, inst in telemetry.instruments(SPAN_METRIC):
        if tenant is not None and labels.get("tenant") != str(tenant):
            continue
        d = inst.dump()  # locked read: count/min/max move together
        if d["count"] and d["min"] is not None:
            s = out.get(labels["name"])
            if s is None:
                out[labels["name"]] = SpanStat(
                    d["count"], float(d["sum"]), float(d["min"]),
                    float(d["max"]))
            else:
                s.count += d["count"]
                s.total_s += float(d["sum"])
                s.min_s = min(s.min_s, float(d["min"]))
                s.max_s = max(s.max_s, float(d["max"]))
    return out


def reset_timings() -> None:
    telemetry.reset("tracing.")


def report(tenant: "str | None" = None) -> str:
    """Human-readable table of span stats, slowest total first. The
    p50/p99 columns come from the shared pow2 histogram buckets
    (:meth:`cylon_tpu_torch.telemetry.registry.Histogram.quantile`) — mean/
    min/max alone hide tail latency, and the tail is where stragglers
    live. ``tenant=`` isolates one tenant's spans from a mixed
    multi-tenant recording (series labeled by the serve layer's
    ambient :func:`cylon_tpu_torch.telemetry.tenant_scope`); the default
    merges every tenant's series per span name."""
    insts: dict[str, list] = {}
    for _, labels, inst in telemetry.instruments(SPAN_METRIC):
        if tenant is not None and labels.get("tenant") != str(tenant):
            continue
        insts.setdefault(labels.get("name", "?"), []).append(inst)
    snap = timings(tenant=tenant)
    if not snap:
        return "(no spans recorded)"
    rows = sorted(snap.items(), key=lambda kv: -kv[1].total_s)
    w = max(len(k) for k, _ in rows)
    lines = [f"{'span':<{w}}  {'count':>6}  {'total ms':>10}  "
             f"{'mean ms':>9}  {'min ms':>8}  {'p50 ms':>8}  "
             f"{'p99 ms':>8}  {'max ms':>8}"]
    for k, s in rows:
        # quantiles over the MERGED bucket ladder when a name has
        # several tenant series (associative by construction)
        inst = telemetry.merge_histograms(insts.get(k, []))
        p50 = inst.quantile(0.5) if inst is not None else None
        p99 = inst.quantile(0.99) if inst is not None else None
        lines.append(
            f"{k:<{w}}  {s.count:>6}  {s.total_s * 1e3:>10.3f}  "
            f"{s.total_s / s.count * 1e3:>9.3f}  {s.min_s * 1e3:>8.3f}  "
            f"{(p50 or 0.0) * 1e3:>8.3f}  {(p99 or 0.0) * 1e3:>8.3f}  "
            f"{s.max_s * 1e3:>8.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activity) of the enclosed region into ``logdir`` as a Chrome trace
    file — the deep-dive tool the reference lacks; open it in Perfetto
    or ``chrome://tracing``. The spans of this module appear in it as
    ``record_function`` ranges."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"profile-{os.getpid()}.trace.json"))
