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
"""

import contextlib
import functools
from dataclasses import dataclass, field

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.logging import get_logger

#: the telemetry series spans record into (label ``name`` = span name)
SPAN_METRIC = "tracing.span_seconds"


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
    import torch

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


@contextlib.contextmanager
def span(name: str, sync=None, cat: "str | None" = None, **targs):
    """Time a named region; optionally wait for ``sync`` (tensors, or
    lists/tuples/dicts of them) so their device work is included in the
    measurement: the current stream of each of their CUDA devices is
    synchronized, and no other device. Without ``sync`` the span adds no
    device sync.

    ``cat``/``**targs`` annotate the flight-recorder event when tracing
    is armed (``cat="stage"`` marks the span as a stage for
    :func:`cylon_tpu_torch.telemetry.trace.critical_path` attribution);
    they cost nothing when it is off. The per-span completion line logs
    at DEBUG — at millions of spans an INFO line per span is pure noise
    on hot paths; aggregate visibility is :func:`report`'s job."""
    import time

    from torch.profiler import record_function

    t0 = time.perf_counter()
    tok = _trace.begin(name, cat=cat, **targs) if _trace.enabled() \
        else None
    try:
        with record_function(name):
            try:
                yield
            finally:
                if sync is not None:
                    _sync_streams(sync)
                dt = time.perf_counter() - t0
                # the ambient tenant (serve layer) splits the series so
                # per-tenant latency is reportable; outside a tenant
                # scope the labels are {} — the historical series key
                telemetry.timer(SPAN_METRIC, name=name,
                                **telemetry.tenant_labels()).observe(dt)
                get_logger().debug("%s: %.3f ms", name, dt * 1e3)
    finally:
        _trace.end(tok)


def traced(name: str | None = None):
    """Decorator: run the function under a :func:`span` (host timing)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def timings(tenant: "str | None" = None) -> dict[str, SpanStat]:
    """Snapshot of accumulated span statistics — a view over the
    telemetry registry's :data:`SPAN_METRIC` series. Series that differ
    only by ``tenant`` label merge per span name; ``tenant=`` restricts
    the view to one tenant's series (the serve layer's per-tenant
    latency slice)."""
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

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"profile-{os.getpid()}.trace.json"))
