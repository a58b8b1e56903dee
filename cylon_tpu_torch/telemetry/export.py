"""Machine-readable exporters: JSONL snapshots and Prometheus text.

Export is pull/flush-shaped and OFF by default: nothing here runs —
no thread, no file handle — unless ``CYLON_TPU_METRICS_DIR`` is set
(then :func:`arm_exporters` installs an atexit flush, plus a periodic
daemon writer when ``CYLON_TPU_METRICS_INTERVAL`` seconds > 0) or a
caller invokes :func:`write_snapshot` / :func:`to_prometheus`
directly. That keeps the instrumented hot paths at dict-update cost,
mirroring the watchdog's no-scope-no-thread design.

Everything emitted is strict JSON / Prometheus text: non-finite values
(the ``SpanStat.min_s = float("inf")`` bug class — ``json.dumps``
happily writes invalid-JSON ``Infinity``) are normalised to ``null``
(JSONL) or dropped (Prometheus) by :func:`json_safe`.
"""

import json
import os
import re
import threading
import time

__all__ = [
    "json_safe", "snapshot_to_json", "to_prometheus", "metrics_dir",
    "write_snapshot", "arm_exporters", "bench_metrics",
    "REQUIRED_BENCH_KEYS", "HBM_PEAK_BYTES_PER_SEC",
    "NVLINK_BYTES_PER_SEC", "fraction_of_peak",
    "to_chrome_trace", "chrome_trace_json", "write_chrome_trace",
    "SHARD_PID_BASE",
]

# ---------------------------------------------------------------- roofline
#: H100 SXM5 80GB HBM3 bandwidth, bytes/s: the data-sheet value (3.35
#: TB/s), not a measurement. The roofline every exchange bytes/s
#: number is reported against (a shuffle that moves device rows through
#: a sort and a copy is bound by device memory before the link at W=1).
HBM_PEAK_BYTES_PER_SEC = 3.35e12

#: H100 SXM5 NVLink (fourth generation), bytes/s per card: the
#: data-sheet value (900 GB/s, both directions of its 18 links
#: together), not a measurement. The peak for the per-peer streams of a
#: multi-card all-to-all.
NVLINK_BYTES_PER_SEC = 900e9


def fraction_of_peak(bytes_per_sec: float,
                     peak: float = HBM_PEAK_BYTES_PER_SEC) -> float:
    """Measured exchange bandwidth as a fraction of a hardware peak —
    the roofline position of a bench number. Callers label which peak
    they divided by (device memory for single-card/self-copy paths,
    NVLink for cross-card streams); the division itself is kept here so
    every bench reports it the same way."""
    return bytes_per_sec / peak if peak > 0 else 0.0


def json_safe(x):
    """Recursively coerce to strict-JSON values: NaN/±inf become None
    (``json.dumps(..., allow_nan=False)`` never raises) and non-JSON
    scalars (numpy scalars, arbitrary objects a gauge was fed) coerce
    through ``float()`` or ``str()`` — ONE bad instrument must never
    cost the whole snapshot."""
    if x is None or isinstance(x, (str, int)):  # bool is an int
        return x
    if isinstance(x, float):
        return x if x == x and x not in (float("inf"),
                                         float("-inf")) else None
    if isinstance(x, dict):
        return {str(k): json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    try:
        return json_safe(float(x))
    except (TypeError, ValueError):
        return str(x)


def snapshot_to_json(snap: dict) -> str:
    """One strict-JSON line for a snapshot (or delta) dict."""
    return json.dumps(json_safe(snap), allow_nan=False,
                      separators=(",", ":"), sort_keys=True)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "cylon_" + _PROM_BAD.sub("_", name)


def _prom_value(v) -> str:
    """Exact exposition-format number: integers verbatim (a 1.2 GB
    byte counter must not round through ``%g``'s 6 significant
    digits), floats at full round-trip precision."""
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".17g")


def _prom_escape(v: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double quote and newline (an unescaped span name with quotes
    would make Prometheus reject the whole scrape)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(labels: dict, extra: "tuple | None" = None) -> str:
    items = [(k, str(v)) for k, v in sorted(labels.items())]
    if extra:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(f'{_PROM_BAD.sub("_", k)}="{_prom_escape(v)}"'
                    for k, v in items)
    return "{" + body + "}"


def to_prometheus(snap: "dict | None" = None) -> str:
    """Prometheus text exposition of a snapshot: counters and gauges
    as-is, histograms/timers as cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count``. Non-finite values are skipped (a gauge
    that was never set exports nothing rather than ``NaN``)."""
    from cylon_tpu_torch.telemetry import registry as _r

    snap = _r.snapshot() if snap is None else snap
    typed: "dict[str, str]" = {}
    lines_by_name: "dict[str, list]" = {}
    for d in snap.values():
        name = _prom_name(d["name"])
        labels = d.get("labels", {})
        kind = d["type"]
        if kind in ("counter", "gauge"):
            typed[name] = "counter" if kind == "counter" else "gauge"
            v = d["value"]
            if not isinstance(v, int):
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    continue  # non-numeric gauge: skip the series
                v = json_safe(v)
            if v is None:
                continue
            lines_by_name.setdefault(name, []).append(
                f"{name}{_prom_labels(labels)} {_prom_value(v)}")
        else:
            typed[name] = "histogram"
            out = lines_by_name.setdefault(name, [])
            cum = 0
            for le, n in sorted(
                    d.get("buckets", {}).items(),
                    key=lambda kv: (kv[0] == "+inf",
                                    float(kv[0]) if kv[0] != "+inf"
                                    else 0.0)):
                if le == "+inf":
                    continue  # the final cumulative line covers it
                cum += n
                out.append(f"{name}_bucket"
                           f"{_prom_labels(labels, ('le', le))} {cum}")
            out.append(f"{name}_bucket"
                       f"{_prom_labels(labels, ('le', '+inf'))} "
                       f"{d['count']}")
            s = json_safe(float(d["sum"]))
            out.append(f"{name}_sum{_prom_labels(labels)} "
                       f"{_prom_value(0.0 if s is None else s)}")
            out.append(f"{name}_count{_prom_labels(labels)} "
                       f"{d['count']}")
    blocks = []
    for name in sorted(lines_by_name):
        blocks.append(f"# TYPE {name} {typed[name]}")
        blocks.extend(lines_by_name[name])
    return "\n".join(blocks) + ("\n" if blocks else "")


# ---------------------------------------------------------- chrome trace
#: pid offset for per-SHARD counter tracks in the Chrome export. On a
#: single-controller mesh one host process drives W device shards: the
#: host timeline is one process track (pid = rank), and the per-shard
#: row counts the exchange instants carry render as W extra counter
#: tracks at pids SHARD_PID_BASE + shard — so the merged trace shows
#: >= W rank tracks even before multihost gives genuinely distinct
#: host timelines.
SHARD_PID_BASE = 10000


def _chrome_sanitize(raw: list) -> list:
    """Enforce the Trace Event Format invariants the tests pin: events
    sorted by ``ts``; every ``B`` matched by an ``E`` (the ring buffer
    may have evicted a begin whose end survived — drop the orphan end;
    close still-open begins at the last timestamp) — per (pid, tid)."""
    raw.sort(key=lambda e: e.get("ts", 0.0))
    last_ts = raw[-1]["ts"] if raw else 0.0
    out, stacks = [], {}
    for e in raw:
        ph = e.get("ph")
        if ph == "B":
            stacks.setdefault((e["pid"], e["tid"]), []).append(e)
            out.append(e)
        elif ph == "E":
            st = stacks.get((e["pid"], e["tid"]))
            if not st:
                continue  # orphan end: its begin was ring-evicted
            st.pop()
            out.append(e)
        else:
            out.append(e)
    closers = []
    for (pid, tid), st in stacks.items():
        for b in reversed(st):  # innermost first: E nesting stays valid
            closers.append({"ph": "E", "pid": pid, "tid": tid,
                            "ts": max(last_ts, b["ts"]),
                            "name": b["name"], "cat": b.get("cat",
                                                            "span")})
    out.extend(closers)  # already >= every ts in out
    return out


def to_chrome_trace(buffers, world: "int | None" = None,
                    origin: "float | None" = None) -> dict:
    """Chrome Trace Event Format document from per-rank event buffers.

    ``buffers``: the :func:`cylon_tpu_torch.telemetry.trace.rank_buffers` /
    ``gather_traces`` shape — dicts of ``{"rank", "world",
    "clock_offset", "events"}`` — or a bare list of event dicts
    (treated as rank 0). One ``pid`` per rank (named ``rank <r>``),
    one ``tid`` per recording thread; span begin/ends become ``B``/``E``
    slice pairs, watchdog-section completes become ``X`` slices,
    instants ``i``, counter samples ``C`` counter tracks. Exchange
    instants carrying per-shard row counts additionally render one
    counter track per device shard (pid ``SHARD_PID_BASE + shard``) so
    a single-controller trace still shows every rank's data volume.

    Fleet process tracks: a buffer carrying a ``proc`` name
    (a router or engine process from
    ``FleetRouter.fleet_trace_buffers``) renders as its own process
    track — pid is the buffer's real OS ``pid`` when known, and the
    track is named after the process — so one artifact shows the
    router and every engine side by side on the router's clock.

    Timestamps are microseconds on rank 0's clock (each buffer's
    ``clock_offset`` is subtracted), after the earliest event or, given
    ``origin``, after that many seconds on the Unix clock, read on the
    recorder's clock as it stands at the export
    (:func:`cylon_tpu_torch.telemetry.trace.unix_skew`). ``origin`` set
    to a ``torch.profiler`` trace's ``baseTimeNanoseconds / 1e9`` puts
    both documents on one time axis: their ``traceEvents`` concatenate
    into one overlay. Everything is strict-JSON (``json_safe``); open in
    Perfetto / ``chrome://tracing``.
    """
    if buffers and isinstance(buffers, (list, tuple)) \
            and buffers and isinstance(buffers[0], dict) \
            and "kind" in buffers[0]:
        buffers = [{"rank": 0, "clock_offset": 0.0, "events": buffers}]
    raw, meta = [], []
    t0 = None
    for buf in buffers:
        off = float(buf.get("clock_offset", 0.0) or 0.0)
        for e in buf.get("events", ()):
            t = e["ts"] - off
            t0 = t if t0 is None else min(t0, t)
    if origin is None:
        t0 = t0 or 0.0
    else:
        from cylon_tpu_torch.telemetry import trace as _trace

        t0 = float(origin) - _trace.unix_skew()
    shard_tracks = set()
    for i, buf in enumerate(buffers):
        proc = buf.get("proc")
        if proc is not None:
            pid = buf.get("pid")
            # a proc buffer with no known OS pid gets a synthetic one
            # above the shard-track band so tracks never collide
            rank = (int(pid) if isinstance(pid, int)
                    else 2 * SHARD_PID_BASE + i)
            label = str(proc)
        else:
            rank = int(buf.get("rank", 0))
            label = f"rank {rank}"
        off = float(buf.get("clock_offset", 0.0) or 0.0)
        world = world or buf.get("world")
        meta.append({"ph": "M", "name": "process_name", "pid": rank,
                     "tid": 0, "ts": 0.0,
                     "args": {"name": label}})
        for e in buf.get("events", ()):
            us = (e["ts"] - off - t0) * 1e6
            tid = e.get("tid", 0)
            kind = e["kind"]
            cat = e.get("cat") or "span"
            args = dict(e.get("args") or {})
            # fleet trace-context stamps live at the event's top level
            # (not in args) — fold them in so a stitched artifact is
            # greppable/filterable by request trace id in Perfetto
            for ck in ("trace_id", "parent_span"):
                cv = e.get(ck)
                if cv is not None:
                    args.setdefault(ck, cv)
            if kind == "begin":
                raw.append({"ph": "B", "pid": rank, "tid": tid,
                            "ts": us, "name": e["name"], "cat": cat,
                            "args": args})
            elif kind == "end":
                raw.append({"ph": "E", "pid": rank, "tid": tid,
                            "ts": us, "name": e["name"]})
            elif kind == "complete":
                raw.append({"ph": "X", "pid": rank, "tid": tid,
                            "ts": us, "dur": e.get("dur", 0.0) * 1e6,
                            "name": e["name"], "cat": cat,
                            "args": args})
            elif kind == "counter":
                raw.append({"ph": "C", "pid": rank, "tid": tid,
                            "ts": us, "name": e["name"],
                            "args": {"value": e.get("value", 0)}})
            elif kind == "instant":
                raw.append({"ph": "i", "pid": rank, "tid": tid,
                            "ts": us, "name": e["name"], "cat": cat,
                            "s": "t", "args": args})
                shards = args.get("rows_shards")
                if shards:
                    for s, v in enumerate(shards):
                        pid = SHARD_PID_BASE + s
                        shard_tracks.add(s)
                        raw.append({"ph": "C", "pid": pid, "tid": 0,
                                    "ts": us,
                                    "name": args.get("counter",
                                                     "exchange.rows"),
                                    "args": {"value": v}})
    for s in sorted(shard_tracks):
        meta.append({"ph": "M", "name": "process_name",
                     "pid": SHARD_PID_BASE + s, "tid": 0, "ts": 0.0,
                     "args": {"name": f"shard {s}"}})
    doc = {"traceEvents": meta + _chrome_sanitize(raw),
           "displayTimeUnit": "ms"}
    if world:
        doc["otherData"] = {"world_size": int(world)}
    return json_safe(doc)


def chrome_trace_json(doc_or_buffers, world: "int | None" = None) -> str:
    """Strict-JSON text of a Chrome trace document (or of buffers,
    converted first). Documents from :func:`to_chrome_trace` are
    already ``json_safe`` — dumping directly avoids a second deep walk
    of a 64k-event trace; a hand-built document with non-finite values
    falls back through the coercion instead of raising."""
    doc = doc_or_buffers
    if not (isinstance(doc, dict) and "traceEvents" in doc):
        doc = to_chrome_trace(doc_or_buffers, world=world)
    try:
        return json.dumps(doc, allow_nan=False, separators=(",", ":"))
    except (TypeError, ValueError):
        return json.dumps(json_safe(doc), allow_nan=False,
                          separators=(",", ":"))


def write_chrome_trace(path: str, doc_or_buffers,
                       world: "int | None" = None) -> str:
    """Write a ``.trace.json`` artifact (atomic rename) and return its
    path — the file Perfetto / ``chrome://tracing`` opens directly."""
    text = chrome_trace_json(doc_or_buffers, world=world)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def metrics_dir() -> "str | None":
    """``CYLON_TPU_METRICS_DIR`` (read per call so tests can flip it)."""
    return os.environ.get("CYLON_TPU_METRICS_DIR") or None


def write_snapshot(snap: "dict | None" = None,
                   directory: "str | None" = None,
                   reason: str = "flush") -> "str | None":
    """Append one JSONL snapshot record to
    ``<dir>/metrics-<pid>.jsonl`` and rewrite the companion
    ``metrics-<pid>.prom`` Prometheus dump. Returns the JSONL path, or
    None when no directory is configured. Export failures are logged,
    never raised — telemetry must not fail the workload."""
    from cylon_tpu_torch.telemetry import registry as _r

    directory = directory or metrics_dir()
    if not directory:
        return None
    snap = _r.snapshot() if snap is None else snap
    rec = {"ts": time.time(), "pid": os.getpid(), "reason": reason,
           "metrics": snap}
    path = os.path.join(directory, f"metrics-{os.getpid()}.jsonl")
    try:
        # serialised: the interval-writer daemon and the atexit flush
        # can overlap at interpreter shutdown, and two writers on one
        # tmp path would interleave into a garbled .prom dump
        with _WRITE_LOCK:
            os.makedirs(directory, exist_ok=True)
            with open(path, "a") as f:
                f.write(snapshot_to_json(rec) + "\n")
            prom = os.path.join(directory,
                                f"metrics-{os.getpid()}.prom")
            tmp = f"{prom}.tmp{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(to_prometheus(snap))
            os.replace(tmp, prom)
    except Exception as e:
        # never raise: serialization surprises (a gauge set to a
        # non-JSON value raises TypeError from json.dumps, ValueError
        # from the Prometheus float()) must not kill the interval
        # writer thread or surface at atexit, any more than an OSError
        from cylon_tpu_torch.utils.logging import get_logger

        get_logger().warning("telemetry export to %s failed: %s",
                             directory, e)
        return None
    return path


_ARM_LOCK = threading.Lock()
_ARMED: "set[int]" = set()
_WRITE_LOCK = threading.Lock()


def arm_exporters(reg) -> None:
    """Install the atexit flush (and the periodic writer when
    ``CYLON_TPU_METRICS_INTERVAL`` > 0) for ``reg``. Called lazily by
    the registry on first instrument creation, and only when
    ``CYLON_TPU_METRICS_DIR`` is set — a process that never configures
    a directory never reaches here."""
    with _ARM_LOCK:
        if id(reg) in _ARMED:
            return
        _ARMED.add(id(reg))
    import atexit

    atexit.register(
        lambda: write_snapshot(reg.snapshot(), reason="atexit"))
    try:
        interval = float(os.environ.get("CYLON_TPU_METRICS_INTERVAL",
                                        "0"))
    except ValueError:
        interval = 0.0
    if interval > 0:
        def _loop():
            from cylon_tpu_torch.telemetry import timeseries

            while True:
                time.sleep(interval)
                write_snapshot(reg.snapshot(), reason="interval")
                try:
                    # the interval daemon doubles as the windowed-
                    # history cadence: one delta sample per
                    # flush, so /metrics/window and rate() have data
                    # even when nothing polls the endpoints
                    timeseries.sample()
                except Exception:  # pragma: no cover - never kill it
                    pass

        threading.Thread(target=_loop, name="cylon-tpu-metrics",
                         daemon=True).start()


#: counter names every bench record's ``metrics`` block must carry —
#: the schema the JAX package's ``tests/test_bench_guard.py`` pins, kept
#: as it is so that no change can silently drop telemetry from the perf
#: trajectory. Values default to 0 when the metric never fired in the
#: run.
REQUIRED_BENCH_KEYS = (
    "exchange.calls",
    "exchange.bytes_true",
    "exchange.bytes_padded",
    "exchange.rows",
    "exchange.tight_dispatches",
    "exchange.fallback_regrows",
    "plan.overflow_events",
    "plan.capacity_rescales",
    "plan.compile_count",
    "resilience.retries",
    "resilience.faults_injected",
    "spill.read_bytes",
    "spill.write_bytes",
    "ooc.fallbacks",
    "ooc.merge_phases",
    "ooc.prefetch_hits",
    "ooc.prefetch_misses",
    "ooc.overlap_seconds",
    "ooc.units_resumed",
    "watchdog.sections_expired",
)


def bench_metrics() -> dict:
    """Compact registry view for embedding in bench JSON records:
    every :data:`REQUIRED_BENCH_KEYS` counter summed across its label
    series (0 if never fired), the WORST (max) ``exchange.pad_ratio``
    and ``exchange.headroom_ratio`` across their series, and
    per-section timer totals. Strict-JSON-safe by construction."""
    from cylon_tpu_torch.telemetry import registry as _r

    out = {k: _r.total(k) for k in REQUIRED_BENCH_KEYS}
    # the run's device-memory high-water mark (telemetry.memory) — absent when
    # sampling never ran
    from cylon_tpu_torch.telemetry import memory as _memory

    peak = _memory.peak_live_bytes()
    if peak is not None:
        out["memory.peak_bytes"] = json_safe(peak)
    for gname in ("exchange.pad_ratio", "exchange.headroom_ratio"):
        ratios = []
        for _, _, inst in _r.instruments(gname):
            try:  # per-value coercion: one bad gauge must not cost
                v = json_safe(float(inst.value))  # the whole block
            except (TypeError, ValueError):
                continue
            if v is not None:
                ratios.append(v)
        if ratios:
            out[gname] = max(ratios)
    sections = {}
    for _, labels, inst in _r.instruments("watchdog.section_seconds"):
        sec = labels.get("section", "?")
        # a section split across tenant-labeled series (the serve
        # layer) merges per section name — counts/totals add, max is
        # max — so no series silently vanishes from the block
        s = sections.setdefault(sec, {"count": 0, "total_s": 0.0,
                                      "max_s": None})
        s["count"] += inst.count
        tot = json_safe(float(inst.sum))
        if tot is not None:
            s["total_s"] += tot
        mx = json_safe(inst.max)
        if mx is not None:
            s["max_s"] = mx if s["max_s"] is None else max(s["max_s"], mx)
    if sections:
        out["watchdog.sections"] = sections
    return out
