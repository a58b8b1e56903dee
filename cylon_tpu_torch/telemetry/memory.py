"""Device memory accounting: live-bytes gauges, per-op peak
watermarks, and OOM forensics.

Port of ``cylon_tpu/telemetry/memory.py``. The engine's scale ceiling is
device memory, yet nothing else in the system answers "how much device
memory is resident right now, and who owns it?" — a CUDA allocation
failure names its size but none of the consumers that crowded it out.
Three pieces close that:

* :func:`device_bytes` / :func:`sample` — per-device live bytes. On
  the cards, the caching allocator's count,
  ``torch.cuda.memory_allocated(i)`` for each visible card, keyed
  ``cuda:<i>``: a host-side read, no device sync. Without a card, a
  walk of the live CPU tensors (found through :mod:`gc`, each storage
  counted once), keyed ``cpu:0``. :func:`sample` publishes
  ``memory.live_bytes{device=}`` gauges, the process-wide
  ``memory.peak_bytes`` high-water mark, and — when called with an
  ``op=`` — the per-op watermark ``memory.peak_bytes{op=}``. Samples
  are taken at *stage boundaries* (eager exchange dispatches, the
  compiled query's dispatch and fetch), never inside device code.

* :func:`watermark` — context manager bracketing one op with
  before/after samples, for callers outside the instrumented layers.

* :func:`forensics` / :func:`oom_report` — when an allocation path
  fails (:func:`is_oom` recognises ``torch.cuda.OutOfMemoryError``,
  "CUDA out of memory" and the host's shapes), the forensics scope
  logs ONE warning naming the top resident consumers — compiled-query
  memo entries, spill byte totals, the largest live CUDA tensors —
  and re-raises. The report is also available programmatically.

Fast-path contract: sampling is gated by ``CYLON_TPU_MEMORY_SAMPLING``
(default ON — one gauge write per device per stage boundary; ``0``
disables every sample to a single env read). Only ``force=True`` and
:func:`watermark` may walk the CPU tensors; the hot, unforced
:func:`sample` never does. No threads, no file handles, ever.
"""

import contextlib
import gc
import os

from cylon_tpu_torch.telemetry import registry as _r

__all__ = [
    "enabled", "device_bytes", "live_bytes", "sample", "watermark",
    "peak_live_bytes", "accumulate_tensor_bytes", "is_oom",
    "oom_report", "format_oom_report", "forensics",
]


def enabled() -> bool:
    """Is stage-boundary sampling on? (``CYLON_TPU_MEMORY_SAMPLING``,
    default yes — one env read, the entire off-path cost.)"""
    return os.environ.get("CYLON_TPU_MEMORY_SAMPLING", "1") not in (
        "0", "off", "false")


def _device_key(d) -> str:
    """``cuda:<i>`` / ``cpu:0`` for a ``torch.device``."""
    return f"{d.type}:{0 if d.index is None else d.index}"


def _storage_key(t):
    """(device key, storage address) of a tensor: views of one storage
    share it, so a walk counts each storage once."""
    st = t.untyped_storage()
    return _device_key(t.device), st.data_ptr(), st.nbytes()


def accumulate_tensor_bytes(t, out: dict, seen: "set | None" = None) -> None:
    """Add one tensor's storage bytes into ``out`` keyed per device
    (:func:`_device_key`) — metadata only, no sync, no transfer; numpy
    arrays land under ``"host"``. ``seen`` holds the storages already
    counted, so that views of one storage count once."""
    import torch

    if isinstance(t, torch.Tensor):
        try:
            key, ptr, nbytes = _storage_key(t)
        except Exception:  # a meta / freed tensor has no storage
            return
        if seen is not None:
            if (key, ptr) in seen:
                return
            seen.add((key, ptr))
        out[key] = out.get(key, 0) + int(nbytes)
        return
    out["host"] = out.get("host", 0) + int(
        getattr(t, "nbytes", t.size * t.dtype.itemsize))


def _live_tensors(device_type: "str | None" = None) -> list:
    """The live tensors the garbage collector tracks (optionally only
    those on ``device_type``). O(objects): only forced samples,
    :func:`watermark` and :func:`oom_report` call it."""
    import torch

    out = []
    for o in gc.get_objects():
        # the type, not isinstance: isinstance reads ``__class__``, which
        # some module-level proxies answer with a deprecation warning
        if not issubclass(type(o), torch.Tensor):
            continue
        try:
            if device_type is None or o.device.type == device_type:
                out.append(o)
        except Exception:  # an object half torn down mid-walk
            continue
    return out


def _cpu_walk_bytes() -> int:
    """Live CPU tensor bytes, each storage counted once."""
    acc: dict = {}
    seen: set = set()
    for t in _live_tensors("cpu"):
        accumulate_tensor_bytes(t, acc, seen)
    return acc.get("cpu:0", 0)


def _allocator_bytes() -> "dict[str, int] | None":
    """Per-card live bytes from the CUDA caching allocator ONLY —
    ``torch.cuda.memory_allocated(i)``, O(cards), a host-side read with
    no device sync. None without a card, i.e. when only the expensive
    CPU walk of :func:`device_bytes` could answer."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


def device_bytes() -> "dict[str, int]":
    """Live bytes per device, ``{"cuda:0": n, ...}``.

    On the cards, the CUDA caching allocator's count for each visible
    card (exact, O(cards), no sync). Without a card, ``{"cpu:0": n}``
    from a walk of the live CPU tensors, each storage counted once —
    O(live objects), still no sync or transfer.
    """
    per = _allocator_bytes()
    if per is not None:
        return per
    return {"cpu:0": _cpu_walk_bytes()}


def live_bytes() -> int:
    """Total live bytes across devices (one :func:`device_bytes`)."""
    return sum(device_bytes().values())


def _raise_watermark(gauge, v: int) -> None:
    """Monotone gauge update: the watermark only ever rises (the
    read-modify-write holds the instrument's own lock, so concurrent
    samplers cannot regress it)."""
    with gauge._lock:
        if gauge.value is None or v > gauge.value:
            gauge.value = v


#: throttle state: (last sample monotonic ts, last total). Hot layers
#: (one exchange dispatch can fire thousands of times a second in a
#: chunked pass) call :func:`sample` freely; the walk itself runs at
#: most once per :data:`SAMPLE_INTERVAL_S` — in between, watermarks
#: update from the cached total at dict-write cost.
_THROTTLE = [0.0, 0]  # unlocked: a race costs one extra sample

#: seconds between two unforced samples' reads (the JAX package reads
#: it from ``CYLON_TPU_MEMORY_SAMPLE_INTERVAL``; no workload of the port
#: sets another value)
SAMPLE_INTERVAL_S = 0.25


def sample(op: "str | None" = None, force: bool = False) -> int:
    """One stage-boundary sample: publish ``memory.live_bytes{device=}``
    gauges, raise the process ``memory.peak_bytes`` watermark (and the
    ``memory.peak_bytes{op=}`` watermark when ``op`` is given), return
    the total. No-op returning 0 when sampling is disabled.

    Cost discipline: an unforced call (the hot paths — one per eager
    exchange dispatch, per OOC unit) is throttled
    (:data:`_THROTTLE`) AND restricted to the O(devices) allocator
    read — on the CPU, which keeps no allocator stats, it reuses the
    last forced walk's total rather than paying (and jittering op
    walls by) an O(live-tensors) scan. ``force=True`` (serve step
    boundaries, :func:`watermark` brackets) always takes the full
    :func:`device_bytes` view."""
    import time

    if not enabled():
        return 0
    now = time.monotonic()
    if not force and now - _THROTTLE[0] < SAMPLE_INTERVAL_S:
        total = _THROTTLE[1]
        if op is not None and total:
            _raise_watermark(_r.gauge("memory.peak_bytes", op=op),
                             total)
        return total
    if force:
        per = device_bytes()
    else:
        per = _allocator_bytes()
        if per is None:  # no allocator stats: hot path stays cheap
            total = _THROTTLE[1]
            if op is not None and total:
                _raise_watermark(
                    _r.gauge("memory.peak_bytes", op=op), total)
            return total
    total = 0
    for dev, n in per.items():
        _r.gauge("memory.live_bytes", device=dev).set(n)
        total += n
    _THROTTLE[0], _THROTTLE[1] = now, total
    _raise_watermark(_r.gauge("memory.peak_bytes"), total)
    if op is not None:
        _raise_watermark(_r.gauge("memory.peak_bytes", op=op), total)
    return total


def peak_live_bytes(op: "str | None" = None) -> "int | None":
    """The recorded high-water mark (process-wide, or one op's) — None
    when never sampled."""
    g = (_r.metric("memory.peak_bytes") if op is None
         else _r.metric("memory.peak_bytes", op=op))
    return None if g is None else g.value


@contextlib.contextmanager
def watermark(op: str):
    """Bracket one op with before/after samples (unthrottled) so its
    peak watermark is recorded even when nothing inside it samples."""
    sample(op=op, force=True)
    try:
        yield
    finally:
        sample(op=op, force=True)


# ------------------------------------------------------- OOM forensics
#: message fragments that identify an allocation failure across the
#: backends this engine meets: CUDA ("CUDA out of memory",
#: ``torch.cuda.OutOfMemoryError``, cudaErrorMemoryAllocation's "out of
#: memory"), host numpy (_ArrayMemoryError "Unable to allocate") and
#: the C++ allocator (bad_alloc), and raw MemoryError.
_OOM_MARKS = ("cuda out of memory", "out of memory",
              "outofmemoryerror", "resource_exhausted",
              "oom when allocating", "unable to allocate",
              "bad_alloc", "memory exhausted")


def is_oom(exc: BaseException) -> bool:
    """Does ``exc`` look like an allocation failure?"""
    if isinstance(exc, MemoryError):
        return True
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in _OOM_MARKS)


def oom_report(limit: int = 8) -> dict:
    """Name the top resident consumers — the dump an OOM needs next to
    the allocator's "tried to allocate N bytes" line:

    - ``devices``: live bytes per device (:func:`device_bytes`),
    - ``tables``: the ``limit`` largest catalog tables (id, bytes,
      rows, pins, holders — a pinned table cannot be evicted, which is
      exactly why its holders are named), from
      :func:`cylon_tpu_torch.catalog.stats` with ``version=False``, so
      no table is fetched to the host for a digest
      (``cylon_tpu/telemetry/memory.py:264-293``),
    - ``plan_cache``: compiled-query memo occupancy
      (:func:`cylon_tpu_torch.plan.plan_cache_stats` + per-query entry
      counts),
    - ``spill``: cumulative spill read/write bytes (the pressure valve
      that *was* available),
    - ``top_arrays``: the ``limit`` largest live CUDA tensors by
      storage bytes (shape/dtype/device), each storage once,
    - ``peak_bytes``: the recorded high-water mark.
    """
    from cylon_tpu_torch import catalog

    rep: dict = {"devices": device_bytes()}
    tables = []
    try:
        for tid, st in catalog.stats(version=False).items():
            tables.append({"id": tid, "bytes": st["bytes"],
                           "rows": st["rows"], "pins": st["pins"],
                           "holders": st["holders"]})
    except Exception:  # catalog stats must never fail the report
        pass
    tables.sort(key=lambda t: -(t["bytes"] or 0))
    rep["tables"] = tables[:limit]
    try:
        from cylon_tpu_torch import plan

        stats = plan.plan_cache_stats()
        stats["entries_per_query"] = {
            getattr(fn, "__name__", "?"): len(cq._scale_memo)
            for (fn, _), cq in list(plan._SHARED.items())}
        rep["plan_cache"] = stats
    except Exception:
        rep["plan_cache"] = {}
    rep["spill"] = {"read_bytes": _r.total("spill.read_bytes"),
                    "write_bytes": _r.total("spill.write_bytes")}
    arrays = []
    try:
        seen: set = set()
        live = []
        for t in _live_tensors("cuda"):
            key, ptr, nbytes = _storage_key(t)
            if (key, ptr) in seen:
                continue
            seen.add((key, ptr))
            live.append((int(nbytes), t))
        live.sort(key=lambda p: -p[0])
        for nbytes, t in live[:limit]:
            arrays.append({"bytes": nbytes, "shape": list(t.shape),
                           "dtype": str(t.dtype),
                           "devices": _device_key(t.device)})
    except Exception:
        pass
    rep["top_arrays"] = arrays
    rep["peak_bytes"] = peak_live_bytes()
    return rep


def format_oom_report(rep: "dict | None" = None) -> str:
    """Human-readable rendering of :func:`oom_report` (the warning-log
    payload)."""
    rep = oom_report() if rep is None else rep
    lines = ["resident-memory forensics:"]
    for dev, n in sorted(rep.get("devices", {}).items()):
        lines.append(f"  device {dev}: {n} bytes live")
    for t in rep.get("tables", []):
        pin = (f" pinned by {t['holders']}" if t.get("pins") else "")
        lines.append(f"  table {t['id']!r}: {t['bytes']} bytes, "
                     f"rows={t['rows']}{pin}")
    pc = rep.get("plan_cache") or {}
    if pc:
        lines.append(f"  plan cache: {pc.get('shared_queries', 0)} "
                     f"shared queries, entries "
                     f"{pc.get('entries_per_query', {})}")
    sp = rep.get("spill", {})
    lines.append(f"  spill: {sp.get('read_bytes', 0)} read / "
                 f"{sp.get('write_bytes', 0)} written bytes")
    for a in rep.get("top_arrays", []):
        lines.append(f"  array {a['shape']} {a['dtype']} on "
                     f"{a['devices']}: {a['bytes']} bytes")
    if rep.get("peak_bytes") is not None:
        lines.append(f"  peak live bytes: {rep['peak_bytes']}")
    return "\n".join(lines)


@contextlib.contextmanager
def forensics(point: str):
    """Wrap an allocation path: an exception :func:`is_oom` recognises
    increments ``memory.oom_events{point=}``, logs ONE warning with
    the :func:`format_oom_report` dump, ATTACHES the report to the
    exception (``e.oom_report`` dict + the rendered text appended to
    the message — so a raised ResourceExhausted names its crowd, not
    just its size, and the serve profile can embed it), then
    re-raises. Nested scopes count per point but attach/log only once
    (the innermost scope wins). Non-OOM errors pass through
    untouched."""
    try:
        yield
    except BaseException as e:
        if is_oom(e):
            _r.counter("memory.oom_events", point=point).inc()
            from cylon_tpu_torch.telemetry import events as _events

            _events.emit("oom", point=point, error=type(e).__name__)
            if getattr(e, "oom_report", None) is None:
                try:
                    rep = oom_report()
                    text = format_oom_report(rep)
                except Exception:  # forensics must never mask the OOM
                    rep = text = None
                if text is not None:
                    # the log and the attach fail INDEPENDENTLY: a
                    # closed stream must not cost the attachment, an
                    # attr-refusing exception class must not cost the
                    # dump
                    try:
                        from cylon_tpu_torch.utils.logging import get_logger

                        get_logger().warning(
                            "allocation failure in %s (%s: %s)\n%s",
                            point, type(e).__name__, e, text)
                    except Exception:
                        pass
                if rep is not None:
                    try:
                        e.oom_report = rep
                        # append the dump to the MESSAGE too: whoever
                        # logs str(e) — a bench record, a client
                        # traceback — sees the consumers without
                        # knowing the attribute
                        if e.args and isinstance(e.args[0], str):
                            e.args = (e.args[0] + "\n" + text,) \
                                + e.args[1:]
                        elif not e.args:
                            e.args = (text,)
                    except Exception:
                        pass
        raise
