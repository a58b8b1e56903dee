"""Reading a ``torch.profiler`` trace of the window: the device's busy time
(the union of the intervals in which something ran on the card, as
``chip_smoke.profile_call`` takes it), the device time by operation, and
the device's idle gaps named by the host range open during each.

Read from the profiler's raw kineto events, which are many (thousands a
TPC-H query) and cost far less to walk than ``prof.events()``.
"""

import bisect
import dataclasses
import itertools

#: the name of an idle gap that falls outside every host range
BETWEEN = "bench.between_ops"

#: kineto activity types of work on the card; its ``gpu_user_annotation``
#: ranges only mirror host ranges and are left out (so is any device
#: event named as a host range)
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    #: merged device intervals inside the window, ns
    busy: list
    #: (start, end) of the window, ns
    window: tuple
    #: device seconds by operation name
    by_op: dict
    #: idle seconds by the innermost host range open in the gap
    idle_by_span: dict

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        ops = {}
        for name, s in self.by_op.items():
            short = short_name(name)
            ops[short] = ops.get(short, 0.0) + s
        return {"device_ops": head(ops), "idle_gaps": head(self.idle_by_span)}


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void``, its argument list and, past
    ``limit`` characters, the rest of its template arguments."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:k]
            break
    return name[:limit]


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo, hi) -> list:
    """The idle intervals of ``[lo, hi)`` between merged ``busy`` ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def innermost(spans, starts, reach, t) -> str:
    """The name of the range open at ``t`` that opened last (ranges nest
    on the one host thread); ``spans`` sorted by start, ``starts`` their
    starts, ``reach[k]`` the latest end among ``spans[:k + 1]``."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0 and reach[k] >= t:
        s, e, name = spans[k]
        if e >= t:
            return name
        k -= 1
    return BETWEEN


def read(device_events, host_ranges, window) -> Trace:
    """``device_events``: ``(start_ns, end_ns, name)`` of each device
    operation; ``host_ranges``: the same of each host profiler range;
    ``window``: its ``(start, end)``."""
    lo, hi = window
    seen = set(device_events)
    by_op = {}
    for s, e, name in seen:
        if e > lo and s < hi:
            by_op[name] = by_op.get(name, 0.0) \
                + (min(e, hi) - max(s, lo)) / 1e9
    busy = merge(clip([(s, e) for s, e, _ in seen], lo, hi))
    spans = sorted(host_ranges)
    starts = [s for s, _, _ in spans]
    reach = list(itertools.accumulate((e for _, e, _ in spans), max))
    idle = {}
    for s, e in gaps(busy, lo, hi):
        name = innermost(spans, starts, reach, (s + e) / 2)
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    return Trace(busy=busy, window=window, by_op=by_op, idle_by_span=idle)


def _classify(ev, cuda) -> "str | None":
    """``"device"`` for work on the card, ``"host"`` for a host profiler
    range, else None. Newer kineto events name their activity type;
    older ones tell a range by ``is_user_annotation`` and the card by the
    device type (where a range's mirror on the card is a user annotation
    too)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = kind()
        if kind in DEVICE_ACTIVITIES:
            return "device"
        return "host" if kind == "user_annotation" else None
    annotation = ev.is_user_annotation()
    if ev.device_type() == cuda:
        return None if annotation else "device"
    return "host" if annotation else None


def from_profiler(prof) -> Trace:
    """The window's trace from a finished ``torch.profiler.profile``: the
    window runs from the first ``bench.op`` range's start to the last
    one's end."""
    from torch.autograd import DeviceType

    rows = {"device": [], "host": []}
    for ev in prof.profiler.kineto_results.events():
        side = _classify(ev, DeviceType.CUDA)
        if side is not None:
            start = ev.start_ns()
            rows[side].append((start, start + ev.duration_ns(), ev.name()))
    host = rows["host"]
    ranges = {name for _, _, name in host}
    device = [r for r in rows["device"] if r[2] not in ranges]
    ops = [r for r in host if r[2] == "bench.op"]
    if not ops:
        raise RuntimeError("the trace holds no bench.op range")
    if not device:
        raise RuntimeError("the trace holds no device operation")
    window = (min(s for s, _, _ in ops), max(e for _, e, _ in ops))
    return read(device, host, window)
