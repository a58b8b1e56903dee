"""The closed loop: one caller, each operation issued once the previous
one's result is complete on the device, for a fixed number of seconds.

Every operation that starts inside the window is run to its end and
counted; the window closes when the last of them completes. In a traced
run the operations that start in the window's first ``trace_seconds``
run each inside a ``bench.op`` profiler range, the wait for the device
inside ``bench.wait``, and the synchronising calls they make are counted
(``count_syncs``); then ``stop_trace()`` ends the profile (its reading
costs far more than the window's seconds beyond) and the loop goes on
untraced.
"""

import dataclasses
import sys
import time
import warnings


@dataclasses.dataclass
class Record:
    index: int
    label: str
    start: float
    end: float
    failed: bool = False
    traced: bool = False

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    start: float
    records: list
    syncs: "int | None" = None

    @property
    def seconds(self) -> float:
        """From the window's start to the end of its last operation."""
        return self.records[-1].end - self.start


class count_syncs:
    """Counts the calls that wait for the card inside the ``with`` block,
    under ``torch.cuda.set_sync_debug_mode("warn")``: each such call warns
    once (the arithmetic of ``chip_smoke.count_syncs``, by count alone)."""

    def __init__(self, torch):
        self.torch, self.count = torch, 0

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.count = sum("synchroniz" in str(w.message) for w in self._seen)
        return False


def run(op, sync, keep, label, seconds: float, torch=None,
        trace_seconds: "float | None" = None, stop_trace=None) -> Window:
    """``op(i)`` back to back for ``seconds``, ``sync()`` after each, then
    ``keep(i, result)``. An operation that raises is recorded as failed.
    With ``trace_seconds``, ``torch`` is the torch module, for the ranges
    and the sync count, and ``stop_trace()`` is called once they end."""
    records, syncs = [], 0
    tracing = trace_seconds is not None
    if tracing:
        from torch.profiler import record_function
    start = time.perf_counter()
    close = start + seconds
    i = 0
    while True:
        t = time.perf_counter()
        if t >= close:
            break
        if tracing and t >= start + trace_seconds:
            stop_trace()
            tracing = False
            t = time.perf_counter()
        out, failed = None, False
        try:
            if tracing:
                with record_function("bench.op"):
                    with count_syncs(torch) as c:
                        out = op(i)
                    syncs += c.count
                    with record_function("bench.wait"):
                        sync()
            else:
                out = op(i)
                sync()
        except Exception as exc:  # the program's fault: the run goes on
            failed = True
            print(f"operation {i} ({label(i)}) failed: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr,
                  flush=True)
        records.append(Record(i, label(i), t, time.perf_counter(), failed,
                              tracing))
        if not failed:
            keep(i, out)
        del out
        i += 1
    if tracing:
        stop_trace()
    return Window(start, records,
                  syncs if trace_seconds is not None else None)
