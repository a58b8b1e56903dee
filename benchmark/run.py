"""Run one cell of ``BENCHMARK.json`` once, and print its result line.

    python3 benchmark/run.py --workload join_16m.sort --seed 7 \\
        --seconds 40 --trace 0

From the root of a checkout. Set-up (the card, the kernel library, the
inputs made on the device from ``--seed``, the program's tables and a
warm-up of every shape the cell uses) runs first; then a closed loop
measures for ``--seconds``; then, with the program's state let go, the
reference checks what the timed calls produced. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones from a
profiler trace of the window. The last line of standard output is one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit. ``--control 1`` puts the reference, in the next
lower precision that the configuration names (``control_precision``),
in the program's place (the check must then fail).

No CUDA card, fewer cards than the cell asks for, or JAX (or the JAX
package) in the process once the window has closed: the run prints no
result and exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = ROOT / ".bench_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}

#: top-level modules that may not be loaded in a run (compared whole:
#: ``cylon_tpu_torch`` is not ``cylon_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "cylon_tpu")

EXIT_NO_RESULT = 3

#: a traced run profiles the window's first seconds only: reading a
#: profile costs seconds for each second profiled
TRACE_SECONDS = 10.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric reader reads: the window, the set-up, the memory, the
    trace and the program's counters and spans over the window."""

    def __init__(self, window, setup_s, peak_bytes, workload, bandwidth,
                 trace=None, telemetry_delta=None):
        self.window, self.setup_s = window, setup_s
        self.peak_bytes, self.workload = peak_bytes, workload
        self.bandwidth, self.trace = bandwidth, trace
        self._delta = telemetry_delta

    @property
    def records(self) -> list:
        return self.window.records

    @property
    def traced(self) -> list:
        """The operations of the traced part of the window."""
        return [r for r in self.window.records if r.traced]

    @property
    def syncs(self):
        return self.window.syncs

    def counter(self, name: str, **labels):
        """The program counter's increase over the window, over its series
        that carry ``labels`` (None: the program's telemetry was not
        read)."""
        if self._delta is None:
            return None
        return sum(d["value"] for d in self._delta.values()
                   if d["name"] == name and d["type"] == "counter"
                   and labels.items() <= d["labels"].items())

    def span(self, name: str):
        """``(count, seconds)`` of the program's span ``name`` over the
        window, or None."""
        if self._delta is None:
            return None
        hits = [d for d in self._delta.values()
                if d["name"] == "tracing.span_seconds"
                and d["labels"].get("name") == name]
        if not hits:
            return None
        return (sum(d["count"] for d in hits), sum(d["sum"] for d in hits))

    def least_seconds(self, records) -> float:
        """The least time ``records``' operations need: their bytes over
        the card's memory rate."""
        return sum(self.workload.least_bytes(r.index)
                   for r in records) / self.bandwidth


def measure(cell, seed: int, seconds: float, trace: bool, device,
            control: bool = False, t0: float = T0,
            bandwidth: float = 0.0) -> dict:
    """One run of ``cell`` on ``device``: ``{"metrics", "memory_peak_bytes",
    "attempted", "failed", "checks", "correct", "trace"}``.
    ``memory_peak_bytes`` is the most the process held on the card over
    the run (``max_memory_reserved``: the peak stats are reset after
    set-up, and a reset leaves it at what is held then). ``build_s`` is
    the part of set-up that built the program's kernel library: a
    checkout's first run builds it, later runs load it (0)."""
    import torch

    from benchmark.harness import loop
    from benchmark.harness import trace as tracing

    cuda = torch.device(device).type == "cuda"
    w = cell.kind.Workload(cell.config, cell.traffic, seed, device)
    telemetry, build_s = None, 0.0
    if control:
        op = w.control_op(cell.reference, getattr(
            torch, cell.config["control_precision"]))
    else:
        t = time.perf_counter()
        w.setup()
        from cylon_tpu_torch import telemetry
        from cylon_tpu_torch.kernels import build

        build_s = build.last_build.get("seconds", 0.0)
        print(f"set-up: {t - t0:.3f} s to the program's set-up, "
              f"{time.perf_counter() - t:.3f} s in it, of which "
              f"{build_s:.3f} s built the kernel library", file=sys.stderr)
        op = w.op
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = telemetry.snapshot() if telemetry else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    window = loop.run(op, sync, w.keep, w.label, seconds, torch,
                      TRACE_SECONDS if trace else None,
                      lambda: prof.__exit__(None, None, None))
    delta = telemetry.delta(before) if telemetry else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    held = torch.cuda.max_memory_reserved() if cuda else 0
    tr = tracing.from_profiler(prof) if prof is not None else None
    del prof
    ctx = Context(window, window.start - t0, peak, w, bandwidth, tr, delta)
    metrics = {}
    for entry, reader in cell.metrics:
        value = reader.read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    w.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = w.check(cell.reference)
    limits = cell.config["limits"]
    raised = sum(r.failed for r in window.records)
    correct = (raised == 0 and failed == 0 and set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))
    return {"metrics": metrics, "memory_peak_bytes": held,
            "build_s": build_s,
            "attempted": len(window.records), "failed": raised + failed,
            "checks": {k: {"value": numbers.get(k), "limit": limits[k]}
                       for k in limits},
            "correct": bool(correct), "trace": tr}


def result_line(out: dict, dev: dict, chips: int,
                control: "str | None" = None) -> dict:
    """The run's last line: the driver's keys, then the seconds of
    set-up that built the kernel library, the card's name and power
    limit, then the numbers compared beside their limits (last)."""
    device = {"platform": "gpu", "kind": dev["name"], "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if out["trace"] is not None:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        line["breakdown"] = out["trace"].breakdown()
    line["build_s"] = out["build_s"]
    line["card"] = {"name": dev["name"], "power_limit": dev["power_limit"]}
    if control is not None:
        line["control"] = control
    line["checks"] = out["checks"]
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    args = parse(argv)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE_DIR / sub)
    from benchmark.harness import card, cell as cells

    cell = cells.resolve(args.workload, bool(args.trace))
    os.environ.update(cell.traffic.get("env", {}))
    t = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_RESULT
    dev = card.describe(torch)
    torch.zeros(1, device="cuda")
    print(f"start: {t - T0:.3f} s to import torch, {t_torch - t:.3f} s "
          f"in it, {time.perf_counter() - t_torch:.3f} s to the card's "
          f"first tensor", file=sys.stderr, flush=True)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  control=bool(args.control), bandwidth=dev["bandwidth"])
    dev["power_limit"] = card.power_limit()
    print(f"card: {dev['name']}, power limit {dev['power_limit']}, "
          f"{dev['cards_present']} present, {cell.chips} used",
          file=sys.stderr, flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"run: forbidden modules loaded: {loaded}", file=sys.stderr)
        return EXIT_NO_RESULT
    line = result_line(out, dev, cell.chips,
                       cell.config["control_precision"]
                       if args.control else None)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
