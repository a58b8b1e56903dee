"""Drive the PyTorch/CUDA port (``cylon_tpu_torch``) on one NVIDIA GPU
and check it.

    python3 chip_smoke.py             # every phase; exit 0 only if all pass
    python3 chip_smoke.py --profile   # also trace a bench stage, a hash
                                      # join, a high-cardinality group-by,
                                      # the 100M sort and a 16M intersect

Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``cylon_tpu_torch/csrc`` (``nvcc``);
3. kernels: every kernel against its plain PyTorch version on the same
   CUDA tensors, bit for bit, at the main paths' shapes (``row_hash`` also
   at 18 words; ``scan32`` in every kind: int32 add and max, uint32 add
   that wraps, float32 max with NaNs and zeros of both signs, and float32
   add against ``torch.cumsum`` within ``F32_ADD_RTOL`` and bit for bit
   against a second call; ``bucket_probe`` on an int64 key, which takes
   its one-load path, and on a nullable int64 key and two int32 columns,
   which compare word by word; the bucket kernels also on an overflowing
   and an all-duplicate build; ``bucket_build`` also at widths 1 and 30,
   below one tile, at nb = 4 cap, with ids past nb, on no rows, on a
   ragged last chunk, on the global-counter path (nb 64M) and with one
   bucket holding 1 % of 16M rows, each build also against a second call,
   the 16M builds with their device time by pass and peak memory;
   ``pair_max_scan`` also on no marks, a mark on every element, one mark
   at element 0, ties on hi that lo decides and hi and lo at or above
   2^31, at every shape and at its dispatch threshold and one pair on
   each side of it, so that both of its paths run, and a look-back call
   after a three-pass one whose carries read as the next call's flags);
   the time per call of the kernel, the plain
   version and one PyTorch library call (where one computes the same
   function), by CUDA events over calls back to back and as device time
   from torch.profiler, beside the memory bound; then the whole join on
   the card against the same join on the CPU (plain versions) on a small
   input, for the sort join and both routes of ``algorithm="hash"``, and
   a join with an empty side (capacity 0, and no valid row in a capacity
   of 8) in every ``how`` by both algorithms;
4. dist_join: the public entry point at a world of one rank on 16M x 16M
   rows (the per-rank share of the reference's 1B-row, 64-rank run),
   checked against numpy: the row count exactly, the checksum
   sum(v_l * v_r) at rtol 1e-9;
5. hash_join: the same entry point with ``algorithm="hash"`` and
   ``CYLON_TPU_JOIN_HASH_IMPL=bucketed`` (bucket_build / bucket_probe) on
   a 16M-row dimension table (unique keys) joined to a 16M-row fact
   table, checked against numpy as phase 4, the launches checked, and the
   sort join's wall on the same tables beside it;
6. bench: the port of ``bench.py``'s exchange-inclusive pipeline (1M rows
   per side, 12 stages, fresh keys per stage): partition_ids ->
   shuffle_local -> checked_recv -> join, the total checked against
   numpy, and the launch counters checked per stage;
7. strings: string keys at the dist_join phase's scale (16M rows a
   side): TPC-H's C_NAME as device bytes through the sort join and the
   bucketed hash join, N_NAME as dictionary codes through the sort join,
   the exchange of a bytes table, and the kernels at these shapes
   (``row_hash`` on 6 and 21 word streams, ``bucket_probe`` word by
   word); see :func:`strings_phase`.

8. comm: ``ProcessGroupComm`` over NCCL at a world of one against
   ``LocalComm``: ``all_reduce``, ``dist_join`` at 16M x 16M and one bench
   stage, bit for bit, with walls and the stage's busy share; see
   :func:`comm_phase`;
9. groupby: the 10M-row low-cardinality and 16M-row high-cardinality
   group-bys, TPC-H Q1's shape at 16M rows (dictionary and bytes keys),
   the ops that do not decompose at 4M rows, ``dist_groupby`` at W = 4
   through ``ThreadWorld`` on the card, and ``dist_aggregate`` at 16M
   rows for every op, exact and sketch; each against numpy or pandas,
   each run twice for the same bits; see :func:`groupby_phase`;
10. path kernels: every kernel phase 9 launched, held against its plain
    version at each shape phase 9 gave it, on the input phase 9 gave it
    and on inputs of its kind; see :func:`path_kernel_phase`;
11. dist_join_w4: ``dist_join`` at W = 4 through ``ThreadWorld`` on the
    card, small enough that ``pair_max_scan`` takes its three passes,
    repeated, each run equal to W = 1; then its kernels at its shapes as
    in phase 10; see :func:`dist_join_w4_phase`;
12. sort_setops: BASELINE.json's configuration 4 (a 100M-row int64 sort,
    a union of two 50M-row tables), a 16M-row stability table, unique /
    intersect / subtract at 16M rows, and ``dist_sort`` (both
    partitioners) and the distributed set ops at W = 4 through
    ``ThreadWorld``, each checked (numpy, ``torch.sort``,
    ``torch.unique``, W = 1); then ``scan32`` and ``row_hash`` at the
    shapes this phase gave them, as in phase 10; see
    :func:`sort_setops_phase`.
13. frame: the user-facing layer on the card: ``DataFrame.merge`` of
    two 16M-row frames built from numpy (phase 4's count and checksum,
    and bit for bit the direct ``join``), ``groupby(...).agg`` on phase
    9's low- and high-cardinality shapes (bit for bit
    ``groupby_aggregate``), ``sort_values``, ``drop_duplicates``, a mask
    filter, a derived column, ``len`` and ``head``, each wall beside the
    direct op's; the README's quick start at W = 4 on ``ThreadWorld``
    against W = 1 in 4 runs; ``DisJoinOp`` over 16 chunks a side against
    one ``dist_join``; ``task_shuffle`` of 8 tasks over W = 4; then
    ``row_hash``, ``scan32`` and ``pair_max_scan`` at the shapes this
    phase gave them, as in phase 10. Every line of the phase carries the
    card's name and power limit; see :func:`frame_phase`.
14. tpch: whole TPC-H queries through ``cylon_tpu_torch.tpch``: all 22
    at SF 1 (each equal to the port's run on the CPU), BASELINE.json's
    configuration 5 cut to one card (Q3 and Q5 at SF 10, eager and
    ``tpch.compiled``, bit for bit each other and equal to a pandas
    oracle), six queries at W = 4 on ``ThreadWorld`` against W = 1 in 4
    runs; then ``row_hash``, ``scan32`` and ``pair_max_scan`` at the
    shapes this phase gave them, as in phase 10. Every line of the phase
    carries the card's name and power limit; see :func:`tpch_phase`.
15. telemetry: the telemetry core's cost and its timelines. ``dist_join``
    at 16M x 16M (W = 1) and one bench stage, each untraced and then
    with ``CYLON_TPU_TRACE`` and ``CYLON_TPU_METRICS_DIR`` armed: the
    same rows, kernel launches and synchronizing calls, both walls (at
    W = 1 the exchange and its pricing are bypassed); ``dist_join`` at
    W = 4 on ``ThreadWorld``, 4M rows a rank a side, untraced and armed
    alike: the same comparison, no sync in telemetry's code, and of the
    armed runs the merged timeline's critical path, each rank's stage
    coverage (at least 0.8), the exchange's true bytes against the rows
    the ranks sent, a strict-JSON Chrome trace; then the kernels at this
    phase's shapes, as in phase 10; see :func:`telemetry_phase`.
16. spill: resilience, deadlines and the spill path. The 100M x 100M
    out-of-core join (``ooc_join``, 8 partitions spilled to host
    memory) against numpy, prefetched and sequential, beside the in-core
    join; ``fallback.join`` by the pre-flight route and after a real
    CUDA OOM (a ballast tensor), the live bytes back where they were;
    a child process killed mid-join and resumed here, byte for byte;
    TPC-H through the fallback (q5 spilled, the streaming q1 and q5 at
    SF 10, the six two-phase queries at SF 1) against the in-core
    result and pandas; a transient exchange fault retried at W = 4, a
    barrier against a hung peer, and the hooks' sync sites; then the
    kernels at this phase's shapes, as in phase 10; see
    :func:`spill_phase`.

After every phase a ``memory`` line (:func:`memory_line`):
``telemetry.memory``'s forced sample, the caching allocator's live,
peak (then reset) and reserved bytes, and the live bytes after a
``gc.collect()``, with the card's name and power limit.

Then a ``{"kernels": [...]}`` line (each kernel's launches on the bench
or hash-join path and, as ``groupby_launches``,
``sort_setops_launches``, ``frame_launches``, ``tpch_launches``,
``telemetry_launches`` and ``spill_launches``, on phase 9's group-by
calls, phase 12's calls, phase 13's, phase 14's, phase 15's compared runs
and phase 16's parts (a)-(f)), the ``nvidia-smi``
line again, and as the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device, or run away from the repository, it exits
non-zero and prints no result.
"""

import contextlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: device memory rate by card name (NVIDIA data sheets), bytes/s
_BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
              ("H100", 3.35e12))

DIST_ROWS = 16 << 20
BENCH_ROWS = 1 << 20
BENCH_DEPTH = 12
REPS = 20
#: the shapes each kernel meets on its path (the path whose launches are
#: counted): on the bench path row_hash over one side's rows and the scans
#: over the join's combined rows (two shuffled sides of capacity 2n
#: each); on the hash_join path the bucket kernels over one side's rows
PATH_SHAPE = {"row_hash": BENCH_ROWS, "scan32": 4 * BENCH_ROWS,
              "pair_max_scan": 4 * BENCH_ROWS, "bucket_build": DIST_ROWS,
              "bucket_probe": DIST_ROWS}
#: 2n is the bench's out_cap (its one max scan); 32M the dist_join
#: phase's combined rows; the rest are ragged edges of the tiling
TIMED = (BENCH_ROWS, 2 * BENCH_ROWS, 4 * BENCH_ROWS, 2 * DIST_ROWS)
SHAPES = (4096, 4097, (2 << 20) + 3) + TIMED
#: the bucket kernels: ragged sizes and the hash_join phase's side
BUCKET_SHAPES = (4097, (2 << 20) + 3, DIST_ROWS)
BUCKET_WIDTH = 16
#: wide keys: nine int64 columns are 18 u32 words, past one 16-word chunk
WIDE_COLUMNS = 9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, rate in _BANDWIDTH:
        if key in name:
            return rate
    raise SystemExit(f"no memory rate known for card {name!r}")


def time_ms(torch, fn, reps: int = REPS) -> float:
    """CUDA-event time per call of ``fn``: ``reps`` calls back to back
    after warm-up, over the count. Where a call's host work (Python,
    argument checks, the launch) outlasts its device work, this reads the
    host's rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trace(torch, fn, reps: int = 1):
    """``reps`` calls of ``fn`` under torch.profiler, then a synchronise:
    ``(spans, wall_s)``, spans = (start_us, end_us, name) of every
    device-side event (kernels, copies, sets). A trace that comes back
    without device events (it happened once among a few hundred profiles
    on the H100) is taken again, at most three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = [(ev.time_range.start, ev.time_range.end, ev.name)
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        if spans:
            return spans, wall
    raise SystemExit("profile: the trace holds no device time")


def device_ms_by_kernel(torch, fn, reps: int = REPS) -> dict:
    """Device time per call of ``fn`` from torch.profiler, by the name of
    what its calls ran on the card (kernels, copies, sets)."""
    fn()
    spans, _ = trace(torch, fn, reps)
    by = {}
    for s, e, name in spans:
        by[name] = by.get(name, 0.0) + (e - s) / reps / 1e3
    return by


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Device time per call of ``fn``: the summed durations of everything
    its calls ran on the card -- the host's share of a call left out."""
    return sum(device_ms_by_kernel(torch, fn, reps).values())


def compare(torch, a, b):
    """(mismatching elements, max |a - b|) of two 32-bit outputs or
    tuples of them, bit for bit: uint32 and float32 are compared as their
    int32 bit patterns (so a NaN equals the same NaN, and -0.0 differs
    from +0.0)."""
    if isinstance(a, tuple):
        pairs = [compare(torch, x, y) for x, y in zip(a, b)]
        return sum(p[0] for p in pairs), max(p[1] for p in pairs)
    if a.dtype in (torch.uint32, torch.float32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    bad = int((a != b).sum())
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0
    return bad, err


#: float32 add scans tiles in another order than torch.cumsum: both are
#: float sums of positive terms whose rounding errors walk at random, a
#: few 1e-6 of the prefix at 32M elements; 1e-4 leaves a wide margin
F32_ADD_RTOL = 1e-4


def max_rel_err(torch, got, want) -> float:
    """max |got - want| / |want| over the elements where want != 0."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    nz = want != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got - want).abs()[nz] / want.abs()[nz]).max())


def float_max_input(torch, n, g):
    """float32 values for the max scan: a negative first half with zeros
    of both signs (so the running max sits at 0 and each later zero, of
    either sign, takes its place), then normal values, NaNs from 3/4 on."""
    x = torch.randn(n, device="cuda", generator=g)
    half = n // 2
    x[:half] = -x[:half].abs()
    zeros = torch.rand(half, device="cuda", generator=g) < 0.01
    signs = torch.where(torch.rand(half, device="cuda", generator=g) < 0.5,
                        -0.0, 0.0)
    x[:half] = torch.where(zeros, signs, x[:half])
    nans = torch.rand(n, device="cuda", generator=g) < 0.001
    nans[:3 * n // 4] = False
    nans[3 * n // 4] = True
    return torch.where(nans, float("nan"), x)


def pair_inputs(torch, n, g):
    """The kernel phase's pair input (2 % marks; hi the position, lo
    random), then no marks, every element marked, one mark at 0, ties on
    hi that lo decides, and hi and lo at or above 2^31."""
    iota = torch.arange(n, dtype=torch.int32, device=g.device)

    def rand32():
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                             device=g.device, generator=g)

    marks = torch.rand(n, device=g.device, generator=g) < 0.02
    zero = torch.zeros(n, dtype=torch.int32, device=g.device)
    one = zero.clone()
    one[0] = 1
    ties = (iota >> 10) + 1
    return {
        "path": (torch.where(marks, iota, 0), torch.where(marks, rand32(), 0)),
        "no_marks": (zero, zero),
        "all_marks": (iota, rand32()),
        "one_mark_at_0": (one, one * 7),
        "ties_on_hi": (ties, rand32()),
        "high_bits": (rand32() | -2 ** 31, rand32() | -2 ** 31),
    }


# ------------------------------------------------------------ phase 3
def kernel_phase(torch, rate):
    from cylon_tpu_torch.kernels import pair_max_scan, row_hash, scan32

    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    g_pairs = torch.Generator(device="cuda")
    g_pairs.manual_seed(10)
    stats = {}
    for n in SHAPES:
        keys = torch.randint(-2 ** 62, 2 ** 62, (n,), dtype=torch.int64,
                             device="cuda", generator=g)
        pair = keys.view(torch.int32).view(-1, 2)
        words = [pair[:, 0], pair[:, 1]]   # an int64 key, read in place
        flags = (torch.rand(n, device="cuda", generator=g) < 0.5).to(
            torch.int32)
        marks = torch.rand(n, device="cuda", generator=g) < 0.02
        iota = torch.arange(n, dtype=torch.int32, device="cuda")
        hi = torch.where(marks, iota, 0)
        lo = torch.where(marks, torch.randint(-2 ** 31, 2 ** 31 - 1, (n,),
                                              dtype=torch.int32,
                                              device="cuda", generator=g), 0)
        packed = ((hi.to(torch.int64) ^ 0x80000000) << 32) \
            | (lo.to(torch.int64) & 0xFFFFFFFF)
        # uint32 values within 1000 of 2^32: every add wraps
        near = torch.randint(-1000, 0, (n,), dtype=torch.int32,
                             device="cuda", generator=g).view(torch.uint32)
        fmax = float_max_input(torch, n, g)
        fpos = torch.rand(n, device="cuda", generator=g)
        wide = []
        if n in (4097, BENCH_ROWS):
            for _ in range(WIDE_COLUMNS):
                col = torch.randint(-2 ** 62, 2 ** 62, (n,),
                                    dtype=torch.int64, device="cuda",
                                    generator=g).view(torch.int32)
                wide += [col.view(-1, 2)[:, 0], col.view(-1, 2)[:, 1]]
        # name: (kernel, plain, library call, bytes, rtol against plain;
        # 0 = bit for bit)
        cases = {
            "row_hash": (lambda: row_hash(words),
                         lambda: row_hash.plain(words), None, 12 * n, 0),
            "row_hash/nparts": (lambda: row_hash(words, 64),
                                lambda: row_hash.plain(words, 64), None,
                                12 * n, 0),
            "scan32/add": (lambda: scan32(flags, "add"),
                           lambda: scan32.plain(flags, "add"),
                           lambda: torch.cumsum(flags, 0, dtype=torch.int32),
                           8 * n, 0),
            "scan32/max": (lambda: scan32(hi, "max"),
                           lambda: scan32.plain(hi, "max"),
                           lambda: torch.cummax(hi, 0), 8 * n, 0),
            "scan32/add_u32": (lambda: scan32(near, "add"),
                               lambda: scan32.plain(near, "add"), None,
                               8 * n, 0),
            "scan32/max_f32": (lambda: scan32(fmax, "max"),
                               lambda: scan32.plain(fmax, "max"),
                               lambda: torch.cummax(fmax, 0), 8 * n, 0),
            "scan32/add_f32": (lambda: scan32(fpos, "add"),
                               lambda: scan32.plain(fpos, "add"),
                               lambda: torch.cumsum(fpos, 0), 8 * n,
                               F32_ADD_RTOL),
            "pair_max_scan": (lambda: pair_max_scan(hi, lo),
                              lambda: pair_max_scan.plain(hi, lo),
                              lambda: torch.cummax(packed, 0), 16 * n, 0),
        }
        if wide:
            cases["row_hash/18words"] = (
                lambda: row_hash(wide, 64), lambda: row_hash.plain(wide, 64),
                None, (4 * len(wide) + 4) * n, 0)
        # pair_max_scan's edge inputs, checked and not timed
        untimed = set()
        for case, (ehi, elo) in pair_inputs(torch, n, g_pairs).items():
            if case != "path":
                name = f"pair_max_scan/{case}"
                untimed.add(name)
                cases[name] = (
                    lambda ehi=ehi, elo=elo: pair_max_scan(ehi, elo),
                    lambda ehi=ehi, elo=elo: pair_max_scan.plain(ehi, elo),
                    None, 16 * n, 0)
        for name, (kern, plain, library, nbytes, rtol) in cases.items():
            got = kern()
            extra = {}
            if rtol:
                # against the plain version within rtol, and bit for bit
                # against a second call of the kernel
                rel = max_rel_err(torch, got, plain())
                bad, err = compare(torch, got, kern())
                bad += int(not rel <= rtol)
                extra["max_rel_err"] = rel
            else:
                bad, err = compare(torch, got, plain())
            torch.cuda.synchronize()
            row = {"phase": "kernel", "name": name, "n": n,
                   "mismatches": bad, "max_abs_err": err,
                   "tolerance": rtol, "bound_us": nbytes / rate * 1e6,
                   **extra}
            if n in TIMED and name not in untimed:
                for label, fn in (("kernel", kern), ("plain", plain),
                                  ("library", library)):
                    row[f"{label}_ms"] = time_ms(torch, fn) if fn else None
                    row[f"{label}_device_ms"] = (device_ms(torch, fn)
                                                 if fn else None)
            emit(row)
            if bad:
                raise SystemExit(f"{name} at n={n}: {bad} mismatches")
            stats[(name, n)] = row
    pair_split_phase(torch, rate, stats)
    pair_scratch_phase(torch, stats)
    return stats


def pair_split_phase(torch, rate, stats):
    """pair_max_scan at its dispatch threshold and one pair on each side
    of it (``PAIR_SPLIT`` and below: the three passes; above: one pass
    with a look-back), on every input of :func:`pair_inputs`, bit for bit
    against the plain version."""
    from cylon_tpu_torch.kernels import pair_max_scan
    from cylon_tpu_torch.kernels.scan import PAIR_SPLIT

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    for n in (PAIR_SPLIT - 1, PAIR_SPLIT, PAIR_SPLIT + 1):
        for case, (hi, lo) in pair_inputs(torch, n, g).items():
            name = f"pair_max_scan/split_{case}"
            bad, err = compare(torch, pair_max_scan(hi, lo),
                               pair_max_scan.plain(hi, lo))
            row = {"phase": "kernel", "name": name, "n": n,
                   "path": "three passes" if n <= PAIR_SPLIT
                   else "look-back",
                   "mismatches": bad, "max_abs_err": err, "tolerance": 0,
                   "bound_us": 16 * n / rate * 1e6}
            emit(row)
            if bad:
                raise SystemExit(f"{name} at n={n}: {bad} mismatches")
            stats[(name, n)] = row


def pair_scratch_phase(torch, stats):
    """pair_max_scan's kept scratch across calls of other sizes and
    paths: a look-back call sizes it, a three-pass call then leaves tile
    carries whose words read as the next call's flags (``4 * epoch + 1``
    and ``+ 2``: an aggregate and a prefix), and the look-back call after
    it must still match the plain version bit for bit. The kernel keeps
    its flags where no carry or value is written, so a stale word never
    reads as a flag."""
    from cylon_tpu_torch.kernels import pair_max_scan
    from cylon_tpu_torch.kernels import scan as tscan
    from cylon_tpu_torch.kernels.build import stream_of

    n = 2 * DIST_ROWS
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    hi, lo = pair_inputs(torch, n, g)["path"]
    pair_max_scan(hi, lo)
    key = (hi.device, stream_of(hi))
    nxt = tscan._pair_state[key][1] + 2   # the last call's epoch
    fill = torch.full((tscan.PAIR_SPLIT,), 4 * nxt + 1, dtype=torch.int32,
                      device="cuda")
    pair_max_scan(fill, fill + 1)
    got = pair_max_scan(hi, lo)
    assert tscan._pair_state[key][1] == nxt, "the epochs did not follow"
    bad, err = compare(torch, got, pair_max_scan.plain(hi, lo))
    row = {"phase": "kernel", "name": "pair_max_scan/stale_scratch", "n": n,
           "epoch": nxt, "mismatches": bad, "max_abs_err": err,
           "tolerance": 0}
    emit(row)
    if bad:
        raise SystemExit(f"pair_max_scan/stale_scratch: {bad} mismatches")
    stats[("pair_max_scan/stale_scratch", n)] = row


def bucket_kernel_phase(torch, rate, stats):
    """bucket_build and bucket_probe against their plain versions, bit for
    bit: the table, the overflow count and the mask. Build rows are a
    dimension table's unique int64 keys, probe rows a fact table's keys,
    both bucketed by their row hash as the hash join does, with a ragged
    tail of padding rows (bucket -1); then an overflowing build (ids from
    eight buckets) and an all-duplicate one (every id in one bucket)."""
    from cylon_tpu_torch.kernels import bucket_build, bucket_probe, row_hash
    from cylon_tpu_torch.kernels.bucket import one_int64_key
    from cylon_tpu_torch.ops.hash_join import table_slots

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    width = BUCKET_WIDTH

    def words_of(keys):
        pair = keys.view(torch.int32).view(-1, 2)
        return [pair[:, 0], pair[:, 1]]

    def bucket_ids(words, nb, valid):
        h = row_hash(words)
        return torch.where(torch.arange(h.shape[0], device="cuda") < valid,
                           h & (nb - 1), -1)

    def repeat_mismatches(bids, nb, w, first):
        """A second call on the same input must give the same bits."""
        first = (first[0].clone(), first[1].clone())
        return compare(torch, first, bucket_build(bids, nb, w))[0]

    def build_passes(bids, nb, w):
        """The build's device time by pass, and its peak device memory
        over the memory it started with: the table, the count matrices
        and one staging buffer (the coarse pass stages in the table)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t, _ = bucket_build(bids, nb, w)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        table_bytes = t.numel() * 4
        del t
        by = device_ms_by_kernel(torch, lambda: bucket_build(bids, nb, w))
        return {"passes_device_ms": {k[:60]: v for k, v in by.items()},
                "peak_bytes": peak, "peak_bytes_over_table":
                peak - table_bytes}

    def check(name, n, got, want, nbytes, kern, plain, extra):
        bad, err = compare(torch, got, want)
        bad += extra.get("repeat_mismatches", 0)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "name": name, "n": n, "mismatches": bad,
               "max_abs_err": err, "tolerance": 0,
               "bound_us": nbytes / rate * 1e6, **extra}
        if n == DIST_ROWS and kern is not None:
            for label, fn in (("kernel", kern), ("plain", plain)):
                row[f"{label}_ms"] = time_ms(torch, fn)
                row[f"{label}_device_ms"] = device_ms(torch, fn)
            row["library_ms"] = row["library_device_ms"] = None
        emit(row)
        if bad:
            raise SystemExit(f"{name} at n={n}: {bad} mismatches")
        stats[(name, n)] = row

    for n in BUCKET_SHAPES:
        nb = table_slots(n)
        valid = n - 5   # a ragged tail of padding rows
        bkeys = torch.randperm(n, device="cuda", generator=g)
        pkeys = torch.randint(0, 2 * n, (n,), dtype=torch.int64,
                              device="cuda", generator=g)
        bwords, pwords = words_of(bkeys), words_of(pkeys)
        bids = bucket_ids(bwords, nb, valid)
        pbids = bucket_ids(pwords, nb, valid)
        table, ovf = bucket_build(bids, nb, width)
        want_t, want_o = bucket_build.plain(bids, nb, width)
        if int(want_o):
            raise SystemExit(f"bucket_build at n={n}: unique keys overflowed")
        extra = {"overflow": int(ovf),
                 "repeat_mismatches": repeat_mismatches(bids, nb, width,
                                                        (table, ovf))}
        if n == DIST_ROWS:
            extra.update(build_passes(bids, nb, width))
            main_bids = bids
        check("bucket_build", n, (table, ovf), (want_t, want_o),
              4 * n + 4 * width * nb,
              lambda: bucket_build(bids, nb, width),
              lambda: bucket_build.plain(bids, nb, width), extra)
        # the one-load int64 path, then two layouts that compare word by
        # word: a nullable int64 key (lo, hi and the validity word, nulls
        # zeroed, eight nulls a side) and two int32 key columns
        bnull = torch.ones(n, dtype=torch.bool, device="cuda")
        pnull = bnull.clone()
        bnull[torch.randperm(n, device="cuda", generator=g)[:8]] = False
        pnull[torch.randperm(n, device="cuda", generator=g)[:8]] = False
        layouts = {
            "bucket_probe": (bwords, pwords),
            "bucket_probe/nullable_int64": (
                nullable_words(torch, bkeys, bnull),
                nullable_words(torch, pkeys, pnull)),
            "bucket_probe/two_int32": (
                [(bkeys >> 12).to(torch.int32),
                 (bkeys & 4095).to(torch.int32)],
                [(pkeys >> 12).to(torch.int32),
                 (pkeys & 4095).to(torch.int32)]),
        }
        for name, (bw, pw) in layouts.items():
            if name != "bucket_probe":   # a table over these words' buckets
                bids = bucket_ids(bw, nb, valid)
                table, _ = bucket_build(bids, nb, width)
            pb = bucket_ids(pw, nb, valid)
            one = one_int64_key(pw, bw)
            if one != (name == "bucket_probe"):
                raise SystemExit(f"{name}: one_int64_key gave {one}")
            mask = bucket_probe(pb, pw, table, bw)
            want_m = bucket_probe.plain(pb, pw, table, bw)
            occupied = int((table >= 0).sum())
            check(name, n, mask, want_m,
                  4 * n * (2 + len(pw)) + 4 * occupied * (1 + len(bw)),
                  lambda: bucket_probe(pb, pw, table, bw),
                  lambda: bucket_probe.plain(pb, pw, table, bw),
                  {"matched_rows": int((want_m != 0).sum()),
                   "occupied_entries": occupied, "one_int64": one})

    for name, n, nbuckets in (("bucket_build/collisions", 65537, 8),
                              ("bucket_build/all_duplicate", 4097, 1)):
        nb = table_slots(n)
        bids = torch.randint(0, nbuckets, (n,), dtype=torch.int32,
                             device="cuda", generator=g) * (nb // 8 + 1)
        table, ovf = bucket_build(bids, nb, width)
        want_t, want_o = bucket_build.plain(bids, nb, width)
        if not int(want_o) > 0:
            raise SystemExit(f"{name}: the case does not overflow")
        check(name, n, (table, ovf), (want_t, want_o),
              4 * n + 4 * width * nb, None, None, {"overflow": int(ovf)})
        # the probe on an overflowing table: the entries it holds
        keys = torch.arange(n, dtype=torch.int64, device="cuda")
        mask = bucket_probe(bids, words_of(keys), table, words_of(keys))
        want_m = bucket_probe.plain(bids, words_of(keys), table,
                                    words_of(keys))
        check(name.replace("build", "probe"), n, mask, want_m,
              4 * n * 4 + 4 * int((table >= 0).sum()) * 3, None, None, {})

    # the partitioned build at the edges of its plan: one entry a bucket
    # and thirty, fewer buckets than a tile holds, nb = 4 cap, ids >= nb
    # among -1 rows, no rows, a ragged last chunk, more tiles than a count
    # block's shared counters (the global-counter path), and at 16M one
    # bucket holding 1 % of the rows (it overflows; timed)
    n2 = (2 << 20) + 3

    def ids(n, lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device="cuda",
                             generator=g)

    hot = main_bids.clone()
    hot[torch.rand(DIST_ROWS, device="cuda", generator=g) < 0.01] = 12345
    build_cases = (
        ("bucket_build/width1", ids(n2, 0, 1 << 22), 1 << 22, 1),
        ("bucket_build/width30", ids(n2, 0, 1 << 22), 1 << 22, 30),
        ("bucket_build/nb16", ids(4097, -1, 16), 16, width),
        ("bucket_build/nb_4cap", ids(n2, 0, 4 * n2), 4 * n2, width),
        ("bucket_build/ids_past_nb", ids(n2, -1, (1 << 21) + (1 << 15)),
         1 << 21, width),
        ("bucket_build/cap0", ids(0, 0, 1), 1024, width),
        ("bucket_build/ragged_chunk", ids(300_001, -1, 1 << 18), 1 << 18,
         width),
        ("bucket_build/nb64M", ids(1 << 20, 0, 64 << 20), 64 << 20, width),
        ("bucket_build/hot_bucket", hot, DIST_ROWS, width),
    )
    for name, bids, nb, w in build_cases:
        cap = bids.shape[0]
        got = bucket_build(bids, nb, w)
        want = bucket_build.plain(bids, nb, w)
        extra = {"nb": nb, "width": w, "overflow": int(got[1]),
                 "repeat_mismatches": repeat_mismatches(bids, nb, w, got)}
        if name.endswith("hot_bucket"):
            if not int(want[1]) > 0:
                raise SystemExit(f"{name}: the case does not overflow")
            extra["kernel_ms"] = time_ms(torch, lambda: bucket_build(
                bids, nb, w))
            extra["kernel_device_ms"] = device_ms(
                torch, lambda: bucket_build(bids, nb, w))
            extra.update(build_passes(bids, nb, w))
        check(name, cap, got, want, 4 * cap + 4 * w * nb, None, None, extra)
        del got, want


def nullable_words(torch, keys, valid):
    """An int64 key column with a validity mask as the hash join words it
    (``ops.hash._row_words``): lo and hi, zeroed where null, then the
    validity word."""
    pair = keys.view(torch.int32).view(-1, 2)
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    return [torch.where(valid, pair[:, 0], zero),
            torch.where(valid, pair[:, 1], zero), valid.to(torch.int32)]


def join_parity_phase(torch):
    """The whole join on the card (kernels) against the same join on the
    CPU (plain versions), every how and both orders, nulls included; then
    ``algorithm="hash"`` by both routes (``CYLON_TPU_JOIN_HASH_IMPL`` sort
    and bucketed) for inner, left and right. The hash cases' build chains
    stay within 16 (every null of a build side lands in one bucket): the
    left keys are unique with a few nulls (inner and right build the
    left), the right keys moderately duplicated (left builds the right).
    One all-duplicate case must take the sort fallback."""
    import os

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(7)
    n = 50_000
    lk = rng.integers(0, 20_000, n)
    rk = rng.integers(0, 20_000, n)
    lv = rng.random(n) > 0.05
    data_l = {"k": lk, "a": rng.normal(size=n)}
    data_r = {"k": rk, "b": rng.integers(0, 9, n).astype(np.int32)}
    hash_l = {"k": rng.permutation(4 * n)[:n], "a": rng.normal(size=n)}
    hash_lv = np.ones(n, bool)
    hash_lv[rng.choice(n, 8, replace=False)] = False
    hash_r = {"k": rng.integers(0, 4 * n, n), "b": rng.normal(size=n)}
    dup = {"k": np.zeros(n // 10, np.int64), "a": rng.normal(size=n // 10)}

    def tables(dl, dr, valid, dev):
        left = ct.Table.from_pydict(dl, device=dev)
        right = ct.Table.from_pydict(dr, device=dev)
        kcol = left.column("k")
        return left.add_column("k", ct.Column(
            kcol.data, torch.from_numpy(valid).to(dev), kcol.dtype)), right

    out = {}
    bucket_launches = {}
    saved = os.environ.get("CYLON_TPU_JOIN_HASH_IMPL")
    try:
        for dev in ("cuda", "cpu"):
            left, right = tables(data_l, data_r, lv, dev)
            for how in ("inner", "left", "right", "outer"):
                for ordered in (True, False):
                    res = ct.join(left, right, on="k", how=how,
                                  ordered=ordered, out_capacity=4 * n)
                    out.setdefault(("sort", how, ordered), []).append(
                        res.to_pandas())
            left, right = tables(hash_l, hash_r, hash_lv, dev)
            for impl in ("sort", "bucketed"):
                os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = impl
                for how in ("inner", "left", "right"):
                    for ordered in (True, False):
                        before = launch_counts()
                        res = ct.join(left, right, on="k", how=how,
                                      algorithm="hash", ordered=ordered,
                                      out_capacity=4 * n)
                        key = (f"hash_{impl}", how, ordered)
                        out.setdefault(key, []).append(res.to_pandas())
                        if dev == "cuda":
                            after = launch_counts()
                            bucket_launches[key] = [
                                after[k] - before[k]
                                for k in ("bucket_build", "bucket_probe")]
            # the smaller side builds an inner join: one 5000-long chain
            os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = "bucketed"
            dl, dr = tables(dup, hash_r, np.ones(n // 10, bool), dev)
            before = launch_counts()
            res = ct.join(dl, dr, on="k", how="inner", algorithm="hash",
                          out_capacity=4 * n)
            out.setdefault(("hash_overflow", "inner", True), []).append(
                res.to_pandas())
            if dev == "cuda":
                after = launch_counts()
                bucket_launches[("hash_overflow", "inner", True)] = [
                    after[k] - before[k]
                    for k in ("bucket_build", "bucket_probe")]
            # an empty side: capacity 0 on the left, no valid row in a
            # capacity of 8 on the right, by both algorithms
            el = ct.Table.from_pydict({"k": np.zeros(0, np.int64),
                                       "a": np.zeros(0)}, device=dev)
            er = ct.Table.from_pydict({"k": np.zeros(0, np.int64),
                                       "b": np.zeros(0, np.int32)},
                                      capacity=8, device=dev)
            sl = ct.Table.from_pydict({c: v[:100] for c, v in data_l.items()},
                                      device=dev)
            sr = ct.Table.from_pydict({c: v[:100] for c, v in data_r.items()},
                                      device=dev)
            for impl in ("sort", "bucketed"):
                os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = impl
                for how in ("inner", "left", "right", "outer"):
                    for side, (a, b) in (("empty_left", (el, sr)),
                                         ("empty_right", (sl, er))):
                        res = ct.join(a, b, on="k", how=how,
                                      algorithm="sort" if impl == "sort"
                                      else "hash")
                        out.setdefault((f"{side}_{impl}", how, True),
                                       []).append(res.to_pandas())
    finally:
        if saved is None:
            os.environ.pop("CYLON_TPU_JOIN_HASH_IMPL", None)
        else:
            os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = saved
    for key, (gpu, cpu) in out.items():
        if not gpu.equals(cpu):
            raise SystemExit(f"join {key}: the card and the CPU differ")
    empty_rows = {k: len(v[0]) for k, v in out.items()
                  if k[0].startswith("empty")}
    for (side, how, _), rows in empty_rows.items():
        # the rows of the side that is not empty, where the join keeps them
        keeps = how == "outer" or how == ("right" if side.startswith(
            "empty_left") else "left")
        if rows != (100 if keeps else 0):
            raise SystemExit(f"join {side} {how}: {rows} rows")
    for key, counts in bucket_launches.items():
        want = [1, 1] if key[0] == "hash_bucketed" else [0, 0]
        if counts != want:
            raise SystemExit(f"join {key}: bucket kernel launches {counts}, "
                             f"expected {want}")
    emit({"phase": "join_parity", "rows": n, "cases": len(out),
          "equal": True, "empty_side_rows": {
              "/".join(map(str, k[:2])): v for k, v in empty_rows.items()},
          "bucket_launches": {
              "/".join(map(str, k)): v for k, v in bucket_launches.items()}})


# ------------------------------------------------------------ phase 4
def dist_join_phase(torch):
    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    n = DIST_ROWS
    g = torch.Generator(device="cuda")
    g.manual_seed(4)

    def table():
        k = torch.randint(0, n, (n,), dtype=torch.int64, device="cuda",
                          generator=g)
        v = torch.rand(n, dtype=torch.float64, device="cuda", generator=g)
        return ct.Table({"k": Column(k, None, dtypes.int64),
                         "v": Column(v, None, dtypes.float64)}, n)

    left, right = table(), table()
    env = ct.CylonEnv()
    ct.dist_join(env, left, right, on="k", how="inner")   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = ct.dist_join(env, left, right, on="k", how="inner")
    rows = res.num_rows
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check = float((res.column("v_x").data[:rows]
                   * res.column("v_y").data[:rows]).sum())
    lk, rk = left.column("k").data.cpu().numpy(), \
        right.column("k").data.cpu().numpy()
    lv, rv = left.column("v").data.cpu().numpy(), \
        right.column("v").data.cpu().numpy()
    want_rows = int((np.bincount(lk, minlength=n).astype(np.int64)
                     * np.bincount(rk, minlength=n)).sum())
    want_check = float((np.bincount(lk, weights=lv, minlength=n)
                        * np.bincount(rk, weights=rv, minlength=n)).sum())
    keys_ok = bool(torch.isfinite(res.column("v_x").data[:rows]).all())
    emit({"phase": "dist_join", "rows_per_side": n, "world": 1,
          "result_rows": rows, "expected_rows": want_rows,
          "checksum": check, "expected_checksum": want_check,
          "wall_s": wall, "rows_per_s": 2 * n / wall,
          "peak_bytes": peak, "launches": launches})
    if rows != want_rows or not keys_ok:
        raise SystemExit("dist_join: wrong row count or values")
    if abs(check - want_check) > 1e-9 * abs(want_check):
        raise SystemExit("dist_join: checksum off")
    # a world of one never exchanges, so never hashes: one join's scans
    if launches != {"row_hash": 0, "scan32": 5, "pair_max_scan": 5,
                    "bucket_build": 0, "bucket_probe": 0}:
        raise SystemExit(f"dist_join: launches {launches}")
    return wall


# ------------------------------------------------------------ phase 5
#: the hash_join phase's launches, from the code: row_hash hashes the
#: build side twice (the host chain pre-check, then the build) and the
#: probe side once; one build, one probe; one scan32 for the emission's
#: offsets (dist_join runs ordered=False, so no sort of the pairs, and a
#: world of one never partitions)
HASH_JOIN_LAUNCHES = {"row_hash": 3, "scan32": 1, "pair_max_scan": 0,
                      "bucket_build": 1, "bucket_probe": 1}


def hash_join_phase(torch, sort_wall_other, profile: bool):
    """``dist_join(..., algorithm="hash")`` with the bucketed route at a
    world of one on 16M x 16M rows: a dimension table (keys a random
    permutation of [0, 16M), so the build chains stay near 11, within the
    width of 16) joined to a fact table (keys uniform in [0, 32M), so
    about half its rows match). Int64 keys and float64 values, as the
    dist_join phase."""
    import os

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    n = DIST_ROWS
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    lk = torch.randperm(n, device="cuda", generator=g)
    rk = torch.randint(0, 2 * n, (n,), dtype=torch.int64, device="cuda",
                       generator=g)
    lv = torch.rand(n, dtype=torch.float64, device="cuda", generator=g)
    rv = torch.rand(n, dtype=torch.float64, device="cuda", generator=g)

    def table(k, v):
        return ct.Table({"k": Column(k, None, dtypes.int64),
                         "v": Column(v, None, dtypes.float64)}, n)

    left, right = table(lk, lv), table(rk, rv)
    env = ct.CylonEnv()
    saved = os.environ.get("CYLON_TPU_JOIN_HASH_IMPL")
    os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = "bucketed"
    try:
        ct.dist_join(env, left, right, on="k", algorithm="hash")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = ct.dist_join(env, left, right, on="k", algorithm="hash")
        rows = res.num_rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if profile:
            profile_call(torch, "hash_join_profile", lambda: ct.dist_join(
                env, left, right, on="k", algorithm="hash").num_rows)
    finally:
        if saved is None:
            os.environ.pop("CYLON_TPU_JOIN_HASH_IMPL", None)
        else:
            os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = saved
    check = float((res.column("v_x").data[:rows]
                   * res.column("v_y").data[:rows]).sum())
    del res
    ct.dist_join(env, left, right, on="k")   # the sort join, warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sort_rows = ct.dist_join(env, left, right, on="k").num_rows
    torch.cuda.synchronize()
    sort_wall = time.perf_counter() - t0

    lkn, lvn = lk.cpu().numpy(), lv.cpu().numpy()
    rkn, rvn = rk.cpu().numpy(), rv.cpu().numpy()
    by_key = np.zeros(n)
    by_key[lkn] = lvn
    hit = rkn < n
    want_rows = int(hit.sum())
    want_check = float((by_key[rkn[hit]] * rvn[hit]).sum())
    emit({"phase": "hash_join", "rows_per_side": n, "world": 1,
          "hash_impl": "bucketed", "bucket_width": BUCKET_WIDTH,
          "result_rows": rows, "expected_rows": want_rows,
          "checksum": check, "expected_checksum": want_check,
          "wall_s": wall, "rows_per_s": 2 * n / wall, "peak_bytes": peak,
          "launches": launches, "expected_launches": HASH_JOIN_LAUNCHES,
          "sort_join_wall_s": sort_wall,
          "sort_join_wall_s_dist_join_phase": sort_wall_other})
    if rows != want_rows or sort_rows != want_rows:
        raise SystemExit("hash_join: wrong row count")
    if abs(check - want_check) > 1e-9 * abs(want_check):
        raise SystemExit("hash_join: checksum off")
    if launches != HASH_JOIN_LAUNCHES:
        raise SystemExit(f"hash_join: launches {launches} != "
                         f"{HASH_JOIN_LAUNCHES}")
    return launches


# ------------------------------------------------------------ phase 6
def bench_stage(comm, lt, rt, shuf_cap: int, out_cap: int):
    """One stage of bench.py's pipeline through ``comm``: partition_ids
    -> shuffle_local -> checked_recv, both sides, then the join."""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops.hash import partition_ids
    from cylon_tpu_torch.parallel.shuffle import checked_recv, shuffle_local

    w = comm.world_size
    lpid = partition_ids([lt.column("k").data], w, [None])
    rpid = partition_ids([rt.column("k").data], w, [None])
    lsh, _ = checked_recv(shuffle_local(comm, lt, lpid, shuf_cap), shuf_cap)
    rsh, _ = checked_recv(shuffle_local(comm, rt, rpid, shuf_cap), shuf_cap)
    return ct.join(lsh, rsh, on="k", how="inner", suffixes=("_l", "_r"),
                   out_capacity=out_cap, ordered=False)


def bench_phase(torch, profile: bool):
    """Port of bench.py's _bench_exchange_pipeline at its own size."""
    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    n, depth = BENCH_ROWS, BENCH_DEPTH
    out_cap = shuf_cap = 2 * n
    comm = ct.LocalComm()
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    kl = torch.randint(0, n, (depth, n), dtype=torch.int64, device="cuda",
                       generator=g)
    kr = torch.randint(0, n, (depth, n), dtype=torch.int64, device="cuda",
                       generator=g)
    av = torch.randn(depth, n, dtype=torch.float64, device="cuda",
                     generator=g)
    bv = torch.randn(depth, n, dtype=torch.float64, device="cuda",
                     generator=g)

    def side(k, v):
        return ct.Table({"k": Column(k, None, dtypes.int64),
                         "v": Column(v, None, dtypes.float64)}, n)

    def stage(i):
        return bench_stage(comm, side(kl[i], av[i]), side(kr[i], bv[i]),
                           shuf_cap, out_cap).nrows

    def pipeline():
        total = torch.zeros((), dtype=torch.int64, device="cuda")
        for i in range(depth):
            total += stage(i)   # in place: one running device counter
        return int(total)

    pipeline()                                  # warm-up
    times = []
    reset_launches()
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = pipeline()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = launch_counts()
    want = 0
    for i in range(depth):
        a = np.bincount(kl[i].cpu().numpy(), minlength=n).astype(np.int64)
        want += int((a * np.bincount(kr[i].cpu().numpy(), minlength=n)).sum())
    expect = {"row_hash": 2 * depth, "scan32": 5 * depth,
              "pair_max_scan": 5 * depth, "bucket_build": 0,
              "bucket_probe": 0}
    emit({"phase": "bench", "rows_per_side": n, "depth": depth,
          "total_rows": total, "expected_rows": want, "times_s": times,
          "rows_per_s": depth * n / min(times), "launches": launches,
          "expected_launches": expect})
    if total != want:
        raise SystemExit("bench: wrong total")
    if launches != expect:
        raise SystemExit(f"bench: launches {launches} != {expect}")
    if profile:
        profile_call(torch, "profile", lambda: stage(0))
    return launches


def profile_call(torch, phase: str, fn, card: "str | None" = None):
    """One call of ``fn`` (a bench stage, a hash join) under
    torch.profiler: device time by kernel and the device's busy share of
    the call's wall time (the union of the kernels' intervals; the
    operators that launched them are left out, so no time counts
    twice). Emits the row and returns it."""
    spans, wall = trace(torch, fn)
    spans.sort()
    busy_us, end = 0.0, None
    by_kernel = {}
    for s, e, name in spans:
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
        us, calls = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (us + e - s, calls + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    row = {"phase": phase, "stage_wall_ms": wall * 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches": len(spans),
           "top": [{"name": name[:90], "ms": us / 1e3, "calls": c}
                   for name, (us, c) in top[:20]]}
    if card is not None:
        row["card"] = card
    emit(row)
    return row


# ------------------------------------------------------------ phase 7
#: TPC-H's C_NAME, "Customer#%09d": 18 bytes, so 5 words of device bytes
CUSTOMER_PREFIX = b"Customer#"
CUSTOMER_BYTES = 18
#: TPC-H's N_NAME in N_NATIONKEY order (the spec's nation table)
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES")
#: the nations of TPC-H's region ASIA (Q5's filter on R_NAME)
ASIA = ("INDIA", "INDONESIA", "JAPAN", "CHINA", "VIETNAM")
#: rows of the prefix rendered from Python strings by bytescol.encode_host
ENCODE_PREFIX = 1 << 20
#: output rows decoded on the host and parsed back to their keys
DECODE_SAMPLE = 4096
#: the wide key of the kernel cases: 80 bytes, 20 words and a validity
#: word, two row_hash launches (16-word chunks)
WIDE_KEY_BYTES = 80
#: the sort join's launches at a world of one on any key: one group_sort
#: (one add scan), the join's counts and offsets, its five fills
SORT_JOIN_LAUNCHES = {"row_hash": 0, "scan32": 5, "pair_max_scan": 5,
                      "bucket_build": 0, "bucket_probe": 0}


def render_customer(torch, keys):
    """[n] int64 keys -> [n, 5] int32 words of "Customer#%09d", rendered
    on the device with integer ops: big-endian bytes, zero-padded from 18
    to 20 bytes, every word below 2^31 (ASCII)."""
    digits = [(keys // 10 ** (8 - i)) % 10 + 0x30 for i in range(9)]
    head = [int(b) for b in CUSTOMER_PREFIX]
    byte = [torch.full_like(keys, b) for b in head] + digits + \
        [torch.zeros_like(keys)] * 2
    words = [(byte[4 * j] << 24) | (byte[4 * j + 1] << 16)
             | (byte[4 * j + 2] << 8) | byte[4 * j + 3] for j in range(5)]
    return torch.stack(words, dim=1).to(torch.int32)


def parse_customer(values) -> list:
    """Decoded "Customer#%09d" strings -> their integer keys."""
    out = []
    for v in values:
        if not (isinstance(v, str) and v.startswith("Customer#")
                and len(v) == CUSTOMER_BYTES):
            raise SystemExit(f"strings: decoded {v!r} is no C_NAME")
        out.append(int(v[len("Customer#"):]))
    return out


def pairs_exist(np, keys, vals, want_keys, want_vals) -> bool:
    """Does every (want_keys[i], want_vals[i]) occur among the rows
    (keys, vals)? One sort, then a short scan of each key's run."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    lo = np.searchsorted(ks, want_keys, "left")
    hi = np.searchsorted(ks, want_keys, "right")
    return all(bool((vs[a:b] == v).any())
               for a, b, v in zip(lo, hi, want_vals))


def timed_join(torch, fn):
    """Warm-up, then one call from zeroed launch counters: (result, rows,
    wall seconds, launches, peak device bytes)."""
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    rows = res.num_rows
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, rows, wall, launch_counts(),
            torch.cuda.max_memory_allocated())


def strings_phase(torch, rate, stats, profile: bool):
    """String keys through the public entry points at the dist_join
    phase's scale, 16M rows a side at a world of one:

    1. device bytes, sort join: C_NAME keys uniform in [0, 16M), rendered
       on the device, held bit for bit against ``bytescol.encode_host``
       (through ``Table.from_pydict(..., string_storage="bytes")``) on a
       1M-row prefix made of Python strings; ``dist_join`` checked against
       numpy (row count, sum(v_l * v_r) at rtol 1e-9) and 4096 output
       rows decoded and parsed back to keys present on both sides; its
       wall beside the int64 ``dist_join`` on the same integer keys;
    2. device bytes, bucketed hash join: the hash_join phase's keys
       (a permutation of [0, 16M) against uniform [0, 32M)) as C_NAME;
       one bucket_build and one bucket_probe (the word-by-word path);
    3. dictionary codes: a 16M-row fact table of N_NAME (uniform over the
       25 nations, ingested as strings) joined to the 25-row nation table,
       ingested apart in N_NATIONKEY order (its sorted dictionary is the
       fact's), and to the 5 nations of region ASIA, whose dictionary
       differs, so that ``unify_dictionaries`` re-encodes the 16M codes;
    4. the exchange of a bytes table: ``partition_ids`` over the key,
       ``shuffle_local`` through ``LocalComm`` as the bench phase drives
       it; the words that arrive equal the host's gather in that order;
    5. the kernels at these shapes, bit for bit against their plain
       versions, timed and bounded as in the kernel phase: ``row_hash``
       on the C_NAME key's 5 words and a validity word, on an 80-byte key
       (21 words, two launches), and ``bucket_probe`` word by word.

    ``profile`` adds a device trace of each join of items 1 and 2, and of
    the int64 sort join beside item 1."""
    import os

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import (bucket_build, bucket_probe,
                                         launch_counts, row_hash)
    from cylon_tpu_torch.kernels.bucket import one_int64_key
    from cylon_tpu_torch.ops.hash import _row_words, partition_ids
    from cylon_tpu_torch.ops.hash_join import table_slots
    from cylon_tpu_torch.parallel.shuffle import shuffle_local

    n = DIST_ROWS
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    env = ct.CylonEnv()
    bytes_dt = dtypes.string_bytes(CUSTOMER_BYTES)

    def table(words, v, key_dtype=bytes_dt):
        return ct.Table({"k": Column(words, None, key_dtype),
                         "v": Column(v, None, dtypes.float64)},
                        words.shape[0])

    def rand_values(m):
        return torch.rand(m, dtype=torch.float64, device="cuda",
                          generator=g)

    # -- the rendering against the host codec
    kl = torch.randint(0, n, (n,), dtype=torch.int64, device="cuda",
                       generator=g)
    kr = torch.randint(0, n, (n,), dtype=torch.int64, device="cuda",
                       generator=g)
    wl, wr = render_customer(torch, kl), render_customer(torch, kr)
    prefix = kl[:ENCODE_PREFIX].cpu().numpy()
    t0 = time.perf_counter()
    host = ct.Table.from_pydict(
        {"k": np.array([f"Customer#{k:09d}" for k in prefix], object)},
        device="cuda", string_storage="bytes").column("k")
    encode_s = time.perf_counter() - t0
    encode_bad = int((host.data != wl[:ENCODE_PREFIX]).sum())
    if repr(host.dtype) != repr(bytes_dt) or encode_bad:
        raise SystemExit(f"strings: encode_host and the device rendering "
                         f"differ ({host.dtype!r}, {encode_bad} words)")
    del host

    # -- 1. bytes-key sort join, beside the int64 join on the same keys
    vl, vr = rand_values(n), rand_values(n)
    left, right = table(wl, vl), table(wr, vr)
    res, rows, wall, launches, peak = timed_join(
        torch, lambda: ct.dist_join(env, left, right, on="k"))
    check = float((res.column("v_x").data[:rows]
                   * res.column("v_y").data[:rows]).sum())
    sample = torch.randint(0, max(rows, 1), (DECODE_SAMPLE,), device="cuda",
                           generator=g)
    kcol = res.column("k")
    got_keys = np.array(parse_customer(kcol.decode_host(
        kcol.data[sample].cpu().numpy(), None)))
    sx = res.column("v_x").data[sample].cpu().numpy()
    sy = res.column("v_y").data[sample].cpu().numpy()
    del res, kcol
    lk, rk = kl.cpu().numpy(), kr.cpu().numpy()
    lvh, rvh = vl.cpu().numpy(), vr.cpu().numpy()
    want_rows = int((np.bincount(lk, minlength=n).astype(np.int64)
                     * np.bincount(rk, minlength=n)).sum())
    want_check = float((np.bincount(lk, weights=lvh, minlength=n)
                        * np.bincount(rk, weights=rvh, minlength=n)).sum())
    decoded_ok = pairs_exist(np, lk, lvh, got_keys, sx) and \
        pairs_exist(np, rk, rvh, got_keys, sy)
    ileft = table(kl, vl, dtypes.int64)
    iright = table(kr, vr, dtypes.int64)
    _, irows, iwall, _, ipeak = timed_join(
        torch, lambda: ct.dist_join(env, ileft, iright, on="k"))
    if profile:
        profile_call(torch, "strings_profile_bytes_sort_join",
                     lambda: ct.dist_join(env, left, right,
                                          on="k").num_rows)
        profile_call(torch, "strings_profile_int64_sort_join",
                     lambda: ct.dist_join(env, ileft, iright,
                                          on="k").num_rows)
    del ileft, iright
    emit({"phase": "strings", "case": "bytes_sort_join",
          "rows_per_side": n, "world": 1, "key": "C_NAME",
          "key_dtype": repr(bytes_dt),
          "encode_prefix_rows": ENCODE_PREFIX, "encode_host_s": encode_s,
          "encode_mismatched_words": encode_bad,
          "result_rows": rows, "expected_rows": want_rows,
          "checksum": check, "expected_checksum": want_check,
          "decoded_rows": DECODE_SAMPLE, "decoded_ok": decoded_ok,
          "wall_s": wall, "peak_bytes": peak, "launches": launches,
          "expected_launches": SORT_JOIN_LAUNCHES,
          "int64_wall_s": iwall, "int64_peak_bytes": ipeak,
          "int64_result_rows": irows, "wall_ratio_to_int64": wall / iwall})
    if rows != want_rows or irows != want_rows or not decoded_ok:
        raise SystemExit("strings: bytes sort join gave wrong rows")
    if abs(check - want_check) > 1e-9 * abs(want_check):
        raise SystemExit("strings: bytes sort join checksum off")
    if launches != SORT_JOIN_LAUNCHES:
        raise SystemExit(f"strings: bytes sort join launches {launches}")
    del left, right

    # -- 2. bytes-key bucketed hash join
    dk = torch.randperm(n, device="cuda", generator=g)
    fk = torch.randint(0, 2 * n, (n,), dtype=torch.int64, device="cuda",
                       generator=g)
    dw, fw = render_customer(torch, dk), render_customer(torch, fk)
    dv, fv = rand_values(n), rand_values(n)
    dim, fact = table(dw, dv), table(fw, fv)
    saved = os.environ.get("CYLON_TPU_JOIN_HASH_IMPL")
    os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = "bucketed"
    try:
        res, rows, hwall, hlaunches, hpeak = timed_join(
            torch, lambda: ct.dist_join(env, dim, fact, on="k",
                                        algorithm="hash"))
        if profile:
            profile_call(torch, "strings_profile_bytes_hash_join",
                         lambda: ct.dist_join(env, dim, fact, on="k",
                                              algorithm="hash").num_rows)
    finally:
        if saved is None:
            os.environ.pop("CYLON_TPU_JOIN_HASH_IMPL", None)
        else:
            os.environ["CYLON_TPU_JOIN_HASH_IMPL"] = saved
    check = float((res.column("v_x").data[:rows]
                   * res.column("v_y").data[:rows]).sum())
    sample = torch.randint(0, max(rows, 1), (DECODE_SAMPLE,), device="cuda",
                           generator=g)
    kcol = res.column("k")
    got_keys = np.array(parse_customer(kcol.decode_host(
        kcol.data[sample].cpu().numpy(), None)))
    sx = res.column("v_x").data[sample].cpu().numpy()
    sy = res.column("v_y").data[sample].cpu().numpy()
    del res, kcol
    dkn, dvn = dk.cpu().numpy(), dv.cpu().numpy()
    fkn, fvn = fk.cpu().numpy(), fv.cpu().numpy()
    by_key = np.zeros(n)
    by_key[dkn] = dvn
    hit = fkn < n
    want_rows = int(hit.sum())
    want_check = float((by_key[fkn[hit]] * fvn[hit]).sum())
    decoded_ok = bool((got_keys < n).all()) and bool(
        (by_key[np.minimum(got_keys, n - 1)] == sx).all()) and \
        pairs_exist(np, fkn, fvn, got_keys, sy)
    emit({"phase": "strings", "case": "bytes_hash_join",
          "rows_per_side": n, "world": 1, "hash_impl": "bucketed",
          "bucket_width": BUCKET_WIDTH, "result_rows": rows,
          "expected_rows": want_rows, "checksum": check,
          "expected_checksum": want_check, "decoded_ok": decoded_ok,
          "wall_s": hwall, "peak_bytes": hpeak, "launches": hlaunches,
          "expected_launches": HASH_JOIN_LAUNCHES})
    if rows != want_rows or not decoded_ok:
        raise SystemExit("strings: bytes hash join gave wrong rows")
    if abs(check - want_check) > 1e-9 * abs(want_check):
        raise SystemExit("strings: bytes hash join checksum off")
    if hlaunches != HASH_JOIN_LAUNCHES:
        raise SystemExit(f"strings: bytes hash join launches {hlaunches}")

    # -- 5. the kernels at this path's shapes (the probe on the tables
    # above: its build from the dimension keys' words)
    nb = table_slots(n)
    valid = torch.rand(n, device="cuda", generator=g) >= 0.01
    cases = {}
    words6 = _row_words([wl], [valid])
    cases["row_hash/c_name_6words"] = (words6, (4 * 6 + 4) * n, 1)
    lens = torch.randint(1, WIDE_KEY_BYTES + 1, (n, 1), device="cuda",
                         generator=g)
    raw = torch.randint(0x21, 0x7F, (n, WIDE_KEY_BYTES), device="cuda",
                        generator=g)
    raw = torch.where(torch.arange(WIDE_KEY_BYTES, device="cuda") < lens,
                      raw, 0).view(n, WIDE_KEY_BYTES // 4, 4)
    wide = ((raw[:, :, 0] << 24) | (raw[:, :, 1] << 16)
            | (raw[:, :, 2] << 8) | raw[:, :, 3]).to(torch.int64)
    wide = (wide - ((wide >> 31) << 32)).to(torch.int32)   # u32 patterns
    words21 = _row_words([wide], [valid])
    cases["row_hash/80_bytes_21words"] = (words21, (4 * 21 + 4) * n, 2)
    for name, (words, nbytes, chunks) in cases.items():
        before = row_hash.launches
        got = row_hash(words)
        launched = row_hash.launches - before
        bad, err = compare(torch, got, row_hash.plain(words))
        row = {"phase": "kernel", "name": name, "n": n,
               "words": len(words), "mismatches": bad, "max_abs_err": err,
               "tolerance": 0, "launches_a_call": launched,
               "bound_us": nbytes / rate * 1e6,
               "kernel_ms": time_ms(torch, lambda: row_hash(words)),
               "kernel_device_ms": device_ms(torch, lambda: row_hash(words)),
               "plain_ms": time_ms(torch, lambda: row_hash.plain(words)),
               "plain_device_ms": device_ms(
                   torch, lambda: row_hash.plain(words)),
               "library_ms": None, "library_device_ms": None}
        emit(row)
        if bad or launched != chunks:
            raise SystemExit(f"{name}: {bad} mismatches, {launched} "
                             f"launches a call")
        stats[(name, n)] = row
    del words6, words21, wide, raw
    bwords, pwords = _row_words([dw], None), _row_words([fw], None)
    bids = row_hash(bwords) & (nb - 1)
    pbids = row_hash(pwords) & (nb - 1)
    btable, ovf = bucket_build(bids, nb, BUCKET_WIDTH)
    if int(ovf) or one_int64_key(pwords, bwords):
        raise SystemExit("strings: probe case overflowed or took the "
                         "int64 path")
    mask = bucket_probe(pbids, pwords, btable, bwords)
    want_m = bucket_probe.plain(pbids, pwords, btable, bwords)
    bad, err = compare(torch, mask, want_m)
    occupied = int((btable >= 0).sum())
    row = {"phase": "kernel", "name": "bucket_probe/c_name_5words", "n": n,
           "words": len(pwords), "mismatches": bad, "max_abs_err": err,
           "tolerance": 0, "matched_rows": int((want_m != 0).sum()),
           "occupied_entries": occupied, "one_int64": False,
           "bound_us": (4 * n * (2 + len(pwords))
                        + 4 * occupied * (1 + len(bwords))) / rate * 1e6,
           "kernel_ms": time_ms(torch, lambda: bucket_probe(
               pbids, pwords, btable, bwords)),
           "kernel_device_ms": device_ms(torch, lambda: bucket_probe(
               pbids, pwords, btable, bwords)),
           "plain_ms": time_ms(torch, lambda: bucket_probe.plain(
               pbids, pwords, btable, bwords)),
           "plain_device_ms": device_ms(torch, lambda: bucket_probe.plain(
               pbids, pwords, btable, bwords)),
           "library_ms": None, "library_device_ms": None}
    emit(row)
    if bad:
        raise SystemExit(f"bucket_probe/c_name_5words: {bad} mismatches")
    stats[("bucket_probe/c_name_5words", n)] = row
    del dim, fact, btable, mask, want_m, bwords, pwords, bids, pbids

    # -- 3. dictionary keys: N_NAME, the nation table in N_NATIONKEY order
    codes = torch.randint(0, len(NATIONS), (n,), device="cuda",
                          generator=g).cpu().numpy()
    fv = rand_values(n)
    t0 = time.perf_counter()
    fact = ct.Table.from_pydict(
        {"n": np.array(NATIONS, object)[codes], "v": fv.cpu().numpy()},
        device="cuda", string_storage="dict")
    ingest_s = time.perf_counter() - t0
    fvn = fv.cpu().numpy()
    for case, names in (("dict_join", NATIONS), ("dict_join_asia", ASIA)):
        nv = rand_values(len(names))
        dim = ct.Table.from_pydict(
            {"n": np.array(names, object), "w": nv.cpu().numpy()},
            device="cuda", string_storage="dict")
        reencode = fact.column("n").dictionary != dim.column("n").dictionary
        if reencode != (names is ASIA):
            raise SystemExit(f"strings: {case}: the dictionaries "
                             f"{'differ' if reencode else 'agree'}")
        res, rows, dwall, dlaunches, dpeak = timed_join(
            torch, lambda: ct.dist_join(env, fact, dim, on="n"))
        check = float((res.column("v").data[:rows]
                       * res.column("w").data[:rows]).sum())
        out_names = res.column("n").to_numpy(DECODE_SAMPLE)
        del res
        # the dimension's weight of each fact row, 0 where it has none
        weight = np.zeros(len(NATIONS))
        weight[[NATIONS.index(x) for x in names]] = nv.cpu().numpy()
        want_rows = int(np.isin(codes, [NATIONS.index(x)
                                        for x in names]).sum())
        want_check = float((fvn * weight[codes]).sum())
        emit({"phase": "strings", "case": case, "rows": n,
              "dimension_rows": len(names), "world": 1, "key": "N_NAME",
              "reencoded": reencode, "ingest_s": ingest_s,
              "result_rows": rows, "expected_rows": want_rows,
              "checksum": check, "expected_checksum": want_check,
              "wall_s": dwall, "peak_bytes": dpeak, "launches": dlaunches,
              "expected_launches": SORT_JOIN_LAUNCHES})
        if rows != want_rows or not set(out_names) <= set(names):
            raise SystemExit(f"strings: {case} gave wrong rows")
        if abs(check - want_check) > 1e-9 * abs(want_check):
            raise SystemExit(f"strings: {case} checksum off")
        if dlaunches != SORT_JOIN_LAUNCHES:
            raise SystemExit(f"strings: {case} launches {dlaunches}")
        del dim
    del fact

    # -- 4. the exchange of a bytes table
    comm = ct.LocalComm()
    t = table(wl, vl)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = partition_ids([t.column("k").data], comm.world_size, [None])
    sh = shuffle_local(comm, t, pid, n)
    got_rows = int(sh.nrows)
    torch.cuda.synchronize()
    xwall = time.perf_counter() - t0
    after = launch_counts()
    order = np.argsort(pid.cpu().numpy(), kind="stable")
    want_w = wl.cpu().numpy()[order]
    want_v = vl.cpu().numpy()[order]
    got_w = sh.column("k").data[:got_rows].cpu().numpy()
    got_v = sh.column("v").data[:got_rows].cpu().numpy()
    same = got_rows == n and np.array_equal(got_w, want_w) and \
        np.array_equal(got_v.view(np.int64), want_v.view(np.int64))
    xl = {k: after[k] - before[k] for k in after}
    emit({"phase": "strings", "case": "exchange", "rows": n,
          "world": comm.world_size, "words_a_row": got_w.shape[1] + 2,
          "received_rows": got_rows, "bit_identical": same,
          "wall_s": xwall, "launches": xl})
    if not same or xl["row_hash"] != 1:
        raise SystemExit("strings: the exchange changed the words")


# ------------------------------------------------------------ phase 8
def event_wall(torch, fn):
    """``(result, wall ms)`` of one call of ``fn`` between two CUDA events
    on the current stream, the host's gaps (the regrow ladder's and the
    exchange's syncs) included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bits_of(torch, t):
    """A tensor as integers of its width, so that equality is bit
    equality (a NaN equals the same NaN, -0.0 differs from 0.0)."""
    if t.is_floating_point():
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def same_bits(torch, a, b) -> bool:
    """Do two tables hold the same rows, column by column, bit for
    bit?"""
    n = a.num_rows
    if b.num_rows != n or a.column_names != b.column_names:
        return False
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if repr(x.dtype) != repr(y.dtype) or \
                (x.validity is None) != (y.validity is None):
            return False
        if not torch.equal(bits_of(torch, x.data[:n]),
                           bits_of(torch, y.data[:n])):
            return False
        if x.validity is not None and \
                not torch.equal(x.validity[:n], y.validity[:n]):
            return False
    return True


def comm_phase(torch):
    """``ProcessGroupComm`` over NCCL at a world of one (``DistConfig``,
    a ``tcp://127.0.0.1`` rendezvous on a free port; the group destroyed
    at the end), against ``LocalComm`` on the same inputs:

    1. ``all_reduce`` of 1M float64 and int64 values, each op, bit for
       bit (at W = 1 the fold returns the input);
    2. ``dist_join`` on the dist_join phase's 16M x 16M tables: the same
       rows, bit for bit, both walls (CUDA events) and peaks;
    3. one bench stage (partition_ids -> exchange -> join at 1M rows a
       side) through each: the same rows, its launches, and the device's
       busy share under torch.profiler, where the exchange's count sync
       (the count matrix brought to the host so that NCCL gets its split
       sizes) shows."""
    import socket

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = ct.CylonEnv(config=ct.DistConfig(
        backend="nccl", init_method=f"tcp://127.0.0.1:{port}",
        world_size=1, rank=0))
    local = ct.CylonEnv()
    row = {"phase": "comm", "backend": "nccl", "world": env.world_size,
           "comm": type(env.comm).__name__}
    try:
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        m = 1 << 20
        vectors = {
            "float64": torch.randn(m, dtype=torch.float64, device="cuda",
                                   generator=g),
            "int64": torch.randint(-2 ** 62, 2 ** 62, (m,),
                                   dtype=torch.int64, device="cuda",
                                   generator=g)}
        # the first collective sets up the NCCL communicator: not timed
        env.comm.all_gather(torch.zeros(1, device="cuda"))
        reduces = []
        for dt, x in vectors.items():
            for op in ("sum", "min", "max"):
                got, ms = event_wall(torch,
                                     lambda: env.comm.all_reduce(x, op))
                same = torch.equal(bits_of(torch, got), bits_of(
                    torch, local.comm.all_reduce(x, op))) and \
                    torch.equal(bits_of(torch, got), bits_of(torch, x))
                reduces.append({"dtype": dt, "op": op, "n": m,
                                "identical_bits": same, "wall_ms": ms})
        row["all_reduce"] = reduces

        n = DIST_ROWS
        g.manual_seed(4)

        def table():
            k = torch.randint(0, n, (n,), dtype=torch.int64, device="cuda",
                              generator=g)
            v = torch.rand(n, dtype=torch.float64, device="cuda",
                           generator=g)
            return ct.Table({"k": Column(k, None, dtypes.int64),
                             "v": Column(v, None, dtypes.float64)}, n)

        left, right = table(), table()
        joins = {}
        for name, e in (("local", local), ("nccl", env)):
            ct.dist_join(e, left, right, on="k")   # warm-up
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res, ms = event_wall(
                torch, lambda e=e: ct.dist_join(e, left, right, on="k"))
            # the peak above what was held before (the first run's result
            # is still held during the second)
            joins[name] = (res, ms, torch.cuda.max_memory_allocated() - held)
        same = same_bits(torch, joins["local"][0], joins["nccl"][0])
        row["dist_join"] = {
            "rows_per_side": n, "result_rows": joins["nccl"][0].num_rows,
            "identical_rows": same,
            **{f"{k}_wall_ms": v[1] for k, v in joins.items()},
            **{f"{k}_peak_bytes_above_start": v[2]
               for k, v in joins.items()}}
        del joins, left, right

        b = BENCH_ROWS

        def side():
            return ct.Table({
                "k": Column(torch.randint(0, b, (b,), dtype=torch.int64,
                                          device="cuda", generator=g),
                            None, dtypes.int64),
                "v": Column(torch.randn(b, dtype=torch.float64,
                                        device="cuda", generator=g),
                            None, dtypes.float64)}, b)

        lt, rt = side(), side()
        stages = {}
        for name, comm in (("local", local.comm), ("nccl", env.comm)):
            def stage(comm=comm):
                return bench_stage(comm, lt, rt, 2 * b, 2 * b)

            stage()
            reset_launches()
            res, ms = event_wall(torch, stage)
            launches = launch_counts()
            prof = profile_call(torch, f"comm_profile_{name}",
                                lambda: stage().num_rows)
            stages[name] = (res, {"wall_ms": ms, "launches": launches,
                                  "busy_share": prof["device_busy_share"],
                                  "profiled_wall_ms": prof["stage_wall_ms"],
                                  "device_busy_ms": prof["device_busy_ms"]})
        same_stage = same_bits(torch, stages["local"][0], stages["nccl"][0])
        row["bench_stage"] = {"rows_per_side": b,
                              "identical_rows": same_stage,
                              **{k: v[1] for k, v in stages.items()}}
    finally:
        env.finalize()
    emit(row)
    if not all(r["identical_bits"] for r in row["all_reduce"]):
        raise SystemExit("comm: all_reduce changed the bits")
    if not same or not same_stage:
        raise SystemExit("comm: NCCL and LocalComm gave other rows")
    expect = {"row_hash": 2, "scan32": 5, "pair_max_scan": 5,
              "bucket_build": 0, "bucket_probe": 0}
    for name, (_, st) in stages.items():
        if st["launches"] != expect:
            raise SystemExit(f"comm: {name} stage launches "
                             f"{st['launches']} != {expect}")


# ------------------------------------------------------------ phase 9
GROUPBY_LOW_ROWS = 10_000_000
GROUPBY_LOW_KEYS = 10_000
GROUPBY_ROWS = DIST_ROWS
#: bench_suite.py's high-cardinality cell: 0.6 key values a row
GROUPBY_HIGH_KEYS = GROUPBY_ROWS * 6 // 10
GROUPBY_RAW_ROWS = 4 << 20
GROUPBY_RAW_KEYS = 1 << 20
GROUPBY_WORLD = 4
GROUPBY_RANK_ROWS = 4 << 20
GROUPBY_W4_REPEATS = 4
#: scan32 launches one dispatch of each workload makes, from the code:
#: one for group_sort's numbering, one a count channel (min, max, mean,
#: std and count share a column's), one a nunique, two a quantile (its
#: count and the exclusive scan of the counts)
GROUPBY_SCANS = {"lowcard": 2, "highcard": 2, "q1_dict": 4, "q1_bytes": 4,
                 "raw": 6}
Q1_AGGS = [("l_quantity", "sum", "sum_qty"),
           ("l_extendedprice", "sum", "sum_base_price"),
           ("disc_price", "sum", "sum_disc_price"),
           ("charge", "sum", "sum_charge"),
           ("l_quantity", "mean", "avg_qty"),
           ("l_extendedprice", "mean", "avg_price"),
           ("l_discount", "mean", "avg_disc"),
           ("l_quantity", "count", "count_order")]


def run_groupby(torch, case: str, table, by, aggs, total: dict,
                quantile: float = 0.5):
    """Two calls of ``groupby_aggregate`` at one shape, the first from a
    cold regrow memo: each call's wall (CUDA events) and its rungs (the
    dispatches the ladder made), the first call's launches (added to
    ``total``) against :data:`GROUPBY_SCANS`, its peak memory, and the
    two results bit for bit. Returns ``(result, row)``."""
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.ops import groupby as gb

    bounds = []
    inner = gb._groupby_compiled

    def counting(*args, **kw):
        bounds.append(kw["out_cap"])
        return inner(*args, **kw)

    gb._groupby_compiled = counting
    gb._EAGER_SCALE_MEMO.clear()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        first, ms1 = event_wall(torch, lambda: gb.groupby_aggregate(
            table, by, aggs, quantile=quantile))
        groups = first.num_rows
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        bounds1 = list(bounds)
        bounds.clear()
        second, ms2 = event_wall(torch, lambda: gb.groupby_aggregate(
            table, by, aggs, quantile=quantile))
    finally:
        gb._groupby_compiled = inner
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    rows = table.num_rows
    expect = {"row_hash": 0, "scan32": GROUPBY_SCANS[case] * len(bounds1),
              "pair_max_scan": 0, "bucket_build": 0, "bucket_probe": 0}
    same = same_bits(torch, first, second)
    row = {"phase": "groupby", "case": case, "rows": rows, "groups": groups,
           "aggregates": [list(a) for a in aggs],
           "wall_ms_first": ms1, "wall_ms_second": ms2,
           "rows_per_s": rows / (ms2 / 1e3), "rungs_first": len(bounds1),
           "rungs_second": len(bounds), "bounds_first": bounds1,
           "peak_bytes": peak, "identical_bits": same,
           "launches": launches, "expected_launches": expect}
    if not same:
        raise SystemExit(f"groupby {case}: two calls gave other bits")
    if launches != expect:
        raise SystemExit(f"groupby {case}: launches {launches} != {expect}")
    return first, row


def check_close(np, case, name, got, want, rtol, atol=0.0):
    """Raise unless ``got`` equals ``want`` (both tolerances 0) or is
    within them, NaNs in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same_nan = np.array_equal(np.isnan(got), np.isnan(want))
    ok = same_nan and (np.array_equal(got, want, equal_nan=True)
                       if not (rtol or atol)
                       else np.allclose(got, want, rtol=rtol, atol=atol,
                                        equal_nan=True))
    if not ok:
        bad = ~np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
        raise SystemExit(f"groupby {case}: {name} off at "
                         f"{int(bad.sum())} groups")


def groupby_phase(torch, profile: bool) -> dict:
    """Group-by and scalar aggregates through the public entry points;
    each workload checked against numpy or pandas on the host and run
    twice for the same bits (:func:`run_groupby`):

    1. lowcard: BASELINE.json's 10M-row groupby-aggregate in the shape
       of bench_suite.py's cell 3: int64 keys uniform in [0, 10000),
       float64 values, sum / mean / count;
    2. highcard: bench_suite.py's cell 3b at 16M rows, keys uniform in
       [0, 0.6 x 16M) (about 8M groups), sum / mean / count / min / max /
       std; the regrow ladder's rungs on the first and second call;
    3. TPC-H Q1's shape at 16M rows: by l_returnflag (A/N/R) and
       l_linestatus (F/O), as dictionary codes and as device bytes (the
       same bits both ways), its eight aggregates (sum x4, mean x3,
       count), the disc_price and charge columns computed on the card;
    4. raw: nunique, median, quantile 0.9, first and last at 4M rows
       (about 1M groups; 1 % NaN values) against pandas;
    5. dist_groupby at W = 4 through ThreadWorld on CUDA tensors, 4M rows
       a rank, both paths, against the W = 1 group-by of the same 16M
       rows (row_hash launched by the exchange), in
       :data:`GROUPBY_W4_REPEATS` runs, the first timed;
    6. dist_aggregate at 16M rows for every op, exact and sketch (within
       one bracket of the exact quantile), each twice for the same bits;
       the int64 key column's nunique, min and max.

    Returns the launches of the phase's group-by calls, summed."""
    import numpy as np
    import pandas as pd

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column, Dictionary
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.ops import bytescol
    from cylon_tpu_torch.ops.aggregates import AGGS

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    total = {}

    def f64(x):
        return Column(x, None, dtypes.float64)

    def i64(x):
        return Column(x, None, dtypes.int64)

    def host_groups(k, nkeys, v=None):
        cnt = np.bincount(k, minlength=nkeys)
        return cnt, (None if v is None
                     else np.bincount(k, weights=v, minlength=nkeys))

    # -- 1. lowcard
    n, nk = GROUPBY_LOW_ROWS, GROUPBY_LOW_KEYS
    k = torch.randint(0, nk, (n,), dtype=torch.int64, device="cuda",
                      generator=g)
    v = torch.randn(n, dtype=torch.float64, device="cuda", generator=g)
    low = ct.Table({"k": i64(k), "v": f64(v)}, n)
    res, row = run_groupby(torch, "lowcard", low, ["k"],
                           [("v", "sum"), ("v", "mean"), ("v", "count")],
                           total)
    kh, vh = k.cpu().numpy(), v.cpu().numpy()
    cnt, s = host_groups(kh, nk, vh)
    have = cnt > 0
    got = res.to_pandas()
    if not np.array_equal(got["k"].to_numpy(), np.nonzero(have)[0]) or \
            not np.array_equal(got["v_count"].to_numpy(), cnt[have]):
        raise SystemExit("groupby lowcard: keys or counts off")
    check_close(np, "lowcard", "sum", got["v_sum"], s[have], 1e-9)
    check_close(np, "lowcard", "mean", got["v_mean"], s[have] / cnt[have],
                1e-9)
    emit(row)
    del low, res, got

    # -- 2. highcard
    n, nk = GROUPBY_ROWS, GROUPBY_HIGH_KEYS
    k = torch.randint(0, nk, (n,), dtype=torch.int64, device="cuda",
                      generator=g)
    v = torch.randn(n, dtype=torch.float64, device="cuda", generator=g)
    high = ct.Table({"k": i64(k), "v": f64(v)}, n)
    high_aggs = [("v", "sum"), ("v", "mean"), ("v", "count"), ("v", "min"),
                 ("v", "max"), ("v", "std")]
    res, row = run_groupby(torch, "highcard", high, ["k"], high_aggs, total)
    kh, vh = k.cpu().numpy(), v.cpu().numpy()
    cnt, s = host_groups(kh, nk, vh)
    sq = np.bincount(kh, weights=vh * vh, minlength=nk)
    lo = np.full(nk, np.inf)
    hi = np.full(nk, -np.inf)
    np.minimum.at(lo, kh, vh)
    np.maximum.at(hi, kh, vh)
    have = cnt > 0
    c = cnt[have].astype(np.float64)
    var = (sq[have] - s[have] * s[have] / c) / np.maximum(c - 1, 1)
    std = np.where(c > 1, np.sqrt(np.maximum(var, 0)), np.nan)
    got = res.to_pandas()
    if not np.array_equal(got["k"].to_numpy(), np.nonzero(have)[0]) or \
            not np.array_equal(got["v_count"].to_numpy(), cnt[have]):
        raise SystemExit("groupby highcard: keys or counts off")
    check_close(np, "highcard", "sum", got["v_sum"], s[have], 1e-9)
    check_close(np, "highcard", "mean", got["v_mean"], s[have] / c, 1e-9)
    check_close(np, "highcard", "min", got["v_min"], lo[have], 0)
    check_close(np, "highcard", "max", got["v_max"], hi[have], 0)
    check_close(np, "highcard", "std", got["v_std"], std, 1e-9)
    emit(row)
    del res, got
    if profile:
        profile_call(torch, "groupby_profile_highcard",
                     lambda: ct.groupby_aggregate(high, ["k"],
                                                  high_aggs).num_rows)

    # -- 6. dist_aggregate on the highcard table's values, 1 % NaN
    va = torch.where(torch.rand(n, device="cuda", generator=g) < 0.01,
                     float("nan"), v)
    agg_table = ct.Table({"k": i64(k), "v": f64(va)}, n)
    env = ct.CylonEnv()
    vah = va.cpu().numpy()
    ok = vah[~np.isnan(vah)]
    want = {"sum": ok.sum(), "count": len(ok), "min": ok.min(),
            "max": ok.max(), "mean": ok.mean(), "var": ok.var(ddof=1),
            "std": ok.std(ddof=1), "nunique": len(np.unique(ok)),
            "median": np.median(ok), "quantile": np.quantile(ok, 0.9)}
    bracket = (ok.max() - ok.min()) / 2048 ** 2
    aggs_out = []
    for op in AGGS:
        for exact in ((True, False) if op in ("median", "quantile")
                      else (True,)):
            def call(op=op, exact=exact):
                return ct.dist_aggregate(env, agg_table, "v", op,
                                         quantile=0.9, exact=exact)

            reset_launches()
            first, ms = event_wall(torch, call)
            first_launches = launch_counts()
            second, ms2 = event_wall(torch, call)
            got_v = first.item()
            same = torch.equal(bits_of(torch, first), bits_of(torch, second))
            if not exact:
                good = abs(got_v - want[op]) <= bracket
            elif op in ("count", "min", "max", "nunique"):
                good = got_v == want[op]
            else:
                rtol = 1e-12 if op in ("median", "quantile") else 1e-9
                good = abs(got_v - want[op]) <= rtol * abs(want[op])
            good = bool(good)
            aggs_out.append({"op": op, "exact": exact, "value": got_v,
                             "expected": float(want[op]), "wall_ms": ms,
                             "wall_ms_second": ms2,
                             "identical_bits": same, "within": good,
                             "launches": first_launches})
            if not (same and good):
                raise SystemExit(f"dist_aggregate {op} exact={exact}: "
                                 f"{got_v} against {want[op]}")
    knu, ms = event_wall(torch, lambda: ct.dist_aggregate(
        env, agg_table, "k", "nunique"))
    # the int64 key's extremes: an int64 reduction, no atomics
    present = np.flatnonzero(cnt)
    int_ext = {}
    for op, want_k in (("min", present[0]), ("max", present[-1])):
        def call_k(op=op):
            return ct.dist_aggregate(env, agg_table, "k", op)

        got_k, ms_k = event_wall(torch, call_k)
        _, ms_k2 = event_wall(torch, call_k)
        int_ext[op] = {"value": got_k.item(), "expected": int(want_k),
                       "wall_ms": ms_k, "wall_ms_second": ms_k2}
    emit({"phase": "groupby", "case": "dist_aggregate", "rows": n,
          "world": 1, "nan_share": 0.01,
          "sketch_bracket": float(bracket),
          "ops": aggs_out, "nunique_k": knu.item(),
          "nunique_k_expected": int((cnt > 0).sum()),
          "nunique_k_wall_ms": ms, "int64_k": int_ext})
    if knu.item() != int((cnt > 0).sum()):
        raise SystemExit("dist_aggregate: nunique of the keys off")
    if any(e["value"] != e["expected"] for e in int_ext.values()):
        raise SystemExit(f"dist_aggregate: the keys' extremes off: "
                         f"{int_ext}")
    del high, agg_table, va

    # -- 3. TPC-H Q1's shape
    rf = torch.randint(0, 3, (n,), dtype=torch.int32, device="cuda",
                       generator=g)
    ls = torch.randint(0, 2, (n,), dtype=torch.int32, device="cuda",
                       generator=g)
    qty = torch.randint(1, 51, (n,), device="cuda",
                        generator=g).to(torch.float64)
    price = qty * (torch.rand(n, dtype=torch.float64, device="cuda",
                              generator=g) * 2000 + 900)
    disc = torch.randint(0, 11, (n,), device="cuda",
                         generator=g).to(torch.float64) / 100
    tax = torch.randint(0, 9, (n,), device="cuda",
                        generator=g).to(torch.float64) / 100
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    values = {"l_quantity": f64(qty), "l_extendedprice": f64(price),
              "l_discount": f64(disc), "disc_price": f64(disc_price),
              "charge": f64(charge)}

    def words(codes, names):
        w, _, width = bytescol.encode_host(np.array(names, object))
        tab = torch.from_numpy(w.view(np.int32)).to("cuda")
        return Column(tab[codes.to(torch.int64)], None,
                      dtypes.string_bytes(width))

    q1 = {}
    for case, keys in (
            ("q1_dict", {"l_returnflag": Column(rf, None, dtypes.string,
                                                Dictionary(["A", "N", "R"])),
                         "l_linestatus": Column(ls, None, dtypes.string,
                                                Dictionary(["F", "O"]))}),
            ("q1_bytes", {"l_returnflag": words(rf, ["A", "N", "R"]),
                          "l_linestatus": words(ls, ["F", "O"])})):
        t = ct.Table({**keys, **values}, n)
        q1[case], row = run_groupby(torch, case, t,
                                    ["l_returnflag", "l_linestatus"],
                                    Q1_AGGS, total)
        row["key_dtype"] = repr(t.column("l_returnflag").dtype)
        emit(row)
    gid = (rf * 2 + ls).cpu().numpy()
    got = q1["q1_dict"].to_pandas()
    if [f"{a}{b}" for a, b in zip(got["l_returnflag"],
                                   got["l_linestatus"])] != \
            ["AF", "AO", "NF", "NO", "RF", "RO"]:
        raise SystemExit("groupby q1: groups off")
    cnt = np.bincount(gid, minlength=6)
    for src, op, name in Q1_AGGS:
        col = values[src].data.cpu().numpy()
        s = np.bincount(gid, weights=col, minlength=6)
        want_q1 = cnt if op == "count" else s if op == "sum" else s / cnt
        check_close(np, "q1", name, got[name], want_q1,
                    0 if op == "count" else 1e-9)
    if not same_bits(torch, q1["q1_dict"].select(
            [name for _, _, name in Q1_AGGS]), q1["q1_bytes"].select(
            [name for _, _, name in Q1_AGGS])):
        raise SystemExit("groupby q1: codes and bytes disagree")
    del q1, values, qty, price, disc, tax, disc_price, charge, rf, ls

    # -- 4. the ops that do not decompose
    n, nk = GROUPBY_RAW_ROWS, GROUPBY_RAW_KEYS
    k = torch.randint(0, nk, (n,), dtype=torch.int64, device="cuda",
                      generator=g)
    v = torch.randn(n, dtype=torch.float64, device="cuda", generator=g)
    v = torch.where(torch.rand(n, device="cuda", generator=g) < 0.01,
                    float("nan"), v)
    u = torch.randint(0, 8, (n,), dtype=torch.int64, device="cuda",
                      generator=g)
    raw = ct.Table({"k": i64(k), "v": f64(v), "u": i64(u)}, n)
    raw_aggs = [("u", "nunique"), ("v", "median"), ("v", "quantile"),
                ("v", "first"), ("v", "last")]
    res, row = run_groupby(torch, "raw", raw, ["k"], raw_aggs, total,
                           quantile=0.9)
    df = pd.DataFrame({"k": k.cpu().numpy(), "v": v.cpu().numpy(),
                       "u": u.cpu().numpy()})
    grp = df.groupby("k")
    want_raw = pd.DataFrame({
        "u_nunique": grp["u"].nunique(), "v_median": grp["v"].median(),
        "v_quantile": grp["v"].quantile(0.9), "v_first": grp["v"].first(),
        "v_last": grp["v"].last()}).reset_index()
    got = res.to_pandas()
    if not np.array_equal(got["k"].to_numpy(), want_raw["k"].to_numpy()):
        raise SystemExit("groupby raw: keys off")
    for name in ("u_nunique", "v_first", "v_last"):
        check_close(np, "raw", name, got[name], want_raw[name], 0)
    # pandas interpolates as lo + (hi - lo) * t, the JAX package (and so
    # the port) as lo * (1 - t) + hi * t: near zero the two differ by
    # more than 1e-12 of the result, so the bound is 1e-12 of the
    # values' magnitude
    scale = float(np.nanmax(np.abs(df["v"].to_numpy())))
    for name in ("v_median", "v_quantile"):
        check_close(np, "raw", name, got[name], want_raw[name], 1e-12,
                    1e-12 * scale)
    emit(row)
    del raw, res, got, df, grp

    # -- 5. dist_groupby at W = 4 through ThreadWorld on the card
    w, nr = GROUPBY_WORLD, GROUPBY_RANK_ROWS
    n = w * nr
    k = torch.randint(0, GROUPBY_RAW_KEYS, (n,), dtype=torch.int64,
                      device="cuda", generator=g)
    v = torch.randn(n, dtype=torch.float64, device="cuda", generator=g)
    u = torch.randint(0, 8, (n,), dtype=torch.int64, device="cuda",
                      generator=g)
    paths = {"decomposable": [("v", "sum"), ("v", "mean"), ("v", "count"),
                              ("v", "min"), ("v", "max"), ("v", "std")],
             "raw_rows": [("v", "median"), ("u", "nunique"),
                          ("v", "first"), ("v", "last")]}

    def rank(comm):
        e = ct.CylonEnv(comm)
        sl = slice(e.rank * nr, (e.rank + 1) * nr)
        mine = ct.Table({"k": i64(k[sl]), "v": f64(v[sl]),
                         "u": i64(u[sl])}, nr)
        return {p: ct.dist_groupby(e, mine, ["k"], a)
                for p, a in paths.items()}

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    per_rank, ms = event_wall(torch, lambda: ct.ThreadWorld(w).run(rank))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for key, val in launches.items():
        total[key] = total.get(key, 0) + val
    whole = ct.Table({"k": i64(k), "v": f64(v), "u": i64(u)}, n)
    refs = {p: ct.groupby_aggregate(whole, ["k"], a) for p, a in paths.items()}

    def matches(per_rank, p) -> bool:
        ref = refs[p]
        parts = [r[p] for r in per_rank]
        keys = torch.cat([t.column("k").data[:t.num_rows] for t in parts])
        if keys.numel() != ref.num_rows:
            return False
        order = torch.sort(keys).indices
        good = torch.equal(keys[order], ref.column("k").data[:ref.num_rows])
        for name in ref.column_names[1:]:
            got_c = torch.cat([t.column(name).data[:t.num_rows]
                               for t in parts])[order]
            want_c = ref.column(name).data[:ref.num_rows]
            if p == "decomposable" and got_c.is_floating_point():
                good &= bool(torch.allclose(got_c, want_c, rtol=1e-9,
                                            atol=0, equal_nan=True))
            else:
                good &= torch.equal(bits_of(torch, got_c),
                                    bits_of(torch, want_c))
        return bool(good)

    # the ranks are threads sharing one stream: repeat the run, since a
    # race between them shows in some runs only
    runs = [per_rank] + [ct.ThreadWorld(w).run(rank)
                         for _ in range(GROUPBY_W4_REPEATS - 1)]
    out = {"phase": "groupby", "case": "dist_groupby_w4", "world": w,
           "rows_per_rank": nr, "wall_ms": ms, "peak_bytes": peak,
           "launches": launches, "runs": len(runs),
           "rank_groups": {p: [r[p].num_rows for r in per_rank]
                           for p in paths},
           "groups_w1": {p: refs[p].num_rows for p in paths}}
    for p in paths:
        ok = [matches(r, p) for r in runs]
        out[f"{p}_runs_matching_w1"] = sum(ok)
        if not all(ok):
            emit(out)
            raise SystemExit(f"dist_groupby W=4 {p}: {ok.count(False)} of "
                             f"{len(ok)} runs differ from W=1")
    emit(out)
    if launches["row_hash"] < 1:
        raise SystemExit("dist_groupby W=4: the exchange hashed nothing")
    return total


# ------------------------------------------------------------ phase 10
class PathInputs:
    """While active, ``scan32`` and ``pair_max_scan`` (as
    ``ops.kernels`` reaches them, through its name ``scan``) and
    ``row_hash`` (as ``ops.hash`` reaches it) run as before, each launch
    counted by its wrapper, and the first input of each shape is kept, a
    copy on the card, for :func:`path_kernel_phase`. The wrappers'
    modules are left alone: each wrapper counts its launches through its
    module's name for it. The copies cost a device copy a shape (64 MB
    at 16M int32 values) inside the timed first calls."""

    def __init__(self):
        self.inputs = {}
        self._lock = threading.Lock()

    def _keep(self, key, make):
        with self._lock:
            if key not in self.inputs:
                self.inputs[key] = make()

    def __enter__(self):
        from cylon_tpu_torch.kernels import scan as kscan
        from cylon_tpu_torch.ops import hash as ohash
        from cylon_tpu_torch.ops import kernels as okernels

        self._saved = okernels.scan, ohash.row_hash
        real_scan, real_pair, real_hash = \
            kscan.scan32, kscan.pair_max_scan, ohash.row_hash

        class Scan:
            """``kernels.scan`` with its two wrappers recorded."""

            def __getattr__(self, name):
                return getattr(kscan, name)

        def scan32(x, kind):
            self._keep(("scan32", kind, str(x.dtype), x.shape[0]),
                       lambda: x.clone())
            return real_scan(x, kind)

        def pair_max_scan(hi, lo):
            self._keep(("pair_max_scan", hi.shape[0]),
                       lambda: (hi.clone(), lo.clone()))
            return real_pair(hi, lo)

        def row_hash(words, nparts=0, **kw):
            words = list(words)
            self._keep(("row_hash", len(words), nparts, words[0].shape[0],
                        tuple(sorted(kw.items()))),
                       lambda: ([w.clone() for w in words], kw))
            return real_hash(words, nparts, **kw)

        proxy = Scan()
        proxy.scan32, proxy.pair_max_scan = scan32, pair_max_scan
        okernels.scan, ohash.row_hash = proxy, row_hash
        return self

    def __exit__(self, *exc):
        from cylon_tpu_torch.ops import hash as ohash
        from cylon_tpu_torch.ops import kernels as okernels

        okernels.scan, ohash.row_hash = self._saved


def path_kernel_phase(torch, rate, stats, path: str, inputs: dict,
                      card: "str | None" = None) -> None:
    """Each kernel against its plain version at every shape a path gave
    it (:class:`PathInputs`), untimed: on the input the path gave it,
    and for ``scan32``'s int32 add also on 0/1 flags and on counts in
    [0, 64) (the group-by's numbering and count channels), for
    ``row_hash`` on random words of the path's width, for
    ``pair_max_scan`` on :func:`pair_inputs`' edge cases. Bit for bit
    (float32 adds within ``F32_ADD_RTOL``). The rows join ``stats``, so
    the ``kernels`` line's mismatches count them. With ``card``
    (the card's name and power limit) each row carries it."""
    from cylon_tpu_torch.kernels import pair_max_scan, row_hash, scan32

    g = None
    for key in sorted(inputs, key=repr):
        got = inputs[key]
        dev = (got[0][0] if key[0] == "row_hash" else
               got[0] if key[0] == "pair_max_scan" else got).device
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(15)
        cases, rtol = {}, 0
        if key[0] == "scan32":
            _, kind, dtype, n = key
            cases["path"] = got
            if kind == "add" and got.dtype == torch.int32:
                cases["flags01"] = (torch.rand(n, device=dev, generator=g)
                                    < 0.5).to(torch.int32)
                cases["counts"] = torch.randint(0, 64, (n,), device=dev,
                                                dtype=torch.int32,
                                                generator=g)
            if kind == "add" and got.dtype == torch.float32:
                rtol = F32_ADD_RTOL
            name = f"scan32/{path}_{kind}_{dtype.split('.')[-1]}"
            run = {c: (lambda x=x: scan32(x, kind),
                       lambda x=x: scan32.plain(x, kind))
                   for c, x in cases.items()}
            nbytes = 8 * n
        elif key[0] == "row_hash":
            _, k, nparts, n, _ = key
            words, kw = got
            rand = [torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device=dev,
                                  dtype=torch.int32, generator=g)
                    for _ in range(k)]
            name = f"row_hash/{path}_{k}words_nparts{nparts}"
            run = {c: (lambda ws=ws: row_hash(ws, nparts, **kw),
                       lambda ws=ws: row_hash.plain(ws, nparts, **kw))
                   for c, ws in (("path", words), ("random", rand))}
            nbytes = (4 * k + 4) * n
        else:
            _, n = key
            pairs = {"path": got, **{c: p for c, p in pair_inputs(
                torch, n, g).items() if c != "path"}}
            name = f"pair_max_scan/{path}"
            run = {c: (lambda p=p: pair_max_scan(*p),
                       lambda p=p: pair_max_scan.plain(*p))
                   for c, p in pairs.items()}
            nbytes = 16 * n
        for case, (kern, plain) in run.items():
            out = kern()
            extra = {}
            if rtol:
                rel = max_rel_err(torch, out, plain())
                bad, err = compare(torch, out, kern())
                bad += int(not rel <= rtol)
                extra["max_rel_err"] = rel
            else:
                bad, err = compare(torch, out, plain())
            row = {"phase": "path_kernel", "path": path,
                   "name": f"{name}/{case}", "n": n, "mismatches": bad,
                   "max_abs_err": err, "tolerance": rtol,
                   "bound_us": nbytes / rate * 1e6, **extra}
            if card is not None:
                row["card"] = card
            emit(row)
            if bad:
                raise SystemExit(f"{name}/{case} at n={n} on the {path} "
                                 f"path: {bad} mismatches")
            stats[(f"{name}/{case}", n)] = row


# ------------------------------------------------------------ phase 11
#: a rank's rows a side: each rank's two receive buffers (a power-of-two
#: bucket of 2M / 4 rows and its margin, 1M) keep the local join's pair
#: scans (2M pairs) on pair_max_scan's three passes
DIST_W4_ROWS = 512 << 10
DIST_W4_REPEATS = 4


def row_set(torch, parts, names):
    """The rows of several tables as columns of integers (floats by
    their bits), sorted lexicographically: equal row sets give equal
    columns."""
    cols = [torch.cat([bits_of(torch, t.column(c).data[:t.num_rows])
                       for t in parts]) for c in names]
    idx = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        idx = idx[torch.sort(c[idx], stable=True).indices]
    return [c[idx] for c in cols]


def dist_join_w4_phase(torch, rate, stats, dev="cuda") -> None:
    """``dist_join`` at W = 4 through ``ThreadWorld`` on the card,
    :data:`DIST_W4_ROWS` rows a rank a side, int64 keys uniform over the
    world's rows: the ranks' threads share one stream, and each local
    join's ``pair_max_scan`` runs its three passes, whose carries live in
    the scratch kept per stream. :data:`DIST_W4_REPEATS` runs (a race
    shows in some runs only), each equal as a row set, bit for bit, to
    the W = 1 join of the same rows; then every kernel held against its
    plain version at the shapes this path gave it
    (:func:`path_kernel_phase`)."""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.kernels.scan import PAIR_SPLIT

    w, nr = GROUPBY_WORLD, DIST_W4_ROWS
    n = w * nr
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    sides = [(torch.randint(0, n, (n,), dtype=torch.int64, device=dev,
                            generator=g),
              torch.rand(n, dtype=torch.float64, device=dev, generator=g))
             for _ in range(2)]

    def table(k, v, lo, hi):
        return ct.Table({"k": Column(k[lo:hi], None, dtypes.int64),
                         "v": Column(v[lo:hi], None, dtypes.float64)},
                        hi - lo)

    def rank(comm):
        e = ct.CylonEnv(comm)
        lo, hi = e.rank * nr, (e.rank + 1) * nr
        return ct.dist_join(e, *[table(k, v, lo, hi) for k, v in sides],
                            on="k")

    with PathInputs() as rec:
        reset_launches()
        first, ms = event_wall(torch, lambda: ct.ThreadWorld(w).run(rank))
        launches = launch_counts()
        runs = [first] + [ct.ThreadWorld(w).run(rank)
                          for _ in range(DIST_W4_REPEATS - 1)]
    whole = ct.dist_join(ct.CylonEnv(device=dev),
                         *[table(k, v, 0, n) for k, v in sides], on="k")
    names = whole.column_names
    want = row_set(torch, [whole], names)
    ok = [all(torch.equal(a, b) for a, b in zip(row_set(torch, r, names),
                                                want)) for r in runs]
    pair_ns = sorted(key[1] for key in rec.inputs
                     if key[0] == "pair_max_scan")
    out = {"phase": "dist_join_w4", "world": w, "rows_per_rank_side": nr,
           "result_rows": whole.num_rows, "wall_ms": ms,
           "launches": launches, "pair_scan_n": pair_ns,
           "runs": len(runs), "runs_matching_w1": sum(ok)}
    emit(out)
    if not all(ok):
        raise SystemExit(f"dist_join W=4: {ok.count(False)} of {len(ok)} "
                         "runs differ from W=1")
    if not pair_ns or max(pair_ns) > PAIR_SPLIT or \
            launches["pair_max_scan"] < 1 or launches["row_hash"] < 1:
        raise SystemExit(f"dist_join W=4: pair scans {pair_ns}, launches "
                         f"{launches}: not the three-pass path")
    path_kernel_phase(torch, rate, stats, "dist_join_w4", rec.inputs)


# ------------------------------------------------------------ phase 12
#: BASELINE.json's fourth configuration, "Distributed sort / set-union
#: (sample-sort on 100M-row int64 column)", in bench_suite.py:173-183's
#: shape: keys uniform in [0, 2^40), and a union with keys in [0, n)
SORT_ROWS = 100_000_000
SORT_KEY_BITS = 40
UNION_ROWS = 50_000_000
#: the stability table: int64 keys in [0, 1M) and a float64 value
STABLE_ROWS = 16 << 20
STABLE_KEYS = 1 << 20
#: unique / intersect / subtract a side, keys in [0, SETOP_ROWS)
SETOP_ROWS = 16 << 20
#: dist_sort and the distributed set ops at W = 4 on ThreadWorld
SORT_W4_RANK_ROWS = 1 << 20
SORT_W4_REPEATS = 4


def timed_twice(torch, fn):
    """``(second result, its wall ms, its peak bytes)``: one call to
    warm up, then one between CUDA events with the peak memory counter
    reset before it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, ms = event_wall(torch, fn)
    return out, ms, torch.cuda.max_memory_allocated()


def column_of(t, name):
    return t.column(name).data[:t.num_rows]


def sort_setops_phase(torch, profile: bool, dev="cuda") -> tuple:
    """Sort, set ops and their distributed forms through the public
    entry points, at the sizes of BASELINE.json's configuration 4; each
    result checked, each wall the second call's (CUDA events), with its
    peak memory:

    1. ``sort_table`` on :data:`SORT_ROWS` int64 keys in [0, 2^40), and
       ``dist_sort`` at W = 1 on the same column: the keys equal
       ``torch.sort(keys).values`` element for element;
    2. a :data:`STABLE_ROWS`-row table, int64 keys in [0, 1M) and a
       float64 value, sorted ascending and descending: keys and values
       against numpy's stable argsort element for element;
    3. ``union`` of two :data:`UNION_ROWS`-row tables, 2^40 keys against
       keys in [0, n): against ``torch.unique`` of the concatenation as
       a set, the count exactly;
    4. ``unique``, ``intersect`` and ``subtract`` at :data:`SETOP_ROWS`
       rows a side, keys in [0, 16M): against numpy's ``unique``,
       ``intersect1d`` and ``setdiff1d`` as sets, and ``unique`` in the
       first-occurrence order of pandas' ``drop_duplicates``;
    5. at W = 4 through ``ThreadWorld`` on the card,
       :data:`SORT_W4_RANK_ROWS` rows a rank: ``dist_sort`` (sample and
       histogram splitters), ``dist_union``, ``dist_intersect``,
       ``dist_subtract`` and ``dist_unique``, each
       :data:`SORT_W4_REPEATS` times: sorts equal to W = 1 element for
       element, set ops equal to W = 1 as row sets. Every run of the six
       ops is timed; its wall is the second run's, the first carrying
       the one-time warm-up.

    The launch counters are zeroed before and read after; ``scan32``
    (the set ops' group numbering) and ``row_hash`` (the distributed set
    ops' partition) must both have run. Returns ``(launches, the
    inputs the kernels met)`` for :func:`path_kernel_phase`."""
    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches

    g = torch.Generator(device=dev)
    g.manual_seed(16)

    def i64(x):
        return Column(x, None, dtypes.int64)

    def keys(n, hi):
        return torch.randint(0, hi, (n,), dtype=torch.int64, device=dev,
                             generator=g)

    env1 = ct.CylonEnv(device=dev)
    rows = []
    t0 = time.perf_counter()

    def record(case, n, ms, peak, **extra):
        row = {"phase": "sort_setops", "case": case, "rows": n,
               "wall_ms": ms, "rows_per_s": n / (ms / 1e3),
               "peak_bytes": peak, **extra,
               "phase_s": time.perf_counter() - t0}
        emit(row)
        rows.append(row)

    rec = PathInputs()
    with rec:
        reset_launches()
        # 1. the 100M sort, local and at W = 1
        k = keys(SORT_ROWS, 1 << SORT_KEY_BITS)
        t = ct.Table({"k": i64(k)}, SORT_ROWS)
        want = torch.sort(k).values
        for case, fn in (("sort_table", lambda: ct.sort_table(t, ["k"])),
                         ("dist_sort_w1", lambda: ct.dist_sort(env1, t,
                                                               "k"))):
            out, ms, peak = timed_twice(torch, fn)
            same = torch.equal(column_of(out, "k"), want)
            record(case, SORT_ROWS, ms, peak, equal_to_torch_sort=same)
            if not same:
                raise SystemExit(f"sort_setops {case}: keys differ from "
                                 "torch.sort")
            del out
        if profile:
            profile_call(torch, "sort_setops_profile_sort",
                         lambda: ct.sort_table(t, ["k"]))
        del t, want

        # 2. stability, both directions, against numpy's stable argsort
        sk = keys(STABLE_ROWS, STABLE_KEYS)
        sv = torch.rand(STABLE_ROWS, dtype=torch.float64, device=dev,
                        generator=g)
        st = ct.Table({"k": i64(sk), "v": Column(sv, None, dtypes.float64)},
                      STABLE_ROWS)
        hk, hv = sk.cpu().numpy(), sv.cpu().numpy()
        for asc in (True, False):
            out, ms, peak = timed_twice(
                torch, lambda: ct.sort_table(st, ["k"], asc))
            perm = np.argsort(hk if asc else -hk, kind="stable")
            same = bool(np.array_equal(column_of(out, "k").cpu().numpy(),
                                       hk[perm])
                        and np.array_equal(column_of(out, "v").cpu().numpy(),
                                           hv[perm]))
            record(f"stable_{'asc' if asc else 'desc'}", STABLE_ROWS, ms,
                   peak, equal_to_numpy_stable=same)
            if not same:
                raise SystemExit("sort_setops: the sort is not numpy's "
                                 "stable order")
        del st, out

        # 3. the union of bench_suite.py's cell 4 at 2 x 50M rows
        ua, ub = keys(UNION_ROWS, 1 << SORT_KEY_BITS), keys(UNION_ROWS,
                                                            UNION_ROWS)
        ta = ct.Table({"k": i64(ua)}, UNION_ROWS)
        tb = ct.Table({"k": i64(ub)}, UNION_ROWS)
        out, ms, peak = timed_twice(
            torch, lambda: ct.union(ta, tb, 2 * UNION_ROWS))
        want = torch.unique(torch.cat([ua, ub]))
        got = torch.sort(column_of(out, "k")).values
        same = got.shape == want.shape and torch.equal(got, want)
        record("union", 2 * UNION_ROWS, ms, peak, distinct=out.num_rows,
               distinct_torch_unique=int(want.numel()), equal_as_set=same)
        if not same:
            raise SystemExit("sort_setops union: not torch.unique's set")
        del ta, tb, ua, ub, out, got, want

        # 4. unique, intersect, subtract at 16M a side against numpy
        a_k, b_k = keys(SETOP_ROWS, SETOP_ROWS), keys(SETOP_ROWS, SETOP_ROWS)
        ta = ct.Table({"k": i64(a_k)}, SETOP_ROWS)
        tb = ct.Table({"k": i64(b_k)}, SETOP_ROWS)
        ha, hb = a_k.cpu().numpy(), b_k.cpu().numpy()
        uniq, first = np.unique(ha, return_index=True)
        # on the distinct values: numpy's set ops on the raw 16M rows
        # take most of the phase's time on the host
        uniq_b = np.unique(hb)
        wants = {"unique": uniq,
                 "intersect": np.intersect1d(uniq, uniq_b,
                                             assume_unique=True),
                 "subtract": np.setdiff1d(uniq, uniq_b, assume_unique=True)}
        for case, fn in (("unique", lambda: ct.unique(ta)),
                         ("intersect", lambda: ct.intersect(ta, tb)),
                         ("subtract", lambda: ct.subtract(ta, tb))):
            out, ms, peak = timed_twice(torch, fn)
            got = column_of(out, "k").cpu().numpy()
            same = bool(np.array_equal(np.sort(got), wants[case]))
            extra = {"distinct": len(got), "equal_as_set": same}
            if case == "unique":
                # pandas' drop_duplicates: first occurrences, in order
                extra["first_occurrence_order"] = bool(np.array_equal(
                    got, ha[np.sort(first)]))
                same &= extra["first_occurrence_order"]
            record(case, SETOP_ROWS, ms, peak, **extra)
            if not same:
                raise SystemExit(f"sort_setops {case}: not numpy's set")
        if profile:
            profile_call(torch, "sort_setops_profile_intersect",
                         lambda: ct.intersect(ta, tb))
        del ta, tb, out

        # 5. W = 4 on ThreadWorld against W = 1
        w, nr = GROUPBY_WORLD, SORT_W4_RANK_ROWS
        n = w * nr
        dk = keys(n, 1 << 20)
        dv = torch.rand(n, dtype=torch.float64, device=dev, generator=g)
        xa, xb = keys(n, 2 * n), keys(n, 2 * n) + n // 2

        def table(sl, **cols):
            return ct.Table({c: Column(x[sl], None, dtypes.float64
                                       if x.is_floating_point()
                                       else dtypes.int64)
                             for c, x in cols.items()}, sl.stop - sl.start)

        whole = slice(0, n)
        sort_ref = ct.sort_table(table(whole, k=dk, v=dv), ["k"])
        ops = {"dist_union": ct.union, "dist_intersect": ct.intersect,
               "dist_subtract": ct.subtract}
        refs = {op: row_set(torch, [fn(table(whole, k=xa),
                                       table(whole, k=xb))], ["k"])
                for op, fn in ops.items()}
        refs["dist_unique"] = row_set(torch, [ct.unique(
            table(whole, k=dk, v=dv), ["k"])], ["k", "v"])

        def rank(comm):
            e = ct.CylonEnv(comm)
            sl = slice(e.rank * nr, (e.rank + 1) * nr)
            mine = table(sl, k=dk, v=dv)
            a, b = table(sl, k=xa), table(sl, k=xb)
            out = {"dist_sort_sample": ct.dist_sort(e, mine, "k"),
                   "dist_sort_histogram": ct.dist_sort(
                       e, mine, "k", options=ct.SortOptions(num_bins=256)),
                   "dist_unique": ct.dist_unique(e, mine, ["k"])}
            for op in ops:
                out[op] = getattr(ct, op)(e, a, b)
            return out

        timed = [event_wall(torch, lambda: ct.ThreadWorld(w).run(rank))
                 for _ in range(SORT_W4_REPEATS)]
        runs = [r for r, _ in timed]
        walls = [ms for _, ms in timed]
        per_rank = runs[0]
        launches = launch_counts()

    def matches(run, op) -> bool:
        parts = [r[op] for r in run]
        if op.startswith("dist_sort"):
            return all(torch.equal(torch.cat([column_of(p, c)
                                              for p in parts]),
                                   column_of(sort_ref, c))
                       for c in ("k", "v"))
        names = ["k", "v"] if op == "dist_unique" else ["k"]
        return all(torch.equal(x, y) for x, y in
                   zip(row_set(torch, parts, names), refs[op]))

    out = {"phase": "sort_setops", "case": "w4", "world": w,
           "rows_per_rank": nr, "wall_ms": walls[1],
           "first_run_wall_ms": walls[0], "run_walls_ms": walls,
           "runs": len(runs),
           "rank_rows": {op: [r[op].num_rows for r in per_rank]
                         for op in per_rank[0]}}
    bad = []
    for op in per_rank[0]:
        ok = [matches(r, op) for r in runs]
        out[f"{op}_runs_matching_w1"] = sum(ok)
        if not all(ok):
            bad.append(op)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    if bad:
        raise SystemExit(f"sort_setops W=4: {bad} differ from W=1")
    if launches["scan32"] < 1 or launches["row_hash"] < 1:
        raise SystemExit(f"sort_setops: launches {launches}: the set ops "
                         "did not reach scan32 and row_hash")
    return launches, rec.inputs


# ------------------------------------------------------------ phase 13
#: the quick start's rows a rank at W = 4, and its runs
FRAME_W4_RANK_ROWS = 1 << 20
FRAME_W4_REPEATS = 4
#: the operator graph's chunk rows (16 chunks of a 16M-row side)
FRAME_CHUNK_ROWS = 1 << 20
FRAME_TASKS = 8


def frame_phase(torch, card: str, dev="cuda") -> tuple:
    """The user-facing layer (``DataFrame``, ``Series``, the operator
    graph, the task plan) through the entry points a user calls, each
    result checked; every JSON line carries the card's name and power
    limit (``card``):

    1. local (``env=None``): two frames of :data:`DIST_ROWS` rows built
       from numpy dicts (int64 ``k`` in [0, 16M), float64 ``v``, phase
       4's shape): ``merge(on="k")`` gives phase 4's row count and
       checksum (numpy, rtol 1e-9) and, bit for bit, ``join`` followed
       by ``shrink_to_fit``; ``groupby("k").agg({"v": ["sum",
       "mean"]})`` on phase 9's low-cardinality (10M rows, keys in [0,
       10000)) and high-cardinality (16M rows, 0.6 keys a row) shapes
       equals ``groupby_aggregate`` bit for bit; ``sort_values``,
       ``drop_duplicates``, a mask filter, a derived column, ``len`` and
       ``head(5).to_pandas()`` against the direct op or numpy. For
       ``merge``, ``groupby`` and ``sort_values`` the second call's wall
       (CUDA events) and peak memory beside the direct op's;
    2. the README's quick start at W = 4 on ``ThreadWorld``,
       :data:`FRAME_W4_RANK_ROWS` rows a rank: ``DataFrame(data,
       env=env)``, ``merge``, ``sort_values``, ``groupby(...).agg`` and
       ``drop_duplicates`` with ``env``, and ``to_pandas()``, in
       :data:`FRAME_W4_REPEATS` runs, each equal to W = 1 (row sets;
       the sort in order; the group-by's float aggregates, summed in
       another order, within rtol 1e-9);
    3. the operator graph: ``DisJoinOp("k")`` fed 16 chunks a side
       through ``chunk_stream`` gives the row set of one ``dist_join`` of
       the whole tables; ``task_shuffle`` of :data:`FRAME_TASKS` tasks
       dealt round robin over W = 4 routes every row to its task's rank.

    The launch counters are zeroed before and read after; ``row_hash``,
    ``scan32`` and ``pair_max_scan`` must each have run. Returns
    ``(launches, the inputs the kernels met)``."""
    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.ops_graph import DisJoinOp, chunk_stream
    from cylon_tpu_torch.parallel import (LogicalTaskPlan, TASK_COL,
                                          task_shuffle, task_tables)

    rng = np.random.default_rng(17)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    t0 = time.perf_counter()

    def record(case, **fields):
        row = {"phase": "frame", "case": case, "card": card, **fields,
               "phase_s": time.perf_counter() - t0}
        emit(row)
        return row

    def fail(msg):
        raise SystemExit(f"frame: {msg}")

    def layer(case, frame_fn, direct_fn, n):
        """Both calls twice, the second timed; their results bit for
        bit."""
        got, ms, peak = timed_twice(torch, frame_fn)
        want, dms, dpeak = timed_twice(torch, direct_fn)
        got_t = got.table if hasattr(got, "table") else got
        same = same_bits(torch, got_t, want)
        record(case, rows=n, result_rows=want.num_rows, wall_ms=ms,
               direct_wall_ms=dms, layer_ms=ms - dms, peak_bytes=peak,
               direct_peak_bytes=dpeak, identical_bits=same)
        if not same:
            fail(f"{case} differs from the direct op")
        return got

    rec = PathInputs()
    with rec:
        reset_launches()
        # -- 1. local frames of 16M rows from numpy dicts
        n = DIST_ROWS
        sides = [{"k": rng.integers(0, n, n, dtype=np.int64),
                  "v": rng.random(n)} for _ in range(2)]
        left, right = (ct.DataFrame(d, device=dev) for d in sides)
        lt, rt = left.table, right.table
        merged = layer("merge", lambda: left.merge(right, on="k"),
                       lambda: ct.join(lt, rt, on="k").shrink_to_fit(), n)
        rows = len(merged)
        check = float((column_of(merged.table, "v_x")
                       * column_of(merged.table, "v_y")).sum())
        (lk, lv), (rk, rv) = [(d["k"], d["v"]) for d in sides]
        want_rows = int((np.bincount(lk, minlength=n).astype(np.int64)
                         * np.bincount(rk, minlength=n)).sum())
        want_check = float((np.bincount(lk, weights=lv, minlength=n)
                            * np.bincount(rk, weights=rv, minlength=n))
                           .sum())
        record("merge_check", result_rows=rows, expected_rows=want_rows,
               checksum=check, expected_checksum=want_check)
        if rows != want_rows or \
                abs(check - want_check) > 1e-9 * abs(want_check):
            fail("merge: rows or checksum differ from numpy")
        del merged

        aggs = [("v", "sum", "v_sum"), ("v", "mean", "v_mean")]
        for case, rows_, nkeys in (
                ("groupby_lowcard", GROUPBY_LOW_ROWS, GROUPBY_LOW_KEYS),
                ("groupby_highcard", GROUPBY_ROWS, GROUPBY_HIGH_KEYS)):
            t = ct.Table({
                "k": Column(torch.randint(0, nkeys, (rows_,),
                                          dtype=torch.int64, device=dev,
                                          generator=g), None, dtypes.int64),
                "v": Column(torch.randn(rows_, dtype=torch.float64,
                                        device=dev, generator=g), None,
                            dtypes.float64)}, rows_)
            df = ct.DataFrame(t)
            layer(case, lambda: df.groupby("k").agg({"v": ["sum", "mean"]}),
                  lambda: ct.groupby_aggregate(t, ["k"], aggs)
                  .shrink_to_fit(), rows_)
            del t, df

        layer("sort_values", lambda: left.sort_values("k"),
              lambda: ct.sort_table(lt, ["k"]), n)
        same = {
            "drop_duplicates": same_bits(
                torch, left.drop_duplicates(subset="k").table,
                ct.unique(lt, ["k"]).shrink_to_fit()),
            "mask_filter": same_bits(
                torch, left[left["v"] > 0.5].table,
                ct.filter_table(lt, lt.column("v").data > 0.5)
                .shrink_to_fit())}
        df = ct.DataFrame(left)
        df["w"] = df["v"] * 2 + 1
        same["derived_column"] = torch.equal(
            df.table.column("w").data, lt.column("v").data * 2 + 1) \
            and df.dtypes["w"] == dtypes.float64
        same["len"] = len(df) == n
        head = df.head(5).to_pandas()
        same["head"] = bool(
            np.array_equal(head["k"].to_numpy(), lk[:5])
            and np.array_equal(head["v"].to_numpy(), lv[:5])
            and np.array_equal(head["w"].to_numpy(), lv[:5] * 2 + 1))
        record("local_ops", rows=n, **same)
        if not all(same.values()):
            fail(f"local ops differ: {same}")
        del df

        # -- 2. the README's quick start at W = 4 against W = 1
        w, nr = GROUPBY_WORLD, FRAME_W4_RANK_ROWS
        nw = w * nr
        ldata = {"k": rng.integers(0, nw, nw, dtype=np.int64),
                 "g": rng.integers(0, 1000, nw, dtype=np.int64),
                 "v": rng.random(nw)}
        rdata = {"k": rng.integers(0, nw, nw, dtype=np.int64),
                 "w": rng.random(nw)}

        def quick_start(env):
            big = ct.DataFrame(ldata, env=env, device=dev)
            other = ct.DataFrame(rdata, env=env, device=dev)
            res = big.merge(other, on="k", env=env)
            srt = res.sort_values("k", env=env)
            agg = big.groupby("g", env=env).agg({"v": ["sum", "mean"]})
            uniq = big.drop_duplicates(subset="k", env=env)
            pdf = srt.to_pandas()   # a collective: every rank gathers
            return {"merge": res.table, "sort": srt.table,
                    "groupby": agg.table, "drop_duplicates": uniq.table,
                    "pandas": pdf if env.rank == 0 else None}

        ref = quick_start(ct.CylonEnv(device=dev))
        timed = [event_wall(torch, lambda: ct.ThreadWorld(w).run(
            lambda comm: quick_start(ct.CylonEnv(comm))))
            for _ in range(FRAME_W4_REPEATS)]
        names = {"merge": ["k", "v", "g", "w"],
                 "drop_duplicates": ["k", "g", "v"]}

        def matches(run) -> bool:
            for op, cols in names.items():
                if not all(torch.equal(a, b) for a, b in zip(
                        row_set(torch, [r[op] for r in run], cols),
                        row_set(torch, [ref[op]], cols))):
                    return False
            # the group keys exactly; the float aggregates, summed in
            # another order over four ranks, within rtol 1e-9 (phase 9's)
            parts = [r["groupby"] for r in run]
            keys = torch.cat([column_of(t, "g") for t in parts])
            order = torch.sort(keys).indices
            if not torch.equal(keys[order], column_of(ref["groupby"], "g")):
                return False
            for c in ("v_sum", "v_mean"):
                got = torch.cat([column_of(t, c) for t in parts])[order]
                if not torch.allclose(got, column_of(ref["groupby"], c),
                                      rtol=1e-9, atol=0):
                    return False
            sort_cols = ref["sort"].column_names
            in_order = all(torch.equal(
                torch.cat([bits_of(torch, column_of(r["sort"], c))
                           for r in run]),
                bits_of(torch, column_of(ref["sort"], c)))
                for c in sort_cols)
            pdf = run[0]["pandas"]
            return in_order and all(np.array_equal(
                pdf[c].to_numpy(), ref["pandas"][c].to_numpy())
                for c in sort_cols)

        ok = [matches(r) for r, _ in timed]
        walls = [ms for _, ms in timed]
        record("quick_start_w4", world=w, rows_per_rank=nr,
               merge_rows=ref["merge"].num_rows, wall_ms=walls[1],
               first_run_wall_ms=walls[0], run_walls_ms=walls,
               runs=len(ok), runs_matching_w1=sum(ok))
        if not all(ok):
            fail(f"quick start W=4: {ok.count(False)} runs differ from W=1")
        del ref, timed

        # -- 3. the operator graph and the task plan
        def graph_join():
            graph = DisJoinOp("k")
            for chunk in chunk_stream(lt, FRAME_CHUNK_ROWS):
                graph.insert_left(chunk)
            for chunk in chunk_stream(rt, FRAME_CHUNK_ROWS):
                graph.insert_right(chunk)
            return graph.result()

        got, ms = event_wall(torch, graph_join)
        whole = ct.dist_join(ct.CylonEnv(device=dev), lt, rt, on="k")
        cols = whole.column_names
        same = all(torch.equal(a, b) for a, b in zip(
            row_set(torch, [got], cols), row_set(torch, [whole], cols)))
        record("dis_join_op", chunks_a_side=n // FRAME_CHUNK_ROWS,
               result_rows=got.num_rows, expected_rows=whole.num_rows,
               wall_ms=ms, equal_to_dist_join=same)
        if not same:
            fail("DisJoinOp over chunks differs from one dist_join")
        del got, whole

        plan = LogicalTaskPlan.round_robin(FRAME_TASKS, w)
        tk = torch.randint(0, nw, (nw,), dtype=torch.int64, device=dev,
                           generator=g)
        tt = torch.randint(0, FRAME_TASKS, (nw,), dtype=torch.int64,
                           device=dev, generator=g)

        def route(comm):
            env = ct.CylonEnv(comm)
            sl = slice(env.rank * nr, (env.rank + 1) * nr)
            mine = ct.Table({"k": Column(tk[sl], None, dtypes.int64),
                             TASK_COL: Column(tt[sl], None, dtypes.int64)},
                            nr)
            sh = task_shuffle(env, mine, TASK_COL, plan)
            tasks = task_tables(env, sh, plan)
            owner = torch.tensor(plan.worker_of(), device=dev)[
                column_of(sh, TASK_COL)]
            return sh, bool((owner == env.rank).all()), \
                sum(t.num_rows for t in tasks.values())

        routed, ms = event_wall(torch, lambda: ct.ThreadWorld(w).run(route))
        whole = ct.Table({"k": Column(tk, None, dtypes.int64),
                          TASK_COL: Column(tt, None, dtypes.int64)}, nw)
        same = all(torch.equal(a, b) for a, b in zip(
            row_set(torch, [r[0] for r in routed], ["k", TASK_COL]),
            row_set(torch, [whole], ["k", TASK_COL])))
        owned = all(r[1] for r in routed)
        split = [r[2] for r in routed] == [r[0].num_rows for r in routed]
        record("task_plan", world=w, tasks=FRAME_TASKS, rows=nw,
               rank_rows=[r[0].num_rows for r in routed], wall_ms=ms,
               same_rows=same, every_row_on_its_task_rank=owned,
               task_tables_cover=split)
        if not (same and owned and split):
            fail("task_shuffle misrouted rows")
        launches = launch_counts()
    record("launches", launches=launches, seconds=time.perf_counter() - t0)
    missing = [k for k in ("row_hash", "scan32", "pair_max_scan")
               if launches[k] < 1]
    if missing:
        fail(f"launches {launches}: {missing} never ran")
    return launches, rec.inputs


# ------------------------------------------------------------ phase 14
#: part (a): all 22 queries at this scale factor (lineitem about 6M rows)
TPCH_SF = 1.0
#: part (b): BASELINE.json's configuration 5, TPC-H SF 100 Q3/Q5 over ten
#: cards, at one card's share
TPCH_BASELINE_SF = 10.0
TPCH_BASELINE_QUERIES = ("q3", "q5")
#: part (c): the SPMD runs at W = 4 on ThreadWorld
TPCH_W4_SF = 0.1
TPCH_W4_QUERIES = ("q1", "q3", "q5", "q6", "q16", "q22")
TPCH_W4_REPEATS = 4
TPCH_SEED = 0
TPCH_RTOL = 1e-9
#: traced under ``--profile``: the slowest SF 1 queries on an H100 (q22's
#: time is host time, q21's and q1's device time)
TPCH_PROFILED = ("q1", "q21", "q22")


def manifest_keep(manifest, queries) -> dict:
    """The generator's ``keep`` for ``queries``: the union of their
    manifest column sets, by table."""
    keep = {}
    for qn in queries:
        for t, cols in manifest[qn].items():
            keep.setdefault(t, set()).update(cols)
    return keep


def host_result(out):
    """A query's result on the host: a pandas frame (a collective on a
    distributed frame) or a float."""
    return out.to_pandas() if hasattr(out, "to_pandas") else float(out)


def results_match(np, got, want, rtol: float = TPCH_RTOL) -> bool:
    """Two query results agree: scalars within ``rtol``; frames with the
    same columns and rows, integer, date and string columns exactly,
    floats within ``rtol``, in order, or, where ties in the final sort
    permuted rows, as sorted rows (``tests/test_tpch.py:_frame_close``)."""
    if not hasattr(want, "columns"):
        return bool(np.isclose(got, want, rtol=rtol, atol=0.0,
                               equal_nan=True))
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return False

    def close(g, w):
        for c in w.columns:
            a, b = g[c].to_numpy(), w[c].to_numpy()
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                if not np.allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=rtol,
                                   atol=0.0, equal_nan=True):
                    return False
            elif list(a) != list(b):
                return False
        return True

    g, w = got.reset_index(drop=True), want.reset_index(drop=True)
    if close(g, w):
        return True
    cols = list(w.columns)
    return close(g.sort_values(cols).reset_index(drop=True),
                 w.sort_values(cols).reset_index(drop=True))


def tpch_q3_pandas(pdfs, date_int, segment="BUILDING", cutoff=None,
                   limit=10):
    """TPC-H Q3 in pandas (a copy of ``tests/test_tpch.py:q3_pandas``)."""
    if cutoff is None:
        cutoff = date_int(1995, 3, 15)
    c = pdfs["customer"]
    o = pdfs["orders"]
    l = pdfs["lineitem"]
    c = c[c.c_mktsegment == segment]
    o = o[o.o_orderdate < cutoff]
    l = l[l.l_shipdate > cutoff].copy()
    l["revenue"] = l.l_extendedprice * (1 - l.l_discount)
    j = l.merge(o.merge(c, left_on="o_custkey", right_on="c_custkey"),
                left_on="l_orderkey", right_on="o_orderkey")
    g = (j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                   as_index=False)["revenue"].sum())
    g = g.sort_values(["revenue", "o_orderdate"],
                      ascending=[False, True]).head(limit)
    return g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]


def tpch_q5_pandas(pdfs, date_int, region="ASIA", date_from=None,
                   date_to=None):
    """TPC-H Q5 in pandas (a copy of ``tests/test_tpch.py:q5_pandas``)."""
    if date_from is None:
        date_from = date_int(1994, 1, 1)
    if date_to is None:
        date_to = date_int(1995, 1, 1)
    r = pdfs["region"]
    n = pdfs["nation"]
    s = pdfs["supplier"]
    c = pdfs["customer"]
    o = pdfs["orders"]
    l = pdfs["lineitem"].copy()
    l["revenue"] = l.l_extendedprice * (1 - l.l_discount)
    r = r[r.r_name == region]
    nat = n.merge(r, left_on="n_regionkey", right_on="r_regionkey")
    sup = s.merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    o = o[(o.o_orderdate >= date_from) & (o.o_orderdate < date_to)]
    j = (l.merge(o.merge(c, left_on="o_custkey", right_on="c_custkey"),
                 left_on="l_orderkey", right_on="o_orderkey")
          .merge(sup, left_on="l_suppkey", right_on="s_suppkey"))
    j = j[j.c_nationkey == j.s_nationkey]
    g = j.groupby("n_name", as_index=False)["revenue"].sum()
    return g.sort_values("revenue", ascending=False)[["n_name", "revenue"]]


def q3_matches(np, got, want) -> bool:
    """``tests/test_tpch.py:_assert_q3_equal`` as a predicate: the
    revenue order holds (ties may permute), and the rows by their group
    keys are the oracle's."""
    if len(got) != len(want):
        return False
    rev = got.revenue.to_numpy()
    if not np.all(np.diff(rev) <= 1e-9 * np.abs(rev[:-1]) + 1e-9):
        return False
    keys = ["l_orderkey", "o_orderdate", "o_shippriority"]
    g = got.sort_values(keys).reset_index(drop=True)
    w = want.sort_values(keys).reset_index(drop=True)
    return all(list(g[c]) == list(w[c]) for c in keys) and np.allclose(
        g.revenue.to_numpy(), w.revenue.to_numpy(), rtol=TPCH_RTOL, atol=0)


def timed_calls(torch, fn):
    """``(second result, first wall ms, second wall ms, second call's peak
    bytes, bytes allocated before it)``: two calls between CUDA events,
    the peak counter reset before the second."""
    _, first = event_wall(torch, fn)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, second = event_wall(torch, fn)
    return out, first, second, torch.cuda.max_memory_allocated(), resident


def tpch_phase(torch, card: str, profile: bool = False,
               dev="cuda") -> tuple:
    """Whole TPC-H queries through the port's entry points
    (``cylon_tpu_torch.tpch``), each result checked; every JSON line
    carries the card's name and power limit (``card``):

    (a) all 22 queries at :data:`TPCH_SF`, eager, W = 1, default
        parameters, on tables generated with ``keep`` the union of the
        manifest's column sets and ingested once (``tpch.ingest``): each
        query's second call timed by CUDA events with its peak memory,
        and its result equal to the same query run by the port on the
        CPU (the plain versions) on the same data
        (:func:`results_match`);
    (b) BASELINE.json's configuration 5 cut to one card: Q3 and Q5 at
        :data:`TPCH_BASELINE_SF`, each eagerly and through
        ``tpch.compiled``, the compiled result bit for bit the eager one
        and both equal to a pandas oracle of the SQL; host seconds of
        generation and ingest apart;
    (c) q1, q3, q5, q6, q16 and q22 at :data:`TPCH_W4_SF` at W = 4 on
        ``ThreadWorld``, every rank calling the query with the same
        frames, :data:`TPCH_W4_REPEATS` runs each equal to W = 1 (q22's
        orders cut to 5 %, so that idle customers exist);
    (d) the launch counters zeroed before and read after: ``row_hash``
        (in part (c)), ``scan32`` and ``pair_max_scan`` must each have
        run, the bucket kernels never.

    With ``profile``, :data:`TPCH_PROFILED` at SF 1 and Q3 and Q5 at
    SF 10 are traced once more (:func:`profile_call`).

    Returns ``(launches, the inputs the kernels met)`` for
    :func:`path_kernel_phase`."""
    import numpy as np
    import pandas as pd

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.tpch.manifest import MANIFEST

    queries = [f"q{i}" for i in range(1, 23)]
    t0 = time.perf_counter()

    def record(part, case, **fields):
        row = {"phase": "tpch", "part": part, "case": case, "card": card,
               **fields, "phase_s": time.perf_counter() - t0}
        emit(row)
        return row

    def fail(msg):
        raise SystemExit(f"tpch: {msg}")

    def rows_of(out):
        return len(out) if hasattr(out, "to_pandas") else 1

    def generate(sf, names):
        """``(data, frames, {"generate": s, "ingest": s, table: s})``:
        generation and each table's ingest in host seconds."""
        t = time.perf_counter()
        data = tpch.generate(sf, TPCH_SEED, keep=manifest_keep(MANIFEST,
                                                              names))
        secs = {"generate": time.perf_counter() - t}
        frames = {}
        for name, cols in data.items():
            t = time.perf_counter()
            frames.update(tpch.ingest({name: cols}, device=dev))
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
        secs["ingest"] = sum(v for k, v in secs.items() if k != "generate")
        return data, frames, secs

    rec = PathInputs()
    reset_launches()

    # -- (a) all 22 queries at SF 1 against the port on the CPU
    data, frames, secs = generate(TPCH_SF, queries)
    record("a", "data", sf=TPCH_SF, host_s=secs,
           lineitem_rows=len(data["lineitem"]["l_orderkey"]),
           resident_bytes=torch.cuda.memory_allocated())
    card_out = {}
    with rec:
        for qn in queries:
            q = getattr(tpch, qn)
            out, first, ms, peak, resident = timed_calls(
                torch, lambda: q(frames))
            card_out[qn] = host_result(out)
            record("a", qn, wall_ms=ms, first_wall_ms=first,
                   peak_bytes=peak, resident_bytes=resident,
                   result_rows=rows_of(out))
            del out
    if profile:
        # where the slowest queries' time goes
        for qn in TPCH_PROFILED:
            q = getattr(tpch, qn)
            profile_call(torch, f"tpch_profile_{qn}", lambda: q(frames),
                         card=card)
    del frames
    cpu_frames = tpch.ingest(data, device="cpu")
    del data
    t = time.perf_counter()
    bad = []
    for qn in queries:
        want = host_result(getattr(tpch, qn)(cpu_frames))
        if not results_match(np, card_out[qn], want):
            bad.append(qn)
    record("a", "equal_to_cpu", queries=len(queries),
           matching=len(queries) - len(bad), differing=bad,
           cpu_host_s=time.perf_counter() - t)
    if bad:
        fail(f"SF {TPCH_SF}: {bad} differ from the port on the CPU")
    del cpu_frames, card_out
    torch.cuda.empty_cache()

    # -- (b) BASELINE.json configuration 5 at one card's share
    data, frames, secs = generate(TPCH_BASELINE_SF, TPCH_BASELINE_QUERIES)
    li = data["lineitem"]
    record("b", "data", sf=TPCH_BASELINE_SF, host_s=secs,
           lineitem_rows=len(li["l_orderkey"]),
           lineitem_columns=sorted(li),
           resident_bytes=torch.cuda.memory_allocated())
    pdfs = {k: pd.DataFrame(v) for k, v in data.items()}
    del data, li
    oracles = {"q3": tpch_q3_pandas, "q5": tpch_q5_pandas}
    for qn in TPCH_BASELINE_QUERIES:
        q, cq = getattr(tpch, qn), tpch.compiled(qn)
        with rec:
            eager, e_first, e_ms, e_peak, resident = timed_calls(
                torch, lambda: q(frames))
            comp, c_first, c_ms, c_peak, _ = timed_calls(
                torch, lambda: cq(frames))
        same = same_bits(torch, eager.table, comp.table)
        got = eager.to_pandas()
        t = time.perf_counter()
        want = oracles[qn](pdfs, tpch.date_int)
        oracle_s = time.perf_counter() - t
        ok = q3_matches(np, got, want) if qn == "q3" \
            else results_match(np, got.reset_index(drop=True),
                               want.reset_index(drop=True))
        record("b", qn, eager_wall_ms=e_ms, eager_first_wall_ms=e_first,
               compiled_wall_ms=c_ms, compiled_first_wall_ms=c_first,
               eager_peak_bytes=e_peak, compiled_peak_bytes=c_peak,
               resident_bytes=resident, result_rows=len(got),
               compiled_equal_bits=same, equal_to_pandas=ok,
               pandas_host_s=oracle_s)
        if not (same and ok):
            fail(f"SF {TPCH_BASELINE_SF} {qn}: compiled equal {same}, "
                 f"pandas equal {ok}")
        del eager, comp
        if profile:
            profile_call(torch, f"tpch_profile_sf10_{qn}",
                         lambda: q(frames), card=card)
    del frames, pdfs
    torch.cuda.empty_cache()

    # -- (c) SPMD at W = 4 against W = 1
    w = GROUPBY_WORLD
    data, frames, _ = generate(TPCH_W4_SF, TPCH_W4_QUERIES)
    n_keep = max(len(data["orders"]["o_custkey"]) // 20, 1)
    idle = dict(data, orders={k: v[:n_keep]
                              for k, v in data["orders"].items()})
    inputs = {qn: frames for qn in TPCH_W4_QUERIES}
    inputs["q22"] = tpch.ingest(idle, device=dev)
    codes = tuple(sorted({p[:2] for p in data["customer"]["c_phone"]}))
    kwargs = {qn: {} for qn in TPCH_W4_QUERIES}
    kwargs["q22"] = {"codes": codes}
    del data, idle
    before_c = launch_counts()
    with rec:
        for qn in TPCH_W4_QUERIES:
            q, fr, kw = getattr(tpch, qn), inputs[qn], kwargs[qn]
            ref = host_result(q(fr, env=ct.CylonEnv(device=dev), **kw))
            timed = [event_wall(torch, lambda: ct.ThreadWorld(w).run(
                lambda comm: host_result(q(
                    fr, env=ct.CylonEnv(comm, device=dev), **kw))))
                for _ in range(TPCH_W4_REPEATS)]
            ok = [all(results_match(np, r, ref) for r in res)
                  for res, _ in timed]
            walls = [ms for _, ms in timed]
            record("c", qn, world=w, sf=TPCH_W4_SF,
                   result_rows=len(ref) if hasattr(ref, "columns") else 1,
                   wall_ms=walls[1], first_run_wall_ms=walls[0],
                   run_walls_ms=walls, runs=len(ok),
                   runs_matching_w1=sum(ok))
            if not all(ok):
                fail(f"{qn} W=4: {ok.count(False)} runs differ from W=1")
    launches = launch_counts()
    hashed_c = launches["row_hash"] - before_c["row_hash"]
    del inputs, frames
    torch.cuda.empty_cache()
    record("d", "launches", launches=launches, row_hash_in_part_c=hashed_c,
           seconds=time.perf_counter() - t0)
    missing = [k for k in ("row_hash", "scan32", "pair_max_scan")
               if launches[k] < 1]
    if missing or hashed_c < 1:
        fail(f"launches {launches}: {missing} never ran "
             f"(row_hash in part (c): {hashed_c})")
    if launches["bucket_build"] or launches["bucket_probe"]:
        fail(f"launches {launches}: the bucket kernels ran on a path "
             "whose joins are sort joins")
    return launches, rec.inputs


# ------------------------------------------------------------ main
# ------------------------------------------------------------ phase 15
#: the telemetry phase's W = 4 share: the 16M-row flagship share split
#: over the ranks, a side
TELEMETRY_W4_RANK_ROWS = 4 << 20


def memory_line(torch, card: str, after: str) -> None:
    """One line at the end of a phase: ``telemetry.memory``'s forced
    sample, the caching allocator's live and peak bytes (the peak then
    reset) and its reserved bytes, then the live bytes again after a
    ``gc.collect()``, so that memory held only by unreachable cycles
    shows as the difference. A telemetry failure fails the run."""
    import gc

    from cylon_tpu_torch import telemetry

    sampled = telemetry.memory.sample(force=True)
    allocated = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    gc.collect()
    after_gc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    emit({"phase": "memory", "after": after, "card": card,
          "sampled_bytes": sampled, "allocated_bytes": allocated,
          "max_allocated_bytes": peak, "reserved_bytes": reserved,
          "allocated_after_gc_bytes": after_gc})
    if sampled != allocated:
        raise SystemExit(f"memory after {after}: telemetry sampled "
                         f"{sampled} bytes, the allocator holds "
                         f"{allocated}")


def count_syncs(torch, fn):
    """``(result, synchronizing calls by site)`` of one call of ``fn``
    under ``torch.cuda.set_sync_debug_mode("warn")``: each call that
    waits for the card warns once, and the warnings are counted by the
    ``file:line`` of the Python call that made them (the file's path in
    the repo, or its name outside it)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            path = Path(w.filename).resolve()
            name = path.relative_to(ROOT).as_posix() \
                if path.is_relative_to(ROOT) else path.name
            key = f"{name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return out, sites


def telemetry_syncs(runs) -> list:
    """The sync sites of ``runs`` (:func:`count_syncs`'s dicts) that lie
    in telemetry's own code (its package, the span, the exchange pricing
    ``dist_ops._note_exchange``) or in the resilience layer's (the fault
    plans and the spill store, the watchdog, and the exchanges' row
    accounting ``dist_ops._account_exchange_rows``)."""
    import inspect

    from cylon_tpu_torch.parallel import dist_ops

    own_lines = set()
    for fn in (dist_ops._note_exchange, dist_ops._account_exchange_rows):
        lines, at = inspect.getsourcelines(fn)
        own_lines.update(range(at, at + len(lines)))
    own_files = ("cylon_tpu_torch/utils/tracing.py",
                 "cylon_tpu_torch/resilience.py",
                 "cylon_tpu_torch/watchdog.py")
    own = set()
    for sites in runs:
        for site in sites:
            path, line = site.rsplit(":", 1)
            if path.startswith("cylon_tpu_torch/telemetry/") \
                    or path in own_files \
                    or (path == "cylon_tpu_torch/parallel/dist_ops.py"
                        and int(line) in own_lines):
                own.add(site)
    return sorted(own)


@contextlib.contextmanager
def armed(tmp: str):
    """Arm the flight recorder and the exporters (``CYLON_TPU_TRACE``,
    ``CYLON_TPU_METRICS_DIR``) for the enclosed runs, on an empty
    recorder; disarm after, so that nothing writes at exit."""
    import os

    from cylon_tpu_torch.telemetry import trace

    os.environ["CYLON_TPU_TRACE"] = "1"
    os.environ["CYLON_TPU_METRICS_DIR"] = tmp
    trace.clear()
    try:
        yield
    finally:
        del os.environ["CYLON_TPU_TRACE"]
        del os.environ["CYLON_TPU_METRICS_DIR"]


def telemetry_phase(torch, rate, stats, card: str, dev="cuda") -> dict:
    """The telemetry core on the card (phase 15).

    (a) Its cost: ``dist_join`` at 16M x 16M, W = 1, and one bench stage
    (1M a side), each run untraced and then with the flight recorder and
    the exporters armed, on the same inputs: the rows bit for bit, the
    kernel launches and the synchronizing calls
    (:func:`count_syncs`) equal, none in telemetry's code
    (:func:`telemetry_syncs`), both walls printed; the armed run's
    spans recorded and its metrics snapshot written and parsed back.
    The W = 1 ``dist_join`` short-circuits: no stage span, no exchange
    pricing runs there.
    (b) ``dist_join`` at W = 4 through ``ThreadWorld``,
    :data:`TELEMETRY_W4_RANK_ROWS` rows a rank a side, where the stage
    spans, the exchange pricing and its memory samples run: untraced and
    armed in alternation, compared as in (a); every run's world
    ``exchange.bytes_true`` equal to the rows the ranks sent times their
    words times 4. Of the last armed run: the rank buffers merged
    (``merge_timelines``), ``critical_path`` and each rank's
    ``stage_coverage`` printed, every rank's coverage at least 0.8, the
    ``exchange.dispatch`` instants' row counts (from the count matrices)
    equal to the rows sent, the Chrome trace written and read back as
    strict JSON. Then each kernel against its plain version at the
    shapes this phase gave it, as in phase 10. Returns the kernels'
    launches over the runs it compared (untraced and armed)."""
    import tempfile

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import dtypes, telemetry
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.parallel.shuffle import transport_words
    from cylon_tpu_torch.telemetry import trace

    def no_const(_):
        raise SystemExit("telemetry: a non-finite constant in the trace")

    g = torch.Generator(device=dev)
    g.manual_seed(16)

    def table(n, lo=0, keys=None, vals=None):
        k = torch.randint(0, n, (n,), dtype=torch.int64, device=dev,
                          generator=g) if keys is None else keys
        v = torch.rand(n, dtype=torch.float64, device=dev, generator=g) \
            if vals is None else vals
        return ct.Table({"k": Column(k, None, dtypes.int64),
                         "v": Column(v, None, dtypes.float64)},
                        k.shape[0])

    total = {k: 0 for k in launch_counts()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    with tempfile.TemporaryDirectory() as tmp:
        # (a) telemetry's cost at W = 1
        n = DIST_ROWS
        left, right = table(n), table(n)
        env = ct.CylonEnv(device=dev)
        bl, br = table(BENCH_ROWS), table(BENCH_ROWS)
        comm = ct.LocalComm()
        cases = {
            "dist_join": lambda: ct.dist_join(env, left, right, on="k"),
            "bench_stage": lambda: bench_stage(comm, bl, br,
                                               2 * BENCH_ROWS,
                                               2 * BENCH_ROWS)}
        cost = {}
        for name, fn in cases.items():
            fn()                                          # warm-up
            # a second warm-up with the sync check on: a site that warns
            # once a process (the first synchronize under the check) warns
            # here, not in the runs compared
            count_syncs(torch, lambda: event_wall(torch, fn))
            runs = []
            # untraced, armed, untraced, armed: the pairs are compared
            for mode in ("untraced", "armed") * 2:
                ctx = armed(tmp) if mode == "armed" else \
                    contextlib.nullcontext()
                with ctx:
                    reset_launches()
                    (res, ms), sites = count_syncs(
                        torch, lambda: event_wall(torch, fn))
                    res.num_rows
                    launches = launch_counts()
                    evts = trace.events()
                runs.append({"mode": mode, "ms": ms, "syncs": sites,
                             "launches": launches, "events": len(evts),
                             "res": res})
                add(launches)
            same = [same_bits(torch, runs[0]["res"], r["res"])
                    for r in runs[1:]]
            cost[name] = {
                "ms": [r["ms"] for r in runs],
                "modes": [r["mode"] for r in runs],
                "syncs": [sum(r["syncs"].values()) for r in runs],
                "sync_sites": [r["syncs"] for r in runs],
                "launches": [r["launches"] for r in runs],
                "armed_events": [r["events"] for r in runs[1::2]],
                "rows": runs[0]["res"].num_rows, "rows_equal": all(same)}
            bad = [i for i in (0, 2) if runs[i]["launches"]
                   != runs[i + 1]["launches"]
                   or runs[i]["syncs"] != runs[i + 1]["syncs"]]
            own = telemetry_syncs(r["syncs"] for r in runs)
            if not all(same) or bad or own:
                emit({"phase": "telemetry", "part": "a", "case": name,
                      **cost[name]})
                raise SystemExit(f"telemetry {name}: an armed run differs "
                                 f"from the untraced one before it (pairs "
                                 f"{bad}, rows equal {same}), or telemetry "
                                 f"synchronized at {own}")
            if not all(cost[name]["armed_events"]):
                raise SystemExit(f"telemetry {name}: an armed run "
                                 "recorded no event")
            for r in runs:
                del r["res"]
        del left, right, bl, br, runs, res
        path = telemetry.write_snapshot(directory=tmp)
        with open(path) as f:
            snap = json.loads(f.read().splitlines()[-1])["metrics"]
        emit({"phase": "telemetry", "part": "a", "card": card,
              "cost": cost, "snapshot_series": len(snap)})

        # (b) W = 4 on ThreadWorld, untraced and armed
        w, nr = GROUPBY_WORLD, TELEMETRY_W4_RANK_ROWS
        nw = w * nr
        sides = [(torch.randint(0, nw, (nw,), dtype=torch.int64, device=dev,
                                generator=g),
                  torch.rand(nw, dtype=torch.float64, device=dev,
                             generator=g)) for _ in range(2)]

        def rank(comm):
            e = ct.CylonEnv(comm, device=dev)
            lo, hi = e.rank * nr, (e.rank + 1) * nr
            return ct.dist_join(e, *[table(nr, keys=k[lo:hi],
                                           vals=v[lo:hi])
                                     for k, v in sides], on="k")

        def world():
            return event_wall(torch, lambda: ct.ThreadWorld(w).run(rank))

        # the warm-up, under the sync check (see part (a)), records the
        # kernels' inputs: their copies stay out of the compared walls
        with PathInputs() as rec:
            count_syncs(torch, world)
        runs = []
        # untraced, armed, untraced, armed: each pair compared, as in (a)
        for mode in ("untraced", "armed") * 2:
            ctx = armed(tmp) if mode == "armed" else \
                contextlib.nullcontext()
            telemetry.reset("exchange.")
            with ctx:
                reset_launches()
                (res, ms), sites = count_syncs(torch, world)
                launches = launch_counts()
                bufs = trace.rank_buffers() if mode == "armed" else None
            add(launches)
            runs.append({"mode": mode, "ms": ms, "syncs": sites,
                         "launches": launches, "res": res, "bufs": bufs,
                         "bytes": telemetry.total("exchange.bytes_true"),
                         "rows": telemetry.total("exchange.rows")})
        traced, bufs = runs[-1]["res"], runs[-1]["bufs"]
        merged = trace.merge_timelines(bufs)
        crit = trace.critical_path(merged)
        coverage = {b["rank"]: trace.stage_coverage(b["events"],
                                                    "dist_join")
                    for b in bufs}
        words = transport_words(table(1))
        want_bytes = 2 * nw * words * 4
        shard_rows = [e["args"]["rows_shards"] for e in merged
                      if e["name"] == "exchange.dispatch"]
        tpath = telemetry.write_chrome_trace(
            f"{tmp}/dist_join_w4.trace.json", bufs, world=w)
        with open(tpath) as f:
            doc = json.loads(f.read(), parse_constant=no_const)
        same = [all(same_bits(torch, a, b) for a, b in
                    zip(runs[0]["res"], r["res"])) for r in runs[1:]]
        own = telemetry_syncs(r["syncs"] for r in runs)
        bad = [i for i in (0, 2) if runs[i]["launches"]
               != runs[i + 1]["launches"]
               or runs[i]["syncs"] != runs[i + 1]["syncs"]]
        out = {"phase": "telemetry", "part": "b", "card": card,
               "world": w, "rows_per_rank_side": nr,
               "modes": [r["mode"] for r in runs],
               "ms": [r["ms"] for r in runs],
               "syncs": [sum(r["syncs"].values()) for r in runs],
               "sync_sites": [r["syncs"] for r in runs],
               "telemetry_sync_sites": own,
               "launches": [r["launches"] for r in runs],
               "wall_ms": runs[-1]["ms"],
               "buffers": sorted(b["rank"] for b in bufs),
               "events": len(merged), "coverage": coverage,
               "critical_path": {
                   "straggler_rank": crit["straggler_rank"],
                   "dominant_stage": crit["dominant_stage"],
                   "excess_seconds": crit["excess_seconds"],
                   "rank_walls": crit["rank_walls"],
                   "stage_seconds": crit["stage_seconds"]},
               "exchange_rows": [r["rows"] for r in runs],
               "exchange_bytes_true": [r["bytes"] for r in runs],
               "expected_bytes_true": want_bytes,
               "dispatch_instants": len(shard_rows),
               "chrome_events": len(doc["traceEvents"]),
               "runs_equal_first": same}
        emit(out)
        if bad or own:
            raise SystemExit(f"telemetry W=4: an armed run differs from "
                             f"the untraced one before it (pairs {bad}), "
                             f"or telemetry synchronized at {own}")
        if sorted(coverage) != list(range(w)) or any(
                c is None or c < 0.8 for c in coverage.values()):
            raise SystemExit(f"telemetry W=4: stage coverage {coverage}")
        if any(r["bytes"] != want_bytes or r["rows"] != 2 * nw
               for r in runs):
            raise SystemExit(f"telemetry W=4: exchange.bytes_true "
                             f"{out['exchange_bytes_true']}, rows "
                             f"{out['exchange_rows']}; expected "
                             f"{want_bytes}, {2 * nw}")
        if len(shard_rows) != w or sum(sum(r) for r in shard_rows) \
                != w * 2 * nw:
            raise SystemExit(f"telemetry W=4: dispatch instants' rows "
                             f"{shard_rows}")
        if not all(same):
            raise SystemExit(f"telemetry W=4: runs {same} differ from "
                             "the first, untraced one")
        del runs, traced, bufs, res, sides
        trace.clear()
    path_kernel_phase(torch, rate, stats, "telemetry", rec.inputs,
                      card=card)
    return total


# ------------------------------------------------------------ phase 16
#: the out-of-core join's configuration (``cylon_tpu/outofcore.py:188``
#: names the 100M x 100M join): rows a side, keys uniform in [0, rows)
SPILL_ROWS = 100_000_000
SPILL_PARTS = 8
SPILL_CHUNK = 1 << 22
SPILL_SEED = 0
#: the pre-flight route's budget, ``CYLON_TPU_HBM_BUDGET_BYTES``
SPILL_BUDGET = 8 << 30
#: the kill-and-resume run dies at this partition's durable write, so
#: this many partitions were complete before it
SPILL_KILL_AT = 4
#: the card the ballast of part (c) leaves beyond two partitions' peak
SPILL_HEADROOM = 1 << 30
#: TPC-H through the fallback: phase 14's scales and seed
SPILL_TPCH_SF = TPCH_BASELINE_SF
SPILL_TPCH_SMALL_SF = TPCH_SF
#: every query with a two-phase plan (``tpch.twophase``)
SPILL_TWO_PHASE = ("q8", "q11", "q14", "q15", "q16", "q22")
#: the free-memory budget ``run_query("q5")`` is given, below q5's
#: predicted working set at SF 10, so that it takes the spill path
SPILL_TPCH_BUDGET = 1 << 30
#: part (f): the 16M share at W = 4, and the barrier's hang and timeout
SPILL_W4_RANK_ROWS = 4 << 20
BARRIER_TIMEOUT_S = 0.5
BARRIER_SLACK_S = 1.0


def spill_tables(np, n: int):
    """Part (a)'s two sides from :data:`SPILL_SEED`: an int64 key uniform
    in [0, n) and a float64 value each (the same arrays in the parent
    and in the killed child of part (d))."""
    rng = np.random.default_rng(SPILL_SEED)
    return [{"k": rng.integers(0, n, n, dtype=np.int64),
             "v": rng.random(n)} for _ in range(2)]


class SpillSink:
    """An ``ooc_join`` sink: per partition (in call order) its rows, the
    sum of ``v_x * v_y`` and, with ``digest``, a blake2b digest of its
    columns' bytes."""

    def __init__(self, digest: bool):
        self.rows, self.sums, self.digests = [], [], []
        self.digest = digest

    def __call__(self, df):
        import hashlib

        import numpy as np

        vx, vy = df["v_x"].to_numpy(), df["v_y"].to_numpy()
        self.rows.append(len(df))
        self.sums.append(float(np.dot(vx, vy)))
        if self.digest:
            h = hashlib.blake2b(digest_size=16)
            for c in df.columns:
                h.update(np.ascontiguousarray(df[c].to_numpy()).tobytes())
            self.digests.append(h.hexdigest())


def spill_child(rdir: str, dev: str, rows: str, chunk: str,
                parts: str) -> int:
    """Part (d)'s child: part (a)'s ``ooc_join`` (``rows`` a side,
    ``chunk`` rows a chunk, ``parts`` partitions, on ``dev``) with
    ``resume_dir`` under ``FaultRule.kill`` at the
    :data:`SPILL_KILL_AT`-th partition's durable write; it dies there
    with ``KILL_EXIT_CODE``."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from cylon_tpu_torch import resilience
    from cylon_tpu_torch.outofcore import ooc_join

    left, right = spill_tables(np, int(rows))
    plan = resilience.FaultPlan([resilience.FaultRule.kill(
        "spill_write", nth=SPILL_KILL_AT)])
    with resilience.active(plan):
        ooc_join(left, right, on="k", n_partitions=int(parts),
                 chunk_rows=int(chunk), resume_dir=rdir,
                 sink=SpillSink(False), device=dev)
    return 1                       # the kill never fired


def compute_idle_share(evts) -> "dict | None":
    """From one ``ooc_join``'s flight-recorder events: the pass's wall
    (first to last event), the host partition phase (to the first
    ``ooc_join.partition`` span), the seconds inside ``ooc.compute``,
    ``ooc.prefetch`` and ``spill.write_async`` spans, and the compute
    stage's idle share (the wall outside every ``ooc.compute`` span)."""
    from cylon_tpu_torch.telemetry import trace

    spans = trace._matched_spans(evts)
    if not evts or not spans:
        return None
    t0 = min(e["ts"] for e in evts)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in evts)
    def total(name):
        return sum(d for b, d in spans if b["name"] == name)

    starts = [b["ts"] for b, _ in spans if b["name"] == "ooc_join.partition"]
    compute, wall = total("ooc.compute"), t1 - t0
    return {"wall_s": wall,
            "partition_phase_s": min(starts) - t0 if starts else None,
            "compute_s": compute, "prefetch_s": total("ooc.prefetch"),
            "commit_s": total("spill.write_async"),
            "compute_idle_share": 1.0 - compute / wall if wall else None}


def tpch_q1_pandas(pdfs, date_int, cutoff=None):
    """TPC-H Q1 in pandas (a copy of
    ``tests/test_torch_tpch.py:q1_pandas``)."""
    if cutoff is None:
        cutoff = date_int(1998, 9, 2)
    li = pdfs["lineitem"]
    li = li[li["l_shipdate"] <= cutoff].copy()
    li["disc_price"] = li["l_extendedprice"] * (1 - li["l_discount"])
    li["charge"] = li["disc_price"] * (1 + li["l_tax"])
    return li.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "count"),
    ).reset_index().sort_values(
        ["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def tpch_q8_pandas(pdfs, date_int, nation="BRAZIL", region="AMERICA",
                   ptype="ECONOMY ANODIZED STEEL"):
    """TPC-H Q8 in pandas (a copy of ``tests/test_tpch.py:q8_pandas``)."""
    import datetime

    import numpy as np

    epoch = datetime.date(1970, 1, 1).toordinal()
    p, s, li, o, c, n, r = (pdfs["part"], pdfs["supplier"],
                            pdfs["lineitem"], pdfs["orders"],
                            pdfs["customer"], pdfs["nation"],
                            pdfs["region"])
    p = p[p.p_type == ptype]
    o = o[(o.o_orderdate >= date_int(1995, 1, 1))
          & (o.o_orderdate <= date_int(1996, 12, 31))].copy()
    o["o_year"] = [datetime.date.fromordinal(int(x) + epoch).year
                   for x in o.o_orderdate]
    r = r[r.r_name == region]
    n1 = n.merge(r, left_on="n_regionkey", right_on="r_regionkey")
    c = c[c.c_nationkey.isin(n1.n_nationkey)]
    li = li.copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    j = (li.merge(p, left_on="l_partkey", right_on="p_partkey")
           .merge(o, left_on="l_orderkey", right_on="o_orderkey")
           .merge(c, left_on="o_custkey", right_on="c_custkey")
           .merge(s, left_on="l_suppkey", right_on="s_suppkey")
           .merge(n.rename(columns={"n_name": "supp_nation",
                                    "n_nationkey": "s_nk"}),
                  left_on="s_nationkey", right_on="s_nk"))
    j["nation_rev"] = np.where(j.supp_nation == nation, j.revenue, 0.0)
    g = j.groupby("o_year", as_index=False)[["revenue", "nation_rev"]].sum()
    g["mkt_share"] = g.nation_rev / g.revenue
    return g.sort_values("o_year")[["o_year", "mkt_share"]].reset_index(
        drop=True)


def tpch_q11_pandas(pdfs, nation="GERMANY", fraction=0.0001):
    """TPC-H Q11 in pandas (a copy of ``tests/test_tpch.py:q11_pandas``)."""
    ps, s, n = pdfs["partsupp"], pdfs["supplier"], pdfs["nation"]
    n = n[n.n_name == nation]
    j = (ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
           .merge(n, left_on="s_nationkey", right_on="n_nationkey")).copy()
    j["value"] = j.ps_supplycost * j.ps_availqty
    g = j.groupby("ps_partkey", as_index=False)["value"].sum()
    total = g.value.sum()
    g = g[g.value > fraction * total]
    return g.sort_values("value", ascending=False).reset_index(drop=True)


def tpch_q14_pandas(pdfs, date_int):
    """TPC-H Q14 in pandas (a copy of ``tests/test_tpch.py:q14_pandas``)."""
    li, p = pdfs["lineitem"], pdfs["part"]
    d0, d1 = date_int(1995, 9, 1), date_int(1995, 10, 1)
    li = li[(li.l_shipdate >= d0) & (li.l_shipdate < d1)].copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    j = li.merge(p, left_on="l_partkey", right_on="p_partkey")
    promo = j[j.p_type.str.startswith("PROMO")].revenue.sum()
    total = j.revenue.sum()
    return 100.0 * promo / total if total else 0.0


def tpch_q15_pandas(pdfs, date_int):
    """TPC-H Q15 in pandas (a copy of ``tests/test_tpch.py:q15_pandas``)."""
    s, li = pdfs["supplier"], pdfs["lineitem"]
    d0, d1 = date_int(1996, 1, 1), date_int(1996, 4, 1)
    li = li[(li.l_shipdate >= d0) & (li.l_shipdate < d1)].copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    g = li.groupby("l_suppkey", as_index=False).agg(
        total_revenue=("revenue", "sum"))
    g = g[g.total_revenue >= g.total_revenue.max()]
    out = g.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    return out.sort_values("s_suppkey")[
        ["s_suppkey", "s_name", "total_revenue"]].reset_index(drop=True)


def tpch_q16_pandas(pdfs, brand="Brand#45", type_prefix="MEDIUM POLISHED",
                    sizes=(49, 14, 23, 45, 19, 3, 36, 9)):
    """TPC-H Q16 in pandas (a copy of ``tests/test_tpch.py:q16_pandas``)."""
    import re

    p, ps, s = pdfs["part"], pdfs["partsupp"], pdfs["supplier"]
    bad = s[s.s_comment.str.match(re.compile(".*Customer.*Complaints.*"))]
    p = p[(p.p_brand != brand) & ~p.p_type.str.startswith(type_prefix)
          & p.p_size.isin(sizes)]
    j = ps.merge(p, left_on="ps_partkey", right_on="p_partkey")
    j = j[~j.ps_suppkey.isin(bad.s_suppkey)]
    g = j.groupby(["p_brand", "p_type", "p_size"], as_index=False).agg(
        supplier_cnt=("ps_suppkey", "nunique"))
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True]).reset_index(
        drop=True)


def tpch_q22_pandas(pdfs, codes=("13", "31", "23", "29", "30", "18", "17")):
    """TPC-H Q22 in pandas (a copy of ``tests/test_tpch.py:q22_pandas``)."""
    c, o = pdfs["customer"].copy(), pdfs["orders"]
    c["cntrycode"] = c.c_phone.str[:2]
    c = c[c.cntrycode.isin(codes)]
    avg = c[c.c_acctbal > 0.0].c_acctbal.mean()
    cand = c[c.c_acctbal > avg]
    cand = cand[~cand.c_custkey.isin(o.o_custkey.unique())]
    g = cand.groupby("cntrycode", as_index=False).agg(
        numcust=("c_custkey", "count"), totacctbal=("c_acctbal", "sum"))
    return g.sort_values("cntrycode").reset_index(drop=True)


def spill_phase(torch, rate, stats, card: str, dev="cuda") -> tuple:
    """Resilience, deadlines and the spill path on the card (phase 16).
    Every line carries the card's name and power limit.

    (a) The 100M x 100M out-of-core join (:data:`SPILL_ROWS` a side,
        keys uniform in [0, SPILL_ROWS), seed :data:`SPILL_SEED`) through
        ``ooc_join`` (:data:`SPILL_PARTS` partitions, :data:`SPILL_CHUNK`
        rows a chunk, a sink that sums ``v_l * v_r`` and digests each
        partition): the row total against numpy's
        ``sum_k cnt_l[k] * cnt_r[k]``, the products' sum at rtol 1e-9,
        each partition's rows against its keys' expected count (the
        host hash's partition of every key). Walls, peak device bytes,
        prefetch hits, and from the flight recorder's ``ooc.*`` spans the
        compute stage's idle share; then the same join with prefetch
        depth 0 (``CYLON_TPU_OOC_PREFETCH_DEPTH=0``), and the in-core
        ``join`` of the same tables on the card.
    (b) ``fallback.join`` of (a)'s tables with
        ``CYLON_TPU_HBM_BUDGET_BYTES`` at :data:`SPILL_BUDGET`: one
        pre-flight fallback, (a)'s rows and sum.
    (c) A real OOM: a ballast tensor leaves two sequential partitions'
        peak (from (a)) and :data:`SPILL_HEADROOM` free, less than the
        in-core join's peak; ``fallback.join`` under ``run_with_fallback``
        (its budget the card's whole memory, so that the pre-flight lets
        the attempt run) must see ``torch.cuda.OutOfMemoryError`` in the
        in-core attempt, count one OOM fallback, and give (a)'s result;
        the bytes the allocator holds when the spill starts and, after
        the ballast is freed, the live bytes back at their level before
        the phase (less the pair scan's scratch, which its wrapper keeps
        across calls and grows to the largest scan met).
    (d) Kill and resume: a child process (``--spill-child``) runs (a)'s
        join with ``resume_dir`` and dies by ``FaultRule.kill`` at the
        :data:`SPILL_KILL_AT`-th partition's durable write; this process
        resumes it: (a)'s total, the partitions' digests in order equal
        to (a)'s, ``SPILL_KILL_AT - 1`` partitions resumed.
    (e) TPC-H through the fallback on phase 14's generator, seed and
        scales (the lineitem columns of Q1 added at SF 10):
        ``fallback.run_query("q5")`` with a budget that forces the spill
        path, ``streaming.q1_ooc`` and ``q5_ooc`` at :data:`SPILL_TPCH_SF`,
        and the two-phase :data:`SPILL_TWO_PHASE` at
        :data:`SPILL_TPCH_SMALL_SF` (q22's orders cut to 5 % as in phase
        14), each equal to the eager in-core result of the same data on
        the card and to its pandas oracle; each two-phase query's
        phases launch the path's kernels (they join on the card).
    (f) Faults and deadlines: ``dist_join`` at W = 4 on ``ThreadWorld``
        (:data:`SPILL_W4_RANK_ROWS` a rank a side) under a fault plan
        with one transient fault at each rank's ``exchange`` point,
        inside ``retrying``: the clean run's rows, one retry a rank;
        ``CylonEnv.barrier(timeout=BARRIER_TIMEOUT_S)`` against a hang
        at the ``worker`` point raises ``DeadlineExceeded`` within the
        timeout plus :data:`BARRIER_SLACK_S`; ``dist_join`` at W = 1
        (phase 4's 16M) and W = 4 with the hooks armed (a fault plan
        that never fires and a deadline scope) against the same runs
        unarmed: equal sync sites and launches, none in the resilience
        layer's code (:func:`telemetry_syncs`).
    (g) Each kernel the spill path launched in (d)'s recomputed
        partitions (the joins of (a)) and in (e), against its plain
        version at the shapes it met, as in phase 10.

    Returns ``(launches of (a)-(f), the kernels' inputs)``."""
    import gc
    import os
    import tempfile

    import numpy as np
    import pandas as pd

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import fallback, outofcore, resilience, telemetry
    from cylon_tpu_torch import tpch, watchdog
    from cylon_tpu_torch.errors import DeadlineExceeded
    from cylon_tpu_torch.kernels import launch_counts, reset_launches
    from cylon_tpu_torch.telemetry import trace
    from cylon_tpu_torch.tpch import streaming
    from cylon_tpu_torch.tpch.manifest import MANIFEST

    from cylon_tpu_torch.kernels import scan as kscan

    def kept_bytes():
        """Live device bytes less the pair scan's scratch, which its
        wrapper keeps (grown, never shrunk) across calls a stream (each
        block as the allocator counts it, rounded up to 512 bytes)."""
        if dev != "cuda":
            return 0
        return torch.cuda.memory_allocated() - sum(
            -(-s[0].numel() * s[0].element_size() // 512) * 512
            for s in kscan._pair_state.values())

    t_phase = time.perf_counter()
    base_bytes = kept_bytes()

    def record(part, case, **fields):
        row = {"phase": "spill", "part": part, "case": case, "card": card,
               **fields, "phase_s": time.perf_counter() - t_phase}
        emit(row)
        return row

    def fail(msg):
        raise SystemExit(f"spill: {msg}")

    def peak_of(fn):
        """``(result, host wall s, peak device bytes)`` of ``fn``."""
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        return out, wall, peak

    def counter(name, **labels):
        c = telemetry.metric(name, **labels)
        return 0 if c is None else c.value

    rec = PathInputs()
    total_launches = {k: 0 for k in launch_counts()}

    def bank_launches():
        """Add the counts since the last reset to the phase's total."""
        for k, v in launch_counts().items():
            total_launches[k] += v
        reset_launches()

    reset_launches()

    # -- (a) the 100M x 100M out-of-core join
    n = SPILL_ROWS
    t = time.perf_counter()
    left, right = spill_tables(np, n)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    cnt_l = np.bincount(left["k"], minlength=n)
    cnt_r = np.bincount(right["k"], minlength=n)
    pairs = cnt_l * cnt_r
    want_rows = int(pairs.sum())
    want_sum = float(np.dot(np.bincount(left["k"], weights=left["v"],
                                        minlength=n),
                            np.bincount(right["k"], weights=right["v"],
                                        minlength=n)))
    # each key that matches on both sides, in its host partition
    both = np.flatnonzero(pairs)
    pid = (outofcore._row_hash([both]) % np.uint64(SPILL_PARTS)) \
        .astype(np.int64)
    want_parts = np.bincount(pid, weights=pairs[both],
                             minlength=SPILL_PARTS).astype(np.int64)
    del cnt_l, cnt_r, pairs, pid, both
    expect_s = time.perf_counter() - t
    kw = dict(on="k", n_partitions=SPILL_PARTS, chunk_rows=SPILL_CHUNK,
              device=dev)

    def check_join(case, total, sink):
        rows_ok = (total == want_rows and sum(sink.rows) == want_rows
                   and sink.rows == want_parts.tolist())
        sum_ok = bool(np.isclose(sum(sink.sums), want_sum, rtol=1e-9,
                                 atol=0.0))
        if not (rows_ok and sum_ok):
            fail(f"{case}: rows {total} by partition {sink.rows}, sum "
                 f"{sum(sink.sums)!r}; numpy {want_rows} by partition "
                 f"{want_parts.tolist()}, sum {want_sum!r}")

    runs = {}
    for case, depth in (("prefetch", None), ("sequential", "0")):
        if depth is not None:
            os.environ["CYLON_TPU_OOC_PREFETCH_DEPTH"] = depth
        hits = counter("ooc.prefetch_hits", op="join")
        misses = counter("ooc.prefetch_misses", op="join")
        sink = SpillSink(True)
        os.environ["CYLON_TPU_TRACE"] = "1"
        trace.clear()
        try:
            total, wall, peak = peak_of(lambda: outofcore.ooc_join(
                left, right, sink=sink, **kw))
            evts = trace.events()
        finally:
            del os.environ["CYLON_TPU_TRACE"]
            if depth is not None:
                del os.environ["CYLON_TPU_OOC_PREFETCH_DEPTH"]
        trace.clear()
        check_join(f"(a) {case}", total, sink)
        runs[case] = {"wall_s": wall, "peak_bytes": peak, "sink": sink,
                      "prefetch_hits": counter(
                          "ooc.prefetch_hits", op="join") - hits,
                      "prefetch_misses": counter(
                          "ooc.prefetch_misses", op="join") - misses,
                      "spans": compute_idle_share(evts)}
        record("a", f"ooc_join_{case}", rows=total, sum=sum(sink.sums),
               partition_rows=sink.rows, wall_s=wall, peak_bytes=peak,
               prefetch_hits=runs[case]["prefetch_hits"],
               prefetch_misses=runs[case]["prefetch_misses"],
               spans=runs[case]["spans"])
    if runs["prefetch"]["sink"].digests != runs["sequential"]["sink"].digests:
        fail("(a) the sequential run's partitions differ from the "
             "prefetched run's")
    ref = runs["prefetch"]["sink"]

    def in_core():
        lt = ct.Table.from_pydict(left, capacity=n, device=dev)
        rt = ct.Table.from_pydict(right, capacity=n, device=dev)
        res = ct.join(lt, rt, on="k", ordered=False)
        m = res.num_rows
        # an elementwise product and a sum: torch.dot would take cuBLAS,
        # whose workspace stays allocated after the call
        return m, float((res.column("v_x").data[:m]
                         * res.column("v_y").data[:m]).sum())

    (incore_rows, incore_sum), incore_wall, incore_peak = peak_of(in_core)
    if incore_rows != want_rows or not np.isclose(incore_sum, want_sum,
                                                  rtol=1e-9, atol=0.0):
        fail(f"(a) in-core join: {incore_rows} rows, sum {incore_sum!r}")
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    record("a", "summary", rows_per_side=n, partitions=SPILL_PARTS,
           chunk_rows=SPILL_CHUNK, generate_s=gen_s, numpy_expect_s=expect_s,
           want_rows=want_rows, want_sum=want_sum,
           ooc_prefetch_wall_s=runs["prefetch"]["wall_s"],
           ooc_sequential_wall_s=runs["sequential"]["wall_s"],
           ooc_prefetch_peak_bytes=runs["prefetch"]["peak_bytes"],
           ooc_sequential_peak_bytes=runs["sequential"]["peak_bytes"],
           in_core_wall_s=incore_wall, in_core_peak_bytes=incore_peak,
           in_core_rows=incore_rows, in_core_sum=incore_sum)

    # -- (b) the pre-flight route
    pre = counter("ooc.fallbacks", op="join", reason="preflight")
    os.environ["CYLON_TPU_HBM_BUDGET_BYTES"] = str(SPILL_BUDGET)
    try:
        got, wall, peak = peak_of(lambda: fallback.join(
            left, right, on="k", n_partitions=SPILL_PARTS,
            chunk_rows=SPILL_CHUNK, device=dev))
    finally:
        del os.environ["CYLON_TPU_HBM_BUDGET_BYTES"]
    pre = counter("ooc.fallbacks", op="join", reason="preflight") - pre
    got_sum = float(np.dot(got["v_x"].to_numpy(), got["v_y"].to_numpy()))
    record("b", "preflight", budget_bytes=SPILL_BUDGET,
           predicted_bytes=int((16 * n * 2) * fallback.expansion_factor()),
           fallbacks_preflight=pre, rows=len(got), sum=got_sum,
           wall_s=wall, peak_bytes=peak)
    if pre != 1 or len(got) != want_rows or not np.isclose(
            got_sum, want_sum, rtol=1e-9, atol=0.0):
        fail(f"(b) {pre} pre-flight fallbacks, {len(got)} rows, sum "
             f"{got_sum!r}")
    del got
    gc.collect()

    # -- (c) a real OOM, retried once through the spill path
    if dev == "cuda":
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        keep = 2 * runs["sequential"]["peak_bytes"] + SPILL_HEADROOM
        if keep >= incore_peak:
            fail(f"(c) two partitions' peak and headroom ({keep} bytes) "
                 f"reach the in-core peak ({incore_peak}): no OOM to make")
        ballast = torch.empty(max(free - keep, 0), dtype=torch.uint8,
                              device=dev)
        before = torch.cuda.memory_allocated()
        seen = {}
        real_spill = outofcore.ooc_join

        def spill_probe(*a, **k):
            seen["allocated_at_spill"] = torch.cuda.memory_allocated()
            return real_spill(*a, **k)

        real_rwf = fallback.run_with_fallback

        def rwf(attempt, spill, **k):
            def probed():
                try:
                    return attempt()
                except BaseException as e:
                    seen["attempt_error"] = type(e).__name__
                    raise
            return real_rwf(probed, spill, **k)

        oom = counter("ooc.fallbacks", op="join", reason="oom")
        outofcore.ooc_join, fallback.run_with_fallback = spill_probe, rwf
        try:
            # the budget is the card's whole memory, so the pre-flight
            # lets the in-core attempt run into the allocator's limit
            got, wall, peak = peak_of(lambda: fallback.join(
                left, right, on="k", n_partitions=SPILL_PARTS,
                chunk_rows=SPILL_CHUNK, device=dev,
                budget_bytes=torch.cuda.mem_get_info()[1]))
        finally:
            outofcore.ooc_join, fallback.run_with_fallback = real_spill, \
                real_rwf
        oom = counter("ooc.fallbacks", op="join", reason="oom") - oom
        got_sum = float(np.dot(got["v_x"].to_numpy(),
                               got["v_y"].to_numpy()))
        got_rows = len(got)
        ballast_bytes = ballast.numel()
        del ballast, got
        gc.collect()
        torch.cuda.empty_cache()
        after = kept_bytes()
        record("c", "oom", free_bytes=free, ballast_bytes=ballast_bytes,
               left_free_bytes=keep, in_core_peak_bytes=incore_peak,
               attempt_error=seen.get("attempt_error"),
               fallbacks_oom=oom, rows=got_rows, sum=got_sum, wall_s=wall, peak_bytes=peak,
               allocated_before_attempt=before,
               allocated_at_spill=seen.get("allocated_at_spill"),
               reclaimed_short_bytes=(seen.get("allocated_at_spill", 0)
                                      - before),
               kept_bytes_before_phase=base_bytes, kept_bytes_after=after,
               pair_scratch_bytes=torch.cuda.memory_allocated() - after)
        if seen.get("attempt_error") != "OutOfMemoryError" or oom != 1 \
                or got_rows != want_rows \
                or not np.isclose(got_sum, want_sum, rtol=1e-9, atol=0.0):
            fail(f"(c) attempt raised {seen.get('attempt_error')}, {oom} "
                 f"OOM fallbacks, sum {got_sum!r}")
        if after != base_bytes:
            fail(f"(c) {after} bytes live after the ballast went, "
                 f"{base_bytes} before the phase")
    else:
        record("c", "oom", skipped="a real OOM needs the card")

    # -- (d) kill and resume
    with tempfile.TemporaryDirectory() as tmp:
        rdir = os.path.join(tmp, "resume")
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--spill-child",
             rdir, dev, str(n), str(SPILL_CHUNK), str(SPILL_PARTS)],
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t
        if child.returncode != resilience.KILL_EXIT_CODE:
            fail(f"(d) the child exited {child.returncode}, not "
                 f"{resilience.KILL_EXIT_CODE}: {child.stderr[-2000:]}")
        resumed = counter("ooc.units_resumed", op="join")
        sink = SpillSink(True)
        # the kernels' inputs are kept here, on the partitions this run
        # recomputes (the joins of (a)): a copy of each stays on the card
        # until (g), so it is taken after (c)'s count of live bytes
        with rec:
            total, wall, peak = peak_of(lambda: outofcore.ooc_join(
                left, right, sink=sink, resume_dir=rdir, **kw))
        resumed = counter("ooc.units_resumed", op="join") - resumed
        check_join("(d) resumed", total, sink)
        record("d", "kill_resume", child_s=child_s,
               child_exit=child.returncode, resumed_units=resumed,
               rows=total, wall_s=wall, peak_bytes=peak,
               digests_equal=sink.digests == ref.digests)
        if resumed != SPILL_KILL_AT - 1 or sink.digests != ref.digests:
            fail(f"(d) {resumed} partitions resumed (want "
                 f"{SPILL_KILL_AT - 1}), digests equal "
                 f"{sink.digests == ref.digests}")
    del left, right, runs, ref
    gc.collect()

    # -- (e) TPC-H through the fallback
    def gen(sf, names):
        t = time.perf_counter()
        data = tpch.generate(sf, TPCH_SEED, keep=manifest_keep(MANIFEST,
                                                              names))
        return data, time.perf_counter() - t

    def pandas_of(data):
        return {k: pd.DataFrame(v) for k, v in data.items()}

    big, gen_big = gen(SPILL_TPCH_SF, ["q1", "q5"])
    frames = {}
    for name, cols in big.items():
        frames.update(tpch.ingest({name: cols}, device=dev))
    pdfs = pandas_of(big)
    results = []
    with rec:
        q5_in = host_result(tpch.q5(frames))
        q1_in = host_result(tpch.q1(frames))
        del frames
        gc.collect()
        q5_pd = tpch_q5_pandas(pdfs, tpch.date_int)
        q1_pd = tpch_q1_pandas(pdfs, tpch.date_int)
        del pdfs
        pre = counter("ooc.fallbacks", op="q5", reason="preflight")
        got, wall, peak = peak_of(lambda: fallback.run_query(
            "q5", big, budget_bytes=SPILL_TPCH_BUDGET))
        pre = counter("ooc.fallbacks", op="q5", reason="preflight") - pre
        results.append(("run_query_q5", got, q5_in, q5_pd, wall, peak,
                        {"fallbacks_preflight": pre}))
        for name, fn, incore, oracle in (
                ("q1_ooc", streaming.q1_ooc, q1_in, q1_pd),
                ("q5_ooc", streaming.q5_ooc, q5_in, q5_pd)):
            got, wall, peak = peak_of(lambda: host_result(fn(
                big, device=dev)))
            results.append((name, got, incore, oracle, wall, peak, {}))
        del big
        small, gen_small = gen(SPILL_TPCH_SMALL_SF, list(SPILL_TWO_PHASE))
        n_keep = max(len(small["orders"]["o_custkey"]) // 20, 1)
        trimmed = dict(small, orders={k: v[:n_keep] for k, v in
                                      small["orders"].items()})
        oracles = {"q8": lambda p: tpch_q8_pandas(p, tpch.date_int),
                   "q11": tpch_q11_pandas,
                   "q14": lambda p: tpch_q14_pandas(p, tpch.date_int),
                   "q15": lambda p: tpch_q15_pandas(p, tpch.date_int),
                   "q16": tpch_q16_pandas, "q22": tpch_q22_pandas}
        for qn in SPILL_TWO_PHASE:
            data = trimmed if qn == "q22" else small
            frames = tpch.ingest(data, device=dev)
            incore = host_result(getattr(tpch, qn)(frames))
            del frames
            merges = counter("ooc.merge_phases", op=qn)
            launched = sum(launch_counts().values())
            got, wall, peak = peak_of(lambda: fallback.tpch_fallback(
                qn, data, n_partitions=SPILL_PARTS))
            # the phases join and group each partition on the card: the
            # path's kernels launch in them
            results.append((f"two_phase_{qn}", got, incore,
                            oracles[qn](pandas_of(data)), wall, peak,
                            {"merge_phases": counter(
                                "ooc.merge_phases", op=qn) - merges,
                             "kernel_launches": sum(
                                 launch_counts().values()) - launched}))
        del small, trimmed
    bad = []
    for case, got, incore, oracle, wall, peak, extra in results:
        ok_in = results_match(np, got, incore)
        ok_pd = results_match(np, got, oracle)
        record("e", case, rows=len(got) if hasattr(got, "columns") else 1,
               equal_in_core=ok_in, equal_pandas=ok_pd, wall_s=wall,
               peak_bytes=peak, **extra)
        if not (ok_in and ok_pd) or extra.get("fallbacks_preflight", 1) \
                != 1 or extra.get("merge_phases", 1) != 1 \
                or (dev == "cuda" and extra.get("kernel_launches", 1) == 0):
            bad.append(case)
    record("e", "data", sf=SPILL_TPCH_SF, small_sf=SPILL_TPCH_SMALL_SF,
           seed=TPCH_SEED, generate_s=gen_big, small_generate_s=gen_small)
    if bad:
        fail(f"(e) {bad} differ from the in-core result or pandas")
    del results
    gc.collect()

    # -- (f) faults and deadlines
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    w, nr = GROUPBY_WORLD, SPILL_W4_RANK_ROWS
    nw = w * nr
    sides = [{"k": torch.randint(0, nw, (nw,), dtype=torch.int64,
                                 device=dev, generator=g),
              "v": torch.rand(nw, dtype=torch.float64, device=dev,
                              generator=g)} for _ in range(2)]

    def shard(e, side):
        lo, hi = e.rank * nr, (e.rank + 1) * nr
        from cylon_tpu_torch import dtypes
        from cylon_tpu_torch.column import Column

        return ct.Table({"k": Column(side["k"][lo:hi], None, dtypes.int64),
                         "v": Column(side["v"][lo:hi], None,
                                     dtypes.float64)}, nr)

    def w4(plan_of=None, scoped: bool = False):
        """Each rank's rows and fault plan; ``scoped``: each rank runs
        under a deadline scope (a rank thread does not inherit the
        caller's context)."""
        def rank(comm):
            e = ct.CylonEnv(comm, device=dev)
            if plan_of is not None:
                e.set_fault_plan(plan_of())
            with watchdog.deadline(600.0) if scoped else \
                    contextlib.nullcontext():
                out = resilience.retrying(
                    lambda: ct.dist_join(e, shard(e, sides[0]),
                                         shard(e, sides[1]), on="k"),
                    ct.RetryPolicy(base_delay=0.0),
                    sleep_fn=lambda s: None)
            return out.num_rows, e.fault_plan
        return ct.ThreadWorld(w).run(rank)

    clean = w4()
    retries = counter("resilience.retries", code="Unavailable")
    faulted = w4(lambda: resilience.FaultPlan(
        [resilience.FaultRule("exchange", nth=1)]))
    retries = counter("resilience.retries", code="Unavailable") - retries
    rows_clean = sum(r for r, _ in clean)
    rows_faulted = sum(r for r, _ in faulted)
    hits = [p.hits("exchange") for _, p in faulted]
    record("f", "transient_exchange", world=w, rows_per_rank_side=nr,
           rows_clean=rows_clean, rows_retried=rows_faulted,
           retries=retries, exchange_hits=hits)
    if rows_clean != rows_faulted or retries != w or hits != [2] * w:
        fail(f"(f) retried dist_join: {rows_faulted} rows against "
             f"{rows_clean}, {retries} retries, hits {hits}")

    benv = ct.CylonEnv(device=dev)
    benv.set_fault_plan(resilience.FaultPlan(
        [resilience.FaultRule.hang("worker", seconds=2.0)]))
    t = time.perf_counter()
    try:
        benv.barrier(timeout=BARRIER_TIMEOUT_S)
        raised = None
    except DeadlineExceeded as e:
        raised = e
    waited = time.perf_counter() - t
    # the abandoned wait wakes from its hang and finishes its barrier:
    # join it, so that its synchronize counts in no later run
    for th in threading.enumerate():
        if th.name == "cylon-bounded-barrier":
            th.join(timeout=30.0)
    record("f", "barrier_hang", timeout_s=BARRIER_TIMEOUT_S,
           slack_s=BARRIER_SLACK_S, waited_s=waited,
           raised=type(raised).__name__ if raised else None,
           section=getattr(raised, "section", None),
           retryable=resilience.is_retryable(raised) if raised else None)
    if raised is None or raised.section != "barrier" \
            or waited > BARRIER_TIMEOUT_S + BARRIER_SLACK_S:
        fail(f"(f) barrier: raised {raised!r} after {waited} s")

    n1 = DIST_ROWS
    l1 = {"k": torch.randint(0, n1, (n1,), dtype=torch.int64, device=dev,
                             generator=g),
          "v": torch.rand(n1, dtype=torch.float64, device=dev, generator=g)}
    r1 = {"k": torch.randint(0, n1, (n1,), dtype=torch.int64, device=dev,
                             generator=g),
          "v": torch.rand(n1, dtype=torch.float64, device=dev, generator=g)}
    env1 = ct.CylonEnv(device=dev)

    def one():
        return ct.dist_join(env1, shard1(l1), shard1(r1), on="k")

    def shard1(side):
        from cylon_tpu_torch import dtypes
        from cylon_tpu_torch.column import Column

        return ct.Table({"k": Column(side["k"], None, dtypes.int64),
                         "v": Column(side["v"], None, dtypes.float64)}, n1)

    never = resilience.FaultPlan([resilience.FaultRule(
        "exchange", nth=1 << 40)])
    sync_cases = {"w1": (one, one), "w4": (w4, lambda: w4(scoped=True))}
    sync_out = {}
    for name, (plain, hooked) in sync_cases.items():
        plain()
        count_syncs(torch, plain)                 # warm-up under the check
        runs_f = []
        for mode in ("plain", "hooked") * 2:
            ctx = contextlib.ExitStack()
            if mode == "hooked":
                ctx.enter_context(resilience.active(never))
                ctx.enter_context(watchdog.deadline(600.0))
            with ctx:
                bank_launches()
                _, sites = count_syncs(
                    torch, plain if mode == "plain" else hooked)
                runs_f.append({"mode": mode, "syncs": sites,
                               "launches": launch_counts()})
        badp = [i for i in (0, 2) if runs_f[i]["syncs"]
                != runs_f[i + 1]["syncs"] or runs_f[i]["launches"]
                != runs_f[i + 1]["launches"]]
        own = telemetry_syncs(r["syncs"] for r in runs_f)
        sync_out[name] = {"syncs": [sum(r["syncs"].values())
                                    for r in runs_f],
                          "sync_sites": runs_f[0]["syncs"],
                          "launches": runs_f[0]["launches"],
                          "modes": [r["mode"] for r in runs_f],
                          "pairs_differ": badp, "own_sites": own}
        if badp or own:
            record("f", f"syncs_{name}", **sync_out[name])
            fail(f"(f) {name}: hooked runs differ from plain ones "
                 f"{badp}, or the resilience layer synchronized at {own}")
    record("f", "syncs", **sync_out)
    del sides, l1, r1, clean, faulted
    bank_launches()
    record("launches", "spill", launches=total_launches)
    for k in ("scan32", "pair_max_scan", "row_hash"):
        if not total_launches[k]:
            fail(f"{k} never launched on the spill path")
    gc.collect()
    return total_launches, rec.inputs


def main(argv) -> int:
    import torch

    if argv[:1] == ["--spill-child"]:
        return spill_child(*argv[1:6])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive",
              file=sys.stderr)
        return 2
    if not (ROOT / "cylon_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no cylon_tpu_torch package beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cylon_tpu_torch.kernels import (build, bucket_build, bucket_probe,
                                         pair_max_scan, row_hash, scan32)

    card = smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rate = bandwidth(card)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "bandwidth_bytes_per_s": rate,
          "allow_tf32": False})
    torch.zeros(1, device="cuda")           # the context, for phase 1's line
    memory_line(torch, card, "1 card")

    t0 = time.perf_counter()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": Path(build.last_build.get("path", "")).name or None})
    memory_line(torch, card, "2 build")

    stats = kernel_phase(torch, rate)
    bucket_kernel_phase(torch, rate, stats)
    join_parity_phase(torch)
    memory_line(torch, card, "3 kernels")
    sort_wall = dist_join_phase(torch)
    memory_line(torch, card, "4 dist_join")
    hash_launches = hash_join_phase(torch, sort_wall, "--profile" in argv)
    memory_line(torch, card, "5 hash_join")
    launches = bench_phase(torch, "--profile" in argv)
    memory_line(torch, card, "6 bench")
    strings_phase(torch, rate, stats, "--profile" in argv)
    memory_line(torch, card, "7 strings")
    comm_phase(torch)
    memory_line(torch, card, "8 comm")
    with PathInputs() as groupby_inputs:
        groupby_launches = groupby_phase(torch, "--profile" in argv)
    memory_line(torch, card, "9 groupby")
    path_kernel_phase(torch, rate, stats, "groupby", groupby_inputs.inputs)
    del groupby_inputs
    memory_line(torch, card, "10 path kernels")
    dist_join_w4_phase(torch, rate, stats)
    memory_line(torch, card, "11 dist_join_w4")
    t12 = time.perf_counter()
    sort_setops_launches, sort_inputs = sort_setops_phase(
        torch, "--profile" in argv)
    path_kernel_phase(torch, rate, stats, "sort_setops", sort_inputs)
    del sort_inputs
    emit({"phase": "sort_setops_seconds",
          "seconds": time.perf_counter() - t12})
    memory_line(torch, card, "12 sort_setops")
    frame_launches, frame_inputs = frame_phase(torch, card)
    path_kernel_phase(torch, rate, stats, "frame", frame_inputs)
    del frame_inputs
    memory_line(torch, card, "13 frame")
    t14 = time.perf_counter()
    tpch_launches, tpch_inputs = tpch_phase(torch, card,
                                            "--profile" in argv)
    path_kernel_phase(torch, rate, stats, "tpch", tpch_inputs, card=card)
    del tpch_inputs
    emit({"phase": "tpch_seconds", "card": card,
          "seconds": time.perf_counter() - t14})
    memory_line(torch, card, "14 tpch")
    t15 = time.perf_counter()
    telemetry_launches = telemetry_phase(torch, rate, stats, card)
    emit({"phase": "telemetry_seconds", "card": card,
          "seconds": time.perf_counter() - t15})
    memory_line(torch, card, "15 telemetry")
    t16 = time.perf_counter()
    spill_launches, spill_inputs = spill_phase(torch, rate, stats, card)
    path_kernel_phase(torch, rate, stats, "spill", spill_inputs, card=card)
    del spill_inputs
    emit({"phase": "spill_seconds", "card": card,
          "seconds": time.perf_counter() - t16})
    memory_line(torch, card, "16 spill")

    # each kernel at the shape its path gives it: on the bench path
    # partition_ids' fused modulo, the join's add scans, its fills; on the
    # hash_join path the build and the probe
    entries = []
    for wrapper, key, counts in (
            (row_hash, "row_hash/nparts", launches),
            (scan32, "scan32/add", launches),
            (pair_max_scan, "pair_max_scan", launches),
            (bucket_build, "bucket_build", hash_launches),
            (bucket_probe, "bucket_probe", hash_launches)):
        n = PATH_SHAPE[wrapper.__name__]
        s = stats[(key, n)]
        entries.append({
            "name": wrapper.__name__, "route": "cuda",
            "source": wrapper.source, "replaces": wrapper.replaces,
            "launches": counts[wrapper.__name__],
            "mismatches": sum(r["mismatches"] for (name, _), r in
                              stats.items() if name.split("/")[0]
                              == wrapper.__name__),
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "groupby_launches": groupby_launches[wrapper.__name__],
            "sort_setops_launches": sort_setops_launches[wrapper.__name__],
            "frame_launches": frame_launches[wrapper.__name__],
            "tpch_launches": tpch_launches[wrapper.__name__],
            "telemetry_launches": telemetry_launches[wrapper.__name__],
            "spill_launches": spill_launches[wrapper.__name__],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": s["library_ms"], "n": n,
            "device_ms": s["kernel_device_ms"],
            "plain_device_ms": s["plain_device_ms"],
            "library_device_ms": s["library_device_ms"]})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
