"""Out-of-core relational ops: host-partitioned spill + per-partition
device compute.

Port of ``cylon_tpu/outofcore.py``. One device's memory is a hard
ceiling, so past it the pass takes the grace-join structure the
streaming graph (:mod:`cylon_tpu_torch.ops_graph`) already models, with
the partition buffers spilled to HOST memory:

- **partition phase** (numpy): stream fixed-size chunks (host column
  mappings, or :func:`cylon_tpu_torch.io.read_parquet_chunks` tables);
  hash-split each chunk's rows into ``n_partitions`` host buckets. The
  host hash (:func:`host_partition_chunks`) is the JAX package's, bit
  for bit, so both packages put every row in the same partition;
- **compute phase**: per partition, move ONE bucket pair onto the
  device (``device=``, CUDA by default), run the normal join, group-by
  or sort, and hand the result back to the host.

Device memory holds one partition's working set (two with the default
prefetch depth of 1, :mod:`cylon_tpu_torch.pipeline`); host memory holds
the spilled partitions. This is ``DisJoinOp``'s
partition->shuffle->join graph (``ops/dis_join_op.cpp:21-72``) with
"another rank's memory" replaced by "host memory".
"""

from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from cylon_tpu_torch import device as _device
from cylon_tpu_torch import pipeline, resilience, telemetry, watchdog
from cylon_tpu_torch.errors import DataLossError, InvalidArgument
from cylon_tpu_torch.telemetry import memory as _memory
from cylon_tpu_torch.utils.tracing import span as _span

__all__ = ["host_partition_chunks", "ooc_join", "ooc_groupby", "ooc_sort"]


def _hash_u64(a: np.ndarray) -> np.ndarray:
    """Vectorised 64-bit mix (splitmix64 finalizer) — host twin of the
    device row hash: only cross-side CONSISTENCY matters (both sides of
    a join partition with the same function), not equality with the
    device murmur."""
    x = a.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _row_hash(cols: Sequence[np.ndarray]) -> np.ndarray:
    h = np.zeros(len(cols[0]), np.uint64)
    for c in cols:
        if c.dtype.kind in ("U", "O", "S"):
            # string keys: stable per-value hash via factorize-like map
            uniq, inv = np.unique(np.asarray(c, dtype=str),
                                  return_inverse=True)
            vh = np.array([hash(v) & 0xFFFFFFFFFFFFFFFF for v in uniq],
                          np.uint64)
            k = vh[inv]
        elif c.dtype.kind == "f":
            k = c.view(np.uint64) if c.dtype.itemsize == 8 \
                else c.astype(np.float64).view(np.uint64)
        else:
            k = c.astype(np.int64).view(np.uint64)
        h = _hash_u64(h ^ _hash_u64(k))
    return h


def host_partition_chunks(chunks: Iterable[Mapping[str, np.ndarray]],
                          key_cols: Sequence[str],
                          n_partitions: int) -> list[dict]:
    """Partition phase: hash-split every chunk's rows into
    ``n_partitions`` host buckets. Returns one ``{col: np.ndarray}``
    dict per partition (dense concatenated spill buffers)."""
    def pid_of(cols):
        return (_row_hash([cols[k] for k in key_cols])
                % np.uint64(n_partitions)).astype(np.int64)

    return _scatter_chunks(chunks, pid_of, n_partitions)


def _resolve_source(src, op: str, chunk_rows: int):
    """Normalise ``src`` into a zero-arg factory of FRESH chunk
    iterators — the replayable-source contract every out-of-core pass
    needs (two-pass algorithms, retry after a transient fault, resume
    after a hard kill). Accepts a host column ``Mapping`` (sliced into
    chunks), a re-iterable of chunk dicts/Tables, or a zero-arg
    callable returning a fresh iterator. One-shot
    iterators/generators are REJECTED up front: a second iteration
    would silently see 0 rows and the pass would produce short output
    (``ooc_sort``, ``ooc_join`` and ``ooc_groupby`` all route through
    this guard).

    Every factory routes its chunk stream through the SHARED prefetcher
    (:func:`cylon_tpu_torch.pipeline.prefetched`): chunk k+1's pull — IO
    read, parquet decode, ``Table.to_pandas`` — runs on a
    watchdog-abandonable worker while chunk k is scattered/computed
    (``CYLON_TPU_OOC_PREFETCH_DEPTH``; 0 = sequential)."""
    if isinstance(src, Mapping):
        return lambda: pipeline.prefetched(
            _as_chunks(src, chunk_rows), op=op)
    if callable(src):
        return lambda: pipeline.prefetched(
            _as_chunks(src(), chunk_rows), op=op)
    try:
        probe = iter(src)
    except TypeError:
        raise InvalidArgument(
            f"{op} source must be a column Mapping, a re-iterable of "
            "chunks, or a zero-arg callable returning a fresh chunk "
            f"iterator; got {type(src).__name__}") from None
    if probe is src:
        raise InvalidArgument(
            f"{op} needs a REPLAYABLE source (a retry or a "
            "resume_dir= rerun re-iterates it), but a one-shot "
            "iterator/generator was passed — a second iteration would "
            "silently yield 0 rows and produce short output. Wrap it "
            "in a zero-arg callable returning a fresh iterator, e.g. "
            "lambda: read_parquet_chunks(path, chunk_rows)")
    return lambda: pipeline.prefetched(
        _as_chunks(src, chunk_rows), op=op)


def _as_chunks(src, chunk_rows: int):
    """Accept a dict of host arrays (sliced into chunks), or any
    iterable of dicts / Tables (used as-is). Every chunk passes the
    ``chunk_source`` injection point — the place a streaming source
    (tunneled parquet reader, network stream) fails in production."""
    from cylon_tpu_torch.table import Table

    if isinstance(src, Mapping):
        n = len(next(iter(src.values())))
        for lo in range(0, n, chunk_rows):
            watchdog.check("ooc_pass", "chunk source")
            resilience.inject("chunk_source")
            telemetry.counter("ooc.chunks").inc()
            yield {k: np.asarray(v)[lo:lo + chunk_rows]
                   for k, v in src.items()}
        return
    for c in src:
        # cooperative deadline checkpoint per chunk: an ooc pass under
        # a deadline raises promptly BETWEEN chunks (the watched
        # section around the whole pass only raises on exit)
        watchdog.check("ooc_pass", "chunk source")
        resilience.inject("chunk_source")
        telemetry.counter("ooc.chunks").inc()
        if isinstance(c, Table):
            # to_pandas decodes dictionary columns to values — codes
            # are TABLE-LOCAL and must not cross the host spill raw
            pdf = c.to_pandas()
            yield {k: pdf[k].to_numpy() for k in pdf.columns}
        else:
            yield c


@watchdog.watched("ooc_pass", "ooc_join")
def ooc_join(left, right, on, how: str = "inner",
             n_partitions: int = 8, chunk_rows: int = 1 << 22,
             sink: Callable | None = None,
             suffixes=("_x", "_y"),
             resume_dir: str | None = None,
             algorithm: str = "sort", device=None) -> int:
    """Out-of-core equi-join. ``left``/``right``: host column dicts,
    re-iterables of chunks, or zero-arg callables returning fresh
    chunk iterators (one-shot iterators are rejected — see
    :func:`_resolve_source`). Each of the ``n_partitions`` bucket
    pairs joins on device with the normal fused program; results spill
    to host via ``sink(partition_pandas_df)`` — or are only counted
    when ``sink`` is None. Returns total result rows.

    ``resume_dir`` makes the pass RESUMABLE: every completed
    partition's joined output checkpoints to a
    :class:`cylon_tpu_torch.resilience.CheckpointedRun` there (manifest
    updated atomically per partition), so a killed run re-invoked with
    the same arguments replays completed partitions from the store and
    recomputes only the rest — output identical to a fault-free run.
    The fingerprint (op + keys + how + partition plan) guards against
    resuming the wrong plan; recorded per-partition input sizes guard
    against a source that changed underneath the checkpoint.

    Each partition joins on ``device`` (``None``: CUDA); the host
    partition phase is numpy. A partition whose output outgrows its
    buffer (the port's join marks it ``nrows == out_capacity + 1``)
    reruns at twice the capacity, up to 12 doublings.

    Parity: completes the 100M x 100M config that exceeds one TPU
    chip's HBM in-core (the reference finishes it by spreading over
    ranks, ``docs/docs/arch.md:148-162``; one device finishes it by
    spilling partitions to host memory)."""
    from cylon_tpu_torch.ops.join import join as dev_join
    from cylon_tpu_torch.table import Table
    from cylon_tpu_torch.utils import pow2_bucket

    dev = _device.resolve(device)
    keys = [on] if isinstance(on, str) else list(on)
    if how not in ("inner", "left", "right", "fullouter", "outer"):
        raise InvalidArgument(f"unsupported how={how!r}")
    lchunks = _resolve_source(left, "ooc_join", chunk_rows)
    rchunks = _resolve_source(right, "ooc_join", chunk_rows)
    ckpt = None
    if resume_dir is not None:
        # the local-join kernel (sort vs bucketed hash) changes the
        # ordered=False row ORDER, so it is part of the partition plan:
        # a resume under a different EFFECTIVE kernel must recompute,
        # not mix — and the effective kernel is decided by the env
        # overrides (CYLON_TPU_JOIN_ALGORITHM / _HASH_IMPL / the chain
        # budget), not just the param, so fingerprint those
        from cylon_tpu_torch.ops import hash_join
        from cylon_tpu_torch.ops.join import _env_algorithm

        eff = _env_algorithm() or algorithm
        fp_alg = () if eff == "sort" else (
            (eff, hash_join.hash_impl(), hash_join.bucket_width()),)
        ckpt = resilience.CheckpointedRun(
            resume_dir, "join",
            (tuple(keys), how, int(n_partitions), tuple(suffixes))
            + fp_alg)
    lparts = host_partition_chunks(lchunks(), keys, n_partitions)
    rparts = host_partition_chunks(rchunks(), keys, n_partitions)
    from cylon_tpu_torch.errors import OutOfCapacity

    # resume decisions are fixed at manifest load; snapshotting here
    # keeps the prefetch worker and the async writer off the live
    # manifest dict (only the writer mutates it during the pass)
    done_map = ckpt.completed if ckpt is not None else {}

    def _ingest(p):
        """Pipelined ingest of partition p (prefetch worker): host
        sizes always; the device tables only for fresh, non-empty
        partitions — overlapped with partition p-1's compute. The
        host spill buckets are freed as soon as they are ingested.
        NOTE the tables are DEVICE-resident: the prefetcher's
        depth+1-unit bound is a device-memory bound here (depth 1 = two
        partitions' tables live at once — set
        CYLON_TPU_OOC_PREFETCH_DEPTH=0 or raise n_partitions when one
        bucket pair barely fits). Power-of-2 capacities bound the
        compiled-shape count to O(log(rows)) across partitions."""
        lp, rp = lparts[p], rparts[p]
        ln = len(next(iter(lp.values()))) if lp else 0
        rn = len(next(iter(rp.values()))) if rp else 0
        skip = (p in done_map or (ln == 0 and rn == 0)
                or ((ln == 0 or rn == 0) and how == "inner"))
        lt = rt = None
        if not skip:
            lt = Table.from_pydict(lp, capacity=pow2_bucket(max(ln, 1)),
                                   device=dev)
            rt = Table.from_pydict(rp, capacity=pow2_bucket(max(rn, 1)),
                                   device=dev)
        lparts[p] = rparts[p] = None  # free the spill as we go
        return ln, rn, lt, rt

    total = 0
    with pipeline.committer("join") as com:
        for p, (ln, rn, lt, rt) in pipeline.prefetch_map(
                range(n_partitions), _ingest, op="join"):
            watchdog.check("ooc_pass", f"join partition {p}")
            done = done_map.get(p)
            if done is not None:
                # completed partition: verify the re-scattered source
                # still matches, then replay the durable output
                # (identical bytes, no device work). The spill READ +
                # sink call ride the writer thread — FIFO submission
                # order keeps replayed and fresh partitions in
                # partition order, so a resumed run's sink stream is
                # byte-identical to a fault-free run's
                ckpt.verify_meta(p, "ooc_join", ln=ln, rn=rn)
                # count the resume always; read the spill only when a
                # sink needs the bytes (a count-only run must not pay
                # the IO)
                ckpt.note_resumed(p)
                if done and sink is not None:
                    import pandas as pd

                    com.submit(lambda p=p: sink(
                        pd.DataFrame(ckpt.load_unit(p))))
                total += done
                telemetry.counter("ooc.rows_out", op="join").inc(done)
                continue
            if ln == 0 or rn == 0:
                if (ln == 0 and rn == 0) or how == "inner":
                    if ckpt is not None:
                        com.submit(lambda p=p, ln=ln, rn=rn:
                                   ckpt.complete(p, {}, 0,
                                                 meta={"ln": ln,
                                                       "rn": rn}))
                    continue
                # outer semantics with an empty side still need the pass
            # one trace slice per device pass: on the merged timeline
            # the OOC join reads as n_partitions back-to-back bucket
            # slices, so a slow bucket (skewed partition, deep regrow
            # ladder) is visible by eye instead of buried in the pass
            # total
            with _span("ooc_join.partition", cat="stage", partition=p,
                       rows_left=ln, rows_right=rn):
                # stage-boundary device-memory sample: the live-bytes
                # gauge of telemetry.memory
                _memory.sample(op="ooc_join")
                # ~1 output row per probe row is the expected shape of
                # an equi-join on hash-partitioned keys; pow2 rounding
                # plus the doubling ladder below absorbs fan-out, and
                # starting tight matters — at 12.5M-row partitions a
                # 4x(ln+rn) start is a multi-GB output buffer that can
                # itself OOM the pass.
                # ladder depth 12: the tight start shifts the ceiling
                # down 4x vs the old 4x(ln+rn) start, and hot-key
                # fan-out inside ONE partition cannot be relieved by
                # more partitions — keep the reachable maximum at
                # least where it was (a device OOM during a deep
                # regrow raises through, which is the honest limit)
                cap = pow2_bucket(2 * max(ln, rn, 1))
                with _span("ooc.compute", cat="stage", op="join",
                           unit=p):
                    for _ in range(12):
                        res = dev_join(lt, rt,
                                       on=keys if len(keys) > 1
                                       else keys[0], how=how,
                                       suffixes=suffixes,
                                       out_capacity=cap,
                                       ordered=False,
                                       algorithm=algorithm)
                        # the port's overflow mark: nrows == cap + 1
                        nrows = int(res.nrows)
                        if nrows <= cap:
                            break
                        del res
                        cap *= 2
                    else:
                        raise OutOfCapacity(
                            f"ooc_join partition {p}: output exceeds "
                            f"{cap} rows — raise n_partitions")
                    pdf = (res.to_pandas()
                           if ckpt is not None or sink is not None
                           else None)
                total += nrows
                telemetry.counter("ooc.rows_out", op="join").inc(nrows)
                if pdf is not None:
                    cols = ({c: pdf[c].to_numpy()
                             for c in pdf.columns}
                            if ckpt is not None else None)

                    def _commit(p=p, cols=cols, pdf=pdf, nrows=nrows,
                                ln=ln, rn=rn):
                        # checkpoint BEFORE the sink sees the
                        # partition (both on the one writer thread, in
                        # order): a kill between the two replays it on
                        # resume, so acknowledged output is never
                        # recomputed and unacknowledged output is
                        # never lost
                        if ckpt is not None:
                            ckpt.complete(p, cols, nrows,
                                          meta={"ln": ln, "rn": rn})
                        if sink is not None:
                            sink(pdf)

                    com.submit(_commit)
                    del pdf
                del res, lt, rt
    return total


@watchdog.watched("ooc_pass", "ooc_groupby")
def ooc_groupby(src, by: Sequence[str], aggs,
                chunk_rows: int = 1 << 22,
                transform: Callable | None = None,
                resume_dir: str | None = None, device=None):
    """Out-of-core decomposable groupby: per chunk, a device
    pre-combine shrinks the chunk to its partial aggregates (tiny for
    low-cardinality groups); partials accumulate on host and one final
    device combine produces the result Table. ``aggs``: (src, op[,
    out]) with op in sum/count/min/max (decompose mean as sum+count —
    :mod:`cylon_tpu_torch.tpch.streaming` shows the pattern). ``src``: a
    host column Mapping, a re-iterable of chunks, or a zero-arg
    callable returning a fresh chunk iterator (one-shot iterators are
    rejected — see :func:`_resolve_source`).

    ``transform(chunk_dict) -> Table`` optionally maps each raw chunk
    to the table the pre-combine consumes (on ``device``, the plain
    ingest's and the final combine's; ``None``: CUDA) (filters, derived columns,
    probe-side joins — the TPC-H streaming queries are exactly this
    hook); default is a plain ingest.

    ``resume_dir`` makes the pass RESUMABLE at chunk granularity:
    every chunk's partial aggregate checkpoints to a
    :class:`cylon_tpu_torch.resilience.CheckpointedRun` (manifest updated
    atomically per chunk), so a killed run re-invoked with the same
    arguments replays completed partials from the store — the chunk
    source is re-iterated, but the transform + device pre-combine are
    skipped for every completed chunk, and the final combine (cheap —
    one row per group per chunk) produces output identical to a
    fault-free run. The fingerprint covers keys, aggs, chunking and
    the transform's identity; the recorded per-chunk source rows guard
    against a source that changed underneath the checkpoint.

    Parity: the chunked pre-combine -> final combine structure of
    ``DistributedHashGroupBy`` (groupby/groupby.cpp:62-78) applied to
    the chunk dimension, partials living on host between chunks."""
    from cylon_tpu_torch.ops.groupby import groupby_aggregate
    from cylon_tpu_torch.table import Table

    dev = _device.resolve(device)
    merge = {"sum": "sum", "count": "sum", "size": "sum",
             "min": "min", "max": "max"}
    aggs = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[0]}_{a[1]}")
            for a in (tuple(x) for x in aggs)]
    bad = [op for _, op, _ in aggs if op not in merge]
    if bad:
        raise InvalidArgument(
            f"non-decomposable ops {bad}; decompose (mean = sum+count) "
            "or use the in-core path")
    chunks = _resolve_source(src, "ooc_groupby", chunk_rows)
    import pandas as pd

    ckpt = None
    if resume_dir is not None:
        # the transform is part of the plan: two passes differing only
        # in their transform must never share partials. Its code
        # identity (module + qualname) is the best cheap stand-in for
        # semantic identity; a renamed/relocated transform re-runs.
        tf = (None if transform is None else
              (getattr(transform, "__module__", None),
               getattr(transform, "__qualname__", repr(transform))))
        ckpt = resilience.CheckpointedRun(
            resume_dir, "groupby",
            (tuple(by), tuple(tuple(a) for a in aggs),
             int(chunk_rows), tf))
    done_map = ckpt.completed if ckpt is not None else {}
    partials: list = []
    # pipelined: the chunk source arrives through the shared prefetcher
    # (chunk i+1 pulls/decodes on a worker while chunk i pre-combines
    # on-device — see _resolve_source), and each chunk's checkpoint
    # commit overlaps the next chunk's compute on the async writer
    with pipeline.committer("groupby") as com:
        for i, chunk in enumerate(chunks()):
            src_rows = len(next(iter(chunk.values()))) if chunk else 0
            done = done_map.get(i)
            if done is not None:
                ckpt.verify_meta(i, "ooc_groupby", src_rows=src_rows)
                cols = ckpt.resume_unit(i)
                if done:
                    partials.append(pd.DataFrame(cols))
                continue
            with _span("ooc_groupby.chunk", cat="stage", chunk=i):
                _memory.sample(op="ooc_groupby")
                with _span("ooc.compute", cat="stage", op="groupby",
                           unit=i):
                    t = (Table.from_pydict(chunk, device=dev)
                         if transform is None else transform(chunk))
                    part = groupby_aggregate(
                        t, list(by), [(s, op, o) for s, op, o in aggs])
                    # partials hop through pandas: tiny (one row per
                    # group), and dictionary key columns decode to
                    # values (codes are chunk-local)
                    pdf = part.to_pandas()
                if ckpt is not None:
                    cols = {c: pdf[c].to_numpy() for c in pdf.columns}
                    com.submit(lambda i=i, cols=cols, n=len(pdf),
                               sr=src_rows: ckpt.complete(
                                   i, cols, n, meta={"src_rows": sr}))
                partials.append(pdf)
                del t, part
    if not partials:
        raise InvalidArgument("ooc_groupby: empty input")

    merged_df = pd.concat(partials, ignore_index=True)
    final = Table.from_pydict(
        {c: merged_df[c].to_numpy() for c in merged_df.columns},
        device=dev)
    return groupby_aggregate(final, list(by),
                             [(o, merge[op], o) for _, op, o in aggs])


def _lex_gt(cols: Sequence[np.ndarray], split) -> np.ndarray:
    """Vectorised lexicographic ``row > split`` over parallel
    partition-encoded key columns (see :func:`_sortable`; each column
    compares in its own dtype — no cross-column promotion)."""
    gt = np.zeros(len(cols[0]), bool)
    eq = np.ones(len(cols[0]), bool)
    for c, s in zip(cols, split):
        gt |= eq & (c > s)
        eq &= c == s
    return gt


def _sortable(a: np.ndarray) -> np.ndarray:
    """Key column encoded for partition comparisons. Ints pass through
    in their own dtype (no precision loss). Floats map to
    order-preserving uint64 (the sign-flip bit trick), with NaN
    canonicalised to a pattern ABOVE +inf — so NaNs range-partition
    strictly last, after real infinities, matching the device sort's
    (and pandas') inf-before-NaN placement. Datetimes likewise map to
    order-preserving uint64 with NaT canonicalised to the TOP pattern:
    the raw int64 NaT sentinel is INT64_MIN, and NaT comparisons are
    always-False in numpy, so passing the dtype through would silently
    route every NaT row to bucket 0 while the per-bucket device sort
    (null validity) and pandas both place them last."""
    a = np.asarray(a)
    if a.dtype.kind not in "iufM":
        raise InvalidArgument(
            f"ooc_sort keys must be numeric/datetime, got {a.dtype}")
    if a.dtype.kind == "M":
        u = a.view(np.int64).astype(np.uint64) ^ np.uint64(1 << 63)
        return np.where(np.isnat(a), np.uint64(0xFFFFFFFFFFFFFFFF), u)
    if a.dtype.kind != "f":
        return a
    f = np.ascontiguousarray(a, np.float64)
    u = f.view(np.uint64)
    u = np.where(np.isnan(f), np.uint64(0x7FF8000000000000), u)
    return np.where(u >> np.uint64(63) == 1, ~u,
                    u | np.uint64(1 << 63))


def _scatter_chunks(chunks, pid_fn, n_partitions: int) -> list[dict]:
    """Shared partition scatter: route every chunk's rows into
    ``n_partitions`` host buckets by ``pid_fn(cols) -> int64[n]``,
    returning one dense ``{col: np.ndarray}`` per partition (empty
    partitions keep the schema). Rows-in vs rows-out is verified — a
    ``pid_fn`` straying outside ``[0, n_partitions)`` (or any scatter
    bug) raises :class:`~cylon_tpu_torch.errors.DataLossError` instead of
    silently shrinking the spill."""
    acct = resilience.RowAccount("host_partition_chunks")
    parts: list[dict[str, list]] = [{} for _ in range(n_partitions)]
    schema: dict[str, np.dtype] = {}
    for chunk in chunks:
        cols = {k: np.asarray(v) for k, v in chunk.items()}
        acct.add_in(len(next(iter(cols.values()))) if cols else 0)
        pid = pid_fn(cols)
        # the stable order of the partition ids; ids that fit a byte sort
        # by radix (numpy's stable sort of an 8/16-bit type), the same
        # permutation as the int64 sort in a fraction of its time
        narrow = (np.uint8 if n_partitions <= 1 << 8 else
                  np.uint16 if n_partitions <= 1 << 16 else None)
        order = np.argsort(pid if narrow is None or pid.size == 0
                           or pid.min() < 0 or pid.max() >= n_partitions
                           else pid.astype(narrow), kind="stable")
        bounds = np.searchsorted(pid[order], np.arange(n_partitions + 1))
        for name, arr in cols.items():
            arr = arr[order]
            schema.setdefault(name, arr.dtype)
            for p in range(n_partitions):
                lo, hi = bounds[p], bounds[p + 1]
                if hi > lo:
                    parts[p].setdefault(name, []).append(arr[lo:hi])
        del cols
    out = []
    for p in parts:
        full = {name: (np.concatenate(p[name]) if len(p[name]) > 1
                       else p[name][0]) if name in p
                else np.empty(0, dt)  # keep schema on empty partitions
                for name, dt in schema.items()}
        acct.add_out(len(next(iter(full.values()))) if full else 0)
        out.append(full)
    acct.verify()
    return out


@watchdog.watched("ooc_pass", "ooc_sort")
def ooc_sort(src, by, n_partitions: int = 8, chunk_rows: int = 1 << 22,
             sink: Callable | None = None,
             sample_stride: int = 8192,
             resume_dir: str | None = None, device=None) -> int:
    """Out-of-core sort: the host-DRAM twin of ``dist_sort``'s
    sample-sort (sample -> splitters -> range partition -> per-range
    device sort), completing sorts whose in-core working set exceeds
    one device's memory. Two passes over ``src`` (a host column dict, a
    re-iterable of chunks, or a zero-arg callable returning a FRESH
    chunk iterator — e.g. ``lambda: read_parquet_chunks(path, 1 <<
    22)``; one-shot iterators/generators are REJECTED up front, since
    pass 1 would exhaust them and pass 2 would silently sort nothing):
    pass 1 strided-samples the keys and picks ``n_partitions - 1``
    splitter tuples; pass 2 range-partitions every chunk into host
    buckets by vectorised lexicographic compare. Each bucket then
    device-sorts with the normal fused program and spills via
    ``sink(pandas_df)`` IN RANGE ORDER — the concatenation of the sink
    calls is the globally sorted table. Returns total rows.

    Loss accounting: pass-1 and pass-2 row counts must agree (a source
    that yields fewer rows on its second iteration raises
    :class:`~cylon_tpu_torch.errors.DataLossError`), and the spilled bucket
    total must equal the pass-2 count.

    ``resume_dir`` makes pass 2 RESUMABLE: every completed bucket's
    sorted output checkpoints to a
    :class:`cylon_tpu_torch.resilience.CheckpointedRun`
    there (manifest updated atomically per bucket), so a killed run
    re-invoked with the same arguments replays completed buckets from
    the store and recomputes only from the first incomplete one — the
    output is identical to a fault-free run. A manifest whose
    fingerprint (keys + splitters) does not match is discarded, never
    resumed against the wrong plan.

    Parity: ``dist_sort``'s sample-sort structure
    (``table.cpp DistributedSort`` -> sample + SortImpl) with "another
    rank's memory" replaced by host DRAM, like :func:`ooc_join`."""
    from cylon_tpu_torch.ops.selection import sort_table
    from cylon_tpu_torch.table import Table
    from cylon_tpu_torch.utils import pow2_bucket

    dev = _device.resolve(device)
    keys = [by] if isinstance(by, str) else list(by)
    chunks = _resolve_source(src, "ooc_sort", chunk_rows)

    # pass 1: strided per-column key samples (each keeps its own
    # dtype) -> equi-spaced splitter tuples; rows counted for the
    # pass-1 vs pass-2 conservation check
    rows_pass1 = 0
    samples: list[list[np.ndarray]] = [[] for _ in keys]
    for chunk in chunks():
        kc = [_sortable(np.asarray(chunk[k])) for k in keys]
        rows_pass1 += len(kc[0])
        if len(kc[0]):
            for i, c in enumerate(kc):
                samples[i].append(c[::sample_stride])
    if not samples[0]:
        return 0
    scols = [np.concatenate(s) for s in samples]
    order = np.lexsort(tuple(reversed(scols)))
    pos = (np.arange(1, n_partitions)
           * (len(order) / n_partitions)).astype(np.int64)
    pos = np.clip(pos, 0, len(order) - 1)
    splitters = [tuple(c[order[p]] for c in scols) for p in pos]

    ckpt = None
    if resume_dir is not None:
        ckpt = resilience.CheckpointedRun(
            resume_dir, "sort", (tuple(keys), n_partitions, splitters))

    # pass 2: range-partition every chunk into host buckets
    def pid_of(cols_dict):
        kc = [_sortable(cols_dict[k]) for k in keys]
        pid = np.zeros(len(kc[0]), np.int64)
        for s in splitters:
            pid += _lex_gt(kc, s)
        return pid

    parts = _scatter_chunks(chunks(), pid_of, n_partitions)
    # _scatter_chunks verifies chunk rows == bucket rows internally, so
    # the bucket sizes ARE the pass-2 row count
    sizes = [len(next(iter(p.values()))) if p else 0 for p in parts]
    rows_pass2 = sum(sizes)
    if rows_pass2 != rows_pass1:
        raise DataLossError(
            f"ooc_sort: pass 1 saw {rows_pass1} rows but pass 2 saw "
            f"{rows_pass2} — the source is not replayable (an "
            "exhausted/truncating iterator?); pass a zero-arg callable "
            "that returns a fresh iterator each call")

    # range order: per-bucket device sort, spill in splitter order.
    # With a store, completed buckets replay from their durable spill
    # (identical bytes, no recompute) and each fresh bucket is spilled
    # + recorded BEFORE its sink call — both on the ONE async-writer
    # thread, in bucket order — so a kill between buckets never loses
    # acknowledged work and the sink stream keeps range order.
    done_map = ckpt.completed if ckpt is not None else {}

    def _ingest(p):
        """Pipelined ingest of bucket p (prefetch worker): the
        host→device ``from_pydict`` of bucket p+1 overlaps bucket p's
        device sort; the host bucket is freed as soon as ingested.
        Device-resident lookahead — same device-memory note as ooc_join's
        ingest: depth+1 buckets live at once, depth 0 restores the
        one-bucket footprint."""
        full, n = parts[p], sizes[p]
        t = None
        if p not in done_map and n > 0:
            t = Table.from_pydict(full, capacity=pow2_bucket(n), device=dev)
        parts[p] = None  # free the spill as we go
        return t

    total = 0
    with pipeline.committer("sort") as com:
        for p, t in pipeline.prefetch_map(range(n_partitions), _ingest,
                                          op="sort"):
            watchdog.check("ooc_pass", f"sort bucket {p}")
            n = sizes[p]
            done = done_map.get(p)
            if done is not None:
                if done != n:
                    raise DataLossError(
                        f"ooc_sort: resume manifest records {done} "
                        f"rows for bucket {p} but the re-scattered "
                        f"source has {n} — the source changed since "
                        "the manifest was written; clear the "
                        "resume_dir")
                ckpt.note_resumed(p)
                if n and sink is not None:
                    import pandas as pd

                    com.submit(lambda p=p: sink(
                        pd.DataFrame(ckpt.load_unit(p))))
                total += n
                # replayed rows count toward rows_out too: a resumed
                # run produces identical output to a clean one, and
                # must not read as a row deficit on any dashboard
                telemetry.counter("ooc.rows_out", op="sort").inc(n)
                continue
            if n == 0:
                if ckpt is not None:
                    com.submit(lambda p=p: ckpt.complete(p, {}, 0))
                continue
            with _span("ooc_sort.bucket", cat="stage", bucket=p,
                       rows=n):
                _memory.sample(op="ooc_sort")
                with _span("ooc.compute", cat="stage", op="sort",
                           unit=p):
                    res = sort_table(t, keys)
                    pdf = res.to_pandas()
                cols = ({c: pdf[c].to_numpy() for c in pdf.columns}
                        if ckpt is not None else None)

                def _commit(p=p, cols=cols, pdf=pdf, n=n):
                    if ckpt is not None:
                        ckpt.complete(p, cols, n)
                    if sink is not None:
                        sink(pdf)

                total += n
                telemetry.counter("ooc.rows_out", op="sort").inc(n)
                if ckpt is not None or sink is not None:
                    com.submit(_commit)
                del res, t, pdf
    resilience.check_conservation("ooc_sort", rows_pass2, total)
    return total
