"""The bucketed hash join's kernels: ``bucket_build`` and ``bucket_probe``.

Kernel source: ``cylon_tpu_torch/csrc/bucket.cu``. They replace the Pallas
kernels ``bucket_build`` (``_bucket_build_kernel`` /
``_bucket_build_impl``) and ``bucket_probe`` (``_bucket_probe_kernel`` /
``_bucket_probe_impl``) of ``cylon_tpu/ops/pallas_kernels.py``; the plain
versions below are ports of their jnp twins ``hash_join._build_jnp`` and
``_probe_jnp``.

The table is entry-major ``[width, nb]`` int32, as in the JAX package:
entry e of bucket b holds the (e+1)-th smallest row id whose bucket id is
b, or -1. The JAX package gates its kernels on a VMEM budget; here the
table lives in device memory, so a CUDA tensor always takes the kernel,
within the limits the kernels have: fewer than 2^31 rows (int32 row ids)
and ``width <= 30`` (the probe mask's bits).

The build partitions the rows by tiles of T consecutive buckets (a count,
then two scatter levels of at most 128 digits each, each block sorting a
batch by digit in shared memory), then one block a tile builds its
``[width, T]`` slice of the table in shared memory and writes it out
whole; ``bucket.cu`` says why. :func:`build_plan` picks T, the chunks and
groups of rows the blocks take, and the scratch; the launcher computes the
same plan and refuses any other. The scratch is one staging buffer of 8
bytes a row and the count matrices; the first level stages in the table's
own memory where it fits.
"""

import ctypes
from typing import NamedTuple

import torch

from cylon_tpu_torch.kernels import build, scan

MAX_WIDTH = 30
MAX_ROWS = 2 ** 31 - 1
_WORD_DTYPES = (torch.int32, torch.uint32)


def _ids(x: torch.Tensor, name: str) -> None:
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"{name}: bucket ids must be a 1-D int32 tensor")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: {x.shape[0]} rows exceed the int32 row "
                         "ids")


def _words(ws, n: int, dev, name: str) -> None:
    for w in ws:
        if w.dim() != 1 or w.shape[0] != n:
            raise ValueError(f"{name}: word streams must be 1-D of the "
                             "side's length")
        if w.dtype not in _WORD_DTYPES:
            raise TypeError(f"{name}: words must be int32 or uint32 bit "
                            f"patterns, got {w.dtype}")
        if w.device != dev:
            raise ValueError(f"{name}: operands lie on several devices")


def one_int64_key(pwords, bwords) -> bool:
    """Is the key one int64 column on both sides, read in place: two
    32-bit word streams a side, the (lo, hi) halves of one 8-byte-aligned
    int64 tensor (hi 4 bytes after lo, both of stride 2)? Then the probe
    compares each key with one 8-byte load a side; any other layout
    compares word by word."""
    if len(pwords) != 2 or len(bwords) != 2:
        return False
    for lo, hi in (pwords, bwords):
        if lo.dtype not in _WORD_DTYPES or hi.dtype not in _WORD_DTYPES:
            return False
        if lo.stride(0) != 2 or hi.stride(0) != 2:
            return False
        if lo.data_ptr() % 8 or hi.data_ptr() != lo.data_ptr() + 4:
            return False
    return True


def _cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


# ------------------------------------------------------------- build

#: shared memory of one tile's table, and of a chunk's tile counters
TILE_BYTES = 64 * 1024
HIST_TILES = 16 * 1024
#: the count and coarse passes aim at two blocks an SM of an H100 (132
#: SMs); the fine pass takes each coarse digit's rows in GROUPS parts
TARGET_CHUNKS = 264
MIN_CHUNK = 4096
CHUNK_ALIGN = 1024
GROUPS = 16


class BuildPlan(NamedTuple):
    """How ``bucket_build``'s kernel cuts a build (``plan_of`` in
    ``bucket.cu`` computes the same)."""
    tile: int          # T buckets a tile, a power of two <= nb
    tiles: int         # ceil(nb / T)
    chunk: int         # rows a count (and coarse scatter) block takes
    chunks: int
    shared_hist: bool  # two-level partition; else global tile counters
    fine_bits: int     # F = 2 ** fine_bits tiles a coarse digit
    coarse: int        # P = ceil(tiles / F) coarse digits
    group_chunks: int  # chunks a fine scatter block takes
    groups: int
    tile_bytes: int    # shared memory of a tile build block
    hist_bytes: int    # shared memory of a count block
    scan_len: int      # elements of the longest scan
    count_words: int   # uint32 scratch for the counts (and a transpose)
    staging: int       # (row id, bucket) entries a staging buffer, even


def build_plan(cap: int, nb: int, width: int) -> BuildPlan:
    """The tile T is the largest power of two with T <= nb and
    T * width * 4 <= TILE_BYTES. Chunks of at least MIN_CHUNK rows, about
    TARGET_CHUNKS of them. Where the tiles' counters fit shared memory
    (at most HIST_TILES tiles) the rows reach their tiles in two scatter
    passes of at most 128 digits each: a coarse one by the top bits of the
    tile id, into [coarse digit, chunk] runs, and a fine one that takes
    each coarse digit's rows of a chunk group to their tiles. Else one
    scatter through [tiles] global counters."""
    if cap < 0 or nb < 1 or not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"build_plan: no plan for cap {cap}, nb {nb}, "
                         f"width {width}")
    tile = 1
    while 2 * tile <= nb and 2 * tile * width * 4 <= TILE_BYTES:
        tile *= 2
    tiles = -(-nb // tile)
    chunk = max(-(-cap // TARGET_CHUNKS), MIN_CHUNK)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    chunks = -(-cap // chunk) if cap else 1
    shared = tiles <= HIST_TILES
    fine_bits = ((tiles - 1).bit_length() + 1) // 2
    coarse = -(-tiles >> fine_bits)
    group_chunks = -(-chunks // GROUPS)
    groups = -(-chunks // group_chunks)
    if shared:
        scan_len = max(coarse * chunks, tiles * groups)
        count_words = coarse * chunks + 2 * tiles * groups
    else:
        scan_len, count_words = tiles, 2 * tiles
    return BuildPlan(
        tile=tile, tiles=tiles, chunk=chunk, chunks=chunks,
        shared_hist=shared, fine_bits=fine_bits, coarse=coarse,
        group_chunks=group_chunks, groups=groups,
        tile_bytes=4 * width * tile, hist_bytes=4 * tiles if shared else 0,
        scan_len=scan_len, count_words=count_words,
        staging=max(cap + cap % 2, 2))


def bucket_build_plain(bids: torch.Tensor, nb: int, width: int):
    """``width`` scatter-min rounds: each round the smallest unplaced row
    of every bucket wins its entry. Row ids outside ``[-1, nb)`` stay
    unplaced and count as overflow, as in the jnp twin."""
    cap = bids.shape[0]
    dev = bids.device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    # one spare slot at the end takes the writes the JAX twin drops
    flat = torch.full((width * nb + 1,), -1, dtype=torch.int32, device=dev)
    unplaced = bids >= 0
    placeable = unplaced & (bids < nb)
    safe = torch.where(placeable, bids, 0).to(torch.int64)
    for e in range(width):
        idx = torch.where(placeable, bids, nb).to(torch.int64)
        cand = torch.full((nb + 1,), cap, dtype=torch.int32, device=dev)
        cand.scatter_reduce_(0, idx, iota, "amin")   # in place: fresh buffer
        won = placeable & (cand[safe] == iota)
        flat.index_put_((torch.where(won, e * nb + safe, width * nb),), iota)
        unplaced &= ~won
        placeable &= ~won
    return flat[:-1].view(width, nb), unplaced.sum(dtype=torch.int32)


def bucket_build(bids: torch.Tensor, nb: int, width: int):
    """Build the ``[width, nb]`` int32 bucket table from [cap] int32 bucket
    ids (-1 = skip). Returns ``(table, overflow)``: ``overflow`` (0-d
    int32) counts the rows past ``width`` in their bucket; any overflow
    means the table misses rows. A CPU tensor takes
    :func:`bucket_build_plain`; a CUDA tensor launches the kernel or
    raises."""
    _ids(bids, "bucket_build")
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"bucket_build: width {width} not in 1..{MAX_WIDTH}")
    if nb < 1:
        raise ValueError(f"bucket_build: nb {nb} < 1")
    if bids.device.type == "cpu":
        return bucket_build_plain(bids, nb, width)
    _cuda(bids, "bucket_build")
    bids = bids.contiguous()
    dev = bids.device
    plan = build_plan(bids.shape[0], nb, width)
    lib = build.library()
    table = torch.empty((width, nb), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    counts = torch.empty(plan.count_words, dtype=torch.int32, device=dev)
    scratch = scan._scratch(lib, plan.scan_len, dev)
    staging_b = torch.empty(2 * plan.staging, dtype=torch.int32, device=dev)
    # the coarse pass stages in the table's memory where it fits (the tile
    # build writes the table after the last read of it); the global-counter
    # path has no coarse pass
    in_table = 4 * width * nb >= 8 * plan.staging or not plan.shared_hist
    staging_a = table if in_table else \
        torch.empty(2 * plan.staging, dtype=torch.int32, device=dev)
    err = lib.cylon_bucket_build(
        bids.data_ptr(), bids.shape[0], nb, width, plan.tile, plan.chunk,
        int(plan.shared_hist), counts.data_ptr(), plan.count_words,
        scratch.data_ptr(), scratch.shape[0], staging_a.data_ptr(),
        staging_a.numel() // 2, staging_b.data_ptr(), plan.staging,
        table.data_ptr(), overflow.data_ptr(), build.stream_of(bids))
    build.check(err, "bucket_build")
    build.count(bucket_build)
    return table, overflow


# ------------------------------------------------------------- probe

def bucket_probe_plain(pbids: torch.Tensor, pwords, table: torch.Tensor,
                       bwords) -> torch.Tensor:
    """``width`` gather-and-compare rounds. Probe rows whose bucket id
    lies outside ``[0, nb)`` get 0."""
    cap = pbids.shape[0]
    width, nb = table.shape
    bcap = bwords[0].shape[0] if bwords else 0
    mask = torch.zeros(cap, dtype=torch.int32, device=pbids.device)
    if bcap == 0:
        return mask
    valid = (pbids >= 0) & (pbids < nb)
    bsafe = torch.where(valid, pbids, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=pbids.device)
    for e in range(width):
        rr = table[e][bsafe]
        eq = valid & (rr >= 0) & (rr < bcap)
        rsafe = torch.clamp(rr, 0, bcap - 1).to(torch.int64)
        for pw, bw in zip(pwords, bwords):
            eq &= pw == bw[rsafe]   # in place: eq is a fresh mask
        mask |= torch.where(eq, torch.full((), 1 << e, dtype=torch.int32,
                                           device=pbids.device), zero)
    return mask


def bucket_probe(pbids: torch.Tensor, pwords, table: torch.Tensor,
                 bwords) -> torch.Tensor:
    """[pcap] int32 match bitmasks: bit e is set when ``table[e, pbids]``
    holds a build row whose key words (``bwords``) all equal the probe
    row's (``pwords``); bucket id -1 gives 0. The words are the canonical
    u32 streams of ``ops.hash._row_words`` and may be strided views.
    ``table`` comes from :func:`bucket_build` (its entries fill from 0). A
    CPU tensor takes :func:`bucket_probe_plain`; a CUDA tensor launches
    the kernel or raises."""
    pwords, bwords = list(pwords), list(bwords)
    _ids(pbids, "bucket_probe")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError("bucket_probe: table must be a [width, nb] int32 "
                         "tensor")
    width, nb = table.shape
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"bucket_probe: width {width} not in 1..{MAX_WIDTH}")
    if len(pwords) != len(bwords):
        raise ValueError("bucket_probe: probe and build sides have "
                         f"{len(pwords)} and {len(bwords)} words")
    bcap = bwords[0].shape[0] if bwords else 0
    _words(pwords, pbids.shape[0], pbids.device, "bucket_probe")
    _words(bwords, bcap, pbids.device, "bucket_probe")
    if table.device != pbids.device:
        raise ValueError("bucket_probe: operands lie on several devices")
    if pbids.device.type == "cpu":
        return bucket_probe_plain(pbids, pwords, table, bwords)
    _cuda(pbids, "bucket_probe")
    pcap = pbids.shape[0]
    if pcap == 0 or bcap == 0:
        return torch.zeros(pcap, dtype=torch.int32, device=pbids.device)
    mask = torch.empty(pcap, dtype=torch.int32, device=pbids.device)
    pbids = pbids.contiguous()
    table = table.contiguous()
    k = len(pwords)
    err = build.library().cylon_bucket_probe(
        pbids.data_ptr(), pcap,
        (ctypes.c_void_p * k)(*[w.data_ptr() for w in pwords]),
        (ctypes.c_longlong * k)(*[w.stride(0) for w in pwords]),
        (ctypes.c_void_p * k)(*[w.data_ptr() for w in bwords]),
        (ctypes.c_longlong * k)(*[w.stride(0) for w in bwords]),
        k, int(one_int64_key(pwords, bwords)), table.data_ptr(), nb, width,
        bcap, mask.data_ptr(), build.stream_of(pbids))
    build.check(err, "bucket_probe")
    build.count(bucket_probe)
    return mask


bucket_build.launches = 0
bucket_build.plain = bucket_build_plain
bucket_build.source = "cylon_tpu_torch/csrc/bucket.cu"
bucket_build.replaces = \
    "cylon_tpu/ops/pallas_kernels.py:360 _bucket_build_kernel"

bucket_probe.launches = 0
bucket_probe.plain = bucket_probe_plain
bucket_probe.source = "cylon_tpu_torch/csrc/bucket.cu"
bucket_probe.replaces = \
    "cylon_tpu/ops/pallas_kernels.py:445 _bucket_probe_kernel"
