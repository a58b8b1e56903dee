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
"""

import ctypes

import torch

from cylon_tpu_torch.kernels import build

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
    table = torch.empty((width, nb), dtype=torch.int32, device=bids.device)
    overflow = torch.empty((), dtype=torch.int32, device=bids.device)
    err = build.library().cylon_bucket_build(
        bids.data_ptr(), bids.shape[0], nb, width, table.data_ptr(),
        overflow.data_ptr(), build.stream_of(bids))
    build.check(err, "bucket_build")
    bucket_build.launches += 1
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
    bucket_probe.launches += 1
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
