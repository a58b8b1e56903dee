"""Bucketed O(n) hash join: build / probe instead of sort.

Port of ``cylon_tpu/ops/hash_join.py:53-329`` (reference analog:
``join/hash_join.cpp:22-31``, build the smaller side into a hash map,
probe the other). A power-of-2 bucket table of fixed-width chains
(``CYLON_TPU_JOIN_BUCKET_WIDTH`` entries per bucket, entry-major
``[width, nb]``) is built from the 32-bit murmur row hash the shuffle
computes (:mod:`cylon_tpu_torch.ops.hash`); the canonical u32 key-word
streams (``hash._row_words``: nulls zeroed plus a validity word, so null ==
null as in ``kernels.group_sort``) are the exact collision tiebreakers.
A device-bytes key enters as its word columns (``hash._words32``), so a
string key hashes and compares by content and the probe takes its
word-by-word path.

Both phases run through the kernel wrappers ``bucket_build`` and
``bucket_probe`` (:mod:`cylon_tpu_torch.kernels.bucket`): the CUDA kernels
on the card, their plain versions (the JAX package's jnp twins) on the
CPU. The JAX package's VMEM gate has no counterpart: the table lives in
device memory.

A chain longer than ``width`` cannot be stored: the build reports an
overflow count, and the join takes the unchanged sort join instead. The
eager caller decides that before the join, on the host
(:func:`chain_overflow`); :func:`bucketed_join_indices` can also check
the build's own count (``sort_fallback``, one host read), or register it
as a compiled query's overflow flag (``guard``, no host read: a replay
whose chains overflow reruns the query, which then takes the sort join;
``ops.join._guarded_route``). Either way the output equals the sort
join's: the same rows in pandas order for ``ordered=True``, the same row
set for ``ordered=False``.

Supported: ``how`` in {"inner", "left"} ("right" is swapped into "left"
by ``ops.join.join``; "fullouter" keeps the sort path, whose key-union
output order is a sort by construction).
"""

import os

import torch

from cylon_tpu_torch import plan
from cylon_tpu_torch.kernels import bucket_build, bucket_probe, row_hash
from cylon_tpu_torch.ops import kernels
from cylon_tpu_torch.ops.hash import M32, _row_words, paired_validities
from cylon_tpu_torch.utils import pow2_bucket
from cylon_tpu_torch.utils.tracing import host_read

#: default entries per bucket: the chain budget a bucket's key
#: multiplicities must exceed to force the sort fallback. The JAX package
#: sized it from the chain tail of uniform keys (max chain 15 at 1M rows,
#: 16 at 10M, 17 at 100M), so uniform data stays on the fast path through
#: about 10M build rows.
DEFAULT_BUCKET_WIDTH = 16

SUPPORTED_HOW = ("inner", "left")

#: which implementation ``algorithm="hash"`` routes to by default, as in
#: the JAX package: "sort" is the murmur-bucket-first ordering of the sort
#: join (``group_sort(hash_first=True)``); ``CYLON_TPU_JOIN_HASH_IMPL=
#: bucketed`` selects this module.
DEFAULT_HASH_IMPL = "sort"


def bucket_width() -> int:
    """Entries per bucket (``CYLON_TPU_JOIN_BUCKET_WIDTH``), 1..30."""
    try:
        w = int(os.environ.get("CYLON_TPU_JOIN_BUCKET_WIDTH",
                               DEFAULT_BUCKET_WIDTH))
    except ValueError:
        return DEFAULT_BUCKET_WIDTH
    return max(1, min(w, 30))   # mask bits must fit an int32


def table_slots(build_cap: int) -> int:
    """Bucket count: the power of two >= the build capacity (at least
    16), so the expected chain is about one row long."""
    return pow2_bucket(max(build_cap, 1), minimum=16)


def supported(how: str) -> bool:
    return how in SUPPORTED_HOW


def hash_impl() -> str:
    """"bucketed" (this module) or "sort" (the murmur-bucket-first
    ``group_sort(hash_first=True)`` ordering of the sort join), from
    ``CYLON_TPU_JOIN_HASH_IMPL``."""
    v = os.environ.get("CYLON_TPU_JOIN_HASH_IMPL", "").lower()
    return v if v in ("bucketed", "sort") else DEFAULT_HASH_IMPL


def describe_routing() -> dict:
    """What ``algorithm="hash"`` would do right now, no data needed."""
    return {
        "hash_impl": hash_impl(),
        "algorithm_env": os.environ.get("CYLON_TPU_JOIN_ALGORITHM",
                                        "") or None,
        "bucket_width": bucket_width(),
        "supported_how": list(SUPPORTED_HOW),
        "overflow_fallback": "sort",
    }


def _bucket_ids(words, nrows, nb: int) -> torch.Tensor:
    """[cap] int32 bucket ids: the row hash's low bits; -1 on padding."""
    cap = words[0].shape[0]
    h = row_hash(words)
    valid = kernels.valid_mask(cap, nrows, words[0].device)
    return torch.where(valid, h & (nb - 1), -1)


# ------------------------------------------------------------ phases

def build_phase(keys, validities, nrows, width: "int | None" = None):
    """Hash and bucket-insert one side. Returns ``(table, overflow, bids,
    words)``; ``words`` are the canonical u32 word streams the probe
    compares against."""
    width = bucket_width() if width is None else width
    nb = table_slots(keys[0].shape[0])
    words = _row_words(keys, validities)
    bids = _bucket_ids(words, nrows, nb)
    table, overflow = bucket_build(bids, nb, width)
    return table, overflow, bids, words


def probe_phase(keys, validities, nrows, table, bwords):
    """Hash and look up the other side in ``table``. Returns ``(mask,
    pbids)``: per-row match bitmasks over the chain entries."""
    words = _row_words(keys, validities)
    pbids = _bucket_ids(words, nrows, table.shape[1])
    return bucket_probe(pbids, words, table, bwords), pbids


def _emit(mask, pbids, pvalid, table, how, probe_is_left, out_cap,
          ordered):
    """Matched index pairs from the probe bitmasks: run-length offsets by
    prefix sum, then one scatter per chain entry. Valid output slots are
    contiguous in [0, total); ``ordered=True`` restores pandas order with
    one sort of the (left, right) pairs (ascending right id within a left
    row is the right-frame order the sort join keeps). Writes past
    ``out_cap`` land in one spare slot, sliced away, in place of the JAX
    ``mode="drop"``."""
    pcap = pbids.shape[0]
    width = table.shape[0]
    dev = pbids.device
    iota_p = torch.arange(pcap, dtype=torch.int32, device=dev)
    bsafe = torch.where(pbids >= 0, pbids, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    mcnt = torch.zeros(pcap, dtype=torch.int32, device=dev)
    for e in range(width):
        mcnt += (mask >> e) & 1   # in place: a fresh counter
    if how == "inner":
        ecounts = mcnt
    else:   # left (the probe side is the left): unmatched rows emit one
        ecounts = torch.where(pvalid, torch.clamp(mcnt, min=1), zero)
    offs = kernels.exclusive_cumsum(ecounts)
    total = (offs[-1] + ecounts[-1]) if pcap else zero
    li = torch.full((out_cap + 1,), -1, dtype=torch.int32, device=dev)
    ri = torch.full((out_cap + 1,), -1, dtype=torch.int32, device=dev)
    rank = torch.zeros(pcap, dtype=torch.int32, device=dev)
    for e in range(width):
        flag = (mask >> e) & 1
        rr = table[e][bsafe]
        pos = torch.where(flag > 0, (offs + rank).to(torch.int64), out_cap
                          ).clamp_(max=out_cap)
        li.index_put_((pos,), iota_p if probe_is_left else rr)
        ri.index_put_((pos,), rr if probe_is_left else iota_p)
        rank += flag
    if how == "left":
        pos0 = torch.where(pvalid & (mcnt == 0), offs.to(torch.int64),
                           out_cap).clamp_(max=out_cap)
        li.index_put_((pos0,), iota_p)
    li, ri = li[:out_cap], ri[:out_cap]
    if ordered:
        # one sort of the (left, right) pairs as u32s; valid left ids are
        # below 2^31 - 1, so the invalid slots take that as their left id
        # and the packed key stays below 2^63
        live = torch.arange(out_cap, dtype=torch.int32, device=dev) < total
        okl = torch.where(live, li.to(torch.int64), 2 ** 31 - 1)
        okr = torch.where(live, ri.to(torch.int64) & M32, M32)
        # the pairs are unique, so the order is total: no stability needed
        perm = torch.sort((okl << 32) | okr).indices
        li, ri = li[perm], ri[perm]
    return li, ri, total.to(torch.int32)


def bucketed_join_indices(lkeys, lvals, lrows, rkeys, rvals, rrows,
                          how: str, out_cap: int, ordered: bool,
                          sort_fallback=None, width: "int | None" = None,
                          guard: bool = False):
    """(left_idx, right_idx, total) gather plans of length ``out_cap``,
    the bucketed counterpart of ``join._join_indices`` (same contract: -1
    marks the null side of an output row, valid slots first).

    Build side: see :func:`sides` (for "left" the right, so an unmatched
    left row is a per-probe-row test). ``sort_fallback``, a callable
    returning the same triple, is taken when the build overflowed (one
    host sync on the overflow count; eager callers only). ``guard``
    registers the overflow count as an overflow flag of the enclosing
    compiled query instead (:func:`cylon_tpu_torch.plan.note_overflow`),
    with no host read. Pass neither only when overflow was ruled out
    (:func:`chain_overflow`).
    """
    (bkeys, bvals, brows), (pkeys, pvals, prows), build_left = sides(
        lkeys, lvals, lrows, rkeys, rvals, rrows, how)
    table, overflow, _, bwords = build_phase(bkeys, bvals, brows,
                                             width=width)
    if sort_fallback is not None and \
            host_read("build_overflow", lambda: int(overflow)) > 0:
        return sort_fallback()
    if guard:
        plan.note_overflow(overflow > 0)
    mask, pbids = probe_phase(pkeys, pvals, prows, table, bwords)
    pvalid = kernels.valid_mask(pkeys[0].shape[0], prows, pbids.device)
    return _emit(mask, pbids, pvalid, table, how,
                 probe_is_left=not build_left, out_cap=out_cap,
                 ordered=ordered)


def sides(lkeys, lvals, lrows, rkeys, rvals, rrows, how: str):
    """``((keys, validities, nrows) of the build side, the same of the
    probe side, build_left)``. The build side is the smaller capacity for
    "inner" and the right for "left". The validities are paired
    (:func:`cylon_tpu_torch.ops.hash.paired_validities`), so that a key
    nullable on one side only hashes and compares alike on both."""
    lvals, rvals = paired_validities(lkeys, lvals, rkeys, rvals)
    build_left = how == "inner" and lkeys[0].shape[0] <= rkeys[0].shape[0]
    left, right = (lkeys, lvals, lrows), (rkeys, rvals, rrows)
    return (left, right, True) if build_left else (right, left, False)


def chain_overflow(keys, validities, nrows,
                   width: "int | None" = None) -> bool:
    """Host-side pre-check (one sync): would any bucket chain of this
    build side exceed the chain budget?"""
    width = bucket_width() if width is None else width
    nb = table_slots(keys[0].shape[0])
    bids = _bucket_ids(_row_words(keys, validities), nrows, nb)
    idx = torch.where(bids >= 0, bids, nb).to(torch.int64)
    counts = torch.zeros(nb + 1, dtype=torch.int32, device=bids.device)
    counts.index_add_(0, idx, torch.ones_like(bids))   # in place: fresh
    return host_read("chain_check",
                     lambda: bool((counts[:nb] > width).any()))
