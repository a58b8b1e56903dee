"""Vectorised row hashing for partition assignment.

Port of ``cylon_tpu/ops/hash.py``: the reference's per-column
MurmurHash3 construction (``arrow/arrow_partition_kernels.cpp:140-297``)
as whole-column u32 word streams. 64-bit columns hash as two 32-bit words
(lo, hi); floats are canonicalised first (-0.0 -> +0.0, every NaN -> the
canonical NaN) so that equal values hash equally. Hash values are
bit-identical to the JAX package's.

A u32 word is carried as an int32 tensor holding its bit pattern: torch
implements no shifts, remainders or comparisons for ``torch.uint32`` on
the CPU, and the CUDA kernel reads the same four bytes either way. The
plain arithmetic below works on int64 masked to 32 bits after every
step; an int64 product of two 32-bit values may wrap past 2^63, but its
low 32 bits stay right.
"""

from typing import Sequence

import torch

from cylon_tpu_torch.kernels import row_hash
from cylon_tpu_torch.kernels.row_hash import MURMUR_SEED

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def u32(w: torch.Tensor) -> torch.Tensor:
    """u32 bit pattern (int32 or uint32 tensor) -> int64 in [0, 2^32)."""
    return w.to(torch.int64) & M32


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_word(h, k):
    """One murmur3 block step: fold word k into running hash h (both
    int64 in [0, 2^32))."""
    k = (k * _C1) & M32
    k = _rotl32(k, 15)
    k = (k * _C2) & M32
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & M32


def _fmix32(h):
    """murmur3 finaliser (``util/murmur3.cpp`` fmix32)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def canonical_float(data: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 and any NaN payload -> the canonical NaN, so that bit
    identity equals value identity."""
    data = torch.where(data == 0, torch.zeros((), dtype=data.dtype,
                                              device=data.device), data)
    return torch.where(torch.isnan(data),
                       torch.full((), float("nan"), dtype=data.dtype,
                                  device=data.device), data)


def _words32(data: torch.Tensor) -> list:
    """Column -> list of u32 word streams (int32 bit patterns). The words
    of a 64-bit column, and the word columns of a device-bytes column
    ([cap, nwords]), are strided views of it, read in place. Bytes hash
    by content, so relations ingested apart send equal strings to the
    same rank with no dictionary in between."""
    if data.dim() == 2:
        return [data[:, i] for i in range(data.shape[1])]
    if data.dtype == torch.bool:
        return [data.to(torch.int32)]
    if data.is_floating_point():
        data = canonical_float(data)
        if data.element_size() < 4:
            data = data.to(torch.float32)
    if data.element_size() < 4:
        return [data.to(torch.int32)]   # sign- or zero-extends, as astype
    if data.element_size() == 4:
        return [data.view(torch.int32)]
    pair = data.contiguous().view(torch.int32).view(-1, 2)
    return [pair[:, 0], pair[:, 1]]


def _row_words(arrays: Sequence[torch.Tensor],
               validities: "Sequence[torch.Tensor | None] | None") -> list:
    """Row key -> canonical u32 word streams (nulls zeroed, validity
    appended as its own word so null == null)."""
    words = []
    for i, a in enumerate(arrays):
        v = validities[i] if validities is not None else None
        for w in _words32(a):
            if v is not None:
                w = torch.where(v, w, torch.zeros((), dtype=w.dtype,
                                                  device=w.device))
            words.append(w)
        if v is not None:
            words.append(v.to(torch.int32))
    return words


def paired_validities(lkeys: Sequence[torch.Tensor], lvals: Sequence,
                      rkeys: Sequence[torch.Tensor], rvals: Sequence):
    """Validity lists for hashing or comparing two sides' keys against
    each other. A key nullable on one side only gets an all-valid mask on
    the other: the validity word joins a row's words only where a mask
    exists, so without it equal keys would hash (and compare) differently.
    (The JAX package uses the masks as they are, and its hash partition
    and bucketed hash join lose those matches.)"""
    lvals, rvals = list(lvals), list(rvals)

    def ones(key):   # [cap], also for a [cap, nwords] bytes key
        return torch.ones(key.shape[0], dtype=torch.bool, device=key.device)

    for i, (lv, rv) in enumerate(zip(lvals, rvals)):
        if lv is None and rv is not None:
            lvals[i] = ones(lkeys[i])
        elif rv is None and lv is not None:
            rvals[i] = ones(rkeys[i])
    return lvals, rvals


def hash_columns(arrays: Sequence[torch.Tensor],
                 validities: "Sequence[torch.Tensor | None] | None" = None,
                 seed: int = MURMUR_SEED) -> torch.Tensor:
    """[capacity] u32 row hash (int32 bit patterns) over key columns;
    nulls hash as their own word stream, so null == null."""
    return row_hash(_row_words(arrays, validities), seed=seed)


def partition_ids(arrays: Sequence[torch.Tensor], num_partitions: int,
                  validities=None) -> torch.Tensor:
    """hash % world as int32 -- parity: ``MapToHashPartitions``
    (``partition/partition.cpp:93-174``); the kernel fuses the modulo."""
    return row_hash(_row_words(arrays, validities), num_partitions)
