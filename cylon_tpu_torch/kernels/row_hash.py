"""Row hash: the murmur3 chain over u32 word streams, as a CUDA kernel.

Kernel source: ``cylon_tpu_torch/csrc/row_hash.cu``. It replaces the
Pallas kernel ``row_hash`` (``cylon_tpu/ops/pallas_kernels.py``,
``_hash_kernel`` / ``_row_hash_impl``).

Word streams are 1-D int32 (or uint32) tensors holding u32 bit patterns;
they may be strided views, such as the (lo, hi) words of an int64 column
(``column.view(torch.int32).view(-1, 2)[:, 0]``), and are read in place.
A row key may have any number of words, as in the JAX package: the
kernel takes them in chunks of :data:`CHUNK`, one launch a chunk, and
``row_hash.launches`` counts every launch.
"""

import ctypes

import torch

from cylon_tpu_torch.kernels import build

MURMUR_SEED = 0x9747B28C
#: word streams one launch takes (``kChunk`` in row_hash.cu)
CHUNK = 16
_WORD_DTYPES = (torch.int32, torch.uint32)


def row_hash_plain(words, nparts: int = 0, *,
                   seed: int = MURMUR_SEED) -> torch.Tensor:
    """The same function in plain PyTorch: int64 arithmetic masked to 32
    bits after every step (torch implements no shifts, remainders or
    comparisons for ``torch.uint32``)."""
    from cylon_tpu_torch.ops.hash import _fmix32, _mix_word, u32

    n = words[0].shape[0]
    h = torch.full((n,), seed, dtype=torch.int64, device=words[0].device)
    for w in words:
        h = _mix_word(h, u32(w))
    h = _fmix32(h ^ (4 * len(words)))
    if nparts:
        h = h % nparts
    return h.to(torch.int32)


def _check(words) -> int:
    if not words:
        raise ValueError("row_hash needs at least one word stream")
    n = words[0].shape[0]
    dev = words[0].device
    for w in words:
        if w.dim() != 1 or w.shape[0] != n:
            raise ValueError("row_hash word streams must be 1-D of one "
                             "length")
        if w.dtype not in _WORD_DTYPES:
            raise TypeError(f"row_hash words must be int32 or uint32 bit "
                            f"patterns, got {w.dtype}")
        if w.device != dev:
            raise ValueError("row_hash word streams lie on several devices")
    return n


def row_hash(words, nparts: int = 0, *,
             seed: int = MURMUR_SEED) -> torch.Tensor:
    """[n] row hash of ``words`` (u32 bit patterns in an int32 tensor),
    or with ``nparts`` the int32 partition ids ``hash % nparts``.

    A CPU tensor takes :func:`row_hash_plain`; a CUDA tensor launches the
    kernel or raises."""
    words = list(words)
    n = _check(words)
    dev = words[0].device
    if dev.type == "cpu":
        return row_hash_plain(words, nparts, seed=seed)
    if dev.type != "cuda":
        raise ValueError(f"row_hash: unsupported device {dev}")
    if not 0 <= nparts < 2 ** 31:
        raise ValueError(f"row_hash: nparts {nparts} out of range")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = build.library()
    k = len(words)
    ptrs = (ctypes.c_void_p * k)(*[w.data_ptr() for w in words])
    strides = (ctypes.c_longlong * k)(*[w.stride(0) for w in words])
    err = lib.cylon_row_hash(ptrs, strides, k, n, seed & 0xFFFFFFFF,
                             nparts, out.data_ptr(), build.stream_of(out))
    build.check(err, "row_hash")
    build.count(row_hash, -(-k // CHUNK))
    return out


row_hash.launches = 0
row_hash.plain = row_hash_plain
row_hash.source = "cylon_tpu_torch/csrc/row_hash.cu"
row_hash.replaces = "cylon_tpu/ops/pallas_kernels.py:96 _hash_kernel"
