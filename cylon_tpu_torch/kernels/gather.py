"""The packed row gather: rows of a ``[cap, w]`` int32 word matrix by
index, as a CUDA kernel.

Kernel source: ``cylon_tpu_torch/csrc/gather.cu``. It replaces no Pallas
kernel: the JAX package leaves its row gathers to XLA (``jnp.take``). It
takes the place of PyTorch's ``index_select`` on the packed matrices of
``ops.selection.take_columns``, the join's plan gather and the exchange's
send buffer, which for rows of 16 bytes (or any multiple of 16) launches
one block for each index.

Every call adds its ``n`` to the counter ``gather.rows{route}``: ``plain``
where the plain version ran (a CPU tensor), ``kernel`` where the kernel
did.
"""

import torch

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.kernels import build

_INDEX_DTYPES = (torch.int32, torch.int64)


def gather_rows_plain(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_select`` of the index clamped to ``[0, cap - 1]``."""
    safe = torch.clamp(idx, 0, words.shape[0] - 1).to(torch.int64)
    return words.index_select(0, safe)


def _check(words: torch.Tensor, idx: torch.Tensor) -> None:
    if words.dim() != 2 or words.dtype != torch.int32:
        raise TypeError("gather_rows: words must be a [cap, w] int32 "
                        f"matrix, got {words.dtype} of {words.dim()} dims")
    if not words.is_contiguous():
        raise ValueError("gather_rows: the word matrix must be contiguous")
    if idx.dim() != 1 or idx.dtype not in _INDEX_DTYPES:
        raise TypeError("gather_rows: the index must be 1-D int32 or int64, "
                        f"got {idx.dtype} of {idx.dim()} dims")
    if idx.device != words.device:
        raise ValueError("gather_rows: operands lie on several devices")
    if words.shape[0] == 0 and idx.shape[0]:
        raise ValueError("gather_rows: no row to gather from")


def gather_rows(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[n, w]`` int32: row i is ``words[clamp(idx[i], 0, cap - 1)]``.

    ``words`` is a contiguous ``[cap, w]`` int32 matrix (a matrix of
    8-byte values enters as its int32 view), ``idx`` a 1-D int32 or int64
    index. A CPU tensor takes :func:`gather_rows_plain`; a CUDA tensor
    launches the kernel or raises."""
    _check(words, idx)
    n = idx.shape[0]
    if words.device.type == "cpu":
        telemetry.counter("gather.rows", route="plain").inc(n)
        return gather_rows_plain(words, idx)
    if words.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {words.device}")
    telemetry.counter("gather.rows", route="kernel").inc(n)
    cap, w = words.shape
    out = torch.empty((n, w), dtype=torch.int32, device=words.device)
    if n == 0 or w == 0:
        return out
    idx = idx.contiguous()
    err = build.library().cylon_gather_rows(
        words.data_ptr(), cap, w, idx.data_ptr(), idx.element_size(), n,
        out.data_ptr(), build.stream_of(out))
    build.check(err, "gather_rows")
    build.count(gather_rows)
    return out


gather_rows.launches = 0
gather_rows.plain = gather_rows_plain
gather_rows.source = "cylon_tpu_torch/csrc/gather.cu"
gather_rows.replaces = "none: the JAX package gathers rows with jnp.take"
