"""Default device resolution (the port's counterpart of
``cylon_tpu/platform.py``).

Entry points run on CUDA unless the caller asks for the CPU: ``device=None``
means ``"cuda"``, and without a CUDA device that is an error, never a quiet
drop to the CPU. Operators follow their inputs' device.
"""

import numpy as np
import torch

from cylon_tpu_torch.errors import DeviceUnavailable


def resolve(device=None) -> torch.device:
    """``None`` -> the CUDA device; anything else -> ``torch.device``.
    Raises :class:`DeviceUnavailable` for CUDA without a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "cylon_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A host scalar as a 0-d tensor of ``dtype`` on ``device``, made by
    a fill on the device (no host-to-device copy, so it captures into a
    CUDA graph). A float past the dtype's range becomes an infinity, as
    ``torch.tensor`` makes it."""
    import math

    v = np.asarray(value).item()
    if dtype.is_floating_point and isinstance(v, (int, float)) and \
            math.isfinite(v) and abs(v) > torch.finfo(dtype).max:
        v = math.copysign(math.inf, v)
    return torch.full((), v, dtype=dtype, device=device)


def from_host(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a contiguous tensor on ``device`` (in ``dtype``,
    default the array's), with unit strides even when it has no
    elements: ``torch.from_numpy`` gives an empty array stride 0, which
    ``.contiguous()`` keeps and a ``.view`` to another element size
    refuses."""
    t = torch.from_numpy(arr)
    if t.numel() == 0:
        t = torch.empty(t.shape, dtype=t.dtype)
    return t.to(device=device, dtype=dtype)
