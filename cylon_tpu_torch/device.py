"""Default device resolution (the port's counterpart of
``cylon_tpu/platform.py``).

Entry points run on CUDA unless the caller asks for the CPU: ``device=None``
means ``"cuda"``, and without a CUDA device that is an error, never a quiet
drop to the CPU. Operators follow their inputs' device.
"""

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
