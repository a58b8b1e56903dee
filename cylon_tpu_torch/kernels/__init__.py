"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it counts launches in
``wrapper.launches`` (:func:`~cylon_tpu_torch.kernels.build.count`; a
thread capturing a CUDA graph tallies its own apart, and the replays
count them) and names its plain version in ``wrapper.plain``.
"""

from cylon_tpu_torch.kernels.bucket import bucket_build, bucket_probe
from cylon_tpu_torch.kernels.gather import gather_rows
from cylon_tpu_torch.kernels.row_hash import row_hash
from cylon_tpu_torch.kernels.scan import (SCAN_MIN_SIZE, pair_max_scan,
                                          scan32, scan32_ok)

#: every kernel wrapper of the package
WRAPPERS = (row_hash, scan32, pair_max_scan, bucket_build, bucket_probe,
            gather_rows)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["SCAN_MIN_SIZE", "WRAPPERS", "bucket_build", "bucket_probe",
           "gather_rows", "launch_counts", "pair_max_scan", "reset_launches",
           "row_hash", "scan32", "scan32_ok"]
