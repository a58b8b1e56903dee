"""Runtime utilities: logging, op tracing/profiling and the capacity
bucket (port of ``cylon_tpu/utils/``; the port never imports the JAX
package).

Reference analog: ``cpp/src/cylon/util/`` (logging.{hpp,cpp} glog wrap,
macros) plus the inline ``std::chrono`` op timing at table boundaries
(``table.cpp:167-177``).
"""

from cylon_tpu_torch.utils.logging import (disable_logging, get_logger,
                                           init_logging, log_level)
from cylon_tpu_torch.utils.tracing import (profile_to, report,
                                           reset_timings, span, timings,
                                           traced)


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(n, minimum)."""
    return max(int(minimum), 1 << max(int(n) - 1, 0).bit_length())


__all__ = [
    "disable_logging", "get_logger", "init_logging", "log_level",
    "pow2_bucket",
    "profile_to", "report", "reset_timings", "span", "timings", "traced",
]
