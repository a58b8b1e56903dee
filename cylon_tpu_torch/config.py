"""Typed option structs.

The port's copy of the structs of ``cylon_tpu/config.py`` that the
frame and io layers honour (parity targets:
``cpp/src/cylon/join/join_config.hpp:25-197``,
``cpp/src/cylon/io/csv_read_config.hpp:28-152``, ``csv_write_config.hpp``
and ``parquet_config.hpp``), and the knobs of the resilience and
deadline layers (``cylon_tpu/config.py:77-150``: :class:`RetryPolicy`,
:data:`DEADLINE_SECTIONS`, :class:`DeadlinePolicy`). ``SortOptions``
lives with ``dist_sort`` (:mod:`cylon_tpu_torch.parallel.dist_ops`) and
is re-exported here.
"""

import dataclasses
import enum
from typing import Sequence

from cylon_tpu_torch.parallel.dist_ops import SortOptions

__all__ = ["CSVReadOptions", "CSVWriteOptions", "DEADLINE_SECTIONS",
           "DeadlinePolicy", "JoinAlgorithm", "JoinConfig", "JoinType",
           "ParquetOptions", "RetryPolicy", "SortOptions"]


class JoinType(enum.Enum):
    """Parity: ``join_config.hpp`` JoinType {INNER, LEFT, RIGHT, FULL_OUTER}
    (``cylon_tpu/config.py:14``)."""

    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL_OUTER = "fullouter"


class JoinAlgorithm(enum.Enum):
    """Parity: ``join_config.hpp`` JoinAlgorithm {SORT, HASH}
    (``cylon_tpu/config.py:23``). Both are exact and give the same row
    set; ``HASH`` groups by hash first, or runs the bucketed build/probe
    under ``CYLON_TPU_JOIN_HASH_IMPL=bucketed``."""

    SORT = "sort"
    HASH = "hash"


def _hash_fields(obj) -> int:
    """Hash of a frozen dataclass whose fields may be lists or dicts."""
    def h(v):
        if isinstance(v, dict):
            return tuple(sorted((k, str(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return v

    return hash(tuple(h(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)))


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Parity: ``join_config.hpp:42-197`` (``cylon_tpu/config.py:38``)."""

    join_type: JoinType = JoinType.INNER
    algorithm: JoinAlgorithm = JoinAlgorithm.SORT
    left_on: Sequence[str] = ()
    right_on: Sequence[str] = ()
    left_suffix: str = "_x"
    right_suffix: str = "_y"

    @staticmethod
    def make(join_type="inner", algorithm="sort", left_on=(), right_on=(),
             suffixes=("_x", "_y")) -> "JoinConfig":
        jt = join_type if isinstance(join_type, JoinType) \
            else JoinType(join_type)
        alg = algorithm if isinstance(algorithm, JoinAlgorithm) \
            else JoinAlgorithm(algorithm)
        return JoinConfig(jt, alg, tuple(left_on), tuple(right_on),
                          suffixes[0], suffixes[1])


@dataclasses.dataclass(frozen=True)
class CSVReadOptions:
    """Parity: ``io/csv_read_config.hpp:28-152`` (``cylon_tpu/config.py:151``):
    every builder method is a field. The port reads with pyarrow only
    (the native engine waits for its host library)."""

    use_threads: bool = True
    delimiter: str = ","
    ignore_emptylines: bool = True
    block_size: int = 1 << 22
    use_cols: "Sequence[str] | None" = None
    skip_rows: int = 0
    column_names: "Sequence[str] | None" = None
    slice: bool = False  # distributed read: each rank keeps its block
    concurrent_file_reads: bool = True
    auto_generate_column_names: bool = False
    use_quoting: bool = True
    quote_char: str = '"'
    double_quote: bool = True
    use_escaping: bool = False
    escaping_character: str = "\\"
    has_newlines_in_values: bool = False
    na_values: "Sequence[str] | None" = None
    true_values: "Sequence[str] | None" = None
    false_values: "Sequence[str] | None" = None
    strings_can_be_null: bool = False
    #: explicit per-column dtypes: {name: "int64" | "float64" | "str" |
    #: numpy dtype-like}
    column_types: "dict | None" = None
    include_missing_columns: bool = False

    __hash__ = _hash_fields


@dataclasses.dataclass(frozen=True)
class CSVWriteOptions:
    """Parity: ``io/csv_write_config.hpp`` (``cylon_tpu/config.py:206``)."""

    delimiter: str = ","
    include_header: bool = True


@dataclasses.dataclass(frozen=True)
class ParquetOptions:
    """Parity: ``io/parquet_config.hpp`` (``cylon_tpu/config.py:214``):
    ``concurrent_file_reads`` and ``use_cols`` on read; compression,
    row-group size, dictionary encoding and a column subset on write."""

    concurrent_file_reads: bool = True
    use_cols: "Sequence[str] | None" = None
    compression: str = "snappy"
    row_group_size: "int | None" = None
    use_dictionary: bool = True
    write_cols: "Sequence[str] | None" = None

    __hash__ = _hash_fields


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs of the retry engine (:func:`cylon_tpu_torch.resilience.retrying`).
    Delays follow ``min(base_delay * multiplier**k, max_delay)`` with a
    deterministic jitter drawn from ``seed``, so two processes with the
    same policy back off identically and failure traces replay exactly.
    The process default is this struct's defaults
    (:func:`cylon_tpu_torch.resilience.default_policy`)."""

    max_attempts: int = 3      # total attempts, including the first
    base_delay: float = 0.05   # seconds before the first retry
    max_delay: float = 2.0     # backoff ceiling (pre-jitter)
    multiplier: float = 2.0    # exponential growth per retry
    jitter: float = 0.1        # +- fraction, deterministic from seed
    seed: int = 0


#: Default deadline budget (seconds) of each named blocking section of
#: the watchdog (:mod:`cylon_tpu_torch.watchdog`); ``None`` is unbounded.
#: ``CYLON_TPU_DEADLINE_<SECTION>`` overrides one per call (``0`` or
#: less clears it back to unbounded).
DEADLINE_SECTIONS: "dict[str, float | None]" = {
    "barrier": None,         # CylonEnv.barrier
    "bootstrap": None,       # the process group's init
    "overflow_fetch": None,  # CompiledQuery's one device->host transfer
    "spill_io": None,        # SpillStore bucket write/read
    "ooc_pass": None,        # out-of-core join/groupby/sort passes
    "ooc_prefetch": None,    # one pipelined-ingest unit (pipeline)
    "exchange": None,        # shuffle/repartition/dist_join
    "fallback_merge": None,  # the two-phase fallback's global merge
}


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy:
    """Knobs of the watchdog (:mod:`cylon_tpu_torch.watchdog`): when a
    section stalls past its budget, the monitor thread dumps all-thread
    stacks to stderr (``dump_stacks``) and then either lets the section
    raise :class:`~cylon_tpu_torch.errors.DeadlineExceeded`
    (``action="raise"``) or ends the process (``"abort"``, exit 70).
    ``poll_interval`` is the monitor's re-scan cadence while a dumped
    section is still stalled. The process default is
    :data:`cylon_tpu_torch.watchdog.DEADLINE_POLICY`."""

    poll_interval: float = 0.05
    action: str = "raise"        # "raise" | "abort" (os._exit(70))
    dump_stacks: bool = True     # all-thread stacks to stderr on stall
