"""Typed option structs.

The port's copy of the structs of ``cylon_tpu/config.py`` that the
frame and io layers honour (parity targets:
``cpp/src/cylon/join/join_config.hpp:25-197``,
``cpp/src/cylon/io/csv_read_config.hpp:28-152``, ``csv_write_config.hpp``
and ``parquet_config.hpp``). ``SortOptions`` lives with ``dist_sort``
(:mod:`cylon_tpu_torch.parallel.dist_ops`) and is re-exported here.
"""

import dataclasses
import enum
from typing import Sequence

from cylon_tpu_torch.parallel.dist_ops import SortOptions

__all__ = ["CSVReadOptions", "CSVWriteOptions", "JoinAlgorithm",
           "JoinConfig", "JoinType", "ParquetOptions", "SortOptions"]


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
