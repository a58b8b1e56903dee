"""Pandas-style indexing over device tables.

Port of ``cylon_tpu/indexing`` (parity: ``cpp/src/cylon/indexing/``:
``IndexingType`` and the ``BaseArrowIndex`` family,
``indexing/index.hpp:36-42,108-425``; the loc/iloc indexers,
``indexing/indexer.hpp:76,123``). The reference's hash maps become, as
in the JAX package:

- :class:`RangeIndex`: positional, no storage (``ArrowRangeIndex``);
- :class:`LinearIndex`: a full-column compare a probe batch
  (``ArrowLinearIndex``);
- :class:`HashIndex`: a stable sort of the key column probed with
  ``searchsorted`` (``ArrowNumericHashIndex`` / ``ArrowBinaryHashIndex``).

An index is built on a local (gathered) frame: ``DataFrame.set_index``
on a distributed frame gathers it first, a collective.
"""

from cylon_tpu_torch.indexing.index import (BaseIndex, HashIndex,
                                            IndexingType, LinearIndex,
                                            RangeIndex, build_index)
from cylon_tpu_torch.indexing.indexer import ILocIndexer, LocIndexer

__all__ = ["BaseIndex", "HashIndex", "ILocIndexer", "IndexingType",
           "LinearIndex", "LocIndexer", "RangeIndex", "build_index"]
