"""Incremental materialized views over appendable catalog tables.

Port of ``cylon_tpu/views``.

The package has two layers: :mod:`cylon_tpu_torch.views.combiners` (the
pure delta-merge algebra lifted from the fallback layer's partial
combiners) and :mod:`cylon_tpu_torch.views.materialized` (the registry:
named views with resident state, generation watermarks, checkpointable
incremental refresh, and generation-consistent reads). See
``docs/views.md`` for the refresh semantics and exactness contract.
"""

from cylon_tpu_torch.views.combiners import (  # noqa: F401
    TWOPHASE_COMBINE_BY, combine_partials, finalize_twophase,
    merge_delta, present,
)
from cylon_tpu_torch.views.materialized import (  # noqa: F401
    MaterializedView, clear, drop_view, list_views, read,
    refresh, register_view, stats, view_version,
)

__all__ = [
    "TWOPHASE_COMBINE_BY", "combine_partials", "finalize_twophase",
    "merge_delta", "present",
    "MaterializedView", "clear", "drop_view", "list_views", "read",
    "refresh", "register_view", "stats", "view_version",
]
