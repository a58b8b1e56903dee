"""cylon_tpu_torch.serve — the serving layer's durable spine and its
versioned result cache (port of ``cylon_tpu/serve``, in part).

Ported so far (ROADMAP A7.3): :mod:`.durability` — the write-ahead
:class:`RequestJournal`, the multi-engine :class:`JournalLock` and
:func:`fence_journal`, and the :class:`CatalogSnapshot` of the resident
tables — and :mod:`.result_cache`, keyed on the catalog's table
versions. The always-on engine itself (``ServeEngine``, admission, SLOs,
sessions, introspection and the fleet) comes with ROADMAP A8.2.
"""

from cylon_tpu_torch.serve.durability import (CatalogSnapshot, JournalLock,
                                              RequestJournal, fence_journal)

__all__ = ["CatalogSnapshot", "JournalLock", "RequestJournal",
           "fence_journal"]
