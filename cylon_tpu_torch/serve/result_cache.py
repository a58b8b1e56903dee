"""Versioned result cache: serve a hot query once per table version.

Port of ``cylon_tpu/serve/result_cache.py`` on the port's catalog and
telemetry; a cached value's size counts torch tensors and port tables.

The serving layer's second dedup level (the first is
:func:`cylon_tpu_torch.plan.shared_compiled`, which dedupes the *trace*):
completed results are stored under ``(query fingerprint, table-version
vector)`` and served straight from admission — a hot query never
touches the scheduler, the card, or the breaker again until one of its
tables mutates.

**Keying is the whole contract.** The fingerprint
(:func:`cylon_tpu_torch.plan.query_fingerprint`) identifies *what* was asked;
the version vector — a sorted tuple of ``(table_id, generation,
content digest)`` from :func:`cylon_tpu_torch.catalog.table_version` —
identifies *which data* answered it. Both halves are REQUIRED
positional arguments of :meth:`ResultCache.lookup` /
:meth:`ResultCache.store`, and a bench-guard AST lint walks every call
site in the tree asserting the vector is actually passed: a lookup
keyed on the fingerprint alone would happily serve pre-append bytes
after an append, which is exactly the staleness bug this keying
exists to make unrepresentable. A query with NO declared tables has no
version vector (``versions=None``) and is therefore uncacheable by
construction — lookups miss, stores are dropped.

**Invalidation is precise, not temporal.** Entries are indexed by the
table ids in their vector; :meth:`invalidate_table` — wired to
:func:`cylon_tpu_torch.catalog.on_append` by the engine (and to the
``append`` event stream by the fleet router) — evicts exactly the
entries that read the mutated table. There is no TTL: an entry is
correct until its inputs change, and wrong immediately after.

**Bounded.** Byte-budgeted LRU
(:data:`cylon_tpu_torch.serve.service.RESULT_CACHE_BYTES` engine-side,
``CYLON_TPU_FLEET_RESULT_CACHE_BYTES`` router-side; ``0`` disables). Counters ride telemetry as
``{prefix}.result_cache_{hits,misses,invalidations,evictions}``.
"""

import collections
import os
import sys
import threading

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import InvalidArgument, KeyError_

__all__ = ["ResultCache", "DEFAULT_CACHE_BYTES", "cache_bytes_from_env",
           "hook_on_append", "value_nbytes", "version_vector"]

#: default byte budget for a result cache (generous for scalar/frame
#: TPC-H answers; bound the hoard, not the hit rate)
DEFAULT_CACHE_BYTES = 256 * 2**20


def cache_bytes_from_env(var: str) -> int:
    """Read a cache byte budget from ``var`` (defensive parse — a
    malformed value falls back to the default rather than failing an
    engine construction). ``0``/negative disables the cache."""
    try:
        return int(os.environ.get(var, str(DEFAULT_CACHE_BYTES)))
    except ValueError:
        return DEFAULT_CACHE_BYTES


def version_vector(table_ids) -> "tuple | None":
    """The version half of the cache key: a SORTED tuple of
    ``(table_id, generation, digest)`` over ``table_ids``, from
    :func:`cylon_tpu_torch.catalog.table_version`. None — uncacheable —
    when no tables are declared or any of them is not resident (a
    request whose read set the engine cannot version must never be
    deduped).

    (``cylon_tpu/serve/result_cache.py`` ``version_vector``)"""
    from cylon_tpu_torch import catalog

    ids = sorted(set(str(t) for t in table_ids or ()))
    if not ids:
        return None
    vec = []
    try:
        for tid in ids:
            v = catalog.table_version(tid)
            vec.append((tid, int(v["generation"]), str(v["digest"])))
    except (KeyError_, InvalidArgument):
        return None
    return tuple(vec)


def value_nbytes(value) -> int:
    """Byte-size estimate of a cached result: device buffer bytes for
    Tables/DataFrames, ``numel() * element_size()`` for torch tensors,
    ``.nbytes`` for arrays, recursive for containers,
    ``sys.getsizeof`` otherwise. An estimate is enough — the budget
    bounds the hoard, it is not an allocator.

    (``cylon_tpu/serve/result_cache.py`` ``value_nbytes``)"""
    import torch

    from cylon_tpu_torch import catalog as _catalog
    from cylon_tpu_torch.table import Table

    t = getattr(value, "table", value)
    if isinstance(t, Table):
        return _catalog.table_nbytes(t)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (str, bytes, bytearray)):
        return len(value)
    if isinstance(value, dict):
        return sum(value_nbytes(k) + value_nbytes(v)
                   for k, v in value.items()) + 64
    if isinstance(value, (list, tuple, set, frozenset)):
        return sum(value_nbytes(v) for v in value) + 64
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, int):
        return nb
    try:
        return sys.getsizeof(value)
    except TypeError:  # pragma: no cover - exotic __sizeof__
        return 64


class ResultCache:
    """Byte-budgeted, version-keyed LRU of completed query results.

    Thread-safe; shared by client threads (admission-time lookups) and
    the scheduler thread (stores at retirement) on the engine, and by
    submitter + poller threads on the fleet router.

    (``cylon_tpu/serve/result_cache.py`` ``ResultCache``)"""

    def __init__(self, max_bytes: int, *, metric_prefix: str = "serve"):
        self.max_bytes = int(max_bytes)
        self._prefix = str(metric_prefix)
        self._mu = threading.Lock()
        #: (fingerprint, versions) -> (value, nbytes), LRU order
        self._entries: "collections.OrderedDict" = \
            collections.OrderedDict()
        #: table_id -> set of keys whose vector reads it (the precise
        #: invalidation index on_append drives)
        self._by_table: "dict[str, set]" = {}
        self._bytes = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    # ------------------------------------------------------------ read
    def lookup(self, fingerprint, versions):
        """``(hit, value)`` for ``(fingerprint, versions)`` — BOTH key
        halves are required (the bench-guard AST lint pins that every
        call site passes the version vector; see module docstring). A
        None fingerprint or None vector is uncacheable: always a
        miss."""
        if (not self.enabled or fingerprint is None
                or versions is None):
            telemetry.counter(
                f"{self._prefix}.result_cache_misses").inc()
            return False, None
        key = (fingerprint, tuple(versions))
        with self._mu:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
        if ent is None:
            telemetry.counter(
                f"{self._prefix}.result_cache_misses").inc()
            return False, None
        telemetry.counter(f"{self._prefix}.result_cache_hits").inc()
        return True, ent[0]

    # ----------------------------------------------------------- write
    def store(self, fingerprint, versions, value,
              nbytes: "int | None" = None) -> bool:
        """Insert a completed result under ``(fingerprint, versions)``
        — both halves required, same lint as :meth:`lookup`. Returns
        False (dropped) for uncacheable keys or a value larger than
        the whole budget."""
        if (not self.enabled or fingerprint is None
                or versions is None):
            return False
        if nbytes is None:
            nbytes = value_nbytes(value)
        nbytes = max(int(nbytes), 1)
        if nbytes > self.max_bytes:
            return False
        key = (fingerprint, tuple(versions))
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            for tid, _gen, _dig in key[1]:
                self._by_table.setdefault(str(tid), set()).add(key)
            while self._bytes > self.max_bytes and self._entries:
                self._evict_lru_locked()
        return True

    def _evict_lru_locked(self) -> None:
        key, (_, nb) = self._entries.popitem(last=False)
        self._bytes -= nb
        self._unindex_locked(key)
        telemetry.counter(
            f"{self._prefix}.result_cache_evictions").inc()

    def _unindex_locked(self, key) -> None:
        for tid, _gen, _dig in key[1]:
            keys = self._by_table.get(str(tid))
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_table[str(tid)]

    # ---------------------------------------------------- invalidation
    def invalidate_table(self, table_id: str) -> int:
        """Evict every entry whose version vector reads ``table_id`` —
        the :func:`catalog.on_append` hook target. Precise: entries
        over other tables are untouched. Returns the eviction count."""
        table_id = str(table_id)
        with self._mu:
            keys = self._by_table.pop(table_id, None)
            if not keys:
                return 0
            n = 0
            for key in keys:
                ent = self._entries.pop(key, None)
                if ent is None:
                    continue
                self._bytes -= ent[1]
                self._unindex_locked(key)
                n += 1
        if n:
            telemetry.counter(
                f"{self._prefix}.result_cache_invalidations").inc(n)
        return n

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._by_table.clear()
            self._bytes = 0

    # ------------------------------------------------------- reporting
    def stats(self) -> dict:
        with self._mu:
            return {"entries": len(self._entries),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes}

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)


# ------------------------------------------------- append-hook wiring
#: live caches wired to the catalog append stream — weakly held, so a
#: closed engine's cache is collectable without an unhook protocol
_LIVE: "weakref.WeakSet" = None  # type: ignore[assignment]
_HOOK_MU = threading.Lock()
_HOOKED = False


def _on_append(table_id: str, generation: int) -> None:
    for cache in list(_LIVE or ()):
        cache.invalidate_table(table_id)


def hook_on_append(cache: ResultCache) -> ResultCache:
    """Wire ``cache`` to :func:`cylon_tpu_torch.catalog.on_append` so every
    append invalidates exactly the entries that read the mutated table.
    One catalog listener is registered process-wide (listeners cannot
    be removed); caches are tracked weakly. Returns ``cache`` so the
    call composes inline at construction.

    (``cylon_tpu/serve/result_cache.py`` ``hook_on_append``)"""
    global _LIVE, _HOOKED
    import weakref

    from cylon_tpu_torch import catalog

    with _HOOK_MU:
        if _LIVE is None:
            _LIVE = weakref.WeakSet()
        _LIVE.add(cache)
        if not _HOOKED:
            catalog.on_append(_on_append)
            _HOOKED = True
    return cache
