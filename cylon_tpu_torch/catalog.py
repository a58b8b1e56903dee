"""String-id table catalog + id-keyed operation mirror.

Port of ``cylon_tpu/catalog.py`` (parity: ``cpp/src/cylon/table_api.{hpp,
cpp}``): a process-global registry mapping string ids to tables
(``PutTable/GetTable/RemoveTable``, ``table_api.hpp:38-90``) with every
relational op mirrored on ids (``JoinTables(ctx, "left", "right",
...)``). It is the **resident-table store** the serving modules stand on:
tables register once, concurrent queries :func:`pin` them for their
lifetime (refcounted per holder), :func:`drop` refuses pinned tables
with a :class:`~cylon_tpu_torch.errors.FailedPrecondition` naming the
holders, and :func:`stats` reports per-table rows/bytes/pins.

Resident tables are **appendable and versioned**: :func:`append` folds a
host delta frame into a registered table under an ATOMIC swap (a
concurrent reader holds the old :class:`~cylon_tpu_torch.table.Table`
object and never observes a half-applied delta), every mutation bumps a
**monotone generation number**, and :func:`table_version` exposes
``{generation, digest}`` where the digest is the content fingerprint the
fallback layer uses to guard broadcast inputs
(:func:`cylon_tpu_torch.fallback._cols_fingerprint`, byte for byte the
JAX package's, so the same content digests identically in both).
Appended deltas are retained in a bounded per-table log
(:func:`deltas_since`) so a materialized view can refresh from exactly
the rows it has not applied yet; a watermark older than the retention
window answers ``None`` (full recompute), never a silently truncated
delta.

**Shards.** The JAX catalog serves one controller, and a distributed
table there is one mesh-sharded ``Table``. In the port every rank holds
its own shard, and ``ThreadWorld`` ranks share one process. So an entry
is a *slot* ``(table id, rank)``: ``rank`` is None for a local table,
and a call with ``env=`` that writes a table (``put_table(...,
env=env)``, an id op with ``env=``) writes this rank's shard, recorded
as a shard of a world of ``env.world_size``. That record is what
:func:`stats` (``distributed``), the digest and :func:`append` read in
place of the JAX package's ``dtable.is_distributed``. A call with
``env=`` that reads finds this rank's shard, else the local table of
that id; a call without ``env=`` finds the local table (a sharded id
needs ``env=``), except :func:`stats` and :func:`drop`, which take every
slot of the id this process holds.
"""

import collections
import contextlib
import threading
from typing import Mapping, Sequence

from cylon_tpu_torch.config import JoinConfig
from cylon_tpu_torch.errors import (FailedPrecondition, InvalidArgument,
                                    KeyError_)
from cylon_tpu_torch.table import Table

_lock = threading.Lock()


class _Entry:
    """One slot's table and, for a shard, its world's size (None for a
    local table)."""

    __slots__ = ("table", "world")

    def __init__(self, table: Table, world: "int | None"):
        self.table = table
        self.world = world


#: (table id, rank or None) -> _Entry
_catalog: "dict[tuple, _Entry]" = {}
#: slot -> Counter of holder labels (pin refcounts). A pinned table
#: cannot be dropped: the serving layer pins every resident table a
#: request reads for the request's lifetime, so a concurrent ``drop``
#: fails loudly at the drop site (naming the holders) instead of as a
#: confusing late KeyError inside whichever query lost the race.
_pins: "dict[tuple, collections.Counter]" = {}
#: slot -> {"generation": int, "digest": str | None}. Every
#: registration/append bumps the monotone generation; the content
#: digest is computed LAZILY (first :func:`table_version` call per
#: generation) because it hashes the table's host bytes.
_versions: "dict[tuple, dict]" = {}
#: slot -> [(generation, host pandas delta frame)] — the bounded delta
#: log :func:`deltas_since` serves incremental view refreshes from
#: (newest ``CYLON_TPU_CATALOG_DELTA_KEEP`` appends retained).
_deltas: "dict[tuple, list]" = {}
#: append listeners: ``cb(table_id, generation)`` after every
#: successful append — how the views layer invalidates result memos
#: keyed on the now-stale version without catalog importing views.
_append_listeners: list = []
#: slot -> mutex serializing whole append operations on that slot (host
#: gather + concat + swap; the swap itself still happens under
#: ``_lock``). One mutex per slot, not one for the process: the ranks
#: of a ThreadWorld append to their shards collectively, and a rank
#: holding a process-wide mutex through the gather would wait forever
#: for a peer blocked on that mutex.
_append_mus: "dict[tuple, threading.Lock]" = {}

DEFAULT_DELTA_KEEP = 64


def _rank(env) -> "int | None":
    return None if env is None else int(env.rank)


def _slots_locked(table_id: str) -> list:
    return [k for k in _catalog if k[0] == table_id]


def _find_locked(table_id: str, env) -> tuple:
    """The slot a call with (or without) ``env`` addresses: this rank's
    shard, else the local table. Caller holds ``_lock``."""
    if env is not None and (table_id, int(env.rank)) in _catalog:
        return (table_id, int(env.rank))
    if (table_id, None) in _catalog:
        return (table_id, None)
    shards = _slots_locked(table_id)
    if shards:
        world = _catalog[shards[0]].world
        raise InvalidArgument(
            f"table {table_id!r} is held as shards of a world of {world}"
            + ("" if env is None else f", none of them rank {env.rank}'s")
            + ": pass the env of the world that wrote it")
    raise KeyError_(f"no table registered under {table_id!r}")


def put_table(table_id: str, table: Table, *, env=None) -> None:
    """Parity: ``PutTable`` (table_api.hpp:38). Re-registering an id is
    an overwrite — but not while the old table is pinned (an in-flight
    reader must never see its input swapped underneath it). With
    ``env`` the table is this rank's shard of ``table_id``: it replaces
    the local table of that id and the shards of another world, never a
    peer's shard.

    (``cylon_tpu/catalog.py`` ``put_table``)"""
    if not isinstance(table, Table):
        raise InvalidArgument(f"not a Table: {type(table)}")
    key = (table_id, _rank(env))
    world = None if env is None else int(env.world_size)
    with _lock:
        replaced = [k for k in _slots_locked(table_id)
                    if k == key or (env is None) != (k[1] is None)
                    or (k[1] is not None and _catalog[k].world != world)]
        for k in replaced:
            _require_unpinned(k, "overwrite")
        floor = max((int(_versions[k]["generation"]) for k in replaced
                     if k in _versions), default=0)
        for k in replaced:
            _forget_locked(k)
        _catalog[key] = _Entry(table, world)
        _versions[key] = {"generation": floor + 1, "digest": None}
        # a full overwrite restarts delta history: nothing in the old
        # log describes the new content, so views must full-recompute


def _forget_locked(key: tuple) -> None:
    _catalog.pop(key, None)
    _versions.pop(key, None)
    _deltas.pop(key, None)


def _bump_version_locked(key: tuple) -> int:
    """Advance a slot's monotone generation (digest recomputes lazily).
    Caller holds ``_lock``. Returns the new generation."""
    ent = _versions.get(key)
    gen = (int(ent["generation"]) + 1) if ent else 1
    _versions[key] = {"generation": gen, "digest": None}
    return gen


def get_table(table_id: str, pin_for: "str | None" = None, *,
              env=None) -> Table:
    """Parity: ``GetTable``. ``pin_for=holder`` additionally pins the
    table under ``holder`` in the same lock hold — the atomic
    lookup-and-pin a concurrent reader needs (a separate get + pin
    could lose a drop race in between). With ``env``: this rank's
    shard, else the local table.

    (``cylon_tpu/catalog.py`` ``get_table``)"""
    with _lock:
        key = _find_locked(table_id, env)
        if pin_for is not None:
            _pins.setdefault(key, collections.Counter())[str(pin_for)] += 1
        return _catalog[key].table


def is_shard(table_id: str, env=None) -> bool:
    """Does the slot ``env`` addresses hold a rank's shard (the record
    that stands in for the JAX package's ``dtable.is_distributed``)?"""
    with _lock:
        return _catalog[_find_locked(table_id, env)].world is not None


def holds_shard(table: Table) -> bool:
    """Is this very table object registered as a rank's shard? The
    shard record a caller holding only the table reads (EXPLAIN's
    ``distributed``); False for a local or an unregistered table."""
    with _lock:
        return any(ent.table is table and ent.world is not None
                   for ent in _catalog.values())


def _require_unpinned(key: tuple, verb: str) -> None:
    holders = _pins.get(key)
    if holders:
        names = sorted(holders)
        raise FailedPrecondition(
            f"cannot {verb} table {key[0]!r}: pinned by "
            f"{sum(holders.values())} holder(s) {names}; drop waits "
            "until every holder unpins")


def pin(table_id: str, holder: str = "anonymous", *, env=None) -> None:
    """Refcount ``table_id`` under ``holder`` so :func:`drop` refuses
    it. Pins nest (one count per call); unpin with the same holder.

    (``cylon_tpu/catalog.py`` ``pin``)"""
    with _lock:
        key = _find_locked(table_id, env)
        _pins.setdefault(key, collections.Counter())[str(holder)] += 1


def unpin(table_id: str, holder: str = "anonymous", *, env=None) -> None:
    """Release one pin held by ``holder`` (unknown pins raise — an
    unbalanced unpin is a refcount bug, not a no-op)."""
    with _lock:
        try:
            key = _find_locked(table_id, env)
        except KeyError_:
            key = (table_id, _rank(env))
        holders = _pins.get(key)
        if not holders or holders[str(holder)] <= 0:
            raise InvalidArgument(
                f"table {table_id!r} holds no pin for {holder!r}")
        holders[str(holder)] -= 1
        if holders[str(holder)] <= 0:
            del holders[str(holder)]
        if not holders:
            _pins.pop(key, None)


@contextlib.contextmanager
def pinned(table_id: str, holder: str = "anonymous", *, env=None):
    """``with catalog.pinned("lineitem", holder=req_id) as t:`` — the
    table, pinned for the scope."""
    t = get_table(table_id, pin_for=holder, env=env)
    try:
        yield t
    finally:
        unpin(table_id, holder, env=env)


def pins(table_id: str, *, env=None) -> "dict[str, int]":
    """Live pin counts per holder (empty when unpinned/unknown)."""
    with _lock:
        try:
            key = _find_locked(table_id, env)
        except (KeyError_, InvalidArgument):
            return {}
        return dict(_pins.get(key, ()))


def drop(table_id: str, *, if_exists: bool = True, env=None) -> None:
    """Remove ``table_id`` — unless pinned, in which case a
    :class:`~cylon_tpu_torch.errors.FailedPrecondition` NAMES the
    holders. With ``env``: this rank's shard (else the local table);
    without: every slot of the id this process holds.

    (``cylon_tpu/catalog.py`` ``drop``)"""
    with _lock:
        if env is None:
            keys = _slots_locked(table_id)
        else:
            try:
                keys = [_find_locked(table_id, env)]
            except KeyError_:
                keys = []
        if not keys:
            if if_exists:
                return
            raise KeyError_(f"no table registered under {table_id!r}")
        for k in keys:
            _require_unpinned(k, "drop")
        for k in keys:
            _forget_locked(k)


def remove_table(table_id: str, *, env=None) -> None:
    """Parity: ``RemoveTable`` — now pin-respecting (see :func:`drop`)."""
    drop(table_id, if_exists=True, env=env)


def list_tables() -> list[str]:
    with _lock:
        return sorted({k[0] for k in _catalog})


def table_nbytes(table: Table) -> int:
    """Device bytes held by ``table``'s buffers (data + validity),
    summed over columns as ``numel() * element_size()`` — no host sync
    (buffer shapes are static).

    (``cylon_tpu/catalog.py`` ``table_nbytes``)"""
    total = 0
    for c in table.columns.values():
        total += c.data.numel() * c.data.element_size()
        if c.validity is not None:
            total += c.validity.numel() * c.validity.element_size()
    return total


def table_device_nbytes(table: Table) -> "dict[str, int]":
    """Per-device byte split of ``table``'s buffers — ``{"cuda:0": n}``
    (``"cpu:0"`` for a table on the CPU), each storage once, through
    :func:`cylon_tpu_torch.telemetry.memory.accumulate_tensor_bytes`,
    the accounting the live-bytes walk uses, so the two cross-check.
    Metadata only: no sync, no transfer. A shard's split is its rank's
    device.

    (``cylon_tpu/catalog.py`` ``table_device_nbytes``)"""
    from cylon_tpu_torch.telemetry.memory import accumulate_tensor_bytes

    out: "dict[str, int]" = {}
    seen: set = set()
    for c in table.columns.values():
        accumulate_tensor_bytes(c.data, out, seen)
        if c.validity is not None:
            accumulate_tensor_bytes(c.validity, out, seen)
    return out


def _cached_version(key: tuple) -> dict:
    """The slot's generation and its digest as cached (``None`` until a
    read computes it): a dict read, no host fetch."""
    with _lock:
        v = _versions.get(key) or {"generation": 1, "digest": None}
    return {"generation": int(v["generation"]), "digest": v["digest"]}


def _slot_stats(key: tuple, ent: _Entry, holders: dict,
                version: bool) -> dict:
    t = ent.table
    try:
        rows = int(t.nrows)          # one host fetch of a 0-d tensor
    except Exception:
        rows = None
    try:
        ver = _version_of(key) if version else _cached_version(key)
    except Exception:
        # racing drop, or a table whose bytes are not host-reachable —
        # report the generation without a digest rather than failing
        ver = _cached_version(key)
    return {"rows": rows, "bytes": table_nbytes(t),
            "bytes_by_device": table_device_nbytes(t),
            "capacity": int(t.capacity), "columns": t.num_columns,
            "distributed": ent.world is not None,
            "pins": sum(holders.values()), "holders": sorted(holders),
            "version": ver}


def stats(*, env=None, version: bool = True) -> "dict[str, dict]":
    """Per-table catalog statistics: ``{id: {rows, bytes,
    bytes_by_device, capacity, columns, distributed, pins, holders,
    version}}`` — the resident-table inventory the serve layer reports
    (the JAX package's key set). With ``env`` each id reports the slot
    that rank addresses (its shard: ``rows`` is this rank's count);
    without, a sharded id sums the shards this process holds (a
    ``ThreadWorld``'s every rank, one rank's under a process group), its
    ``version`` that of the lowest rank held. ``rows`` is one host fetch
    of a 0-d tensor per slot; no collective runs. ``version=False``
    reports each digest as cached (``None`` where no read has computed
    it) in place of hashing the table on the host: what the OOM report
    reads, which must not fetch every resident table before a retry.

    (``cylon_tpu/catalog.py`` ``stats``)"""
    with _lock:
        items = list(_catalog.items())
        pin_view = {k: dict(v) for k, v in _pins.items()}
    by_id: "dict[str, list]" = {}
    for key, ent in items:
        by_id.setdefault(key[0], []).append((key, ent))
    out = {}
    for tid, slots in sorted(by_id.items()):
        if env is not None:
            mine = [s for s in slots if s[0][1] == int(env.rank)] or \
                [s for s in slots if s[0][1] is None]
        else:
            mine = [s for s in slots if s[0][1] is None] or \
                sorted(slots, key=lambda s: s[0][1])
        if not mine:
            continue
        parts = [_slot_stats(k, e, pin_view.get(k, {}), version)
                 for k, e in mine]
        st = parts[0]
        for p in parts[1:]:
            st["rows"] = None if st["rows"] is None or p["rows"] is None \
                else st["rows"] + p["rows"]
            st["bytes"] += p["bytes"]
            for dev, nb in p["bytes_by_device"].items():
                st["bytes_by_device"][dev] = \
                    st["bytes_by_device"].get(dev, 0) + nb
            st["capacity"] += p["capacity"]
            st["pins"] += p["pins"]
            st["holders"] = sorted(set(st["holders"]) | set(p["holders"]))
        out[tid] = st
    return out


def clear() -> None:
    """Drop everything, pins included (test/teardown hatch — the
    pin-respecting path is :func:`drop`)."""
    with _lock:
        _catalog.clear()
        _pins.clear()
        _versions.clear()
        _deltas.clear()
        _append_mus.clear()


# -------------------------------------------------- versioned appends
def _table_digest(table: Table, shard: "tuple | None" = None) -> str:
    """Content digest of a resident table — the SAME fingerprint the
    resumable fallback uses to guard changed broadcast inputs
    (:func:`cylon_tpu_torch.fallback._cols_fingerprint`) over the
    trimmed host content, so two tables with identical logical rows
    digest identically regardless of capacity padding, and a local
    table digests as the JAX package's does. A shard (``shard = (rank,
    world)``) hashes its rank's trimmed content plus its rank and world
    size (no collective runs here, and any append changes the shard,
    which is what versioning needs).

    (``cylon_tpu/catalog.py`` ``_table_digest``)"""
    import numpy as np

    from cylon_tpu_torch.fallback import _cols_fingerprint

    pdf = table.to_pandas()
    cols = {c: pdf[c].to_numpy() for c in pdf.columns}
    if shard is not None:
        cols["__rank__"] = np.asarray([shard[0]], np.int64)
        cols["__world__"] = np.asarray([shard[1]], np.int64)
    return _cols_fingerprint(cols)


def generation(table_id: str, *, env=None) -> int:
    """The table's monotone generation number — one cheap dict read,
    no digest computation.

    (``cylon_tpu/catalog.py`` ``generation``)"""
    with _lock:
        ent = _versions.get(_find_locked(table_id, env))
        return int(ent["generation"]) if ent else 1


def _version_of(key: tuple) -> dict:
    with _lock:
        if key not in _catalog:
            raise KeyError_(f"no table registered under {key[0]!r}")
        e = _catalog[key]
        ent = _versions.setdefault(key, {"generation": 1, "digest": None})
        gen, digest = int(ent["generation"]), ent["digest"]
    if digest is None:
        digest = _table_digest(
            e.table, None if e.world is None else (key[1], e.world))
        with _lock:
            cur = _versions.get(key)
            # only cache onto the generation we hashed — a racing
            # append's newer generation must not inherit a stale digest
            if cur is not None and int(cur["generation"]) == gen:
                cur["digest"] = digest
    return {"generation": gen, "digest": digest}


def table_version(table_id: str, *, env=None) -> dict:
    """``{"generation": int, "digest": str}`` for a resident table.
    The digest is computed lazily (one host fetch of the table and a
    sha256 of its bytes) and cached per generation — repeated calls
    between mutations are one dict read.

    (``cylon_tpu/catalog.py`` ``table_version``)"""
    with _lock:
        key = _find_locked(table_id, env)
    return _version_of(key)


def restore_version(table_id: str, gen: int, *, env=None) -> None:
    """Reinstate a table's generation after a snapshot restore
    (:meth:`cylon_tpu_torch.serve.CatalogSnapshot.restore`): the
    recovered process must serve the POST-append generation the
    snapshot was taken at, not restart at 1 and silently alias the
    pre-append version.

    (``cylon_tpu/catalog.py`` ``restore_version``)"""
    with _lock:
        key = _find_locked(table_id, env)
        _versions[key] = {"generation": max(int(gen), 1), "digest": None}


def _as_host_frame(delta):
    """Normalize an append delta (pandas frame, port DataFrame/Table,
    or a {col: array} mapping) to a host pandas frame."""
    import numpy as np
    import pandas as pd

    if isinstance(delta, pd.DataFrame):
        return delta.reset_index(drop=True)
    t = getattr(delta, "table", delta)
    if isinstance(t, Table):
        return t.to_pandas().reset_index(drop=True)
    if isinstance(delta, Mapping):
        return pd.DataFrame({k: np.asarray(v) for k, v in delta.items()})
    raise InvalidArgument(
        f"cannot append a {type(delta).__name__}: pass a pandas frame, "
        "a DataFrame/Table, or a column mapping")


def _delta_keep() -> int:
    import os

    try:
        return int(os.environ.get("CYLON_TPU_CATALOG_DELTA_KEEP",
                                  str(DEFAULT_DELTA_KEEP)))
    except ValueError:
        return DEFAULT_DELTA_KEEP


#: a non-string column whose host values came back as objects holds
#: integers or booleans with nulls: pandas' nullable type carries them
#: back with their validity
_NULLABLE = {"int8": "Int8", "int16": "Int16", "int32": "Int32",
             "int64": "Int64", "uint8": "UInt8", "bool": "boolean"}


def _schema_of(table: Table) -> "dict[str, str]":
    """How each column of ``table`` rebuilds from its host values:
    ``"bytes"`` or ``"dict"`` for a string column's storage, pandas'
    nullable type for an integer or boolean column (used only where the
    host values hold a null). JSON-serialisable: the catalog snapshot
    keeps it."""
    out = {}
    for name, c in table.columns.items():
        if c.dtype.is_bytes or c.dtype.is_dictionary:
            out[name] = "bytes" if c.dtype.is_bytes else "dict"
        elif str(c.data.dtype).split(".")[-1] in _NULLABLE:
            out[name] = _NULLABLE[str(c.data.dtype).split(".")[-1]]
    return out


def _build(frame, schema: dict, device) -> Table:
    """A host frame as a table on ``device`` under ``schema``
    (:func:`_schema_of`): each string column in its storage, integer
    and boolean columns whose host values hold nulls with their
    validity."""
    import pandas as pd

    storage, cols = {}, {}
    for name in frame.columns:
        kind, col = schema.get(name), frame[name]
        if kind in ("bytes", "dict"):
            storage[name] = kind
        elif kind is not None and col.dtype == object:
            col = pd.array(col.to_numpy(), dtype=kind)
        cols[name] = col
    return Table.from_pandas(pd.DataFrame(cols),
                             capacity=None if len(frame) else 1,
                             device=device, string_storage=storage)


def on_append(cb) -> None:
    """Register ``cb(table_id, generation)`` to run after every
    successful :func:`append` — the invalidation hook the views layer
    uses to evict memos keyed on the now-stale version, and how the
    versioned result caches drop exactly the cached results whose
    version vector names the appended table
    (:func:`cylon_tpu_torch.serve.result_cache.hook_on_append`).
    Callbacks run outside the catalog locks; exceptions are swallowed
    (an observer must never fail a mutation).

    (``cylon_tpu/catalog.py`` ``on_append``)"""
    _append_listeners.append(cb)


def append(table_id: str, delta, *, env=None) -> dict:
    """Fold ``delta`` rows into resident table ``table_id`` under an
    atomic swap, bumping its generation.

    Unlike :func:`put_table`'s overwrite, append is legal while the
    table is PINNED: an in-flight reader holds the old
    :class:`~cylon_tpu_torch.table.Table` object, which is immutable —
    it finishes against the generation it started on and never observes
    a half-applied delta. The swap publishes the merged table and the
    new generation in one ``_lock`` hold.

    ``delta`` may be a pandas frame, a DataFrame/Table, or a
    ``{col: array}`` mapping; its columns must match the resident
    schema. The merged table is built where the resident one lies,
    each string column in its storage. A shard needs ``env=`` and is
    collective: every rank passes the same delta, the world's shards
    gather (``dist_to_pandas``), the delta is concatenated, and the
    result scatters back (``scatter_table``). The host delta is
    retained in the bounded per-slot log (:func:`deltas_since`) for
    incremental view refresh. Returns ``{"generation", "delta_rows",
    "rows"}``.

    (``cylon_tpu/catalog.py`` ``append``)"""
    import pandas as pd

    from cylon_tpu_torch import telemetry
    from cylon_tpu_torch.telemetry import events as _events

    pdf = _as_host_frame(delta)
    with _lock:
        key = _find_locked(table_id, env)
        mu = _append_mus.setdefault(key, threading.Lock())
    with mu:
        with _lock:
            if key not in _catalog:
                raise KeyError_(
                    f"no table registered under {table_id!r}")
            ent = _catalog[key]
        cur, shard = ent.table, ent.world is not None
        if shard:
            if env is None:
                raise InvalidArgument(
                    f"append to sharded table {table_id!r} needs env= "
                    "(gather + re-scatter run over the world)")
            from cylon_tpu_torch.parallel import dist_to_pandas

            base = dist_to_pandas(env, cur)
        else:
            base = cur.to_pandas()
        if set(pdf.columns) != set(base.columns):
            raise InvalidArgument(
                f"append({table_id!r}): delta columns "
                f"{sorted(pdf.columns)} != resident schema "
                f"{sorted(base.columns)}")
        pdf = pdf[list(base.columns)]
        merged = (pd.concat([base, pdf], ignore_index=True)
                  if len(pdf) else base)
        new = _build(merged, _schema_of(cur), cur.device)
        if shard:
            from cylon_tpu_torch.column import Column
            from cylon_tpu_torch.parallel import scatter_table

            # the rank's block as a copy: a view would hold the whole
            # merged table's buffers for as long as the shard lives
            part = scatter_table(env, new)
            new = Table({n: Column(c.data.clone(), None if c.validity is None
                                   else c.validity.clone(), c.dtype,
                                   c.dictionary)
                         for n, c in part.columns.items()}, part.nrows)
        # the build above happened OUTSIDE _lock (readers kept going);
        # the swap itself is one lock hold: table, generation and the
        # delta-log entry publish together
        with _lock:
            if key not in _catalog:
                raise KeyError_(
                    f"table {table_id!r} dropped during append")
            _catalog[key] = _Entry(new, ent.world)
            gen = _bump_version_locked(key)
            log = _deltas.setdefault(key, [])
            log.append((gen, pdf.reset_index(drop=True)))
            keep = _delta_keep()
            if keep >= 0 and len(log) > keep:
                del log[:len(log) - keep]
    telemetry.counter("catalog.appends", table=table_id).inc()
    _events.emit("append", table=table_id, generation=gen,
                 delta_rows=int(len(pdf)))
    for cb in list(_append_listeners):
        try:
            cb(table_id, gen)
        except Exception:  # pragma: no cover - observer must not fail
            pass
    return {"generation": gen, "delta_rows": int(len(pdf)),
            "rows": int(len(merged))}


def deltas_since(table_id: str, gen: int, *, env=None) -> "list | None":
    """Host delta frames appended after generation ``gen``, oldest
    first — the exact rows a view at watermark ``gen`` has not applied
    yet (a shard's log holds the whole delta every rank passed).
    Returns ``[]`` when the watermark is current, and ``None`` when the
    retention window (or an intervening full :func:`put_table`
    overwrite) no longer covers the span — the caller must
    full-recompute, never silently under-apply.

    (``cylon_tpu/catalog.py`` ``deltas_since``)"""
    with _lock:
        key = _find_locked(table_id, env)
        ent = _versions.get(key)
        cur = int(ent["generation"]) if ent else 1
        log = list(_deltas.get(key, ()))
    gen = int(gen)
    if gen >= cur:
        return []
    got = {g: f for g, f in log}
    want = range(gen + 1, cur + 1)
    if any(g not in got for g in want):
        return None
    return [got[g] for g in want]


# ---------------------------------------------------------------- id ops
def _operand(table_id: str, env) -> Table:
    """An id op's input: with ``env`` this rank's shard, or its block
    of a local table (``scatter_table``), so that a local table enters a
    distributed op once, not once a rank."""
    with _lock:
        key = _find_locked(table_id, env)
        t = _catalog[key].table
    if env is not None and key[1] is None:
        from cylon_tpu_torch.parallel import scatter_table

        t = scatter_table(env, t)
    return t


def read_csv(table_id: str, path, **kw) -> None:
    """Parity: ``ReadCSV(ctx, path, id)`` (table_api.hpp). Builds on
    ``device=`` (CUDA by default)."""
    from cylon_tpu_torch.io import read_csv as _read

    put_table(table_id, _read(path, **kw).to_table())


def join_tables(left_id: str, right_id: str, out_id: str,
                config: JoinConfig | None = None, *, on=None,
                how: str = "inner", env=None, **kw) -> None:
    """Parity: ``JoinTables(ctx, "left", "right", ...)``
    (table_api.hpp:46). With ``env``: ``dist_join`` of this rank's
    shards, written as this rank's shard of ``out_id``.

    (``cylon_tpu/catalog.py`` ``join_tables``)"""
    from cylon_tpu_torch.ops.join import join
    from cylon_tpu_torch.parallel import dist_join

    lt, rt = _operand(left_id, env), _operand(right_id, env)
    if config is not None:
        on = None
        kw.setdefault("left_on", list(config.left_on))
        kw.setdefault("right_on", list(config.right_on))
        how = config.join_type.value
    if env is not None:
        out = dist_join(env, lt, rt, on=on, how=how, **kw)
    else:
        out = join(lt, rt, on=on, how=how, **kw)
    put_table(out_id, out, env=env)


def _binary(op_name: str):
    def run(left_id: str, right_id: str, out_id: str, env=None, **kw):
        from cylon_tpu_torch.ops import setops
        from cylon_tpu_torch.parallel import dist_ops

        lt, rt = _operand(left_id, env), _operand(right_id, env)
        if env is not None:
            fn = getattr(dist_ops, f"dist_{op_name}")
            put_table(out_id, fn(env, lt, rt, **kw), env=env)
        else:
            fn = getattr(setops, op_name)
            put_table(out_id, fn(lt, rt, **kw))
    run.__name__ = f"{op_name}_tables"
    run.__doc__ = (f"Parity: table_api {op_name.capitalize()}Tables "
                   f"(``cylon_tpu/catalog.py`` ``{op_name}_tables``).")
    return run


union_tables = _binary("union")
intersect_tables = _binary("intersect")
subtract_tables = _binary("subtract")


def sort_table(table_id: str, out_id: str, by, env=None, **kw) -> None:
    """Parity: table_api Sort/DistributedSort.

    (``cylon_tpu/catalog.py`` ``sort_table``)"""
    from cylon_tpu_torch.ops.selection import sort_table as _sort
    from cylon_tpu_torch.parallel import dist_sort

    t = _operand(table_id, env)
    by = [by] if isinstance(by, str) else list(by)
    if env is not None:
        put_table(out_id, dist_sort(env, t, by, **kw), env=env)
    else:
        put_table(out_id, _sort(t, by, **kw))


def unique_table(table_id: str, out_id: str, cols=None, env=None, **kw
                 ) -> None:
    """Parity: table_api Unique/DistributedUnique.

    (``cylon_tpu/catalog.py`` ``unique_table``)"""
    from cylon_tpu_torch.ops import setops
    from cylon_tpu_torch.parallel import dist_unique

    t = _operand(table_id, env)
    if env is not None:
        put_table(out_id, dist_unique(env, t, cols, **kw), env=env)
    else:
        put_table(out_id, setops.unique(t, cols, **kw))


def select_columns(table_id: str, out_id: str, names: Sequence[str],
                   env=None) -> None:
    """Parity: table_api Project."""
    put_table(out_id, get_table(table_id, env=env).select(list(names)),
              env=env if env is not None and is_shard(table_id, env)
              else None)


def table_to_pydict(table_id: str, env=None) -> Mapping[str, list]:
    """The table's rows as lists; a shard gathers the world's rows
    (collective), as the JAX package's global table would give."""
    t = get_table(table_id, env=env)
    if env is not None and is_shard(table_id, env):
        from cylon_tpu_torch.parallel import gather_table

        t = gather_table(env, t)
    return t.to_pydict()


# --------------------------------------------------------- native bridge
def to_native(table_id: str) -> None:
    """Copy a catalog entry into the native C-ABI registry
    (``cylon_catalog_*`` in ``native/cylon_host.cpp``) where any FFI
    host (the JNI-style binding surface) can read it. A sharded id
    raises, as every read without ``env`` does.

    (``cylon_tpu/catalog.py`` ``to_native``)"""
    from cylon_tpu_torch import native

    native.catalog_put(table_id, get_table(table_id))


def from_native(table_id: str, device=None) -> None:
    """Import a table published in the native registry into this
    catalog, built on ``device`` (None: CUDA); the reverse of
    :func:`to_native`.

    (``cylon_tpu/catalog.py`` ``from_native``)"""
    from cylon_tpu_torch import native

    put_table(table_id, native.catalog_get(table_id, device=device))
