"""Serve-engine durability: the write-ahead journal + catalog snapshot.

Port of ``cylon_tpu/serve/durability.py`` (host code on the port's
:mod:`cylon_tpu_torch.resilience` spill store and atomic writes).

The always-on engine (:mod:`cylon_tpu_torch.serve.service`) is exactly the
process a preemption hurts most: it holds resident tables other
processes registered and requests clients already got tickets for.
This module gives :class:`~cylon_tpu_torch.serve.ServeEngine` a durable spine
so ``ServeEngine.recover(dir)`` can rebuild both after a hard kill:

* :class:`RequestJournal` — an append-only JSONL **write-ahead
  journal**. Every admitted request lands as an ``admit`` line (fsynced
  BEFORE the request is dispatched to the scheduler — the write-ahead
  invariant the bench guard enforces statically), and every retirement
  as a ``done`` line. Recovery replays admitted-but-not-done entries.
  Client-supplied **idempotency keys** make the replay exactly-once: a
  client retrying a request it never got an answer for reuses its key,
  and the engine dedups against both live and replayed requests instead
  of double-executing. Dedup'd admissions journal the same
  way: a result-cache hit writes its admit line and then an immediate
  ``done`` line, and every coalesced follower writes its OWN admit
  line before it can be answered — so ``recover()`` never replays an
  answer a client already holds, and a killed leader's followers are
  each independently replayable.

* :class:`CatalogSnapshot` — the resident tables, spilled through the
  same fsync-then-rename :class:`~cylon_tpu_torch.resilience.SpillStore`
  machinery the out-of-core checkpoints use. ``register_table`` on a
  durable engine snapshots the table's host content; ``recover``
  restores every snapshot into the process catalog (distributed tables
  restore as local tables — re-scatter them over the recovered world
  if the deployment shards them). Restores build on the card unless
  the caller passes ``device="cpu"``.

* :class:`JournalLock` — the multi-engine fence. A fleet
  shares one durable dir tree, so a second live engine pointed at an
  OWNED journal must fail loudly instead of silently interleaving
  journal lines with the owner. Each journal carries an exclusive
  owner lockfile (``journal.lock``, created ``O_EXCL``) recording the
  owner's pid/host plus a random fencing token; every append
  re-verifies the token on disk, so :func:`fence_journal` (the
  router's "you are dead to me" write) makes a zombie owner's next
  append raise :class:`~cylon_tpu_torch.errors.FailedPrecondition` instead
  of corrupting the stream. Stale locks — dead pid on this host, a
  fence marker, or a heartbeat mtime older than
  ``CYLON_TPU_FLEET_LOCK_TTL`` (0 disables the TTL rule) — are broken
  automatically on acquire, which is exactly what
  ``ServeEngine.recover`` needs to adopt a killed engine's journal.

Crash-window contract (shared with :class:`CheckpointedRun`): every
manifest write is tmp + fsync + ``os.replace``; journal lines are
flushed + fsynced per record, and a torn trailing line (the kill landed
mid-append) is skipped on replay, never fatal.
"""

import json
import os
import socket
import threading
import time
import uuid

from cylon_tpu_torch.errors import (FailedPrecondition, InvalidArgument,
                                    KeyError_)
from cylon_tpu_torch.resilience import SpillStore, atomic_write_json
from cylon_tpu_torch.utils.logging import get_logger

__all__ = ["RequestJournal", "CatalogSnapshot", "JournalLock",
           "fence_journal"]


class JournalLock:
    """Exclusive owner lockfile for one request journal.

    The file holds ``{"pid", "host", "owner", "token", "acquired"}``;
    the in-memory ``token`` is the owner's proof of possession. Three
    operations matter:

    * :meth:`acquire` — ``O_EXCL`` create; an existing lock is broken
      IFF :meth:`_stale` says so (owner pid dead on this host, a
      ``fenced`` marker, or mtime heartbeat older than the TTL),
      otherwise :class:`~cylon_tpu_torch.errors.FailedPrecondition` names the
      live owner. A broken-and-reacquired lock gets a FRESH token, so
      the previous owner is fenced as a side effect.
    * :meth:`verify` — called under the journal mutex before every
      append: the on-disk token must still be ours. A mismatch means
      somebody fenced us (or adopted the journal); the append raises
      instead of interleaving with the new owner.
    * :meth:`heartbeat` — ``os.utime`` after every append, the
      liveness signal the TTL rule reads (a wedged-but-alive engine
      eventually reads stale once the deployment sets the TTL).
    (``cylon_tpu/serve/durability.py`` ``JournalLock``)"""

    FILE = "journal.lock"

    def __init__(self, root: str):
        self.root = str(root)
        self.path = os.path.join(self.root, self.FILE)
        self.token: "str | None" = None

    # ------------------------------------------------------- internals
    def _read(self) -> "dict | None":
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def _ttl() -> float:
        try:
            return float(os.environ.get("CYLON_TPU_FLEET_LOCK_TTL",
                                        "0") or 0)
        except ValueError:
            return 0.0

    def _stale(self, cur: "dict | None") -> bool:
        """May this lock be broken? Unreadable/torn locks and fence
        markers are always breakable (a fence only needs to stop the
        OLD token holder — any new owner may take over). On the
        owner's own host, pid liveness is AUTHORITATIVE: a dead pid is
        stale, a provably-alive pid is never stale (an idle engine
        appends nothing, so its heartbeat mtime ages — the TTL must
        not break a live owner; fencing a wedged-but-alive engine is
        :func:`fence_journal`'s job, a deliberate act). Only when the
        pid is uncheckable (different host — shared storage) does the
        armed-TTL heartbeat rule decide."""
        if cur is None or cur.get("fenced"):
            return True
        pid = cur.get("pid")
        if cur.get("host") == socket.gethostname() \
                and isinstance(pid, int):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            except PermissionError:
                return False  # alive, different user
            return False  # alive: liveness beats any heartbeat age
        ttl = self._ttl()
        if ttl > 0:
            try:
                age = time.time() - os.stat(self.path).st_mtime
            except OSError:
                return True
            if age > ttl:
                return True
        return False

    # ------------------------------------------------------ operations
    def acquire(self, owner: str = "engine") -> "JournalLock":
        os.makedirs(self.root, exist_ok=True)
        payload = {"pid": os.getpid(), "host": socket.gethostname(),
                   "owner": str(owner),
                   "token": uuid.uuid4().hex,
                   "acquired": time.time()}
        for _ in range(8):  # bounded retry around break/acquire races
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                cur = self._read()
                if not self._stale(cur):
                    cur = cur or {}
                    raise FailedPrecondition(
                        f"journal {self.root!r} is owned by a live "
                        f"engine (pid {cur.get('pid')} on "
                        f"{cur.get('host')!r}, owner "
                        f"{cur.get('owner')!r}) — a second engine must "
                        "never append to an owned journal; point it at "
                        "its own durable dir, or fence/stop the owner "
                        "first. NOTE: pid liveness is only checkable "
                        "on the owner's host — for cross-host "
                        "deployments (shared storage) arm "
                        "CYLON_TPU_FLEET_LOCK_TTL so a crashed "
                        "remote owner's heartbeat expires, or "
                        "fence_journal()/unlink the lock once the "
                        "owner is provably gone")
                get_logger().warning(
                    "breaking stale journal lock %s (owner %r)",
                    self.path, (cur or {}).get("owner"))
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
                continue
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            self.token = payload["token"]
            return self
        raise FailedPrecondition(
            f"could not acquire journal lock {self.path!r}: lost the "
            "break/acquire race repeatedly")

    def verify(self) -> None:
        """Raise :class:`~cylon_tpu_torch.errors.FailedPrecondition` unless
        the on-disk lock still carries OUR token — i.e. we were fenced
        (or the lock was broken and re-acquired) since the last
        append."""
        cur = self._read()
        if cur is None or cur.get("token") != self.token:
            raise FailedPrecondition(
                f"journal {self.root!r} has been FENCED (lock token "
                f"changed; current owner: "
                f"{(cur or {}).get('owner')!r}) — this engine no "
                "longer owns its journal and must not append; a "
                "router declared it dead and failed its requests over")

    def heartbeat(self) -> None:
        try:
            os.utime(self.path, None)
        except OSError:  # pragma: no cover - heartbeat best-effort
            pass

    def release(self) -> None:
        """Unlink the lock IFF it is still ours (never steal a
        successor's lock — release after a fence is a no-op)."""
        if self.token is None:
            return
        cur = self._read()
        if cur is not None and cur.get("token") == self.token:
            try:
                os.unlink(self.path)
            except OSError:  # pragma: no cover - release best-effort
                pass
        self.token = None


def fence_journal(root: str, owner: str = "router") -> None:
    """FENCE a journal: atomically install a fresh lock token so the
    current owner's next :meth:`JournalLock.verify` fails. This is the
    router's failover barrier — written AFTER an engine is declared
    dead and BEFORE its journaled-but-incomplete requests replay on a
    peer, so a zombie engine (alive but unreachable) can never append
    an ``admit``/``done`` line that races the replay. The fence itself
    is marked breakable (``fenced: true``): a later
    ``ServeEngine.recover`` on the same dir adopts the journal
    normally.

    (``cylon_tpu/serve/durability.py`` ``fence_journal``)"""
    payload = {"pid": os.getpid(), "host": socket.gethostname(),
               "owner": str(owner), "token": uuid.uuid4().hex,
               "acquired": time.time(), "fenced": True}
    os.makedirs(str(root), exist_ok=True)
    atomic_write_json(os.path.join(str(root), JournalLock.FILE),
                      payload)


class RequestJournal:
    """Append-only JSONL write-ahead journal of serve requests.

    One line per event::

        {"kind": "admit", "rid": 3, "key": "c1-q3-0", "name": "q3",
         "args": [...], "kwargs": {...}, "tenant": "t1", "priority": 1,
         "slo": null, "tables": ["tpch/lineitem"], "replayable": true}
        {"kind": "done", "rid": 3, "key": "c1-q3-0", "state": "done"}

    ``admit`` is written (flush + fsync) BEFORE the request reaches the
    scheduler, so a kill at any later instant leaves the request
    recoverable. A request whose args are not JSON-serializable (or
    that was submitted as a bare callable rather than a registered
    named query) is journaled with ``replayable: false`` — recovery
    reports it as lost instead of silently dropping it.
    (``cylon_tpu/serve/durability.py`` ``RequestJournal``)"""

    FILE = "journal.jsonl"

    def __init__(self, root: str, owner: str = "engine"):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.path = os.path.join(self.root, self.FILE)
        self._mu = threading.Lock()
        #: exclusive ownership BEFORE the append handle opens: a second
        #: live engine pointed at this journal fails here (two
        #: writers would silently interleave admit/done lines);
        #: stale locks (dead pid, fence marker, expired heartbeat) are
        #: broken, which is how recover() adopts a killed engine's dir
        self.lock = JournalLock(self.root).acquire(owner=owner)
        self._f = open(self.path, "a")

    def _append(self, entry: dict) -> None:
        line = json.dumps(entry)
        with self._mu:
            # fencing check rides every append: once a router fenced
            # this journal (token replaced), appending would race the
            # failover replay — refuse instead
            self.lock.verify()
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            self.lock.heartbeat()

    def admit(self, *, rid: int, key: "str | None", name: "str | None",
              args=(), kwargs=None, tenant: str = "default",
              priority: int = 1, slo: "float | None" = None,
              tables=(), trace_id: "str | None" = None) -> None:
        """Write-ahead record of one admitted request. Falls back to
        ``replayable: false`` (with args dropped) when the payload is
        not JSON-serializable — the journal must never fail a submit
        that the engine would otherwise accept. ``trace_id``
        rides the entry so a failover REPLAY of this request can
        keep the original fleet trace identity."""
        entry = {"kind": "admit", "rid": int(rid), "key": key,
                 "name": name, "args": list(args),
                 "kwargs": dict(kwargs or {}), "tenant": str(tenant),
                 "priority": int(priority), "slo": slo,
                 "tables": list(tables),
                 "trace_id": (None if trace_id is None
                              else str(trace_id)),
                 "replayable": name is not None}
        try:
            self._append(entry)
        except (TypeError, ValueError):
            entry.update(args=[], kwargs={}, replayable=False)
            self._append(entry)

    def done(self, *, rid: int, key: "str | None", state: str) -> None:
        """Retirement record (state ``done``/``failed``): the request
        needs no replay — even a FAILED one, whose error the client
        already observed (re-running it on recovery would surprise an
        idempotent client with a second side-effect attempt)."""
        self._append({"kind": "done", "rid": int(rid), "key": key,
                      "state": str(state)})

    # ---------------------------------------------------------- replay
    @staticmethod
    def read(root: str) -> "list[dict]":
        """All parseable journal entries under ``root`` (missing file =
        empty). A torn trailing line — the kill landed mid-append — is
        skipped; a torn line FOLLOWED by valid lines would mean
        fsync-ordering was violated and is logged loudly but still
        skipped (recovery must degrade, not die)."""
        path = os.path.join(str(root), RequestJournal.FILE)
        entries: list = []
        torn = 0
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return entries
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                torn += 1
                if i != len(lines) - 1:
                    get_logger().error(
                        "serve journal %s: torn NON-final line %d "
                        "(skipped) — fsync ordering violated?",
                        path, i + 1)
        if torn:
            get_logger().warning(
                "serve journal %s: skipped %d torn line(s)", path, torn)
        return entries

    @staticmethod
    def incomplete(root: str) -> "tuple[list[dict], list[dict]]":
        """(replayable, unreplayable) admitted-but-not-done entries, in
        admission order, deduped by idempotency key (a key journaled
        twice — e.g. admitted again by a previous recovery — replays
        once)."""
        done_keys, done_rids = set(), set()
        for e in RequestJournal.read(root):
            if e.get("kind") == "done":
                if e.get("key") is not None:
                    done_keys.add(e["key"])
                done_rids.add(e.get("rid"))
        replayable, unreplayable, seen = [], [], set()
        for e in RequestJournal.read(root):
            if e.get("kind") != "admit":
                continue
            key = e.get("key")
            if key is not None:
                if key in done_keys or key in seen:
                    continue
                seen.add(key)
            elif e.get("rid") in done_rids:
                continue
            (replayable if e.get("replayable") and e.get("name")
             else unreplayable).append(e)
        return replayable, unreplayable

    def close(self) -> None:
        with self._mu:
            try:
                self._f.close()
            except OSError:  # pragma: no cover - close best-effort
                pass
            self.lock.release()


class CatalogSnapshot:
    """Durable image of the resident-table catalog.

    Tables spill into a :class:`~cylon_tpu_torch.resilience.SpillStore` under
    ``<root>/catalog/`` (one bucket per table, fsync-then-rename data +
    manifest), with a ``tables.json`` map from table id to bucket —
    itself written via :func:`~cylon_tpu_torch.resilience.atomic_write_json`.
    The store's fingerprint is a fixed format tag, so reopening after a
    kill resumes the snapshot rather than discarding it.

    (``cylon_tpu/serve/durability.py`` ``CatalogSnapshot``)"""

    FORMAT = "serve-catalog-v1"
    MAP = "tables.json"
    INIT_LOCK = ".init.lock"

    def __init__(self, root: str):
        self.root = os.path.join(str(root), "catalog")
        self.store = self._store_with_init_mutex()
        self._mpath = os.path.join(self.root, self.MAP)
        try:
            with open(self._mpath) as f:
                self._map = json.load(f)
        except (OSError, ValueError):
            self._map = {"tables": {}, "next": 0}

    def _store_with_init_mutex(self) -> SpillStore:
        """Open the spill store under a tiny cross-process init mutex.

        A FLEET shares one snapshot store: two engine
        processes constructing it concurrently on a FRESH dir would
        race SpillStore's first-manifest write against the other's
        stale-state sweep (which unlinks ``manifest.json.tmp*`` —
        deleting the peer's in-flight atomic write). The mutex only
        guards construction; steady-state saves stay lock-free
        (identical content, atomic per-file replace). A mutex file
        older than 60s is a crashed initializer and is broken."""
        os.makedirs(self.root, exist_ok=True)
        lockpath = os.path.join(self.root, self.INIT_LOCK)
        deadline = time.monotonic() + 120.0
        while True:
            try:
                fd = os.open(lockpath,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise FailedPrecondition(
                        f"snapshot store {self.root!r} init mutex "
                        "held past the deadline — wedged "
                        "initializer?")
                try:
                    age = time.time() - os.stat(lockpath).st_mtime
                except OSError:
                    age = None  # released/claimed under us: retry
                if age is not None and age > 60.0:
                    # crashed initializer: CLAIM the stale mutex by
                    # atomic rename — exactly one breaker wins the
                    # replace (the losers' replace raises and they
                    # just retry the O_EXCL create), so a freshly
                    # re-created lock can never be unlinked by a
                    # racing breaker that statted the OLD file
                    stale = (f"{lockpath}.stale{os.getpid()}_"
                             f"{threading.get_ident()}")
                    try:
                        os.replace(lockpath, stale)
                        os.unlink(stale)
                    except OSError:
                        pass
                time.sleep(0.05)
                continue
            os.close(fd)
            try:
                return SpillStore(self.root, fingerprint=self.FORMAT)
            finally:
                try:
                    os.unlink(lockpath)
                except OSError:  # pragma: no cover - best-effort
                    pass

    def _flush_map(self) -> None:
        atomic_write_json(self._mpath, self._map)

    @property
    def tables(self) -> "list[str]":
        return sorted(self._map["tables"])

    def save(self, table_id: str, table, env=None,
             generation: "int | None" = None) -> None:
        """Snapshot one table's host content. A shard (the catalog's
        record of ``table_id`` as ``env`` addresses it, the port's
        stand-in for the JAX package's ``dtable.is_distributed``)
        gathers the world's rows first: every rank calls, rank 0
        writes. Data lands durably BEFORE the map names it — a kill
        mid-save leaves the previous snapshot intact. The map entry
        keeps each column's string storage and nullable type, so
        :meth:`restore` rebuilds the table as it was.

        ``generation`` stamps the catalog's monotone version into the
        map entry: a :meth:`restore` after an append must reinstate
        the POST-append generation, or the recovered process would
        serve generation-1 content under a generation-1 label and
        every version-keyed memo/view watermark would silently alias
        the stale version.

        (``cylon_tpu/serve/durability.py`` ``save``)"""
        from cylon_tpu_torch import catalog

        shard = env is not None and _is_shard(table_id, env)
        pdf = self._host_frame(table, env, shard)
        if shard and int(env.rank) != 0:
            return
        if not len(pdf.columns):
            get_logger().warning(
                "catalog snapshot: table %r has no columns; skipped",
                table_id)
            return
        ent = self._map["tables"].get(table_id)
        if ent is None:
            bucket = int(self._map["next"])
            self._map["next"] = bucket + 1
        else:
            bucket = int(ent["bucket"])
        self.store.write_bucket(
            bucket, {c: pdf[c].to_numpy() for c in pdf.columns},
            max(len(pdf), 1), meta={"table_id": table_id,
                                    "rows": int(len(pdf))})
        entry = {"bucket": bucket, "rows": int(len(pdf)),
                 "schema": catalog._schema_of(table)}
        if generation is not None:
            entry["generation"] = int(generation)
        self._map["tables"][table_id] = entry
        self._flush_map()

    def generations(self) -> "dict[str, int]":
        """Per-table generation stamps recorded at save time (tables
        snapshotted before the versioning era are absent — restore
        treats them as generation 1)."""
        return {tid: int(ent["generation"])
                for tid, ent in self._map["tables"].items()
                if "generation" in ent}

    @staticmethod
    def _host_frame(table, env=None, shard: bool = False):
        """A table's host frame: a shard's is the world's rows in rank
        order (``dist_to_pandas``, collective).

        (``cylon_tpu/serve/durability.py`` ``_host_frame``)"""
        if shard:
            from cylon_tpu_torch.parallel import dist_to_pandas

            return dist_to_pandas(env, table)
        return table.to_pandas()

    def drop(self, table_id: str) -> None:
        """Forget a table's snapshot (the orphaned bucket is left on
        disk; the map is authoritative)."""
        if self._map["tables"].pop(table_id, None) is not None:
            self._flush_map()

    def restore(self, device=None) -> "dict[str, object]":
        """Rebuild every snapshot table on ``device`` (None: CUDA, as
        every port entry point; pass ``device="cpu"`` for the CPU):
        {table_id: Table}, each string column in its saved storage and
        nullable columns with their validity. Rows==0 snapshots restore
        with their schema (the spill kept empty columns).

        (``cylon_tpu/serve/durability.py`` ``restore``)"""
        import pandas as pd

        from cylon_tpu_torch import catalog
        from cylon_tpu_torch import device as _device

        dev = _device.resolve(device)
        out: dict = {}
        for tid, ent in sorted(self._map["tables"].items()):
            cols = self.store.read_bucket(int(ent["bucket"]))
            rows = int(ent["rows"])
            frame = pd.DataFrame({k: v[:rows] for k, v in cols.items()})
            out[tid] = catalog._build(frame, ent.get("schema", {}), dev)
        return out


def _is_shard(table_id: str, env) -> bool:
    """The catalog's shard record of ``table_id`` as ``env`` addresses
    it; False for a table the catalog does not hold."""
    from cylon_tpu_torch import catalog

    try:
        return catalog.is_shard(table_id, env)
    except (KeyError_, InvalidArgument):
        return False
