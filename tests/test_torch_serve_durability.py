"""The port's serve durability (``cylon_tpu_torch.serve.durability``) and
versioned result cache (``cylon_tpu_torch.serve.result_cache``) against
the JAX package's modules on the same sequences: the write-ahead
journal (admit/done, ``incomplete``, a torn tail skipped), the journal
lock (acquire, verify, fence, stale break), the catalog snapshot
(save/restore with generations, on the CPU here and on CUDA by default),
and the result cache (lookups keyed on the version vector, invalidation
on append, byte-budget eviction). Journal lines compare by content:
timestamps, pids and tokens differ between runs."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as jct
from cylon_tpu import catalog as jcat
from cylon_tpu.serve import durability as jdur
from cylon_tpu.serve import result_cache as jrc
from cylon_tpu_torch import Table, catalog
from cylon_tpu_torch.context import CylonEnv
from cylon_tpu_torch.errors import DeviceUnavailable, FailedPrecondition
from cylon_tpu_torch.parallel.comm import ThreadWorld
from cylon_tpu_torch.serve import durability as pdur
from cylon_tpu_torch.serve import result_cache as prc

BOTH = [pytest.param(pdur, id="port"), pytest.param(jdur, id="jax")]


@pytest.fixture(autouse=True)
def clean():
    catalog.clear()
    jcat.clear()
    yield
    catalog.clear()
    jcat.clear()


def _content(entries):
    """Journal entries without what differs between runs."""
    return [{k: v for k, v in e.items() if k not in ("ts", "pid")}
            for e in entries]


def _journal_sequence(dur, root):
    j = dur.RequestJournal(str(root))
    j.admit(rid=1, key="a", name="q", args=[1], tenant="t")
    j.admit(rid=2, key="b", name="q", args=[2], tenant="t",
            tables=["tpch/lineitem"], trace_id="tr-2")
    j.admit(rid=3, key=None, name=None, tenant="t")       # bare callable
    j.admit(rid=4, key="c", name="q", args=[object()])    # not JSON
    j.admit(rid=5, key="b", name="q", args=[2], tenant="t")  # key again
    j.admit(rid=6, key=None, name="q", args=[6])
    j.done(rid=1, key="a", state="done")
    j.done(rid=6, key=None, state="failed")
    j.close()
    return dur.RequestJournal.read(str(root)), \
        dur.RequestJournal.incomplete(str(root))


def test_journal_admit_done_incomplete_match_jax(tmp_path):
    got = _journal_sequence(pdur, tmp_path / "port")
    want = _journal_sequence(jdur, tmp_path / "jax")
    assert _content(got[0]) == _content(want[0])
    replayable, unreplayable = got[1]
    assert _content(replayable) == _content(want[1][0])
    assert _content(unreplayable) == _content(want[1][1])
    assert [e["key"] for e in replayable] == ["b"]
    assert [e["rid"] for e in unreplayable] == [3, 4]
    assert unreplayable[1]["replayable"] is False
    assert unreplayable[1]["args"] == []


@pytest.mark.parametrize("dur", BOTH)
def test_torn_journal_tail_is_skipped(tmp_path, dur):
    j = dur.RequestJournal(str(tmp_path))
    j.admit(rid=1, key="a", name="q", tenant="t")
    j.close()
    with open(os.path.join(str(tmp_path), dur.RequestJournal.FILE),
              "a") as f:
        f.write('{"kind": "admit", "rid": 2, "key": "b", "na')   # torn
    assert [e["rid"] for e in dur.RequestJournal.read(str(tmp_path))] \
        == [1]
    replayable, _ = dur.RequestJournal.incomplete(str(tmp_path))
    assert [e["key"] for e in replayable] == ["a"]
    assert dur.RequestJournal.read(str(tmp_path / "none")) == []


@pytest.mark.parametrize("dur", BOTH)
def test_journal_lock_acquire_verify_release(tmp_path, dur):
    lk = dur.JournalLock(str(tmp_path)).acquire(owner="e0")
    on_disk = json.loads((tmp_path / dur.JournalLock.FILE).read_text())
    assert on_disk["owner"] == "e0" and on_disk["token"] == lk.token
    assert on_disk["pid"] == os.getpid()
    lk.verify()
    # this process is alive: a second owner is refused, naming it
    with pytest.raises(Exception, match="owned by a live engine") as e:
        dur.JournalLock(str(tmp_path)).acquire()
    assert type(e.value).__name__ == "FailedPrecondition"
    lk.release()
    assert not (tmp_path / dur.JournalLock.FILE).exists()
    lk.release()                                    # a second is a no-op


@pytest.mark.parametrize("dur", BOTH)
def test_stale_lock_of_a_dead_pid_is_broken(tmp_path, dur):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    (tmp_path / dur.JournalLock.FILE).write_text(json.dumps({
        "pid": proc.pid, "host": socket.gethostname(), "owner": "engine",
        "token": "stale", "acquired": 0}))
    j = dur.RequestJournal(str(tmp_path))       # breaks the stale lock
    j.admit(rid=1, key="k", name="q")
    assert j.lock.token != "stale"
    j.close()


@pytest.mark.parametrize("dur", BOTH)
def test_expired_heartbeat_is_stale_only_when_ttl_armed(tmp_path, dur,
                                                        monkeypatch):
    lock = tmp_path / dur.JournalLock.FILE

    def write_lock(host):
        lock.write_text(json.dumps({"pid": os.getpid(), "host": host,
                                    "owner": "engine", "token": "old",
                                    "acquired": 0}))
        old = time.time() - 3600
        os.utime(lock, (old, old))

    write_lock("some-other-host")
    monkeypatch.delenv("CYLON_TPU_FLEET_LOCK_TTL", raising=False)
    with pytest.raises(Exception, match="live engine"):
        dur.JournalLock(str(tmp_path)).acquire()
    monkeypatch.setenv("CYLON_TPU_FLEET_LOCK_TTL", "10")
    dur.JournalLock(str(tmp_path)).acquire().release()
    write_lock(socket.gethostname())            # alive on this host
    with pytest.raises(Exception, match="live engine"):
        dur.JournalLock(str(tmp_path)).acquire()


@pytest.mark.parametrize("dur", BOTH)
def test_fence_blocks_owner_appends_but_not_adoption(tmp_path, dur):
    j = dur.RequestJournal(str(tmp_path))
    j.admit(rid=1, key="a", name="q")
    dur.fence_journal(str(tmp_path), owner="router:test")
    with pytest.raises(Exception, match="FENCED"):
        j.admit(rid=2, key="b", name="q")
    j.close()
    assert (tmp_path / dur.JournalLock.FILE).exists()    # fence survives
    j2 = dur.RequestJournal(str(tmp_path))   # adoption breaks the fence
    j2.admit(rid=3, key="c", name="q")
    j2.close()
    keys = [e.get("key") for e in dur.RequestJournal.read(str(tmp_path))]
    assert keys == ["a", "c"]


# ------------------------------------------------------------ snapshots
def _frame(seed=0, n=30):
    rng = np.random.default_rng(seed)
    ni = pd.array(rng.integers(0, 5, n), dtype="Int64")
    ni[rng.random(n) < 0.3] = pd.NA
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                         "v": rng.normal(size=n),
                         "s": rng.choice(["x", "yy", None], n), "n": ni})


def test_catalog_snapshot_save_restore_matches_jax(tmp_path):
    df = _frame()
    delta = _frame(1, 5)
    catalog.put_table("t", Table.from_pandas(
        df, device="cpu", string_storage={"s": "bytes"}))
    jcat.put_table("t", jct.Table.from_pandas(df))
    empty = {"k": np.empty(0, np.int64), "v": np.empty(0)}
    catalog.put_table("e", Table.from_pydict(empty, capacity=1,
                                             device="cpu"))
    jcat.put_table("e", jct.Table.from_pydict(empty, capacity=1))
    for cat in (catalog, jcat):
        cat.append("t", delta)
        cat.append("t", delta.assign(k=delta["k"] + 100))
    snaps = {"port": pdur.CatalogSnapshot(str(tmp_path / "port")),
             "jax": jdur.CatalogSnapshot(str(tmp_path / "jax"))}
    before = {}
    for name, cat in (("port", catalog), ("jax", jcat)):
        for tid in cat.list_tables():
            snaps[name].save(tid, cat.get_table(tid),
                             generation=cat.generation(tid))
        before[name] = {tid: cat.table_version(tid)
                        for tid in cat.list_tables()}
        cat.clear()
    assert before["port"] == before["jax"]
    assert snaps["port"].tables == snaps["jax"].tables == ["e", "t"]
    assert snaps["port"].generations() == snaps["jax"].generations() \
        == {"e": 1, "t": 3}
    # reopening reads the durable map
    restored = pdur.CatalogSnapshot(str(tmp_path / "port")).restore(
        device="cpu")
    jrestored = snaps["jax"].restore()
    for tid, t in restored.items():
        catalog.put_table(tid, t)
        catalog.restore_version(tid, snaps["port"].generations()[tid])
        jcat.put_table(tid, jrestored[tid])
        jcat.restore_version(tid, snaps["jax"].generations()[tid])
    after = {tid: catalog.table_version(tid) for tid in restored}
    assert after == before["port"]
    assert {tid: jcat.table_version(tid) for tid in jrestored} == \
        before["jax"]
    t = catalog.get_table("t")
    assert t.device.type == "cpu" and t.column("s").dtype.is_bytes
    assert t.column("n").validity is not None
    assert catalog.get_table("e").num_rows == 0


def test_snapshot_restore_builds_on_cuda_by_default(tmp_path, monkeypatch):
    snap = pdur.CatalogSnapshot(str(tmp_path))
    snap.save("t", Table.from_pydict({"a": np.arange(3)}, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        snap.restore()
    with pytest.raises(DeviceUnavailable):
        snap.restore(device="cuda")
    assert snap.restore(device="cpu")["t"].num_rows == 3


def test_snapshot_generations_tolerate_pre_version_entries(tmp_path):
    snap = pdur.CatalogSnapshot(str(tmp_path))
    t = Table.from_pydict({"a": np.arange(4)}, device="cpu")
    snap.save("old", t)
    snap.save("new", t, generation=5)
    assert snap.generations() == {"new": 5}
    snap.drop("old")
    assert pdur.CatalogSnapshot(str(tmp_path)).tables == ["new"]


def test_snapshot_of_shards_gathers_and_rank0_writes(tmp_path):
    df = _frame(2, 40)[["k", "v"]]

    def rank(comm):
        env = CylonEnv(comm, device="cpu")
        block = -(-len(df) // env.world_size)
        part = df.iloc[env.rank * block:(env.rank + 1) * block]
        catalog.put_table("T", Table.from_pandas(
            part.reset_index(drop=True), device="cpu"), env=env)
        snap = pdur.CatalogSnapshot(str(tmp_path))
        snap.save("T", catalog.get_table("T", env=env), env=env,
                  generation=catalog.generation("T", env=env))
        return True

    assert ThreadWorld(4).run(rank) == [True] * 4
    got = pdur.CatalogSnapshot(str(tmp_path)).restore(device="cpu")["T"]
    pd.testing.assert_frame_equal(got.to_pandas(), df)


# --------------------------------------------------------- result cache
def _cache_sequence(rc, cat, mk):
    """The same lookups, stores, appends and evictions on one package's
    cache; returns what each step saw."""
    cat.put_table("a", mk({"k": np.arange(4, dtype=np.int64)}))
    cat.put_table("b", mk({"k": np.arange(8, dtype=np.int64)}))
    cache = rc.hook_on_append(rc.ResultCache(300, metric_prefix="t"))
    va, vab = rc.version_vector(["a"]), rc.version_vector(["b", "a", "a"])
    seen = [va[0][:2], [x[:2] for x in vab],
            rc.version_vector([]), cache.lookup("fp1", va)]
    seen.append(cache.store("fp1", va, "A" * 100))
    seen.append(cache.store("fp2", vab, "B" * 100))
    seen.append(cache.lookup("fp1", va))
    seen.append(cache.lookup("fp1", None))
    seen.append(cache.store("fp3", None, "x"))
    seen.append(cache.store("huge", va, "x" * 1000))
    seen.append(cache.stats())
    cat.append("b", {"k": np.asarray([99])})           # drops fp2 only
    seen.append((len(cache), cache.lookup("fp2", vab)[0],
                 cache.lookup("fp1", va)[0]))
    vb2 = rc.version_vector(["a", "b"])
    seen.append([x[:2] for x in vb2])
    cache.store("fp4", vb2, "C" * 100)
    cache.store("fp5", va, "D" * 100)
    cache.lookup("fp1", va)                   # fp1 is now the newest
    cache.store("fp6", va, "E" * 100)         # evicts fp4, the LRU
    seen.append((cache.lookup("fp4", vb2)[0], cache.lookup("fp1", va)[0],
                 cache.stats()))
    seen.append(cache.invalidate_table("a"))
    seen.append(cache.stats())
    return seen


def test_result_cache_sequence_matches_jax():
    got = _cache_sequence(prc, catalog,
                          lambda d: Table.from_pydict(d, device="cpu"))
    want = _cache_sequence(jrc, jcat, jct.Table.from_pydict)
    assert got == want
    assert got[3] == (False, None) and got[6] == (True, "A" * 100)
    assert got[11] == (1, False, True)
    assert got[-2] == 3 and got[-1]["entries"] == 0


def test_version_vector_reads_digests_and_refuses_unknown_tables():
    catalog.put_table("a", Table.from_pydict({"k": np.arange(3)},
                                             device="cpu"))
    jcat.put_table("a", jct.Table.from_pydict({"k": np.arange(3)}))
    assert prc.version_vector(["a"]) == jrc.version_vector(["a"])
    # a read set the catalog cannot version is uncacheable
    assert prc.version_vector(["a", "ghost"]) is None


def test_value_nbytes_counts_tensors_and_tables():
    t = Table.from_pydict({"k": np.arange(16, dtype=np.int64),
                           "v": np.arange(16, dtype=np.float32)},
                          device="cpu")
    assert prc.value_nbytes(t) == 16 * 8 + 16 * 4 == catalog.table_nbytes(t)
    assert prc.value_nbytes(torch.zeros(10, dtype=torch.float64)) == 80
    assert prc.value_nbytes(np.zeros(5)) == jrc.value_nbytes(np.zeros(5))
    assert prc.value_nbytes("abc") == 3
    assert prc.value_nbytes({"a": 1.0}) == jrc.value_nbytes({"a": 1.0})
    assert prc.value_nbytes([b"xy", np.zeros(2)]) == 2 + 16 + 64


def test_disabled_cache_and_budget_from_env(monkeypatch):
    off = prc.ResultCache(0)
    assert not off.enabled and not off.store("f", (("a", 1, "d"),), 1)
    assert off.lookup("f", (("a", 1, "d"),)) == (False, None)
    monkeypatch.setenv("CYLON_TPU_SERVE_RESULT_CACHE_BYTES", "123")
    assert prc.cache_bytes_from_env(
        "CYLON_TPU_SERVE_RESULT_CACHE_BYTES") == 123
    monkeypatch.setenv("CYLON_TPU_SERVE_RESULT_CACHE_BYTES", "junk")
    assert prc.cache_bytes_from_env(
        "CYLON_TPU_SERVE_RESULT_CACHE_BYTES") == prc.DEFAULT_CACHE_BYTES


def test_snapshot_init_mutex_breaks_a_crashed_initializer(tmp_path):
    root = tmp_path / "catalog"
    root.mkdir()
    lock = root / pdur.CatalogSnapshot.INIT_LOCK
    lock.write_text("")
    old = time.time() - 120
    os.utime(lock, (old, old))
    snap = pdur.CatalogSnapshot(str(tmp_path))
    assert snap.tables == [] and not lock.exists()
    with pytest.raises(FailedPrecondition):
        pdur.JournalLock(str(tmp_path)).acquire().verify() or \
            pdur.JournalLock(str(tmp_path)).acquire()
