"""Cross-rank aggregation: merge snapshots, gather the world view.

Port of ``cylon_tpu/telemetry/aggregate.py``. The reference prints
per-rank ``j_t``/``w_t`` lines and leaves the operator to eyeball 64
stdouts; here every rank's registry snapshot is a plain dict, merging
is associative (:func:`merge_snapshots` — the property the tests pin),
and :func:`gather_metrics` collects every process's snapshot through
the env's communicator so ONE host can print the world view.

Which worlds gather: only ranks that are processes
(``ProcessGroupComm``, over ``torch.distributed``) hold registries of
their own, so only they exchange snapshots: one all-gather of the
payload lengths, then one all-gather of the JSON, padded to the longest
as ``uint8``. A ``LocalComm`` and the W ranks of a ``ThreadWorld``
(threads of one process) share the process registry, which already
holds every rank's counts: gathering there would add the same snapshot
W times, so those return the local snapshot and run no collective.

Merge semantics per instrument type:

- counter: sum (bytes moved world-wide, total retries);
- histogram/timer: per-bucket add + count/sum add + min/max combine —
  exact because every histogram shares the fixed log-spaced bucket
  ladder (:data:`cylon_tpu_torch.telemetry.registry.BUCKET_BOUNDS`);
- gauge: max of the set values (a world pad-ratio gauge reports the
  worst rank — the conservative reading for a utilisation metric).
"""

import json

__all__ = ["merge_snapshots", "gather_metrics", "gather_traces"]


def _merge_entry(a: dict, b: dict) -> dict:
    if a.get("type") != b.get("type"):
        raise ValueError(
            f"cannot merge {a.get('type')} with {b.get('type')} for "
            f"metric {a.get('name')!r} — rank registries diverged")
    out = dict(a)
    if a["type"] == "counter":
        out["value"] = a["value"] + b["value"]
    elif a["type"] == "gauge":
        # only numeric gauge values merge — a rank whose gauge was
        # stringified by json_safe must not turn max() into a
        # lexicographic compare or a mixed-type TypeError
        def _num(v):
            return v if isinstance(v, (int, float)) \
                and not isinstance(v, bool) else None

        av, bv = _num(a.get("value")), _num(b.get("value"))
        out["value"] = (bv if av is None
                        else av if bv is None else max(av, bv))
    else:  # histogram / timer
        out["count"] = a["count"] + b["count"]
        out["sum"] = a["sum"] + b["sum"]
        for field, pick in (("min", min), ("max", max)):
            av, bv = a.get(field), b.get(field)
            out[field] = (bv if av is None
                          else av if bv is None else pick(av, bv))
        bks = dict(a.get("buckets", {}))
        for le, n in b.get("buckets", {}).items():
            bks[le] = bks.get(le, 0) + n
        out["buckets"] = bks
    return out


def merge_snapshots(snaps) -> dict:
    """Reduce an iterable of snapshot dicts into one world snapshot.
    Associative and commutative: any merge tree over the same rank set
    produces the same result (the histogram buckets are fixed and
    add elementwise; counters add; gauges max)."""
    out: dict = {}
    for snap in snaps:
        for key, entry in snap.items():
            out[key] = (dict(entry) if key not in out
                        else _merge_entry(out[key], entry))
    return out


def _gathers(env) -> bool:
    """Do the ranks of ``env`` hold registries of their own, i.e. are
    they processes of a ``torch.distributed`` group of more than one?"""
    if env is None or env.world_size <= 1:
        return False
    from cylon_tpu_torch.parallel.comm import ProcessGroupComm

    return isinstance(env.comm, ProcessGroupComm)


def gather_metrics(env=None, snap: "dict | None" = None) -> dict:
    """The world-wide metric snapshot, merged onto every rank.

    One process (no env, ``LocalComm``, ``ThreadWorld``): the local
    snapshot is returned as-is — no collective, no device work (the
    threads of a ``ThreadWorld`` share it, so it is already the world
    view). Ranks as processes: each contributes its JSON-encoded
    snapshot through :func:`_allgather_json` and every rank returns the
    same merged view — counters summed, histograms bucket-merged.
    A collective then: every rank must call it."""
    from cylon_tpu_torch.telemetry import registry as _r

    snap = _r.snapshot() if snap is None else snap
    if not _gathers(env):
        return snap
    return merge_snapshots(_allgather_json(env, snap))


def _allgather_json(env, obj) -> list:
    """Every rank's ``obj`` (any JSON-able value), on every rank, in
    rank order: one all-gather of the payload lengths, then one of the
    payloads as ``uint8`` padded to the longest — the standard
    variable-payload trick, shared by the metric and trace gathers.
    The tensors lie on the env's device (NCCL reads only the card).
    ``json_safe`` (not ``default=str``): a numpy-scalar value must
    arrive at the merge as a NUMBER on every rank — stringified values
    would max()/add lexicographically or crash on mixed types."""
    import numpy as np
    import torch

    from cylon_tpu_torch.telemetry.export import json_safe

    dev = env.device
    payload = json.dumps(json_safe(obj), allow_nan=False).encode()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    sizes = env.comm.all_gather(n).reshape(-1).cpu().tolist()
    cap = max(int(s) for s in sizes)
    buf = np.zeros(cap, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    got = env.comm.all_gather(torch.from_numpy(buf).to(dev))
    rows = got.reshape(env.world_size, cap).cpu().numpy()
    return [json.loads(bytes(row[:int(size)]).decode())
            for row, size in zip(rows, sizes)]


def gather_traces(env=None, events: "list | None" = None) -> list:
    """Every rank's flight-recorder buffer, on every rank: a list of
    ``{"rank", "world", "clock_offset", "events"}`` dicts ready for
    :func:`cylon_tpu_torch.telemetry.trace.merge_timelines` or the
    Chrome exporter.

    One process: the local buffer, split into one buffer a rank by each
    event's ``"rank"`` stamp (:func:`~cylon_tpu_torch.telemetry.trace.rank_scope`;
    the ``ThreadWorld`` ranks share the recorder); an unstamped event
    belongs to the env's rank (0 without an env). No collective. Ranks
    as processes: one :func:`_allgather_json` round of the buffers;
    ``clock_offset`` is the env's barrier-anchored wall-clock offset
    (:meth:`cylon_tpu_torch.context.CylonEnv.clock_offset`) so merged
    timelines line up across hosts. A collective then: every rank must
    call it."""
    from cylon_tpu_torch.telemetry import trace

    evts = trace.events() if events is None else events
    world = env.world_size if env is not None else 1
    me = env.rank if env is not None else 0
    if _gathers(env):
        local = {"rank": me, "world": world,
                 "clock_offset": float(env.clock_offset()),
                 "events": evts}
        return _allgather_json(env, local)
    by_rank: "dict[int, list]" = {}
    for e in evts:
        by_rank.setdefault(e.get("rank", me), []).append(e)
    if not by_rank:
        by_rank[me] = []
    return [{"rank": r, "world": max(world, len(by_rank)),
             "clock_offset": 0.0, "events": by_rank[r]}
            for r in sorted(by_rank)]
