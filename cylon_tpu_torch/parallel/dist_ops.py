"""Distributed join: partition -> exchange -> local join, on every rank.

Port of ``cylon_tpu/parallel/dist_ops.py:850-947`` with its capacity
defaults (``:254-269``), its regrow-on-overflow loop (``:313-400``) and
its prepare step (``:880-899``), parity ``DistributedJoin``
(``table.cpp:476``). Each rank calls :func:`dist_join` on its own shards
(see :func:`cylon_tpu_torch.parallel.dtable.scatter_table`).
"""

from cylon_tpu_torch.errors import OutOfCapacity
from cylon_tpu_torch.ops.hash import paired_validities, partition_ids
from cylon_tpu_torch.ops.join import _aligned_keys, join as _join_fn
from cylon_tpu_torch.parallel.dtable import shard_sizes, \
    world_layout_sized
from cylon_tpu_torch.parallel.shuffle import checked_recv, poison, \
    shuffle_local

#: default headroom factor for post-shuffle local buffers (hash
#: partitioning of uniform keys is balanced; skew beyond 2x should pass
#: an explicit out_capacity)
DEFAULT_SKEW = 2
#: the regrow ladder's top: capacities double up to this multiple of the
#: default before the overflow is raised
MAX_SCALE = 1024


def _out_cap_local(env, world_capacity: int, out_capacity=None,
                   skew=DEFAULT_SKEW, scale: int = 1) -> int:
    """A rank's receive buffer: ``out_capacity`` split over the ranks, or
    by default the ranks' mean capacity (the JAX package's local
    capacity; ranks that ingest their own rows hold different ones, an
    empty shard none) times the skew headroom and the regrow scale."""
    w = env.world_size
    if out_capacity is not None:
        return -(-out_capacity // w)
    return -(-world_capacity // w) * skew * scale


def _partition_keys(lt, rt, left_on, right_on):
    """Key columns and validities for partition hashing, the masks paired
    (:func:`cylon_tpu_torch.ops.hash.paired_validities`) so that equal
    keys reach the same rank. Keys are in one layout on every rank by
    then (:func:`dist_join`'s prepare step), so dictionary keys hash by
    their codes, as in the JAX package's ``_key_data``."""
    lkeys = [lt.column(c).data for c in left_on]
    rkeys = [rt.column(c).data for c in right_on]
    lvals, rvals = paired_validities(
        lkeys, [lt.column(c).validity for c in left_on],
        rkeys, [rt.column(c).validity for c in right_on])
    return lkeys, lvals, rkeys, rvals


def _shard_fit(env, table) -> tuple:
    """``(fits, counts)``: whether every rank's row count is within that
    rank's capacity, and the counts. Every rank takes the same decision."""
    counts, caps = shard_sizes(env, table)
    return all(c <= k for c, k in zip(counts, caps)), counts


def _adaptive(env, build, args, adaptive: bool):
    """Run ``build(scale)(*args)``, doubling the default capacities while
    any rank overflowed (every bound defaulted: ``adaptive``). Explicit
    capacities keep the raise-on-overflow contract: their overflow shows
    in ``nrows`` and ``num_rows`` raises."""
    scale = 1
    while True:
        out = build(scale)(*args)
        if not adaptive:
            return out
        fits, counts = _shard_fit(env, out)
        if fits:
            return out
        for t in args:
            t_fits, tc = _shard_fit(env, t)
            if not t_fits:
                raise OutOfCapacity(
                    f"input shard row counts {tc} exceed their "
                    "capacities: an upstream op overflowed an explicit "
                    "out_capacity")
        if scale >= MAX_SCALE:
            raise OutOfCapacity(
                f"shard row counts {counts} still exceed their local "
                f"capacities at {scale}x the default budget; pass an "
                "explicit out_capacity")
        scale *= 2


def dist_join(env, left, right, *, on=None, left_on=None, right_on=None,
              how: str = "inner", suffixes=("_x", "_y"),
              out_capacity: "int | None" = None,
              shuffle_capacity: "int | None" = None,
              algorithm: str = "sort"):
    """Distributed equi-join of this rank's shards ``left`` and ``right``
    (parity: ``DistributedJoin``, table.cpp:476): shuffle both by key
    hash, then join locally (``ordered=False``, as every shard of the JAX
    package runs it). A world of one short-circuits to the local join,
    like the reference's ``world==1`` branch (table.cpp:481).

    ``algorithm`` routes each rank's local join as ``join`` does. The JAX
    package checks the bucketed route's chains in-graph (``lax.cond``,
    its traced "hash_guarded" route); the port runs eagerly, so each rank
    checks its own build side on the host before its local join, as the
    eager "hash_bucketed" route does, and an overflowing rank takes the
    sort join alone."""
    if on is not None:
        left_on = right_on = [on] if isinstance(on, str) else list(on)
    else:
        left_on = [left_on] if isinstance(left_on, str) else list(left_on)
        right_on = [right_on] if isinstance(right_on, str) \
            else list(right_on)

    if env.world_size == 1:
        def build1(scale):
            cap = out_capacity if out_capacity is not None \
                else (left.capacity + right.capacity) * scale

            def run(lt, rt):
                return _join_fn(lt, rt, left_on=left_on, right_on=right_on,
                                how=how, suffixes=suffixes,
                                out_capacity=cap, algorithm=algorithm,
                                ordered=False)
            return run

        return _adaptive(env, build1, (left, right), out_capacity is None)

    # prepare, before any rows move: each table in one layout on every
    # rank (world_layout: bytes widths, validity masks and dictionaries,
    # which differ where ranks ingested their own rows), so that the
    # exchanged rows line up and their codes keep their strings; then the
    # key columns of both sides in one layout (bytes at one width,
    # dictionaries unified), so the codes co-locate equal keys and the
    # local joins' alignment is a no-op
    left, lcaps = world_layout_sized(env, left)
    right, rcaps = world_layout_sized(env, right)
    left, right = _aligned_keys(left, right, left_on, right_on)
    w = env.world_size
    comm = env.comm
    caps = [sum(lcaps), sum(rcaps)]

    def build(scale):
        shuf_l = _out_cap_local(env, caps[0], shuffle_capacity,
                                scale=scale)
        shuf_r = _out_cap_local(env, caps[1], shuffle_capacity,
                                scale=scale)
        join_l = shuf_l + shuf_r if out_capacity is None \
            else -(-out_capacity // w)

        def run(lt, rt):
            # clamped shards + the overflow flags an upstream bounded op
            # carried in (nrows == capacity + 1)
            ltab, liof = checked_recv(lt, lt.capacity)
            rtab, riof = checked_recv(rt, rt.capacity)
            lkeys, lvals, rkeys, rvals = _partition_keys(ltab, rtab, left_on,
                                                         right_on)
            lpid = partition_ids(lkeys, w, lvals)
            rpid = partition_ids(rkeys, w, rvals)
            lsh, lof = checked_recv(shuffle_local(comm, ltab, lpid, shuf_l),
                                    shuf_l)
            rsh, rof = checked_recv(shuffle_local(comm, rtab, rpid, shuf_r),
                                    shuf_r)
            res = _join_fn(lsh, rsh, left_on=left_on, right_on=right_on,
                           how=how, suffixes=suffixes, out_capacity=join_l,
                           algorithm=algorithm, ordered=False)
            return poison(res, liof, riof, lof, rof)
        return run

    adaptive = out_capacity is None and shuffle_capacity is None
    return _adaptive(env, build, (left, right), adaptive)
