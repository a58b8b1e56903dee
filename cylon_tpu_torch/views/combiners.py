"""Delta-merge algebra for incremental view maintenance.

Port of ``cylon_tpu/views/combiners.py``: host pandas code on the port's
:func:`cylon_tpu_torch.fallback._merge_partials` and
:data:`cylon_tpu_torch.tpch.twophase.PLANS`.

The observation this subsystem is built on: the
fallback layer's partial-merge combiners
(:func:`cylon_tpu_torch.fallback._merge_partials` and the two-phase plans in
:mod:`cylon_tpu_torch.tpch.twophase`) are *delta-apply operators*. A merge
spec that recombines per-partition partials of a hash-partitioned run
recombines, for exactly the same algebraic reason, a resident result
with the result of the SAME query run on an appended delta:

* ``merge == "sum"`` — a scalar aggregate: state' = state + delta.
* ``merge == "groupby"`` — associative re-aggregation (sum/min/max)
  plus count-weighted means (``("wmean", weight_col)``): groups
  present in both sides re-aggregate, new groups appear.
* ``merge == "concat"`` — order-refining plans whose output rows each
  derive from one partition-closed key group (e.g. q3's per-order
  revenue, partitioned by orderkey): concat + stable resort. The view
  keeps its state UNTRUNCATED (the query's row limit re-applies at
  read time via :func:`present`), so the merge is exact even for
  top-k queries.
* ``merge == "twophase"`` — global-scalar plans: the view's state is
  the *associative phase-1 partial* (sum/count pairs, per-group sums),
  combined by :func:`combine_partials` and only finalized into the
  blocking scalar at read time by :func:`finalize_twophase`.

Exactness contract (documented per-query in ``docs/views.md``): a
delta must be **partition-closed** for the spec's partition keys —
every key group lands entirely in the base or entirely in one delta.
TPC-H's RF1 refresh stream satisfies this by construction (new orders
arrive with all their lineitems).
"""

import numpy as np
import pandas as pd

from cylon_tpu_torch.errors import InvalidArgument

__all__ = ["merge_delta", "present", "combine_partials",
           "finalize_twophase", "TWOPHASE_COMBINE_BY"]


def merge_delta(state, delta_partial, spec: dict):
    """Fold one delta partial into a view's resident state per the
    manifest merge spec — :func:`fallback._merge_partials` run over
    ``[state, delta_partial]`` with NO row limit (state stays
    untruncated; :func:`present` re-applies the query's limit), or the
    scalar/two-phase combine for those kinds. Either side may be
    ``None`` (an empty base or an all-filtered delta).

    (``cylon_tpu/views/combiners.py`` ``merge_delta``)"""
    from cylon_tpu_torch.fallback import _merge_partials

    kind = spec["merge"]
    if kind == "twophase":
        return combine_partials(spec["query"],
                                [state, delta_partial])
    return _merge_partials([state, delta_partial], spec, None)


def present(state, spec: dict, limit=None):
    """The client-visible result of a view state: the spec's stable
    sort plus the query's row limit. Scalar states pass through. The
    state itself is never truncated — only its presentation.

    (``cylon_tpu/views/combiners.py`` ``present``)"""
    if state is None or isinstance(state, float):
        return state
    if spec["merge"] == "twophase":
        return finalize_twophase(spec["query"], state)
    df = state
    sort = spec.get("sort")
    if sort:
        df = df.sort_values(
            sort, ascending=spec.get("ascending", [True] * len(sort)),
            kind="stable", ignore_index=True)
    if limit is not None:
        df = df.head(int(limit))
    return df.reset_index(drop=True)


#: two-phase queries whose phase-1 partial is view-maintainable, and
#: the group keys their partials re-combine under (``None`` = a
#: single-row frame of associative sums). Plans with a phase-2 apply
#: pass (q11/q15/q22) need their base tables at finalize time and are
#: NOT maintainable from the partial alone — absent here on purpose.
#: q16's partial is exact only for supplier-closed deltas (its
#: COUNT(DISTINCT) dedups inside one partial) — see docs/views.md.
TWOPHASE_COMBINE_BY: "dict[str, list | None]" = {
    "q8": ["o_year"],
    "q14": None,
    "q16": ["p_brand", "p_type", "p_size"],
}


def combine_partials(query: str, partials: list):
    """Associatively combine two-phase phase-1 partials: column-wise
    sums for single-row scalar partials (q14's promo/total revenue),
    per-group re-aggregation for per-group partials (q8's per-year
    totals, q16's per-brand distinct counts).
    ``None``/empty entries (an empty base or delta) contribute
    nothing.

    (``cylon_tpu/views/combiners.py`` ``combine_partials``)"""
    by = TWOPHASE_COMBINE_BY.get(query)
    if query not in TWOPHASE_COMBINE_BY:
        raise InvalidArgument(
            f"{query!r} is not view-maintainable: its two-phase plan "
            "needs an apply pass over the base tables (maintainable: "
            f"{sorted(TWOPHASE_COMBINE_BY)})")
    fs = [f for f in partials if f is not None and len(f)]
    if not fs:
        return next((f for f in partials if f is not None), None)
    df = pd.concat(fs, ignore_index=True)
    if by is None:
        return pd.DataFrame([df.sum(axis=0)])
    return df.groupby(by, sort=False, as_index=False).sum()


def finalize_twophase(query: str, state, **params):
    """The blocking answer of a two-phase view from its combined
    associative state: the plan's global merge runs over the single
    combined partial, then its reduce unwraps the final scalar/frame
    (exactly the math the fallback executor journals as its merge
    unit).

    (``cylon_tpu/views/combiners.py`` ``finalize_twophase``)"""
    from cylon_tpu_torch.tpch.twophase import PLANS

    plan = PLANS[query]
    if plan.phase2 is not None:
        raise InvalidArgument(
            f"{query!r}: plans with a phase-2 apply pass are not "
            "incrementally maintainable as views")
    if state is None:
        state = pd.DataFrame()
    merged = plan.merge([state if len(state) else None], **params)
    return plan.reduce(merged, None, **params)
