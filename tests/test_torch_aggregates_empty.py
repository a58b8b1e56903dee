"""Scalar aggregates of tables with no row (ROADMAP C7).

At capacity 0 the JAX package's ``table_aggregate`` and
``dist_aggregate`` raise (``ValueError`` for min and max, ``IndexError``
for median and nunique), so the port is held against what both packages
give for a table of capacity 8 with no valid row: the identities of min
and max (the dtype's max and min, ±inf for floats), 0 for sum, count
and nunique, 0.0 for mean, var and std, NaN for the median. Locally, and
at W = 4 with every shard empty.

One difference stays: the JAX package's ``dist_aggregate(...,
"median")`` of a world with no valid row gives -inf, where its
``table_aggregate`` and pandas give NaN; the port gives NaN in both.
"""

import numpy as np
import pytest
import torch

import cylon_tpu_torch as ct

OPS = ("min", "max", "sum", "mean", "var", "std", "median", "nunique",
       "count")
DTYPES = (np.int64, np.float64, np.int32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)       # NaN equals NaN


def _empty(dt, cap):
    t = ct.Table.from_pydict({"x": np.arange(cap, dtype=dt)}, device="cpu")
    return t.with_nrows(torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("op", OPS)
def test_capacity_zero_aggregate_is_the_jax_capacity8_empty_result(op, dt):
    import cylon_tpu as jct
    from cylon_tpu.ops.aggregates import table_aggregate as jagg

    want = np.asarray(jagg(jct.Table.from_pydict(
        {"x": np.arange(8, dtype=dt)}).with_nrows(0), "x", op))
    zero = ct.Table.from_pydict({"x": np.zeros(0, dtype=dt)}, device="cpu")
    assert zero.capacity == 0
    _same(ct.table_aggregate(zero, "x", op).numpy(), want)
    _same(ct.table_aggregate(_empty(dt, 8), "x", op).numpy(), want)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d.__name__)
def test_w4_every_shard_empty_is_the_jax_capacity8_empty_result(env4, dt):
    import cylon_tpu as jct
    from cylon_tpu.ops.aggregates import table_aggregate as jagg
    from cylon_tpu.parallel import dist_aggregate as jdist_aggregate
    from cylon_tpu.parallel import scatter_table as jscatter

    jt = jct.Table.from_pydict({"x": np.arange(8, dtype=dt)}).with_nrows(0)
    want = {}
    for op in OPS:
        # the JAX package's distributed median of nothing is -inf; its
        # local median, like pandas', is NaN: the port gives NaN
        want[op] = np.asarray(jagg(jt, "x", op)) if op == "median" \
            else np.asarray(jdist_aggregate(env4, jscatter(env4, jt), "x",
                                            op))

    def rank(comm):
        env = ct.CylonEnv(comm, device="cpu")
        zero = ct.Table.from_pydict({"x": np.zeros(0, dtype=dt)},
                                    device="cpu")
        return {op: ct.dist_aggregate(env, zero, "x", op).numpy()
                for op in OPS}

    for got in ct.ThreadWorld(4).run(rank):
        for op in OPS:
            _same(got[op], want[op])
