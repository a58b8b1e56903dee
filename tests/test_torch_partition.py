"""The port's partitioning and calendar fields against the JAX
package's: ``assign_partitions`` bit for bit in its three modes (hash on
nullable, float and string keys in both storages, modulo, round robin),
``split_by_partition`` and ``partition_table`` element for element,
with a partition past ``out_capacity`` poisoned; ``civil_from_days``
and its fields over days before 1970 and across leap years.
"""

import datetime

import numpy as np
import pytest
import torch

import cylon_tpu as jct
import cylon_tpu_torch as ct
from cylon_tpu.ops import datetime_ops as jdt
from cylon_tpu.ops import partition as jpart
from cylon_tpu_torch.ops import datetime_ops, partition
from tests.test_torch_setops import _frame
from tests.test_torch_sort import _cells, to_port


@pytest.mark.parametrize("storage", ["dict", "bytes"])
def test_assign_partitions_bit_for_bit(storage):
    df = _frame(21, 90).assign(m=np.arange(-45, 45))
    jt = jct.Table.from_pandas(df, capacity=96, string_storage=storage)
    tt = to_port(jt)
    for cols, mode in ((["k"], "hash"), (["s", "f"], "hash"),
                       (["m"], "modulo"), (["k"], "round_robin")):
        for nparts in (1, 3, 4):
            got = partition.assign_partitions(tt, cols, nparts, mode)
            want = np.asarray(jpart.assign_partitions(jt, cols, nparts,
                                                      mode))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{cols} {mode} {nparts}")
    with pytest.raises(ct.InvalidArgument):
        partition.assign_partitions(tt, ["k"], 2, "range")
    assert partition.hash_partition_ids is ct.ops.hash.partition_ids
    np.testing.assert_array_equal(
        partition.round_robin_ids(10, 4, offset=3).numpy(),
        np.asarray(jpart.round_robin_ids(10, 4, offset=3)))


@pytest.mark.parametrize("mode", ["hash", "round_robin"])
def test_split_and_partition_table_match_jax(mode):
    df = _frame(22, 70)
    jt = jct.Table.from_pandas(df, capacity=80, string_storage="bytes")
    tt = to_port(jt)
    got = partition.partition_table(tt, ["k", "s"], 3, mode)
    want = jpart.partition_table(jt, ["k", "s"], 3, mode)
    assert [g.capacity for g in got] == [80] * 3
    for g, w in zip(got, want):
        assert _cells(g.to_pandas()) == _cells(w.to_pandas())
    assert sum(g.num_rows for g in got) == 70
    # a bound below the largest partition poisons that one only
    big = max(g.num_rows for g in got)
    pid = partition.assign_partitions(tt, ["k", "s"], 3, mode)
    parts = partition.split_by_partition(tt, pid, 3, out_capacity=big - 1)
    jparts = jpart.split_by_partition(
        jt, jpart.assign_partitions(jt, ["k", "s"], 3, mode), 3,
        out_capacity=big - 1)
    for p, jp in zip(parts, jparts):
        assert p.capacity == big - 1
        assert int(p.nrows) == int(jp.nrows)
        if int(p.nrows) > p.capacity:
            with pytest.raises(ct.OutOfCapacity):
                p.num_rows
        else:
            assert _cells(p.to_pandas()) == _cells(jp.to_pandas())
    wide = partition.split_by_partition(tt, pid, 3, out_capacity=100)
    assert [w.capacity for w in wide] == [100] * 3
    assert [w.num_rows for w in wide] == [g.num_rows for g in got]


def test_calendar_fields_match_jax_and_python():
    days = np.concatenate([np.arange(-800, 800), np.arange(-719468, -719000),
                           [-1, 0, 59, 60, 365 * 30 + 7, 11016, 11017,
                            2932896]]).astype(np.int32)
    y, m, d = datetime_ops.civil_from_days(torch.from_numpy(days))
    jy, jm, jd = jdt.civil_from_days(days)
    for got, want in ((y, jy), (m, jm), (d, jd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    epoch = datetime.date(1970, 1, 1).toordinal()
    for i, day in enumerate(days.tolist()):
        if epoch + day >= 1:           # Python's calendar starts at year 1
            dt = datetime.date.fromordinal(epoch + day)
            assert (int(y[i]), int(m[i]), int(d[i])) == \
                (dt.year, dt.month, dt.day), day
    t = torch.from_numpy(days.astype(np.int64))
    assert torch.equal(datetime_ops.year_of(t), y)
    assert torch.equal(datetime_ops.month_of(t), m)
    assert torch.equal(datetime_ops.day_of(t), d)
    # 2000-02-29 and 1900-03-01 (1900 is no leap year)
    feb29 = (datetime.date(2000, 2, 29).toordinal() - epoch)
    mar1 = (datetime.date(1900, 3, 1).toordinal() - epoch)
    got = datetime_ops.civil_from_days(torch.tensor([feb29, mar1]))
    assert [g.tolist() for g in got] == [[2000, 1900], [2, 3], [29, 1]]
