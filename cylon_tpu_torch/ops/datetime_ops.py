"""Calendar fields of ordinal dates, on the device.

Port of ``cylon_tpu/ops/datetime_ops.py``. Dates are int32 days since
1970-01-01; TPC-H's Q7, Q8 and Q9 group by the year, so the decode runs
elementwise beside the group-by. The algorithm is Howard Hinnant's
``civil_from_days`` (public domain): integer floor divisions and one
select, no table and no host round trip.
"""

import torch


def civil_from_days(days: torch.Tensor):
    """Days since 1970 -> ``(year, month, day)`` as int32 tensors, exact
    in the proleptic Gregorian calendar (port of
    ``cylon_tpu/ops/datetime_ops.py:20``); any integer dtype in,
    computed in int32 with floor divisions (negative days before
    1970)."""
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097                                   # [0, 146096]
    yoe = torch.div(doe - doe // 1460 + doe // 36524 - doe // 146096, 365,
                    rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    return torch.where(m <= 2, y + 1, y), m, d


def year_of(days: torch.Tensor) -> torch.Tensor:
    """EXTRACT(YEAR FROM date) (port of
    ``cylon_tpu/ops/datetime_ops.py:39``)."""
    return civil_from_days(days)[0]


def month_of(days: torch.Tensor) -> torch.Tensor:
    """EXTRACT(MONTH FROM date) (port of
    ``cylon_tpu/ops/datetime_ops.py:45``)."""
    return civil_from_days(days)[1]


def day_of(days: torch.Tensor) -> torch.Tensor:
    """EXTRACT(DAY FROM date) (port of
    ``cylon_tpu/ops/datetime_ops.py:51``)."""
    return civil_from_days(days)[2]
