"""Plain PyTorch reference of the ``join_16m`` configuration: an inner
equi-join of two tables on one int64 key, every matching pair once.

``join`` sorts the right keys, finds each left key's run of equal right
keys with two binary searches, and expands the runs into row pairs.
``compare`` puts both results in one canonical row order (key, then the
values' bits) and counts the rows that differ. Imports torch alone.
"""

import torch


def join(left, right, dtype=torch.float64) -> dict:
    """``left``, ``right``: ``(keys, [value columns])``. Returns
    ``{"k": keys, "left": [values...], "right": [values...]}``, one row a
    matching pair. The values are computed in ``dtype`` and returned as
    float64 (float32 is the control: the values a float32 join would
    hand back)."""
    lk, lvals = left
    rk, rvals = right
    rsorted, rperm = torch.sort(rk, stable=True)
    lo = torch.searchsorted(rsorted, lk, side="left")
    hi = torch.searchsorted(rsorted, lk, side="right")
    counts = hi - lo
    li = torch.repeat_interleave(
        torch.arange(lk.shape[0], device=lk.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(li.shape[0], device=lk.device) - starts[li] + lo[li]
    ri = rperm[pos]

    def cast(v):
        return v.to(dtype).to(torch.float64)

    return {"k": lk[li], "left": [cast(v)[li] for v in lvals],
            "right": [cast(v)[ri] for v in rvals]}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64) if t.is_floating_point() else t


def canonical(result: dict) -> list:
    """The result's columns (key, left values, right values) as int64 bit
    patterns, rows sorted by all of them: an order that depends on the
    rows alone."""
    cols = [_bits(result["k"])] + [_bits(v) for v in result["left"]] \
        + [_bits(v) for v in result["right"]]
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.sort(c[order], stable=True)[1]]
    return [c[order] for c in cols]


def compare(got: dict, want: dict) -> dict:
    """``{"rows_off": n}``: the rows one result has and the other has not,
    bit for bit (the difference in row counts, plus the rows that differ
    when both are in canonical order). 0 when the results are equal."""
    g, w = canonical(got), canonical(want)
    n = min(g[0].shape[0], w[0].shape[0])
    differ = torch.zeros(n, dtype=torch.bool, device=g[0].device)
    for a, b in zip(g, w):
        differ |= a[:n] != b[:n]
    off = abs(g[0].shape[0] - w[0].shape[0]) + int(differ.sum())
    return {"rows_off": off}
