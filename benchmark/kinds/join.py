"""A join configuration: two resident tables, one
``cylon_tpu_torch.dist_join`` a call.

Config keys: ``rows_per_side``, ``key`` (``benchmark.data.join.keys``),
``value_columns``, ``world`` (1), ``how``. Traffic keys: ``algorithm``
(``"sort"`` or ``"hash"``) and ``env`` (set before the program loads).

Every call joins the same tables, so every call's result is the same.
The check takes the result of one call drawn from the seed among the
first ``SAMPLE_FROM`` of the window (held on the device until the window
closes; the one result held beside each call's working set, from the
first call on) and holds it to the reference, row for row, bit for bit.
"""

import random

import torch

from benchmark.data import join as data

#: the call whose result is checked is drawn from the window's first
#: calls (a window holds hundreds)
SAMPLE_FROM = 32

#: the calls that warm up the join before the window
WARM_CALLS = 2


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.sample = random.Random(seed).randrange(SAMPLE_FROM)
        self.kept = {}
        self.rows_out = None

    def value_names(self) -> list:
        return [f"v{i}" for i in range(int(self.config["value_columns"]))]

    # -- the program ----------------------------------------------------
    def setup(self) -> None:
        """The tables on the device, the env, and the warm-up calls."""
        import cylon_tpu_torch as ct
        from cylon_tpu_torch import dtypes
        from cylon_tpu_torch.column import Column

        raw = data.tables(self.config, self.seed, self.device)

        def table(keys, values):
            cols = {"k": Column(keys, None, dtypes.int64)}
            for name, v in zip(self.value_names(), values):
                cols[name] = Column(v, None, dtypes.float64)
            return ct.Table(cols, keys.shape[0])

        self.left = table(*raw["left"])
        self.right = table(*raw["right"])
        del raw
        self.env = ct.CylonEnv(device=self.device)
        self._ct = ct
        for i in range(WARM_CALLS):
            self.op(i)

    def op(self, i: int):
        return self._ct.dist_join(self.env, self.left, self.right, on="k",
                                  how=self.config["how"],
                                  algorithm=self.traffic["algorithm"])

    def op_rows(self, i: int) -> int:
        """Input rows of a call: both sides."""
        return 2 * int(self.config["rows_per_side"])

    def label(self, i: int) -> str:
        return "join"

    def keep(self, i: int, result) -> None:
        """The sampled call's result; until it comes, the latest one (a
        window too short to reach the sample checks its last call)."""
        if i <= self.sample:
            self.kept = {i: result}

    def rows_of(self, result) -> dict:
        """A program result as the reference's columns, its rows only."""
        if isinstance(result, dict):
            return result
        n = result.num_rows
        names = self.value_names()
        return {"k": result.column("k").data[:n],
                "left": [result.column(f"{v}_x").data[:n] for v in names],
                "right": [result.column(f"{v}_y").data[:n] for v in names]}

    def least_bytes(self, i: int) -> int:
        """What a call must move at the least: both inputs read once, the
        result written once (key and both sides' values a row)."""
        width = 8 * (1 + int(self.config["value_columns"]))
        if self.rows_out is None:
            self.rows_out = self.rows_of(next(iter(self.kept.values())))[
                "k"].shape[0]
        return self.op_rows(i) * width \
            + self.rows_out * 8 * (1 + 2 * int(self.config["value_columns"]))

    def release(self) -> None:
        """Let the program's state go; the kept results stay, as plain
        tensors."""
        self.kept = {i: self.rows_of(r) for i, r in self.kept.items()}
        self.left = self.right = self.env = None

    # -- the check ------------------------------------------------------
    def inputs(self) -> dict:
        return data.tables(self.config, self.seed, self.device)

    def control_op(self, reference, control_dtype):
        """The reference, in ``control_dtype``, in the program's place."""
        raw = self.inputs()
        return lambda i: reference.join(raw["left"], raw["right"],
                                        control_dtype)

    def check(self, reference) -> "tuple[dict, int]":
        """The kept results against the reference: the numbers compared
        (the worst over the kept calls) and how many calls failed."""
        raw = self.inputs()
        want = reference.join(raw["left"], raw["right"])
        del raw
        worst, failed = {}, 0
        for i in sorted(self.kept):
            got = self.kept[i]
            numbers = reference.compare(got, want)
            failed += any(v > self.config["limits"][k]
                          for k, v in numbers.items())
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, v), v)
        return worst, failed
