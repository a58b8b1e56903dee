"""A TPC-H configuration: two batches of the tables resident on the
device, and the traffic's queries over them in a fixed cycle.

Config keys: ``scale_factor``, ``columns_read`` (each query's columns by
table: the generator's keep sets and the roofline's bytes). Traffic keys:
``mode`` (``"captured"``: ``cylon_tpu_torch.tpch.compiled(q)``, one CUDA
graph a query; ``"eager"``: ``tpch.q3(frames)``), ``cycle`` (a list of
``[query, batch]``, batch ``"a"`` or ``"b"``), ``params`` (each query's
substitution parameters, dates as ISO strings).

Batch ``"b"`` is batch ``"a"``'s rows under a seeded permutation a table:
the same shapes and dictionaries, other data in every buffer. Every
call's result is kept (a few rows) and held to the reference's answer
for its query and batch.
"""

import torch

from benchmark.data import tpch as data


def _params(raw: dict) -> dict:
    """Dates as ISO strings -> the program's int32 days."""
    return {k: data.date_int(v) if isinstance(v, str) and v[:1].isdigit()
            else v for k, v in raw.items()}


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.cycle = [tuple(c) for c in traffic["cycle"]]
        self.params = {q: _params(p) for q, p in traffic["params"].items()}
        self.kept = {}
        self.rows = self.widths = self.fns = None

    def batches(self) -> dict:
        """The raw columns of both batches, ``{"a": ..., "b": ...}``."""
        a = data.generate(self.config, self.seed, self.device)
        b = data.permuted(a, data.permutations(a, self.seed, self.device))
        return {"a": a, "b": b}

    # -- the program ----------------------------------------------------
    def setup(self) -> None:
        """Both batches as the program's frames, the queries, and one pass
        over the cycle (captures, memos, the allocator's pools)."""
        import cylon_tpu_torch as ct
        from cylon_tpu_torch import dtypes, tpch
        from cylon_tpu_torch.column import Column, Dictionary

        raw = self.batches()
        self.rows = data.rows(raw["a"])
        self.widths = {c: t.element_size() for cols in raw["a"].values()
                       for c, t in cols.items()}
        dicts = {name: Dictionary(values)
                 for name, values in data.DICTS.items()}

        def column(name, t):
            if name in dicts:
                return Column(t, None, dtypes.string, dicts[name])
            return Column(t, None, dtypes.from_torch_dtype(t.dtype))

        def frames(batch):
            return tpch.ingest({
                table: ct.DataFrame(ct.Table(
                    {c: column(c, t) for c, t in cols.items()},
                    next(iter(cols.values())).shape[0]))
                for table, cols in batch.items()})

        self.frames = {b: frames(raw[b]) for b in ("a", "b")}
        del raw
        mode = self.traffic["mode"]
        if mode == "captured":
            self.fns = {q: tpch.compiled(q) for q, _ in self.cycle}
        elif mode == "eager":
            self.fns = {q: getattr(tpch, q) for q, _ in self.cycle}
        else:
            raise ValueError(f"unknown mode {mode!r}")
        for i in range(len(self.cycle)):
            self.op(i)

    def op(self, i: int):
        q, b = self.cycle[i % len(self.cycle)]
        return self.fns[q](self.frames[b], **self.params[q])

    def label(self, i: int) -> str:
        return "%s.%s" % self.cycle[i % len(self.cycle)]

    def keep(self, i: int, result) -> None:
        self.kept[i] = result

    def rows_of(self, result) -> dict:
        """A program result as host arrays by column."""
        if isinstance(result, dict):
            return result
        frame = result.to_pandas()
        return {c: frame[c].tolist() if frame[c].dtype == object
                else frame[c].to_numpy() for c in frame.columns}

    def least_bytes(self, i: int) -> int:
        """What a call must move at the least: each column its query reads,
        read once, and its result written once."""
        q, _ = self.cycle[i % len(self.cycle)]
        read = sum(self.rows[t] * self.widths[c]
                   for t, cols in self.config["columns_read"][q].items()
                   for c in cols)
        out = self.kept[i]
        return read if isinstance(out, dict) else read + out_bytes(out.table)

    def release(self) -> None:
        """Let the program's state go; the kept results stay, on the
        host."""
        self.kept = {i: self.rows_of(r) for i, r in self.kept.items()}
        if self.fns is not None:
            from cylon_tpu_torch import plan

            self.frames = self.fns = None
            plan.release_shared_graphs()

    # -- the check ------------------------------------------------------
    def control_op(self, reference, control_dtype):
        """The reference, in ``control_dtype``, in the program's place."""
        raw = self.batches()

        def run(i):
            q, b = self.cycle[i % len(self.cycle)]
            return reference.answer(q, raw[b], data.DICTS, self.params[q],
                                    control_dtype)
        return run

    def check(self, reference) -> "tuple[dict, int]":
        """Every kept result against the reference's answer for its query
        and batch: the worst of each number, and how many calls failed."""
        raw = self.batches()
        want = {}
        for q, b in self.cycle:
            if (q, b) not in want:
                want[q, b] = reference.answer(q, raw[b], data.DICTS,
                                              self.params[q])
        del raw
        worst, failed = {}, 0
        for i in sorted(self.kept):
            key = self.cycle[i % len(self.cycle)]
            numbers = reference.compare(key[0], self.kept[i], want[key])
            failed += any(v > self.config["limits"][k]
                          for k, v in numbers.items())
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, v), v)
        return worst, failed


def out_bytes(table) -> int:
    """Bytes of a program result's rows, every column at its width."""
    n = table.num_rows
    return sum(n * c.data[:1].element_size() * max(1, c.data[0].numel())
               for c in table.columns.values()) if n else 0
