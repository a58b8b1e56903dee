"""The two tables of a join configuration: an int64 key column and float64
value columns a side, made on the device from the seed in a few large
calls. The keys' distribution is a file of its own in ``keys/``."""

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer: it is
    taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def keys(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` int64 keys from ``benchmark/data/keys/<distribution>.py``,
    the file named by ``spec["distribution"]`` (a later distribution is a
    file added there)."""
    from benchmark.harness.cell import BENCH_DIR, load_module

    path = BENCH_DIR / "data" / "keys" / f"{spec['distribution']}.py"
    return load_module(path).draw(spec, n, gen, device)


def tables(config: dict, seed: int, device) -> dict:
    """``{"left": (keys, [values...]), "right": ...}`` for ``config``."""
    gen = generator(seed, device)
    n = int(config["rows_per_side"])
    out = {}
    for side in ("left", "right"):
        k = keys(config["key"], n, gen, device)
        vals = [torch.rand(n, dtype=torch.float64, device=device,
                           generator=gen)
                for _ in range(int(config["value_columns"]))]
        out[side] = (k, vals)
    return out
