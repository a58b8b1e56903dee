"""A cell of ``BENCHMARK.json``, resolved by name to its files:

- ``configs[].file``: the configuration (JSON); its ``"kind"`` names
  ``benchmark/kinds/<kind>.py``;
- ``benchmark/traffic/<traffic>.json``: the traffic mix;
- ``benchmark/reference/<config>.py``: the configuration's reference;
- ``benchmark/metrics/<metric>.py``: one reader a metric, for the cell's
  end-to-end metrics (``--trace 0``) or its per-layer ones (``--trace 1``):
  every metric whose ``workloads`` names the cell, or that has none.

A later cell, configuration, mix or metric is files and entries added;
nothing here names one.
"""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path):
    """The Python file ``path`` as a module (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "benchmark_" + re.sub(r"\W", "_", path.relative_to(
        BENCH_DIR).with_suffix("").as_posix())
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    kind: object
    reference: object
    #: ``[(BENCHMARK.json entry, reader module)]``
    metrics: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, trace: bool, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    metrics = [(m, load_module(BENCH_DIR / "metrics" / f"{m['name']}.py"))
               for m in bench["per_layer" if trace else "end_to_end"]
               if applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                kind=load_module(BENCH_DIR / "kinds" /
                                 f"{config['kind']}.py"),
                reference=load_module(BENCH_DIR / "reference" /
                                      f"{w['config']}.py"),
                metrics=metrics)
