"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repo (about a minute on the CPU). Tests marked ``card``
need a CUDA card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture
def tiny():
    """``(cell name -> config override)``: the cells at a size the CPU
    runs in a second."""
    join = {"rows_per_side": 4096,
            "key": {"distribution": "uniform", "domain": 4096}}
    return {"join_16m.sort": join, "join_16m.hash": join,
            "tpch_sf10.captured": {"scale_factor": 0.01},
            "tpch_sf10.eager": {"scale_factor": 0.01}}
