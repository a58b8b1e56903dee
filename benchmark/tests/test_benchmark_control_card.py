"""On the card: the control (the reference in its ``control_precision``,
in the program's place) comes out not correct, and the program comes out correct, on
three seeds each, at a size a test run holds. The full-size readings
are made with ``python3 benchmark/run.py ... --control 1``."""

import pytest

from benchmark import run
from benchmark.harness import cell as cells

SIZES = {"join_16m.sort": {"rows_per_side": 1 << 20,
                           "key": {"distribution": "uniform",
                                   "domain": 1 << 20}},
         "tpch_sf10.captured": {"scale_factor": 0.5}}
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.card
@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes_on_the_card(name, seed, card):
    c = cells.resolve(name, False)
    c.config.update(SIZES[name])
    sound = run.measure(c, seed, 1.0, False, card, bandwidth=3.35e12)
    assert sound["correct"], sound["checks"]
    control = run.measure(c, seed, 1.0, False, card, control=True,
                          bandwidth=3.35e12)
    assert not control["correct"], control["checks"]
