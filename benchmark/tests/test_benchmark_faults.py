"""A whole run but the look for a card, on the CPU at a tiny size: sound,
it comes out correct; with the timed path broken underneath it, or with
the control (the reference in its ``control_precision``) in the
program's place, it comes out not correct. The faults a cell can have here: an answer altered
where it is produced, and half of the rows left out. (No state carries
from step to step and no exchange runs at a world of one.)"""

import pytest

from benchmark import run
from benchmark.harness import cell as cells

CELLS = ["join_16m.sort", "tpch_sf10.captured", "join_16m.hash",
         "tpch_sf10.eager"]


def measure(name, tiny, monkeypatch, fault=None, control=False):
    c = cells.resolve(name, False)
    c.config.update(tiny[name])
    for k, v in c.traffic.get("env", {}).items():
        monkeypatch.setenv(k, v)
    if fault is not None:
        op = c.kind.Workload.op
        monkeypatch.setattr(c.kind.Workload, "op",
                            lambda self, i: fault(op(self, i)))
    return run.measure(c, 2**31 + 17, 0.3, False, "cpu", control=control)


def table_of(result):
    return result.table if hasattr(result, "table") else result


def altered(result):
    """One value of the first float column changed where it is made."""
    t = table_of(result)
    col = next(c for c in t.columns.values()
               if c.data.is_floating_point())
    col.data[0] = col.data[0] * (1 + 1e-6) + 1e-6
    return result


def halved(result):
    """Half the result's rows left out."""
    import cylon_tpu_torch as ct

    t = table_of(result)
    half = t.with_nrows(max(t.num_rows // 2, 0))
    return ct.DataFrame(half) if hasattr(result, "table") else half


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny, monkeypatch):
    out = measure(name, tiny, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [altered, halved])
def test_broken_timed_path_is_not_correct(name, fault, tiny, monkeypatch):
    out = measure(name, tiny, monkeypatch, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny, monkeypatch):
    out = measure(name, tiny, monkeypatch, control=True)
    assert not out["correct"], out["checks"]
