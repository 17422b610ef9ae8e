"""The check against faults planted under the timed path: each run, at a tiny
size on the CPU (the look for a chip skipped), must come out not correct.
The faults are ``perfbench/tools/faults.py``'s: those every cell can have (a
step that returns its state unchanged; half of the batch left out and the
mean taken over the rest; an answer altered where it is produced) and those
of a cell's own sampler.  (Every cell runs on one chip: there is no exchange
between chips to leave out.)"""

import pytest

from perfbench.harness import cell, spec
from perfbench.tests import tiny
from perfbench.tools import faults

BENCH = spec.benchmark()
CASES = [(w["name"], f) for w in BENCH["workloads"] for f in faults.BY_CONFIG[w["config"]]]


def _run(cell_name):
    return cell.run_cell(cell_name, 2 ** 31 + 99, 0.5, False, device="cpu",
                         overrides=tiny.overrides(BENCH, cell_name))


def _failed_checks(result):
    return {n for n, c in result["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_fault_is_caught(monkeypatch, cell_name, fault):
    faults.plant(fault, spec.cell(cell_name, BENCH)["config"], monkeypatch.setattr)
    result = _run(cell_name)
    assert result["correct"] is False
    assert _failed_checks(result), result["checks"]


@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_sound_run_is_correct(cell_name):
    result = _run(cell_name)
    assert result["correct"] is True, result["checks"]
