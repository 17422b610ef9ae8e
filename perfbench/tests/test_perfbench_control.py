"""The control on the card: the program's own lower-precision path (TF32
matmuls and, in the softmax cells, the plain value+grad in place of the
kernel) must come out not correct, and the program as its configuration
states it correct, on the same seed.  At the cells' widths and data, with
fewer chains and a shorter warmup, so that a test run holds it.

    python -m pytest perfbench/tests/test_perfbench_control.py -m gpu -q"""

import pytest
import torch

from perfbench.harness import cell, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALLER = {"softmax-mnist": {"chains": 32, "warmup_steps": 100},
           "mlp-dropout-mnist": {"chains": 16}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 exists only there")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes(card, cell_name):
    config = spec.cell(cell_name, BENCH)["config"]
    overrides = {"traffic": SMALLER[config]}
    sound = cell.run_cell(cell_name, 3 * 10 ** 9 + 17, 3.0, False, overrides=overrides)
    control = cell.run_cell(cell_name, 3 * 10 ** 9 + 17, 3.0, False, overrides=overrides,
                            control=True)
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
