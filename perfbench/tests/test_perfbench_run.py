"""run.py and run_cell end to end at a tiny size on the CPU, and what the
harness loads."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import cell, spec
from perfbench.tests import tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_run_without_a_card_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                          CELLS[0], "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.harness import cell\n"
            "print(cell.run_cell(%r, 7, 0.1, False, device='cpu'))\n" % (str(tmp_path), CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "dropout_hamiltonian_montecarlo_tpu_torch" in out.stderr


def test_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import cell, spec, whitened\n"
        "for kind, names in (('mixes', ['hmc', 'nuts', 'sghmc']),\n"
        "                    ('reference', ['softmax-mnist', 'mlp-dropout-mnist'])):\n"
        "    for n in names: spec.load_module(kind, n)\n"
        "for m in spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']:\n"
        "    spec.load_module('metrics', m['name'])\n"
        "import dropout_hamiltonian_montecarlo_tpu_torch.inference.sgmcmc\n"
        "sys.path.insert(0, %r)\n"
        "import run\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n" % (str(spec.ROOT), str(spec.BENCH_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    top, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    names = eval(top)
    for bad in ("jax", "jaxlib", "flax", "dropout_hamiltonian_montecarlo_tpu"):
        assert bad not in names


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.harness import spec\n"
            "spec.load_module('reference', 'softmax-mnist')\n"
            "spec.load_module('reference', 'mlp-dropout-mnist')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "dropout_hamiltonian_montecarlo_tpu_torch" not in out.stdout


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell_name", CELLS)
def test_window_and_result_line(cell_name, trace):
    result = cell.run_cell(cell_name, 2 ** 32 + 11, 0.5, bool(trace), device="cpu",
                           overrides=tiny.overrides(BENCH, cell_name))
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert json.loads(json.dumps(result)) == result
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    field = "per_layer" if trace else "end_to_end"
    reported = set(result["metrics"])
    wanted = {m["name"] for m in spec.metrics_for(cell_name, field, BENCH)}
    assert reported <= wanted
    if not trace:
        assert reported == wanted
    else:
        # the CPU trace has no device events: only the device readers stay silent
        assert wanted - reported <= {"vag_roofline", "device.idle_share",
                                     "mlp.launches_per_step"}
        assert "busy_s" in result["device"] and "breakdown" in result
    for name, c in result["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"], name
