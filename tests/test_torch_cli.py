"""The port's ``mnist-nuts`` CLI on the CPU: the config-3 pipeline on real
pixels (scikit-learn's digits) held to the assertions of the JAX package's
tests/test_nuts_batched.py::test_mnist_nuts_cli_digits_batched, its JSON
keys against the JAX CLI's batched path, and the options that are not
ported yet.  Imports no jax."""

import contextlib
import io
import json
import math
import os
import tomllib

import pytest
import torch

from dropout_hamiltonian_montecarlo_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of the JAX CLI's batched ``mnist-nuts`` line (cli.py:400-404,
# :450-453, :461-470, :575-584; no compile_s on that path)
JAX_KEYS = {
    "min_ess", "median_ess", "max_rhat", "min_ess_per_sec", "median_ess_per_sec",
    "diag_s", "run_s", "sampler", "warmup_s", "chain_shards", "resumed",
    "draws_per_sec", "mean_tree_depth", "mean_leaves_per_draw", "mean_acceptance",
    "divergent_frac", "workload", "train_accuracy", "metric", "setup_s",
    "setup_from_cache", "dataset", "predictive_accuracy", "predictive_ece",
    "predictive_nll",
}


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def one_thread():
    """Thousands of tiny ops: one intra-op thread is as fast alone and does
    not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mnist_nuts_cli_digits_on_cpu(one_thread):
    agg = _run(["mnist-nuts", "--dataset", "digits", "--chains", "4", "--samples", "30",
                "--warmup", "50", "--max-depth", "5", "--device", "cpu"])
    assert set(agg) == JAX_KEYS | {"device"}
    assert agg["device"] == "cpu"
    assert agg["sampler"] == "batched-nuts"
    assert agg["dataset"] == "sklearn-digits"
    assert agg["metric"] == "kron-gauss-newton"
    assert agg["train_accuracy"] > 0.9
    assert agg["predictive_accuracy"] > 0.9
    assert agg["mean_tree_depth"] >= 1.0
    assert agg["divergent_frac"] < 0.05
    assert agg["mean_leaves_per_draw"] <= 2 ** 5 - 1
    assert math.isfinite(agg["max_rhat"]) and 0 < agg["min_ess"] <= agg["median_ess"] <= 4 * 30


@pytest.mark.parametrize("extra, item", [
    (["--save", "draws.h5"], "slice 5"),
    (["--stream-chunk", "10"], "slice 5"),
    (["--checkpoint", "ck.npz"], "slice 5"),
    (["--resume"], "slice 5"),
    (["--chain-shards", "2"], "slice 5"),
    (["--diag-mass"], "slice 3"),
    (["--per-chain-nuts"], "slice 3"),
    (["--data", "mnist.h5"], "slice 5"),
], ids=["save", "stream-chunk", "checkpoint", "resume", "chain-shards", "diag-mass",
        "per-chain-nuts", "data"])
def test_cli_unported_options_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"not ported yet \\(ROADMAP {item}\\)"):
        cli.main(["mnist-nuts", "--device", "cpu"] + extra)


def test_cli_cuda_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["mnist-nuts", "--dataset", "digits"])


def test_console_script_and_package_discovery():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    assert scripts["dhmc-torch"] == "dropout_hamiltonian_montecarlo_tpu_torch.cli:main"
    # the discovery glob ships the port's package beside the JAX one
    (pattern,) = project["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "dropout_hamiltonian_montecarlo_tpu_torch".startswith(pattern.rstrip("*"))
