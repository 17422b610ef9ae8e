"""The port's CLI on the CPU: the config-3 pipeline on real pixels
(scikit-learn's digits) held to the assertions of the JAX package's
tests/test_nuts_batched.py::test_mnist_nuts_cli_digits_batched, configs 1 and
2 and the per-chain ``mnist-nuts`` modes at small size, every JSON line's keys
against the JAX CLI's line of the same subcommand (without ``compile_s``:
the port compiles nothing), configs 4, 5 and 6 (``mnist-mlp-sgmcmc``,
``plantvillage-smc``, ``mnist-vi``) at tiny sizes, ``--data PATH`` on the four
subcommands that take it, and the options that lay a run over ranks, which
outside torchrun exit with the command to use.  Imports no jax."""

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


# the summarize() aggregate with elapsed seconds (JAX cli.py:141-143)
AGG_KEYS = {"min_ess", "median_ess", "max_rhat", "min_ess_per_sec", "median_ess_per_sec"}
# mvn-hmc (cli.py:170-175), logistic-hmc (:203-208), per-chain mnist-nuts
# (:547, :572-584)
MVN_KEYS = AGG_KEYS | {"workload", "run_s"}
LOGISTIC_KEYS = MVN_KEYS | {"test_accuracy"}
PER_CHAIN_KEYS = AGG_KEYS | {
    "run_s", "sampler", "workload", "train_accuracy", "metric", "setup_s", "setup_from_cache",
    "dataset", "predictive_accuracy", "predictive_ece", "predictive_nll",
}

# mnist-mlp-sgmcmc (JAX cli.py:756-780), mnist-vi (:851-863),
# plantvillage-smc (:935-950)
SGMCMC_KEYS = {
    "workload", "dataset", "dropout", "p_drop", "chains", "data_shards", "mc_dropout_accuracy",
    "train_accuracy", "predictive_accuracy", "predictive_ece", "predictive_nll", "min_ess",
    "median_ess", "max_rhat", "logdensity_ess", "logdensity_rhat", "predictive_trace_min_ess",
    "predictive_trace_median_ess", "predictive_trace_max_rhat", "sgd_init_steps", "sgd_init_s",
    "elapsed_s", "steps_per_sec",
}
VI_KEYS = {"workload", "dataset", "train_accuracy", "predictive_accuracy", "predictive_ece",
           "predictive_nll", "elbo_first_last", "num_steps", "elapsed_s", "steps_per_sec"}
SMC_KEYS = {"workload", "mutation", "shard_particles", "dataset", "predictive_accuracy",
            "predictive_ece", "train_accuracy", "num_stages", "log_evidence",
            "stage_acceptance_min", "stage_acceptance_max", "step_size_first_last", "elapsed_s"}


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


@pytest.mark.parametrize("extra", [[], ["--nuts"]], ids=["hmc", "nuts"])
def test_mvn_hmc_cli_on_cpu(one_thread, extra):
    agg = _run(["mvn-hmc", "--chains", "4", "--samples", "300", "--warmup", "200",
                "--device", "cpu"] + extra)
    assert set(agg) == MVN_KEYS | {"device"}
    assert agg["workload"] == "mvn-hmc" and agg["device"] == "cpu"
    assert agg["max_rhat"] < 1.05
    assert 300 < agg["min_ess"] <= agg["median_ess"]
    assert agg["min_ess_per_sec"] == pytest.approx(agg["min_ess"] / agg["run_s"], rel=0.05)


def test_logistic_hmc_cli_on_cpu(one_thread):
    agg = _run(["logistic-hmc", "--chains", "8", "--samples", "200", "--warmup", "150",
                "--device", "cpu"])
    assert set(agg) == LOGISTIC_KEYS | {"device"}
    assert agg["workload"] == "logistic-hmc"
    assert agg["test_accuracy"] >= 0.98
    assert agg["max_rhat"] < 1.05 and agg["min_ess"] > 0.25 * 8 * 200


@pytest.mark.parametrize("mode, metric", [("--per-chain-nuts", "kron-gauss-newton"),
                                          ("--diag-mass", "diag")],
                         ids=["per-chain-nuts", "diag-mass"])
def test_mnist_nuts_per_chain_modes_on_cpu(one_thread, mode, metric):
    """The two modes that run the per-chain kernel: with the Kronecker metric
    passed as ``metric=`` the chains start from the Laplace draw and stay at
    the mode's accuracy; with a diagonal mass they run (and need not mix)."""
    agg = _run(["mnist-nuts", "--dataset", "digits", "--chains", "4", "--samples", "30",
                "--warmup", "40", "--max-depth", "4", "--device", "cpu", mode])
    assert set(agg) == PER_CHAIN_KEYS | {"device"}
    assert agg["sampler"] == "per-chain-nuts" and agg["metric"] == metric
    assert agg["dataset"] == "sklearn-digits" and agg["setup_from_cache"] is False
    for key in ("min_ess", "median_ess", "max_rhat", "predictive_nll", "predictive_ece"):
        assert math.isfinite(agg[key]), key
    assert agg["train_accuracy"] > 0.9 and agg["predictive_accuracy"] > 0.9
    if mode == "--per-chain-nuts":
        assert agg["setup_s"] > 0 and agg["max_rhat"] < 1.5
    else:
        assert agg["setup_s"] == 0.0


@pytest.mark.parametrize("algorithm, p_drop", [("sghmc", "0.1"), ("sgld", "0.1"),
                                               ("sghmc", "0")],
                         ids=["sghmc", "sgld", "sghmc-no-dropout"])
def test_mnist_mlp_sgmcmc_cli_on_cpu(one_thread, algorithm, p_drop):
    """Config 4 at a narrow width (hidden 32, 3 chains, 400 SGD steps, 100
    sampler steps): the SGD warm start reaches the mode and the sampler keeps
    its accuracy."""
    step = "1e-5" if algorithm == "sghmc" else "1e-6"
    agg = _run(["mnist-mlp-sgmcmc", "--algorithm", algorithm, "--p-drop", p_drop, "--hidden",
                "32", "--batch-size", "128", "--num-steps", "100", "--burnin-steps", "40",
                "--collect-every", "10", "--sgd-init-steps", "400", "--chains", "3",
                "--step-size", step, "--device", "cpu"])
    assert set(agg) == SGMCMC_KEYS | {"device"}
    assert agg["workload"] == f"mnist-mlp-{algorithm}" and agg["device"] == "cpu"
    assert agg["dataset"] == "synthetic-mnist" and agg["chains"] == 3 and agg["data_shards"] == 1
    assert agg["dropout"] is (p_drop != "0")
    for key in ("train_accuracy", "predictive_accuracy"):
        assert agg[key] > 0.9, key
    if p_drop == "0":
        assert agg["mc_dropout_accuracy"] is None
    else:
        assert agg["mc_dropout_accuracy"] > 0.9
    for key in ("predictive_nll", "predictive_ece", "min_ess", "median_ess", "max_rhat",
                "logdensity_ess", "logdensity_rhat", "predictive_trace_min_ess",
                "predictive_trace_median_ess", "predictive_trace_max_rhat", "sgd_init_s"):
        assert math.isfinite(agg[key]), key
    assert agg["steps_per_sec"] == pytest.approx(3 * 100 / agg["elapsed_s"], rel=0.05)


@pytest.mark.parametrize("model, extra", [
    ("softmax", ["--learning-rate", "0.02"]),
    ("mlp", ["--hidden", "32", "--init-log-std", "-6", "--learning-rate", "3e-3"]),
])
def test_mnist_vi_cli_digits_on_cpu(one_thread, model, extra):
    """Held to the JAX package's tests/test_vi.py::test_mnist_vi_cli_digits."""
    agg = _run(["mnist-vi", "--dataset", "digits", "--model", model, "--num-steps", "800",
                "--batch-size", "256", "--device", "cpu"] + extra)
    assert set(agg) == VI_KEYS | {"device"}
    assert agg["workload"] == f"mnist-vi-{model}" and agg["dataset"] == "sklearn-digits"
    assert agg["predictive_accuracy"] > 0.85 and agg["train_accuracy"] > 0.85
    assert agg["elbo_first_last"][1] > agg["elbo_first_last"][0]
    assert agg["num_steps"] == 800 and math.isfinite(agg["predictive_nll"])


@pytest.mark.parametrize("mutation, extra", [
    ("hmc", []), ("sghmc", ["--batch-size", "128", "--mcmc-steps", "40"])])
def test_plantvillage_smc_cli_on_cpu(one_thread, mutation, extra):
    """Config 5 at 400 rows and 32 particles: the ladder reaches lambda = 1
    (fewer stages than the stage cap), and under HMC every stage's acceptance
    holds and the step size grows from its first value."""
    agg = _run(["plantvillage-smc", "--n-data", "400", "--particles", "32", "--mutation",
                mutation, "--device", "cpu"] + extra)
    assert set(agg) == SMC_KEYS | {"device"}
    assert agg["workload"] == "plantvillage-smc" and agg["mutation"] == mutation
    assert agg["dataset"] == "synthetic-plantvillage" and agg["shard_particles"] is False
    assert 1 <= agg["num_stages"] < 100 and math.isfinite(agg["log_evidence"])
    assert agg["log_evidence"] < 0
    if mutation == "hmc":
        assert agg["predictive_accuracy"] > 0.95 and agg["train_accuracy"] > 0.95
        assert 0.4 < agg["stage_acceptance_min"] <= agg["stage_acceptance_max"] <= 1.0
        first, last = agg["step_size_first_last"]
        assert first == 0.001 and last > first
    else:
        assert agg["stage_acceptance_min"] is None and agg["stage_acceptance_max"] is None
        assert agg["step_size_first_last"] == [0.001, 0.001]
        assert agg["predictive_accuracy"] > 0.5


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.mark.parametrize("argv, what", [
    (["mnist-mlp-sgmcmc", "--data-shards", "2"], "--data-shards"),
    (["plantvillage-smc", "--shard-particles", "--n-data", "60", "--particles", "8",
      "--mcmc-steps", "1"], None),
], ids=["data-shards", "shard-particles"])
def test_single_device_configs_refuse_unported_options(argv, what, monkeypatch):
    """Outside torchrun, --data-shards 2 exits with the torchrun command to
    use (nothing falls back to one process); --shard-particles lays the
    particles over every rank of the group, so alone one rank holds them
    all and the line says it was sharded."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if what is not None:
        with pytest.raises(SystemExit, match=f"{what} runs one process per rank.*torchrun "
                                             f"--standalone --nproc-per-node 2"):
            cli.main(argv + ["--device", "cpu"])
    else:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv + ["--device", "cpu"])
        agg = json.loads(out.getvalue().strip().splitlines()[-1])
        assert agg["shard_particles"] is True and math.isfinite(agg["log_evidence"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv[:1])


@pytest.mark.parametrize("sub", ["mvn-hmc", "logistic-hmc"])
def test_small_configs_refuse_unported_options(sub):
    """The file options run now; what is still refused is a checkpoint
    without the sample file that a resumed run would go on from."""
    with pytest.raises(SystemExit, match=r"--checkpoint/--resume require --save"):
        cli.main([sub, "--device", "cpu", "--checkpoint", "ck.npz"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([sub])


@pytest.mark.parametrize("extra, match", [
    (["--chain-shards", "2"], "--chain-shards runs one process per rank.*torchrun"),
    (["--chain-shards", "2", "--per-chain-nuts"], "--per-chain-nuts and --diag-mass run in one"),
    (["--chain-shards", "2", "--diag-mass"], "--per-chain-nuts and --diag-mass run in one"),
], ids=["chain-shards", "per-chain-nuts", "diag-mass"])
def test_cli_unported_options_raise(extra, match, monkeypatch):
    """--chain-shards outside torchrun, and with the per-chain modes that it
    does not shard, exits: no silent run in one process."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match=match):
        cli.main(["mnist-nuts", "--device", "cpu"] + extra)


def _write_h5(path, **arrays):
    import h5py

    with h5py.File(path, "w") as f:
        for name, arr in arrays.items():
            f[name] = arr


def test_mnist_nuts_cli_reads_data_file(one_thread, tmp_path):
    """--data PATH: real-pixel-like rows (0..255, one-hot labels) in the
    reference's layout; the line names the file."""
    pytest.importorskip("h5py")
    import numpy as np

    rng = np.random.RandomState(0)
    yi = rng.randint(0, 10, 300)
    centers = rng.randint(0, 200, (10, 20))
    path = str(tmp_path / "mnist_train.h5")
    _write_h5(path, X_train=np.clip(centers[yi] + 20 * rng.randn(300, 20), 0, 255)
              .round().astype(np.float32), y_train=np.eye(10, dtype=np.float32)[yi])
    agg = _run(["mnist-nuts", "--data", path, "--chains", "3", "--samples", "20", "--warmup",
                "30", "--max-depth", "4", "--device", "cpu"])
    assert agg["dataset"] == f"hdf5:{path}" and agg["train_accuracy"] > 0.9
    # a path that is not there falls back to the synthetic set, and says so
    from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets
    assert datasets.mnist_provenance(str(tmp_path / "missing.h5")) == "synthetic-mnist"


@pytest.mark.parametrize("sub, extra", [
    ("mnist-mlp-sgmcmc", ["--hidden", "8", "--batch-size", "64", "--num-steps", "50",
                          "--burnin-steps", "10", "--collect-every", "10", "--sgd-init-steps",
                          "200", "--sgd-step-size", "3e-5", "--chains", "2"]),
    ("mnist-vi", ["--num-steps", "200", "--batch-size", "64"]),
], ids=["sgmcmc-data", "vi-data"])
def test_mnist_configs_read_data_file(one_thread, tmp_path, sub, extra):
    pytest.importorskip("h5py")
    import numpy as np

    rng = np.random.RandomState(1)
    yi = rng.randint(0, 10, 400)
    centers = rng.randint(0, 200, (10, 12))
    path = str(tmp_path / "mnist_train.h5")
    _write_h5(path, X_train=np.clip(centers[yi] + 10 * rng.randn(400, 12), 0, 255)
              .round().astype(np.float32), y_train=yi.astype(np.int64))
    agg = _run([sub, "--data", path, "--device", "cpu"] + extra)
    assert agg["dataset"] == f"hdf5:{path}" and math.isfinite(agg["predictive_nll"])
    assert agg["train_accuracy"] > 0.5


def test_plantvillage_smc_cli_reads_data_file(one_thread, tmp_path):
    pytest.importorskip("h5py")
    from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets

    X, y = datasets.plantvillage_features(n=300, dim=24, k=5)
    path = str(tmp_path / "features.h5")
    _write_h5(path, features=X, labels=y)
    agg = _run(["plantvillage-smc", "--data", path, "--particles", "16", "--device", "cpu"])
    assert agg["dataset"] == f"hdf5:{path}" and agg["num_stages"] >= 1
    assert agg["predictive_accuracy"] > 0.8


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
