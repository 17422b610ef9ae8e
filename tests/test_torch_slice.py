"""The whole slice (setup -> whitened chain-batched HMC -> dual-averaging
warmup -> gauge Gibbs -> draws) in both packages, on the CPU at small size.

Both start from the same metric-setup npz (written by the JAX package, read
by the port) on the first 400 rows of scikit-learn's digits.  Their random
streams differ, so the comparison is statistical: mean acceptance within
0.1, median adapted step sizes within a factor of 1.5, and whitened draws
with mean ~0 and variance ~1 in both.  Also: the port's bench entry point on
the CPU, and the port's import without jax.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference.warmup import (  # noqa: E402
    run_warmup as jax_run_warmup,
)
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops import kron_metric as jkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import bench  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.warmup import run_warmup  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.models import Softmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric as tkm  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import load_gn_setup  # noqa: E402

ALPHA, C, L, WARMUP, DRAWS, ROWS = 1.0, 4, 10, 20, 40, 400
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax(X, Y, jmodel, jmetric, jaux, jqmap):
    d = X.shape[1]
    vag, _ = jkm.make_whitened_fused_vag(jmodel, jmetric, jqmap, (X, Y), use_pallas=False)
    gibbs = jkm.make_whitened_gauge_gibbs(jmetric, jaux, jqmap)
    kernel = jhmc.build_batched_kernel(vag, L)

    @jax.jit
    def run(key):
        k0, k1 = jax.random.split(jax.random.fold_in(key, 0))
        e0 = {"weights": jax.random.normal(k0, (C, d, 10)),
              "bias": jax.random.normal(k1, (C, 10))}
        warm = jax_run_warmup(kernel, jhmc.batched_init(e0, vag), jax.random.fold_in(key, 1),
                              WARMUP, initial_step_size=jnp.full((C,), 0.1),
                              target_acceptance=0.5, adapt_mass=False)

        def body(s, k):
            ns, info = kernel(k, s, warm.step_size, warm.inv_mass)
            ns = gibbs(jax.random.fold_in(k, 1), ns)
            return ns, (ns.position, info.acceptance_prob)

        st = jhmc.batched_init(warm.state.position, vag)
        _, (pos, acc) = jax.lax.scan(body, st, jax.random.split(jax.random.fold_in(key, 2),
                                                                DRAWS))
        return warm.step_size, pos, acc

    with jax.default_matmul_precision("highest"):
        ss, pos, acc = run(jax.random.key(0))
    draws = np.concatenate([np.asarray(pos["weights"]).reshape(DRAWS, C, -1),
                            np.asarray(pos["bias"])], axis=2)
    return np.asarray(ss), draws, float(np.mean(acc))


def _run_torch(X, Y, metric, aux, qmap):
    d = X.shape[1]
    model = Softmax(dim=d, n_classes=10, alpha=ALPHA)
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    vag, grad_only = tkm.make_whitened_fused_vag(model, metric, qmap, batch)
    gibbs = tkm.make_whitened_gauge_gibbs(metric, aux, qmap)
    kernel = hmc.build_batched_kernel(vag, L, grad_fn=grad_only)
    gen = torch.Generator().manual_seed(0)
    e0 = {"weights": torch.randn((C, d, 10), generator=gen),
          "bias": torch.randn((C, 10), generator=gen)}
    warm = run_warmup(kernel, hmc.batched_init(e0, vag), WARMUP,
                      initial_step_size=torch.full((C,), 0.1), target_acceptance=0.5,
                      adapt_mass=False, generator=gen)
    st = hmc.batched_init(warm.state.position, vag)
    draws, acc = [], []
    for _ in range(DRAWS):
        st, info = kernel(st, warm.step_size, warm.inv_mass, generator=gen)
        st = gibbs(st, generator=gen)
        draws.append(torch.cat([st.position["weights"].reshape(C, -1),
                                st.position["bias"]], dim=1))
        acc.append(info.acceptance_prob)
    return (warm.step_size.numpy(), torch.stack(draws).numpy(),
            float(torch.stack(acc).mean()))


def test_slice_statistical_parity(tmp_path):
    X, yi = datasets.digits()
    X, yi = X[:ROWS], yi[:ROWS]
    Y = np.eye(10, dtype=np.float32)[yi]
    jmodel = JaxSoftmax(dim=X.shape[1], n_classes=10, alpha=ALPHA)
    with jax.default_matmul_precision("highest"):
        jmetric, jaux, jqmap, _ = jkm.cached_gn_setup(
            jnp.asarray(X), jnp.asarray(Y), jmodel, alpha=ALPHA, newton_steps=60,
            cache_dir=str(tmp_path), provenance="digits-400")
    (npz,) = glob.glob(str(tmp_path / "kron_setup_*.npz"))
    metric, aux, qmap = load_gn_setup(npz, ALPHA, "cpu")

    jss, jdraws, jacc = _run_jax(X, Y, jmodel, jmetric, jaux, jqmap)
    tss, tdraws, tacc = _run_torch(X, Y, metric, aux, qmap)

    assert abs(tacc - jacc) < 0.1, (tacc, jacc)
    ratio = np.median(tss) / np.median(jss)
    assert 1 / 1.5 < ratio < 1.5, (np.median(tss), np.median(jss))
    for draws in (jdraws, tdraws):     # (draws, chains, 650) whitened
        assert np.isfinite(draws).all()
        flat = draws.reshape(-1, draws.shape[-1])
        assert abs(flat.mean()) < 0.1
        assert 0.7 < flat.var(axis=0).mean() < 1.3


def test_bench_entry_point_on_cpu():
    env = dict(os.environ, BENCH_DATASET="digits", BENCH_CHAINS="4", BENCH_WARMUP="10",
               BENCH_DRAWS="20")
    proc = subprocess.run(
        [sys.executable, "-m", "dropout_hamiltonian_montecarlo_tpu_torch.bench",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device", "detail"}
    assert out["metric"] == "median_ess_per_sec_mnist_softmax_hmc"
    assert out["device"] == "cpu"
    det = out["detail"]
    assert det["chains"] == 4 and det["draws"] == 20 and det["path"] == "torch-plain"
    assert det["kernel_launches"] == {"value_and_grad": 0, "grad": 0}
    assert np.isfinite(out["value"]) and 0.0 < det["acceptance"] <= 1.0


@pytest.mark.parametrize("env", [{"BENCH_CHAIN_SHARDS": "2"}])
def test_bench_unported_options_raise(env, monkeypatch):
    """BENCH_CHAIN_SHARDS > 1 outside torchrun exits with the command to use:
    no silent run in one process."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="torchrun --standalone --nproc-per-node 2"):
        bench.main(["--device", "cpu"])


@pytest.mark.parametrize("env", [{"BENCH_SAMPLER": "nuts", "BENCH_NUTS_DEPTH": "auto"},
                                 {"BENCH_CHEES": "1"}], ids=["nuts-auto", "chees"])
def test_bench_adaptive_paths_on_cpu(env, monkeypatch, capsys):
    """The bench's NUTS (depth cap from the warmup) and ChEES paths, on
    digits with 4 chains, 10 warmup steps and 20 draws."""
    for k, v in dict(env, BENCH_DATASET="digits", BENCH_CHAINS="4", BENCH_WARMUP="10",
                     BENCH_DRAWS="20").items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "median_ess_per_sec_mnist_softmax_hmc" and out["device"] == "cpu"
    det = out["detail"]
    assert np.isfinite(out["value"]) and 0.0 < det["acceptance"] <= 1.0
    assert det["kernel_launches"] == {"value_and_grad": 0, "grad": 0}
    if "BENCH_SAMPLER" in env:
        assert det["sampler"] == "nuts" and det["nuts_depth_mode"] == "auto"
        assert det["warmup"] == "dual-averaging" and det["warmup_median_leaves"] >= 1
        assert 2 <= det["nuts_depth_cap"] <= 6
        # the lockstep kernel runs at least the largest tree of each draw
        assert 1 <= det["num_integration_steps"] <= det["lockstep_evals_per_draw"]
        assert det["lockstep_evals_per_draw"] <= 2 ** det["nuts_depth_cap"]
        assert det["lockstep_leaves"] >= 20 * det["lockstep_evals_per_draw"]
    else:
        assert det["sampler"] == "hmc" and det["warmup"] == "chees"
        assert 1 <= det["num_integration_steps"] <= 64
        assert det["lockstep_evals_per_draw"] == det["num_integration_steps"]
        assert det["chees_leapfrog_steps"] >= 10


def test_bench_cuda_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(device="cuda")


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import dropout_hamiltonian_montecarlo_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_no_port_source_names_jax_in_an_import():
    """Statically: no module of the port, and not the chip smoke script,
    imports jax or the JAX package (a lazy import inside a function would
    pass the import walk above)."""
    import re

    sources = glob.glob(os.path.join(REPO, "dropout_hamiltonian_montecarlo_tpu_torch", "**",
                                     "*.py"), recursive=True)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) >= 40
    pattern = re.compile(r"^\s*(import|from)\s+(jax|dropout_hamiltonian_montecarlo_tpu)(\.|\s|$)",
                         re.MULTILINE)
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_bench_kernel_switch_and_trace_on_cpu(monkeypatch, capsys, tmp_path):
    """BENCH_KERNEL=0 names the plain version in the line, and BENCH_TRACE
    writes the sampling loop's profiler trace."""
    for k, v in dict(BENCH_DATASET="digits", BENCH_CHAINS="3", BENCH_WARMUP="5",
                     BENCH_DRAWS="8", BENCH_KERNEL="0",
                     BENCH_TRACE=str(tmp_path / "trace")).items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["kernel"] == "plain" and out["detail"]["path"] == "torch-plain"
    assert out["detail"]["kernel_launches"] == {"value_and_grad": 0, "grad": 0}
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_use_kernel_false_is_the_plain_version():
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import softmax_glm as sg

    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.rand(50, 6).astype(np.float32))
    Y = torch.from_numpy(np.eye(4, dtype=np.float32)[rng.randint(0, 4, 50)])
    W = torch.from_numpy(rng.randn(3, 6, 4).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    sg.reset_launch_counts()
    ref = sg.softmax_value_and_grad(X, Y, W, b, 1.0)
    got = sg.softmax_value_and_grad(X, Y, W, b, 1.0, use_kernel=False)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert sg.softmax_value_and_grad(X, Y, W, b, 1.0, fwd_full=False, use_kernel=False)[0] is None
    assert sg.launch_counts == {"value_and_grad": 0, "grad": 0}


def test_device_trace_span(tmp_path):
    from dropout_hamiltonian_montecarlo_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "t")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "aten::matmul" or e.key == "aten::mm" for e in prof.key_averages())
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
