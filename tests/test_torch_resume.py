"""Checkpoint / resume of the port's streaming samplers and CLI, on the CPU.

An interrupted and resumed run must equal the uninterrupted one with
``array_equal``: chunk i draws only from the generator of (seed, sample
stream, i), and the checkpoint carries the states, the adapted step sizes and
inverse mass, the seed and the draws done.  The tests mirror the JAX package's
tests/test_io.py (exact resume, a crash between append and checkpoint, the
chunk-size guard, the finished-run no-op, the checkpoint without an inverse
mass, the CLI streaming run), and add what the port must not copy: ``--resume
--save FILE`` with a file and no checkpoint raises.

Slice parity against the JAX package: ONE streaming chunk of each package's
``sample_batched_streaming`` from the same state writes the same block into
its HDF5 file, rtol 1e-5 (atol 1e-6).  The JAX side runs its Pallas kernel in
interpret mode, as its own tests do on the CPU; the port is handed the momenta
and accept uniforms that the JAX package's streaming function derives from its keys
(split(fold_in(key, chunk)) per draw, split per chain), as injected draws.
"""

import contextlib
import io as _io
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu.inference import hmc as jhmc  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference.sampling import (  # noqa: E402
    sample_batched_streaming as jax_sample_batched_streaming)
from dropout_hamiltonian_montecarlo_tpu.io import HDF5Backend as JaxHDF5Backend  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.models import Softmax as JaxSoftmax  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.ops.tree import (  # noqa: E402
    tree_randn_like as jax_tree_randn_like)
from dropout_hamiltonian_montecarlo_tpu_torch import cli, models  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference import (  # noqa: E402
    hmc, nuts_batched, sampling)
from dropout_hamiltonian_montecarlo_tpu_torch.io import (  # noqa: E402
    HDF5Backend, load_checkpoint, save_checkpoint)
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import params_from_jax  # noqa: E402

DIM, COV = 3, np.eye(3, dtype=np.float32) + 0.3


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of tiny ops: one intra-op thread is as fast alone and does
    not stall when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _per_chain_setup(chains=2):
    model = models.MVNGaussian(np.zeros(DIM, np.float32), COV)
    ld = model.make_logdensity()
    kernel = hmc.build_kernel(ld, num_integration_steps=4)
    positions = sampling.init_chain_positions(model.init_params, chains, generator=_gen(),
                                              device="cpu")
    return kernel, (lambda p: hmc.init(p, ld)), positions


def _run_posterior(setup, path, ckpt, num_samples, resume=False, chains=2):
    kernel, init_fn, positions = setup
    with HDF5Backend(path, mode="a" if resume else "w") as b:
        out = sampling.sample_posterior_streaming(
            init_fn, kernel, positions, b, num_samples=num_samples, chunk_size=10,
            num_warmup=30, num_chains=chains, checkpoint_path=ckpt, resume=resume,
            generator=_gen())
        return b.read(), out


def test_streaming_checkpoint_resume_exact(tmp_path):
    setup = _per_chain_setup()
    full, (_, full_step, full_im, _) = _run_posterior(
        setup, str(tmp_path / "full.h5"), str(tmp_path / "full.ckpt"), 40)
    p2, c2 = str(tmp_path / "part.h5"), str(tmp_path / "part.ckpt")
    _run_posterior(setup, p2, c2, 20)
    part, (_, step, inv_mass, appended) = _run_posterior(setup, p2, c2, 40, resume=True)
    assert appended == 40 and part["x"].shape == full["x"].shape == (40, 2, DIM)
    np.testing.assert_array_equal(part["x"], full["x"])
    # warmup was skipped: the adapted values came out of the checkpoint
    assert torch.equal(step, full_step) and torch.equal(inv_mass["x"], full_im["x"])
    assert float(full_im["x"].std()) > 0


def test_streaming_resume_without_a_checkpoint_file_starts_afresh(tmp_path):
    setup = _per_chain_setup()
    full, _ = _run_posterior(setup, str(tmp_path / "full.h5"), None, 20)
    again, (_, _, _, appended) = _run_posterior(setup, str(tmp_path / "b.h5"),
                                                str(tmp_path / "missing.ckpt"), 20)
    assert appended == 20
    np.testing.assert_array_equal(again["x"], full["x"])


def test_streaming_resume_after_crash_between_append_and_checkpoint(tmp_path):
    setup = _per_chain_setup()
    full, _ = _run_posterior(setup, str(tmp_path / "full.h5"), str(tmp_path / "full.ckpt"), 40)
    p2, c2 = str(tmp_path / "part.h5"), str(tmp_path / "part.ckpt")
    _run_posterior(setup, p2, c2, 20)                        # the checkpoint says 20 draws
    # the crash: one more chunk reaches the file, the checkpoint never updates
    with HDF5Backend(p2, mode="a") as b:
        assert b.num_draws() == 20
        b.append({"x": torch.full((10, 2, DIM), 1e9)})
        assert b.num_draws() == 30
    part, _ = _run_posterior(setup, p2, c2, 40, resume=True)
    assert part["x"].shape == (40, 2, DIM)
    np.testing.assert_array_equal(part["x"], full["x"])


def _batched_setup(chains=4):
    model = models.MVNGaussian(np.zeros(DIM, np.float32), COV)
    prec = torch.from_numpy(np.linalg.inv(COV).astype(np.float32))

    def vag(p):
        x = p["x"]
        g = -(x @ prec)
        return 0.5 * (x * g).sum(dim=1), {"x": g}

    positions = {"x": torch.randn((chains, DIM), generator=_gen())}
    return vag, positions


def _run_batched(kernel, states, ss, inv_mass, path, ckpt, num, resume=False, chunk=10,
                 seed=1):
    with HDF5Backend(path, mode="a" if resume else "w") as b:
        _, appended, infos = sampling.sample_batched_streaming(
            kernel, states, ss, inv_mass, b, num_samples=num, chunk_size=chunk,
            checkpoint_path=ckpt, resume=resume, generator=_gen(seed))
        return b.read(), appended, infos


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_batched_streaming_resume_exact_and_guards(tmp_path, sampler):
    vag, positions = _batched_setup()
    if sampler == "hmc":
        kernel, states = hmc.build_batched_kernel(vag, 4), hmc.batched_init(positions, vag)
    else:
        kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=3)
        states = nuts_batched.batched_init(positions, vag)
    ss, ones = torch.full((4,), 0.4), {"x": torch.ones(4, DIM)}
    run = lambda *a, **k: _run_batched(kernel, states, *a, **k)   # noqa: E731

    full, _, infos = run(ss, ones, str(tmp_path / "f.h5"), str(tmp_path / "f.ckpt"), 40)
    assert len(infos) == 4 and 0 < infos[0].acceptance_prob <= 1
    p, c = str(tmp_path / "p.h5"), str(tmp_path / "p.ckpt")
    run(ss, ones, p, c, 20)
    # PLACEHOLDER step sizes and another caller seed: the checkpoint's win
    part, appended, infos = run(torch.full((4,), 99.0), ones, p, c, 40, resume=True, seed=77)
    assert appended == 40 and len(infos) == 2            # this call ran two chunks
    np.testing.assert_array_equal(part["x"], full["x"])

    # another chunk size in mid-run: an error, not a silently different stream
    run(ss, ones, p, c, 20)
    with HDF5Backend(p, mode="a") as b:
        with pytest.raises(ValueError, match="chunk_size"):
            sampling.sample_batched_streaming(kernel, states, ss, ones, b, num_samples=40,
                                              chunk_size=15, checkpoint_path=c, resume=True,
                                              generator=_gen(1))

    # resuming a FINISHED run appends nothing and leaves the file as it is
    done, appended, infos = run(torch.full((4,), 99.0), ones, str(tmp_path / "f.h5"),
                                str(tmp_path / "f.ckpt"), 40, resume=True)
    assert appended == 40 and infos == []
    np.testing.assert_array_equal(done["x"], full["x"])


def test_batched_streaming_partial_last_chunk_and_the_guard(tmp_path):
    """25 draws in chunks of 10: the last chunk runs 5 steps and is saved at
    25, which is no chunk boundary: going on to 40 from there raises, and
    the same 25 draws are the first 25 of a longer run's."""
    vag, positions = _batched_setup()
    kernel, states = hmc.build_batched_kernel(vag, 4), hmc.batched_init(positions, vag)
    ss, ones = torch.full((4,), 0.4), {"x": torch.ones(4, DIM)}
    p, c = str(tmp_path / "p.h5"), str(tmp_path / "p.ckpt")
    part, appended, infos = _run_batched(kernel, states, ss, ones, p, c, 25)
    assert appended == 25 and part["x"].shape[0] == 25 and len(infos) == 3
    full, _, _ = _run_batched(kernel, states, ss, ones, str(tmp_path / "f.h5"), None, 40)
    np.testing.assert_array_equal(part["x"], full["x"][:25])
    with pytest.raises(ValueError, match="not a multiple of chunk_size"):
        _run_batched(kernel, states, ss, ones, p, c, 40, resume=True)


def test_batched_streaming_resume_legacy_checkpoint_without_inv_mass(tmp_path):
    vag, positions = _batched_setup()
    kernel, states = hmc.build_batched_kernel(vag, 4), hmc.batched_init(positions, vag)
    ss, ones = torch.full((4,), 0.4), {"x": torch.ones(4, DIM)}
    path, ckpt = str(tmp_path / "d.h5"), str(tmp_path / "d.ckpt")
    first, _, _ = _run_batched(kernel, states, ss, ones, path, None, 10)
    # a checkpoint whose extras carry the step sizes only
    save_checkpoint(ckpt, states, seed=1, step=10, extras={"step_size": ss})
    out, appended, _ = _run_batched(kernel, states, ss, ones, path, ckpt, 20, resume=True)
    assert appended == 20 and out["x"].shape[0] == 20
    np.testing.assert_array_equal(out["x"][:10], first["x"])
    _, seed, step, extras = load_checkpoint(ckpt, states, {"step_size": ss, "inv_mass": ones})
    assert (seed, step) == (1, 20) and torch.equal(extras["inv_mass"]["x"], ones["x"])


def test_draw_buffer_sits_under_a_checkpoint(tmp_path):
    """The bounded DeviceBackend as the resumed backend: run, crash (a chunk
    more in the buffer than the checkpoint knows), resume into the same
    buffer."""
    vag, positions = _batched_setup()
    kernel, states = hmc.build_batched_kernel(vag, 4), hmc.batched_init(positions, vag)
    ss, ones = torch.full((4,), 0.4), {"x": torch.ones(4, DIM)}
    kw = dict(chunk_size=10, generator=_gen(1))
    full = sampling.DeviceBackend(40)
    sampling.sample_batched_streaming(kernel, states, ss, ones, full, num_samples=40, **kw)
    ckpt = str(tmp_path / "b.ckpt")
    part = sampling.DeviceBackend(40)
    sampling.sample_batched_streaming(kernel, states, ss, ones, part, num_samples=20,
                                      checkpoint_path=ckpt, **kw)
    part.append({"x": torch.full((10, 4, DIM), 1e9)})
    assert part.num_draws() == 30
    _, appended, _ = sampling.sample_batched_streaming(
        kernel, states, torch.full((4,), 99.0), ones, part, num_samples=40,
        checkpoint_path=ckpt, resume=True, **kw)
    assert appended == 40 and part.num_draws() == 40
    assert torch.equal(part.draws()["x"], full.draws()["x"])


# ---- the CLI ------------------------------------------------------------------

def _cli(argv):
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv + ["--device", "cpu"])
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _h5(path, name="x"):
    with h5py.File(path, "r") as h:
        return h[name][:]


def test_streaming_collection_cli(tmp_path):
    f = str(tmp_path / "stream.h5")
    agg = _cli(["mvn-hmc", "--chains", "2", "--samples", "40", "--warmup", "50", "--save", f,
                "--stream-chunk", "16"])
    assert agg["workload"] == "mvn-hmc" and np.isfinite(agg["min_ess"])
    assert _h5(f).shape == (40, 2, 2)          # (draws, chains, dim), appended in chunks
    # without --stream-chunk the draws are saved once, chains and draws flattened
    g = str(tmp_path / "once.h5")
    _cli(["logistic-hmc", "--chains", "3", "--samples", "12", "--warmup", "20", "--save", g])
    assert _h5(g, "weights").shape == (36, 2) and _h5(g, "bias").shape == (36,)


@pytest.mark.parametrize("sub, extra", [("mvn-hmc", []), ("mvn-hmc", ["--nuts"]),
                                        ("logistic-hmc", ["--n-data", "200"])],
                         ids=["mvn-hmc", "mvn-nuts", "logistic-hmc"])
def test_cli_resume_equals_the_uninterrupted_run(tmp_path, sub, extra):
    common = [sub, "--chains", "3", "--warmup", "30", "--stream-chunk", "10"] + extra
    full = str(tmp_path / "full.h5")
    _cli(common + ["--samples", "30", "--save", full, "--checkpoint", str(tmp_path / "f.ckpt")])
    part, ckpt = str(tmp_path / "part.h5"), str(tmp_path / "p.ckpt")
    _cli(common + ["--samples", "10", "--save", part, "--checkpoint", ckpt])
    agg = _cli(common + ["--samples", "30", "--save", part, "--checkpoint", ckpt, "--resume"])
    assert np.isfinite(agg["max_rhat"])
    name = "x" if sub == "mvn-hmc" else "weights"
    assert _h5(part, name).shape[0] == 30
    np.testing.assert_array_equal(_h5(part, name), _h5(full, name))


def test_mnist_nuts_cli_resume_equals_the_uninterrupted_run(tmp_path):
    common = ["mnist-nuts", "--dataset", "digits", "--chains", "3", "--warmup", "20",
              "--max-depth", "3", "--stream-chunk", "6"]
    full = str(tmp_path / "full.h5")
    a = _cli(common + ["--samples", "18", "--save", full, "--checkpoint",
                       str(tmp_path / "f.ckpt")])
    part, ckpt = str(tmp_path / "part.h5"), str(tmp_path / "p.ckpt")
    _cli(common + ["--samples", "6", "--save", part, "--checkpoint", ckpt])
    b = _cli(common + ["--samples", "18", "--save", part, "--checkpoint", ckpt, "--resume"])
    for name in ("weights", "bias"):
        assert _h5(part, name).shape[:2] == (18, 3)
        np.testing.assert_array_equal(_h5(part, name), _h5(full, name))
    assert a["resumed"] is False and b["resumed"] is True and b["warmup_s"] == 0.0
    # the resumed run read the file back: the same draws, the same diagnostics
    for key in ("min_ess", "median_ess", "max_rhat", "predictive_nll"):
        assert b[key] == pytest.approx(a[key], rel=1e-5), key
    # its rate counts the 12 draws this call made for 3 chains, not all 18
    assert b["draws_per_sec"] == pytest.approx(3 * 12 / b["run_s"], rel=0.05)


def test_cli_file_options_refuse_what_would_lose_draws(tmp_path):
    f, ckpt = str(tmp_path / "draws.h5"), str(tmp_path / "none.ckpt")
    base = ["mvn-hmc", "--chains", "2", "--samples", "10", "--warmup", "10"]
    for sub in (base, ["mnist-nuts", "--dataset", "digits"]):
        with pytest.raises(SystemExit, match="require --save"):
            _cli(sub + ["--checkpoint", ckpt])
        with pytest.raises(SystemExit, match="require --save"):
            _cli(sub + ["--resume"])
    with pytest.raises(SystemExit, match="--stream-chunk"):
        _cli(base + ["--save", f, "--checkpoint", ckpt])
    # --resume --save FILE, FILE there, no checkpoint: raise, never truncate
    _cli(base + ["--save", f, "--stream-chunk", "5"])
    before = _h5(f)
    for sub in (base, ["mnist-nuts", "--dataset", "digits", "--chains", "2"]):
        with pytest.raises(FileExistsError, match="no checkpoint"):
            _cli(sub + ["--save", f, "--stream-chunk", "5", "--checkpoint", ckpt, "--resume"])
    np.testing.assert_array_equal(_h5(f), before)


def test_mnist_nuts_cli_host_buffer_gives_the_device_buffers_line():
    """A draw-buffer threshold of one byte sends the draws to host storage
    and the diagnostics through the blockwise path: the same line."""
    argv = ["mnist-nuts", "--dataset", "digits", "--chains", "3", "--samples", "20",
            "--warmup", "20", "--max-depth", "3", "--device", "cpu"]
    lines = []
    for threshold in (None, 1):
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.cmd_mnist_nuts(cli.build_parser().parse_args(argv),
                               draw_buffer_threshold=threshold)
        lines.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    dev, host = lines
    for key in ("min_ess", "median_ess", "max_rhat", "train_accuracy", "predictive_accuracy",
                "predictive_nll", "mean_acceptance"):
        assert host[key] == pytest.approx(dev[key], rel=1e-5), key


# ---- one streaming chunk against the JAX package -------------------------------

def test_one_streaming_chunk_matches_the_jax_package(tmp_path):
    n, d, k, chains, chunk, steps = 256, 16, 5, 4, 3, 2
    rng = np.random.RandomState(0)
    X = (rng.randint(0, 256, (n, d)) / 256.0).astype(np.float32)      # exact in bf16
    Y = np.eye(k, dtype=np.float32)[rng.randint(0, k, n)]
    pos = {"weights": (0.05 * rng.randn(chains, d, k)).astype(np.float32),
           "bias": (0.05 * rng.randn(chains, k)).astype(np.float32)}
    eps = np.array([0.002, 0.004, 0.008, 0.012], np.float32)

    # the JAX package: its streaming function on its Pallas kernel (interpret mode)
    jvag = JaxSoftmax(dim=d, n_classes=k, alpha=1.0).make_fused_value_and_grad(
        (jnp.asarray(X), jnp.asarray(Y)), tile_rows=128, interpret=True, bwd_3pass=True)
    jkernel = jhmc.build_batched_kernel(jvag, steps)
    jstate = jhmc.batched_init({kk: jnp.asarray(v) for kk, v in pos.items()}, jvag)
    ones = {kk: jnp.ones_like(v) for kk, v in pos.items()}
    key = jax.random.key(5)
    jpath = str(tmp_path / "jax.h5")
    with JaxHDF5Backend(jpath, "w") as b:
        jax_sample_batched_streaming(jkernel, jstate, jnp.asarray(eps), ones, key, b,
                                     num_samples=chunk, chunk_size=chunk)
        jblock = b.read()

    # the draws the JAX function derived: per-(draw, chain) keys, split per chain
    draw_keys = jax.vmap(lambda kk: jax.random.split(kk, chains))(
        jax.random.split(jax.random.fold_in(key, 0), chunk))
    injected = []
    for t in range(chunk):
        both = jax.vmap(lambda kk: jax.random.split(kk, 2))(draw_keys[t])
        mom = jax.vmap(jax_tree_randn_like)(both[:, 0], jstate.position)
        u = jax.vmap(lambda kk: jax.random.uniform(kk))(both[:, 1])
        injected.append((params_from_jax(mom, "cpu"), torch.from_numpy(np.array(u))))

    tvag = models.Softmax(dim=d, n_classes=k, alpha=1.0).make_fused_value_and_grad(
        (torch.from_numpy(X), torch.from_numpy(Y)))
    tkernel = hmc.build_batched_kernel(tvag, steps)
    tstate = params_from_jax(jstate, "cpu")
    feed = iter(injected)

    def injected_kernel(state, step_sizes, inv_mass, *, generator):
        momentum, uniforms = next(feed)
        return tkernel(state, step_sizes, inv_mass, momentum=momentum, uniforms=uniforms)

    tpath = str(tmp_path / "torch.h5")
    with HDF5Backend(tpath, "w") as b:
        sampling.sample_batched_streaming(
            injected_kernel, tstate, torch.from_numpy(eps), params_from_jax(ones, "cpu"), b,
            num_samples=chunk, chunk_size=chunk, generator=_gen())
    with JaxHDF5Backend(tpath, "r") as b:          # the JAX reader on the port's file
        tblock = b.read()
    assert sorted(tblock) == sorted(jblock) == ["bias", "weights"]
    moved = 0.0
    for name in jblock:
        assert tblock[name].shape == jblock[name].shape == (chunk, chains) + pos[name].shape[1:]
        np.testing.assert_allclose(tblock[name], jblock[name], rtol=1e-5, atol=1e-6)
        moved = max(moved, float(np.abs(jblock[name][-1] - pos[name]).max()))
    assert moved > 1e-3                              # some chain accepted a move
