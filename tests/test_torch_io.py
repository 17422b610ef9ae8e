"""The port's file layer: the HDF5 sample backend, checkpoints, shard files,
and the bounded draw buffer; held against the JAX package where the two must
agree.

Cross-package: a sample file written by either package's ``HDF5Backend`` is
read by the other's with the same dataset names and arrays (inputs from a
numpy seed), a checkpoint of either package has the other's key names for the
state and the extras, and a checkpoint of the JAX package raises the port's
clear error.  The draw buffer with host storage gives the device path's
diagnostics (rtol 1e-5: the same FFT on other block widths).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dropout_hamiltonian_montecarlo_tpu import io as jio  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu.inference.hmc import HMCState as JaxHMCState  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch import io as tio  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.diagnostics import (  # noqa: E402
    draw_diagnostics, effective_sample_size, posterior_predictive_probs, split_rhat)
from dropout_hamiltonian_montecarlo_tpu_torch.inference import sampling  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.inference.hmc import HMCState  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.io.checkpoint import checkpoint_groups  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.utils.convert import (  # noqa: E402
    draws_from_sample_file, draws_to_numpy, params_from_jax)


def _blocks(seed, sizes=(5, 3), chains=3):
    rng = np.random.RandomState(seed)
    return [{"weights": rng.randn(n, chains, 4, 2).astype(np.float32),
             "bias": rng.randn(n, chains, 2).astype(np.float32)} for n in sizes]


def test_hdf5_backend_append_and_read(tmp_path):
    path = str(tmp_path / "samples.h5")
    b1, b2 = _blocks(0)
    with tio.HDF5Backend(path) as b:
        b.append({k: torch.from_numpy(v) for k, v in b1.items()})     # tensors
        assert b.num_draws() == 5
        b.append(b2)                                                    # numpy
        assert b.num_draws() == 8
    with tio.HDF5Backend(path, "r") as b:
        data = b.read()
    assert set(data) == {"weights", "bias"} and data["weights"].shape == (8, 3, 4, 2)
    for k in data:
        np.testing.assert_array_equal(data[k], np.concatenate([b1[k], b2[k]]))
    with tio.HDF5Backend(path, "a") as b:
        b.truncate(6)
        assert b.num_draws() == 6
        b.truncate(7)                     # never grows
        assert b.num_draws() == 6
    with tio.HDF5Backend(str(tmp_path / "empty.h5"), "w") as b:
        assert b.num_draws() == 0 and b.read() == {}


def test_posterior_mean_across_files(tmp_path):
    p1, p2 = str(tmp_path / "b0.h5"), str(tmp_path / "b1.h5")
    with tio.HDF5Backend(p1) as b:
        b.append({"x": torch.full((4, 2), 1.0)})
    with tio.HDF5Backend(p2) as b:
        b.append({"x": torch.full((12, 2), 3.0)})
    mean = tio.posterior_mean([p1, p2])
    assert np.allclose(mean["x"], 2.5)        # (4 * 1 + 12 * 3) / 16
    assert np.allclose(jio.posterior_mean([p1, p2])["x"], mean["x"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sample_file_crosses_the_packages(tmp_path, writer):
    path = str(tmp_path / "draws.h5")
    blocks = _blocks(1, sizes=(4, 4, 2))
    w, r = (jio, tio) if writer == "jax" else (tio, jio)
    with w.HDF5Backend(path, "w") as b:
        for blk in blocks:
            b.append({k: jnp.asarray(v) for k, v in blk.items()} if writer == "jax"
                     else {k: torch.from_numpy(v) for k, v in blk.items()})
    with r.HDF5Backend(path, "r") as b:
        data = b.read()
        assert b.num_draws() == 10
    assert sorted(data) == ["bias", "weights"]
    for k in data:
        np.testing.assert_array_equal(data[k], np.concatenate([blk[k] for blk in blocks]))
    # and into the layout either package's summarize takes
    draws = draws_from_sample_file(data, "cpu")
    assert draws["weights"].shape == (3, 10, 4, 2)
    np.testing.assert_array_equal(draws_to_numpy(draws)["bias"], np.swapaxes(data["bias"], 0, 1))


def _states(seed=2, chains=3):
    rng = np.random.RandomState(seed)
    pos = {"weights": rng.randn(chains, 4, 2).astype(np.float32),
           "bias": rng.randn(chains, 2).astype(np.float32)}
    grad = {k: -v for k, v in pos.items()}
    logp = rng.randn(chains).astype(np.float32)
    jstate = JaxHMCState(pos, logp, grad)
    extras = {"step_size": rng.rand(chains).astype(np.float32),
              "inv_mass": {k: np.ones_like(v) for k, v in pos.items()}}
    return jstate, params_from_jax(jstate, "cpu"), extras


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    _, state, extras = _states()
    textras = params_from_jax(extras, "cpu")
    tio.save_checkpoint(path, state, seed=2 ** 63 + 5, step=42, extras=textras)
    assert not (tmp_path / "ckpt.npz.tmp").exists()           # moved into place
    template = HMCState({k: torch.zeros_like(v) for k, v in state.position.items()},
                        torch.zeros(3), {k: torch.zeros_like(v) for k, v in state.position.items()})
    like = {"step_size": torch.zeros(3), "inv_mass": {k: torch.zeros_like(v)
                                                      for k, v in state.position.items()}}
    state2, seed, step, extras2 = tio.load_checkpoint(path, template, like)
    assert (seed, step) == (2 ** 63 + 5, 42) and isinstance(state2, HMCState)
    assert torch.equal(state2.logdensity, state.logdensity)
    for k in state.position:
        assert torch.equal(state2.position[k], state.position[k])
        assert torch.equal(state2.logdensity_grad[k], state.logdensity_grad[k])
        assert torch.equal(extras2["inv_mass"][k], textras["inv_mass"][k])
    assert torch.equal(extras2["step_size"], textras["step_size"])
    assert checkpoint_groups(path) == ["inv_mass", "step_size"]
    # a float64 template gets float64 leaves
    t64 = template._replace(logdensity=torch.zeros(3, dtype=torch.float64))
    assert tio.load_checkpoint(path, t64)[0].logdensity.dtype == torch.float64


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    tio.save_checkpoint(path, {"x": torch.zeros(3)}, seed=0, step=1)
    with pytest.raises(ValueError, match="shape"):
        tio.load_checkpoint(path, {"x": torch.zeros(4)})


def test_checkpoint_names_match_and_foreign_checkpoint_raises(tmp_path):
    """Same npz keys for the state and the extras in both packages; only the
    random-stream entry differs, and that is why neither loads the other's."""
    jstate, tstate, extras = _states()
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_checkpoint(jp, jstate, key=jax.random.key(3), step=7, extras=extras)
    tio.save_checkpoint(tp, tstate, seed=3, step=7, extras=params_from_jax(extras, "cpu"))
    with np.load(jp) as j, np.load(tp) as t:
        assert set(j.files) - {"__key__"} == set(t.files) - {"__seed__"}
        assert "state::.position/weights" in t.files and "extra.step_size::" in t.files
        for k in set(t.files) - {"__seed__"}:
            np.testing.assert_array_equal(j[k], t[k])
    with pytest.raises(ValueError, match="checkpoint of the JAX package.*not portable"):
        tio.load_checkpoint(jp, tstate)
    np.savez(str(tmp_path / "other.npz"), a=np.zeros(2))
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        tio.load_checkpoint(str(tmp_path / "other.npz"), tstate)


def test_sharded_backend_single_process_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    block = {"w": rng.normal(size=(5, 4, 3)).astype(np.float32)}
    base = str(tmp_path / "draws.h5")
    with tio.ShardedHDF5Backend(base, mode="w") as b:
        b.append({"w": torch.from_numpy(block["w"])})
        b.append(block)
        assert b.num_draws() == 10 and set(b.read()) == {"w"}
        path0 = b.path
    assert path0 == tio.shard_paths(base, 1)[0] == jio.shard_paths(base, 1)[0]
    expect = np.concatenate([block["w"], block["w"]])
    np.testing.assert_array_equal(tio.assemble_shards([path0])["w"], expect)
    np.testing.assert_array_equal(jio.assemble_shards([path0])["w"], expect)   # the JAX reader
    np.testing.assert_allclose(tio.posterior_mean([path0])["w"], expect.mean(axis=0), rtol=1e-6)
    # a reopened shard pins its chains
    with tio.ShardedHDF5Backend(base, mode="a", chain_indices=[4, 5, 6, 7]) as b:
        with pytest.raises(ValueError, match="chain ownership mismatch"):
            b.append(block)
        b.truncate(5)
        assert b.num_draws() == 5


def test_sharded_backend_explicit_process_and_assembly(tmp_path):
    """Two writers with explicit process indices and chain blocks, as a
    sharded run will make them; assembly restores the global chain order
    whatever the order of the files."""
    full = np.arange(3 * 6 * 2, dtype=np.float32).reshape(3, 6, 2)
    base = str(tmp_path / "draws.h5")
    for rank, sl in enumerate([slice(3, 6), slice(0, 3)]):
        with tio.ShardedHDF5Backend(base, mode="w", process_index=rank,
                                    chain_indices=np.arange(sl.start, sl.stop)) as b:
            b.append({"w": torch.from_numpy(full[:, sl])})
    paths = tio.shard_paths(base, 2)
    np.testing.assert_array_equal(tio.assemble_shards(paths)["w"], full)
    np.testing.assert_array_equal(tio.assemble_shards(paths[::-1])["w"], full)
    np.testing.assert_array_equal(jio.assemble_shards(paths)["w"], full)
    block, idx = tio.local_chain_block(full[:, 3:6], [3, 4, 5])
    assert block.shape == (3, 3, 2) and idx.tolist() == [3, 4, 5]
    assert tio.local_chain_block(full)[1].tolist() == list(range(6))
    with pytest.raises(ValueError, match="chain indices"):
        tio.local_chain_block(full, [0, 1])


def test_assemble_shards_reorders_chains(tmp_path):
    full = np.arange(3 * 6 * 2, dtype=np.float32).reshape(3, 6, 2)
    paths = []
    for i, sl in enumerate([slice(3, 6), slice(0, 3)]):     # chains 3..5 first
        p = str(tmp_path / f"draws_{i}.h5")
        with h5py.File(p, "w") as f:
            f.create_dataset("w", data=full[:, sl])
            f.create_dataset("__chain_indices__", data=np.arange(sl.start, sl.stop))
        paths.append(p)
    np.testing.assert_array_equal(tio.assemble_shards(paths)["w"], full)


@pytest.mark.parametrize("indices, message", [
    ([[0, 1, 2], [2, 3, 4]], "same chains more than once"),
    ([[0, 1, 2], [4, 5, 6]], "do not cover a contiguous chain range"),
], ids=["duplicates", "gap"])
def test_assemble_shards_rejects_bad_coverage(tmp_path, indices, message):
    paths = []
    for i, idx in enumerate(indices):
        p = str(tmp_path / f"draws_{i}.h5")
        with h5py.File(p, "w") as f:
            f.create_dataset("w", data=np.zeros((2, 3, 2), np.float32))
            f.create_dataset("__chain_indices__", data=np.asarray(idx))
        paths.append(p)
    with pytest.raises(ValueError, match=message):
        tio.assemble_shards(paths)


@pytest.mark.parametrize("storage", ["device", "host"])
@pytest.mark.parametrize("total", [8, None], ids=["sized", "growing"])
def test_draw_buffer_fills_one_buffer(storage, total):
    blocks = _blocks(3, sizes=(4, 3, 1))
    backend = sampling.DeviceBackend(num_draws=total, storage=storage)
    for blk in blocks:
        backend.append({k: torch.from_numpy(v) for k, v in blk.items()})
    assert backend.num_draws() == 8
    got = backend.draws()
    for k in got:
        expect = np.swapaxes(np.concatenate([b[k] for b in blocks]), 0, 1)
        assert got[k].shape == expect.shape                    # (C, T, ...)
        np.testing.assert_array_equal(got[k].numpy(), expect)
    if total is not None and storage == "device":
        assert got["weights"].is_contiguous()                  # the buffer itself, no copy
        assert got["weights"].data_ptr() == backend.draws()["weights"].data_ptr()
    backend.truncate(4)
    backend.append({k: torch.from_numpy(v[:2]) for k, v in blocks[0].items()})
    assert backend.num_draws() == 6
    np.testing.assert_array_equal(backend.draws()["bias"][:, 4:].numpy(),
                                  np.swapaxes(blocks[0]["bias"][:2], 0, 1))
    with pytest.raises(ValueError, match="storage"):
        sampling.DeviceBackend(storage="disk")
    with pytest.raises(ValueError, match="no draws"):
        sampling.DeviceBackend().draws()


def test_tee_backend_keeps_and_forwards(tmp_path):
    path = str(tmp_path / "tee.h5")
    blocks = _blocks(4)
    with sampling.TeeDeviceBackend(tio.HDF5Backend(path, "w"), num_draws=8) as b:
        for blk in blocks:
            b.append({k: torch.from_numpy(v) for k, v in blk.items()})
        assert b.num_draws() == 8
        b.truncate(5)
        assert b.num_draws() == 5 and b.draws()["bias"].shape == (3, 5, 2)
    with tio.HDF5Backend(path, "r") as f:
        assert f.num_draws() == 5
    alone = sampling.TeeDeviceBackend()
    alone.append({k: torch.from_numpy(v) for k, v in blocks[0].items()})
    assert alone.num_draws() == 5


def test_choose_draw_storage_and_draw_bytes():
    pos = {"weights": torch.zeros(4, 5, 3), "bias": torch.zeros(4, 3)}
    assert sampling.draw_bytes(4, 10, pos) == 4 * 4 * 10 * 18
    assert sampling.choose_draw_storage(10 ** 12, "cpu") == "device"
    assert sampling.choose_draw_storage(100, "cpu", threshold_bytes=100) == "device"
    assert sampling.choose_draw_storage(101, "cpu", threshold_bytes=100) == "host"


def test_host_buffer_gives_the_device_paths_diagnostics():
    """The blockwise diagnostics over a host buffer (a tiny block width, so
    every leaf takes several blocks) against the calls the device path makes."""
    rng = np.random.RandomState(5)
    chains, draws = 4, 60
    noise = rng.randn(draws, chains, 6, 3).astype(np.float32)
    for t in range(1, draws):                      # AR(1): an ESS below the cap
        noise[t] += 0.6 * noise[t - 1]
    block = {"weights": torch.from_numpy(noise),
             "bias": torch.from_numpy(rng.randn(draws, chains, 3).astype(np.float32))}
    dev_b, host_b = sampling.DeviceBackend(draws), sampling.DeviceBackend(draws, "host")
    for b in (dev_b, host_b):
        b.append({k: v[:25] for k, v in block.items()})
        b.append({k: v[25:] for k, v in block.items()})
    q = dev_b.draws()
    ess = torch.cat([effective_sample_size(q["bias"]).reshape(-1),
                     effective_sample_size(q["weights"], block_size=512).reshape(-1)])
    rh = torch.cat([split_rhat(q["bias"]).reshape(-1), split_rhat(q["weights"]).reshape(-1)])
    diag = draw_diagnostics(host_b.draws(), "cpu", block_bytes=4 * chains * draws * 4)
    torch.testing.assert_close(diag["ess"], ess, rtol=1e-5, atol=0)
    torch.testing.assert_close(diag["rhat"], rh, rtol=1e-5, atol=0)
    assert float(ess.min()) < 0.8 * chains * draws
    for k in q:
        torch.testing.assert_close(diag["mean"][k], q[k].mean(dim=(0, 1)), rtol=1e-5, atol=1e-6)

    def predict(p, x):
        return torch.softmax(x @ p["weights"] + p["bias"], dim=-1)

    X = torch.from_numpy(rng.randn(9, 6).astype(np.float32))
    torch.testing.assert_close(posterior_predictive_probs(predict, host_b.draws(), X, 16),
                               posterior_predictive_probs(predict, q, X, 16), rtol=0, atol=0)
