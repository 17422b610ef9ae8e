"""The port's dataset loaders give the JAX package's arrays, byte for byte."""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dropout_hamiltonian_montecarlo_tpu.io import datasets as jds  # noqa: E402
from dropout_hamiltonian_montecarlo_tpu_torch.io import datasets  # noqa: E402


def test_synthetic_mnist_is_byte_identical(tmp_path, monkeypatch):
    """The JAX loader caches its arrays next to its package; pointing its
    module path into a temporary directory makes it regenerate them there,
    so neither side reads or writes the repository's cache."""
    monkeypatch.setattr(jds, "__file__", str(tmp_path / "pkg" / "io" / "datasets.py"))
    monkeypatch.delenv("DHMC_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert datasets.mnist_provenance() == jds.mnist_provenance() == "synthetic-mnist"
    X, y = datasets.mnist()
    jX, jy = jds.mnist()
    assert X.dtype == np.float32 and y.dtype == np.int32
    assert X.shape == (60000, 784) and y.shape == (60000,)
    assert X.tobytes() == np.asarray(jX).tobytes()
    assert y.tobytes() == np.asarray(jy).tobytes()
    # 8-bit grid k/256, exact in f32
    np.testing.assert_array_equal(X * 256.0, np.round(X * 256.0))


def test_digits_match():
    X, y = datasets.digits()
    jX, jy = jds.digits()
    assert X.shape == (1797, 64)
    assert X.tobytes() == np.asarray(jX).tobytes()
    assert y.tobytes() == np.asarray(jy).tobytes()


def test_digits_needs_no_sklearn(monkeypatch):
    """The port needs no scikit-learn: it reads its bundled copy."""
    from sklearn import datasets as sk

    ref = sk.load_digits()
    monkeypatch.setitem(sys.modules, "sklearn", None)
    X, y = datasets.digits()
    assert X.tobytes() == (ref.data / 16.0).astype(np.float32).tobytes()
    assert y.tobytes() == ref.target.astype(np.int32).tobytes()


@pytest.mark.parametrize("kwargs", [{}, {"n": 301, "d": 3, "sep": 2.0, "seed": 5,
                                         "test_fraction": 0.25}], ids=["default", "odd"])
def test_blobs_are_byte_identical(kwargs):
    (Xtr, ytr), (Xte, yte) = datasets.blobs(**kwargs)
    (jXtr, jytr), (jXte, jyte) = jds.blobs(**kwargs)
    for got, ref in ((Xtr, jXtr), (ytr, jytr), (Xte, jXte), (yte, jyte)):
        assert got.dtype == np.float32
        assert got.tobytes() == np.asarray(ref).tobytes()


def test_synthetic_classification_is_byte_identical():
    X, y = datasets.synthetic_classification(200, 6, 4, seed=3, noise=0.7)
    jX, jy = jds.synthetic_classification(200, 6, 4, seed=3, noise=0.7)
    assert X.tobytes() == np.asarray(jX).tobytes()
    assert y.dtype == np.int32 and y.tobytes() == np.asarray(jy).tobytes()


def test_train_test_split_is_byte_identical():
    X, y = datasets.synthetic_classification(100, 3, 2, seed=1)
    (Xtr, ytr), (Xte, yte) = datasets.train_test_split(X, y, test_fraction=0.3, seed=4)
    (jXtr, jytr), (jXte, jyte) = jds.train_test_split(X, y, test_fraction=0.3, seed=4)
    assert Xte.shape[0] == 30 and Xtr.shape[0] == 70
    for got, ref in ((Xtr, jXtr), (ytr, jytr), (Xte, jXte), (yte, jyte)):
        assert got.tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize("kwargs", [{"n": 500}, {"n": 123, "dim": 40, "k": 7, "seed": 9}],
                         ids=["default-width", "small"])
def test_plantvillage_features_are_byte_identical(kwargs):
    X, y = datasets.plantvillage_features(**kwargs)
    jX, jy = jds.plantvillage_features(None, **kwargs)
    assert X.dtype == np.float32 and y.dtype == np.int32
    assert X.shape == (kwargs["n"], kwargs.get("dim", 512)) and float(X.min()) >= 0.0
    assert X.tobytes() == np.asarray(jX).tobytes()
    assert y.tobytes() == np.asarray(jy).tobytes()
    assert datasets.plantvillage_provenance() == jds.plantvillage_provenance(None)


# ---- the HDF5 readers, on files written in the reference's layout -------------

def _write_h5(path, **arrays):
    import h5py

    with h5py.File(path, "w") as f:
        for name, arr in arrays.items():
            f[name] = arr


@pytest.fixture
def mnist_file(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    path = str(tmp_path / "mnist_train.h5")
    _write_h5(path,
              X_train=rng.randint(0, 256, (32, 28, 28)).astype(np.float32),
              y_train=np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)],
              X_test=(rng.randint(0, 256, (8, 784)) / 255.0).astype(np.float32),
              y_test=rng.randint(0, 10, 8).astype(np.int64))
    return path


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_hdf5_reader_matches_jax(mnist_file, split):
    """8-bit pixels are divided by 256 (exact in bf16), pixels already in
    [0, 1] are left alone, one-hot labels become classes, images flatten."""
    X, y = datasets.mnist(mnist_file, split)
    jX, jy = jds.mnist(mnist_file, split)
    n = 32 if split == "train" else 8
    assert X.shape == (n, 784) and y.shape == (n,)
    assert X.dtype == np.float32 and y.dtype == np.int32
    assert X.tobytes() == np.asarray(jX).tobytes() and y.tobytes() == np.asarray(jy).tobytes()
    assert 0.0 <= float(X.min()) and float(X.max()) <= 1.0
    if split == "train":
        np.testing.assert_array_equal(X * 256.0, np.round(X * 256.0))


def test_mnist_file_is_found_as_the_jax_package_finds_it(mnist_file, tmp_path, monkeypatch):
    import os

    monkeypatch.delenv("DHMC_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)           # no ./data/mnist_train.h5 here
    monkeypatch.setattr(jds, "__file__", str(tmp_path / "pkg" / "io" / "datasets.py"))
    monkeypatch.setattr(datasets, "__file__", str(tmp_path / "pkg" / "io" / "datasets.py"))
    missing = str(tmp_path / "nothing.h5")
    for path, want in ((mnist_file, f"hdf5:{mnist_file}"), (missing, "synthetic-mnist"),
                       (None, "synthetic-mnist")):
        assert datasets.mnist_provenance(path) == jds.mnist_provenance(path) == want
    monkeypatch.setenv("DHMC_DATA_DIR", os.path.dirname(mnist_file))
    assert datasets.mnist_provenance() == jds.mnist_provenance() == f"hdf5:{mnist_file}"
    assert datasets.mnist()[0].shape == (32, 784)
    monkeypatch.delenv("DHMC_DATA_DIR")
    os.makedirs(tmp_path / "data")
    os.replace(mnist_file, tmp_path / "data" / "mnist_train.h5")
    found = os.path.join(os.getcwd(), "data", "mnist_train.h5")
    assert datasets.mnist_provenance() == jds.mnist_provenance() == f"hdf5:{found}"


def test_synthetic_mnist_test_split_is_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(jds, "__file__", str(tmp_path / "pkg" / "io" / "datasets.py"))
    monkeypatch.delenv("DHMC_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    X, y = datasets.mnist(split="test")
    jX, jy = jds.mnist(split="test")
    assert X.shape == (10000, 784) and y.shape == (10000,)
    assert X.tobytes() == np.asarray(jX).tobytes() and y.tobytes() == np.asarray(jy).tobytes()


def test_plantvillage_hdf5_reader_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.RandomState(3)
    path = str(tmp_path / "features.h5")
    _write_h5(path, features=rng.rand(20, 16).astype(np.float64),
              labels=rng.randint(0, 38, 20).astype(np.int64))
    X, y = datasets.plantvillage_features(path)
    jX, jy = jds.plantvillage_features(path)
    assert X.shape == (20, 16) and X.dtype == np.float32 and y.dtype == np.int32
    assert X.tobytes() == np.asarray(jX).tobytes() and y.tobytes() == np.asarray(jy).tobytes()
    assert datasets.plantvillage_provenance(path) == jds.plantvillage_provenance(path)
    assert datasets.plantvillage_provenance(path) == f"hdf5:{path}"
    missing = str(tmp_path / "none.h5")
    assert datasets.plantvillage_provenance(missing) == "synthetic-plantvillage"
    assert datasets.plantvillage_features(missing, n=50)[0].shape == (50, 512)


def test_off_grid_pixels_take_the_x_lo_passes(mnist_file):
    """Pixels stored as k/255 are not exact in bf16: the kernel's input split
    keeps a lo piece, so a launch runs the X_lo passes; the reader's k/256
    rule for 8-bit pixels leaves none."""
    import torch

    from dropout_hamiltonian_montecarlo_tpu_torch.ops.softmax_glm import split_bf16_input

    on_grid, _ = datasets.mnist(mnist_file, "train")
    off_grid, _ = datasets.mnist(mnist_file, "test")
    hi, lo = split_bf16_input(torch.from_numpy(on_grid))
    assert lo is None and hi.shape == (32, 784)
    hi, lo = split_bf16_input(torch.from_numpy(off_grid))
    assert lo is not None and lo.shape == (8, 784) and bool(lo.x.any())
    # hi + lo carries X to ~2^-17 of its size
    back = hi.x[:, :784].float() + lo.x[:, :784].float()
    assert float((back - torch.from_numpy(off_grid)).abs().max()) < 2.0 ** -16
