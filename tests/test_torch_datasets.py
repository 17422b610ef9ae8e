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
