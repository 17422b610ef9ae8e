"""Dataset loaders.

Every generator draws from a numpy ``RandomState`` in the JAX package's
order, so the arrays are byte-identical to that package's; they come back as
numpy.  ``blobs`` is the 2-D binary problem of config 2.

``mnist(path, split)`` reads MNIST from an HDF5 file in the layout
``X_train`` / ``y_train`` / ``X_test`` / ``y_test`` (an explicit path, else
``$DHMC_DATA_DIR/mnist_train.h5``, else ``./data/mnist_train.h5``); without a
file it generates the deterministic MNIST-shaped synthetic set, byte-identical
to the JAX package's generator (numpy ``RandomState``).  The arrays come back
as numpy (X float32 (n, 784), y int32 (n,)); nothing is cached on disk.
``digits()`` reads ``digits.npz`` beside this module, so it needs no
scikit-learn.  ``plantvillage_features(path, ...)`` reads ``features`` /
``labels`` from an HDF5 file, else generates the synthetic PlantVillage-shaped
conv-feature set of config 5.  ``h5py`` is imported only where a file is read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def blobs(n: int = 1000, d: int = 2, sep: float = 3.0, seed: int = 0,
          test_fraction: float = 0.2):
    """Two separable Gaussian blobs (binary): ((X_train, y_train), (X_test,
    y_test)), float32."""
    rng = np.random.RandomState(seed)
    n2 = n // 2
    X = np.concatenate([
        rng.randn(n2, d) - sep / 2.0,
        rng.randn(n - n2, d) + sep / 2.0,
    ]).astype(np.float32)
    y = np.concatenate([np.zeros(n2), np.ones(n - n2)]).astype(np.float32)
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    n_test = int(n * test_fraction)
    return (X[n_test:], y[n_test:]), (X[:n_test], y[:n_test])


def synthetic_classification(n: int, d: int, k: int, seed: int = 0,
                             noise: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly separable-ish K-class data from a ground-truth softmax model."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32) / np.sqrt(d)
    logits = X @ W + noise * rng.randn(n, k).astype(np.float32)
    return X, logits.argmax(-1).astype(np.int32)


def train_test_split(X, y, test_fraction: float = 0.2, seed: int = 0):
    """((X_train, y_train), (X_test, y_test)) by a seeded permutation."""
    n = X.shape[0]
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(n * test_fraction)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return (X[train_idx], y[train_idx]), (X[test_idx], y[test_idx])


def _find_mnist_h5(path: Optional[str] = None) -> Optional[str]:
    """A real mnist_train.h5: the explicit path, ``$DHMC_DATA_DIR``, or the
    conventional ``./data`` and repo-root ``data`` directories; None when
    there is none."""
    if path is not None:
        return path if os.path.exists(path) else None
    candidates = []
    env = os.environ.get("DHMC_DATA_DIR")
    if env:
        candidates.append(os.path.join(env, "mnist_train.h5"))
    here = os.path.dirname(__file__)
    candidates += [
        os.path.join(os.getcwd(), "data", "mnist_train.h5"),
        os.path.join(here, "..", "..", "data", "mnist_train.h5"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def mnist_provenance(path: Optional[str] = None) -> str:
    """'hdf5:<path>' when ``mnist(path)`` will read a real MNIST file, else
    'synthetic-mnist'; carried into the bench and CLI JSON lines, so a number
    on synthetic data cannot be read as a real-MNIST result."""
    resolved = _find_mnist_h5(path)
    return f"hdf5:{resolved}" if resolved else "synthetic-mnist"


def mnist(path: Optional[str] = None, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """MNIST from an HDF5 file (``X_<split>`` / ``y_<split>``), found as
    ``_find_mnist_h5`` says; without one the synthetic stand-in: 60000
    (``split="test"``: 10000, seed 1) x 784, 10 classes, pixels k/256."""
    path = _find_mnist_h5(path)
    if path is not None:
        import h5py

        with h5py.File(path, "r") as f:
            X = np.asarray(f[f"X_{split}"], np.float32)
            y = np.asarray(f[f"y_{split}"]).astype(np.int32)
        if X.max() > 1.5:
            # /256, not /255: 8-bit pixels k/256 are exact in bf16, so the
            # fused kernel's bf16 X carries no rounding error and runs no
            # X_lo passes (ops.softmax_glm.split_bf16_input)
            X = X / 256.0
        if y.ndim == 2:     # labels stored one-hot
            y = y.argmax(-1).astype(np.int32)
        return X.reshape(X.shape[0], -1), y

    n = 60000 if split == "train" else 10000
    rng = np.random.RandomState(0 if split == "train" else 1)
    # class-conditional pixel means with calibrated overlap (a linear softmax
    # tops out near real-MNIST accuracy) and 4% label noise (positive Fisher
    # information at the MAP); the draw order matches the JAX package's
    centers = rng.rand(10, 784).astype(np.float32) * 0.12
    y = rng.randint(0, 10, size=n).astype(np.int32)
    X = centers[y] + 0.3 * np.abs(rng.randn(n, 784).astype(np.float32))
    flip = rng.rand(n) < 0.04
    y = np.where(flip, rng.randint(0, 10, size=n), y).astype(np.int32)
    X = np.clip(X, 0.0, 1.0)
    X = np.round(X * 256.0) / 256.0          # the 8-bit grid k/256
    return X, y


def plantvillage_provenance(path: Optional[str] = None) -> str:
    """'hdf5:<path>' when ``plantvillage_features(path)`` will read a file,
    else 'synthetic-plantvillage'."""
    if path is not None and os.path.exists(path):
        return f"hdf5:{path}"
    return "synthetic-plantvillage"


def plantvillage_features(path: Optional[str] = None, n: int = 20000, dim: int = 512,
                          k: int = 38, seed: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """PlantVillage conv-feature classifier data: ``features`` / ``labels``
    of the HDF5 file at ``path``, or, without one, synthetic: clustered
    conv-feature-like activations (ReLU-censored Gaussians around class
    centres), 38 classes like PlantVillage.  X float32 (n, dim), y int32 (n,)."""
    if path is not None and os.path.exists(path):
        import h5py

        with h5py.File(path, "r") as f:
            X = np.asarray(f["features"], np.float32)
            y = np.asarray(f["labels"]).astype(np.int32)
        return X, y

    rng = np.random.RandomState(seed)
    centers = np.maximum(rng.randn(k, dim).astype(np.float32), 0.0)
    y = rng.randint(0, k, size=n).astype(np.int32)
    X = np.maximum(centers[y] + 0.5 * rng.randn(n, dim).astype(np.float32), 0.0)
    return X, y


def digits() -> Tuple[np.ndarray, np.ndarray]:
    """Real bundled image data (scikit-learn's 8x8 digits, 1797 x 64,
    10 classes), pixels scaled to [0, 1] as ``load_digits().data / 16``.

    ``digits.npz`` holds scikit-learn's bundled copy of the UCI optical
    digits as uint8 (``pixels`` 0..16, ``labels``), written once by
    ``np.savez_compressed(path, pixels=d.data.astype(np.uint8),
    labels=d.target.astype(np.uint8))`` with ``d = load_digits()``."""
    with np.load(os.path.join(os.path.dirname(__file__), "digits.npz")) as f:
        pixels, labels = f["pixels"], f["labels"]
    return (pixels.astype(np.float64) / 16.0).astype(np.float32), labels.astype(np.int32)
