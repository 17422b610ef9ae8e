"""Dataset loaders.

Every generator draws from a numpy ``RandomState`` in the JAX package's
order, so the arrays are byte-identical to that package's; they come back as
numpy.  ``blobs`` is the 2-D binary problem of config 2.

``mnist()`` generates the deterministic MNIST-shaped synthetic training set,
byte-identical to the JAX package's generator (numpy ``RandomState``).  The
arrays come back as numpy (X float32 (60000, 784) on the 8-bit k/256 grid,
y int32 (60000,)); nothing is cached on disk.  ``digits()`` reads
``digits.npz`` beside this module, so it needs no scikit-learn.  Reading a
real MNIST HDF5 file is not ported yet.  ``plantvillage_features()`` is the
synthetic PlantVillage-shaped conv-feature set of config 5; its HDF5 reader
waits for the file layer too.
"""

from __future__ import annotations

import os
from typing import Tuple

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


def mnist_provenance() -> str:
    """Where ``mnist()``'s arrays come from: always the synthetic generator."""
    return "synthetic-mnist"


def mnist() -> Tuple[np.ndarray, np.ndarray]:
    """The synthetic MNIST stand-in: 60000 x 784, 10 classes, pixels k/256."""
    n = 60000
    rng = np.random.RandomState(0)
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


def plantvillage_provenance() -> str:
    """Where ``plantvillage_features()``'s arrays come from: always the
    synthetic generator."""
    return "synthetic-plantvillage"


def plantvillage_features(n: int = 20000, dim: int = 512, k: int = 38,
                          seed: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """PlantVillage conv-feature classifier data, synthetic: clustered
    conv-feature-like activations (ReLU-censored Gaussians around class
    centres), 38 classes like PlantVillage.  X float32 (n, dim), y int32 (n,)."""
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
