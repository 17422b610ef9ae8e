"""Dataset loaders for the headline workload.

``mnist()`` generates the deterministic MNIST-shaped synthetic training set,
byte-identical to the JAX package's generator (numpy ``RandomState``).  The
arrays come back as numpy (X float32 (60000, 784) on the 8-bit k/256 grid,
y int32 (60000,)); nothing is cached on disk.  scikit-learn is imported only
when ``digits()`` is called.  Reading a real MNIST HDF5 file is not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def digits() -> Tuple[np.ndarray, np.ndarray]:
    """Real bundled image data (scikit-learn's 8x8 digits, 1797 x 64,
    10 classes), pixels scaled to [0, 1]."""
    from sklearn import datasets as skdatasets

    d = skdatasets.load_digits()
    return (d.data / 16.0).astype(np.float32), d.target.astype(np.int32)
