"""Fused multi-chain softmax-GLM log-posterior value and gradient.

The hot op of the headline sampler: every leapfrog step needs, for all C
chains at once,

    value_c = sum_n y_n . log_softmax(X_n W_c + b_c)  + log prior(W_c, b_c)
    grad_W  = X^T (Y - softmax(X W_c + b_c)) - alpha W_c
    grad_b  = sum_n (Y - softmax(.))_n        - alpha b_c

``softmax_value_and_grad`` routes by device.  A CUDA tensor launches the
hand-written kernel in ``csrc/softmax_glm.cu`` (built with nvcc at first use)
or raises; nothing falls back to the plain version there.  A CPU tensor goes
to ``softmax_value_and_grad_plain``, two ``torch.matmul`` calls around a
``log_softmax``, which is also the reference the kernel is held against on
the card.

Parameters are the chain-batched dict layout {'weights': (C, D, K),
'bias': (C, K)}; the kernel's (D, C*K) chain-major layout is this module's
business.  The Gaussian prior is added outside the kernel, in f32, as the JAX
package does (its nparam is D*K + K per chain).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .cuda_build import load_library

# Supported class count of the compiled kernel (the port's datasets have 10).
KERNEL_CLASSES = 10

# Launches of the CUDA kernel, per variant.  Raised only where the kernel is
# launched; the CPU route leaves them alone.
launch_counts: Dict[str, int] = {"value_and_grad": 0, "grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_inputs(X, Y, W, b) -> Tuple[int, int, int, int]:
    for name, t in (("X", X), ("Y", Y), ("W", W), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
    if X.dim() != 2 or Y.dim() != 2 or W.dim() != 3 or b.dim() != 2:
        raise ValueError("expected X (N, D), Y (N, K), W (C, D, K), b (C, K); got "
                         f"{tuple(X.shape)}, {tuple(Y.shape)}, {tuple(W.shape)}, "
                         f"{tuple(b.shape)}")
    N, D = X.shape
    C, _, K = W.shape
    if Y.shape != (N, K) or W.shape != (C, D, K) or b.shape != (C, K):
        raise ValueError("inconsistent shapes: X %s, Y %s, W %s, b %s"
                         % (tuple(X.shape), tuple(Y.shape), tuple(W.shape),
                            tuple(b.shape)))
    if N == 0 or D == 0 or C == 0 or K == 0:
        raise ValueError("empty input")
    if not X.is_contiguous() or not Y.is_contiguous():
        raise ValueError("X and Y must be contiguous")
    return N, D, K, C


def log_prior_batched(W: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Per-chain Gaussian log prior, nparam = D*K + K for each chain."""
    C, D, K = W.shape
    nparam = float(D * K + K)
    sq = (W * W).sum(dim=(1, 2)) + (b * b).sum(dim=1)
    return 0.5 * nparam * math.log(alpha / (2.0 * math.pi)) - 0.5 * alpha * sq


def softmax_value_and_grad_plain(X, Y, W, b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Likelihood value (C,) and gradients (C, D, K), (C, K): the plain
    PyTorch version of the kernel, two GEMMs over all chains at once."""
    N, D, K, C = _check_inputs(X, Y, W, b)
    W2 = W.permute(1, 0, 2).reshape(D, C * K)               # chain-major columns
    Z = (X @ W2).view(N, C, K) + b                          # (N, C, K)
    logp = torch.log_softmax(Z, dim=-1)
    ll = (Y[:, None, :] * logp).sum(dim=(0, 2))             # (C,)
    R = Y[:, None, :] - torch.exp(logp)                     # (N, C, K)
    gw = (X.T @ R.reshape(N, C * K)).view(D, C, K).permute(1, 0, 2)
    gb = R.sum(dim=0)
    return ll, gw.contiguous(), gb


def _launch(X, Y, W, b, with_value: bool):
    """Run the CUDA kernel: likelihood value (or None) and gradients."""
    N, D, K, C = X.shape[0], X.shape[1], W.shape[2], W.shape[0]
    if K != KERNEL_CLASSES:
        raise NotImplementedError(
            f"the CUDA softmax-GLM kernel is compiled for K={KERNEL_CLASSES} "
            f"classes, got K={K}")
    lib = _kernel_lib()
    dev = X.device
    with torch.cuda.device(dev):
        W2 = W.permute(1, 0, 2).reshape(D, C * K).contiguous()
        b2 = b.reshape(C * K).contiguous()
        n_tiles = -(-N // lib.dhmc_softmax_glm_tile_rows())
        f32 = dict(dtype=torch.float32, device=dev)
        gw_part = torch.empty((n_tiles, D, C * K), **f32)
        gb_part = torch.empty((n_tiles, C * K), **f32)
        gw2 = torch.empty((D, C * K), **f32)
        gb = torch.empty((C, K), **f32)
        ll_part = torch.empty((n_tiles, C), **f32) if with_value else None
        ll = torch.empty((C,), **f32) if with_value else None
        stream = torch.cuda.current_stream(dev).cuda_stream

        def ptr(t: Optional[torch.Tensor]):
            return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

        err = lib.dhmc_softmax_glm(
            ptr(X), ptr(Y), ptr(W2), ptr(b2), ptr(ll_part), ptr(gw_part),
            ptr(gb_part), ptr(ll), ptr(gw2), ptr(gb), N, D, K, C,
            int(with_value), dev.index if dev.index is not None else
            torch.cuda.current_device(), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.dhmc_cuda_error_string(err).decode()
        raise RuntimeError(f"softmax_glm CUDA kernel launch failed: {msg} ({err})")
    launch_counts["value_and_grad" if with_value else "grad"] += 1
    gw = gw2.view(D, C, K).permute(1, 0, 2).contiguous()
    return ll, gw, gb


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("softmax_glm")
    if not getattr(lib, "_dhmc_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dhmc_softmax_glm.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.dhmc_softmax_glm.restype = ci
        lib.dhmc_softmax_glm_tile_rows.argtypes = []
        lib.dhmc_softmax_glm_tile_rows.restype = ci
        lib.dhmc_cuda_error_string.argtypes = [ci]
        lib.dhmc_cuda_error_string.restype = ctypes.c_char_p
        lib._dhmc_typed = True
    return lib


def build_kernel() -> float:
    """Build (if needed) and load the CUDA library; returns build seconds."""
    from .cuda_build import BUILD_INFO

    _kernel_lib()
    return BUILD_INFO["softmax_glm"]["seconds"]


def softmax_value_and_grad(X, Y, W, b, alpha: float, *, fwd_full: bool = True,
                           include_prior: bool = True):
    """Fused log-posterior value + gradient for all chains in one X pass.

    Returns (value (C,) or None, grad_W (C, D, K), grad_b (C, K)), float32.
    ``fwd_full=False`` is the grad-only variant used by the inner leapfrog
    steps: it returns None for the value.  ``include_prior=False`` returns
    the likelihood-only value and gradients (the data-parallel composition:
    sum the outputs of row shards, add the prior once).
    """
    _check_inputs(X, Y, W, b)
    if X.device.type == "cuda":
        value, gw, gb = _launch(X, Y, W, b, with_value=fwd_full)
    elif X.device.type == "cpu":
        value, gw, gb = softmax_value_and_grad_plain(X, Y, W, b)
        if not fwd_full:
            value = None
    else:
        raise ValueError(f"unsupported device {X.device}")
    if include_prior:
        if value is not None:
            value = value + log_prior_batched(W, b, alpha)
        gw = gw - alpha * W
        gb = gb - alpha * b
    return value, gw, gb
