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

The kernel runs its GEMMs on the tensor cores on exact bf16 pieces of its
operands (see the note at the top of the CUDA source).  X is constant over a
run, so its pieces are cut once, by ``split_bf16_input``, and handed to every
call (``x_split=``), as the JAX package does; W is cut on every call
(``split_weights``).

Parameters are the chain-batched dict layout {'weights': (C, D, K),
'bias': (C, K)}; the kernel's layouts are this module's business.  The
Gaussian prior is added outside the kernel, in f32, as the JAX package does
(its nparam is D*K + K per chain).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .cuda_build import load_library

# Class counts the compiled kernel takes (a forward work item holds 8 or 16
# chains x K classes of logits: a wgmma width of at most 256).
KERNEL_MIN_CLASSES, KERNEL_MAX_CLASSES = 2, 16
TILE_ROWS = 128        # rows of X per forward work item
BACKWARD_COLS = 160    # columns of gW per backward block
STEP = 64              # reduction step of both GEMMs
MAX_SLICE_STEPS = 160  # reduction steps in one slice of the gradient GEMM (10240 rows)

# Launches of the CUDA kernel, per variant, and the forward work items whose
# epilogue could run under another item's main loop (work items minus
# persistent blocks, summed over launches).  Raised only where the kernel is
# launched; the CPU route leaves them alone.
launch_counts: Dict[str, int] = {"value_and_grad": 0, "grad": 0}
forward_items_overlapped = 0


def reset_launch_counts() -> None:
    global forward_items_overlapped
    for k in launch_counts:
        launch_counts[k] = 0
    forward_items_overlapped = 0


def _check_inputs(X, Y, W, b, dtypes=(torch.float32,)) -> Tuple[int, int, int, int]:
    for name, t in (("X", X), ("Y", Y), ("W", W), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in dtypes or t.dtype != X.dtype:
            raise TypeError(f"{name} must be one of {dtypes} like X, got {t.dtype}")
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
    PyTorch version of the kernel, two GEMMs over all chains at once, in the
    inputs' dtype (float32, or float64 for a reference evaluation)."""
    N, D, K, C = _check_inputs(X, Y, W, b, dtypes=(torch.float32, torch.float64))
    W2 = W.permute(1, 0, 2).reshape(D, C * K)               # chain-major columns
    Z = (X @ W2).view(N, C, K) + b                          # (N, C, K)
    logp = torch.log_softmax(Z, dim=-1)
    ll = (Y[:, None, :] * logp).sum(dim=(0, 2))             # (C,)
    R = Y[:, None, :] - torch.exp(logp)                     # (N, C, K)
    gw = (X.T @ R.reshape(N, C * K)).view(D, C, K).permute(1, 0, 2)
    gb = R.sum(dim=0)
    return ll, gw.contiguous(), gb


# ---- bf16 pieces -------------------------------------------------------------

def _pad8(n: int) -> int:
    """Leading dimensions of the kernel's bf16 operands are multiples of 8
    elements: TMA takes only 16-byte-aligned strides."""
    return -(-n // 8) * 8


class BF16Piece(NamedTuple):
    """One bf16 piece of X (N, D) in the two layouts the kernel reads.

    ``x``  (N, pad8(D)): the piece, row-major, for the logits GEMM;
    ``xt`` (D + 1, pad8(N)): its transpose plus a last row of ones (the hi
    piece) or zeros (the lo piece), for the gradient GEMM, whose row D is
    then sum_n R = grad_b.  Padding columns are zero and never read."""
    x: torch.Tensor
    xt: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return self.x.shape[0], self.xt.shape[0] - 1


def _bf16_piece(p: torch.Tensor, last_row: float) -> BF16Piece:
    N, D = p.shape
    x = p.new_zeros((N, _pad8(D)))
    x[:, :D] = p
    xt = p.new_zeros((D + 1, _pad8(N)))
    xt[:D, :N] = p.T
    xt[D, :N] = last_row
    return BF16Piece(x, xt)


def split_bf16_input(X: torch.Tensor) -> Tuple[BF16Piece, Optional[BF16Piece]]:
    """Cut a constant input into bf16 pieces ONCE per run: hi = bf16(X)
    (round to nearest even) and lo = bf16(X - hi), the split of
    ``pallas_glm.split_bf16_input``.  When X is exact in bf16 (8-bit pixels
    k/256, digits k/16) lo is zero and this returns (hi, None); the kernel
    then skips the X_lo passes."""
    if X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError(f"X must be a float32 matrix, got {X.dtype} {tuple(X.shape)}")
    hi = X.to(torch.bfloat16)
    lo = (X - hi.float()).to(torch.bfloat16)
    return (_bf16_piece(hi, 1.0),
            _bf16_piece(lo, 0.0) if bool(lo.any()) else None)


def split_weights(W: torch.Tensor, n_pieces: int) -> torch.Tensor:
    """(C, D, K) f32 -> (n_pieces, C*K, pad8(D)) bf16: W transposed to
    chain-major rows c*K + k (so the GEMM reads it K-major) and cut into
    pieces W_0 = bf16(W), W_p = bf16(W - W_0 - ... - W_{p-1}); every
    subtraction is exact in f32.  Two pieces are the JAX wrapper's
    ``_split_bf16`` pair."""
    C, D, K = W.shape
    rest = W.permute(0, 2, 1).reshape(C * K, D)
    out = W.new_zeros((n_pieces, C * K, _pad8(D)), dtype=torch.bfloat16)
    for p in range(n_pieces):
        piece = rest.to(torch.bfloat16)
        out[p, :, :D] = piece
        if p + 1 < n_pieces:
            rest = rest - piece.float()
    return out


def backward_slices(N: int, D: int, CK: int, slots: int) -> int:
    """Slices S of the gradient GEMM's N reduction.

    Each slice holds at most MAX_SLICE_STEPS reduction steps: the tensor
    cores add into their f32 accumulators with truncation, so the gradient
    drifts with the length of its accumulation chain, by ~2.5e-7 max|g| a
    step (H100 SXM, bench shape: 1.5e-4 max|g| with 469 steps a slice, 6.3e-5
    with 235, 3.1e-5 with 134, 1.2e-5 with 67; the bound is 1e-4).  Among the
    S allowed: the fewest waves of (output tiles x S) blocks over the
    ``slots`` blocks the device runs at once, per slice; the smaller S on
    ties; never more slices than reduction steps."""
    tiles = -(-(D + 1) // TILE_ROWS) * -(-CK // BACKWARD_COLS)
    steps = -(-N // STEP)
    least = -(-steps // MAX_SLICE_STEPS)
    best, best_cost = least, float("inf")
    for s in range(least, max(least, min(steps, 32)) + 1):
        cost = -(-tiles * s // slots) / s
        if cost < best_cost - 1e-12:
            best, best_cost = s, cost
    return best


def forward_schedule(N: int, C: int, group: int, slots: int) -> Tuple[int, int]:
    """(work items, persistent blocks) of the forward stage.

    A work item is one (128-row tile, chain group of ``group`` chains); the
    grid is as many blocks as the device runs at once (``slots``), or fewer
    where there are fewer items.  Each block walks its items as
    ``forward_walk`` lists them; items - blocks epilogues can run under
    another item's main loop."""
    if slots < 1 or group < 1:
        raise ValueError(f"need slots >= 1 and group >= 1, got {slots}, {group}")
    n_items = -(-N // TILE_ROWS) * -(-C // group)
    return n_items, min(n_items, slots)


def forward_walk(n_items: int, grid: int, n_groups: int):
    """The forward kernel's order of work: block b takes items b, b + grid,
    ...; item i is (row tile i // n_groups, chain group i % n_groups), so the
    groups of a row tile run at once on neighbouring blocks.  Returns, per
    block, its (tile, group) pairs in the order it runs them."""
    return [[(i // n_groups, i % n_groups) for i in range(b, n_items, grid)]
            for b in range(grid)]


# ---- the CUDA kernel -------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


class KernelCall:
    """Buffers and launches of one kernel call: ``forward()`` (logits,
    softmax, R^T pieces, ll partials), ``backward()`` (the gradient GEMM's
    slice partials) and ``finish()`` (the fixed-order sums) run in that order
    on the current stream; ``run()`` runs all three.  The outputs are
    ``ll`` (C,) or None, ``gw`` (C, D, K) and ``gb`` (C, K).  Launches made
    through this class directly are not counted in ``launch_counts``."""

    def __init__(self, x_split: Tuple[BF16Piece, Optional[BF16Piece]], Y, W, b,
                 with_value: bool):
        hi, lo = x_split
        C, D, K = W.shape
        N = Y.shape[0]
        if hi.shape != (N, D) or (lo is not None and lo.shape != (N, D)):
            raise ValueError(f"x_split is for X of shape {hi.shape}, not {(N, D)}")
        if not KERNEL_MIN_CLASSES <= K <= KERNEL_MAX_CLASSES:
            raise NotImplementedError(
                f"the CUDA softmax-GLM kernel takes {KERNEL_MIN_CLASSES} to "
                f"{KERNEL_MAX_CLASSES} classes, got K={K}")
        self.lib = _kernel_lib()
        self.dev = W.device
        self.device_index = (self.dev.index if self.dev.index is not None
                             else torch.cuda.current_device())
        for t in (hi.x, hi.xt) + ((lo.x, lo.xt) if lo is not None else ()):
            if t.device != self.dev:
                raise ValueError(f"x_split is on {t.device}, W on {self.dev}")
        self.N, self.D, self.K, self.C = N, D, K, C
        self.hi, self.lo, self.Y = hi, lo, Y
        CK = C * K
        with torch.cuda.device(self.dev):
            self.w = split_weights(W, 3 if with_value else 2)
            self.b2 = b.reshape(CK).contiguous()
            f32 = dict(dtype=torch.float32, device=self.dev)
            self.ldr = hi.xt.shape[1]
            self.rt = torch.empty((2, CK, self.ldr), dtype=torch.bfloat16, device=self.dev)
            self.n_tiles = -(-N // TILE_ROWS)
            self.n_items, self.grid = forward_schedule(
                N, C, _forward_group(K, with_value),
                _forward_slots(self.device_index, K, with_value))
            self.ll_part = torch.empty((self.n_tiles, C), **f32) if with_value else None
            self.slices = backward_slices(N, D, CK, _backward_slots(self.device_index))
            self.part = torch.empty((self.slices, D + 1, CK), **f32)
            self.ll = torch.empty((C,), **f32) if with_value else None
            self.gw = torch.empty((C, D, K), **f32)
            self.gb = torch.empty((C, K), **f32)

    def _check(self, err: int, stage: str) -> None:
        if err != 0:
            msg = self.lib.dhmc_cuda_error_string(err).decode()
            raise RuntimeError(f"softmax_glm CUDA kernel ({stage}) failed: {msg} ({err})")

    def _stream(self) -> ctypes.c_void_p:
        return ctypes.c_void_p(torch.cuda.current_stream(self.dev).cuda_stream)

    def forward(self) -> None:
        lo = self.lo.x if self.lo is not None else None
        self._check(self.lib.dhmc_glm_forward(
            _ptr(self.hi.x), _ptr(lo), self.hi.x.shape[1], _ptr(self.w), self.w.shape[0],
            _ptr(self.Y), _ptr(self.b2), _ptr(self.rt), self.ldr, _ptr(self.ll_part),
            self.N, self.D, self.K, self.C, self.grid, self.device_index, self._stream()),
            "forward")

    def backward(self) -> None:
        lo = self.lo.xt if self.lo is not None else None
        self._check(self.lib.dhmc_glm_backward(
            _ptr(self.hi.xt), _ptr(lo), _ptr(self.rt), self.ldr, _ptr(self.part),
            self.slices, self.N, self.D, self.C * self.K, self.device_index,
            self._stream()), "backward")

    def finish(self) -> None:
        self._check(self.lib.dhmc_glm_finish(
            _ptr(self.part), self.slices, self.D, self.K, self.C, _ptr(self.ll_part),
            self.n_tiles, _ptr(self.gw), _ptr(self.gb), _ptr(self.ll), self.device_index,
            self._stream()), "finish")

    def run(self):
        self.forward()
        self.backward()
        self.finish()
        return self.ll, self.gw, self.gb


@functools.lru_cache(maxsize=None)
def _forward_group(K: int, with_value: bool) -> int:
    group = _kernel_lib().dhmc_glm_forward_group(K, int(with_value))
    if group <= 0:
        raise RuntimeError(f"softmax_glm: no forward chain group for K={K}")
    return group


@functools.lru_cache(maxsize=None)
def _forward_slots(device_index: int, K: int, with_value: bool) -> int:
    slots = _kernel_lib().dhmc_glm_forward_slots(K, int(with_value), device_index)
    if slots <= 0:
        raise RuntimeError("softmax_glm: could not size the forward grid on "
                           f"cuda:{device_index}")
    return slots


@functools.lru_cache(maxsize=None)
def _backward_slots(device_index: int) -> int:
    slots = _kernel_lib().dhmc_glm_backward_slots(device_index)
    if slots <= 0:
        raise RuntimeError("softmax_glm: could not size the backward grid on "
                           f"cuda:{device_index}")
    return slots


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("softmax_glm")
    if not getattr(lib, "_dhmc_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dhmc_glm_forward.argtypes = [vp, vp, ci, vp, ci, vp, vp, vp, ci, vp,
                                         ci, ci, ci, ci, ci, ci, vp]
        lib.dhmc_glm_forward_group.argtypes = [ci, ci]
        lib.dhmc_glm_forward_slots.argtypes = [ci, ci, ci]
        lib.dhmc_glm_backward.argtypes = [vp, vp, vp, ci, vp, ci, ci, ci, ci, ci, vp]
        lib.dhmc_glm_finish.argtypes = [vp, ci, ci, ci, ci, vp, ci, vp, vp, vp, ci, vp]
        lib.dhmc_glm_backward_slots.argtypes = [ci]
        for fn in (lib.dhmc_glm_forward, lib.dhmc_glm_backward, lib.dhmc_glm_finish,
                   lib.dhmc_glm_forward_group, lib.dhmc_glm_forward_slots,
                   lib.dhmc_glm_backward_slots):
            fn.restype = ci
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
                           include_prior: bool = True,
                           x_split: Optional[Tuple[BF16Piece, Optional[BF16Piece]]] = None,
                           use_kernel: bool = True):
    """Fused log-posterior value + gradient for all chains in one call.

    Returns (value (C,) or None, grad_W (C, D, K), grad_b (C, K)), float32.
    ``fwd_full=False`` is the grad-only variant used by the inner leapfrog
    steps: it returns None for the value.  ``include_prior=False`` returns
    the likelihood-only value and gradients (the data-parallel composition:
    sum the outputs of row shards, add the prior once).  ``x_split`` is
    ``split_bf16_input(X)``, cut once per run; on a CUDA tensor without it,
    every call cuts X anew.  The plain (CPU) version ignores it.

    ``use_kernel=False`` asks for the plain version by name, on any device:
    the A/B switch of the bench (``BENCH_KERNEL=0``).  Nothing selects it
    silently: with the default, a CUDA tensor launches the kernel or raises.
    """
    global forward_items_overlapped
    _check_inputs(X, Y, W, b)
    if not use_kernel:
        value, gw, gb = softmax_value_and_grad_plain(X, Y, W, b)
        if not fwd_full:
            value = None
    elif X.device.type == "cuda":
        call = KernelCall(x_split if x_split is not None else split_bf16_input(X),
                          Y, W, b, with_value=fwd_full)
        value, gw, gb = call.run()
        launch_counts["value_and_grad" if fwd_full else "grad"] += 1
        forward_items_overlapped += call.n_items - call.grid
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
