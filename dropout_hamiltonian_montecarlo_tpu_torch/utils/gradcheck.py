"""Finite-difference gradient checker for any scalar function of a params
dict."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import tree_ravel


def check_gradient(fn, params, analytic_grad=None, dh: float = 1e-3,
                   rtol: float = 2e-2, atol: float = 2e-2) -> bool:
    """Compare grad(fn) (or a provided analytic grad dict) against central
    finite differences (f(x + h) - f(x - h)) / 2h on every coordinate of one
    chain's ``params``.  Returns True if all coordinates match; raises
    AssertionError with the worst offender otherwise.

    The default dh and atol are sized for float32 evaluation: round-off in
    the central difference is ~eps_f32 |f| / dh, so dh = 1e-3 keeps it ~1e-2
    for |f| ~ 1e2."""
    if analytic_grad is None:
        analytic_grad = torch.func.grad(fn)(params)

    flat, unravel = tree_ravel(params)
    g = tree_ravel(analytic_grad)[0].detach().double().cpu().numpy()
    x = flat.detach().double().cpu().numpy()
    num = np.zeros_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = dh
        fp = float(fn(unravel(torch.as_tensor(x + e, dtype=flat.dtype, device=flat.device))))
        fm = float(fn(unravel(torch.as_tensor(x - e, dtype=flat.dtype, device=flat.device))))
        num[i] = (fp - fm) / (2 * dh)
    if not np.allclose(g, num, rtol=rtol, atol=atol):
        err = np.abs(g - num)
        i = int(np.argmax(err))
        raise AssertionError(
            f"gradient mismatch at flat index {i}: analytic={g[i]:.6g} "
            f"numeric={num[i]:.6g} (max abs err {err[i]:.3g})")
    return True
