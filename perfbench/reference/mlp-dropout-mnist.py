"""Plain reference of the ``mlp-dropout-mnist`` configuration, and the
comparison that decides ``correct`` in its cells.

The 784-256-256-10 ReLU MLP with inverted dropout (keep 1 - p_drop, kept
units scaled by 1 / keep) on the first and second hidden pre-activations and
on the last hidden activation, a N(0, 1/alpha) prior on every parameter up to
its constant, and the minibatch log likelihood scaled by n / B: the log
posterior of each chain in float64 with plain ``torch`` operations, its
gradient by autograd.  The SGHMC update (Chen, Fox and Guestrin 2014, unit
mass) in float64:

    v' = (1 - friction eps) v + eps grad + sqrt(2 friction eps) noise,
    q' = q + eps v'.

For every captured step the program's minibatch, masks and noise are the
inputs, drawn by the program from the seed; the reference recomputes from
them and the program's state before the step.

Numbers returned (each at most its limit); a gap of a chain is a norm over
all its parameters, and ``_q90`` the 90th percentile over the chains (the
largest over the captured steps):
  grad_gap      the median over chains of ||g - g_ref|| / ||g_ref||: the
                gradient the program's log density received, under the
                step's masks
  velocity_gap  the same median of ||(v' - (1 - f eps) v - sqrt(2 f eps) noise)
                / eps - g_ref|| / ||g_ref||: the gradient the update applied
  position_gap  the same median of ||max(|q' - q - eps v_ref'| - ulp(q'), 0)||
                / ||eps v_ref'||, v_ref' = (1 - f eps) v + eps g_ref
                + sqrt(2 f eps) noise: the move the update made, beyond one
                float32 rounding of q' (at eps 1e-5 that rounding alone is
                ~1e-3 of the move)
  grad_gap_q90, velocity_gap_q90, position_gap_q90: the 90th percentiles
  value_gap     max |log density after the step - reference's| under the
                step's final masks (nats)
  batch_mismatch  minibatch rows (pixels or label) that are no row of the data
  draw_z        the largest |z| of the step's random inputs against their
                law: the minibatch rows' index (mean, variance), the pairs of
                equal indices within a chain and across chains (uniform with
                replacement, a batch of its own a chain), the share of kept
                units (1 - p_drop)
The medians and 90th percentiles: the largest chain's gap swings from seed
to seed by 30x (a ReLU input within float32 rounding of 0 takes the other
branch in float64 and moves that row's whole contribution), and the control
does not separate it; it is printed beside the numbers, not compared.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
CHAIN_BLOCK = 8
KEYS = ("W1", "b1", "W2", "b2", "W3", "b3")


def log_posterior(params, X, Y, masks, n_data: int, alpha: float, p_drop: float):
    """(C,) log posterior of chain-batched ``params`` on per-chain
    minibatches X (C, B, D), Y (C, B, K) under bool keep-masks (3, C, B, H)."""
    keep = 1.0 - p_drop
    m1, m2, m3 = masks
    h = torch.baddbmm(params["b1"][:, None, :], X, params["W1"])
    h = torch.relu(torch.where(m1, h / keep, torch.zeros_like(h)))
    h = torch.baddbmm(params["b2"][:, None, :], h, params["W2"])
    h = torch.relu(torch.where(m2, h / keep, torch.zeros_like(h)))
    h = torch.where(m3, h / keep, torch.zeros_like(h))
    z = torch.baddbmm(params["b3"][:, None, :], h, params["W3"])
    ll = (Y * torch.log_softmax(z, dim=-1)).sum(dim=(1, 2)) * (n_data / X.shape[1])
    prior = sum((params[k] * params[k]).flatten(1).sum(dim=1) for k in KEYS)
    return ll - 0.5 * alpha * prior


def _flat(d, rows):
    return torch.cat([d[k][rows].to(F64).flatten(1) for k in sorted(d)], dim=1)


def _ulp32(x: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 numbers at |x|: one rounding of a float32 result."""
    _, exponent = torch.frexp(x.to(torch.float32))
    return torch.ldexp(torch.ones_like(x), exponent.to(x.dtype) - 24).to(x.dtype)


def _row_index(X, rows):
    """The index of each row of ``rows`` (M, D) in the data X (N, D), found by
    a float64 key; -1 where no row of X equals it exactly."""
    gen = torch.Generator(device=X.device)
    gen.manual_seed(0)
    w = torch.randn((X.shape[1],), generator=gen, dtype=F64, device=X.device)
    keys = X.to(F64) @ w
    order = torch.argsort(keys)
    sorted_keys = keys[order]
    idx = order[torch.searchsorted(sorted_keys, rows.to(F64) @ w).clamp(max=len(keys) - 1)]
    same = (X[idx] == rows).all(dim=1)
    return torch.where(same, idx, torch.full_like(idx, -1))


def _pairs(idx: torch.Tensor) -> float:
    """Pairs of equal entries of ``idx`` (1-D)."""
    _, counts = torch.unique(idx, return_counts=True)
    return float((counts * (counts - 1) // 2).sum())


def draw_z(idx: torch.Tensor, n_data: int, masks, p_drop: float) -> float:
    """The largest |z| of the step's draws against their law (see the module's
    text); ``idx`` (C, B) the minibatch rows' indices."""
    C, B = idx.shape
    u = idx.to(F64).flatten() / n_data
    m = u.numel()
    mean = (n_data - 1) / (2.0 * n_data)
    var = (n_data ** 2 - 1) / (12.0 * n_data ** 2)
    z = [(float(u.mean()) - mean) / math.sqrt(var / m),
         (float(u.var()) - var) / math.sqrt((1.0 / 80.0 - 1.0 / 144.0) / m)]
    within = sum(_pairs(idx[c]) for c in range(C))
    across = _pairs(idx.flatten()) - within
    e_within = C * B * (B - 1) / (2.0 * n_data)
    e_across = C * (C - 1) * B * B / (2.0 * n_data)
    z += [(within - e_within) / math.sqrt(e_within), (across - e_across) / math.sqrt(e_across)]
    kept = sum(float(mk.sum()) for mk in masks)
    total = sum(mk.numel() for mk in masks)
    keep = 1.0 - p_drop
    z.append((kept / total - keep) / math.sqrt(keep * p_drop / total))
    return max(abs(x) for x in z)


def check_sghmc(captures, X, Y, *, n_data: int, alpha: float, p_drop: float,
                friction: float) -> dict:
    """The numbers compared for the SGHMC cells (see the module's text);
    ``X``, ``Y`` the data the minibatches were gathered from."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("grad", "velocity", "position")
    gaps = {k: [] for k in names}
    value_gap = z_max = 0.0
    batch_mismatch = 0
    for cap in captures:
        Xb, Yb = cap.batch
        eps = cap.step_size
        chains = Xb.shape[0]
        idx = _row_index(X, Xb.reshape(-1, Xb.shape[-1]))
        found = idx >= 0
        found &= (Y[idx.clamp(min=0)] == Yb.reshape(-1, Yb.shape[-1])).all(dim=1)
        batch_mismatch += int((~found).sum())
        z_max = max(z_max, draw_z(idx.view(chains, -1), n_data, cap.masks[0], p_drop))
        per_chain = {k: [] for k in names}
        for c0 in range(0, chains, CHAIN_BLOCK):
            rows = slice(c0, c0 + CHAIN_BLOCK)
            xb, yb = Xb[rows].to(F64), Yb[rows].to(F64)
            params = {k: cap.q[k][rows].to(F64).requires_grad_(True) for k in KEYS}
            value = log_posterior(params, xb, yb, [m[rows] for m in cap.masks[0]],
                                  n_data, alpha, p_drop)
            grads = torch.autograd.grad(value.sum(), [params[k] for k in KEYS])
            g_ref = torch.cat([g.flatten(1) for _, g in
                               sorted(zip(KEYS, grads))], dim=1).detach()
            ref_norm = g_ref.norm(dim=1)
            g = _flat(cap.grads, rows)
            per_chain["grad"].append((g - g_ref).norm(dim=1) / ref_norm)

            v, v_new = _flat(cap.v, rows), _flat(cap.v_new, rows)
            noise = math.sqrt(2.0 * friction * eps) * _flat(cap.noise[0], rows)
            applied = (v_new - (1.0 - friction * eps) * v - noise) / eps
            per_chain["velocity"].append((applied - g_ref).norm(dim=1) / ref_norm)
            move_ref = eps * ((1.0 - friction * eps) * v + eps * g_ref + noise)
            q_new = _flat(cap.q_new, rows)
            off = (q_new - _flat(cap.q, rows) - move_ref).abs()
            beyond = torch.clamp(off - _ulp32(q_new), min=0.0)
            per_chain["position"].append(beyond.norm(dim=1) / move_ref.norm(dim=1))

            with torch.no_grad():
                q_new = {k: cap.q_new[k][rows].to(F64) for k in KEYS}
                value_ref = log_posterior(q_new, xb, yb, [m[rows] for m in cap.masks[1]],
                                          n_data, alpha, p_drop)
            value_gap = max(value_gap,
                            float((cap.value_new[rows].to(F64) - value_ref).abs().max()))
        for k in names:
            gaps[k].append(torch.cat(per_chain[k]))
    out = {"value_gap": value_gap, "batch_mismatch": float(batch_mismatch),
           "draw_z": z_max, "captured": len(captures), "info": {}}
    for k, per_cap in gaps.items():
        for tag, q in (("", 0.5), ("_q90", 0.9)):
            out[f"{k}_gap{tag}"] = max((float(torch.quantile(x, q)) for x in per_cap),
                                       default=0.0)
        for tag, q in (("_q75", 0.75), ("_q95", 0.95), ("_largest_chain", 1.0)):
            out["info"][f"{k}_gap{tag}"] = max((float(torch.quantile(x, q)) for x in per_cap),
                                               default=0.0)
    return out
