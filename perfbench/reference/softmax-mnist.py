"""Plain reference of the ``softmax-mnist`` configuration, and the comparison
that decides ``correct`` in its cells.

Bayesian softmax regression, p(W, b | X, y) with a N(0, 1/alpha) prior on
every weight and bias: the log posterior and its gradient in float64 with
plain ``torch`` operations, over blocks of rows.  The Kronecker Gauss-Newton
set-up (augmented Gram eigenbasis, natural-gradient Newton to the MAP from
zero, class Fisher at the MAP) is worked out again from X, in float64.
Nothing of the program is imported, and nothing it made is used but to be
judged.

The program samples in its own whitened coordinates e, with
q = q_map + U_g (e / sqrt(d)) U_a^T (the bias the last row of q).  Those
coordinates are the program's output format: the reference reads the
program's U_g, U_a, d and q_map to map the program's positions and gradients
to parameter space, after judging that map against its own set-up
(``map_gap``, ``metric_gap``).  The sampler can only be followed step by step
from the program's own states (a trajectory amplifies float32 rounding, so
no independent run stays near the program's): for every captured draw the
reference recomputes the value and gradient at every position the program
evaluated, holds every three consecutive leapfrog positions to the
reference's gradient at the middle one, and, given the draw's random numbers
(kept by the harness), follows the draw's decisions: HMC's acceptance from
the trajectory's ends and its accept test, NUTS's tree (its U-turns,
divergences, multinomial leaf and biased subtree choices, replayed in
float64 from the program's leaf values and gradients), and the gauge Gibbs
move against its conditional law.

Numbers returned (each at most its limit):
  map_gap       max |M_ref^1/2 (q_map - q_map_ref)|: the MAP's error in
                whitened units (both from the same start, 60 Newton steps)
  metric_gap    max over probes v off the gauge directions of
                ||M_ref^-1/2 M M_ref^-1/2 v - v|| / ||v||
  value_gap     max |value - value_ref| over every checked position (nats)
  grad_gap      max over chains of ||g_e - g_e_ref|| / ||g_e_ref||
  leapfrog_gap  max over chains of ||(e+ - 2 e + e-) / eps^2 - g_e_ref(e)|| /
                ||g_e_ref(e)|| over three consecutive leapfrog positions
  momentum_gap  max over chains of ||p0 - p|| / ||p||: p0 the momentum the
                first leapfrog step used (from its positions), p the draw's
  accept_gap    (HMC) max |acceptance prob - the reference's from the
                trajectory's ends|
  accept_mismatch  chains whose move disagrees with their accept flag, or
                   that moved to a position the program never evaluated;
                   HMC: whose flag disagrees with u < acceptance prob, or
                   that sit elsewhere than the trajectory's end (accepted)
                   or its start (rejected)
  tree_mismatch (NUTS) chains whose new position is none of the leaves the
                replayed tree may choose (a choice within rounding of its
                uniform allows both outcomes), of the chains whose U-turns
                and divergences are clear of rounding (see ``nuts_choice``)
  gibbs_gap     max over chains and rows of |e_new - (m + s u)| / s on the
                gauge column, m and s the conditional's mean and sd from the
                program's coordinates, u the move's normals
  gauge_moved   coordinates outside the gauge column changed by the Gibbs move
  draw_z        the largest |z| of the draw's random numbers against their
                law: the mean and variance of p0 (N(0, 1)) and of the new
                gauge column standardised by its conditional, the share of
                forward directions (1/2) and the mean of the uniforms (1/2)
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
ROW_BLOCK = 15000


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def augment(X: torch.Tensor) -> torch.Tensor:
    """[X, 1] in float64."""
    return torch.cat([X.to(F64), torch.ones((X.shape[0], 1), dtype=F64, device=X.device)],
                     dim=1)


def log_posterior(Q: torch.Tensor, X1: torch.Tensor, Y: torch.Tensor, alpha: float):
    """Q (C, D+1, K) float64, the bias the last row; returns the (C,) log
    posterior and its (C, D+1, K) gradient."""
    C, D1, K = Q.shape
    Q2 = Q.permute(1, 0, 2).reshape(D1, C * K)
    value = torch.zeros((C,), dtype=F64, device=Q.device)
    grad = torch.zeros((D1, C * K), dtype=F64, device=Q.device)
    for r in range(0, X1.shape[0], ROW_BLOCK):
        xb = X1[r:r + ROW_BLOCK]
        yb = Y[r:r + ROW_BLOCK].to(F64)
        logp = torch.log_softmax((xb @ Q2).view(-1, C, K), dim=-1)
        value += (yb[:, None, :] * logp).sum(dim=(0, 2))
        resid = yb[:, None, :] - torch.exp(logp)
        grad += xb.T @ resid.reshape(-1, C * K)
    nparam = D1 * K
    value += 0.5 * nparam * math.log(alpha / (2.0 * math.pi)) - 0.5 * alpha * (Q * Q).sum(dim=(1, 2))
    return value, grad.view(D1, C, K).permute(1, 0, 2) - alpha * Q


def gn_setup(X: torch.Tensor, Y: torch.Tensor, alpha: float, newton_steps: int,
             init_seed: int):
    """(s_g, U_g, s_a, U_a, q_map) in float64: eigenpairs of the augmented
    Gram matrix and of the class Fisher at the MAP, and the MAP (D+1, K),
    found by natural-gradient Newton steps under the uniform class Fisher
    from the configuration's start: weights 0.01 N(0, 1) drawn by a
    generator on X's device seeded ``init_seed``, bias 0."""
    _no_tf32()
    X1 = augment(X)
    D, K = X.shape[1], Y.shape[1]
    s_g, U_g = torch.linalg.eigh((X1.T @ X1).cpu())
    s_g = s_g.clamp(min=0.0).to(X1.device)
    U_g = U_g.to(X1.device)
    A0 = (torch.eye(K, dtype=F64) / K - torch.ones((K, K), dtype=F64) / K ** 2)
    s0, U0 = torch.linalg.eigh(A0)
    s0, U0 = s0.clamp(min=0.0).to(X1.device), U0.to(X1.device)
    d0 = torch.outer(s_g, s0) + alpha
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(init_seed))
    w0 = 1e-2 * torch.randn((D, K), generator=gen, dtype=torch.float32, device=X.device)
    q = torch.cat([w0.to(F64), torch.zeros((1, K), dtype=F64, device=X.device)])[None]
    for _ in range(newton_steps):
        _, g = log_posterior(q, X1, Y, alpha)
        q = q + U_g @ ((U_g.T @ g[0] @ U0) / d0) @ U0.T
    probs = torch.softmax(X1 @ q[0], dim=-1)
    A = torch.diag(probs.mean(dim=0)) - probs.T @ probs / probs.shape[0]
    s_a, U_a = torch.linalg.eigh(A.cpu())
    return s_g, U_g, s_a.clamp(min=0.0).to(X1.device), U_a.to(X1.device), q[0]


class Basis:
    """The program's whitened coordinates, in float64."""

    def __init__(self, basis):
        self.U_g = basis["U_g"].to(F64)
        self.U_a = basis["U_a"].to(F64)
        self.d = basis["d_aug"].to(F64)
        self.sqrt_d = torch.sqrt(self.d)
        q = basis["qmap"]
        self.qmap = torch.cat([q["weights"], q["bias"][None]], dim=0).to(F64)

    def to_params(self, E: torch.Tensor) -> torch.Tensor:
        return self.qmap + self.U_g @ (E / self.sqrt_d) @ self.U_a.T

    def grad_to_whitened(self, G: torch.Tensor) -> torch.Tensor:
        return (self.U_g.T @ G @ self.U_a) / self.sqrt_d


def pack(p) -> torch.Tensor:
    """{'weights': (C, D, K), 'bias': (C, K)} -> (C, D+1, K) float64."""
    return torch.cat([p["weights"], p["bias"][:, None, :]], dim=1).to(F64)


def _chain_norm(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1).norm(dim=1)


def _z_normal(x: torch.Tensor):
    """|z| of the mean and the variance of ``x``'s entries against N(0, 1)."""
    x = x.to(F64).flatten()
    m = x.numel()
    return [abs(float(x.mean())) * math.sqrt(m),
            abs(float(x.var()) - 1.0) * math.sqrt(m / 2.0)]


def _z_mean(x: torch.Tensor, mean: float, var: float) -> float:
    """|z| of the mean of ``x``'s entries against a law of that mean and
    variance."""
    x = x.to(F64).flatten()
    return abs(float(x.mean()) - mean) / math.sqrt(var / x.numel())


TURN_TOL = 1e-4          # a U-turn dot product within this share of |a| |b| is undecided


def _turning(r_left, r_right, rho):
    """Betancourt's criterion with the boundary momenta at half weight, unit
    mass: (turning, undecided), each (C,)."""
    rho = rho - 0.5 * (r_left + r_right)
    dl, dr = (r_left * rho).sum(1), (r_right * rho).sum(1)
    nrho = rho.norm(dim=1)
    close = ((dl.abs() < TURN_TOL * r_left.norm(dim=1) * nrho)
             | (dr.abs() < TURN_TOL * r_right.norm(dim=1) * nrho))
    return (dl <= 0) | (dr <= 0), close


def _trailing_ones(i: int) -> int:
    n = 0
    while i & 1:
        n, i = n + 1, i >> 1
    return n


def nuts_choice(z0, r0, logp0, g0, leaves, direction, leaf_u, bias_u, eps, max_depth,
                divergence=1000.0):
    """The leaves a NUTS draw may move to, replayed in float64 (multinomial
    proposals within a subtree, biased progressive sampling across subtrees,
    the U-turn criterion over every power-of-two sub-subtree, divergence at
    ``divergence`` nats), from the start (z0, r0, logp0, g0; (C, P) and (C,))
    and the program's leaves in the order evaluated (``leaves``: (z, value,
    grad) each, P-vectors a chain), with the draw's uniforms.

    A choice whose probability lies within 2^-20 of the start's energy (16
    float32 roundings of it) of its uniform, on the log scale, may go either
    way: both outcomes stay allowed.  Returns (allowed (C, L + 1) bool: the
    leaves, by index in ``leaves``, the new position may be, the last column
    z0; undecided (C,) bool: a U-turn within ``TURN_TOL`` or a divergence
    within a nat of its threshold, whose outcome changes the tree; short
    (C,) bool: the leaves ran out while the chain's tree grew)."""
    C, L = z0.shape[0], len(leaves)
    false = torch.zeros(C, dtype=torch.bool, device=z0.device)
    one_hot = torch.eye(L + 1, dtype=torch.bool, device=z0.device)
    energy0 = -logp0 + 0.5 * (r0 * r0).sum(1)
    tol = 1e-3 + 2.0 ** -20 * energy0.abs()
    undecided, short = false.clone(), false.clone()
    allowed = one_hot[L].expand(C, L + 1).clone()
    r_left = r_right = r0
    g_left = g_right = g0
    r_sum, log_weight = r0, torch.zeros_like(logp0)
    diverging, turning = false.clone(), false.clone()
    k = 0

    def choose(prev, new, log_u, log_p, live):
        """(C, L + 1): ``new`` where the choice is taken, ``prev`` where not,
        both where it may go either way; ``prev`` where not ``live``."""
        taken = log_u < log_p
        either = ((log_u - log_p).abs() < tol) & (log_p < tol)
        out = torch.where((live & taken)[:, None], new, prev)
        return torch.where((live & either)[:, None], prev | new, out)

    for depth in range(max_depth):
        active = ~(diverging | turning)
        fwd = direction[depth]
        sign = torch.where(fwd, 1.0, -1.0).to(F64)
        e = (sign * eps)[:, None]
        r = torch.where(fwd[:, None], r_right, r_left)
        g = torch.where(fwd[:, None], g_right, g_left)
        sub_weight = torch.full_like(logp0, -math.inf)
        sub_sum = torch.zeros_like(r)
        sub_allowed = torch.zeros_like(allowed)
        sub_div, sub_turn = false.clone(), false.clone()
        r_at, sum_at = [], []
        for i in range(2 ** depth):
            live = active & ~(sub_div | sub_turn)
            if k >= L:
                short |= live
                break
            _, v, g_new = leaves[k]
            r_new = r + 0.5 * e * g + 0.5 * e * g_new
            energy = -v + 0.5 * (r_new * r_new).sum(1)
            energy = torch.where(torch.isnan(energy), math.inf, energy)
            delta = energy0 - energy
            div_new = -delta > divergence
            undecided |= live & ((-delta - divergence).abs() < 1.0)
            total = torch.logaddexp(sub_weight, delta)
            sub_allowed = choose(sub_allowed, one_hot[k].expand(C, L + 1),
                                 torch.log(leaf_u[depth, i].to(F64)), delta - total, live)
            r = torch.where(live[:, None], r_new, r)
            g = torch.where(live[:, None], g_new, g)
            sub_sum = torch.where(live[:, None], sub_sum + r, sub_sum)
            r_at.append(r)
            sum_at.append(sub_sum)
            turn_new = false
            if i % 2 == 1:
                for m in range(1, _trailing_ones(i) + 1):
                    j = i + 1 - 2 ** m
                    t, close = _turning(r_at[j], r, sub_sum - sum_at[j] + r_at[j])
                    turn_new = turn_new | t
                    undecided |= live & close
                turn_new = turn_new & ~div_new
            sub_weight = torch.where(live, total, sub_weight)
            sub_div = torch.where(live, div_new, sub_div)
            sub_turn = torch.where(live, turn_new, sub_turn)
            k += 1
        new_left = torch.where(fwd[:, None], r_left, r)
        new_right = torch.where(fwd[:, None], r, r_right)
        allowed = choose(allowed, sub_allowed, torch.log(bias_u[depth].to(F64)),
                         torch.clamp(sub_weight - log_weight, max=0.0),
                         active & ~(sub_div | sub_turn))
        sum_all = torch.where(active[:, None], r_sum + sub_sum, r_sum)
        full_turn, close = _turning(new_left, new_right, sum_all)
        undecided |= active & close
        a = active[:, None]
        g_left = torch.where(a, torch.where(fwd[:, None], g_left, g), g_left)
        g_right = torch.where(a, torch.where(fwd[:, None], g, g_right), g_right)
        r_left = torch.where(a, new_left, r_left)
        r_right = torch.where(a, new_right, r_right)
        r_sum = sum_all
        log_weight = torch.where(active, torch.logaddexp(log_weight, sub_weight), log_weight)
        diverging = torch.where(active, sub_div, diverging)
        turning = torch.where(active, sub_turn | full_turn, turning)
        if k >= L and not bool((~(diverging | turning)).any()):
            break
    return allowed, undecided, short


def check_whitened(X, Y, alpha, newton_steps, init_seed, basis, captures, step_size, *,
                   sampler: str, tree_depth: int = 0) -> dict:
    """The numbers compared for the softmax cells (see the module's text).
    ``captures``: the harness's records of captured draws; ``sampler`` "hmc"
    or "nuts" (with its ``tree_depth`` cap)."""
    _no_tf32()
    X1 = augment(X)
    B = Basis(basis)
    s_g, U_g, s_a, U_a, qmap_ref = gn_setup(X, Y, alpha, newton_steps, init_seed)
    d_ref = torch.outer(s_g, s_a) + alpha

    dq = B.qmap - qmap_ref
    map_gap = float((torch.sqrt(d_ref) * (U_g.T @ dq @ U_a)).abs().max())
    # the metric off the gauge directions (a shift of every class's weight
    # by one amount), where the likelihood is flat: there M is the prior's
    # alpha, and what the program's float32 class Fisher leaves in its null
    # eigenvalue is rounding, not curvature (the Gibbs move samples them)
    K = Y.shape[1]
    uniform = torch.full((K,), 1.0 / math.sqrt(K), dtype=F64, device=X.device)

    def off_gauge(V):
        return V - (V @ uniform)[:, None] * uniform[None, :]

    gen = torch.Generator(device=X.device)
    gen.manual_seed(0)
    metric_gap = 0.0
    for _ in range(4):
        V = off_gauge(torch.randn(qmap_ref.shape, generator=gen, dtype=F64, device=X.device))
        W = U_g @ ((U_g.T @ V @ U_a) / torch.sqrt(d_ref)) @ U_a.T
        MW = B.U_g @ (B.d * (B.U_g.T @ W @ B.U_a)) @ B.U_a.T
        Z = off_gauge(U_g @ ((U_g.T @ MW @ U_a) / torch.sqrt(d_ref)) @ U_a.T) - V
        metric_gap = max(metric_gap, float(Z.norm() / V.norm()))

    def vag(E):
        v, g = log_posterior(B.to_params(E), X1, Y, alpha)
        return v, B.grad_to_whitened(g)

    # the gauge column and its conditional law N(m, s^2) in the program's
    # coordinates: along it the likelihood is flat and the prior alone acts
    align = (B.U_a.T @ uniform).abs()
    j0 = int(align.argmax())
    gauge_m = -B.sqrt_d[:, j0] * (B.U_g.T @ B.qmap @ B.U_a)[:, j0]
    gauge_s = torch.sqrt(B.d[:, j0] / alpha)

    value_gap = grad_gap = leapfrog_gap = accept_gap = momentum_gap = gibbs_gap = 0.0
    mismatch = moved_outside = tree_mismatch = undecided = either = 0
    z = []
    eps = step_size.to(F64)[:, None, None]
    for cap in captures:
        states = [cap.pre, cap.post_kernel, cap.post_gibbs]
        checked = [(s.position, s.logdensity, s.grad) for s in states] + list(cap.calls)
        ref = []
        for E, v, G in checked:
            e = pack(E)
            v_ref, g_ref = vag(e)
            ref.append((e, v_ref, g_ref))
            if v is not None:
                value_gap = max(value_gap, float((v.to(F64) - v_ref).abs().max()))
            grad_gap = max(grad_gap, float((_chain_norm(pack(G) - g_ref)
                                            / _chain_norm(g_ref)).max()))
        e0 = ref[0][0]
        g0 = pack(cap.pre.grad)
        calls = [(pack(E), G) for E, _, G in cap.calls]
        calls_ref = ref[3:]

        # three consecutive leapfrog positions a, b, c: (a - 2b + c) / eps^2 is
        # the gradient at b.  HMC: the draw's start, then its L calls in
        # order.  NUTS: the leaves of each doubling's subtree in order; a
        # chain that has stopped repeats a position, and its triples go out.
        if sampler == "hmc":
            runs = [[(e0, None)] + [(e, g) for e, _, g in calls_ref]]
        else:
            runs, start = [], 0
            for depth in range(tree_depth):
                runs.append([(e, g) for e, _, g in calls_ref[start:start + 2 ** depth]])
                start += 2 ** depth
        for run in runs:
            for (a, _), (b, gb), (c, _) in zip(run, run[1:], run[2:]):
                live = (_chain_norm(a - b) > 0) & (_chain_norm(b - c) > 0)
                resid = _chain_norm((a - 2.0 * b + c) / eps ** 2 - gb) / _chain_norm(gb)
                if bool(live.any()):
                    leapfrog_gap = max(leapfrog_gap, float(resid[live].max()))

        # the momentum the first leapfrog step used, from its positions
        p = pack(cap.draws["momentum"])
        sign = 1.0
        if sampler == "nuts":
            sign = torch.where(cap.draws["direction"][0], 1.0, -1.0).to(F64)[:, None, None]
        e_first = sign * eps
        p0 = (calls[0][0] - e0) / e_first - 0.5 * e_first * g0
        momentum_gap = max(momentum_gap, float((_chain_norm(p0 - p) / _chain_norm(p)).max()))
        z += _z_normal(p0)

        e_post = ref[1][0]
        moved = _chain_norm(e_post - e0) > 0
        if sampler == "hmc":
            # the acceptance from the trajectory's ends, all of it the
            # reference's: its values, and momenta from its gradients
            (e1, _, _), (eL1, _, _), (eL, vL, gL) = calls_ref[0], calls_ref[-2], calls_ref[-1]
            _, v0_ref, g0_ref = ref[0]
            p0_ref = (e1 - e0) / eps - 0.5 * eps * g0_ref
            pL_ref = (eL - eL1) / eps + 0.5 * eps * gL
            h0 = -v0_ref + 0.5 * (p0_ref * p0_ref).sum(dim=(1, 2))
            h1 = -vL + 0.5 * (pL_ref * pL_ref).sum(dim=(1, 2))
            a_ref = torch.exp(torch.clamp(h0 - h1, max=0.0))
            a_ref = torch.where(torch.isnan(a_ref), torch.zeros_like(a_ref), a_ref)
            accept_gap = max(accept_gap, float((cap.accept_prob.to(F64) - a_ref).abs().max()))
            # the MH test with the draw's uniforms; an accepted chain at the
            # trajectory's end, a rejected one at its start
            u = cap.draws["uniforms"]
            mismatch += int((cap.accepted != (u < cap.accept_prob)).sum())
            at_end = (e_post == eL).flatten(1).all(1)
            at_start = (e_post == e0).flatten(1).all(1)
            mismatch += int(torch.where(cap.accepted, ~at_end, ~at_start).sum())
            z.append(_z_mean(u, 0.5, 1.0 / 12.0))
        else:
            allowed, unclear, short = nuts_choice(
                e0.flatten(1), p.flatten(1), cap.pre.logdensity.to(F64), g0.flatten(1),
                [(e.flatten(1), v.to(F64), pack(G).flatten(1))
                 for (e, G), (_, v, _) in zip(calls, cap.calls)],
                cap.draws["direction"], cap.draws["leaf_uniform"], cap.draws["bias_uniform"],
                step_size.to(F64), tree_depth)
            at = torch.stack([(e == e_post).flatten(1).all(1) for e, _ in calls]
                             + [(e0 == e_post).flatten(1).all(1)], dim=1)
            wrong = ~(at & allowed).any(dim=1) | short
            tree_mismatch += int((wrong & ~unclear).sum())
            undecided += int(unclear.sum())
            either += int((allowed.sum(dim=1) > 1).sum())
            z.append(_z_mean(cap.draws["direction"], 0.5, 0.25))
            z.append(_z_mean(cap.draws["leaf_uniform"], 0.5, 1.0 / 12.0))
            z.append(_z_mean(cap.draws["bias_uniform"], 0.5, 1.0 / 12.0))
        # a chain moved iff its flag says so, and only to a position evaluated
        mismatch += int((moved != cap.accepted).sum())
        to_call = torch.stack([(e - e_post).abs().flatten(1).amax(dim=1) for e, _ in calls])
        mismatch += int((moved & (to_call.amin(dim=0) > 0)).sum())

        # the Gibbs move: the gauge column drawn from its conditional with the
        # move's normals, nothing else changed
        e_gibbs = ref[2][0]
        col = e_gibbs[:, :, j0]
        want = gauge_m[None] + gauge_s[None] * cap.gibbs_eps.to(F64)
        gibbs_gap = max(gibbs_gap, float(((col - want).abs() / gauge_s[None]).max()))
        z += _z_normal((col - gauge_m[None]) / gauge_s[None])
        changed = e_gibbs != e_post
        changed[:, :, j0] = False
        moved_outside += int(changed.sum())
    if align[j0] < 1.0 - 1e-6:
        moved_outside += 1

    out = {"map_gap": map_gap, "metric_gap": metric_gap, "value_gap": value_gap,
           "grad_gap": grad_gap, "leapfrog_gap": leapfrog_gap, "momentum_gap": momentum_gap}
    if sampler == "hmc":
        out["accept_gap"] = accept_gap
    else:
        out["tree_mismatch"] = float(tree_mismatch)
    out.update(accept_mismatch=float(mismatch), gibbs_gap=gibbs_gap,
               gauge_moved=float(moved_outside), draw_z=max(z, default=0.0),
               captured=len(captures),
               info={"tree_undecided_chains": undecided, "tree_either_way_chains": either}
               if sampler == "nuts" else {})
    return out
