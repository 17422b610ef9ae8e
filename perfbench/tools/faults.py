"""Faults planted under the timed path, for the check's own tests (at a tiny
size on the CPU) and for readings on the card (``calibrate.py --fault``).
Each is planted in the program by ``plant(name, setattr)``, where
``setattr(owner, attribute, value)`` replaces an attribute of a module or
class of the program (pytest's ``monkeypatch.setattr``, or plain
``setattr`` in a process that runs only the fault).

Faults every cell can have: ``unchanged`` (the step returns its state),
``half_batch`` (half the data or minibatch left out, the mean taken over the
rest), ``altered`` (an answer altered where it is produced).  The softmax
cells also: ``gibbs_noop`` (the gauge Gibbs move does nothing),
``always_accept`` (the sampler's accept test or leaf choice ignores its
uniforms), ``momentum_ignored`` (the step draws a momentum of its own in
place of the one it is handed).  The SGHMC cell also: ``q_frozen`` (the
momentum moves, the position does not), ``stale_velocity`` (the position
moves by the momentum before the update), ``quarter_chains`` (a quarter of
the chains take their gradient on the next chain's minibatch).  Every cell runs on one chip:
there is no exchange between chips to leave out."""

from __future__ import annotations

import torch

COMMON = ("unchanged", "half_batch", "altered")
SOFTMAX = COMMON + ("gibbs_noop", "always_accept", "momentum_ignored")
SGHMC = COMMON + ("q_frozen", "stale_velocity", "quarter_chains")
BY_CONFIG = {"softmax-mnist": SOFTMAX, "mlp-dropout-mnist": SGHMC}


class _Wrapped:
    """A kernel whose step is ``fault(kernel, *args, **kw)``; keeps the
    wrapped kernel's attributes (the NUTS leaf counter, SGHMC's ``draw``)."""

    def __init__(self, kernel, fault):
        self.kernel, self.fault = kernel, fault

    def __call__(self, *args, **kw):
        return self.fault(self.kernel, *args, **kw)

    def __getattr__(self, name):
        return getattr(self.kernel, name)


def _unchanged(kernel, state, *args, **kw):
    _, info = kernel(state, *args, **kw)
    return state, info


def _altered(kernel, *args, **kw):
    new, info = kernel(*args, **kw)
    pos = dict(new.position)
    key = sorted(pos)[-1]
    leaf = pos[key].clone()
    leaf.view(leaf.shape[0], -1)[:, 0] += 0.25
    pos[key] = leaf
    return new._replace(position=pos), info


def _always_accept(kernel, state, step_sizes, inv_mass, *, generator=None, **kw):
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import nuts_batched
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import tree

    if isinstance(kernel, nuts_batched.BatchedNUTSKernel):
        draws = kw.pop("draws", None)
        if draws is None:
            z0, _ = tree.tree_batch_ravel(state.position)
            draws = nuts_batched.sample_draws(z0.shape[0], z0.shape[1], kernel.max_tree_depth,
                                              generator, z0.device, z0.dtype)
        draws = draws._replace(leaf_uniform=torch.zeros_like(draws.leaf_uniform),
                               bias_uniform=torch.zeros_like(draws.bias_uniform))
        return kernel(state, step_sizes, inv_mass, draws=draws, generator=generator, **kw)
    kw["uniforms"] = torch.zeros_like(state.logdensity)
    return kernel(state, step_sizes, inv_mass, generator=generator, **kw)


def _momentum_ignored(kernel, state, *args, generator=None, **kw):
    draws = kw.pop("draws", None)
    kw.pop("momentum", None)
    if draws is not None:
        kw["draws"] = draws._replace(momentum=torch.randn(draws.momentum.shape,
                                                          generator=generator,
                                                          device=draws.momentum.device))
    return kernel(state, *args, generator=generator, **kw)


def _q_frozen(kernel, state, *args, **kw):
    new, info = kernel(state, *args, **kw)
    return new._replace(position=state.position), info


def _stale_velocity(kernel, state, batch, step_size, **kw):
    new, info = kernel(state, batch, step_size, **kw)
    pos = {k: q + float(step_size) * state.momentum[k] for k, q in state.position.items()}
    return new._replace(position=pos), info


def _wrap_builders(setattr_, fault, samplers=("hmc", "nuts", "sghmc")):
    from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc, nuts_batched, sgmcmc

    builders = {"hmc": (hmc, "build_batched_kernel"),
                "nuts": (nuts_batched, "build_batched_kernel"),
                "sghmc": (sgmcmc, "build_sghmc_kernel")}
    for sampler in samplers:
        module, name = builders[sampler]
        real = getattr(module, name)
        setattr_(module, name, lambda *a, _real=real, **kw: _Wrapped(_real(*a, **kw), fault))


def _half_batch_softmax(setattr_):
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

    real = kron_metric.make_whitened_fused_vag

    def half(model, metric, qmap, batch, **kw):
        X, Y = batch
        h = X.shape[0] // 2
        # the first half of the rows twice: the second half left out, the
        # likelihood the mean over the rest, at the full size
        return real(model, metric, qmap, (torch.cat([X[:h], X[:h]]), torch.cat([Y[:h], Y[:h]])),
                    **kw)

    setattr_(kron_metric, "make_whitened_fused_vag", half)


def _mlp_logdensity(setattr_, change):
    """The dropout log density with ``change(params, batch, masks)`` applied
    to its arguments first."""
    from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP

    real = DropoutMLP.make_batched_logdensity

    def make(self, data_size, dropout=False):
        base = real(self, data_size, dropout=dropout)
        if not dropout:
            return base

        def logdensity(params, batch, masks):
            return base(*change(params, batch, masks))

        logdensity.chain_batched = True
        logdensity.draw_masks = base.draw_masks
        return logdensity

    setattr_(DropoutMLP, "make_batched_logdensity", make)


def _half_rows(params, batch, masks):
    h = batch[0].shape[1] // 2
    return params, tuple(t[:, :h] for t in batch), type(masks)(*(m[:, :h] for m in masks))


def _quarter_chains(params, batch, masks):
    q = max(batch[0].shape[0] // 4, 1)
    rolled = tuple(torch.cat([t[1:q + 1], t[q:]]) if t.shape[0] > q else t for t in batch)
    return params, rolled, masks


def _gibbs_noop(setattr_):
    from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric

    def make(metric, aux, qmap):
        def gibbs(state, **kw):
            return state

        return gibbs

    setattr_(kron_metric, "make_whitened_gauge_gibbs", make)


def plant(name: str, config: str, setattr_=setattr) -> None:
    """Plant the fault ``name`` under the cells of configuration ``config``."""
    if name not in BY_CONFIG[config]:
        raise ValueError(f"no fault {name!r} for {config!r} (faults: {BY_CONFIG[config]})")
    softmax = config == "softmax-mnist"
    if name == "unchanged":
        _wrap_builders(setattr_, _unchanged)
    elif name == "altered":
        _wrap_builders(setattr_, _altered)
    elif name == "half_batch":
        if softmax:
            _half_batch_softmax(setattr_)
        else:
            _mlp_logdensity(setattr_, _half_rows)
    elif name == "gibbs_noop":
        _gibbs_noop(setattr_)
    elif name == "always_accept":
        _wrap_builders(setattr_, _always_accept, ("hmc", "nuts"))
    elif name == "momentum_ignored":
        _wrap_builders(setattr_, _momentum_ignored, ("hmc", "nuts"))
    elif name == "q_frozen":
        _wrap_builders(setattr_, _q_frozen, ("sghmc",))
    elif name == "stale_velocity":
        _wrap_builders(setattr_, _stale_velocity, ("sghmc",))
    elif name == "quarter_chains":
        _mlp_logdensity(setattr_, _quarter_chains)
