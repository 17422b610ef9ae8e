"""Sampler loop ``hmc``: chain-batched HMC with lazy-value trajectories (the
port's ``inference/hmc.py::build_batched_kernel`` with ``grad_fn``) in the
whitened coordinates, the gauge Gibbs move after every draw.  Traffic keys:
chains, num_integration_steps, warmup_steps, initial_step_size,
target_accept, chunk_draws, capture_span, capture_draws, trace_skip_chunks,
trace_chunks."""

from perfbench.harness.whitened import WhitenedSession


def prepare(ctx):
    return WhitenedSession(ctx, "hmc")
