"""Sampler loop ``nuts``: lockstep chain-batched NUTS (the port's
``inference/nuts_batched.py::build_batched_kernel``, an accurate value+grad
at every leaf) in the whitened coordinates, the gauge Gibbs move after every
draw.  Traffic keys: chains, max_tree_depth, warmup_steps,
initial_step_size, target_accept, chunk_draws, capture_span, capture_draws,
trace_skip_chunks, trace_chunks."""

from perfbench.harness.whitened import WhitenedSession


def prepare(ctx):
    return WhitenedSession(ctx, "nuts")
