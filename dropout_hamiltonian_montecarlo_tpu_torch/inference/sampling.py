"""Chunked sampling driver for the chain-batched kernels.

Only ``sample_batched_streaming`` is ported, with the draws kept on the
device block by block (``DeviceBackend``, as the JAX CLI's
``_TeeDeviceBackend`` keeps them).  File backends, checkpoints, resume and
chain sharding are not ported yet (ROADMAP slice 5).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..ops.tree import Params


class DeviceBackend:
    """Keeps every appended block (a dict of (chunk, C, ...) tensors, draws
    leading) where it lies, on the device; ``draws()`` joins them into
    (C, T, ...) tensors for the diagnostics."""

    def __init__(self):
        self.device_blocks: List[Params] = []

    def append(self, block: Params) -> None:
        self.device_blocks.append(block)

    def draws(self) -> Params:
        keys = self.device_blocks[0].keys()
        return {k: torch.cat([b[k] for b in self.device_blocks]).transpose(0, 1)
                for k in keys}


def sample_batched_streaming(
    kernel: Callable,       # chain-batched: (state, (C,) eps, inv_mass, *, generator)
    states,                 # chain-batched state (leaves (C, ...))
    step_sizes: torch.Tensor,
    inv_mass: Params,
    backend: DeviceBackend,
    num_samples: int,
    chunk_size: int = 100,
    transform: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    mesh=None,
    *,
    generator: torch.Generator,
):
    """Sample ``num_samples`` draws in chunks of ``chunk_size``.

    Each chunk's positions (C, chunk, ...) go through ``transform`` (e.g.
    unwhitening back to parameter space) and are appended to ``backend``
    with draws leading.  Returns (final_states, num_appended,
    info_summaries): one entry per chunk, the kernel's info averaged over
    (chunk, chains) as floats (one host sync per chunk)."""
    if checkpoint_path is not None or resume:
        raise NotImplementedError(
            "checkpoint_path/resume: checkpoints are not ported yet (ROADMAP slice 5)")
    if mesh is not None:
        raise NotImplementedError("mesh: chain sharding is not ported yet (ROADMAP slice 5)")
    if not isinstance(backend, DeviceBackend):
        raise NotImplementedError(
            "only DeviceBackend is ported; file backends (io/backend.py) are not "
            "ported yet (ROADMAP slice 5)")

    appended = 0
    info_summaries = []
    while appended < num_samples:
        take = min(chunk_size, num_samples - appended)
        positions, infos = [], []
        for _ in range(take):
            states, info = kernel(states, step_sizes, inv_mass, generator=generator)
            positions.append(states.position)
            infos.append(info)
        pos = {k: torch.stack([p[k] for p in positions], dim=1) for k in positions[0]}
        if transform is not None:
            pos = transform(pos)
        backend.append({k: v.transpose(0, 1) for k, v in pos.items()})
        fields = [torch.stack(f).to(torch.float32).mean() for f in zip(*infos)]
        info_summaries.append(type(infos[0])(*torch.stack(fields).tolist()))
        appended += take
    return states, appended, info_summaries
