"""High-level sampling entry points over the chain axis.

``sample_posterior`` runs warmup and sampling for every chain at once (the
JAX package vmaps a per-chain program; here the chain axis is explicit and
every chain has its own draws, step size and inverse mass).  The streaming
forms sample in chunks and hand each chunk's draws to a backend: a file
(io.backend.HDF5Backend), a bounded buffer on the device or in host memory
(``DeviceBackend``), or both (``TeeDeviceBackend``).  With a checkpoint file
a streaming run can be stopped and resumed, and then appends exactly the
draws the uninterrupted run would have: chunk i draws only from the
generator of (run seed, sample stream, i) (ops/streams.py).  With
``mesh=`` (a ``parallel.RankLayout``) the chain axis is sharded over ranks:
each rank streams its chain block, and the checkpoint stays global.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops import streams
from ..ops.tree import Params, tree_ones_like, tree_randn_like
from .base import run_inference
from .warmup import run_warmup


class Posterior(NamedTuple):
    """Stacked draws and diagnostics info.

    positions: dict with leading axes (num_chains, num_samples, ...); the info
    fields are (num_chains, num_samples).
    """

    positions: Params
    infos: Any
    step_size: torch.Tensor
    inv_mass: Params
    final_state: Any


def _num_chains(positions: Params, num_chains: int) -> None:
    got = next(iter(positions.values())).shape[0]
    if got != num_chains:
        raise ValueError(f"initial_positions carry {got} chains, num_chains={num_chains}")


def _warm(init_fn, kernel, initial_positions, num_warmup, initial_step_size,
          target_acceptance, adapt_mass, generator):
    """(state, (C,) step sizes, inv_mass) after warmup (or without one)."""
    state = init_fn(initial_positions)
    step_size = torch.full_like(state.logdensity, float(initial_step_size))
    if num_warmup > 0:
        warm = run_warmup(kernel, state, num_warmup, initial_step_size=step_size,
                          target_acceptance=target_acceptance, adapt_mass=adapt_mass,
                          generator=generator)
        return warm.state, warm.step_size, warm.inv_mass
    return state, step_size, tree_ones_like(initial_positions)


def sample_posterior(
    init_fn: Callable,          # (chain-batched positions) -> state
    kernel: Callable,           # (state, step_size, inv_mass, *, generator) -> (state, info)
    initial_positions: Params,  # dict with a leading chain axis
    num_samples: int,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    thin: int = 1,
    adapt_mass: bool = True,
    *,
    generator: torch.Generator,
) -> Posterior:
    """Warmup, then sampling, for all chains together.

    ``adapt_mass=False``: warmup adapts the step size only: the right choice
    when the kernel carries its own metric (whitened NUTS/HMC under the
    Kronecker Gauss-Newton metric), where the diagonal inv_mass argument is
    ignored anyway."""
    _num_chains(initial_positions, num_chains)
    state, step_size, inv_mass = _warm(init_fn, kernel, initial_positions, num_warmup,
                                       initial_step_size, target_acceptance, adapt_mass,
                                       generator)

    def fixed_kernel(s, generator):
        return kernel(s, step_size, inv_mass, generator=generator)

    final_state, (states, infos) = run_inference(fixed_kernel, state, num_samples, thin=thin,
                                                 generator=generator)
    # (draws, chains, ...) -> (chains, draws, ...)
    positions = {k: v.transpose(0, 1) for k, v in states.position.items()}
    infos = type(infos)(*(f.transpose(0, 1) for f in infos))
    return Posterior(positions, infos, step_size, inv_mass, final_state)


def stack_chains(position: Params, num_chains: int) -> Params:
    """Tile one chain's position dict into a leading chain axis."""
    return {k: v.expand((num_chains,) + v.shape).clone() for k, v in position.items()}


def init_chain_positions(init_params_fn: Callable, num_chains: int, jitter: float = 0.0, *,
                         generator: torch.Generator, device) -> Params:
    """Per-chain initial positions from a model's ``init_params(generator,
    device)``, optionally jittered by ``jitter`` * N(0, I): overdispersed
    starts make R-hat meaningful.  A generator that carries a chain block
    (ops.streams) draws every chain of the run and keeps its own."""
    block = streams.block_of(generator)
    if block is not None and block.size != num_chains:
        raise ValueError(f"num_chains={num_chains}, the generator's block {block} "
                         f"has {block.size}")
    total = num_chains if block is None else block.global_chains
    draws = [init_params_fn(generator, device) for _ in range(total)]
    if block is not None:
        draws = draws[block.start:block.stop]
    positions = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    if jitter > 0.0:
        noise = tree_randn_like(positions, generator)
        positions = {k: positions[k] + jitter * noise[k] for k in positions}
    return positions


def draw_bytes(num_chains: int, num_samples: int, position: Params) -> int:
    """Bytes of the (chains, draws, parameters) float32 draw tensor of a run;
    ``position`` is a chain-batched position dict (leaves (C, ...))."""
    per_chain = sum(v[0].numel() for v in position.values())
    return 4 * int(num_chains) * int(num_samples) * per_chain


def choose_draw_storage(num_bytes: int, device, threshold_bytes: Optional[int] = None) -> str:
    """Where a run's draws are kept: ``"device"`` while the draw tensor is at
    most ``threshold_bytes``, else ``"host"``.  The default threshold is a
    quarter of the device's free memory (``torch.cuda.mem_get_info``); on the
    CPU, where the device's memory is the host's, there is none."""
    device = torch.device(device)
    if threshold_bytes is None:
        if device.type != "cuda":
            return "device"
        threshold_bytes = torch.cuda.mem_get_info(device)[0] // 4
    return "device" if num_bytes <= threshold_bytes else "host"


class DeviceBackend:
    """A bounded draw buffer: every appended block (a dict of (chunk, C, ...)
    tensors, draws leading) is written into ONE preallocated buffer per leaf,
    and ``draws()`` hands out views of it, (C, T, ...), for the diagnostics:
    no list of blocks, no second copy.

    ``num_draws``: the run's total, which sizes the buffer at the first
    append; without it the buffer doubles when it is full.  ``storage``:
    ``"device"`` keeps the buffer where the blocks lie, laid out (C, T, ...)
    so that ``draws()`` is contiguous; ``"host"`` keeps it in host memory
    (pinned when the blocks come from a card, one asynchronous copy per
    block), laid out (T, C, ...), and ``draws()`` is a strided view for
    blockwise diagnostics (diagnostics.summary.draw_diagnostics).

    ``num_draws()`` and ``truncate(n)`` let it sit under a checkpoint."""

    def __init__(self, num_draws: Optional[int] = None, storage: str = "device"):
        if storage not in ("device", "host"):
            raise ValueError(f"storage must be 'device' or 'host', got {storage!r}")
        self.storage = storage
        self._capacity = num_draws
        self._count = 0
        self._buffers: Optional[Params] = None

    def _allocate(self, block: Params, capacity: int) -> Params:
        out = {}
        for k, v in block.items():
            tail = tuple(v.shape[1:])                       # (C, ...)
            if self.storage == "host":
                out[k] = torch.empty((capacity,) + tail, dtype=v.dtype, pin_memory=v.is_cuda)
            else:
                out[k] = torch.empty(tail[:1] + (capacity,) + tail[1:], dtype=v.dtype,
                                     device=v.device)
        return out

    def _time_axis(self) -> int:
        return 0 if self.storage == "host" else 1

    def append(self, block: Params) -> None:
        take = next(iter(block.values())).shape[0]
        need = self._count + take
        if self._buffers is None:
            self._capacity = max(self._capacity or 0, need)
            self._buffers = self._allocate(block, self._capacity)
        elif need > self._capacity:
            # the total was not given (or was exceeded): double
            self._capacity = max(2 * self._capacity, need)
            grown = self._allocate(block, self._capacity)
            axis = self._time_axis()
            for k, old in self._buffers.items():
                grown[k].narrow(axis, 0, self._count).copy_(old.narrow(axis, 0, self._count))
            self._buffers = grown
        for k, v in block.items():
            if self.storage == "host":
                self._buffers[k][self._count:need].copy_(v, non_blocking=True)
            else:
                self._buffers[k][:, self._count:need] = v.transpose(0, 1)
        self._count = need

    def num_draws(self) -> int:
        return self._count

    def truncate(self, n: int) -> None:
        """Forget the draws past the first ``n`` (no-op when there are fewer)."""
        self._count = min(self._count, int(n))

    def draws(self) -> Params:
        """The draws so far as (C, T, ...) views of the buffer."""
        if self._buffers is None:
            raise ValueError("no draws were appended")
        if self.storage == "host":
            if torch.cuda.is_available():
                torch.cuda.synchronize()        # the asynchronous copies have landed
            return {k: v[:self._count].transpose(0, 1) for k, v in self._buffers.items()}
        return {k: v[:, :self._count] for k, v in self._buffers.items()}


class TeeDeviceBackend(DeviceBackend):
    """A ``DeviceBackend`` that also forwards every block to a persistent
    file backend: the buffer feeds the diagnostics where the draws lie, the
    file is what a resumed run continues.  Closing it closes the file."""

    def __init__(self, file_backend=None, num_draws: Optional[int] = None,
                 storage: str = "device"):
        super().__init__(num_draws, storage)
        self._file = file_backend

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._file is not None:
            self._file.close()

    def append(self, block: Params) -> None:
        super().append(block)
        if self._file is not None:
            self._file.append(block)

    def num_draws(self) -> int:
        return self._file.num_draws() if self._file is not None else super().num_draws()

    def truncate(self, n: int) -> None:
        super().truncate(n)
        if self._file is not None:
            self._file.truncate(n)


def sample_posterior_streaming(
    init_fn: Callable,
    kernel: Callable,
    initial_positions: Params,
    backend,                    # anything with .append: io.HDF5Backend, DeviceBackend, ...
    num_samples: int,
    chunk_size: int = 100,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    adapt_mass: bool = True,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    *,
    generator: torch.Generator,
):
    """Warm up once, then sample in chunks, appending each chunk's positions
    (chunk, C, ...), draws leading, to ``backend``.  Returns (final_states,
    step_size, inv_mass, num_appended).

    ``generator`` gives the run its seed (``generator.initial_seed()``), its
    device and its chain block; nothing is drawn from it.  Warmup draws from
    the generator of (seed, warmup stream), chunk i from that of (seed,
    sample stream, i).

    ``checkpoint_path``: after every chunk the resumable state (chain states,
    adapted step sizes and inverse mass, the seed, the count of draws done)
    is written atomically (io/checkpoint.py).  With ``resume=True`` and an
    existing checkpoint, warmup is SKIPPED, the saved seed replaces the
    caller's, and sampling goes on at the next chunk, so an interrupted and
    resumed run appends exactly the draws of the uninterrupted one.  A
    chunk's append and its checkpoint write are two operations; after a crash
    between them the backend is one chunk ahead of the checkpoint's counter,
    and the resume truncates it back (``backend.truncate``)."""
    _num_chains(initial_positions, num_chains)
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        # placeholders of the right shapes: the checkpoint's values replace them
        states = init_fn(initial_positions)
        step_sizes = torch.zeros_like(states.logdensity)
        inv_mass = tree_ones_like(initial_positions)
    else:
        states, step_sizes, inv_mass = _warm(
            init_fn, kernel, initial_positions, num_warmup, initial_step_size,
            target_acceptance, adapt_mass, streams.derive(generator, streams.STREAM_WARMUP))
    states, appended, _, step_sizes, inv_mass = _stream_chunks(
        kernel, states, step_sizes, inv_mass, backend, num_samples, chunk_size, None,
        checkpoint_path, resume, generator)
    return states, step_sizes, inv_mass, appended


def sample_batched_streaming(
    kernel: Callable,       # chain-batched: (state, (C,) eps, inv_mass, *, generator)
    states,                 # chain-batched state (leaves (C, ...))
    step_sizes: torch.Tensor,
    inv_mass: Params,
    backend,
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
    with draws leading.  Returns (final_states, num_appended_total,
    info_summaries): one entry per chunk run in THIS call, the kernel's info
    averaged over (chunk, chains) as floats (one host sync per chunk).

    Random numbers: ``generator`` gives the run its seed, device and chain
    block, and nothing is drawn from it; chunk i draws from the generator of
    (seed, sample stream, i).  The draw sequence therefore depends on the
    chunk size, and a resumed run must use the original one: resuming at a
    draw count that is not a chunk boundary raises.  The last chunk may be
    partial; it then runs only the steps it keeps (the JAX package runs a
    full chunk and keeps the first ``take`` draws; a partial chunk is always
    the last, so no later draw can tell the difference).

    ``checkpoint_path`` / ``resume``: as in ``sample_posterior_streaming``.
    The checkpoint holds the adapted step sizes and the inverse mass, so a
    resuming caller may skip warmup and pass placeholders: the saved ones
    take precedence (a checkpoint without an inverse mass keeps the
    caller's).  Resuming a finished run appends nothing.

    ``mesh``: a ``parallel.RankLayout`` to shard the chain axis over ranks.
    ``states``, ``step_sizes`` and ``inv_mass`` are then this rank's chain
    block, ``generator`` carries the block (``parallel.chain_block``), and
    each chunk runs on the block and appends the block's draws to this rank's
    ``backend``.  The info summaries are means over ALL chains (one
    all-gather of the chunk's info a chunk).  The checkpoint stays
    global, as the JAX package's: after an all-gather of the states, rank 0
    alone writes it, and a resuming rank reads its block's rows from it."""
    if mesh is not None:
        from ..parallel.mesh import chain_block, check_block

        check_block(generator, chain_block(mesh, step_sizes.shape[0] * mesh.num_chain_shards))
    states, appended, info_summaries, _, _ = _stream_chunks(
        kernel, states, step_sizes, inv_mass, backend, num_samples, chunk_size, transform,
        checkpoint_path, resume, generator, mesh)
    return states, appended, info_summaries


def _stream_chunks(kernel, states, step_sizes, inv_mass, backend, num_samples, chunk_size,
                   transform, checkpoint_path, resume, generator, layout=None):
    """The chunk loop of both streaming samplers.  Returns (states, appended,
    info_summaries, step_sizes, inv_mass), the last two as resumed.
    ``layout``: the chain axis sharded over ranks (``sample_batched_streaming``)."""
    from ..io.checkpoint import checkpoint_groups, load_checkpoint, save_checkpoint
    from ..parallel.mesh import all_gather_cat, gather

    if generator is None:
        raise ValueError("a streaming run needs an explicit torch.Generator for its seed")
    seed, device, block = generator.initial_seed(), generator.device, streams.block_of(generator)
    appended = 0

    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        # a checkpoint from before the inverse mass was stored carries only
        # the step sizes: resume it with the caller's inverse mass
        extras_like = {"step_size": step_sizes}
        if "inv_mass" in checkpoint_groups(checkpoint_path):
            extras_like["inv_mass"] = inv_mass
        # a sharded run's checkpoint is global: a rank reads its block's rows
        states, seed, appended, extras = load_checkpoint(
            checkpoint_path, states, extras_like=extras_like,
            block=block if layout is not None and layout.distributed else None)
        step_sizes = extras["step_size"]
        inv_mass = extras.get("inv_mass", inv_mass)
        if appended < num_samples and appended % chunk_size != 0:
            raise ValueError(
                f"resume draw counter {appended} is not a multiple of chunk_size "
                f"{chunk_size}: the random streams are per chunk index, so another chunk "
                f"size would change or repeat the draw sequence; use the original chunk size")
        # after a crash between an append and its checkpoint write: drop the
        # draws past the checkpoint's counter
        if hasattr(backend, "truncate"):
            backend.truncate(appended)

    info_summaries = []
    n_chunks = -(-num_samples // chunk_size)
    # a finished run resumes as a no-op
    start = n_chunks if appended >= num_samples else appended // chunk_size
    for i in range(start, n_chunks):
        gen = streams.chunk_generator(seed, streams.STREAM_SAMPLE, i, device, block)
        take = min(chunk_size, num_samples - appended)
        positions, infos = [], []
        for _ in range(take):
            states, info = kernel(states, step_sizes, inv_mass, generator=gen)
            positions.append(states.position)
            infos.append(info)
        pos = {k: torch.stack([p[k] for p in positions], dim=1) for k in positions[0]}
        if transform is not None:
            pos = transform(pos)
        backend.append({k: v.transpose(0, 1) for k, v in pos.items()})
        fields = [torch.stack(f).to(torch.float32) for f in zip(*infos)]
        if layout is not None and layout.distributed:
            # every chain's info, so that the mean is the one-process mean
            fields = all_gather_cat(torch.stack(fields), layout.chains_group, dim=2).unbind(0)
        means = torch.stack([f.mean() for f in fields])
        info_summaries.append(type(infos[0])(*means.tolist()))
        appended += take
        if checkpoint_path is not None:
            extras = {"step_size": step_sizes, "inv_mass": inv_mass}
            if layout is not None and layout.distributed:
                # one global checkpoint: rank 0 writes the gathered blocks
                whole = gather((states, extras), layout)
                if layout.rank == 0:
                    save_checkpoint(checkpoint_path, whole[0], seed=seed, step=appended,
                                    extras=whole[1])
            else:
                save_checkpoint(checkpoint_path, states, seed=seed, step=appended,
                                extras=extras)
    return states, appended, info_summaries, step_sizes, inv_mass
