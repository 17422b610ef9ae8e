"""Random streams that do not depend on how a run is cut into blocks.

Two cuts must leave every chain's random numbers where they were: the cut of
a long run into chunks (a run stopped after chunk i and resumed must go on as
the uninterrupted run does), and the cut of the chain axis into blocks (a
process that owns chains [start, stop) of C must draw what the one-process
run draws for those chains).  This module is the port's analogue of
``jax.random.fold_in`` / ``split`` for both.

*Chunk streams.*  ``chunk_generator(seed, tag, index, device)`` makes a fresh
``torch.Generator`` whose seed is an integer mix (SplitMix64, written out
below; never Python's ``hash``) of the run seed, a stream tag
(``STREAM_INIT`` / ``STREAM_WARMUP`` / ``STREAM_SAMPLE``) and a chunk index.
The streaming samplers read the run seed off the generator they are given
(``generator.initial_seed()``), and chunk i of the sampling phase draws only
from the generator of (seed, sample, i).  A checkpoint then needs the seed
and the draw counter, not a generator state.

*Chain blocks.*  A ``ChainBlock(global_chains, start, stop)`` rides on the
generator (``block_generator`` / ``BlockGenerator``), so every function that
takes ``generator=`` takes the block with it.  Every draw site of the package
goes through the helpers below (``randn``, ``rand``, ``randint``,
``keep_mask``).  Without a block a helper is exactly the ``torch`` call of the
same name: same shape, same generator, same numbers.  With a block it draws
the tensor at its GLOBAL shape, the chain axis ``global_chains`` long, and
keeps the rows [start, stop): the generator advances as in the full run, so
the block's rows equal the full draw's rows bit for bit, at the price of
drawing noise for chains the process does not own (small against a step's
work).  A draw with no chain axis (``chain_axis=None``: a shared minibatch,
the resampler's offset) is the same on every block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

STREAM_INIT, STREAM_WARMUP, STREAM_SAMPLE = 1, 2, 3

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One round of SplitMix64 (Steele, Lea and Flood, 2014) on a 64-bit int."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed from (run seed, stream tag, chunk index): three chained
    SplitMix64 rounds, so neighbouring seeds, tags and indices give unrelated
    streams."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(tag) & _MASK64))
    h = _splitmix64(h ^ (int(index) & _MASK64))
    return h >> 1


class ChainBlock(NamedTuple):
    """The chains [start, stop) of a run with ``global_chains`` chains."""
    global_chains: int
    start: int
    stop: int

    @property
    def size(self) -> int:
        return self.stop - self.start


class BlockGenerator(torch.Generator):
    """A ``torch.Generator`` that carries the ``ChainBlock`` its owner holds
    (None: all chains).  Make one with ``block_generator``."""

    block: Optional[ChainBlock] = None


def block_generator(seed: int, device, block: Optional[ChainBlock] = None) -> torch.Generator:
    """A seeded generator on ``device`` carrying ``block``."""
    if block is not None and not 0 <= block.start < block.stop <= block.global_chains:
        raise ValueError(f"not a block of a chain axis: {block}")
    gen = BlockGenerator(device=device)
    gen.manual_seed(int(seed))
    gen.block = block
    return gen


def block_of(generator: Optional[torch.Generator]) -> Optional[ChainBlock]:
    """The chain block a generator carries, or None."""
    return getattr(generator, "block", None)


def chunk_generator(seed: int, tag: int, index: int, device,
                    block: Optional[ChainBlock] = None) -> torch.Generator:
    """A fresh generator for chunk ``index`` of stream ``tag`` of the run
    seeded ``seed``."""
    return block_generator(mix_seed(seed, tag, index), device, block)


def derive(generator: torch.Generator, tag: int, index: int = 0) -> torch.Generator:
    """``chunk_generator`` from a generator's own seed, device and block: the
    analogue of ``fold_in``.  The given generator's state is not read, so the
    result does not depend on what was drawn from it before."""
    if generator is None:
        raise ValueError("a random stream needs an explicit torch.Generator")
    return chunk_generator(generator.initial_seed(), tag, index, generator.device,
                           block_of(generator))


def _draw(fn, shape: Sequence[int], generator, chain_axis: Optional[int], **kw) -> torch.Tensor:
    if generator is None:
        raise ValueError("a random draw needs an explicit torch.Generator")
    shape = tuple(shape)
    block = block_of(generator)
    if block is None or chain_axis is None:
        return fn(shape, generator=generator, **kw)
    if shape[chain_axis] != block.size:
        raise ValueError(f"a draw of shape {shape} has {shape[chain_axis]} chains on axis "
                         f"{chain_axis}, the generator's block {block} has {block.size}")
    full = list(shape)
    full[chain_axis] = block.global_chains
    return fn(tuple(full), generator=generator, **kw).narrow(chain_axis, block.start,
                                                              block.size)


def randn(shape, *, generator, device, dtype=torch.float32,
          chain_axis: Optional[int] = 0) -> torch.Tensor:
    """Standard normals of ``shape`` (the caller's local shape)."""
    return _draw(torch.randn, shape, generator, chain_axis, dtype=dtype, device=device)


def rand(shape, *, generator, device, dtype=torch.float32,
         chain_axis: Optional[int] = 0) -> torch.Tensor:
    """Uniforms on [0, 1) of ``shape`` (the caller's local shape)."""
    return _draw(torch.rand, shape, generator, chain_axis, dtype=dtype, device=device)


def randint(low: int, high: int, shape, *, generator, device,
            chain_axis: Optional[int] = 0) -> torch.Tensor:
    """Uniform int64 in [low, high) of ``shape`` (the caller's local shape)."""
    def fn(s, **kw):
        return torch.randint(low, high, s, **kw)

    return _draw(fn, shape, generator, chain_axis, device=device)


def keep_mask(shape, keep_prob: float, *, generator, device,
              chain_axis: Optional[int] = 0) -> torch.Tensor:
    """Bernoulli(keep_prob) bool mask of ``shape``: one uniform draw and one
    compare."""
    return _draw(torch.rand, shape, generator, chain_axis, device=device) < keep_prob
