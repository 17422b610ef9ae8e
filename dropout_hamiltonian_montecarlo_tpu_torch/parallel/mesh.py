"""Ranks of a ``torch.distributed`` group laid out as (chains, data).

The JAX package builds a device mesh over ('chains', 'data') and lets one
program drive it.  The port takes PyTorch's idiom: one process per rank,
started by ``torchrun`` (``python -m torch.distributed.run``), each running
the unchanged single-device code on its block.  ``init_distributed`` joins
the group; ``make_layout`` places the ranks on a (chains, data) grid and
makes the two kinds of process groups the layers above use:

- ``data_group``: the ranks that share a chain block, one per data shard;
  data-parallel gradients are all-reduced over it (the JAX 'data' axis);
- ``chains_group``: the ranks that share a data shard, one per chain block;
  draws are gathered over it (the JAX 'chains' axis).

Ranks are laid row-major: rank r holds chain block r // data_shards and data
shard r % data_shards.  ``torchrun`` numbers the ranks of one host
contiguously, so a host's ranks are contiguous along the chains axis, as
``make_multihost_mesh`` sorts devices, and the data all-reduce stays inside a
host whenever the data shards per chain block fit on one.

Every collective goes through the helpers at the end of this module: they do
nothing for a layout without process groups (one process), and they stage a
tensor where the backend takes it (host memory for gloo, the card for NCCL)
and hand the result back where the tensor was.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.streams import ChainBlock

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")
# how long a collective waits for the other ranks before it raises
_TIMEOUT_S = 600.0


def _init_method(coordinator_address: Optional[str]) -> str:
    """A rendezvous URL from ``host:port``, ``tcp://host:port`` or
    ``file:///path`` (None: torchrun's environment)."""
    if coordinator_address is None:
        return "env://"
    if coordinator_address.startswith(("tcp://", "file://", "env://")):
        return coordinator_address
    host, sep, port = coordinator_address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r}: give host:port, "
                         f"tcp://host:port or file:///path")
    return f"tcp://{coordinator_address}"


def _ranks_on_this_host(init_method: str, num_processes: int) -> int:
    """How many ranks share this host's devices: torchrun's LOCAL_WORLD_SIZE,
    else all of them for a rendezvous on this host, else one."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = init_method.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    if init_method.startswith("file://") or host in _LOCAL_HOSTS:
        return num_processes
    return 1


def local_device(device) -> torch.device:
    """The rank's device: a CUDA device without an index becomes
    ``cuda:{LOCAL_RANK % device_count()}`` (two ranks on a one-card host both
    land on cuda:0); any other device is returned as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None) -> int:
    """Join the process group; returns this process's rank.

    - Already joined: returns the rank.
    - ``num_processes <= 1``, or nothing given and no torchrun environment:
      one process, nothing to join; returns 0.
    - Nothing given under torchrun (RANK, WORLD_SIZE, MASTER_ADDR and
      MASTER_PORT set): joins through that environment, at any world size,
      one included.
    - An explicit coordinator (``host:port``, ``tcp://host:port`` or
      ``file:///path``) or process count: joins it, and any failure raises.
      Nothing here falls back to one process when a group was asked for.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for the
    CPU (``device`` defaults to cuda where there is a card).  NCCL takes one
    device per rank: when more ranks share this host than it has CUDA devices
    (two ranks on one card), asking for it raises; name ``gloo`` for that.
    Under NCCL the rank's current device is set to ``local_device``."""
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is not None and int(num_processes) <= 1:
        return 0
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            return 0
    init_method = _init_method(coordinator_address)
    if init_method == "env://":
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"no coordinator address and no {', '.join(missing)} in the "
                             f"environment: start the ranks with torchrun, or pass "
                             f"coordinator_address=")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("process_id= is needed with an explicit coordinator outside "
                             "torchrun")
        process_id = int(os.environ["RANK"])
    if not 0 <= int(process_id) < world:
        raise ValueError(f"process_id {process_id} outside 0 .. {world - 1}")

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        here = _ranks_on_this_host(init_method, world)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if here > count:
            raise RuntimeError(
                f"NCCL takes one CUDA device per rank, and {here} ranks share the "
                f"{count} CUDA device(s) of this host (NCCL refuses two ranks on one "
                f"device); run these ranks under gloo (backend='gloo')")
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    return dist.get_rank()


class RankLayout:
    """The (chains, data) place of one rank, and its two process groups
    (None for a layout of one process, or for one built without groups, as
    the tests build the layouts of other ranks)."""

    def __init__(self, num_chain_shards: int, num_data_shards: int = 1, rank: int = 0,
                 data_group=None, chains_group=None):
        self.num_chain_shards = int(num_chain_shards)
        self.num_data_shards = int(num_data_shards)
        self.world_size = self.num_chain_shards * self.num_data_shards
        if self.num_chain_shards < 1 or self.num_data_shards < 1:
            raise ValueError(f"a layout of {num_chain_shards} x {num_data_shards} shards")
        if not 0 <= int(rank) < self.world_size:
            raise ValueError(f"rank {rank} outside a layout of {self.world_size} ranks")
        self.rank = int(rank)
        self.chain_index, self.data_index = divmod(self.rank, self.num_data_shards)
        self.data_group = data_group
        self.chains_group = chains_group

    @property
    def distributed(self) -> bool:
        """Whether the layout carries process groups (collectives run)."""
        return self.data_group is not None

    def data_ranks(self) -> List[int]:
        """The ranks that share this rank's chain block (its data_group)."""
        base = self.chain_index * self.num_data_shards
        return [base + j for j in range(self.num_data_shards)]

    def chains_ranks(self) -> List[int]:
        """The ranks that share this rank's data shard (its chains_group)."""
        return [i * self.num_data_shards + self.data_index
                for i in range(self.num_chain_shards)]

    def __repr__(self) -> str:
        return (f"RankLayout(chains={self.num_chain_shards}, data={self.num_data_shards}, "
                f"rank={self.rank}, distributed={self.distributed})")


def make_layout(num_chain_shards: Optional[int] = None, num_data_shards: int = 1) -> RankLayout:
    """This rank's layout over the joined group (``init_distributed``): all
    ranks on the chains axis by default.  Without a group it is the layout of
    one process, and asking for more than one shard raises.  Every rank must
    call it, in the same order as the others: each rank creates every process
    group, also those it is not in, as ``torch.distributed.new_group`` asks."""
    if not dist.is_initialized():
        if (num_chain_shards or 1) * num_data_shards != 1:
            raise ValueError(f"a layout of {num_chain_shards} x {num_data_shards} shards needs "
                             f"a process group: start the ranks with torchrun and call "
                             f"init_distributed first")
        return RankLayout(1, 1, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_chain_shards is None:
        num_chain_shards = world // num_data_shards
    if num_chain_shards * num_data_shards != world:
        raise ValueError(f"a layout of {num_chain_shards} x {num_data_shards} shards != "
                         f"{world} ranks")
    ds = num_data_shards
    data_groups = [dist.new_group([c * ds + j for j in range(ds)])
                   for c in range(num_chain_shards)]
    chains_groups = [dist.new_group([i * ds + j for i in range(num_chain_shards)])
                     for j in range(ds)]
    chain_index, data_index = divmod(rank, ds)
    return RankLayout(num_chain_shards, ds, rank, data_groups[chain_index],
                      chains_groups[data_index])


def chain_block(layout: RankLayout, num_chains: int) -> ChainBlock:
    """The chains [start, stop) of ``num_chains`` that this rank's chain block
    holds: equal contiguous blocks along the chains axis."""
    if num_chains % layout.num_chain_shards != 0:
        raise ValueError(f"num_chains {num_chains} % {layout.num_chain_shards} chain shards "
                         f"!= 0")
    size = num_chains // layout.num_chain_shards
    return ChainBlock(num_chains, layout.chain_index * size, (layout.chain_index + 1) * size)


def check_block(generator, block: ChainBlock) -> None:
    """Raise unless ``generator`` carries ``block`` (or the block is every
    chain and the generator carries none)."""
    from ..ops import streams

    got = streams.block_of(generator)
    if got != block and not (got is None and block.size == block.global_chains):
        raise ValueError(f"the generator carries the chain block {got}, this rank holds "
                         f"{block}: make it with streams.block_generator(seed, device, "
                         f"chain_block(layout, num_chains))")


# ---------------------------------------------------------------------------
# Collectives.  Each does nothing without a group.
# ---------------------------------------------------------------------------


def _staged(group, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` where the group's backend takes it: host memory for gloo
    (whose all-gather and gather take host tensors only; its all-reduce of a
    CUDA tensor copies through the host as well), the rank's card for NCCL."""
    if dist.get_backend(group) == "gloo":
        return tensor.detach().to("cpu").contiguous()
    return tensor.detach().to(torch.device("cuda", torch.cuda.current_device())).contiguous()


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The elementwise sums over ``group`` of ``tensors`` (one flat buffer,
    one all-reduce)."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = _staged(group, flat)
    dist.all_reduce(buf, group=group)
    flat = buf.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather_cat(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``tensor``s of ``group`` concatenated along ``dim`` in rank
    order (every rank's tensor of the same shape)."""
    if group is None:
        return tensor
    local = _staged(group, tensor)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=dim).to(tensor.device)


def broadcast_object(obj):
    """``obj`` of rank 0 on every rank (pickled: only this program's own
    values)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather(tree, layout: RankLayout, dim: int = 0, dst: Optional[int] = 0):
    """A tree of the chain blocks' tensors, concatenated along ``dim`` in
    chain order over ``layout.chains_group``: the global tensors.  ``dst``:
    the chain-block index that receives them (others get None); None: every
    rank.  Without a group the tree is returned as it is."""
    from ..io.checkpoint import _rebuild

    group = layout.chains_group
    if group is None:
        return tree
    if dst is None:
        return _rebuild(tree, "", lambda _, t: all_gather_cat(t, group, dim))
    dst_rank = layout.chains_ranks()[dst]
    mine = dist.get_rank() == dst_rank

    def one(_, t):
        local = _staged(group, t)
        parts = ([torch.empty_like(local) for _ in range(layout.num_chain_shards)]
                 if mine else None)
        dist.gather(local, parts, dst=dst_rank, group=group)
        return torch.cat(parts, dim=dim).to(t.device) if mine else None

    out = _rebuild(tree, "", one)
    return out if mine else None
