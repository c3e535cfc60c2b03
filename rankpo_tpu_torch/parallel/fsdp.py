"""Sharded parameters over the data axis (``--fsdp``; port of
``rankpo_tpu.parallel.sharding.fsdp_partition_specs`` and the trainer's
``fsdp`` path, ``trainer.py:158-162``).

JAX shards each parameter over the data axis on its largest divisible
dimension and lets GSPMD all-gather it at each use and reduce-scatter its
gradient (``sharding.py:127-141``). The port keeps ZeRO-1's whole-tensor
partition instead (``sharding.partition_params``: largest first, each to
the data rank holding the fewest bytes): a parameter's storage lives on its
owner only, and the other ranks hold an empty tensor in its place. Every
trainable parameter of the model (``requires_grad``; LoRA's ``lora_a`` and
``lora_b`` inside their ``LoraMerge``, ``models/lora.py``) is wrapped in a
``torch.nn.utils.parametrize`` parametrization, :class:`GatherFromOwner`,
so each access (``layer.weight``, in the forward and in a checkpointed
recompute alike) broadcasts the whole tensor from its owner, and the
backward of that access reduces the gradient to the owner (a sum over the
data group; the other ranks' grads are empty). So between layers a rank
holds its own tensors only: at most total / W plus the largest tensor,
with their optimizer state (the trainer's ``ShardedOptimizer`` over the
owned tensors) and their gradients. The gathered tensor lives while the
layer uses it (and where autograd saves it for the backward, until then).
The frozen tensors (a LoRA base) stay whole on every rank, as JAX keeps
its frozen tree replicated over the data axis (``trainer.py:183-190``).

With a model axis (``--fsdp`` with ``--model_parallel``) the model is a
model rank's shards and the data group is that model index's: each model
rank's shards are partitioned over its data group, the gathers broadcast
within it, and the tensor-parallel sums run within the model group
(``parallel/sharding.py``).

Why not ``torch.distributed.fsdp.fully_shard``: it turns parameters into
DTensors, which the 8-bit AdamW, Adafactor and LoRA's parametrizations do
not take.

Every access is a collective of the data group: all ranks must run the
same forward and backward (they do: the same model on their own rows). The
trainable parameters keep the one-process order (:func:`shard_parameters_`
checks), so the optimizer's parameter indices, and with them checkpoints,
are one process's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.parallel.sharding import partition_params


class _Gather(torch.autograd.Function):
    """The whole parameter from its owner (a broadcast over the data
    group); the backward sums the gradient over the group onto the owner."""

    @staticmethod
    def forward(ctx, local, shape, owner: int, group, is_owner: bool):
        ctx.owner, ctx.group, ctx.is_owner = owner, group, is_owner
        full = local.detach().clone() if is_owner else local.new_empty(shape)
        dist.broadcast(full, src=mesh.group_rank(group, owner), group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.reduce(g, dst=mesh.group_rank(ctx.group, ctx.owner), group=ctx.group)
        if ctx.is_owner:
            return g, None, None, None, None
        return g.new_empty(0), None, None, None, None


class GatherFromOwner(nn.Module):
    """The parametrization of one sharded parameter: ``original`` is the
    whole tensor on its owner and an empty one elsewhere."""

    def __init__(self, shape: torch.Size, owner: int, group, is_owner: bool):
        super().__init__()
        self.shape, self.owner, self.group, self.is_owner = shape, owner, group, is_owner

    def forward(self, original: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(original, self.shape, self.owner, self.group, self.is_owner)


@dataclasses.dataclass
class ShardedParameters:
    """The model's sharding: the one-process names of the trainable
    tensors, their storage tensors (``parametrizations.<name>.original``),
    their whole shapes (a model rank's shard's under tensor parallelism) and
    owners (data indices), this rank's data index and the data group."""

    names: List[str]
    params: List[nn.Parameter]
    shapes: List[torch.Size]
    owners: List[int]
    rank: int
    group: object


def _trainable(model: nn.Module) -> list:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def shard_parameters_(model: nn.Module, group=None) -> ShardedParameters:
    """Shard every trainable parameter of ``model`` over ``group`` (the
    data group, by default every rank) in place: owners by
    ``partition_params``, each wrapped in :class:`GatherFromOwner`, the
    non-owned storage freed; the frozen ones stay as they are. Sets and
    returns ``model.fsdp``. A collective only in that every rank must shard
    the same model alike."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    named = _trainable(model)
    names = [n for n, _ in named]
    shapes = [p.shape for _, p in named]
    owners = partition_params([p for _, p in named], world)
    stored = []
    for (name, p), owner in zip(named, owners):
        path, _, attr = name.rpartition(".")
        module = model.get_submodule(path)
        gather = GatherFromOwner(p.shape, owner, group, owner == rank)
        parametrize.register_parametrization(module, attr, gather, unsafe=True)
        if owner != rank:
            original = module.parametrizations[attr].original
            original.data = original.data.new_empty(0)
        stored.append(f"{path}.parametrizations.{attr}.original")
    after = _trainable(model)
    got = [n for n, _ in after]
    if got != stored:  # the optimizer's indices must stay one process's
        raise RuntimeError(f"sharding changed the parameter order: {got[:4]} ...")
    params = [p for _, p in after]
    state = ShardedParameters(names, params, shapes, owners, rank, group)
    model.fsdp = state
    return state


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's sharded parameters under their one-process names (a
    model rank's shards under tensor parallelism), every tensor broadcast
    from its owner (a collective of the data group); on every rank."""
    fs = model.fsdp
    out = {}
    for name, p, shape, owner in zip(fs.names, fs.params, fs.shapes, fs.owners):
        full = p.detach().clone() if owner == fs.rank else p.new_empty(shape)
        dist.broadcast(full, src=mesh.group_rank(fs.group, owner), group=fs.group)
        out[name] = full
    return out
