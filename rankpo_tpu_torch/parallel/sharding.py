"""Data-parallel gradient exchange and ZeRO-1/ZeRO-2 optimizer sharding
(port of the data-axis half of ``rankpo_tpu.parallel.sharding``).

The JAX package splits every optimizer leaf over the data axis on its
largest divisible dimension (``zero1_partition_specs``). The port gives
each rank whole tensors instead (:func:`partition_params`): largest first,
each to the rank holding the fewest bytes so far, the partition
``torch.distributed.optim.ZeroRedundancyOptimizer`` makes. Each rank builds
the configured optimizer (AdamW, the 8-bit AdamW or Adafactor) over the
tensors it owns (:class:`ShardedOptimizer`), so Adafactor's factored
moments and the 8-bit blocks stay whole and every optimizer gives the
unsharded bits at any world size; a rank holds at most total / W plus the
largest tensor of state.

After the backward of an accumulation group one bucketed ``all_reduce`` of
the gradients, then a division by W, averages them over the ranks
(:func:`all_reduce_mean_`); the gradient norm for clipping is then the
single-card one (``train/state.py`` ``global_norm``). After the update the
owners send the new values out (:func:`broadcast_from_owners_`).

ZeRO-2 (``zero2``) takes the same path as ZeRO-1. The JAX package's
``zero2`` pins the gradients' layout to the moments' shards and, by its own
config note (``rankpo_tpu/train/config.py``), adds no bytes over ``zero1``.
A ZeRO-2 that saves gradient memory here would have to reduce-scatter each
bucket in a backward hook, so that a rank never holds other ranks' whole
gradients (ROADMAP.md Queue 3).

Every function is a collective: all ranks call it, in the same order, on
the main thread.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 256 * 2**20  # gradients exchanged per collective


def partition_params(tensors: Sequence[torch.Tensor], world: int) -> List[int]:
    """The owner rank of each tensor: largest first (bytes; ties in
    parameter order), each to the rank with the fewest bytes so far (ties
    to the lower rank)."""
    loads = [0] * world
    owners = [0] * len(tensors)
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].numel() * tensors[i].element_size())
    for i in order:
        rank = min(range(world), key=lambda r: loads[r])
        owners[i] = rank
        loads[rank] += tensors[i].numel() * tensors[i].element_size()
    return owners


def _buckets(tensors: Sequence[torch.Tensor], indices: Sequence[int],
             cap: Optional[int] = None) -> Iterator[List[int]]:
    """Consecutive runs of ``indices`` whose tensors share a dtype and
    device, each run at most ``cap`` (by default BUCKET_BYTES) bytes (a
    larger tensor alone)."""
    cap = BUCKET_BYTES if cap is None else cap
    run: List[int] = []
    size = 0
    for i in indices:
        t = tensors[i]
        nbytes = t.numel() * t.element_size()
        if run and (size + nbytes > cap or t.dtype != tensors[run[0]].dtype
                    or t.device != tensors[run[0]].device):
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


def _flat(tensors: Sequence[torch.Tensor], run: List[int]) -> torch.Tensor:
    """The run's tensors as one contiguous buffer (the tensor itself for a
    run of one contiguous tensor: the collective then works in place)."""
    if len(run) == 1 and tensors[run[0]].is_contiguous():
        return tensors[run[0]]
    return torch.cat([tensors[i].reshape(-1) for i in run])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor], run: List[int]) -> None:
    """Copy ``flat`` back into the run's tensors (nothing to do in place)."""
    if len(run) == 1 and flat is tensors[run[0]]:
        return
    offset = 0
    for i in run:
        n = tensors[i].numel()
        tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
        offset += n


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Every tensor replaced by its mean over the ranks (a sum, then a
    division by the world size), in buckets of at most BUCKET_BYTES."""
    world = dist.get_world_size()
    for run in _buckets(tensors, range(len(tensors))):
        flat = _flat(tensors, run)
        dist.all_reduce(flat)
        if world > 1:
            flat.div_(world)
        _unflat(flat, tensors, run)


@torch.no_grad()
def broadcast_from_owners_(tensors: Sequence[torch.Tensor], owners: Sequence[int]) -> None:
    """Every rank's tensors set to their owners' values."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world == 1:
        return
    for owner in range(world):
        mine = [i for i, o in enumerate(owners) if o == owner]
        for run in _buckets(tensors, mine):
            if rank == owner:
                flat = _flat(tensors, run)
            else:
                t = tensors[run[0]]
                flat = torch.empty(sum(tensors[i].numel() for i in run), dtype=t.dtype,
                                   device=t.device)
            dist.broadcast(flat, src=owner)
            if rank != owner:
                _unflat(flat, tensors, run)


class ShardedOptimizer:
    """The optimizer over the tensors this rank owns (``owners[i] ==
    rank``), with the interface the trainer uses: ``param_groups``,
    ``state``, ``step()``, and a ``state_dict()`` / ``load_state_dict()``
    whose parameter indices are the global ones, so the merged state of all
    ranks (:meth:`gather_state_dict`) is the state dict of one optimizer
    over every tensor: a checkpoint written at one world size resumes at
    any other."""

    def __init__(self, params: Sequence[torch.nn.Parameter], owners: Sequence[int],
                 rank: int, build: Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer]):
        self.params = list(params)
        self.owners = list(owners)
        self.rank = rank
        self.local = [i for i, o in enumerate(self.owners) if o == rank]
        self.optimizer = build([self.params[i] for i in self.local]) if self.local else None

    @property
    def param_groups(self) -> list:
        return self.optimizer.param_groups if self.optimizer is not None else []

    @property
    def state(self) -> dict:
        return self.optimizer.state if self.optimizer is not None else {}

    def step(self) -> None:
        if self.optimizer is not None:
            self.optimizer.step()

    def state_dict(self) -> dict:
        """This rank's state under global parameter indices."""
        if self.optimizer is None:
            return {"state": {}, "param_groups": []}
        sd = self.optimizer.state_dict()
        return {"state": {self.local[j]: s for j, s in sd["state"].items()},
                "param_groups": [{**g, "params": [self.local[j] for j in g["params"]]}
                                 for g in sd["param_groups"]]}

    def gather_state_dict(self) -> Optional[dict]:
        """Every rank's state dict, copied to the host, merged on rank 0
        into the state dict of one optimizer over all tensors (one parameter
        group, indices 0..n-1); None on the other ranks. A collective."""
        from rankpo_tpu_torch.train.checkpoint import host_copy

        mine = host_copy(self.state_dict())
        parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
        dist.gather_object(mine, parts, dst=0)
        if parts is None:
            return None
        state: Dict[int, dict] = {}
        for part in parts:
            state.update(part["state"])
        group = next(p["param_groups"][0] for p in parts if p["param_groups"])
        return {"state": {i: state[i] for i in sorted(state)},
                "param_groups": [{**group, "params": list(range(len(self.params)))}]}

    def load_state_dict(self, full: dict) -> None:
        """Take this rank's tensors' entries of a whole state dict (one
        parameter group over every tensor, as :meth:`gather_state_dict`
        and the unsharded optimizer write it)."""
        if self.optimizer is None:
            return
        (group,) = full["param_groups"]
        if len(group["params"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(group['params'])} tensors, "
                             f"the model trains {len(self.params)}")
        state = {j: full["state"][i] for j, i in enumerate(self.local) if i in full["state"]}
        self.optimizer.load_state_dict(
            {"state": state, "param_groups": [{**group, "params": list(range(len(self.local)))}]})
