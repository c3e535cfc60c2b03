"""Tensor-parallel rules, data-parallel gradient exchange and ZeRO-1/ZeRO-2
optimizer sharding (port of ``rankpo_tpu.parallel.sharding``).

Tensor parallelism (the model axis, ``core/mesh.py`` ``make_groups``), the
Megatron layout of JAX's rules (``sharding.py:27-55``): the column-parallel
projections (Llama's ``q/k/v_proj``, ``gate_proj``, ``up_proj``;
Roberta's ``query/key/value`` and ``intermediate``, biases with their
weights, Qwen2's q/k/v biases too) are split on their output features,
the row-parallel ones (``o_proj``, ``down_proj``; Roberta's attention
``output.dense`` and layer ``output.dense``) on their input features, and
embeddings, norms and the row-parallel biases are replicated. A torch
``Linear`` weight is ``[out, in]`` where JAX's kernel is ``[in, out]``, so
column-parallel is dim 0 here and row-parallel dim 1 (:func:`tp_dim`).
:func:`shard_state` cuts a full HF-named state dict to a rank's shard,
:func:`gather_state` puts the shards of a model group back together. Where
JAX quietly replicates a weight whose dim the axis does not divide
(``sharding.py:70-78``), the port raises at build time
(:func:`check_divisible`). In the bodies :func:`copy_to_model` (identity
forward, ``all_reduce`` backward) feeds the column-parallel projections and
:func:`row_parallel_linear` (the rank's partial product, ``all_reduce``
forward, identity backward into the product's own backward) sums the
row-parallel ones. Both sum in fp32 and round once; the row-parallel
partial products are fp32 themselves (``torch.mm(..., out_dtype=
torch.float32)`` on bf16 operands) with the bias added before the rounding,
so the forward rounds where one process's bf16 product rounds and the two
differ by fp32 summation order only.

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

from rankpo_tpu_torch.core import mesh

BUCKET_BYTES = 256 * 2**20  # gradients exchanged per collective

# HF module names (suffixes) split over the model axis
COLUMN_PARALLEL = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                   "mlp.gate_proj", "mlp.up_proj", "attention.self.query",
                   "attention.self.key", "attention.self.value", "intermediate.dense")
ROW_PARALLEL = ("self_attn.o_proj", "mlp.down_proj", "output.dense")


def tp_dim(name: str) -> Optional[int]:
    """The dim of tensor ``name`` (HF-named) that the model axis splits:
    0 for a column-parallel weight or bias, 1 for a row-parallel weight,
    None for a replicated tensor. LoRA's ``lora_a`` / ``lora_b`` are whole
    on every model rank (no rule of JAX's matches them), whichever
    projection they adapt (``models/lora.py``)."""
    module, _, kind = name.rpartition(".")
    if kind in ("lora_a", "lora_b"):
        return None
    if module.endswith(COLUMN_PARALLEL):
        return 0
    if module.endswith(ROW_PARALLEL) and kind == "weight":
        return 1
    return None


def check_divisible(config, mp: int) -> None:
    """Raise unless ``mp`` divides the query heads, the kv heads and the MLP
    width (each rank's attention runs whole heads)."""
    if mp <= 1:
        return
    sizes = {"num_attention_heads": config.num_attention_heads,
             "num_key_value_heads": config.num_key_value_heads,
             "intermediate_size": config.intermediate_size}
    bad = {k: v for k, v in sizes.items() if v % mp}
    if bad:
        raise ValueError(f"--model_parallel {mp} does not divide {bad}: tensor parallelism "
                         "splits whole heads and MLP columns (the JAX package would "
                         "replicate such weights instead)")


def shard_state(state: Dict[str, torch.Tensor], mp: int, index: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s shard of a full HF-named state dict (views of
    the full tensors: the model builds copy them)."""
    if mp <= 1:
        return state
    out = {}
    for name, t in state.items():
        dim = tp_dim(name)
        out[name] = t if dim is None else t.chunk(mp, dim)[index]
    return out


@torch.no_grad()
def gather_state(state: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The full tensors from every model rank's shard (a collective of the
    model group; every rank gets them): the split tensors concatenated on
    their :func:`tp_dim`, the replicated ones as they are."""
    mp = 1 if group is None else dist.get_world_size(group)
    if mp <= 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = tp_dim(name)
        if dim is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mp)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[name] = torch.cat(parts, dim)
    return out


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the one-process layout: its own without
    tensor parallelism or fsdp; under fsdp every tensor from its owner (a
    collective of the data group, ``parallel/fsdp.py``); under
    tensor parallelism then the model group's shards gathered (a collective
    of the model group)."""
    tp = getattr(model, "tp", None)
    if getattr(model, "fsdp", None) is not None:
        from rankpo_tpu_torch.parallel.fsdp import full_state_dict as fsdp_state

        state = fsdp_state(model)
    else:
        state = model.state_dict()
    return state if tp is None else gather_state(state, tp.group)


def gather_tp_optimizer_state(state: dict, dims: Sequence[Optional[int]],
                              shapes: Sequence[torch.Size], group) -> Optional[dict]:
    """One optimizer state dict in the one-process layout from each model
    rank's (global parameter indices, on the host): every tensor of
    parameter i shaped like the rank's shard ``shapes[i]`` is concatenated
    over the ranks on ``dims[i]``; the rest (counts, replicated tensors'
    moments) is the first rank's. Returns it on the group's first rank,
    None elsewhere. A collective of the model group."""
    first = dist.get_rank(group) == 0
    parts = [None] * dist.get_world_size(group) if first else None
    dist.gather_object(state, parts, dst=mesh.group_rank(group, 0), group=group)
    if not first:
        return None
    out = {"state": {}, "param_groups": parts[0]["param_groups"]}
    for i, entry in parts[0]["state"].items():
        dim = dims[i]
        out["state"][i] = {
            key: (torch.cat([p["state"][i][key] for p in parts], dim)
                  if dim is not None and isinstance(t, torch.Tensor) and t.shape == shapes[i]
                  else t)
            for key, t in entry.items()}
    return out


def shard_tp_optimizer_state(full: dict, dims: Sequence[Optional[int]],
                             shapes: Sequence[torch.Size], mp: int, index: int) -> dict:
    """Model rank ``index``'s part of a one-process optimizer state dict:
    every tensor of parameter i shaped like the whole parameter (the
    shard's ``shapes[i]`` times ``mp`` on ``dims[i]``) cut to the rank's
    chunk (:func:`gather_tp_optimizer_state` undone)."""
    out = {"state": {}, "param_groups": full["param_groups"]}
    for i, entry in full["state"].items():
        dim = dims[i]
        whole = None
        if dim is not None:
            whole = list(shapes[i])
            whole[dim] *= mp
        out["state"][i] = {
            key: (t.chunk(mp, dim)[index].clone()
                  if whole is not None and isinstance(t, torch.Tensor)
                  and list(t.shape) == whole else t)
            for key, t in entry.items()}
    return out


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group in fp32, rounded once to x's dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group), None


class _RowParallelLinear(torch.autograd.Function):
    """x [..., in / mp] times this rank's w [out, in / mp]: the fp32 partial
    products summed over the model group, the bias added in fp32, rounded
    once to x's dtype; the backward is one process's (bf16 products)."""

    @staticmethod
    def forward(ctx, x, w, bias, group):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            # a copy: selective checkpointing may keep the product itself
            y = (x2 @ w.t()).clone()
        elif x.is_cuda:  # fp32 accumulators kept, not rounded to bf16
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:  # the same numbers on the host: bf16 products are exact in fp32
            y = x2.float() @ w.float().t()
        dist.all_reduce(y, group=group)
        if bias is not None:
            y += bias.float()
        return y.to(x.dtype).view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ w).view_as(x)
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        db = g2.sum(0) if ctx.has_bias else None
        return dx, dw, db, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of the column-parallel projections: ``x`` itself; its
    gradient is the sum of the model ranks' gradients."""
    return _CopyToModel.apply(x, group)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        group) -> torch.Tensor:
    """A row-parallel projection's output: this rank's partial product
    summed over the model group (module docstring); ``weight`` and ``bias``
    in x's dtype."""
    return _RowParallelLinear.apply(x, weight, bias, group)


def tp_global_norm(grads: Sequence[torch.Tensor], split: Sequence[bool], group,
                   owned: bool = False, data_group=None) -> torch.Tensor:
    """The gradient norm of the whole model from one rank's gradients
    (``optax.global_norm`` of JAX's global arrays). ``owned`` (fsdp): each
    gradient lies on its owner alone (the other ranks' are empty), so the
    squares are first summed over ``data_group`` (None: every rank). Then
    the squares of the split tensors are summed over the model group
    ``group`` (None: no model axis) and the replicated ones counted once.
    A collective of those groups."""
    norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
    mask = torch.tensor(list(split), device=norms.device)
    sq = norms.square()
    parts = torch.stack([torch.where(mask, sq, 0.0).sum(), torch.where(mask, 0.0, sq).sum()])
    if owned:
        dist.all_reduce(parts, group=data_group)
    split_sq, replicated_sq = parts[0].clone(), parts[1]
    if group is not None:
        dist.all_reduce(split_sq, group=group)
    return torch.sqrt(split_sq + replicated_sq)


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
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Every tensor replaced by its mean over the ranks of ``group`` (by
    default every rank: a sum, then a division by the group's size), in
    buckets of at most BUCKET_BYTES."""
    world = dist.get_world_size(group)
    for run in _buckets(tensors, range(len(tensors))):
        flat = _flat(tensors, run)
        dist.all_reduce(flat, group=group)
        if world > 1:
            flat.div_(world)
        _unflat(flat, tensors, run)


@torch.no_grad()
def broadcast_from_owners_(tensors: Sequence[torch.Tensor], owners: Sequence[int],
                           group=None) -> None:
    """Every rank's tensors set to their owners' values; ``owners`` are
    ranks of ``group`` (by default every rank)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
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
            dist.broadcast(flat, src=mesh.group_rank(group, owner), group=group)
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
                 rank: int, build: Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer],
                 group=None):
        self.params = list(params)
        self.owners = list(owners)
        self.rank = rank  # this rank's index in ``group`` (by default every rank)
        self.group = group
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
        """Every rank's state dict, copied to the host, merged on the
        group's first rank into the state dict of one optimizer over all
        tensors (one parameter group, indices 0..n-1); None on the other
        ranks. A collective of the group."""
        from rankpo_tpu_torch.train.checkpoint import host_copy

        mine = host_copy(self.state_dict())
        group = self.group
        first = dist.get_rank(group) == 0
        parts = [None] * dist.get_world_size(group) if first else None
        dist.gather_object(mine, parts, dst=mesh.group_rank(group, 0), group=group)
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
