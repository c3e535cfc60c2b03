"""Process-group bring-up and the (data, model) grid (port of
``rankpo_tpu.core.mesh``).

The JAX package builds one ``Mesh`` over every device and lets XLA place
the collectives. The port runs one process per card (the torchrun model):
each process drives one device and ``torch.distributed`` carries the
collectives. The mesh's two axes become process groups
(:func:`make_groups`): rank ``r = d * mp + m`` has data index ``d`` and
model index ``m``, the model axis innermost as JAX's ``make_mesh`` lays the
devices out (``mesh.py:58-72``). The ranks of one model group hold the
shards of one tensor-parallel model (``parallel/sharding.py``); the ranks
of one data group hold the same shard and split the batch. Until
:func:`make_groups` runs (or after the process group it was made for is
gone) the data axis is the whole process group and the model axis has one
rank.

:func:`initialize_distributed` takes the JAX package's three flags
(``--coordinator_address host:port --num_processes W --process_id r``)
and calls ``torch.distributed.init_process_group`` over TCP: NCCL for CUDA
devices, gloo for the CPU, or the backend the caller names. A failure to
bring NCCL up raises; nothing switches to gloo or to the CPU.

Row shards (the sharded index tiers, their encode and serving): a corpus of
``n`` rows is padded to ``padded_rows(n, dp)``, a multiple of the data
group's size, and data index ``d`` holds the contiguous global rows
``shard_bounds(n_padded, dp, d)``, JAX's layout. :func:`all_gather_rows`,
:func:`broadcast_` and :func:`exchange_rows` move rows between the shards:
under NCCL on the device, under gloo through host copies (gloo aborts on
CUDA tensors; ``scripts/ring_hop_probe.py``). Control messages (what a
serving follower runs next, an evaluation's skip decision) go through
:func:`broadcast_object` on :func:`control_group`, a gloo group over every
rank made once: under NCCL a host payload cannot be broadcast, and the
control group's timeout is its own (an idle serving follower waits on it
between requests; ``serve/multihost.py`` keeps it alive).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import time
from typing import Optional, Tuple

import numpy as np

import torch
import torch.distributed as dist

from rankpo_tpu_torch.core.device import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. ``data_parallel=-1`` means "all remaining
    devices" (JAX ``MeshConfig``)."""

    data_parallel: int = -1
    model_parallel: int = 1
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    def resolve(self, n_devices: int) -> tuple:
        mp = max(1, self.model_parallel)
        dp = self.data_parallel
        if dp == -1:
            if n_devices % mp != 0:
                raise ValueError(
                    f"model_parallel={mp} does not divide device count {n_devices}"
                )
            dp = n_devices // mp
        if dp * mp != n_devices:
            raise ValueError(
                f"mesh {dp}x{mp} != available devices {n_devices}"
            )
        return (dp, mp)

    def check_supported(self) -> None:
        """Raise for a model axis below 1 (every other shape is ported;
        whether the world divides is :meth:`resolve`'s check)."""
        if self.model_parallel < 1:
            raise ValueError(f"--model_parallel {self.model_parallel} must be >= 1")


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's place on the (data, model) grid: its two process groups
    (None without a process group: a world of one) and its indices."""

    dp: int
    mp: int
    data: Optional[object]
    model: Optional[object]
    data_index: int
    model_index: int
    world: Optional[object] = None  # the default group the groups were made in


_groups: Optional[Groups] = None


def make_groups(config: Optional[MeshConfig] = None) -> Groups:
    """Build every data group and every model group with
    ``torch.distributed.new_group``, in the same order on every rank (a
    collective), and make this rank's two the current ones. Without a
    process group both are groups of one (None) and nothing is built. The
    grid's shape is ``config.resolve(world size)``, with JAX's errors."""
    global _groups
    config = config or MeshConfig()
    config.check_supported()
    world, rank = process_count(), process_index()
    dp, mp = config.resolve(world)
    if not is_distributed():
        _groups = Groups(dp, mp, None, None, 0, 0)
        return _groups
    data = model = None
    for d in range(dp):  # model groups: the mp consecutive ranks of a data index
        ranks = [d * mp + m for m in range(mp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            model = group
    for m in range(mp):  # data groups: one rank of each model group
        ranks = [d * mp + m for d in range(dp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            data = group
    _groups = Groups(dp, mp, data, model, rank // mp, rank % mp, dist.group.WORLD)
    logger.info("rank %d: data index %d of %d, model index %d of %d", rank, rank // mp, dp,
                rank % mp, mp)
    return _groups


def current_groups() -> Optional[Groups]:
    """The groups :func:`make_groups` made for the live process group, or
    None (never made, or made for a group that was since destroyed)."""
    g = _groups
    if g is None:
        return None
    if g.world is None:
        return None if is_distributed() else g
    return g if is_distributed() and g.world is dist.group.WORLD else None


def data_group():
    """The data axis's process group (None: the default group, when no grid
    was made)."""
    g = current_groups()
    return g.data if g is not None else None


def data_count() -> int:
    g = current_groups()
    return g.dp if g is not None else process_count()


def data_index() -> int:
    g = current_groups()
    return g.data_index if g is not None else process_index()


def model_group():
    """The model axis's process group (None: one rank)."""
    g = current_groups()
    return g.model if g is not None else None


def model_count() -> int:
    g = current_groups()
    return g.mp if g is not None else 1


def model_index() -> int:
    g = current_groups()
    return g.model_index if g is not None else 0


def group_rank(group, index: int) -> int:
    """The global rank of ``group``'s ``index``-th rank (``index`` itself
    for the default group)."""
    return index if group is None else dist.get_global_rank(group, index)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the process group ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``. A no-op without a coordinator
    address (one process, as in JAX) and when a process group already
    exists (a caller that made the group itself, with the backend it
    needs, then calls a CLI's ``main``). ``backend`` defaults to ``nccl``
    for a CUDA ``device`` and ``gloo`` for the CPU; before NCCL comes up the
    process takes its card (:func:`rank_device`)."""
    if dist.is_initialized() or coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is not in [0, {num_processes})")
    device = resolve_device(device)  # a CUDA request without a card raises
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id)
    logger.info("process %d of %d joined %s over %s", process_id, num_processes,
                coordinator_address, backend)


def is_distributed() -> bool:
    """Whether a process group exists (at any world size, one included)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every process of the group; a no-op without one."""
    if is_distributed():
        dist.barrier()


def rank_device(device="cuda", process_id: Optional[int] = None) -> torch.device:
    """This process's device: ``cuda:<process_id % card count>`` for a CUDA
    ``device`` (two ranks on a one-card machine share ``cuda:0``), the
    device itself otherwise. Resolved through ``core/device.py``, so a CUDA
    request without a card raises."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = process_index() if process_id is None else process_id
    return torch.device("cuda", rank % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# row shards over the data group

def padded_rows(n: int, dp: int) -> int:
    """``n`` rows padded to a multiple of ``dp`` shards (JAX's
    ``(-n) % n_shards`` pad rows)."""
    return n + (-n) % dp


def shard_bounds(n_padded: int, dp: int, d: int) -> Tuple[int, int]:
    """Global rows ``[lo, hi)`` of shard ``d`` of ``dp`` over ``n_padded``
    rows (a multiple of ``dp``)."""
    rows = n_padded // dp
    return d * rows, (d + 1) * rows


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_index(group) -> int:
    """This rank's index in ``group`` (its data index for a data group)."""
    return dist.get_rank(group)


def host_collectives(group) -> bool:
    """Whether ``group``'s collectives take host tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


# all_gather_rows's calls, the bytes each rank sent and the host seconds
# (under NCCL the enqueue only)
gather_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_gather_stats() -> None:
    gather_stats.update(calls=0, bytes=0, seconds=0.0)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along dim 0
    in ``group``'s rank order, on ``x``'s device: one all-gather on the
    device under NCCL, through host copies under gloo. A collective."""
    t0 = time.perf_counter()
    w = dist.get_world_size(group)
    src = x.contiguous()
    out = src.new_empty((w * src.shape[0],) + tuple(src.shape[1:]))
    if host_collectives(group):
        src, out = src.cpu(), out.cpu()
        dist.all_gather(list(out.chunk(w)) if src.shape[0] else
                        [src.new_empty(src.shape) for _ in range(w)], src, group=group)
        out = out.to(x.device)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    gather_stats["calls"] += 1
    gather_stats["bytes"] += src.numel() * src.element_size()
    gather_stats["seconds"] += time.perf_counter() - t0
    return out


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` (contiguous) overwritten in place with group index ``src``'s
    tensor; under gloo through a host copy. A collective."""
    buf = x.cpu() if host_collectives(group) else x
    dist.broadcast(buf, src=group_rank(group, src), group=group)
    if buf is not x:
        x.copy_(buf)
    return x


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (a sum by default; under gloo
    through a host copy). A collective."""
    buf = x.cpu() if host_collectives(group) else x
    dist.all_reduce(buf, op=op, group=group)
    if buf is not x:
        x.copy_(buf)
    return x


def exchange_rows(local: torch.Tensor, src_ids, shard_rows: int, group,
                  dest: Optional[np.ndarray] = None) -> torch.Tensor:
    """Rows of a tensor row-sharded over ``group`` (``local``: this rank's
    global rows ``[d * shard_rows, (d + 1) * shard_rows)``) at the global
    ids ``src_ids``: position ``j`` takes global row ``src_ids[j]``.
    ``dest`` (group index per position) names the one rank that keeps each
    position; None: every rank keeps every position. Returns the kept
    positions' rows in position order. Each owner in turn broadcasts the
    rows that another rank keeps (one shard's block in flight at a time);
    its own it copies. A collective of ``group``."""
    me, w = dist.get_rank(group), dist.get_world_size(group)
    src_ids = np.asarray(src_ids, np.int64).reshape(-1)
    owner = src_ids // shard_rows
    mine = np.ones(src_ids.size, bool) if dest is None else np.asarray(dest) == me
    slot = np.cumsum(mine) - 1  # each kept position's row in the output
    out = local.new_zeros((int(mine.sum()),) + tuple(local.shape[1:]))

    def idx(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(local.device)

    for s in range(w):
        of_s = owner == s
        if s == me and (of_s & mine).any():
            take = of_s & mine
            out[idx(slot[take])] = local[idx(src_ids[take] - s * shard_rows)]
        sent = of_s if dest is None else of_s & (np.asarray(dest) != s)
        if not sent.any():
            continue
        if s == me:
            block = local[idx(src_ids[sent] - s * shard_rows)].contiguous()
        else:
            block = local.new_empty((int(sent.sum()),) + tuple(local.shape[1:]))
        broadcast_(block, s, group)
        take = mine[sent]
        if s != me and take.any():
            out[idx(slot[sent][take])] = block[idx(np.nonzero(take)[0])]
    return out


# ---------------------------------------------------------------------------
# the control plane

CONTROL_TIMEOUT_S = 1800.0  # gloo's default; serving keeps the group alive
_control: Optional[tuple] = None  # (the default group it was made in, group, timeout s)


def control_group(timeout_s: Optional[float] = None):
    """A gloo group over every rank for control messages, made at the first
    call (a collective: every rank calls it at the same point) with
    ``timeout_s`` (default :data:`CONTROL_TIMEOUT_S`); later calls return it."""
    global _control
    if _control is not None and _control[0] is dist.group.WORLD:
        return _control[1]
    timeout = CONTROL_TIMEOUT_S if timeout_s is None else float(timeout_s)
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
    _control = (dist.group.WORLD, group, timeout)
    return group


def control_timeout() -> float:
    """The control group's timeout in seconds (it must exist)."""
    control_group()
    return _control[2]


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` (picklable) from rank ``src`` of ``group`` (default: the
    control group) to every rank; returns it everywhere. A collective."""
    group = control_group() if group is None else group
    box = [obj]
    dist.broadcast_object_list(box, src=group_rank(group, src), group=group)
    return box[0]
