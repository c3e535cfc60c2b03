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
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

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
