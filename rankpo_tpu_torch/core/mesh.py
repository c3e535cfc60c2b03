"""Process-group bring-up for data-parallel training (port of
``rankpo_tpu.core.mesh``).

The JAX package builds one ``Mesh`` over every device and lets XLA place
the collectives. The port runs one process per card (the torchrun model):
each process drives one device, ``torch.distributed`` carries the
collectives, and the data axis is the whole process group. Tensor
parallelism (the mesh's ``model`` axis) is not ported: a
``model_parallel`` above 1 raises (ROADMAP.md Queue 1 item 8b).

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
_NEXT_SLICE = "ROADMAP.md Queue 1 item 8b, sharded models"


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
        """Raise for a model axis: the port has data parallelism only
        (``TrainConfig.check_supported`` asks here)."""
        if self.model_parallel > 1:
            raise NotImplementedError(
                f"--model_parallel {self.model_parallel}: tensor parallelism is not "
                f"ported to rankpo_tpu_torch yet ({_NEXT_SLICE}); leave it at 1")


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
