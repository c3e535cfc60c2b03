"""Training configuration (port of ``rankpo_tpu.train.config``).

The fields are the JAX package's, so the CLIs take the same flags, plus
``device``. The port trains data-parallel, one process per card:
``zero1`` shards the optimizer state over the data group, and ``zero2``
takes ``zero1``'s path (``parallel/sharding.py``; both mean nothing in one
process); ``model_parallel`` splits the model over that many ranks
(tensor parallelism, ``core/mesh.py`` ``make_groups``); ``fsdp`` stores
each trainable parameter on one rank of the data group
(``parallel/fsdp.py``), with a model axis each model rank's shards over its
data group.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from rankpo_tpu_torch.core.mesh import MeshConfig

OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
STRATEGIES = ("no", "steps", "epoch")


@dataclasses.dataclass
class TrainConfig:
    output_dir: str = "outputs/run"
    overwrite_output_dir: bool = False

    # optimization
    learning_rate: float = 1e-5
    # cosine | linear | constant | constant_with_warmup | polynomial |
    # cosine_with_restarts | cosine_with_min_lr | inverse_sqrt
    lr_scheduler_type: str = "cosine"
    lr_end: float = 1e-7  # polynomial / cosine_with_min_lr floor
    lr_power: float = 1.0  # polynomial only
    lr_num_cycles: int = 1  # cosine_with_restarts only
    warmup_ratio: float = 0.1
    warmup_steps: int = 0
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    optim: str = "adamw"  # adamw | adamw8bit | adafactor

    # schedule
    num_train_epochs: int = 3
    max_steps: int = -1
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: Optional[int] = None
    gradient_accumulation_steps: int = 1
    dataloader_drop_last: bool = True
    seed: int = 42

    # precision / memory
    bf16: bool = True
    pure_bf16: bool = False
    gradient_checkpointing: bool = False
    # full | dots | attn (models/base.py CHECKPOINT_POLICIES)
    gradient_checkpointing_policy: str = "full"

    # parallelism (data, tensor and sharded-parameter parallel)
    model_parallel: int = 1
    zero1: bool = True
    zero2: bool = False
    fsdp: bool = False

    # robustness / observability
    skip_nonfinite_updates: bool = True
    profile_steps: int = 0
    profile_start_step: int = 10
    save_on_preemption: bool = True
    debug_nans: bool = False

    # evaluation during training (no | steps | epoch)
    eval_strategy: str = "no"
    eval_steps: int = 0

    # logging / checkpointing
    logging_strategy: str = "steps"  # no | steps | epoch
    logging_steps: int = 1
    save_strategy: str = "epoch"  # epoch | steps | no
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    save_only_model: bool = True
    async_checkpointing: bool = False
    resume_from_checkpoint: Optional[str] = None
    run_name: str = "auto"
    wandb_project: str = ""
    log_level: str = "info"

    # the card the port trains on ("cuda" fails without one; "cpu" runs the
    # plain PyTorch path)
    device: str = "cuda"

    def to_json_string(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def check_supported(self) -> None:
        """Raise for a model axis below 1 and for unknown option values
        (the optimizer on a split model is the trainer's check,
        ``train/trainer.py``)."""
        MeshConfig(model_parallel=self.model_parallel).check_supported()
        if self.optim not in OPTIMIZERS:
            raise ValueError(f"unknown optim {self.optim!r}; one of {list(OPTIMIZERS)}")
        for name in ("logging_strategy", "save_strategy", "eval_strategy"):
            if getattr(self, name) not in STRATEGIES:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}")
