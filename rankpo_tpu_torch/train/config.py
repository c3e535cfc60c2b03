"""Training configuration (port of ``rankpo_tpu.train.config``).

The fields are the JAX package's, so the CLIs take the same flags, plus
``device``. This slice trains on one card; fields of features that are not
ported yet are accepted at their defaults and raise, naming ROADMAP.md, when
set to anything else (:meth:`TrainConfig.check_supported`). ``zero1`` is
accepted and means nothing on one card. ``save_on_preemption`` is accepted
and not acted on yet (SIGTERM checkpoints, ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

_ROADMAP = "ROADMAP.md Queue 1 item 2"


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
    optim: str = "adamw"  # adamw8bit / adafactor: not ported

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
    # "full"; "dots" / "attn" are not ported (LlamaEncoder.for_training raises)
    gradient_checkpointing_policy: str = "full"

    # parallelism (one card: model_parallel, zero2 and fsdp are not ported)
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

    # evaluation during training (not ported)
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
        """Raise for fields set to features this slice does not port."""
        unported = {
            "optim": ("adamw", "adamw8bit / adafactor"),
            "model_parallel": (1, "tensor parallelism"),
            "zero2": (False, "sharded gradients"),
            "fsdp": (False, "sharded parameters"),
            "eval_strategy": ("no", "evaluate and in-training eval"),
            "resume_from_checkpoint": (None, "optimizer-state checkpoints and resume"),
            "save_only_model": (True, "optimizer-state checkpoints and resume"),
            "profile_steps": (0, "profiler traces"),
            "async_checkpointing": (False, "optimizer-state checkpoints and resume"),
            "debug_nans": (False, "anomaly detection"),
        }
        for name, (default, what) in unported.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"--{name} {value}: {what} is not ported to "
                    f"rankpo_tpu_torch yet ({_ROADMAP}); leave it at {default!r}"
                )
        if self.logging_strategy not in ("no", "steps", "epoch"):
            raise ValueError(f"unknown logging_strategy {self.logging_strategy!r}")
        if self.save_strategy not in ("no", "steps", "epoch"):
            raise ValueError(f"unknown save_strategy {self.save_strategy!r}")
