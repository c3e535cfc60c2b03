"""Single-card trainer (port of ``rankpo_tpu.train.trainer``).

One optimizer step per accumulation group, as ``rankpo_tpu.train.Trainer``
takes it (``trainer.py:208-312``):

- the loss function runs forward and backward on each micro-batch of the
  [accum, B, ...] group; the gradients are summed over the group and then
  scaled by 1/accum (the mean of the micro-batch gradients), and so are the
  loss and the metrics;
- the global gradient norm (before clipping) is logged; clipping follows
  optax's rule (``train/state.py``); AdamW applies the update at the
  schedule's value for the optimizer's own update count;
- non-finite skip (``skip_nonfinite_updates``, ``trainer.py:281-293``): when
  the loss or the gradient norm is not finite, neither the parameters nor
  the optimizer state change, so the schedule does not advance either.

- dropout: with ``dropout_seed`` the loss function is called as
  ``loss_fn(model, batch, generator)`` with a CPU generator seeded from
  (``dropout_seed``, step, micro-batch), so every step and micro-batch
  draws new masks and a rerun from the same seed draws the same ones (the
  JAX trainer's ``fold_in(rng, step)`` then ``split(.., accum)``).

``_train_loop`` (``trainer.py:482``) logs interval means with the JAX
package's ordered keys, plus ``step_time``, ``samples_per_sec``,
``tokens_per_sec`` and ``mfu`` (utils/flops.py), stops at ``max_steps``,
and writes model-only checkpoints with rotation.

Every step ends in one device synchronisation (the finite check reads the
loss and the norm), so ``step_time`` is the step's wall time. Not ported
yet (ROADMAP.md Queue 1 item 2): optimizer-state checkpoints and resume,
the SIGTERM checkpoint, ``evaluate`` and in-training evaluation, gradient
caching.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rankpo_tpu_torch.data.loader import DataLoader
from rankpo_tpu_torch.train import checkpoint as ckpt
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.state import clip_grad_norm, global_norm, make_optimizer
from rankpo_tpu_torch.utils.flops import peak_flops_per_chip

logger = logging.getLogger(__name__)

# ordered log keys, matching the reference's log stream
# (contrastive_trainer.py:1059-1067)
_LOG_KEY_ORDER = [
    "global_step",
    "loss",
    "learning_rate",
    "grad_norm",
    "global_epoch",
    "epoch",
    "step",
]


def _micro_batch(group: dict, i: int, device: torch.device) -> dict:
    """Micro-batch ``i`` of a stacked numpy group as device tensors (token
    ids as int64 for the embedding gather)."""
    out = {}
    for key, value in group.items():
        if isinstance(value, dict):
            out[key] = _micro_batch(value, i, device)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value[i]))
            if key == "input_ids":
                t = t.long()
            out[key] = t.to(device)
    return out


class Trainer:
    def __init__(
        self,
        *,
        loss_fn: Callable,
        model: torch.nn.Module,
        config: TrainConfig,
        total_steps: int,
        save_params_fn: Optional[Callable] = None,
        log_fn: Optional[Callable] = None,
        sample_flops: Optional[float] = None,
        sample_tokens: Optional[float] = None,
        peak_flops: Optional[float] = None,
        dropout_seed: Optional[int] = None,
    ):
        """loss_fn(model, batch) -> (loss, metrics) on one micro-batch of
        device tensors. save_params_fn(directory, model) writes the model
        (the caller owns config and tokenizer). sample_flops/sample_tokens:
        per-sample model FLOPs and padded tokens (utils/flops.py) for
        ``tokens_per_sec`` and ``mfu``; ``peak_flops`` defaults to the card's
        (``peak_flops_per_chip``). ``dropout_seed``: see the module
        docstring; None calls ``loss_fn(model, batch)``."""
        config.check_supported()
        self.loss_fn = loss_fn
        self.model = model
        self.config = config
        self.total_steps = total_steps
        self.save_params_fn = save_params_fn
        self.log_fn = log_fn
        self.sample_flops = sample_flops
        self.sample_tokens = sample_tokens
        self.dropout_seed = dropout_seed
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.device = self.params[0].device
        if peak_flops is None and sample_flops is not None:
            peak_flops = peak_flops_per_chip(self.device)
        self._peak_flops = peak_flops
        self.optimizer, self.schedule = make_optimizer(self.params, config, total_steps)
        self.step = 0  # optimizer steps taken, skipped ones included
        self.updates = 0  # updates applied: the schedule's count, as optax's
        self._history: List[Dict] = []
        if config.save_on_preemption:
            logger.info("save_on_preemption: the SIGTERM checkpoint is not "
                        "ported yet (ROADMAP.md Queue 1 item 2)")

    # ------------------------------------------------------------------
    def train_step(self, group: dict) -> Dict[str, float]:
        """One optimizer step on a [accum, B, ...] group of numpy
        micro-batches. Returns the step's loss, grad_norm and metrics."""
        cfg = self.config
        accum = cfg.gradient_accumulation_steps
        for p in self.params:
            p.grad = None
        loss_sum = None
        metric_sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            batch = _micro_batch(group, i, self.device)
            if self.dropout_seed is None:
                loss, metrics = self.loss_fn(self.model, batch)
            else:
                loss, metrics = self.loss_fn(self.model, batch, self._generator(i))
            loss.backward()  # sums into .grad across the group
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for key, value in metrics.items():
                metric_sums[key] = value if key not in metric_sums else metric_sums[key] + value
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if accum > 1:
            inv = 1.0 / accum
            loss_sum = loss_sum * inv
            metric_sums = {k: v * inv for k, v in metric_sums.items()}
            torch._foreach_mul_(grads, inv)
        grad_norm = global_norm(grads)
        # one device sync per step: the finite check and the logged values
        names = ["loss", "grad_norm", *metric_sums]
        values = torch.stack(
            [loss_sum.float(), grad_norm.float()]
            + [v.float() for v in metric_sums.values()]
        ).tolist()
        out = dict(zip(names, values))
        ok = bool(np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]))
        if ok or not cfg.skip_nonfinite_updates:
            if cfg.max_grad_norm and cfg.max_grad_norm > 0:
                clip_grad_norm(grads, cfg.max_grad_norm, grad_norm)
            lr = self.schedule(self.updates)
            for group_ in self.optimizer.param_groups:
                group_["lr"] = lr
            self.optimizer.step()
            self.updates += 1
        for p in self.params:
            p.grad = None
        self.step += 1
        return out

    def _generator(self, micro: int) -> torch.Generator:
        """The dropout generator of micro-batch ``micro`` of this step."""
        seed = np.random.SeedSequence([self.dropout_seed, self.step, micro])
        return torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))

    # ------------------------------------------------------------------
    def train(self, dataset, collator) -> List[Dict]:
        """The training loop over epochs (``trainer.py:482-698``)."""
        cfg = self.config
        micro = cfg.per_device_train_batch_size
        accum = cfg.gradient_accumulation_steps
        loader = DataLoader(dataset, collator, batch_size=micro, shuffle=True,
                            drop_last=cfg.dataloader_drop_last, seed=cfg.seed)
        steps_per_epoch = loader.steps_per_epoch() // accum
        if steps_per_epoch == 0:
            logger.warning(
                "dataset (%d rows) is smaller than one optimizer step (batch "
                "%d x accum %d = %d rows): ZERO training steps will run",
                len(dataset), micro, accum, micro * accum,
            )
        global_step = self.step
        t_start = time.time()
        for epoch in range(cfg.num_train_epochs):
            step_in_epoch = 0
            buffer: List[Dict[str, float]] = []
            times: List[float] = []
            for group in loader.epoch(epoch, stack=accum):
                t_step = time.perf_counter()
                metrics = self.train_step(group)
                times.append(time.perf_counter() - t_step)
                global_step = self.step
                step_in_epoch += 1
                if cfg.logging_strategy != "no":
                    buffer.append(metrics)
                if (cfg.logging_strategy == "steps" and cfg.logging_steps
                        and global_step % cfg.logging_steps == 0):
                    logs = self._interval_logs(buffer, global_step, epoch,
                                               step_in_epoch, steps_per_epoch)
                    logs["step_time"] = round(sum(times) / len(times), 4)
                    samples_per_sec = micro * accum * len(times) / sum(times)
                    logs["samples_per_sec"] = round(samples_per_sec, 2)
                    if self.sample_tokens is not None:
                        logs["tokens_per_sec"] = round(samples_per_sec * self.sample_tokens, 1)
                    if self.sample_flops is not None and self._peak_flops:
                        logs["mfu"] = round(
                            samples_per_sec * self.sample_flops / self._peak_flops, 4)
                    buffer, times = [], []
                    self._log(logs)
                if (cfg.save_strategy == "steps" and cfg.save_steps
                        and global_step % cfg.save_steps == 0):
                    self.save_checkpoint(global_step, epoch)
                if cfg.max_steps > 0 and global_step >= cfg.max_steps:
                    self.save_checkpoint(global_step, epoch)
                    return self._history
            if cfg.logging_strategy == "epoch" and buffer:
                logs = self._interval_logs(buffer, global_step, epoch,
                                           step_in_epoch, steps_per_epoch)
                logs["global_epoch"] = epoch + 1
                self._log(logs)
            if cfg.save_strategy == "epoch":
                self.save_checkpoint(global_step, epoch)
        logger.info("training done: %d steps in %.1fs", global_step, time.time() - t_start)
        return self._history

    def _interval_logs(self, buffer, global_step, epoch, step_in_epoch,
                       steps_per_epoch) -> Dict:
        """Means over the interval's steps of loss, grad_norm and every
        metric, with the schedule's value at the last step."""
        means = {k: sum(m[k] for m in buffer) / len(buffer) for k in buffer[0]}
        logs = {
            "global_step": global_step,
            "loss": means.pop("loss"),
            "learning_rate": float(self.schedule(global_step - 1)),
            "grad_norm": means.pop("grad_norm"),
            "global_epoch": round(epoch + step_in_epoch / max(steps_per_epoch, 1), 4),
            "epoch": epoch,
            "step": step_in_epoch,
        }
        logs.update(means)
        return logs

    def _log(self, logs: Dict) -> None:
        ordered = {k: logs[k] for k in _LOG_KEY_ORDER if k in logs}
        ordered.update({k: v for k, v in logs.items() if k not in ordered})
        self._history.append(ordered)
        logger.info("%s", ordered)
        if self.log_fn is not None:
            self.log_fn(ordered)

    # ------------------------------------------------------------------
    def save_checkpoint(self, global_step: int, epoch: int) -> Optional[str]:
        """Model-only checkpoint ``output_dir/checkpoint-{global_step}``."""
        if self.config.save_strategy == "no":
            return None
        directory = os.path.join(self.config.output_dir, f"checkpoint-{global_step}")
        os.makedirs(directory, exist_ok=True)
        if self.save_params_fn is not None:
            self.save_params_fn(directory, self.model)
        ckpt.save_trainer_state(directory, {"global_step": global_step, "epoch": epoch},
                                self.config)
        ckpt.rotate_checkpoints(self.config.output_dir, self.config.save_total_limit)
        logger.info("saved checkpoint: %s", directory)
        return directory
