"""Trainer, on one card or data-parallel over a process group (port of
``rankpo_tpu.train.trainer``).

One optimizer step per accumulation group, as ``rankpo_tpu.train.Trainer``
takes it (``trainer.py:208-312``):

- the loss function runs forward and backward on each micro-batch of the
  [accum, B, ...] group; the gradients are summed over the group and then
  scaled by 1/accum (the mean of the micro-batch gradients), and so are the
  loss and the metrics. A ``grad_fn`` (gradient caching,
  ``train/gradcache.py``) takes the whole group instead and leaves the
  gradients of its one loss in ``.grad``, unscaled, as the JAX
  ``grad_fn`` hook does (``trainer.py:242-246``);
- the global gradient norm (before clipping) is logged; clipping follows
  optax's rule (``train/state.py``); the optimizer (AdamW, the 8-bit AdamW
  or Adafactor) applies the update at the schedule's value for the
  optimizer's own update count;
- non-finite skip (``skip_nonfinite_updates``, ``trainer.py:281-293``): when
  the loss or the gradient norm is not finite, neither the parameters nor
  the optimizer state change, so the schedule does not advance either;
- ``debug_nans`` (the JAX ``jax_debug_nans``): after each micro-batch's
  forward and backward, a finite check of the loss, the metrics and every
  gradient raises ``FloatingPointError`` naming the first non-finite one.
  Off by default, and then the step makes no extra host sync.

- dropout: with ``dropout_seed`` the loss function is called as
  ``loss_fn(model, batch, generator)`` with a CPU generator seeded from
  (``dropout_seed``, step, micro-batch), so every step and micro-batch
  draws new masks and a rerun from the same seed draws the same ones (the
  JAX trainer's ``fold_in(rng, step)`` then ``split(.., accum)``); a
  resumed run, whose step is restored, draws the masks of an uninterrupted
  one.

``train`` (``trainer.py:444-698``) logs interval means with the JAX
package's ordered keys, plus ``step_time``, ``samples_per_sec``,
``tokens_per_sec`` and ``mfu`` (utils/flops.py), stops at ``max_steps``,
evaluates an eval set by ``eval_strategy`` (``evaluate``: no gradients,
row-weighted means, ``eval_`` keys) and calls ``retrieval_eval_fn`` there
(``retrieval_`` keys), traces ``profile_steps`` steps with
``torch.profiler`` into ``output_dir/profile/``, and writes checkpoints
with rotation: the model, and with ``save_only_model=False`` the optimizer
state and both counters (``train/checkpoint.py``, synchronously or on a
background writer). ``resume_from`` restores them; the loop then skips the
finished epochs and steps, and replays the collator over them so its
sampling stands where an uninterrupted run's did. On SIGTERM (with
``save_on_preemption``, in the main thread) the loop finishes the step in
flight, checkpoints and returns.

Every step ends in one device synchronisation (the finite check reads the
loss and the norm), so ``step_time`` is the step's wall time.

Data parallel (a ``torch.distributed`` group of W processes, one card each,
``core/mesh.py``): the global micro-batch is ``per_device_train_batch_size
* W``, as JAX's counts every device of its mesh (``trainer.py:485``), and
the loader hands each data index its rows (``data/loader.py``): W / dp
times the per-device batch under ``model_parallel``. After the
accumulation group one bucketed exchange averages the gradients over the
data group (``parallel/sharding.py``), before the norm: an
``all_reduce``. With ``zero1`` (or
``zero2``, which takes ``zero1``'s path) each rank's optimizer holds the
tensors it owns among its model shard's, and the owners broadcast the
updated values over the data group. The logged loss and metrics are the
means over the ranks, the same on every rank; ``samples_per_sec``,
``tokens_per_sec`` and ``mfu`` count the whole group. ``evaluate`` splits
each global batch over the data indices and sums row-weighted sums over
them. A SIGTERM on any rank stops every rank after the same step (the flag
rides the step's ``all_reduce`` over every rank). Rank 0 writes the files;
a checkpoint's optimizer state is gathered to it first (every rank takes
part), so it is the state one process would have written and resumes at
any world size and model-parallel size. The collectives run on the main
thread only.

Tensor parallel (a model whose ``tp`` is set, ``models/base.py``): the
parameters are the rank's shards; the gradient norm sums the squares of
the split tensors over the model group and counts the replicated ones once
(``sharding.tp_global_norm``, JAX's norm of its global arrays), so clipping
and the non-finite skip agree on every rank; the dropout generator is keyed
by the data index (the ranks of a model group hold the same activations
and must draw the same masks); checkpoints gather the model
(``sharding.full_state_dict``) and the optimizer state
(``sharding.gather_tp_optimizer_state``) into the one-process layout, and
a resume cuts them to the rank's shards. LoRA's adapters are whole on every
model rank (``models/lora.py``): replicated tensors, counted once by the
norm and passed whole through the checkpoints. The 8-bit AdamW and
Adafactor take replicated tensors only (LoRA's case): the 8-bit blocks and
Adafactor's factored moments of a shard are not those of the whole tensor,
and the JAX package fails on a split model too (:meth:`_check_optimizer`).

fsdp (``config.fsdp`` with a process group; ``parallel/fsdp.py``): every
trainable parameter is stored on its owner (ZeRO-1's whole-tensor
partition over the data group) and gathered at each use, the frozen ones
(a LoRA base) whole on every rank; a gradient arrives summed on the owner
during the backward, so the exchange is a division by dp there, the norm
sums the owners' squares over the data group, each owner updates its
tensors and nothing is broadcast after the step. Any optimizer. With a
model axis each model rank's shards are partitioned over its data group:
the norm sums the owners' squares over the data group, then the split
tensors' over the model group; checkpoints gather from the owners, then
over the model group.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.loader import DataLoader
from rankpo_tpu_torch.parallel.fsdp import shard_parameters_
from rankpo_tpu_torch.parallel.sharding import (
    ShardedOptimizer,
    all_reduce_mean_,
    broadcast_from_owners_,
    gather_tp_optimizer_state,
    partition_params,
    shard_tp_optimizer_state,
    tp_dim,
    tp_global_norm,
)
from rankpo_tpu_torch.train import checkpoint as ckpt
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.state import (
    clip_grad_norm,
    fast_forward,
    global_norm,
    make_optimizer,
    make_schedule,
)
from rankpo_tpu_torch.utils.distributed import _bounds, split_between_processes
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


def _to_device(batch: dict, device: torch.device, index: Optional[int] = None) -> dict:
    """A collated numpy batch (or micro-batch ``index`` of a stacked group)
    as device tensors (token ids as int64 for the embedding gather)."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = _to_device(value, device, index)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value if index is None else value[index]))
            if key == "input_ids":
                t = t.long()
            out[key] = t.to(device)
    return out


def _rows(batch: dict) -> int:
    """The batch's rows (texts of the query field: a packed block carries
    them as its ``slots``)."""
    block = batch["query"]
    if "segment_ids" in block:
        return int(block["slots"].shape[0])
    return int(block["input_ids"].shape[0])


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
        grad_fn: Optional[Callable] = None,
        sample_flops: Optional[float] = None,
        sample_tokens: Optional[float] = None,
        peak_flops: Optional[float] = None,
        dropout_seed: Optional[int] = None,
    ):
        """loss_fn(model, batch) -> (loss, metrics) on one micro-batch of
        device tensors. save_params_fn(directory, model) writes the model
        (the caller owns config and tokenizer). grad_fn(model, micro_batches,
        make_generator) -> (loss, metrics), when given, replaces the
        per-micro-batch backward: it takes the group's micro-batches (a list
        of device batches) and ``make_generator(i)`` (a fresh dropout
        generator for micro-batch i, or None without ``dropout_seed``) and
        leaves the gradients of its loss in ``.grad``.
        sample_flops/sample_tokens: per-sample model FLOPs and padded tokens
        (utils/flops.py) for ``tokens_per_sec`` and ``mfu``; ``peak_flops``
        defaults to the card's (``peak_flops_per_chip``). ``dropout_seed``:
        see the module docstring; None calls ``loss_fn(model, batch)``."""
        config.check_supported()
        self.loss_fn = loss_fn
        self.grad_fn = grad_fn
        self.model = model
        self.config = config
        self.total_steps = total_steps
        self.save_params_fn = save_params_fn
        self.log_fn = log_fn
        self.sample_flops = sample_flops
        self.sample_tokens = sample_tokens
        self.dropout_seed = dropout_seed
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.device = self.params[0].device
        if peak_flops is None and sample_flops is not None:
            peak_flops = peak_flops_per_chip(self.device)
        self._peak_flops = peak_flops
        # data parallel: a process group exists (one process per card)
        self._dp = mesh.is_distributed()
        self.world, self.rank = mesh.process_count(), mesh.process_index()
        # the data axis (every rank without a grid) and the model axis
        self.dp, self.data_rank = mesh.data_count(), mesh.data_index()
        self.data_group = mesh.data_group()
        self.tp = getattr(model, "tp", None)
        if self.tp is not None and self.tp.size != mesh.model_count():
            raise ValueError(f"the model is split {self.tp.size} ways, the grid's model axis "
                             f"has {mesh.model_count()} ranks")
        if self._dp and self.dp > 1:
            # every rank starts from its data group's first rank's weights
            broadcast_from_owners_([p.detach() for p in self.params], [0] * len(self.params),
                                   group=self.data_group)
        # fsdp: each parameter stored on its owner only (parallel/fsdp.py)
        self.fsdp = None
        if self._dp and config.fsdp:
            self.fsdp = shard_parameters_(model, self.data_group)
            self.param_names, self.params = list(self.fsdp.names), list(self.fsdp.params)
        # the model-axis dim of each trainable tensor (None: replicated,
        # LoRA's adapters among them)
        self._tp_dims = [tp_dim(n) if self.tp is not None else None for n in self.param_names]
        # each trainable tensor's shape on this model rank (fsdp's storage
        # is empty off its owner)
        self._shapes = (list(self.fsdp.shapes) if self.fsdp is not None
                        else [p.shape for p in self.params])
        self._check_optimizer()
        # owner (data index) of each trainable tensor under zero1 / zero2 /
        # fsdp, else None
        self._owners = None
        if self.fsdp is not None:
            self._owners = self.fsdp.owners
        elif self._dp and (config.zero1 or config.zero2):
            self._owners = partition_params(self.params, self.dp)
        if self._owners is not None:
            self.optimizer = ShardedOptimizer(
                self.params, self._owners, self.data_rank,
                lambda owned: make_optimizer(owned, config, total_steps)[0],
                group=self.data_group)
            self.schedule = make_schedule(config, total_steps)
        else:
            self.optimizer, self.schedule = make_optimizer(self.params, config, total_steps)
        self.step = 0  # optimizer steps taken, skipped ones included
        self.updates = 0  # updates applied: the schedule's count, as optax's
        self._history: List[Dict] = []
        self._eval_data = None
        # model -> {"retrieval_<metric>": value} at each eval point
        # (eval/in_training.py)
        self.retrieval_eval_fn: Optional[Callable] = None
        self._sigterm = False  # this process received SIGTERM
        self._preempted = False  # some rank did: every rank stops after this step

    def _check_optimizer(self) -> None:
        """The 8-bit AdamW and Adafactor train no tensor split over the
        model axis: a shard's 8-bit blocks and factored moments are not the
        whole tensor's. The JAX package fails there too: its
        ``param_partition_specs`` (``rankpo_tpu/parallel/sharding.py:77``)
        matches the kernel rules on the optimizer state's leaves by path
        and indexes a dim they lack (``IndexError``). A departure of
        ROADMAP.md Queue 3; LoRA's adapters, whole on every model rank,
        take any optimizer."""
        split = [n for n, d in zip(self.param_names, self._tp_dims) if d is not None]
        if self.config.optim != "adamw" and split:
            raise NotImplementedError(
                f"--optim {self.config.optim} with --model_parallel {self.tp.size} would "
                f"train split tensors ({split[0]}, ...): the 8-bit blocks and Adafactor's "
                "factored moments of a shard are not the whole tensor's, and the JAX package "
                "raises IndexError here (rankpo_tpu/parallel/sharding.py:77; ROADMAP.md "
                "Queue 3); use adamw, or LoRA, whose adapters are whole on every model rank")

    # ------------------------------------------------------------------
    def train_step(self, group: dict) -> Dict[str, float]:
        """One optimizer step on a [accum, B, ...] group of numpy
        micro-batches. Returns the step's loss, grad_norm and metrics."""
        cfg = self.config
        accum = cfg.gradient_accumulation_steps
        for p in self.params:
            p.grad = None
        if self.grad_fn is not None:
            micro = [_to_device(group, self.device, i) for i in range(accum)]
            make_generator = None if self.dropout_seed is None else self._generator
            loss_sum, metric_sums = self.grad_fn(self.model, micro, make_generator)
            loss_sum = loss_sum.detach()
            if cfg.debug_nans:
                self._check_finite(loss_sum, metric_sums)
        else:
            loss_sum, metric_sums = self._accumulate(group, accum)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if accum > 1 and self.grad_fn is None:
            inv = 1.0 / accum
            loss_sum = loss_sum * inv
            metric_sums = {k: v * inv for k, v in metric_sums.items()}
            torch._foreach_mul_(grads, inv)
        stats = [loss_sum.float()] + [v.float() for v in metric_sums.values()]
        if self._dp:
            if self.fsdp is None:
                all_reduce_mean_(grads, self.data_group)
            elif self.dp > 1:  # the owners hold the sums (the others: empty)
                torch._foreach_div_(grads, float(self.dp))
            # the loss and metrics: means over the ranks (the ranks of a
            # model group hold the same values); the last entry counts the
            # ranks that received SIGTERM
            summed = torch.stack(stats + [torch.tensor(float(self._sigterm), device=self.device)])
            dist.all_reduce(summed)
            means = summed[:-1] / self.world if self.world > 1 else summed[:-1]
            stats = [*means.unbind(), summed[-1]]
        if self.tp is not None or self.fsdp is not None:
            # fsdp: every gradient lies on its owner alone
            grad_norm = tp_global_norm(grads, [d is not None for d in self._tp_dims],
                                       None if self.tp is None else self.tp.group,
                                       owned=self.fsdp is not None, data_group=self.data_group)
        else:
            grad_norm = global_norm(grads)
        # one device sync per step: the finite check, the logged values and
        # the SIGTERM count
        names = ["loss", "grad_norm", *metric_sums]
        values = torch.stack([stats[0], grad_norm.float(), *stats[1:]]).tolist()
        if self._dp:
            self._preempted = values.pop() > 0
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
            if self._owners is not None and self.fsdp is None:
                broadcast_from_owners_([p.detach() for p in self.params], self._owners,
                                       group=self.data_group)
        for p in self.params:
            p.grad = None
        self.step += 1
        return out

    def _accumulate(self, group: dict, accum: int):
        """Forward and backward of each micro-batch, the gradients summed in
        ``.grad``; (loss sum, metric sums)."""
        loss_sum = None
        metric_sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            batch = _to_device(group, self.device, i)
            if self.dropout_seed is None:
                loss, metrics = self.loss_fn(self.model, batch)
            else:
                loss, metrics = self.loss_fn(self.model, batch, self._generator(i))
            loss.backward()  # sums into .grad across the group
            loss = loss.detach()
            if self.config.debug_nans:
                self._check_finite(loss, metrics)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for key, value in metrics.items():
                metric_sums[key] = value if key not in metric_sums else metric_sums[key] + value
        return loss_sum, metric_sums

    def _check_finite(self, loss: torch.Tensor, metrics: Dict[str, torch.Tensor]) -> None:
        """``debug_nans``: raise FloatingPointError naming the first
        non-finite value among the loss, the metrics and the gradients so
        far (one host sync)."""
        names = ["loss", *(f"metric {k}" for k in metrics)]
        tensors = [loss, *metrics.values()]
        for name, p in zip(self.param_names, self.params):
            if p.grad is not None:
                names.append(f"gradient of {name}")
                tensors.append(p.grad)
        finite = torch.stack([torch.isfinite(t).all() for t in tensors]).tolist()
        if not all(finite):
            bad = names[finite.index(False)]
            raise FloatingPointError(
                f"debug_nans: non-finite {bad} at step {self.step + 1}")

    def _generator(self, micro: int) -> torch.Generator:
        """The dropout generator of micro-batch ``micro`` of this step (and
        of this data index, with more than one: each data index's rows draw
        their own masks, and the ranks of a model group the same ones)."""
        key = [self.dropout_seed, self.step, micro] + ([self.data_rank] if self.dp > 1 else [])
        seed = np.random.SeedSequence(key)
        return torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))

    # ------------------------------------------------------------------
    def evaluate(self, dataset, collator, batch_size: Optional[int] = None) -> Dict[str, float]:
        """Loss and metrics over ``dataset`` without gradients or dropout
        (``trainer.py:315-386``): global batches of ``batch_size`` (by
        default the per-device eval size times the ranks) in order, the last
        one partial (an eval set smaller than one batch still gives
        metrics), combined as means weighted by rows; keys prefixed
        ``eval_``. The JAX package pads the last batch to its static shape
        and masks the pad rows out of the loss and the negative pool;
        unpadded, the port computes the same. With several ranks each takes
        its contiguous share of every global batch, padded to equal sizes
        with masked rows (``row_valid``), and the row-weighted sums are
        summed over the ranks."""
        cfg = self.config
        size = batch_size or (
            (cfg.per_device_eval_batch_size or cfg.per_device_train_batch_size) * self.world)
        if self.dp > 1:
            return self._evaluate_sharded(dataset, collator, size)
        loader = DataLoader(dataset, collator, batch_size=size, shuffle=False, drop_last=False)
        sums: Dict[str, float] = {}
        n_rows = 0
        with torch.no_grad():
            for collated in loader.epoch(0):
                batch = _to_device(collated, self.device)
                rows = _rows(batch)
                loss, metrics = self.loss_fn(self.model, batch)
                values = {"loss": loss, **metrics}
                host = torch.stack([v.float() for v in values.values()]).tolist()
                for key, value in zip(values, host):
                    sums[key] = sums.get(key, 0.0) + value * rows
                n_rows += rows
        if n_rows == 0:
            return {}
        return {f"eval_{k}": v / n_rows for k, v in sums.items()}

    def _evaluate_sharded(self, dataset, collator, size: int) -> Dict[str, float]:
        """``evaluate`` over the ranks (see there)."""
        sums: Dict[str, float] = {}
        n_rows = 0
        with torch.no_grad():
            for lo in range(0, len(dataset), size):
                rows = [dataset[i] for i in range(lo, min(lo + size, len(dataset)))]
                local = split_between_processes(rows, apply_padding=True,
                                                process_index=self.data_rank,
                                                process_count=self.dp)
                start, end, _ = _bounds(len(rows), self.data_rank, self.dp, False)
                valid = max(0, min(end, len(rows)) - start)
                batch = _to_device(collator(local), self.device)
                batch["row_valid"] = (torch.arange(len(local), device=self.device)
                                      < valid).to(torch.int32)
                loss, metrics = self.loss_fn(self.model, batch)
                values = {"loss": loss, **metrics}
                weighted = torch.stack([v.float() * valid for v in values.values()])
                dist.all_reduce(weighted, group=self.data_group)
                for key, value in zip(values, weighted.tolist()):
                    sums[key] = sums.get(key, 0.0) + value
                n_rows += len(rows)
        if n_rows == 0:
            return {}
        return {f"eval_{k}": v / n_rows for k, v in sums.items()}

    def _maybe_evaluate(self, global_step: int, epoch: int) -> None:
        """The eval set's loss and metrics, and the ``retrieval_eval_fn``
        metrics on the live model with their wall time
        (``retrieval_eval_runtime``), as one log line (``trainer.py:427-442``);
        either may run without the other."""
        logs: Dict[str, float] = {}
        if self._eval_data is not None:
            logs.update(self.evaluate(*self._eval_data))
        if self.retrieval_eval_fn is not None:
            t0 = time.time()
            logs.update(self.retrieval_eval_fn(self.model))
            logs["retrieval_eval_runtime"] = round(time.time() - t0, 2)
        if logs:
            self._log({"global_step": global_step, "epoch": epoch, **logs})

    # ------------------------------------------------------------------
    def train(self, dataset, collator, *, eval_dataset=None, eval_collator=None) -> List[Dict]:
        """The training loop over epochs (``trainer.py:444-698``). An
        ``eval_dataset`` is evaluated by ``eval_strategy`` / ``eval_steps``
        (with ``eval_collator``, by default ``collator``)."""
        cfg = self.config
        self._eval_data = (None if eval_dataset is None
                           else (eval_dataset, eval_collator or collator))
        # preemption: on SIGTERM finish the step in flight, checkpoint and
        # return (trainer.py:464-480)
        self._sigterm = self._preempted = False
        old_sigterm = None
        if cfg.save_on_preemption and threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                self._sigterm = True
                logger.warning("SIGTERM received: checkpointing after the current step")

            old_sigterm = signal.signal(signal.SIGTERM, _on_term)
        profiler = _StepProfiler(cfg, self.device)
        try:
            return self._train_loop(dataset, collator, profiler)
        finally:
            profiler.stop()
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)

    def _train_loop(self, dataset, collator, profiler: "_StepProfiler") -> List[Dict]:
        cfg = self.config
        # the global micro-batch (per device times every device, as JAX's
        # trainer.py:485); the loader gives this data index its rows
        micro = cfg.per_device_train_batch_size * self.world
        accum = cfg.gradient_accumulation_steps
        loader = DataLoader(dataset, collator, batch_size=micro, shuffle=True,
                            drop_last=cfg.dataloader_drop_last, seed=cfg.seed,
                            process_index=self.data_rank, process_count=self.dp)
        steps_per_epoch = loader.steps_per_epoch() // accum
        if steps_per_epoch == 0:
            logger.warning(
                "dataset (%d rows) is smaller than one optimizer step (global batch "
                "%d x accum %d = %d rows): ZERO training steps will run",
                len(dataset), micro, accum, micro * accum,
            )
        global_step = self.step
        # resume: skip the finished epochs and steps (trainer.py:508-525)
        resume_epoch = global_step // max(steps_per_epoch, 1)
        resume_step_in_epoch = global_step % max(steps_per_epoch, 1)
        if global_step:
            loader.replay(resume_epoch, resume_step_in_epoch * accum)
        t_start = time.time()
        for epoch in range(resume_epoch, cfg.num_train_epochs):
            step_in_epoch = resume_step_in_epoch if epoch == resume_epoch else 0
            buffer: List[Dict[str, float]] = []
            times: List[float] = []
            for group in loader.epoch(epoch, start_step=step_in_epoch * accum, stack=accum):
                profiler.before_step(global_step)
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
                        logs["mfu"] = round(samples_per_sec * self.sample_flops
                                            / (self._peak_flops * self.world), 4)
                    buffer, times = [], []
                    self._log(logs)
                if (cfg.eval_strategy == "steps" and cfg.eval_steps
                        and global_step % cfg.eval_steps == 0):
                    self._maybe_evaluate(global_step, epoch)
                if (cfg.save_strategy == "steps" and cfg.save_steps
                        and global_step % cfg.save_steps == 0):
                    self.save_checkpoint(global_step, epoch)
                if cfg.max_steps > 0 and global_step >= cfg.max_steps:
                    self.save_checkpoint(global_step, epoch)
                    ckpt.wait_for_saves()
                    return self._history
                if self._preempted or (not self._dp and self._sigterm):
                    self.save_checkpoint(global_step, epoch)
                    ckpt.wait_for_saves()
                    logger.warning("preempted: checkpoint-%d written, exiting training",
                                   global_step)
                    return self._history
            if cfg.logging_strategy == "epoch" and buffer:
                logs = self._interval_logs(buffer, global_step, epoch,
                                           step_in_epoch, steps_per_epoch)
                logs["global_epoch"] = epoch + 1
                self._log(logs)
            if cfg.eval_strategy == "epoch":
                self._maybe_evaluate(global_step, epoch)
            if cfg.save_strategy == "epoch":
                self.save_checkpoint(global_step, epoch)
        ckpt.wait_for_saves()
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
        """Checkpoint ``output_dir/checkpoint-{global_step}``: the model,
        the trainer state and, with ``save_only_model=False``, the
        optimizer state with the step and update counters
        (``trainer.py:732-769``). An asynchronous save copies the state to
        the host here and writes it on the background writer. With several
        ranks every rank takes part in gathering the optimizer state to rank
        0, which writes the files and rotates; the others return None after
        the files but the background write are on disk. Under tensor
        parallelism the ranks of rank 0's model group, and under fsdp every
        rank, call ``save_params_fn`` too: it gathers the model (a
        collective) and rank 0 writes it (:meth:`gathers_model`)."""
        cfg = self.config
        if cfg.save_strategy == "no":
            return None
        directory = os.path.join(cfg.output_dir, f"checkpoint-{global_step}")
        main = mesh.is_main_process()
        payload = None
        if not cfg.save_only_model:
            # the previous write first, so the host holds one copy at a time
            ckpt.wait_for_saves()
            state = self.gather_optimizer_state()
            if main:
                payload = {"optimizer": state, "step": self.step, "updates": self.updates}
        if main:
            os.makedirs(directory, exist_ok=True)
        if self.save_params_fn is not None and (main or self.gathers_model()):
            self.save_params_fn(directory, self.model)
        if main:
            ckpt.save_trainer_state(directory, {"global_step": global_step, "epoch": epoch},
                                    cfg)
            if payload is not None:
                ckpt.save_opt_state(directory, payload, async_save=cfg.async_checkpointing)
            # the current checkpoint is the newest: rotation never removes
            # it, and every older write has finished (save_opt_state waited)
            ckpt.rotate_checkpoints(cfg.output_dir, cfg.save_total_limit)
            logger.info("saved checkpoint: %s", directory)
        mesh.barrier()
        return directory if main else None

    def gathers_model(self) -> bool:
        """Whether this rank takes part in gathering the model for rank 0's
        files: the ranks of rank 0's model group under tensor parallelism,
        every rank under fsdp."""
        return (self.tp is not None and self.data_rank == 0) or self.fsdp is not None

    def gather_optimizer_state(self) -> Optional[dict]:
        """The optimizer state in the one-process layout on rank 0 (on the
        host), None elsewhere: each data group's shards merged on its first
        rank, then each model group's tensor shards concatenated. A
        collective of every rank."""
        if isinstance(self.optimizer, ShardedOptimizer):
            state = self.optimizer.gather_state_dict()
        else:
            first = mesh.is_main_process() or self.data_rank == 0
            state = ckpt.host_copy(self.optimizer.state_dict()) if first else None
        if self.tp is not None and self.data_rank == 0:
            state = gather_tp_optimizer_state(state, self._tp_dims, self._shapes, self.tp.group)
        return state if mesh.is_main_process() else None

    def resume_from(self, directory: str) -> None:
        """Restore the step and update counters, and the optimizer state
        where the checkpoint holds it (``trainer.py:771-794``). The weights
        are the caller's (build the model from the checkpoint). A model-only
        checkpoint fast-forwards both counters to its ``global_step`` and
        starts the optimizer's moments from zero at that count, as the JAX
        trainer fast-forwards optax's counts."""
        ckpt.wait_for_saves()
        payload = ckpt.load_opt_state(directory)
        if payload is not None:
            full = payload["optimizer"]
            if self.tp is not None:  # this rank's tensor shards
                full = shard_tp_optimizer_state(full, self._tp_dims, self._shapes,
                                                self.tp.size, self.tp.index)
            # a sharded optimizer takes its own tensors' entries
            self.optimizer.load_state_dict(full)
            self.step, self.updates = int(payload["step"]), int(payload["updates"])
            return
        step = int(ckpt.load_trainer_state(directory).get("global_step", 0))
        local = (self.optimizer.optimizer if isinstance(self.optimizer, ShardedOptimizer)
                 else self.optimizer)
        if local is not None:
            fast_forward(local, step)
        self.step = self.updates = step


class _StepProfiler:
    """``profile_steps``: ``torch.profiler`` over exactly ``profile_steps``
    steps from ``profile_start_step`` (CPU activity, and CUDA activity on
    the card), written as a Chrome trace under ``output_dir/profile/``
    (``trainer.py:541-558``)."""

    def __init__(self, config: TrainConfig, device: torch.device):
        self.config = config
        self.device = device
        self._prof = None

    def before_step(self, global_step: int) -> None:
        cfg = self.config
        if not cfg.profile_steps or not mesh.is_main_process():  # rank 0 traces
            return
        if self._prof is not None and global_step == cfg.profile_start_step + cfg.profile_steps:
            self.stop()
        if self._prof is None and global_step == cfg.profile_start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        directory = os.path.join(self.config.output_dir, "profile")
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
