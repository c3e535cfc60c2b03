"""Learning-rate schedules and the optimizer (port of
``rankpo_tpu.train.state``).

:func:`make_schedule` returns ``schedule(count) -> float`` with optax's
formulas (``polynomial_schedule``, ``cosine_decay_schedule``,
``join_schedules``), value for value, for the eight ``lr_scheduler_type``s.

:func:`make_optimizer` gives ``torch.optim.AdamW`` (optax ``adamw``'s update:
bias-corrected moments, ``eps`` outside the square root, decoupled weight
decay on the pre-update parameters) and :func:`clip_grad_norm` applies
optax's ``clip_by_global_norm`` rule, which scales by ``max_norm / ||g||``
only when ``||g|| >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds
1e-6 to the norm and scales whenever the norm exceeds the limit). The
schedule is indexed by the optimizer's own update count, so a skipped
non-finite step does not advance it, as in optax.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch

from rankpo_tpu_torch.train.config import TrainConfig

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda count: value


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return _constant(init)

    def schedule(count):
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    return _polynomial(init, end, 1.0, steps)


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(config: TrainConfig, total_steps: int) -> Schedule:
    """Warmup + {cosine, linear, constant, constant_with_warmup, polynomial,
    cosine_with_restarts, cosine_with_min_lr, inverse_sqrt}, with HF's
    semantics: plain "constant" has no warmup; "polynomial" decays peak ->
    lr_end with exponent lr_power."""
    warmup = config.warmup_steps or int(total_steps * config.warmup_ratio)
    peak = config.learning_rate
    kind = config.lr_scheduler_type
    if kind == "constant":
        return _constant(peak)
    if kind == "constant_with_warmup":
        if warmup == 0:
            return _constant(peak)
        return _join([_linear(0.0, peak, warmup), _constant(peak)], [warmup])
    if kind == "inverse_sqrt":
        timescale = max(warmup, 1)

        def inv_sqrt(count):
            if count < timescale:
                return peak * count / timescale
            return peak / math.sqrt(max(count, timescale) / timescale)

        return inv_sqrt
    decay_steps = max(total_steps - warmup, 1)
    if kind == "linear":
        decay = _linear(peak, 0.0, decay_steps)
    elif kind == "cosine":
        decay = _cosine(peak, decay_steps)
    elif kind == "cosine_with_restarts":
        cycles = max(int(config.lr_num_cycles), 1)
        cycle_len = max(decay_steps // cycles, 1)
        decay = _join(
            [_cosine(peak, cycle_len) for _ in range(cycles)],
            [cycle_len * (i + 1) for i in range(cycles - 1)],
        )
    elif kind == "cosine_with_min_lr":
        decay = _cosine(peak, decay_steps, alpha=config.lr_end / peak if peak else 0.0)
    elif kind == "polynomial":
        decay = _polynomial(peak, config.lr_end, config.lr_power, decay_steps)
    else:
        raise ValueError(f"unknown lr_scheduler_type {kind!r}")
    if warmup == 0:
        return decay
    return _join([_linear(0.0, peak, warmup), decay], [warmup])


def make_optimizer(
    params: Iterable[torch.nn.Parameter], config: TrainConfig, total_steps: int
) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW over ``params`` and the LR schedule. The optimizer's lr is set
    from the schedule before every update (``Trainer``)."""
    if config.optim != "adamw":
        raise NotImplementedError(
            f"optim {config.optim!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 2: adamw8bit / adafactor)"
        )
    params = list(params)
    on_cuda = all(p.device.type == "cuda" for p in params)
    optimizer = torch.optim.AdamW(
        params,
        lr=config.learning_rate,
        betas=(config.adam_beta1, config.adam_beta2),
        eps=config.adam_epsilon,
        weight_decay=config.weight_decay,
        # one multi-tensor kernel per group on the card; per-tensor ops on CPU
        fused=on_cuda,
        foreach=False if on_cuda else None,
    )
    return optimizer, make_schedule(config, total_steps)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm), fp32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grad_norm(grads: List[torch.Tensor], max_norm: float,
                   norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g <- (g / norm) * max_norm when
    norm >= max_norm, unchanged otherwise."""
    value = float(norm)
    if value >= max_norm:
        torch._foreach_div_(grads, value)
        torch._foreach_mul_(grads, max_norm)
