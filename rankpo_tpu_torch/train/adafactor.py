"""Adafactor with optax's update rule (the JAX package's ``--optim
adafactor``, ``rankpo_tpu/train/state.py:135-144``).

The JAX package builds ``optax.adafactor(learning_rate=schedule,
momentum=adam_beta1, dtype_momentum=bfloat16, weight_decay_rate=weight_decay
or None, multiply_by_parameter_scale=False, clipping_threshold=None)``, with
optax's defaults otherwise (decay_rate 0.8, decay_offset 0,
min_dim_size_to_factor 128, eps 1e-30, factored). That chain, per
parameter, in optax's order:

1. ``scale_by_factored_rms``: with decay d_t = 1 - (t + 1)^-0.8 (t the
   count before this step, in fp32) and g2 = g * g + eps, a parameter
   whose second-largest dimension has at least 128 entries keeps a row and
   a column mean of g2 (``v_row`` over its largest dimension, ``v_col``
   over its second-largest) and scales g by (v_row / mean(v_row))^-1/2 and
   v_col^-1/2; any other parameter keeps v = d_t v + (1 - d_t) g2 and takes
   g v^-1/2;
2. the learning rate (a product, the schedule at the count);
3. ``ema(beta1, debias=False)`` kept in bf16: m = (1 - b1) u + b1 m_bf16,
   where b1 m_bf16 is a bf16 product (b1 itself rounded to bf16, as JAX
   rounds a Python scalar to the array's dtype); the update is m in fp32,
   the state its bf16 rounding;
4. with weight decay, u + wd p;
5. the sign: p - u.

``torch.optim.Adafactor`` follows another rule (relative step sizes, no
momentum, its own decay), so it is not used.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.train.optim8bit import TypedStateOptimizer


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax ``_factored_dims``: (second-largest, largest) dimension, or None
    when the parameter is not factored."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(TypedStateOptimizer):
    """optax's Adafactor with the JAX package's arguments (module docstring).
    State per parameter: {"step": int, "v_row", "v_col" (factored) or "v",
    "momentum" (bf16)}."""

    STATE_DTYPES = {"momentum": torch.bfloat16}

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: Optional[float] = None, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, eps: float = 1e-30):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      decay_rate=decay_rate,
                                      min_dim_size_to_factor=min_dim_size_to_factor, eps=eps))

    def init_state(self, p: torch.Tensor) -> dict:
        dims = factored_dims(tuple(p.shape), self.defaults["min_dim_size_to_factor"])
        state = {"step": 0, "momentum": torch.zeros_like(p, dtype=torch.bfloat16)}
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros(tuple(np.delete(p.shape, d0)), dtype=p.dtype,
                                         device=p.device)
            state["v_col"] = torch.zeros(tuple(np.delete(p.shape, d1)), dtype=p.dtype,
                                         device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor takes no closure")
        for group in self.param_groups:
            b1, wd, lr, eps = group["momentum"], group["weight_decay"], group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self._state(p)
                # optax _decay_rate_pow in fp32, at the count before this step
                t = np.float32(state["step"] + 1)
                decay = np.float32(1.0) - t ** np.float32(-group["decay_rate"])
                keep = float(decay)
                fresh = float(np.float32(1.0) - decay)
                state["step"] += 1
                grad_sqr = g * g + eps
                dims = factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
                if dims is not None:
                    d1, d0 = dims
                    v_row = keep * state["v_row"] + fresh * grad_sqr.mean(dim=d0)
                    v_col = keep * state["v_col"] + fresh * grad_sqr.mean(dim=d1)
                    state["v_row"], state["v_col"] = v_row, v_col
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                    row_factor = (v_row / row_col_mean) ** -0.5
                    col_factor = v_col ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    v = keep * state["v"] + fresh * grad_sqr
                    state["v"] = v
                    u = g * v ** -0.5
                u = torch.full((), lr, dtype=u.dtype, device=u.device) * u
                # ema(b1, debias=False) with a bf16 accumulator: optax's
                # b1 * m is a bf16 product with b1 rounded to bf16 (a Python
                # scalar takes the array's dtype in JAX)
                b1_bf16 = torch.full((), b1, dtype=torch.bfloat16, device=u.device)
                m = (1.0 - b1) * u + (b1_bf16 * state["momentum"]).to(u.dtype)
                state["momentum"] = m.to(torch.bfloat16)
                if wd is not None:
                    m = m + wd * p
                p.sub_(m)
        return None
