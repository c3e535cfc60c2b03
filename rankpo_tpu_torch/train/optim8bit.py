"""Blockwise 8-bit AdamW (port of ``rankpo_tpu.train.optim8bit``; Dettmers
et al., "8-bit Optimizers via Block-wise Quantization", arXiv:2110.02861).

Each moment of a parameter is stored flattened, zero-padded to a multiple
of ``block`` (256) and cut into [n_blocks, block] codes with one fp32 scale
per block (the block's largest magnitude). The codes are log-domain: the
magnitude code is a rounded log2 of |x| / scale over a fixed range, 20
octaves for the first moment (int8, the sign in the code) and 40 for the
second (uint8). Code 0 is zero.

A step, per parameter, as the JAX ``adamw8bit`` chain takes it
(``optim8bit.py:178-191``): dequantize both moments, Adam in fp32
(bias-corrected, ``eps`` outside the square root), requantize, then the
decoupled weight decay on the pre-update parameter, then the learning rate.
Every operation is the JAX package's, in its order, on fp32 tensors, but
for ``exp2`` and ``log2``: the dequantization factors come from a table
of 2^level rounded once, the codes from fp32 thresholds on the ratio
(:func:`_code_tables`), and the square root is taken in fp64, so a step
gives the same bits on the card and on the CPU. XLA's CPU ``exp2`` and ``log2`` round differently, so the codes
and scales equal the JAX state's in nearly every entry
(``tests/test_torch_optim.py`` states the share).

The state of a parameter is {"step": int, "mu_q" int8 [n_blocks, block],
"mu_scale" fp32 [n_blocks], "nu_q" uint8 [n_blocks, block], "nu_scale"
fp32 [n_blocks]}, so ``state_dict()`` carries the codes and scales
(:class:`TypedStateOptimizer` keeps their dtypes through
``load_state_dict``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rankpo_tpu_torch.ops.topk import divide_exact

# log-domain code ranges: octaves below the block max that remain
# representable; values further below round to the range floor
_MU_OCTAVES = 20.0
_NU_OCTAVES = 40.0


def blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """Flatten and zero-pad to [n_blocks, block] fp32."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def unblocked(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.reshape(-1)[: like.numel()].reshape(like.shape).to(like.dtype)


def _code_tables(octaves: float, top: int):
    """For codes 0..top: the dequantization factors 2^((c - top) * R / (top -
    1)) (float64 rounded once to fp32), and the fp32 thresholds t_c (c =
    2..top) above which a ratio |x| / scale rounds to code c or higher:
    round(log2(ratio) * (top - 1) / R) >= c - top exactly where ratio >=
    2^((c - top - 0.5) * R / (top - 1)). Both make the codes and the
    dequantized moments the same bits on every device (a device's own
    ``exp2`` and ``log2`` round differently)."""
    step = octaves / (top - 1)
    c = np.arange(top + 1, dtype=np.float64)
    factors = np.exp2((c - top) * step).astype(np.float32)
    thresholds = np.exp2((c[2:] - top - 0.5) * step).astype(np.float32)
    return torch.from_numpy(factors), torch.from_numpy(thresholds)


_MU_TABLES = _code_tables(_MU_OCTAVES, 127)
_NU_TABLES = _code_tables(_NU_OCTAVES, 255)


def _on(table: torch.Tensor, device: torch.device) -> torch.Tensor:
    return table if table.device == device else table.to(device)


def quant_signed(x: torch.Tensor):
    """[n_blocks, block] fp32 -> (int8 log-domain codes, fp32 block maxes).
    |code| c in [1, 127]: |x| = scale * 2^(-(127 - c) * 20 / 126), c the
    rounded level (JAX ``_quant_signed``: 127 + round(log2(|x| / scale) *
    126 / 20), at least 1)."""
    scale = torch.clamp_min(x.abs().amax(dim=1), 1e-30)
    ratio = x.abs() / scale[:, None]
    c = 1 + torch.bucketize(ratio, _on(_MU_TABLES[1], x.device), out_int32=True, right=True)
    q = torch.where(x == 0.0, 0, torch.where(x < 0, -c, c)).to(torch.int8)
    return q, scale


def dequant_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    c = q.to(torch.int32)
    mag = scale[:, None] * _on(_MU_TABLES[0], q.device)[c.abs()]
    return torch.where(q == 0, 0.0, torch.where(q < 0, -mag, mag))


def quant_nonneg(x: torch.Tensor):
    """Non-negative [n_blocks, block] fp32 -> (uint8 log codes, block maxes).
    c in [1, 255]: x = scale * 2^(-(255 - c) * 40 / 254)."""
    scale = torch.clamp_min(x.amax(dim=1), 1e-30)
    ratio = x / scale[:, None]
    c = 1 + torch.bucketize(ratio, _on(_NU_TABLES[1], x.device), out_int32=True, right=True)
    q = torch.where(x == 0.0, 0, c).to(torch.uint8)
    return q, scale


def dequant_nonneg(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    val = scale[:, None] * _on(_NU_TABLES[0], q.device)[q.to(torch.int32)]
    return torch.where(q == 0, 0.0, val)


class TypedStateOptimizer(torch.optim.Optimizer):
    """An optimizer whose state tensors keep their own dtypes through
    ``load_state_dict`` (PyTorch casts every state tensor of a floating
    parameter to the parameter's dtype; the casts of int8, uint8 and bf16
    state to fp32 and back are exact). ``STATE_DTYPES`` maps a state key to
    its dtype. The step count is a Python int in each parameter's state."""

    STATE_DTYPES: Dict[str, torch.dtype] = {}

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key, dtype in self.STATE_DTYPES.items():
                if key in state:
                    state[key] = state[key].to(dtype)

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state.update(self.init_state(p))
        return state

    def fast_forward(self, count: int) -> None:
        """Fresh state at step ``count`` for every parameter: a model-only
        resume, as the JAX trainer sets optax's counts (``trainer.py:786-791``)."""
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self.init_state(p)
                self.state[p]["step"] = int(count)

    def init_state(self, p: torch.Tensor) -> dict:
        raise NotImplementedError


class AdamW8bit(TypedStateOptimizer):
    """AdamW with blockwise log-domain 8-bit moments (module docstring)."""

    STATE_DTYPES = {"mu_q": torch.int8, "nu_q": torch.uint8}

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, block: int = 256):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, block=block))

    def init_state(self, p: torch.Tensor) -> dict:
        block = self.defaults["block"]
        nb = -(-p.numel() // block)
        zeros = dict(device=p.device)
        return {"step": 0,
                "mu_q": torch.zeros((nb, block), dtype=torch.int8, **zeros),
                "mu_scale": torch.zeros((nb,), dtype=torch.float32, **zeros),
                "nu_q": torch.zeros((nb, block), dtype=torch.uint8, **zeros),
                "nu_scale": torch.zeros((nb,), dtype=torch.float32, **zeros)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            block, eps, wd, lr = group["block"], group["eps"], group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p)
                state["step"] += 1
                # 1 - b^count in fp32 on the host, as JAX's count.astype(float32)
                count = np.float32(state["step"])
                c1 = float(np.float32(1.0) - np.float32(b1) ** count)
                c2 = float(np.float32(1.0) - np.float32(b2) ** count)
                gb = blocked(p.grad, block)
                mu = dequant_signed(state["mu_q"], state["mu_scale"])
                nu = dequant_nonneg(state["nu_q"], state["nu_scale"])
                mu = b1 * mu + (1.0 - b1) * gb
                nu = b2 * nu + (1.0 - b2) * gb * gb
                # true divisions on every device (a host-scalar divisor is a
                # reciprocal product on the card), and the square root
                # correctly rounded: taken in fp64 (the card's fp32 sqrt is
                # off by an ulp in some entries)
                root = torch.sqrt(divide_exact(nu, c2).double()).to(torch.float32)
                upd = divide_exact(mu, c1) / (root + eps)
                state["mu_q"], state["mu_scale"] = quant_signed(mu)
                state["nu_q"], state["nu_scale"] = quant_nonneg(nu)
                upd = unblocked(upd, p)
                if wd:
                    upd = upd + wd * p
                # optax scale_by_learning_rate: the update times -lr, then added
                p.add_(upd * -lr)
        return None
