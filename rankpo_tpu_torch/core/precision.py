"""Mixed-precision policy (port of ``rankpo_tpu.core.precision``).

Parameters are kept in ``param_dtype`` (fp32 by default, so the optimizer
sees full precision), the forward runs in ``compute_dtype`` (bf16 on the
tensor cores: the model casts each weight inside its forward), and
numerically sensitive reductions (RMSNorm statistics, softmax, losses)
accumulate in fp32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
FP32_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.float32)


def policy_from_flags(bf16: bool = True, pure_bf16: bool = False) -> Policy:
    if pure_bf16:
        return BF16_POLICY
    if bf16:
        return DEFAULT_POLICY
    return FP32_POLICY
