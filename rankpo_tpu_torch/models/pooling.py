"""Sentence pooling + L2 normalisation (port of ``rankpo_tpu.models.pooling``).

- "last_token" (Llama family): the position before the first pad, found with
  the ``attention_mask.argmin(-1) - 1`` trick and a ``% seq_len`` guard that
  maps a full-length row (argmin == 0) to the final position
  (reference src/modeling.py:226-227). Assumes right padding.
- "cls": first token. "mean": mask-weighted mean with fp32 accumulation.

Normalisation is L2 over the last dim in fp32, with the norm clamped at
``eps`` so an all-zero row stays zero instead of becoming NaN.
"""

from __future__ import annotations

import torch


def last_token_pool(last_hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S, H], [B, S] -> [B, H] at the last non-pad position per row."""
    seq_len = attention_mask.shape[-1]
    # torch.argmin returns the first minimal index (the first pad); `%` is
    # Python's remainder, so -1 wraps to seq_len - 1 for an all-ones row
    lengths = (torch.argmin(attention_mask.to(torch.int32), dim=-1) - 1) % seq_len
    rows = torch.arange(last_hidden.shape[0], device=last_hidden.device)
    return last_hidden[rows, lengths]


def cls_pool(last_hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    del attention_mask
    return last_hidden[:, 0]


def mean_pool(last_hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    m = attention_mask[..., None].to(torch.float32)
    summed = (last_hidden.to(torch.float32) * m).sum(dim=1)
    counts = m.sum(dim=1).clamp_min(1.0)
    return (summed / counts).to(last_hidden.dtype)


_POOLERS = {
    "last_token": last_token_pool,
    "cls": cls_pool,
    "mean": mean_pool,
}


def pool(last_hidden: torch.Tensor, attention_mask: torch.Tensor, mode: str) -> torch.Tensor:
    if mode not in _POOLERS:
        raise ValueError(f"Unknown pooling mode: {mode!r}; one of {list(_POOLERS)}")
    return _POOLERS[mode](last_hidden, attention_mask)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along the last axis in fp32 (F.normalize defaults)."""
    xf = x.to(torch.float32)
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True).clamp_min(eps)
    return (xf / norm).to(x.dtype)
