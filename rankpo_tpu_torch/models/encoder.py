"""Text encoder: backbone forward -> pooling -> optional L2 normalisation
(port of ``rankpo_tpu.models.encoder``). Serving and training both call
:func:`embed`, so the embedding semantics live in one place."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rankpo_tpu_torch.models.llama import LlamaEncoder
from rankpo_tpu_torch.models.pooling import l2_normalize, pool


def forward_hidden(
    model: LlamaEncoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Last hidden state [B, S, H] in the model's (compute) dtype."""
    return model(input_ids, attention_mask, attn_impl=attn_impl)


def embed(
    model: LlamaEncoder,
    batch: Dict[str, torch.Tensor],
    *,
    normalize: Optional[bool] = None,
    attn_impl: str = "auto",
    output_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sentence embeddings [B, H] for {'input_ids', 'attention_mask'} inputs.

    Pooling comes from ``model.config`` (reference src/modeling.py:224-232);
    ``normalize`` defaults to ``config.normalize``. The compute dtype, and
    whether layers are recomputed in the backward pass, are the model's
    (``LlamaEncoder.from_state_dict`` / ``LlamaEncoder.for_training``)."""
    config = model.config
    if normalize is None:
        normalize = config.normalize
    hidden = forward_hidden(
        model, batch["input_ids"], batch["attention_mask"], attn_impl=attn_impl
    )
    reps = pool(hidden, batch["attention_mask"], config.pooling).to(output_dtype)
    if normalize:
        reps = l2_normalize(reps)
    return reps
