"""Loss functions of the two training stages (port of
``rankpo_tpu.train.steps``).

Each factory returns ``loss_fn(model, batch) -> (loss, metrics)`` for the
single-card ``Trainer``; ``batch`` holds 'query' and 'passage' blocks of
device tensors ({'input_ids', 'attention_mask'}). The model carries the
compute dtype and gradient checkpointing (``LlamaEncoder.for_training``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from rankpo_tpu_torch.losses.contrastive import (
    info_nce_block_loss,
    info_nce_loss,
    validate_temperature,
)
from rankpo_tpu_torch.losses.rankpo import rankpo_batch_loss
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed


def make_contrastive_loss_fn(
    model_config: EncoderConfig,
    *,
    temperature: float = 0.02,
    use_inbatch_neg: bool = True,
    negatives_cross_device: bool = True,
    normalize_embeddings: bool = True,
    num_data_shards: int = 1,
    attn_impl: str = "auto",
) -> Callable:
    """Contrastive stage (reference src/modeling.py:254-314). On one card the
    batch is global, so ``negatives_cross_device`` is the global in-batch
    loss; with ``num_data_shards`` > 1 and neither cross-device negatives
    the per-block loss runs, as in the JAX package. The temperature guards
    (modeling.py:186-191) are applied at build time."""
    del model_config  # the model carries its config
    temperature = validate_temperature(normalize_embeddings, temperature)

    def loss_fn(model, batch):
        q_reps = embed(model, batch["query"], normalize=normalize_embeddings,
                       attn_impl=attn_impl)
        p_reps = embed(model, batch["passage"], normalize=normalize_embeddings,
                       attn_impl=attn_impl)
        b = q_reps.shape[0]
        group_size = p_reps.shape[0] // b
        row_valid = batch.get("row_valid")
        device = q_reps.device
        if use_inbatch_neg and not negatives_cross_device and num_data_shards > 1:
            loss, scores = info_nce_block_loss(
                q_reps, p_reps, num_blocks=num_data_shards,
                temperature=temperature, row_valid=row_valid,
            )
            bw = b // num_data_shards
            targets = (torch.arange(b, device=device) % bw) * group_size
        else:
            loss, scores = info_nce_loss(
                q_reps, p_reps, temperature=temperature,
                use_inbatch_neg=use_inbatch_neg, row_valid=row_valid,
            )
            targets = (torch.arange(b, device=device) * group_size
                       if use_inbatch_neg else torch.zeros(b, dtype=torch.long, device=device))
        hits = (scores.argmax(dim=-1) == targets).float()
        if row_valid is None:
            accuracy = hits.mean()
        else:
            w = row_valid.float()
            accuracy = (hits * w).sum() / w.sum().clamp_min(1.0)
        return loss, {"accuracy": accuracy.detach()}

    return loss_fn


def make_rankpo_loss_fn(
    model_config: EncoderConfig,
    *,
    beta: float = 1.0,
    gamma_beta_ratio: float = 0.0,
    temperature: float = 0.02,
    loss_type: str = "sigmoid",
    label_smoothing: float = 0.0,
    rankpo_weight: float = 1.0,
    sft_weight: float = 0.0,
    reference_free: bool = True,
    ref_model: Optional[torch.nn.Module] = None,
    disable_dropout: bool = True,
    attn_impl: str = "auto",
) -> Callable:
    """RankPO stage (src/rankpo_trainer.py:447-568).

    Faithful quirk: the reference RankPO forward ALWAYS L2-normalises
    (rankpo_trainer.py:417 ignores normalize_embeddings), so scores are
    cosines; so does this. With ``reference_free=False`` the frozen
    ``ref_model`` scores the same batch under ``torch.no_grad``. The llama
    body has no dropout, so ``disable_dropout`` changes nothing here."""
    del model_config, disable_dropout
    if loss_type == "hinge" and label_smoothing > 0:
        # reference behaviour (rankpo_trainer.py:215-218): warn and ignore
        warnings.warn(
            "loss_type='hinge' does not support label smoothing; ignoring "
            "label_smoothing"
        )

    def _scores(model, batch):
        q_reps = embed(model, batch["query"], normalize=True, attn_impl=attn_impl)
        p_reps = embed(model, batch["passage"], normalize=True, attn_impl=attn_impl)
        grouped = p_reps.reshape(q_reps.shape[0], 2, -1)  # [chosen, rejected]
        return torch.einsum("bh,bgh->bg", q_reps.float(), grouped.float())

    def loss_fn(model, batch):
        scores = _scores(model, batch)
        ref_scores = None
        if not reference_free and ref_model is not None:
            with torch.no_grad():
                ref_scores = _scores(ref_model, batch)
        loss, metrics = rankpo_batch_loss(
            scores, ref_scores, beta=beta, gamma_beta_ratio=gamma_beta_ratio,
            temperature=temperature, loss_type=loss_type,
            label_smoothing=label_smoothing, rankpo_weight=rankpo_weight,
            sft_weight=sft_weight, row_valid=batch.get("row_valid"),
        )
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn
