"""Loss functions of the two training stages (port of
``rankpo_tpu.train.steps``).

Each factory returns ``loss_fn(model, batch) -> (loss, metrics)`` for the
single-card ``Trainer``; ``batch`` holds 'query' and 'passage' blocks of
device tensors ({'input_ids', 'attention_mask'}, or a packed block from
``data/packing.py``'s collators: {'input_ids', 'segment_ids',
'slot_index', 'slots'}). The model carries the
compute dtype and gradient checkpointing (``models/base.py``
``for_training``). A loss function that uses dropout also takes a
``generator`` (``loss_fn(model, batch, generator)``, the trainer's
``dropout_seed``); :func:`uses_dropout` says when it does.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.losses.contrastive import (
    info_nce_block_loss,
    info_nce_loss,
    validate_temperature,
)
from rankpo_tpu_torch.losses.rankpo import rankpo_batch_loss
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed, embed_packed
from rankpo_tpu_torch.models.packing import scatter_packed_reps


def _embed_field(model, block, **kwargs) -> torch.Tensor:
    """Embed one batch field (the query or the passage block), packed or
    plain (JAX ``steps.py:27-44``). A packed block runs the block-diagonal
    forward and scatters each segment's embedding back to its batch
    position: the plain path's values on the same texts, without the pad
    tokens' work."""
    if "segment_ids" in block:
        reps, _valid = embed_packed(model, block, block["slot_index"].shape[1], **kwargs)
        return scatter_packed_reps(reps, block["slot_index"], block["slots"].shape[0])
    return embed(model, block, **kwargs)


def uses_dropout(model_config: EncoderConfig) -> bool:
    """Whether the body draws dropout masks at the config's rates (the
    Roberta family; the llama body has none)."""
    return not model_config.is_llama and (
        model_config.hidden_dropout > 0 or model_config.attention_dropout > 0)


def make_contrastive_loss_fn(
    model_config: EncoderConfig,
    *,
    temperature: float = 0.02,
    use_inbatch_neg: bool = True,
    negatives_cross_device: bool = True,
    normalize_embeddings: bool = True,
    num_data_shards: int = 1,
    attn_impl: str = "auto",
    axis_name: Optional[str] = None,
) -> Callable:
    """Contrastive stage (reference src/modeling.py:254-314). In one process
    the batch is global, so ``negatives_cross_device`` is the global
    in-batch loss; with ``num_data_shards`` > 1 and neither cross-device
    negatives the per-block loss runs, as in the JAX package. With a
    process group (``axis_name="data"``, the CLIs pass it when the run has
    one) each rank holds its rows: ``negatives_cross_device`` pools the
    passages of every rank (``losses/contrastive.py``), and without it each
    rank keeps its own in-batch negatives and makes no collective (the
    per-block loss). The temperature guards (modeling.py:186-191) are
    applied at build time. With a ``generator`` dropout is live, as the JAX
    stage 1 passes an rng on every step (``steps.py:70-86``)."""
    del model_config  # the model carries its config
    temperature = validate_temperature(normalize_embeddings, temperature)

    blocks = num_data_shards if use_inbatch_neg and not negatives_cross_device else 1
    if axis_name is not None:
        blocks = 1  # each rank is one block
    axis = axis_name if negatives_cross_device else None

    def loss_fn(model, batch, generator=None):
        q_reps, p_reps = embed_pair(model, batch, generator, normalize=normalize_embeddings,
                                    attn_impl=attn_impl)
        loss, accuracy = contrastive_terms(
            q_reps, p_reps, temperature=temperature, use_inbatch_neg=use_inbatch_neg,
            num_blocks=blocks, row_valid=batch.get("row_valid"), axis_name=axis)
        return loss, {"accuracy": accuracy.detach()}

    return loss_fn


def embed_pair(model, batch, generator=None, **kwargs):
    """(query reps, passage reps) of a batch, both fields drawing their
    dropout from ``generator`` in that order."""
    q_reps = _embed_field(model, batch["query"], generator=generator, **kwargs)
    p_reps = _embed_field(model, batch["passage"], generator=generator, **kwargs)
    return q_reps, p_reps


def contrastive_terms(q_reps, p_reps, *, temperature: float, use_inbatch_neg: bool = True,
                      num_blocks: int = 1, row_valid=None, axis_name=None):
    """(InfoNCE loss, accuracy) of query reps [B, H] against passage reps
    [B * G, H]: over the whole batch, or per block of rows when
    ``num_blocks`` > 1 (in-batch negatives within a data shard), or against
    the passages of every rank with ``axis_name`` (cross-device negatives).
    Accuracy is the share of this rank's rows whose top score is their
    positive."""
    b = q_reps.shape[0]
    group_size = p_reps.shape[0] // b
    device = q_reps.device
    if use_inbatch_neg and num_blocks > 1:
        loss, scores = info_nce_block_loss(
            q_reps, p_reps, num_blocks=num_blocks, temperature=temperature,
            row_valid=row_valid,
        )
        targets = (torch.arange(b, device=device) % (b // num_blocks)) * group_size
    else:
        loss, scores = info_nce_loss(
            q_reps, p_reps, temperature=temperature, use_inbatch_neg=use_inbatch_neg,
            row_valid=row_valid, axis_name=axis_name,
        )
        if not use_inbatch_neg:
            targets = torch.zeros(b, dtype=torch.long, device=device)
        else:
            rank = 0 if axis_name is None else mesh.data_index()
            targets = (torch.arange(b, device=device) + rank * b) * group_size
    hits = (scores.argmax(dim=-1) == targets).float()
    if row_valid is None:
        return loss, hits.mean()
    w = row_valid.float()
    return loss, (hits * w).sum() / w.sum().clamp_min(1.0)


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
    ``ref_model`` scores the same batch under ``torch.no_grad``, without
    dropout. With ``disable_dropout`` (the reference's default) a
    ``generator`` is ignored; otherwise it makes the policy's dropout live
    (JAX ``steps.py:164-196``)."""
    del model_config
    if loss_type == "hinge" and label_smoothing > 0:
        # reference behaviour (rankpo_trainer.py:215-218): warn and ignore
        warnings.warn(
            "loss_type='hinge' does not support label smoothing; ignoring "
            "label_smoothing"
        )

    def _scores(model, batch, generator=None):
        q_reps = _embed_field(model, batch["query"], normalize=True, attn_impl=attn_impl,
                              generator=generator)
        p_reps = _embed_field(model, batch["passage"], normalize=True, attn_impl=attn_impl,
                              generator=generator)
        grouped = p_reps.reshape(q_reps.shape[0], 2, -1)  # [chosen, rejected]
        return torch.einsum("bh,bgh->bg", q_reps.float(), grouped.float())

    def loss_fn(model, batch, generator=None):
        scores = _scores(model, batch, None if disable_dropout else generator)
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
