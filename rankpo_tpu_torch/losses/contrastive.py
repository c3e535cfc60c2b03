"""InfoNCE contrastive loss with in-batch negatives (port of
``rankpo_tpu.losses.contrastive``; reference src/modeling.py:281-314).

- In-batch negatives on (``use_inbatch_neg``): scores = (q @ p^T) / T of
  shape [B, B*G] with G = 1 positive + n negatives per query; row i's target
  is column i*G; every other passage of the batch is a negative.
- In-batch negatives off: per-query scores [B, G] with target 0.
- Cross-device negatives (``axis_name``) all-gather the passages of every
  device first. This port trains on one card, where the global batch IS the
  local batch: ``negatives_cross_device=True`` is the plain global in-batch
  loss, and passing ``axis_name`` raises (ROADMAP.md Queue 1 item 2:
  cross-device negatives over ``torch.distributed``).

Loss = mean cross-entropy, computed in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def similarity_scores(q_reps: torch.Tensor, p_reps: torch.Tensor) -> torch.Tensor:
    """Inner-product similarity in fp32 (cosine for L2-normalised reps);
    reference src/modeling.py:240-252."""
    return torch.einsum("bh,ph->bp", q_reps.float(), p_reps.float())


def _cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE over rows, fp32 log-softmax. ``row_valid`` [B] (0/1) restricts
    the mean to real rows."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[:, None])[:, 0]
    per_row = logz - picked
    if row_valid is None:
        return per_row.mean()
    w = row_valid.float()
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


def info_nce_loss(
    q_reps: torch.Tensor,
    p_reps: torch.Tensor,
    *,
    temperature: float = 0.02,
    use_inbatch_neg: bool = True,
    axis_name: Optional[str] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean loss, scores). q_reps [B, H]; p_reps [B*G, H].

    ``row_valid`` [B] (0/1): rows marked 0 are excluded from the loss mean
    and their passages are masked out of the in-batch negative pool (scores
    -inf), each row keeping its own target column."""
    if axis_name is not None:
        raise NotImplementedError(
            "cross-device negatives (axis_name) are not ported: one card holds "
            "the whole batch (ROADMAP.md Queue 1 item 2, torch.distributed)"
        )
    b = q_reps.shape[0]
    group_size = p_reps.shape[0] // b
    device = q_reps.device
    if use_inbatch_neg:
        targets = torch.arange(b, device=device) * group_size
        scores = similarity_scores(q_reps, p_reps) / temperature  # [B, B*G]
        if row_valid is not None:
            col_valid = torch.repeat_interleave(row_valid.float(), group_size)
            col = torch.arange(scores.shape[1], device=device)
            keep = (col_valid[None, :] > 0) | (col[None, :] == targets[:, None])
            scores = scores.masked_fill(~keep, float("-inf"))
    else:
        grouped = p_reps.reshape(b, group_size, -1)
        scores = torch.einsum("bh,bgh->bg", q_reps.float(), grouped.float()) / temperature
        targets = torch.zeros(b, dtype=torch.long, device=device)
    return _cross_entropy(scores, targets, row_valid), scores


def info_nce_block_loss(
    q_reps: torch.Tensor,
    p_reps: torch.Tensor,
    *,
    num_blocks: int,
    temperature: float = 0.02,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch InfoNCE restricted to ``num_blocks`` contiguous blocks of the
    batch (the ``negatives_cross_device=False`` semantics across data
    shards): q [B, H] as [W, B/W, H], p [B*G, H] as [W, B*G/W, H],
    block-diagonal scores. Returns (mean loss, scores [B, B*G/W])."""
    b = q_reps.shape[0]
    group_size = p_reps.shape[0] // b
    bw = b // num_blocks
    device = q_reps.device
    qb = q_reps.reshape(num_blocks, bw, -1).float()
    pb = p_reps.reshape(num_blocks, bw * group_size, -1).float()
    scores = torch.einsum("wbh,wph->wbp", qb, pb) / temperature
    targets = torch.arange(bw, device=device) * group_size
    if row_valid is not None:
        col_valid = torch.repeat_interleave(
            row_valid.float().reshape(num_blocks, bw), group_size, dim=1
        )
        col = torch.arange(bw * group_size, device=device)
        keep = (col_valid[:, None, :] > 0) | (col[None, None, :] == targets[None, :, None])
        scores = scores.masked_fill(~keep, float("-inf"))
    logz = torch.logsumexp(scores, dim=-1)  # [W, B/W]
    picked = torch.gather(
        scores, -1, targets[None, :, None].expand(num_blocks, bw, 1)
    )[..., 0]
    per_row = logz - picked
    if row_valid is None:
        loss = per_row.mean()
    else:
        w = row_valid.float().reshape(num_blocks, bw)
        loss = (per_row * w).sum() / w.sum().clamp_min(1.0)
    return loss, scores.reshape(b, -1)


def validate_temperature(normalize_embeddings: bool, temperature: float) -> float:
    """Reference guards (src/modeling.py:186-191): without normalisation the
    temperature is forced to 1.0; with cosine similarity T > 0.5 is rejected."""
    if not normalize_embeddings:
        return 1.0
    if temperature > 0.5:
        raise ValueError(
            "temperature should be <= 0.5 when using cosine similarity "
            "(normalize_embeddings=True); recommended range 0.01-0.1"
        )
    return temperature
