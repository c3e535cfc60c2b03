"""RankPO preference loss over similarity scores (port of
``rankpo_tpu.losses.rankpo``; reference src/rankpo_trainer.py:447-568).

    adv    = (s_chosen - s_rejected) - [ref margin if not reference_free]
    adv   /= temperature
    logits = adv - gamma_beta_ratio
    sigmoid: -log sigmoid(beta logits) (1 - ls) - log sigmoid(-beta logits) ls
    hinge:   relu(1 - beta logits)

The auxiliary SFT branch applies its own temperature to the raw scores
(rankpo_trainer.py:500); the two temperature applications are distinct.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def rankpo_loss(
    chosen_scores: torch.Tensor,
    rejected_scores: torch.Tensor,
    ref_chosen_scores: Optional[torch.Tensor] = None,
    ref_rejected_scores: Optional[torch.Tensor] = None,
    *,
    beta: float = 1.0,
    gamma_beta_ratio: float = 0.0,
    temperature: float = 0.02,
    loss_type: str = "sigmoid",
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Per-example losses [B]."""
    adv = chosen_scores.float() - rejected_scores.float()
    if ref_chosen_scores is not None and ref_rejected_scores is not None:
        adv = adv - (ref_chosen_scores.float() - ref_rejected_scores.float())
    adv = adv / temperature
    logits = adv - gamma_beta_ratio
    if loss_type == "sigmoid":
        return (
            -F.logsigmoid(beta * logits) * (1.0 - label_smoothing)
            - F.logsigmoid(-beta * logits) * label_smoothing
        )
    if loss_type == "hinge":
        return torch.relu(1.0 - beta * logits)
    raise ValueError(f"Unknown loss_type: {loss_type}; one of ['sigmoid', 'hinge']")


def sft_loss(
    scores: torch.Tensor,
    temperature: float,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2-way contrastive regularizer: CE([s_c, s_r]/T, target 0)
    (rankpo_trainer.py:499-505)."""
    logits = scores.float() / temperature
    logz = torch.logsumexp(logits, dim=-1)
    return _masked_mean(logz - logits[:, 0], row_valid)


def _masked_mean(x: torch.Tensor, row_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over rows, restricted to ``row_valid`` (0/1) rows when given."""
    x = x.float()
    if row_valid is None:
        return x.mean()
    w = row_valid.float()
    return (x * w).sum() / w.sum().clamp_min(1.0)


def rankpo_batch_loss(
    scores: torch.Tensor,
    ref_scores: Optional[torch.Tensor] = None,
    *,
    beta: float = 1.0,
    gamma_beta_ratio: float = 0.0,
    temperature: float = 0.02,
    loss_type: str = "sigmoid",
    label_smoothing: float = 0.0,
    rankpo_weight: float = 1.0,
    sft_weight: float = 0.0,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss + metrics from a [B, 2] (chosen, rejected) score matrix:
    ``rankpo_weight * L_rankpo + sft_weight * L_sft``, with the reference's
    rewards/* and scores/* metric families (means over the batch)."""
    chosen = scores[:, 0]
    rejected = scores[:, 1]
    if ref_scores is not None:
        ref_chosen, ref_rejected = ref_scores[:, 0], ref_scores[:, 1]
    else:
        ref_chosen = ref_rejected = None

    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=scores.device)
    if rankpo_weight > 0.0:
        per_example = rankpo_loss(
            chosen, rejected, ref_chosen, ref_rejected, beta=beta,
            gamma_beta_ratio=gamma_beta_ratio, temperature=temperature,
            loss_type=loss_type, label_smoothing=label_smoothing,
        )
        l_rankpo = _masked_mean(per_example, row_valid)
        total = total + rankpo_weight * l_rankpo
        metrics["rankpo_loss"] = l_rankpo
    if sft_weight > 0.0:
        l_sft = sft_loss(scores, temperature, row_valid)
        total = total + sft_weight * l_sft
        metrics["sft_loss"] = l_sft

    rc = 0.0 if ref_chosen is None else ref_chosen
    rr = 0.0 if ref_rejected is None else ref_rejected
    chosen_rewards = beta * (chosen - rc)
    rejected_rewards = beta * (rejected - rr)
    metrics["rewards/chosen"] = _masked_mean(chosen_rewards, row_valid)
    metrics["rewards/rejected"] = _masked_mean(rejected_rewards, row_valid)
    metrics["rewards/accuracies"] = _masked_mean(
        (chosen_rewards > rejected_rewards).float(), row_valid
    )
    metrics["rewards/margins"] = _masked_mean(chosen_rewards - rejected_rewards, row_valid)
    metrics["scores/chosen"] = _masked_mean(chosen, row_valid)
    metrics["scores/rejected"] = _masked_mean(rejected, row_valid)
    metrics["scores/margins"] = _masked_mean(chosen - rejected, row_valid)
    return total, metrics
