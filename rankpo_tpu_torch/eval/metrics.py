"""IR metrics: MRR / Recall / AUC / nDCG at cutoffs (a numpy copy of
``rankpo_tpu.eval.metrics``; the port's tests hold it bit-equal to it on
both the sklearn and the numpy paths).

Bit-compatible with the reference evaluator (src/utils.py:87-153), including
its quirks, which matter for score parity:

  - Recall uses the cutoff-capped denominator
    ``max(min(cutoff, len(pred), len(label)), 1)`` (src/utils.py:127) — NOT the
    standard |relevant| denominator.
  - AUC flattens hit-encodings and scores of the top-k lists across all queries
    into one ROC curve per cutoff (src/utils.py:140-146).
  - nDCG treats the top-k list's binary hit-encodings as graded relevance over
    the k prediction slots (src/utils.py:148-151, sklearn.ndcg_score), not over
    the whole corpus.

sklearn is used when available for literal parity; pure-numpy fallbacks
implement the identical math (tested equal).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

try:
    from sklearn.metrics import ndcg_score as _sk_ndcg, roc_auc_score as _sk_auc

    _HAS_SKLEARN = True
except ImportError:  # pragma: no cover
    _HAS_SKLEARN = False


def _degenerate_auc(labels: np.ndarray) -> float:
    """Defined AUC value when the flattened hit-encodings hold a single class.

    sklearn's roc_auc_score raises ValueError here (and so would the
    reference, src/utils.py:140-146 — the case never arises on its noisy
    eval set, but a WELL-TRAINED model at cutoff 1 hits it: every top-1 is
    relevant → all-ones labels). Convention chosen so the training curve
    stays monotone instead of crashing or jumping to NaN:

      - all positives (every retrieved slot is a hit) → 1.0: the ranking
        task is perfectly satisfied, the natural limit of AUC→1 as the
        last negative leaves the top-k.
      - all negatives (no hits at all) → 0.0: the worst-case limit,
        consistent with MRR/Recall also being 0 for that eval set.
    """
    return 1.0 if labels.any() else 0.0


def _auc_numpy(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney statistic with average ranks for ties —
    equal to sklearn.roc_auc_score for binary labels (single-class input is
    handled by the caller via _degenerate_auc)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return _degenerate_auc(labels)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos_rank_sum = ranks[labels == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _dcg_numpy(rel: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Per-row DCG@k ordering rel by descending score, averaging over tied
    score groups (sklearn's ignore_ties=False behavior)."""
    n, m = rel.shape
    discounts = 1.0 / np.log2(np.arange(2, m + 2))
    out = np.zeros(n)
    for r in range(n):
        order = np.argsort(-scores[r], kind="mergesort")
        s_sorted = scores[r][order]
        rel_sorted = rel[r][order].astype(np.float64)
        # average relevance within tied-score groups (expected DCG over ties)
        gains = rel_sorted.copy()
        i = 0
        while i < m:
            j = i
            while j + 1 < m and s_sorted[j + 1] == s_sorted[i]:
                j += 1
            if j > i:
                gains[i : j + 1] = rel_sorted[i : j + 1].mean()
            i = j + 1
        out[r] = float((gains[:k] * discounts[:k]).sum())
    return out


def _ndcg_numpy(rel: np.ndarray, scores: np.ndarray, k: int) -> float:
    dcg = _dcg_numpy(rel, scores, k)
    ideal = _dcg_numpy(rel, rel.astype(np.float64), k)
    safe = ideal > 0
    out = np.zeros(len(dcg))
    out[safe] = dcg[safe] / ideal[safe]
    return float(out.mean())


def compute_metrics(
    preds: Sequence[Sequence[int]],
    preds_scores: np.ndarray,
    labels: Sequence[Sequence[int]],
    cutoffs: Sequence[int] = (1, 5, 10, 20, 100),
) -> Dict[str, float]:
    """preds: [Q, k] retrieved corpus indices (descending score);
    preds_scores: [Q, k]; labels: per-query relevant corpus indices."""
    preds = np.asarray(preds)
    preds_scores = np.asarray(preds_scores)
    if len(preds) != len(labels):
        raise ValueError("shape mismatch between predictions and labels")
    cutoffs = list(cutoffs)
    metrics: Dict[str, float] = {}

    # MRR: reciprocal rank of the FIRST hit, credited to every cutoff >= rank
    mrrs = np.zeros(len(cutoffs))
    for pred, label in zip(preds, labels):
        label_set = set(label)
        for rank, p in enumerate(pred, 1):
            if p in label_set:
                for ci, cutoff in enumerate(cutoffs):
                    if rank <= cutoff:
                        mrrs[ci] += 1.0 / rank
                break
    mrrs /= len(preds)
    for ci, cutoff in enumerate(cutoffs):
        metrics[f"MRR@{cutoff}"] = float(mrrs[ci])

    # Recall with the reference's capped denominator
    recalls = np.zeros(len(cutoffs))
    for pred, label in zip(preds, labels):
        label_arr = np.asarray(label)
        for ci, cutoff in enumerate(cutoffs):
            common = np.intersect1d(label_arr, pred[:cutoff])
            denom = max(min(cutoff, len(pred), len(label_arr)), 1)
            recalls[ci] += len(common) / denom
    recalls /= len(preds)
    for ci, cutoff in enumerate(cutoffs):
        metrics[f"Recall@{cutoff}"] = float(recalls[ci])

    # hit encodings of the top-k lists
    hits = np.stack(
        [np.isin(pred, np.asarray(label)).astype(int) for pred, label in zip(preds, labels)]
    )

    # AUC: one flattened ROC per cutoff; single-class input (all slots hits,
    # or no hits) gets the defined degenerate value rather than sklearn's
    # ValueError / NaN — see _degenerate_auc
    for cutoff in cutoffs:
        h = hits[:, :cutoff].flatten()
        s = preds_scores[:, :cutoff].flatten()
        if h.all() or not h.any():
            metrics[f"AUC@{cutoff}"] = _degenerate_auc(h)
        elif _HAS_SKLEARN:
            metrics[f"AUC@{cutoff}"] = float(_sk_auc(h, s))
        else:
            metrics[f"AUC@{cutoff}"] = _auc_numpy(h, s)

    # nDCG over the prediction slots
    for cutoff in cutoffs:
        if _HAS_SKLEARN:
            metrics[f"nDCG@{cutoff}"] = float(
                _sk_ndcg(hits, preds_scores, k=cutoff)
            )
        else:
            metrics[f"nDCG@{cutoff}"] = _ndcg_numpy(hits, preds_scores, cutoff)

    return metrics
