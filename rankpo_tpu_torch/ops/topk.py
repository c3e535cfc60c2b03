"""Exact matmul + top-k (port of ``rankpo_tpu.ops.topk.dense_matmul_topk``,
exact mode).

Scores are fp32-faithful: exact search promises the scores FAISS IndexFlatIP
would compute, so fp32 matrix products must not run in TF32.
:func:`require_fp32_matmul` sets that for the process (PyTorch's defaults
already are ``allow_tf32 = False`` and precision "highest"; the call pins
them against any other code that relaxed them).

Tie order: FAISS, and ``index/flat.py:numpy_search``, return the lower corpus
index first among equal scores. PyTorch does not document the tie order of
``torch.topk`` on CUDA, so selection is a stable descending sort, which
keeps equal scores in ascending-index order by construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def require_fp32_matmul() -> None:
    """fp32 products in full fp32 (no TF32) for exact search scores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties by lowest index."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def dense_matmul_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [Q, N] inner-product scores and their exact top-k.

    ``n_valid``: rows at or past it are padding and score -inf, so they
    never surface ahead of a real row. Returns (scores fp32 [Q, k'],
    indices int64 [Q, k']) with k' = min(k, N)."""
    k = min(k, corpus.shape[0])
    scores = queries.to(torch.float32) @ corpus.to(torch.float32).T
    if n_valid is not None and n_valid < corpus.shape[0]:
        scores[:, n_valid:] = float("-inf")
    return exact_topk(scores, k)
