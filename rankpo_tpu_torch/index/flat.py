"""Exact inner-product index on one device (port of
``rankpo_tpu.index.flat``: ``numpy_search`` and ``FlatIPIndex``, fp32
storage).

The corpus matrix stays on the device it was encoded on; a search runs the
fp32 matmul and the tie-stable top-k of ``ops/topk.py`` there. Results match
FAISS ``IndexFlatIP``: exact fp32 scores, descending, ties by lower index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.ops.topk import dense_matmul_topk, require_fp32_matmul


def numpy_search(
    corpus: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side oracle with FAISS IndexFlatIP semantics: exact IP scores,
    descending, ties broken by lower corpus index."""
    scores = queries.astype(np.float32) @ corpus.astype(np.float32).T
    k = min(k, corpus.shape[0])
    # stable descending sort: equal scores keep ascending-index order
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    out_scores = np.take_along_axis(scores, order, axis=1)
    return out_scores, order.astype(np.int64)


class FlatIPIndex:
    """Exact inner-product index over fp32 rows on one device (the device
    of ``embeddings`` when it is a tensor, else the CPU).

    ``embeddings``: [N_buf, D] numpy array or tensor; rows at or past
    ``n_total`` (default N_buf) are padding and never returned."""

    def __init__(self, embeddings, *, n_total: Optional[int] = None):
        require_fp32_matmul()
        # a tensor keeps its device; a numpy array becomes a CPU tensor
        corpus = torch.as_tensor(embeddings, dtype=torch.float32)
        if corpus.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(corpus.shape)}")
        self.corpus = corpus
        self.n_total = int(corpus.shape[0] if n_total is None else n_total)
        if not 0 < self.n_total <= corpus.shape[0]:
            raise ValueError(
                f"n_total {self.n_total} outside (0, {corpus.shape[0]}]"
            )
        self.dim = int(corpus.shape[1])

    @property
    def ntotal(self) -> int:
        return self.n_total

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    def search_tensor(self, queries: torch.Tensor, k: int):
        """Device-side search: (scores fp32 [Q, k'], indices int64 [Q, k'])
        on the index's device, k' = min(k, ntotal)."""
        k = min(k, self.n_total)
        return dense_matmul_topk(queries.to(self.device), self.corpus, k=k,
                                 n_valid=self.n_total)

    def search(self, queries, k: int = 100, batch_size: int = 256):
        """Batched exact top-k from host queries (analog of the reference's
        faiss_search). Returns numpy fp32 scores and int32 indices [Q, k']."""
        k = min(k, self.n_total)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size])
            s, i = self.search_tensor(block, k)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        return np.concatenate(scores), np.concatenate(indices)

    def rows(self) -> np.ndarray:
        """The stored rows [ntotal, D] as host fp32."""
        return self.corpus[: self.n_total].cpu().numpy()
