"""Exact inner-product index on one device (port of
``rankpo_tpu.index.flat``: ``numpy_search`` and ``FlatIPIndex``, fp32
storage), and the helpers every index tier shares: the append-argument
contract, the ``IDSelector``-style filter mask and its tail rewrite, and the
reconstruct id check and row gather.

The corpus matrix stays on the device it was encoded on; a search runs the
fp32 matmul and the tie-stable top-k of ``ops/topk.py`` there. Results match
FAISS ``IndexFlatIP``: exact fp32 scores, descending, ties by lower index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.ops.topk import dense_matmul_topk, require_fp32_matmul

_RECON_BATCH = 1024  # reconstruct gathers ids in chunks of this many


def validate_append_args(new_rows, n_new, headroom, dim, n_shards=1) -> int:
    """The argument contract of every tier's ``append_sharded``:
    ``new_rows`` is [n_buf >= n_new, dim] with n_buf divisible by the shard
    count (1 on one device), and ``headroom`` >= 0. Returns int n_new."""
    n_new = int(n_new)
    if n_new < 1:
        raise ValueError("append_sharded needs n_new >= 1")
    if headroom < 0.0:
        raise ValueError("headroom must be >= 0")
    if int(new_rows.shape[1]) != dim:
        raise ValueError(f"new rows dim {new_rows.shape[1]} != index dim {dim}")
    if int(new_rows.shape[0]) < n_new or int(new_rows.shape[0]) % n_shards:
        raise ValueError(
            f"new rows buffer ({new_rows.shape[0]}) must be >= n_new "
            f"({n_new}) and divisible by {n_shards} shards"
        )
    return n_new


def build_selector_mask(n_total: int, allowed_ids=None, disallowed_ids=None,
                        selector=None) -> Optional[np.ndarray]:
    """The FAISS ``IDSelector`` analog shared by the index tiers: a bool
    eligibility mask over corpus positions (True = may be returned), from at
    most one of ``allowed_ids`` (only these), ``disallowed_ids`` (all but
    these) or ``selector`` (a prebuilt bool [n_total] mask). None when no
    filter is given."""
    given = [x is not None for x in (allowed_ids, disallowed_ids, selector)]
    if sum(given) == 0:
        return None
    if sum(given) > 1:
        raise ValueError("give at most one of allowed_ids / disallowed_ids / selector")
    if selector is not None:
        mask = np.asarray(selector)
        if mask.dtype != np.bool_ or mask.shape != (n_total,):
            raise ValueError(
                f"selector must be a bool array of shape ({n_total},); got "
                f"{mask.dtype} {mask.shape}"
            )
        return mask.copy()
    ids = np.asarray(
        allowed_ids if allowed_ids is not None else disallowed_ids, np.int64
    ).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= n_total):
        raise IndexError(
            f"selector ids must be in [0, {n_total}); got [{ids.min()}, {ids.max()}]"
        )
    if allowed_ids is not None:
        mask = np.zeros(n_total, np.bool_)
        mask[ids] = True
    else:
        mask = np.ones(n_total, np.bool_)
        mask[ids] = False
    return mask


def mask_filtered_misses(scores: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """A filtered search's unfillable tail (score -inf) gets index -1, as
    FAISS pads it."""
    return np.where(np.isfinite(scores), indices, -1).astype(indices.dtype, copy=False)


def _canonical_recon_ids(ids, n_total: int) -> np.ndarray:
    """A reconstruct id argument (scalar or 1-D) as bounds-checked int64."""
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    if ids.ndim != 1:
        raise ValueError("ids must be a scalar or 1-D sequence")
    if ids.size and (ids.min() < 0 or ids.max() >= n_total):
        raise IndexError(
            f"ids must be in [0, {n_total}); got [{ids.min()}, {ids.max()}]"
        )
    return ids


def _chunked_row_gather(fn, idx: np.ndarray, device) -> np.ndarray:
    """``fn(idx_chunk) -> fp32 rows`` on ``device`` over chunks of
    ``_RECON_BATCH`` ids, concatenated on the host."""
    out = [
        fn(torch.from_numpy(idx[lo : lo + _RECON_BATCH]).to(device)).cpu().numpy()
        for lo in range(0, idx.size, _RECON_BATCH)
    ]
    return np.concatenate(out).astype(np.float32, copy=False)


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
