"""Retrieval serving: encoder + exact flat index behind one query API (port
of ``rankpo_tpu.serve.service`` for the flat tier).

The corpus embeddings are encoded on the device and stay there as the
index; a query is tokenized, embedded and searched on the device, and only
the [Q, k] scores and indices come back to the host. Ported: ``build_index``,
``query``, ``warmup``, ``finalize_hits``. Not ported yet (ROADMAP.md): the
refine/IVF/PQ tiers, bf16/int8 storage, approximate top-k, packed queries,
stable ids, passage add/remove, index persistence and filtered search.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.flat import FlatIPIndex

logger = logging.getLogger(__name__)


def finalize_hits(result: Dict, k: int, return_passages: bool = True) -> Dict:
    """Slice a search-at-k_max result down to the client's k (shared by the
    HTTP handler and the micro-batcher). Passage texts already ride the hits,
    attached from the index snapshot the search ran on."""
    result["hits"] = result["hits"][:k]
    if not return_passages:
        for h in result["hits"]:
            h.pop("passage", None)
    return result


class RetrievalService:
    def __init__(
        self,
        encoder: InferenceEncoder,
        *,
        max_query_length: int = 512,
        query_batch_size: int = 64,
    ):
        self.encoder = encoder
        self.max_query_length = max_query_length
        self.query_batch_size = query_batch_size
        # (index, corpus_texts) swap as one tuple: a query decorates hit ids
        # with the texts of the index it searched
        self._state: tuple = (None, [])

    def build_index(
        self,
        corpus_texts: Sequence[str],
        *,
        max_passage_length: int = 512,
        batch_size: int = 256,
    ) -> None:
        """Encode the corpus and keep its fp32 embeddings on the device as a
        flat index (they never visit the host)."""
        if not corpus_texts:
            raise ValueError("cannot build an index over an empty corpus")
        t0 = time.perf_counter()
        emb, n = self.encoder.encode_device(
            list(corpus_texts), batch_size=batch_size,
            max_length=max_passage_length,
        )
        self._state = (FlatIPIndex(emb, n_total=n), list(corpus_texts))
        logger.info("indexed %d passages in %.1fs", n, time.perf_counter() - t0)

    @property
    def index(self):
        return self._state[0]

    @property
    def corpus_texts(self) -> List[str]:
        return self._state[1]

    @property
    def ntotal(self) -> int:
        return self.index.ntotal if self.index is not None else 0

    def search_texts(self, texts: List[str], k: int):
        """(scores fp32 [Q, k'], indices int64 [Q, k']) numpy, k' =
        min(k, ntotal), against an explicit ``(index, texts)`` snapshot."""
        index, corpus_texts = self._state
        if index is None:
            raise RuntimeError("no index built; call build_index first")
        k_eff = min(k, index.ntotal)
        scores, indices = [], []
        for lo in range(0, len(texts), self.query_batch_size):
            chunk = texts[lo : lo + self.query_batch_size]
            batch = self.encoder.prepare_batch(
                chunk, len(chunk), self.max_query_length
            )
            with torch.inference_mode():
                reps = self.encoder.embed_batch(batch)
                s, i = index.search_tensor(reps, k_eff)
            scores.append(s.cpu().numpy())
            indices.append(i.cpu().numpy())
        if not scores:
            return (np.zeros((0, k_eff), np.float32),
                    np.zeros((0, k_eff), np.int64), corpus_texts)
        return np.concatenate(scores), np.concatenate(indices), corpus_texts

    def query(
        self,
        texts: Sequence[str] | str,
        k: int = 10,
        *,
        return_passages: bool = True,
    ) -> List[Dict] | Dict:
        """Top-k passages per query text; hits carry ``index`` (corpus
        position), ``score`` and, with ``return_passages``, ``passage``."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        scores, indices, corpus_texts = self.search_texts(list(texts), k)
        results = []
        for qi, text in enumerate(texts):
            hits = []
            for score, idx in zip(scores[qi], indices[qi]):
                hit = {"index": int(idx), "score": float(score)}
                if return_passages:
                    hit["passage"] = corpus_texts[int(idx)]
                hits.append(hit)
            results.append({"query": text, "hits": hits})
        return results[0] if single else results

    def warmup(self, k: int = 10) -> None:
        """One small pass: builds the kernels and starts cuBLAS before the
        first request (there is nothing to compile per shape)."""
        self.query(["warm up"], k=k, return_passages=False)
