"""Retrieval serving: encoder + index behind one query API (port of
``rankpo_tpu.serve.service`` for the flat and IVF tiers).

The corpus embeddings are encoded on the device and stay there as the
index; a query is tokenized, embedded and searched on the device, and only
the [Q, k] scores and indices come back to the host. Ported: ``build_index``
(``index_type`` "flat", "ivf" or a factory spec such as "IVF4096,PQ64"),
``query`` (with a per-call ``nprobe`` for IVF), ``warmup``,
``finalize_hits``. Not ported yet (ROADMAP.md): the refine tier and the PCA
hybrid, bf16/int8 flat storage, approximate flat top-k, packed queries,
stable ids, passage add/remove, index persistence and filtered search.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import resolve_index_spec
from rankpo_tpu_torch.index.flat import FlatIPIndex
from rankpo_tpu_torch.index.ivf import IVFIPIndex

logger = logging.getLogger(__name__)

_NOT_PORTED = "not ported to rankpo_tpu_torch yet (ROADMAP.md Queue 1, {})"


def finalize_hits(result: Dict, k: int, return_passages: bool = True) -> Dict:
    """Slice a search-at-k_max result down to the client's k (shared by the
    HTTP handler and the micro-batcher). Passage texts already ride the hits,
    attached from the index snapshot the search ran on."""
    result["hits"] = result["hits"][:k]
    if not return_passages:
        for h in result["hits"]:
            h.pop("passage", None)
    return result


def resolve_tier(index_type: str = "flat", index_dtype: Optional[torch.dtype] = None,
                 index_kwargs: Optional[Dict] = None, recall_target: float = 1.0
                 ) -> Tuple[str, torch.dtype, Dict]:
    """(tier, storage dtype, index kwargs) for the service's arguments; a
    tier or option the port has not built raises NotImplementedError.

    ``index_type``: "flat" (exact), "ivf" (clustered inverted file,
    approximate, tuned to ``recall_target`` at build; 1.0 tunes to 0.95),
    or a FAISS index_factory-style spec ("IVF4096,PQ64", ...;
    ``index/factory.py``) whose components fill the kwargs (explicit
    ``index_kwargs`` win). ``index_dtype``: the IVF row storage (fp32, bf16
    or int8); a spec without a storage component keeps the tier's bf16
    default."""
    if index_type not in ("flat", "refine", "ivf"):
        index_type, spec_kwargs = resolve_index_spec(index_type, index_kwargs)
        if index_type == "flat" and "dtype" in spec_kwargs:
            dtype = spec_kwargs.pop("dtype")
            if index_dtype is None:
                index_dtype = dtype
        if index_type == "ivf" and index_dtype is None and "pq_m" not in spec_kwargs:
            spec_kwargs.setdefault("store_dtype", torch.bfloat16)
        index_kwargs = spec_kwargs
    index_dtype = index_dtype if index_dtype is not None else torch.float32
    if index_type == "refine":
        raise NotImplementedError(
            "index_type='refine': " + _NOT_PORTED.format("item 4, index/refined.py"))
    if index_type == "ivf" and (index_kwargs or {}).get("reduced_dim") is not None:
        raise NotImplementedError(
            "ivf reduced_dim: " + _NOT_PORTED.format("item 4, the PCA hybrid"))
    if index_type == "flat":
        if index_dtype != torch.float32:
            raise NotImplementedError(
                f"flat index dtype {index_dtype}: "
                + _NOT_PORTED.format("item 5, bf16/int8 flat storage"))
        if recall_target < 1.0:
            raise NotImplementedError(
                "recall_target < 1 on the flat tier (approximate top-k): "
                + _NOT_PORTED.format("item 5"))
    return index_type, index_dtype, dict(index_kwargs or {})


class RetrievalService:
    def __init__(
        self,
        encoder: InferenceEncoder,
        *,
        max_query_length: int = 512,
        query_batch_size: int = 64,
        recall_target: float = 1.0,
        index_dtype: Optional[torch.dtype] = None,
        index_type: str = "flat",
        index_kwargs: Optional[Dict] = None,
    ):
        """The index arguments are :func:`resolve_tier`'s."""
        self.encoder = encoder
        self.max_query_length = max_query_length
        self.query_batch_size = query_batch_size
        self.recall_target = recall_target
        self.index_type, self.index_dtype, self.index_kwargs = resolve_tier(
            index_type, index_dtype, index_kwargs, recall_target)
        # (index, corpus_texts) swap as one tuple: a query decorates hit ids
        # with the texts of the index it searched
        self._state: tuple = (None, [])

    def _approx_kwargs(self) -> Dict:
        """IVF constructor kwargs: the service's recall_target is the build
        tune target (1.0 would ladder the tuner to its cap chasing
        exactness, so it defaults to 0.95), and ``index_dtype`` the row
        storage unless the kwargs name one."""
        kwargs = dict(self.index_kwargs)
        kwargs.setdefault(
            "recall_target", self.recall_target if self.recall_target < 1.0 else 0.95)
        kwargs.setdefault("store_dtype", self.index_dtype)
        return kwargs

    def build_index(
        self,
        corpus_texts: Sequence[str],
        *,
        max_passage_length: int = 512,
        batch_size: int = 256,
    ) -> None:
        """Encode the corpus and build the index on the device from the
        embeddings there (they never visit the host)."""
        if not corpus_texts:
            raise ValueError("cannot build an index over an empty corpus")
        t0 = time.perf_counter()
        emb, n = self.encoder.encode_device(
            list(corpus_texts), batch_size=batch_size,
            max_length=max_passage_length,
        )
        if self.index_type == "ivf":
            with torch.inference_mode():
                index = IVFIPIndex(emb, n_total=n, **self._approx_kwargs())
        else:
            index = FlatIPIndex(emb, n_total=n, **self.index_kwargs)
        self._state = (index, list(corpus_texts))
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

    def search_texts(self, texts: List[str], k: int, nprobe: Optional[int] = None):
        """(scores fp32 [Q, k'], indices int64 [Q, k'], corpus texts) numpy,
        k' = min(k, ntotal), from one ``(index, texts)`` snapshot."""
        index, corpus_texts = self._state
        if index is None:
            raise RuntimeError("no index built; call build_index first")
        search_kw = {}
        if nprobe is not None:
            if not isinstance(index, IVFIPIndex):
                raise ValueError("nprobe applies to IVF indexes only (--index_type ivf)")
            search_kw["nprobe"] = int(nprobe)
        k_eff = min(k, index.ntotal)
        scores, indices = [], []
        for lo in range(0, len(texts), self.query_batch_size):
            chunk = texts[lo : lo + self.query_batch_size]
            batch = self.encoder.prepare_batch(
                chunk, len(chunk), self.max_query_length
            )
            with torch.inference_mode():
                reps = self.encoder.embed_batch(batch)
                s, i = index.search_tensor(reps, k_eff, **search_kw)
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
        nprobe: Optional[int] = None,
    ) -> List[Dict] | Dict:
        """Top-k passages per query text; hits carry ``index`` (corpus
        position), ``score`` and, with ``return_passages``, ``passage``.
        ``nprobe`` overrides the IVF index's tuned probe count for this call
        (FAISS ``SearchParametersIVF``)."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        scores, indices, corpus_texts = self.search_texts(list(texts), k, nprobe)
        results = []
        for qi, text in enumerate(texts):
            hits = []
            for score, idx in zip(scores[qi], indices[qi]):
                if idx < 0:
                    # IVF pads unreachable tail slots with -1/-inf (FAISS
                    # IVF semantics); never surface them as hits
                    continue
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
