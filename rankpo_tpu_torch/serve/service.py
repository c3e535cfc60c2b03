"""Retrieval serving: encoder + index behind one query API (port of
``rankpo_tpu.serve.service`` for the flat, refine and IVF tiers).

The corpus embeddings are encoded on the device and stay there as the
index; a query is tokenized, embedded and searched on the device, and only
the [Q, k] scores and indices come back to the host. Ported: ``build_index``
(``index_type`` "flat", "refine", "ivf" or a factory spec such as
"IVF4096,PQ64" or "PCA128,Flat"), ``adopt_index`` (serve an index built
elsewhere, e.g. by ``IVFIPIndex.from_chunk_fn``), ``query`` (with a
per-call ``nprobe`` for IVF and ``candidates`` for the two-stage tiers),
``warmup``, ``finalize_hits``. Not ported yet (ROADMAP.md Queue 1 item 5):
bf16/int8 flat storage, approximate flat top-k, packed queries, stable ids,
passage add/remove, index persistence and request-level filters.
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
from rankpo_tpu_torch.index.refined import RefineIPIndex

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

    ``index_type``: "flat" (exact), "refine" (PCA prefilter and exact
    rerank) or "ivf" (clustered inverted file; both approximate, tuned to
    ``recall_target`` at build, 1.0 tuning to 0.95), or a FAISS
    index_factory-style spec ("IVF4096,PQ64", "PCA128,Flat", ...;
    ``index/factory.py``) whose components fill the kwargs (explicit
    ``index_kwargs`` win). ``index_dtype``: the refine/IVF row storage
    (fp32, bf16; int8 for IVF only); a spec without a storage component
    keeps the tier's bf16 default."""
    if index_type not in ("flat", "refine", "ivf"):
        index_type, spec_kwargs = resolve_index_spec(index_type, index_kwargs)
        if index_type == "flat" and "dtype" in spec_kwargs:
            dtype = spec_kwargs.pop("dtype")
            if index_dtype is None:
                index_dtype = dtype
        if (index_type in ("refine", "ivf") and index_dtype is None
                and "pq_m" not in spec_kwargs):
            spec_kwargs.setdefault("store_dtype", torch.bfloat16)
        index_kwargs = spec_kwargs
    index_dtype = index_dtype if index_dtype is not None else torch.float32
    if index_type == "refine" and index_dtype == torch.int8:
        raise ValueError("index_type='refine' stores fp32/bf16 rerank rows; int8 "
                         "storage is an IVF option")
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
        """Refine/IVF constructor kwargs: the service's recall_target is the
        build tune target (1.0 would ladder the tuner to its cap chasing
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
        elif self.index_type == "refine":
            with torch.inference_mode():
                index = RefineIPIndex.from_sharded(emb, n, **self._approx_kwargs())
        else:
            index = FlatIPIndex(emb, n_total=n, **self.index_kwargs)
        self._state = (index, list(corpus_texts))
        logger.info("indexed %d passages in %.1fs", n, time.perf_counter() - t0)

    def adopt_index(self, index, corpus_texts: Sequence[str]) -> None:
        """Serve an index built elsewhere (e.g. ``IVFIPIndex.from_chunk_fn``,
        whose fp32 corpus never existed whole): its rows must be the encoder's
        width and one per text."""
        dim = getattr(index, "dim", None)
        if dim is not None and dim != self.encoder.config.hidden_size:
            raise ValueError(
                f"index dim {dim} != encoder hidden {self.encoder.config.hidden_size}")
        if index.ntotal != len(corpus_texts):
            raise ValueError(
                f"index has {index.ntotal} rows, got {len(corpus_texts)} corpus texts")
        self._state = (index, list(corpus_texts))

    @property
    def index(self):
        return self._state[0]

    @property
    def corpus_texts(self) -> List[str]:
        return self._state[1]

    @property
    def ntotal(self) -> int:
        return self.index.ntotal if self.index is not None else 0

    def search_texts(self, texts: List[str], k: int, nprobe: Optional[int] = None,
                     candidates: Optional[int] = None):
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
        if candidates is not None:
            if not hasattr(index, "candidates"):
                raise ValueError(
                    "candidates applies to two-stage indexes only (--index_type "
                    "refine, or ivf with --ivf_reduced_dim)")
            search_kw["candidates"] = int(candidates)
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
        candidates: Optional[int] = None,
    ) -> List[Dict] | Dict:
        """Top-k passages per query text; hits carry ``index`` (corpus
        position), ``score`` and, with ``return_passages``, ``passage``.
        ``nprobe`` (IVF) and ``candidates`` (the refine tier and the IVF PCA
        hybrid's rerank pool) override the tuned knobs for this call (FAISS
        ``SearchParametersIVF``)."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        scores, indices, corpus_texts = self.search_texts(list(texts), k, nprobe,
                                                          candidates)
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
