"""Retrieval serving: encoder + index behind one query API (port of
``rankpo_tpu.serve.service``).

The corpus embeddings are encoded on the device and stay there as the
index; a query is tokenized, embedded and searched on the device, and only
the [Q, k] scores and indices come back to the host. Tiers: ``index_type``
"flat" (fp32, bf16 or int8 rows; exact, or approximate with
``recall_target < 1``), "refine", "ivf", or a factory spec such as "SQ8",
"IVF4096,PQ64" or "PCA128,Flat". ``adopt_index`` serves an index built
elsewhere (e.g. ``IVFIPIndex.from_chunk_fn``), ``load_index`` one over
given embeddings; ``add_passages`` / ``remove_passages`` mutate the live
index on the device (FAISS ``add`` / ``remove_ids``), with positional ids
or, under ``stable_ids``, external ids that survive removals (FAISS
``IndexIDMap``); ``save_index`` / ``load_index_file`` persist it
(``index/io.py``, plus the JAX package's legacy embeddings format on load);
``query`` takes a per-call ``nprobe`` (IVF), ``candidates`` (the two-stage
tiers) and ``allowed_ids`` / ``disallowed_ids`` (FAISS ``IDSelector``).

The JAX service's fused-program cache (``_get_fused``, ``_build_fused*``,
``_rebind_fused``, ``_arrays_compatible``) has no counterpart: it exists to
keep XLA compiles and remote dispatches off the request path, and the port
compiles nothing per shape. So a mutation keeps nothing to rebind, and
``rewarm_after_mutation`` replays the last warmup after every mutation.
``pack_queries`` packs each group's queries several to a row
(``data/packing.py``) and embeds them with block-diagonal attention.

With ``group=`` (the data group of a multi-process server) the flat and
refine tiers are row-sharded over the group and the IVF tier's whole
clusters are (``index/ivf.py``): each rank encodes only its own shard of
the corpus (``InferenceEncoder.encode_shard``), every rank encodes every
query and every added passage (they are small, and no embedding then
crosses processes), and each search, mutation, save and load is a
collective of the group that every rank must run in the same order;
``serve/multihost.py`` drives the ranks from rank 0. The JAX service slices
the queries across processes instead (``service.py:1019-1022``). Rank 0
writes the index file while the others wait. A sharded IVF index (rows,
PQ codes or the PCA hybrid) mutates as the flat tier does: every rank
appends every added passage's row, and keeps those of its own clusters.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.packing import pack_token_lists
from rankpo_tpu_torch.index import io as index_io
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import resolve_index_spec
from rankpo_tpu_torch.index.flat import (
    FlatIPIndex,
    build_selector_mask,
    mask_filtered_misses,
)
from rankpo_tpu_torch.index.ivf import IVFIPIndex
from rankpo_tpu_torch.index.refined import RefineIPIndex

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


def resolve_tier(index_type: str = "flat", index_dtype: Optional[torch.dtype] = None,
                 index_kwargs: Optional[Dict] = None) -> Tuple[str, torch.dtype, Dict]:
    """(tier, storage dtype, index kwargs) for the service's arguments.

    ``index_type``: "flat" (brute force, exact or, with ``recall_target <
    1``, approximate top-k), "refine" (PCA prefilter and exact rerank) or
    "ivf" (clustered inverted file; both approximate, tuned to
    ``recall_target`` at build, 1.0 tuning to 0.95), or a FAISS
    index_factory-style spec ("SQ8", "IVF4096,PQ64", "PCA128,Flat", ...;
    ``index/factory.py``) whose components fill the kwargs (explicit
    ``index_kwargs`` win). ``index_dtype``: the row storage (fp32, bf16;
    int8 for flat and IVF); a spec without a storage component keeps the
    tier's default (fp32 flat, bf16 refine/IVF rows)."""
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
                         "storage is a flat or IVF option")
    return index_type, index_dtype, dict(index_kwargs or {})


def _placed(index, device: torch.device):
    """``index`` with every tensor it holds on ``device`` (a shallow copy;
    the index itself when it is there already)."""
    here = getattr(index, "device", device)
    if torch.device(here) == device:
        return index
    out = copy.copy(index)
    for name, value in vars(index).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name, value.to(device))
    if "device" in vars(index):
        out.device = device
    return out


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
        stable_ids: bool = False,
        rewarm_after_mutation: bool = False,
        mutation_headroom: float = 0.25,
        pack_queries: bool = False,
        pack_max_segments: int = 16,
        group=None,
    ):
        """The index arguments are :func:`resolve_tier`'s; ``recall_target
        < 1`` is also the flat tier's approximate mode. ``stable_ids``:
        passages carry caller-assigned int64 ids that survive removals
        (FAISS ``IndexIDMap``): hits gain an ``id`` field, removals and
        filters take external ids, and adds accept explicit ids (else they
        continue from max + 1); off, ids are corpus positions with FAISS
        ``remove_ids`` renumbering. ``mutation_headroom``: when an add
        outgrows the index's storage, the new storage holds this fraction of
        extra rows (or slots) for later adds. ``rewarm_after_mutation``: a
        mutation replays the last :meth:`warmup` before it returns.
        ``pack_queries``: each group of up to ``query_batch_size`` queries is
        bin-packed into rows of ``max_query_length`` tokens, at most
        ``pack_max_segments`` queries a row (JAX ``service.py:983-1030``).
        ``group``: the data group the index is row-sharded over (module
        docstring)."""
        self.encoder = encoder
        self.max_query_length = max_query_length
        self.query_batch_size = query_batch_size
        self.recall_target = recall_target
        self.index_type, self.index_dtype, self.index_kwargs = resolve_tier(
            index_type, index_dtype, index_kwargs)
        self.group = group
        self.stable_ids = stable_ids
        self.pack_queries = pack_queries
        self.pack_max_segments = pack_max_segments
        self.rewarm_after_mutation = rewarm_after_mutation
        if mutation_headroom < 0.0:
            raise ValueError("mutation_headroom must be >= 0")
        self.mutation_headroom = float(mutation_headroom)
        # (index, corpus_texts, ext_ids) swap as one tuple: a query decorates
        # hit ids with the texts and external ids of the index it searched.
        # ext_ids maps corpus position -> external id (arange in positional
        # mode)
        self._state: tuple = (None, [], np.zeros(0, np.int64))
        # writers serialize (each HTTP request runs on its own thread): two
        # concurrent mutations would read the same tuple and the second swap
        # would erase the first; readers stay lock-free on the tuple
        self._mutate_lock = threading.Lock()
        self._warmup_spec: Optional[Dict] = None

    # ------------------------------------------------------------------
    def _approx_kwargs(self, overrides: Optional[Dict] = None) -> Dict:
        """Refine/IVF constructor kwargs: the service's recall_target is the
        build tune target (1.0 would ladder the tuner to its cap chasing
        exactness, so it defaults to 0.95), and ``index_dtype`` the row
        storage unless the kwargs name one. ``overrides`` carry tuned or
        structural knobs of one build (a reload or a rebuild after a
        mutation); each fills only a knob the caller left on 'auto' or
        unset, and none sticks to the service."""
        kwargs = dict(self.index_kwargs)
        for key, value in (overrides or {}).items():
            if kwargs.get(key, "auto") == "auto":
                kwargs[key] = value
        kwargs.setdefault(
            "recall_target", self.recall_target if self.recall_target < 1.0 else 0.95)
        kwargs.setdefault("store_dtype", self.index_dtype)
        return kwargs

    def _make_index(self, emb: torch.Tensor, n: int, overrides: Optional[Dict] = None, *,
                    constructor: bool = False):
        """The configured tier over ``emb`` [N_buf, D] on its device.
        ``constructor``: build as the JAX package's constructors (host
        numpy path: refine's PCA moment of the stored rows, flat's host int8
        rounding) rather than its ``from_sharded`` (device path)."""
        shard = {} if self.group is None else {"group": self.group}
        with torch.inference_mode():
            if self.index_type == "ivf":
                if self.group is not None and not constructor:
                    # this rank's shard; int8 scales as the one-process
                    # server's constructor rounds them
                    return IVFIPIndex.from_sharded(emb, n, times_reciprocal=False,
                                                   **self._approx_kwargs(overrides), **shard)
                return IVFIPIndex(emb, n_total=n, **self._approx_kwargs(overrides), **shard)
            if self.index_type == "refine":
                if constructor:
                    return RefineIPIndex(emb, n_total=n, **self._approx_kwargs(overrides),
                                         **shard)
                return RefineIPIndex.from_sharded(emb, n, **self._approx_kwargs(overrides),
                                                  **shard)
        kwargs = dict(self.index_kwargs, recall_target=self.recall_target,
                      dtype=(overrides or {}).get("dtype", self.index_dtype), **shard)
        if constructor:
            return FlatIPIndex(emb, n_total=n, **kwargs)
        return FlatIPIndex.from_sharded(emb, n, **kwargs)

    def build_index(
        self,
        corpus_texts: Sequence[str],
        *,
        max_passage_length: int = 512,
        batch_size: int = 256,
        ids=None,
    ) -> None:
        """Encode the corpus and build the index on the device from the
        embeddings there (they never visit the host). ``ids``: per-passage
        external int64 ids (``stable_ids`` mode), default 0..n-1."""
        if not corpus_texts:
            raise ValueError("cannot build an index over an empty corpus")
        self._require_stable_for(ids)
        ext_ids = self._validate_ids(ids, len(corpus_texts))
        t0 = time.perf_counter()
        if self.group is None:
            emb, n = self.encoder.encode_device(
                list(corpus_texts), batch_size=batch_size, max_length=max_passage_length)
        else:  # this rank's shard of the corpus
            emb, n = self.encoder.encode_shard(
                list(corpus_texts), mesh.group_size(self.group), mesh.group_index(self.group),
                batch_size=batch_size, max_length=max_passage_length)
        self._state = (self._make_index(emb, n), list(corpus_texts), ext_ids)
        logger.info("indexed %d passages in %.1fs", n, time.perf_counter() - t0)

    def load_index(self, embeddings, corpus_texts: Sequence[str],
                   overrides: Optional[Dict] = None, *, ids=None) -> None:
        """Build the index over a prebuilt fp32 embedding matrix (host numpy,
        e.g. an offline encode), placed on the encoder's device; the tier is
        built by its constructor, as the JAX service builds it.
        ``overrides``: tuned knobs to reuse for this build only
        (:meth:`_approx_kwargs`); ``ids``: external ids (``build_index``)."""
        emb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(self.encoder.device)
        self._state = (
            self._make_index(emb, int(emb.shape[0]), overrides, constructor=True),
            list(corpus_texts),
            self._validate_ids(ids, len(corpus_texts)),
        )

    def adopt_index(self, index, corpus_texts: Sequence[str], *, ids=None) -> None:
        """Serve an index built elsewhere (e.g. ``IVFIPIndex.from_chunk_fn``,
        whose fp32 corpus never existed whole), moved to the encoder's
        device: its rows must be the encoder's width and one per text."""
        dim = getattr(index, "dim", None)
        if dim is not None and dim != self.encoder.config.hidden_size:
            raise ValueError(
                f"index dim {dim} != encoder hidden {self.encoder.config.hidden_size}")
        if index.ntotal != len(corpus_texts):
            raise ValueError(
                f"index has {index.ntotal} rows, got {len(corpus_texts)} corpus texts")
        self._state = (_placed(index, self.encoder.device), list(corpus_texts),
                       self._validate_ids(ids, len(corpus_texts)))

    @property
    def index(self):
        return self._state[0]

    @property
    def corpus_texts(self) -> List[str]:
        return self._state[1]

    @property
    def passage_ids(self) -> np.ndarray:
        """External id per corpus position (positional mode: 0..n-1)."""
        return self._state[2]

    @property
    def ntotal(self) -> int:
        return self.index.ntotal if self.index is not None else 0

    def _require_stable_for(self, ids) -> None:
        """External ids need stable_ids mode: positional mode numbers
        passages 0..n-1, and a map would make later mutations disagree."""
        if ids is not None and not self.stable_ids:
            raise ValueError(
                "external ids require stable_ids mode (RetrievalService("
                "stable_ids=True) / serve --stable_ids); positional mode "
                "numbers passages 0..n-1")

    @staticmethod
    def _validate_ids(ids, n: int) -> np.ndarray:
        """Per-passage external ids as int64: default arange, unique, one
        per passage."""
        if ids is None:
            return np.arange(n, dtype=np.int64)
        ext = np.asarray(ids, np.int64).reshape(-1)
        if ext.size != n:
            raise ValueError(f"ids must match the corpus: {n} passages, {ext.size} ids")
        if np.unique(ext).size != ext.size:
            raise ValueError("ids must be unique")
        return ext

    # ------------------------------------------------------------------
    def add_passages(self, texts: Sequence[str], *, max_passage_length: int = 512,
                     batch_size: int = 256, ids=None) -> None:
        """Append passages to the built index (FAISS ``add``; with ``ids``,
        ``add_with_ids``). The new texts are encoded on the device and the
        index appends them there (``append_sharded``): stored rows, codes,
        trained parts and tuned knobs stay as they are, and the new passages
        take the next corpus positions. ``ids``: external ids of the new
        passages (none may be live); default max(live) + 1 onwards."""
        self._require_stable_for(ids)
        with self._mutate_lock:
            index, old_texts, old_ext = self._state
            if index is None:
                raise RuntimeError("no index built; call build_index first")
            if ids is None:
                start = int(old_ext.max()) + 1 if old_ext.size else 0
                new_ext = np.arange(start, start + len(texts), dtype=np.int64)
            else:
                new_ext = self._validate_ids(ids, len(texts))
                clash = np.intersect1d(new_ext, old_ext)
                if clash.size:
                    raise ValueError(f"ids already present: {clash[:8].tolist()}")
            texts_all = old_texts + list(texts)
            ids_all = np.concatenate([old_ext, new_ext])
            new_dev, n_new = self.encoder.encode_device(
                list(texts), batch_size=batch_size, max_length=max_passage_length)
            if hasattr(index, "append_sharded"):
                with torch.inference_mode():
                    new_index = index.append_sharded(new_dev, n_new,
                                                     headroom=self.mutation_headroom)
                self._state = (new_index, texts_all, ids_all)
            else:  # an adopted index without device mutation: rebuild
                merged = np.concatenate(
                    [self._stored_embeddings(index), new_dev.cpu().numpy()])
                self.load_index(merged, texts_all, self._rebuild_overrides(index),
                                ids=ids_all if self.stable_ids else None)
        logger.info("added %d passages (index now %d)", len(texts), self.ntotal)
        self._post_mutation()

    def remove_passages(self, ids: Sequence[int]) -> int:
        """Drop passages (FAISS ``remove_ids``); returns how many went.

        Positional mode: ids are corpus positions (out of range raises) and
        the survivors shift down. ``stable_ids`` mode: ids are external ids,
        unknown ones are ignored, and the survivors keep theirs. The index
        drops the rows on the device (``remove_rows``); the model never
        runs."""
        with self._mutate_lock:
            index, old_texts, old_ext = self._state
            if index is None:
                raise RuntimeError("no index built; call build_index first")
            n = len(old_texts)
            uniq = sorted({int(i) for i in ids})
            if not uniq:
                return 0
            if self.stable_ids:
                keep = ~np.isin(old_ext, np.asarray(uniq, np.int64))
                n_removed = int(n - keep.sum())
                if n_removed == 0:
                    return 0
            else:
                if uniq[0] < 0 or uniq[-1] >= n:
                    raise ValueError(
                        f"remove id out of range: corpus has {n} passages, got ids in "
                        f"[{uniq[0]}, {uniq[-1]}]")
                keep = np.ones(n, bool)
                keep[uniq] = False
                n_removed = len(uniq)
            if not keep.any():
                raise ValueError("cannot remove every passage; build a new index instead")
            kept_texts = [t for t, kept in zip(old_texts, keep) if kept]
            kept_ids = (old_ext[keep] if self.stable_ids
                        else np.arange(int(keep.sum()), dtype=np.int64))
            if hasattr(index, "remove_rows"):
                with torch.inference_mode():
                    new_index = index.remove_rows(np.nonzero(~keep)[0])
                self._state = (new_index, kept_texts, kept_ids)
            else:
                self.load_index(self._stored_embeddings(index)[keep], kept_texts,
                                self._rebuild_overrides(index),
                                ids=kept_ids if self.stable_ids else None)
        logger.info("removed %d passages (index now %d)", n_removed, self.ntotal)
        self._post_mutation()
        return n_removed

    @staticmethod
    def _stored_embeddings(index) -> np.ndarray:
        """An index's stored rows decoded to host fp32, for the rebuild of
        an index without device mutation (none of the built-in tiers)."""
        return index.reconstruct(np.arange(index.ntotal))

    @staticmethod
    def _rebuild_overrides(index) -> Dict:
        """Tuned and structural knobs a rebuild must carry from the live
        index: re-tuning on every mutation would stall serving, and codec
        knobs exist only on the index after a reload."""
        if isinstance(index, RefineIPIndex):
            return {"candidates": index.candidates, "reduced_dim": index.reduced_dim,
                    "store_dtype": index.store_dtype}
        if isinstance(index, IVFIPIndex):
            return {"nprobe": index.nprobe, "n_clusters": index.n_clusters,
                    "pq_m": index.pq_m, "pq_rotate": index.pq_rotate,
                    "reduced_dim": index.reduced_dim, "candidates": index.candidates,
                    "store_dtype": index.store_dtype}
        return {"dtype": getattr(index, "dtype", torch.float32)}

    def _post_mutation(self) -> None:
        """``rewarm_after_mutation``: replay the last warmup inside the
        mutation call, so the next request finds the new storage's kernels
        and GEMM plans warm."""
        if self.rewarm_after_mutation and self._warmup_spec is not None:
            t0 = time.perf_counter()
            self.warmup(**self._warmup_spec)
            logger.info("re-warmed serving after mutation in %.2fs",
                        time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def save_index(self, path: str) -> None:
        """Persist the built index and its passages (``index/io.py``'s
        format, FAISS ``write_index``): a restart skips the corpus encode
        and the whole build, and restores the storage bit-equal. Written
        through a temp file and an atomic rename."""
        index, texts, ext_ids = self._state
        if index is None:
            raise RuntimeError("no index built; call build_index first")
        state = index_io.index_state(index)
        state["corpus_texts"] = np.asarray(texts, dtype=object)
        state["corpus_ext_ids"] = ext_ids
        index_io.save_state(state, path, self.group)
        logger.info("saved index (%d passages) to %s", index.ntotal, path)

    def load_index_file(self, path: str) -> None:
        """Restore a file written by :meth:`save_index` (of either package)
        onto the encoder's device, or rebuild from the JAX service's legacy
        format (raw embeddings and tuned knobs)."""
        with np.load(path, allow_pickle=True) as data:
            self._load_index_data(data, path)

    def _check_loaded_ids(self, ext: np.ndarray, n: int, path: str) -> None:
        """A positional service must not install a stable external-id map
        (its next add would extend a map it cannot have). Positional saves
        carry 0..n-1, which loads either way."""
        if not self.stable_ids and not np.array_equal(ext, np.arange(n, dtype=np.int64)):
            raise ValueError(
                f"{path} carries stable external ids but the service runs in "
                "positional mode — restart with --stable_ids (or rebuild from the "
                "corpus)")

    def _load_index_data(self, data, path: str) -> None:
        if index_io.is_index_state(data):
            # structural restore: placement, no rebuild. The kind must be the
            # configured one, or the next mutation would rebuild another tier
            kind = index_io.state_kind(data)
            if kind != self.index_type:
                raise ValueError(
                    f"{path} holds a {kind!r} index but the service is configured "
                    f"index_type={self.index_type!r} — restart with --index_type "
                    f"{kind} (or rebuild from the corpus)")
            texts = [str(t) for t in data["corpus_texts"]]
            ext = (np.asarray(data["corpus_ext_ids"], np.int64)
                   if "corpus_ext_ids" in data else np.arange(len(texts), dtype=np.int64))
            self._check_loaded_ids(ext, len(texts), path)
            index = index_io.index_from_state(data, device=self.encoder.device,
                                              group=self.group)
            self._state = (index, texts, ext)
            logger.info("restored %s index (%d passages) from %s — no rebuild", kind,
                        self.ntotal, path)
            return
        # legacy format: raw embeddings and tuned knobs; rebuild, reusing a
        # knob where the configuration still allows it
        overrides = {}
        if self.index_type == "ivf" and "ivf_nprobe" in data:
            saved_k = int(data["ivf_n_clusters"])
            if self.index_kwargs.get("n_clusters", "auto") in ("auto", saved_k):
                overrides = {"nprobe": int(data["ivf_nprobe"]), "n_clusters": saved_k}
        if self.index_type == "refine" and "refine_candidates" in data:
            saved_dim = int(data["refine_reduced_dim"])
            if self.index_kwargs.get("reduced_dim", saved_dim) == saved_dim:
                overrides = {"candidates": int(data["refine_candidates"]),
                             "reduced_dim": saved_dim}
        texts = [str(t) for t in data["corpus_texts"]]
        ids = (np.asarray(data["corpus_ext_ids"], np.int64)
               if "corpus_ext_ids" in data else None)
        if ids is not None:
            self._check_loaded_ids(ids, len(texts), path)
            if not self.stable_ids:
                ids = None  # checked equal to arange
        self.load_index(data["embeddings"], texts, overrides, ids=ids)
        logger.info("loaded index (%d passages) from %s", self.ntotal, path)

    # ------------------------------------------------------------------
    def _selector_kwargs(self, allowed_ids, disallowed_ids, ext_ids) -> Dict:
        """Per-request filters as the tiers' selector kwargs (FAISS
        ``SearchParameters(sel=...)``): external ids under stable_ids
        (unknown ids never match), corpus positions otherwise (range-checked
        by the mask)."""
        if allowed_ids is None and disallowed_ids is None:
            return {}
        if allowed_ids is not None and disallowed_ids is not None:
            raise ValueError("give at most one of allowed_ids / disallowed_ids")
        if self.stable_ids:
            ids = np.asarray(allowed_ids if allowed_ids is not None else disallowed_ids,
                             np.int64).reshape(-1)
            mask = np.isin(np.asarray(ext_ids, np.int64), ids)
            if disallowed_ids is not None:
                mask = ~mask
            return {"selector": mask}
        if allowed_ids is not None:
            return {"allowed_ids": allowed_ids}
        return {"disallowed_ids": disallowed_ids}

    @staticmethod
    def _rows_bucket(rows: int) -> int:
        """Power-of-two packed row counts (JAX ``service.py:974``, one
        device): a group's rows round up, so few shapes recur."""
        b = 1
        while b < rows:
            b *= 2
        return b

    def _prepare_packed_queries(self, chunk: List[str]):
        """Tokenize and bin-pack one group of queries: (ids, segment ids
        [R, max_query_length], slot table [R, pack_max_segments], slots).
        The slot table maps segments to the group's request order, so
        result row i is request i; the slot block is ``query_batch_size``
        wide for every group, as the JAX service fixes it."""
        pad_id = self.encoder.config.pad_token_id or 0
        encoded = self.encoder.tokenizer(list(chunk), max_length=self.max_query_length,
                                         truncation=True)
        ids_list = [x or [pad_id] for x in encoded["input_ids"]]
        packed = pack_token_lists(ids_list, self.max_query_length, self.pack_max_segments,
                                  pad_id)
        pad_rows = self._rows_bucket(packed.n_rows) - packed.n_rows
        ids = np.pad(packed.input_ids, ((0, pad_rows), (0, 0)), constant_values=pad_id)
        segs = np.pad(packed.segment_ids, ((0, pad_rows), (0, 0)))
        slot_idx = np.pad(packed.text_index,
                          ((0, pad_rows), (0, self.pack_max_segments - packed.max_segments)),
                          constant_values=-1)
        slots = np.arange(self.query_batch_size, dtype=np.int32)
        return ids, segs, slot_idx, slots

    def search_texts(self, texts: List[str], k: int, nprobe: Optional[int] = None,
                     candidates: Optional[int] = None, *, allowed_ids=None,
                     disallowed_ids=None):
        """(scores fp32 [Q, k'], indices int64 [Q, k'], corpus texts,
        external ids) numpy, k' = min(k, ntotal), from one state snapshot.
        A filtered search's unfillable tail is -inf / -1."""
        index, corpus_texts, ext_ids = self._state
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
        sel_mask = build_selector_mask(
            index.ntotal, **self._selector_kwargs(allowed_ids, disallowed_ids, ext_ids))
        if sel_mask is not None:
            search_kw["sel"] = torch.from_numpy(sel_mask).to(index.device)
        k_eff = min(k, index.ntotal)
        scores, indices = [], []
        for lo in range(0, len(texts), self.query_batch_size):
            chunk = texts[lo : lo + self.query_batch_size]
            with torch.inference_mode():
                if self.pack_queries:
                    ids, segs, slot_idx, slots = self._prepare_packed_queries(chunk)
                    reps = self.encoder.embed_packed_batch(ids, segs, slot_idx, len(slots))
                    reps = reps[: len(chunk)]
                else:
                    batch = self.encoder.prepare_batch(chunk, len(chunk),
                                                       self.max_query_length)
                    reps = self.encoder.embed_batch(batch)
                s, i = index.search_tensor(reps, k_eff, **search_kw)
            scores.append(s.cpu().numpy())
            indices.append(i.cpu().numpy())
        if not scores:
            return (np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64),
                    corpus_texts, ext_ids)
        out_s, out_i = np.concatenate(scores), np.concatenate(indices)
        if sel_mask is not None:
            out_i = mask_filtered_misses(out_s, out_i)
        return out_s, out_i, corpus_texts, ext_ids

    def query(
        self,
        texts: Sequence[str] | str,
        k: int = 10,
        *,
        return_passages: bool = True,
        allowed_ids=None,
        disallowed_ids=None,
        nprobe: Optional[int] = None,
        candidates: Optional[int] = None,
    ) -> List[Dict] | Dict:
        """Top-k passages per query text; hits carry ``index`` (corpus
        position), ``score``, under stable_ids ``id`` (the external id) and,
        with ``return_passages``, ``passage``. ``allowed_ids`` /
        ``disallowed_ids`` restrict the search to a passage subset (external
        ids under stable_ids, positions otherwise); on IVF the probes stay
        the build's, as FAISS keeps them. ``nprobe`` (IVF) and
        ``candidates`` (refine and the IVF PCA hybrid) override the tuned
        knobs for this call (FAISS ``SearchParametersIVF``)."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        scores, indices, corpus_texts, ext_ids = self.search_texts(
            list(texts), k, nprobe, candidates, allowed_ids=allowed_ids,
            disallowed_ids=disallowed_ids)
        results = []
        for qi, text in enumerate(texts):
            hits = []
            for score, idx in zip(scores[qi], indices[qi]):
                if idx < 0:
                    # unreachable IVF slots and a filter's unfillable tail
                    # are -1 / -inf (FAISS); never surface them as hits
                    continue
                hit = {"index": int(idx), "score": float(score)}
                if self.stable_ids:
                    hit["id"] = int(ext_ids[int(idx)])
                if return_passages:
                    hit["passage"] = corpus_texts[int(idx)]
                hits.append(hit)
            results.append({"query": text, "hits": hits})
        return results[0] if single else results

    def warmup(self, k: int = 10) -> None:
        """One small pass: builds the kernels and starts cuBLAS before the
        first request (there is nothing to compile per shape). Sharded, a
        collective (``MultihostFrontend.warmup`` runs it on every rank)."""
        self._warmup_spec = {"k": k}
        self.query(["warm up"], k=k, return_passages=False)
