"""Two-stage approximate inner-product index on one device: PCA prefilter,
then an exact rerank (port of ``rankpo_tpu.index.refined.RefineIPIndex``,
the FAISS ``IndexPreTransform(PCAMatrix)`` + ``IndexRefineFlat`` analog).

Stage 1 scores every row in a PCA-projected d' << D space (bf16 projected
rows and query, one product with its result rounded to bf16, as the JAX
package asks for a bf16 result) and keeps each query's top C rows; stage 2
gathers those C full-width rows and reranks them at storage precision (fp32
rows: true fp32 products; bf16 rows: bf16 operands, fp32 sums). Both
stages' selections are the exact, tie-stable top-k of ``ops/topk.py``
(lowest index first): JAX's ``approx_max_k`` with ``aggregate_to_topk`` is
that exact top-k on the CPU, where the two packages are compared. The JAX
tier has no Pallas kernel, and neither does this one: its products are
torch matmuls.

The projection is the top ``reduced_dim`` eigenvectors of the uncentred
second moment of the rows (summed on the device in fp32, ``np.linalg.eigh``
on the host). ``candidates="auto"`` tunes C against an exact search at
storage precision over a seeded sample of corpus rows: analytic ranks of
each true hit in the projected ordering, then up to 3 verifying searches.

Contract: approximate; the hit set may miss true neighbours, the scores of
returned hits are exact at storage precision.

With ``group=`` the index is row-sharded over the data group in the flat
tier's layout (``index/flat.py`` ``RowShards``): each rank runs both stages
on its own shard with the shard's valid rows and id offset (JAX
``refined.py:680-700``), and the shards' top-k candidates merge by one
all-gather and a stable top-k. The second moment is summed over the
shards; the tuner counts each true hit's rank within its own shard (JAX
``_hit_shard_ranks``) and verifies with sharded searches, so it measures
the compound recall of the sharded index. Appends and removals keep the
global layout, as the flat tier's do.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.index.flat import (
    RowShards,
    _canonical_recon_ids,
    _chunked_row_gather,
    build_selector_mask,
    mask_filtered_misses,
    validate_append_args,
)
from rankpo_tpu_torch.index.ivf import _as_dtype, _bf16_bmm, _bf16_mm
from rankpo_tpu_torch.ops.topk import exact_topk, require_fp32_matmul

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")

TUNE_SAMPLE = 256
TUNE_K = 100
# rows per chunk of the second moment and the projection
_ROW_CHUNK = 1 << 16
# stage-1 comparisons ([sample, k, rows] booleans) per chunk of the tuner's
# rank count
_RANK_BUDGET = 1 << 21


def _check_store(store_dtype) -> torch.dtype:
    dtype = _as_dtype(store_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"store_dtype={store_dtype} must be a float type (rerank rows are "
            "stored as-is; int8 storage is a flat or IVF option)")
    return dtype


class RefineIPIndex(RowShards):
    """PCA-prefiltered, exactly reranked approximate IP index on one device,
    or row-sharded over ``group`` (module docstring).

    Storage: ``corpus`` [n_padded, D] in ``store_dtype`` (stage 2),
    ``corpus_low`` [n_padded, d'] bf16 (stage 1), ``proj`` [D, d'] fp32.
    Rows at or past ``n_total`` are zero padding (free append room).
    Sharded, ``corpus`` and ``corpus_low`` hold this rank's shard."""

    def __init__(
        self,
        embeddings,
        *,
        n_total: Optional[int] = None,
        reduced_dim: int = 256,
        candidates: Union[int, str] = "auto",
        recall_target: float = 0.95,
        store_dtype=torch.bfloat16,
        tune_sample: int = TUNE_SAMPLE,
        tune_k: int = TUNE_K,
        max_candidates: int = 4096,
        seed: int = 0,
        group=None,
    ):
        """Build from [N_buf, D] fp32 ``embeddings`` (a tensor keeps its
        device; numpy builds on the CPU): the second moment is taken of the
        STORED rows (at ``store_dtype``), as the JAX package's host
        constructor does; :meth:`from_sharded` takes it of the fp32 rows.
        With ``group``, ``embeddings`` is the whole corpus on every rank and
        each keeps its shard."""
        self._build(embeddings, n_total, reduced_dim, candidates, recall_target,
                    store_dtype, tune_sample, tune_k, max_candidates, seed,
                    moment_of_stored=True, group=group, whole=True)

    @classmethod
    def from_sharded(
        cls,
        embeddings,
        n_total: int,
        *,
        reduced_dim: int = 256,
        candidates: Union[int, str] = "auto",
        recall_target: float = 0.95,
        store_dtype=torch.bfloat16,
        tune_sample: int = TUNE_SAMPLE,
        tune_k: int = TUNE_K,
        max_candidates: int = 4096,
        seed: int = 0,
        group=None,
        moment_of_stored: bool = False,
    ) -> "RefineIPIndex":
        """Build from a device tensor [N_buf >= n_total, D] fp32 (the
        encoder's output) whose rows past ``n_total`` are padding: the
        second moment is taken of the fp32 rows, as the JAX package's
        device-resident constructor does (``moment_of_stored``: of the
        stored rows, as its host constructor does). With ``group``: this
        rank's shard (``encode_shard``'s layout) of a corpus of ``n_total``
        rows."""
        self = cls.__new__(cls)
        self._build(embeddings, n_total, reduced_dim, candidates, recall_target,
                    store_dtype, tune_sample, tune_k, max_candidates, seed,
                    moment_of_stored=moment_of_stored, group=group, whole=False)
        return self

    def _build(self, embeddings, n_total, reduced_dim, candidates, recall_target,
               store_dtype, tune_sample, tune_k, max_candidates, seed, *,
               moment_of_stored: bool, group, whole: bool):
        require_fp32_matmul()
        emb = torch.as_tensor(embeddings, dtype=torch.float32)
        if emb.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(emb.shape)}")
        self.dim = int(emb.shape[1])
        if group is None:
            whole = None
            self.n_padded = int(emb.shape[0])
            self.n_total = int(self.n_padded if n_total is None else n_total)
        elif whole:  # the whole corpus on every rank: keep the shard
            whole = emb
            self.n_total = int(emb.shape[0] if n_total is None else n_total)
            self._set_layout(group, mesh.padded_rows(self.n_total, mesh.group_size(group)))
            emb = torch.zeros((self.shard_rows, self.dim), device=emb.device)
            nv = self._local_valid()
            emb[:nv] = whole[self.shard_lo : self.shard_lo + nv]
        else:
            whole = None
            self.n_total = int(n_total)
            self._set_layout(group, int(emb.shape[0]) * mesh.group_size(group))
        rows_here = int(emb.shape[0])
        if not 0 < self.n_total <= self.n_padded:
            raise ValueError(f"n_total {self.n_total} outside (0, {self.n_padded}]")
        if not 0 < reduced_dim <= self.dim:
            raise ValueError(f"reduced_dim={reduced_dim} must be in (0, {self.dim}]")
        self.reduced_dim = int(reduced_dim)
        self.recall_target = float(recall_target)
        self.store_dtype = _check_store(store_dtype)
        self.device = emb.device
        n_valid = self._local_valid()
        if rows_here > n_valid:  # padding rows are zero rows
            emb = emb.clone()
            emb[n_valid:] = 0.0
        self.corpus = emb.to(self.store_dtype)
        moment_rows = self.corpus if moment_of_stored else emb
        cov = torch.zeros((self.dim, self.dim), dtype=torch.float32, device=self.device)
        for lo in range(0, rows_here, _ROW_CHUNK):
            rows = moment_rows[lo : lo + _ROW_CHUNK].to(torch.float32)
            cov += rows.T @ rows
        if self.group is not None:  # the shards' moments summed
            mesh.all_reduce_(cov, self.group)
        _, v = np.linalg.eigh(cov.cpu().numpy())  # ascending eigenvalues
        self.proj = torch.from_numpy(
            np.ascontiguousarray(v[:, -self.reduced_dim:], np.float32)).to(self.device)
        if self.group is not None:  # one basis on every rank, bit for bit
            mesh.broadcast_(self.proj, 0, self.group)
        self.corpus_low = torch.cat([
            (emb[lo : lo + _ROW_CHUNK] @ self.proj).to(torch.bfloat16)
            for lo in range(0, rows_here, _ROW_CHUNK)])
        if candidates == "auto":
            rng = np.random.default_rng(seed)
            sample_idx = rng.choice(self.n_total, size=min(tune_sample, self.n_total),
                                    replace=False)
            if whole is not None:
                sample = whole[torch.from_numpy(sample_idx).to(whole.device)].cpu().numpy()
            elif self.group is not None:
                sample = self._gather_rows(emb, sample_idx).cpu().numpy()
            else:
                sample = emb[torch.from_numpy(sample_idx).to(self.device)].cpu().numpy()
            self.candidates = self._tune_candidates(sample, tune_k, max_candidates)
        else:
            self.candidates = int(candidates)
            if self.candidates < 1:
                raise ValueError("candidates must be >= 1")

    # ------------------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.n_total

    def _query_low(self, queries: torch.Tensor) -> torch.Tensor:
        return (queries @ self.proj).to(torch.bfloat16)

    def _hit_ranks(self, sample: np.ndarray, ref_idx: np.ndarray) -> np.ndarray:
        """[S, k] rank of each true hit in its query's projected (fp32)
        ordering over all stored rows: the count of rows scoring strictly
        above it. The candidate stage at count C admits the rows of rank < C,
        so these ranks give recall(C) for every C. Sharded, the ordering is
        the hit's own shard's (each shard admits its own C)."""
        q_low = self._query_low(torch.from_numpy(sample).to(self.device))
        hits = torch.from_numpy(ref_idx.astype(np.int64)).to(self.device)
        rows = self.corpus_low.shape[0]
        if self.group is None:
            here = torch.ones(hits.shape, dtype=torch.bool, device=self.device)
        else:  # each hit's rank within its own shard, counted by its owner
            hits = hits - self.shard_lo
            here = (hits >= 0) & (hits < rows)
            hits = torch.where(here, hits, 0)
        hs = _bf16_bmm(self.corpus_low[hits], q_low[:, :, None])[..., 0]  # [S, k]
        counts = torch.zeros(hits.shape, dtype=torch.int64, device=self.device)
        chunk = max(128, min(rows, _RANK_BUDGET // max(len(sample), 1)))
        for lo in range(0, rows, chunk):
            s1 = _bf16_mm(q_low, self.corpus_low[lo : lo + chunk].T)  # [S, chunk]
            counts += (s1[:, None, :] > hs[:, :, None]).sum(dim=2)
        if self.group is not None:
            counts = torch.where(here, counts, 0)
            mesh.all_reduce_(counts, self.group)
        return counts.cpu().numpy()

    def _exact_stored(self, sample: np.ndarray, k: int) -> np.ndarray:
        """Ids [S, k] of the exact top-k over the stored rows at storage
        precision (fp32 products of the rows as stored): what a perfect
        candidate stage could recover. Chunk by chunk with a running
        tie-stable merge, so no fp32 copy of the corpus is made (the JAX
        package searches one); the hits are the same."""
        q = torch.from_numpy(np.ascontiguousarray(sample, np.float32)).to(self.device)
        best_s = torch.full((q.shape[0], 0), NEG_INF, device=self.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=self.device)
        n_local = self._local_valid()
        offset = self.shard_lo if self.group is not None else 0
        for lo in range(0, n_local, _ROW_CHUNK):
            hi = min(lo + _ROW_CHUNK, n_local)
            s = q @ self.corpus[lo:hi].to(torch.float32).T
            ids = torch.arange(lo + offset, hi + offset,
                               device=self.device).expand(q.shape[0], -1)
            cat_s, cat_i = torch.cat([best_s, s], dim=1), torch.cat([best_i, ids], dim=1)
            best_s, pos = exact_topk(cat_s, min(k, cat_s.shape[1]))
            best_i = torch.gather(cat_i, 1, pos)
        if self.group is not None:
            best_i = self._merge(best_s, best_i, k)[1]
        return best_i.cpu().numpy()

    def _tune_candidates(self, sample: np.ndarray, k: int, max_candidates: int) -> int:
        """Smallest C whose two-stage recall meets ``recall_target`` against
        the exact search at storage precision over the ``sample``
        pseudo-queries: analytic from the hit ranks, then verified with real
        searches and bumped a bounded number of times if short."""
        k = min(k, self.n_total)
        n_sample = len(sample)
        cap = min(max_candidates, self.n_total)
        ref_idx = self._exact_stored(sample, k)
        ref_sets = [set(row.tolist()) for row in ref_idx]
        need = self._hit_ranks(sample, ref_idx).ravel()
        required = int(np.ceil(self.recall_target * need.size))
        if required <= 0:
            c = k
        else:
            c = int(np.partition(need, required - 1)[required - 1]) + 1
        c = max(c, max(2 * k, 128) // 2)  # a floor for tiny ranks
        c = min(max(c, k), cap)
        logger.info("RefineIPIndex tune (analytic): C=%d predicted recall=%.4f "
                    "(target %.2f)", c, float((need < c).mean()), self.recall_target)
        for _ in range(3):
            _, idx = self.search(sample, k=k, candidates=c)
            recall = float(np.mean([len(set(idx[r].tolist()) & ref_sets[r]) / k
                                    for r in range(n_sample)]))
            logger.info("RefineIPIndex tune (verify): C=%d recall=%.4f (target %.2f)",
                        c, recall, self.recall_target)
            if recall >= self.recall_target or c >= cap:
                break
            c = min(max(c + 1, int(c * 1.5)), cap)
        else:
            logger.warning(
                "RefineIPIndex: recall below target %.2f at C=%d after bounded "
                "verification — the spectrum may be too flat for reduced_dim=%d "
                "(raise it or use FlatIPIndex)", self.recall_target, c, self.reduced_dim)
        return c

    # ------------------------------------------------------------------
    def search_tensor(self, queries: torch.Tensor, k: int,
                      candidates: Optional[int] = None, *,
                      sel: Optional[torch.Tensor] = None):
        """Device-side two-stage search: (scores fp32 [Q, k'], indices int64
        [Q, k']), k' = min(k, ntotal). ``sel``: bool [n_total] eligibility
        on the index's device, applied before the candidate pick and again
        to the candidates. Sharded: each shard's two stages (C and k
        capped at its rows), then the merge; a collective."""
        k = min(k, self.n_total)
        c_cand = max(int(candidates if candidates is not None else self.candidates), k)
        rows = self.corpus_low.shape[0]
        cc = min(c_cand, rows)
        q = queries.to(self.device, torch.float32)
        # stage 1: the product's result rounded to bf16, as JAX asks for it
        s1 = _bf16_mm(self._query_low(q), self.corpus_low.T).to(torch.bfloat16)
        s1 = s1.to(torch.float32)
        ok = torch.arange(rows, device=self.device) < self._local_valid()
        if sel is not None:
            ok &= self._local_mask(sel, self.device)
        s1 = torch.where(ok[None, :], s1, NEG_INF)
        _, cand = exact_topk(s1, cc)
        rows = self.corpus[cand]  # [Q, cc, D]
        if rows.dtype == torch.float32:
            s2 = torch.bmm(rows, q[:, :, None])[..., 0]
        else:
            s2 = _bf16_bmm(rows, q[:, :, None])[..., 0]
        # padding or ineligible rows reach the candidates only when fewer
        # than cc rows are eligible
        s2 = torch.where(ok[cand], s2, NEG_INF)
        top_s, pos = exact_topk(s2, min(k, cc))
        top_i = torch.gather(cand, 1, pos)
        if self.group is None:
            return top_s, top_i
        return self._merge(top_s, top_i + self.shard_lo, k)

    def search(
        self,
        queries,
        k: int = 100,
        batch_size: int = 256,
        candidates: Optional[int] = None,
        *,
        allowed_ids=None,
        disallowed_ids=None,
        selector=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched two-stage search from host queries: numpy fp32 scores and
        int32 indices [Q, k'] (FlatIPIndex's surface). ``candidates``
        overrides the tuned C for this call; ``allowed_ids`` /
        ``disallowed_ids`` / ``selector`` (at most one) filter the rows
        before the candidate pick; the unfillable tail is -inf / -1."""
        k = min(k, self.n_total)
        sel_mask = build_selector_mask(self.n_total, allowed_ids, disallowed_ids, selector)
        sel = None if sel_mask is None else torch.from_numpy(sel_mask).to(self.device)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size]).to(self.device)
            s, i = self.search_tensor(block, k, candidates, sel=sel)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        out_s, out_i = np.concatenate(scores), np.concatenate(indices)
        if sel_mask is not None:
            out_i = mask_filtered_misses(out_s, out_i)
        return out_s, out_i

    # ------------------------------------------------------------------
    # mutation: each returns a NEW index; the basis and C stay fixed
    def _clone_shell(self, n_total: int, n_padded: int) -> "RefineIPIndex":
        out = RefineIPIndex.__new__(RefineIPIndex)
        for name in ("dim", "reduced_dim", "recall_target", "store_dtype", "candidates",
                     "proj", "device"):
            setattr(out, name, getattr(self, name))
        out.n_total, out.n_padded = n_total, n_padded
        if self.group is not None:
            out._set_layout(self.group, n_padded)
        return out

    def append_sharded(self, new_rows, n_new: int, *,
                       headroom: float = 0.0) -> "RefineIPIndex":
        """Append fp32 rows [n_buf, D] (rows past ``n_new`` ignored; a
        tensor moves to the index's device). The PCA basis is fixed (FAISS
        ``IndexPreTransform.add``); new rows project through it. Rows that
        fit the padding keep the storage shapes; otherwise storage grows to
        ``(n_total + n_new) * (1 + headroom)`` rows."""
        rows = torch.as_tensor(new_rows, dtype=torch.float32)
        n_new = validate_append_args(rows, n_new, headroom, self.dim)
        fresh = rows[:n_new].to(self.device)
        n_old = self.n_total
        n_total = n_old + n_new
        n_padded = (self.n_padded if n_total <= self.n_padded
                    else int(np.ceil(n_total * (1.0 + headroom))))
        if self.group is not None:
            return self._append_shard(fresh, n_total, mesh.padded_rows(n_padded, self.dp))
        out = self._clone_shell(n_total, n_padded)
        out.corpus = self.corpus.new_zeros((n_padded, self.dim))
        out.corpus_low = self.corpus_low.new_zeros((n_padded, self.reduced_dim))
        out.corpus[:n_old] = self.corpus[:n_old]
        out.corpus_low[:n_old] = self.corpus_low[:n_old]
        out.corpus[n_old:n_total] = fresh.to(self.store_dtype)
        out.corpus_low[n_old:n_total] = (fresh @ self.proj).to(torch.bfloat16)
        return out

    def _append_shard(self, fresh: torch.Tensor, n_total: int, n_padded: int
                      ) -> "RefineIPIndex":
        """``append_sharded`` of a sharded index: ``fresh`` the new rows on
        every rank, each keeping those that land in its shard; a grown layout
        moves the rows whose shard changes."""
        n_old = self.n_total
        out = self._clone_shell(n_total, n_padded)
        with torch.inference_mode():
            if n_padded == self.n_padded:
                out.corpus, out.corpus_low = self.corpus.clone(), self.corpus_low.clone()
            else:
                src = np.arange(n_old)
                out.corpus = self._relayout(self.corpus, src, out.shard_rows)
                out.corpus_low = self._relayout(self.corpus_low, src, out.shard_rows)
            lo = max(out.shard_lo, n_old)
            hi = min(out.shard_lo + out.shard_rows, n_total)
            if hi > lo:
                new = fresh[lo - n_old : hi - n_old]
                out.corpus[lo - out.shard_lo : hi - out.shard_lo] = new.to(self.store_dtype)
                out.corpus_low[lo - out.shard_lo : hi - out.shard_lo] = (
                    (new @ self.proj).to(torch.bfloat16))
        return out

    def remove_rows(self, removed) -> "RefineIPIndex":
        """Drop rows by corpus position (FAISS ``remove_ids``: survivors
        shift down in order); the padded row count is kept, and the freed
        rows become append room."""
        removed = np.unique(np.asarray(removed, np.int64).reshape(-1))
        if removed.size == 0:
            return self
        if removed[0] < 0 or removed[-1] >= self.n_total:
            raise IndexError(
                f"remove ids must be in [0, {self.n_total}); got "
                f"[{removed[0]}, {removed[-1]}]")
        keep = np.ones(self.n_total, bool)
        keep[removed] = False
        keep_idx = torch.from_numpy(np.nonzero(keep)[0]).to(self.device)
        if keep_idx.numel() == 0:
            raise ValueError("cannot remove every row; build a new index")
        n_keep = int(keep_idx.numel())
        out = self._clone_shell(n_keep, self.n_padded)
        if self.group is not None:  # survivors keep the layout, shifted down
            src = np.nonzero(keep)[0]
            with torch.inference_mode():
                out.corpus = self._relayout(self.corpus, src, self.shard_rows)
                out.corpus_low = self._relayout(self.corpus_low, src, self.shard_rows)
            return out
        out.corpus = self.corpus.new_zeros((self.n_padded, self.dim))
        out.corpus_low = self.corpus_low.new_zeros((self.n_padded, self.reduced_dim))
        out.corpus[:n_keep] = self.corpus[keep_idx]
        out.corpus_low[:n_keep] = self.corpus_low[keep_idx]
        return out

    def reconstruct(self, ids) -> np.ndarray:
        """Stored rerank rows of corpus ids as fp32 (FAISS
        ``reconstruct_batch``), at storage precision."""
        ids = _canonical_recon_ids(ids, self.n_total)
        if ids.size == 0:
            return np.zeros((0, self.dim), np.float32)
        if self.group is not None:
            return self._gather_rows(self.corpus, ids).to(torch.float32).cpu().numpy()
        return _chunked_row_gather(lambda i: self.corpus[i].to(torch.float32), ids,
                                   self.device)
