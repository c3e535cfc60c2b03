"""Inverted-file (clustered) approximate inner-product index on one device
(port of ``rankpo_tpu.index.ivf.IVFIPIndex``: the FAISS ``IndexIVFFlat`` /
``IndexIVFPQ`` analog, single device).

Build, on the device the embeddings live on:

- spherical k-means (Lloyd): the assignment is a ``[rows, D] @ [D, K]``
  product of bf16-rounded operands with an fp32 result (JAX's
  ``preferred_element_type=float32``), argmax per row; the update sums each
  cluster's rows in fp32. Rows stream in chunks (bigger on the card than
  JAX's VMEM-sized ones: only the summation order changes);
- each row's top ``ASSIGN_CANDIDATES`` clusters, then the deterministic host
  fill ``_greedy_fill`` (numpy, verbatim from the JAX package) lays the rows
  out cluster-major as ``[K * capacity, D]`` with ``row_ids == -1`` marking
  empty slots;
- storage: fp32 or bf16 rows, int8 rows with a per-slot max-abs scale, or
  residual product-quantization codes (``pq_m`` bytes per slot, optionally
  after a random or OPQ rotation) in rows ``[slots, m]`` or transposed
  ``[m, slots]`` layout;
- ``nprobe`` tuned against ``recall_target``: analytic ranks from one exact
  search, then up to 3 verifying searches.

Search: the queries' top-``nprobe`` clusters by the bf16 centroid product,
then every probed slot scored by a hand-written kernel on the card
(``ops/ivf_gather.py`` for fp32/bf16 rows, ``ops/pq_adc.py`` for PQ codes;
the plain versions on a CPU tensor), empty slots masked, and a stable top-k
(ties to the lower position, as ``lax.top_k``). int8 rows take the JAX
package's own path without a kernel: gather, product, scale.

Every random draw is numpy's ``default_rng`` with the JAX package's seeds, so
both packages draw the same numbers. Not ported yet, each raising with its
ROADMAP.md item: the PCA hybrid (``reduced_dim``), ``balance_eta``,
``kmeans_split``, the streamed build (``from_chunk_fn``), mutation
(``append_sharded`` / ``remove_rows``), ``reconstruct``, selector filtering
and a mesh.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from rankpo_tpu_torch.ops.ivf_gather import probe_scores
from rankpo_tpu_torch.ops.pq_adc import PQ_K, pq_probe_scores, pq_probe_scores_t
from rankpo_tpu_torch.ops.topk import exact_topk, require_fp32_matmul

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")

TUNE_SAMPLE = 256
TUNE_K = 100
# pq_layout='auto' picks the transposed 'cols' codes above this many padded
# row-layout bytes (n_total * ceil(m/128)*128). The rule is the JAX package's,
# kept verbatim so that both packages choose the same layout from the same
# inputs; its threshold was set by a TPU tiling cost (ROADMAP.md Queue 1 item
# 4 lists it to re-measure on the card).
_COLS_AUTO_BYTES = 4 << 30
# score elements per k-means row chunk: the JAX package's VMEM-sized budget
# on the CPU, 1 GiB of fp32 scores on the card
_CHUNK_BUDGET = 1 << 22
_CHUNK_BUDGET_CUDA = 1 << 28
# device bytes one search batch's transients may take; search() shrinks the
# query batch to stay under it
_GATHER_BUDGET = 4 << 30
# slots per chunk of the storage placement and the PQ encode
_ENCODE_CHUNK = 8192

# candidate clusters per row for the greedy fill: overflow cascades to the
# 3rd..8th nearest clusters, which the query's probe set still covers
ASSIGN_CANDIDATES = 8

PQ_TRAIN_SAMPLE = 1 << 16  # residual rows the codebook Lloyd fits on
_OPQ_OUTER = 8  # OPQ alternations (Lloyd fit <-> Procrustes rotation)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}

_NOT_PORTED = "not ported to rankpo_tpu_torch yet (ROADMAP.md Queue 1 item 4, {})"


def _resolve_clusters(n_total: int, n_shards: int, requested) -> int:
    """Cluster count: FAISS's ~4*sqrt(N) rule of thumb, rounded UP to a
    multiple of the shard count so every shard owns whole clusters."""
    if requested == "auto":
        k = max(1, int(round(4.0 * math.sqrt(max(n_total, 1)))))
        k = min(k, max(n_total, 1))
    else:
        k = int(requested)
        if k < 1:
            raise ValueError("n_clusters must be >= 1")
    k = max(k, n_shards)
    k = -(-k // n_shards) * n_shards
    return k


def _resolve_capacity(n_total: int, k: int, slack: float,
                      multiple: int = 8) -> int:
    """Per-cluster slot count: mean fill x slack, rounded up to
    ``multiple``; total slots always cover the corpus."""
    cap = -(-max(n_total, 1) * slack // k)
    cap = max(int(cap), -(-max(n_total, 1) // k))
    return max(multiple, -(-int(cap) // multiple) * multiple)


def _chunk_rows(rows: int, k: int, budget: int = _CHUNK_BUDGET) -> int:
    """Row-chunk size for the streamed assignment/update products."""
    c = max(128, (budget // max(k + 1, 1)) // 8 * 8)
    return min(rows, c)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 tensor of x's bf16-rounded values: a product of two such tensors
    in fp32 has exact products and an fp32 sum (JAX's bf16 einsum with
    ``preferred_element_type=float32``; torch's bf16 matmul would round the
    result to bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` of the bf16-rounded operands: exact products summed in
    fp32. On the card one bf16 tensor-core GEMM with an fp32 output; on the
    CPU an fp32 product of the rounded values (the same contract)."""
    if a.is_cuda:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return _bf16(a) @ _bf16(b)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lloyd_body(corpus: torch.Tensor, centroids: torch.Tensor, *, n_iters: int,
                chunk: int, spherical: bool) -> torch.Tensor:
    """The Lloyd loop over fp32 rows ``corpus`` [N, D] from ``centroids``
    [K, D] (JAX ``_lloyd_body`` with ``balance_eta=0`` and ``split_r=0``).
    Empty clusters keep their previous centroid."""
    k, d = centroids.shape
    cents = centroids
    for _ in range(n_iters):
        cb_t = cents.T
        sums = torch.zeros((k, d), dtype=torch.float32, device=cents.device)
        counts = torch.zeros(k, dtype=torch.float32, device=cents.device)
        for lo in range(0, corpus.shape[0], chunk):
            rows_b = _bf16(corpus[lo : lo + chunk])
            assign = torch.argmax(_bf16_mm(rows_b, cb_t), dim=1)
            sums.index_add_(0, assign, rows_b)
            counts += torch.bincount(assign, minlength=k).to(torch.float32)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        new = torch.where((counts > 0.0)[:, None], new, cents)
        if spherical:
            norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
            new = new / torch.clamp_min(norm, 1e-12)
        cents = new
    return cents


def _assign_top2_body(corpus: torch.Tensor, centroids: torch.Tensor, *,
                      chunk: int, n_cand: int = 2) -> torch.Tensor:
    """Per-row top-``n_cand`` nearest centroids [N, n_cand] int32, ties to
    the lower cluster id; fewer clusters than ``n_cand`` repeat the last."""
    k = centroids.shape[0]
    take = min(n_cand, k)
    cb_t = centroids.T
    out = torch.empty((corpus.shape[0], n_cand), dtype=torch.int32,
                      device=corpus.device)
    for lo in range(0, corpus.shape[0], chunk):
        _, topc = exact_topk(_bf16_mm(corpus[lo : lo + chunk], cb_t), take)
        if take < n_cand:
            topc = torch.cat([topc] + [topc[:, -1:]] * (n_cand - take), dim=1)
        out[lo : lo + chunk] = topc.to(torch.int32)
    return out


# ----------------------------------------------------------------------
# product quantization (residual PQ, FAISS IndexIVFPQ analog)


def _rotate_rows(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rows rotated by the orthogonal [D, D] ``rot`` (``x @ rot``) in fp32."""
    return x.to(torch.float32) @ rot


def _pq_lloyd_body(sample_sub: torch.Tensor, codebooks: torch.Tensor, *,
                   n_iters: int, chunk: int) -> torch.Tensor:
    """Euclidean Lloyd over all ``m`` subvector spaces at once: ``sample_sub``
    [S, m, ds] fp32, ``codebooks`` [m, k, ds]. Assignment is
    ``argmax x.c - ||c||^2/2`` on bf16-rounded operands; empty codes keep
    their previous centroid."""
    s_rows, m, ds = sample_sub.shape
    k = codebooks.shape[1]
    dev = codebooks.device
    offsets = torch.arange(m, device=dev)[:, None] * k
    cb = codebooks
    for _ in range(n_iters):
        cbb_t = _bf16(cb).transpose(1, 2)  # [m, ds, k]
        half = 0.5 * torch.sum(cb * cb, dim=-1)  # [m, k]
        sums = torch.zeros((m * k, ds), dtype=torch.float32, device=dev)
        counts = torch.zeros(m * k, dtype=torch.float32, device=dev)
        for lo in range(0, s_rows, chunk):
            xb = _bf16(sample_sub[lo : lo + chunk]).transpose(0, 1)  # [m, c, ds]
            scores = torch.bmm(xb, cbb_t) - half[:, None, :]
            flat = (torch.argmax(scores, dim=-1) + offsets).reshape(-1)
            sums.index_add_(0, flat, xb.reshape(-1, ds))
            counts += torch.bincount(flat, minlength=m * k).to(torch.float32)
        sums = sums.view(m, k, ds)
        counts = counts.view(m, k)
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        cb = torch.where((counts > 0.0)[..., None], new, cb)
    return cb


def _pq_encode_block(residuals: torch.Tensor, codebooks: torch.Tensor,
                     rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, D] fp32 residuals -> [R, m] uint8 codes (argmin L2 per subvector,
    as the same product-minus-half-norm the trainer uses). ``rot``
    pre-rotates the residuals (codes store the ROTATED residual)."""
    if rot is not None:
        residuals = _rotate_rows(residuals, rot)
    m, k, ds = codebooks.shape
    x = _bf16(residuals.reshape(-1, m, ds)).transpose(0, 1)  # [m, R, ds]
    cb = codebooks.to(torch.float32)
    half = 0.5 * torch.sum(cb * cb, dim=-1)
    scores = torch.bmm(x, _bf16(cb).transpose(1, 2)) - half[:, None, :]
    return torch.argmax(scores, dim=-1).T.to(torch.uint8)


def _pq_reconstruct(codes: torch.Tensor, codebooks_flat: torch.Tensor, m: int,
                    ds: int) -> torch.Tensor:
    """[..., m] uint8 codes -> [..., m*ds] rows from ``codebooks_flat``
    [m*256, ds] (subvector blocks are contiguous)."""
    flat = codes.long() + torch.arange(m, device=codes.device) * PQ_K
    return codebooks_flat[flat].reshape(codes.shape[:-1] + (m * ds,))


def _quantize_rows_int8(rows: torch.Tensor):
    """Symmetric per-row max-abs int8 codes and fp32 scales (the JAX
    package's scheme; zero rows get scale 1e-12 and zero codes)."""
    rows = rows.to(torch.float32)
    scale = torch.clamp_min(rows.abs().amax(dim=1) / 127.0, 1e-12)
    codes = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def _greedy_fill(cand: np.ndarray, n_total: int, k: int, capacity: int
                 ) -> np.ndarray:
    """Place every row into a cluster slot: nearest candidate first, then
    the 2nd..C-th nearest (``cand`` columns, C = ASSIGN_CANDIDATES at
    build), then spill into any free slot. Vectorized (sort + run-rank);
    returns ``row_ids`` of shape [k * capacity] with -1 for empty slots.
    Deterministic — multi-process builds run it identically on every
    host."""
    fill = np.zeros(k, np.int64)
    row_ids = np.full(k * capacity, -1, np.int32)
    remaining = np.arange(n_total, dtype=np.int64)
    for choice in range(cand.shape[1]):
        if len(remaining) == 0:
            break
        c = cand[remaining, choice].astype(np.int64)
        order = np.argsort(c, kind="stable")
        cs = c[order]
        # rank within each equal-cluster run (cs is sorted)
        rank = np.arange(len(cs)) - np.searchsorted(cs, cs, side="left")
        pos = rank + fill[cs]
        ok = pos < capacity
        row_ids[cs[ok] * capacity + pos[ok]] = remaining[order[ok]]
        fill += np.bincount(cs[ok], minlength=k)
        remaining = remaining[order[~ok]]
    if len(remaining):
        free = (capacity - fill).astype(np.int64)
        open_clusters = np.nonzero(free)[0]
        slot_cluster = np.repeat(open_clusters, free[open_clusters])
        slot_pos = np.concatenate(
            [np.arange(fill[c], capacity) for c in open_clusters]
        )
        take = slice(0, len(remaining))
        row_ids[slot_cluster[take] * capacity + slot_pos[take]] = remaining
        logger.info(
            "IVFIPIndex: %d rows (%.2f%%) spilled outside their top-%d "
            "clusters (capacity %d, slack exhausted)",
            len(remaining), 100.0 * len(remaining) / max(n_total, 1),
            cand.shape[1], capacity,
        )
    return row_ids


def _as_dtype(store_dtype) -> torch.dtype:
    if isinstance(store_dtype, torch.dtype):
        return store_dtype
    name = str(store_dtype)
    if name not in _DTYPES:
        raise ValueError(f"store_dtype={store_dtype} must be float32/bfloat16/int8")
    return _DTYPES[name]


class IVFIPIndex:
    """Inverted-file inner-product index on one device.

    ``embeddings``: [N_buf, D] tensor (the index is built on, and stays on,
    its device) or numpy array (built on the CPU); rows at or past
    ``n_total`` (default N_buf) are padding and never indexed.

    Storage: ``corpus`` — cluster-major rows ``[K * capacity, D]`` in
    ``store_dtype`` (fp32, bf16, or int8 with ``slot_scale``), or PQ codes
    (``pq_m``) ``[slots, m]`` / ``[m, slots]`` uint8 with bf16 ``codebooks``
    [m*256, D/m] (and an fp32 ``rotation`` for ``pq_rotate``); ``row_ids``
    [K * capacity] int32 (-1 = empty slot); ``centroids`` [K, D] fp32.
    Contract: approximate (the hit set may miss true neighbours); scores are
    exact at storage precision (int8: against the quantized rows; PQ: ADC
    approximations); a query whose probed clusters hold fewer than k rows
    pads with index -1 / score -inf."""

    def __init__(
        self,
        embeddings,
        *,
        n_total: Optional[int] = None,
        n_clusters: Union[int, str] = "auto",
        nprobe: Union[int, str] = "auto",
        recall_target: float = 0.95,
        store_dtype=torch.bfloat16,
        kmeans_iters: int = 10,
        capacity_slack: float = 1.3,
        spherical: bool = True,
        balance_eta: float = 0.0,
        kmeans_split: int = 0,
        reduced_dim: Optional[int] = None,
        candidates: Union[int, str] = "auto",
        pq_m: Optional[int] = None,
        pq_iters: int = 25,
        pq_rotate: str = "none",
        pq_layout: str = "auto",
        tune_sample: int = TUNE_SAMPLE,
        tune_k: int = TUNE_K,
        max_nprobe: Optional[int] = None,
        seed: int = 0,
        mesh=None,
    ):
        require_fp32_matmul()
        for name, value, off, item in (
            ("mesh", mesh, None, "multi-card IVF"),
            ("balance_eta", balance_eta, 0.0, "balance_eta"),
            ("kmeans_split", kmeans_split, 0, "kmeans_split"),
            ("reduced_dim", reduced_dim, None, "the PCA hybrid"),
        ):
            if value != off:
                raise NotImplementedError(
                    f"IVFIPIndex {name}={value!r}: " + _NOT_PORTED.format(item))
        # a tensor keeps its device; a numpy array becomes a CPU tensor
        corpus = torch.as_tensor(embeddings, dtype=torch.float32)
        if corpus.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(corpus.shape)}")
        self.n_total = int(corpus.shape[0] if n_total is None else n_total)
        if self.n_total < 1:
            raise ValueError("IVFIPIndex needs a non-empty corpus")
        if self.n_total > corpus.shape[0]:
            raise ValueError(f"n_total {self.n_total} > {corpus.shape[0]} rows")
        corpus = corpus[: self.n_total]
        self.device = corpus.device
        self.dim = int(corpus.shape[1])
        self._set_store(store_dtype)
        if capacity_slack < 1.0:
            raise ValueError("capacity_slack must be >= 1.0")
        self.recall_target = float(recall_target)
        self.spherical = bool(spherical)
        self._set_hybrid(candidates)
        self._set_pq(pq_m, pq_iters, pq_rotate, pq_layout)
        self.n_clusters = _resolve_clusters(self.n_total, 1, n_clusters)
        self.capacity = _resolve_capacity(
            self.n_total, self.n_clusters, capacity_slack,
            multiple=self._capacity_multiple(),
        )
        self.build_seconds = {}

        # --- train: k-means on the device ---
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        init_idx = rng.choice(
            self.n_total, size=self.n_clusters,
            replace=self.n_clusters > self.n_total,
        )
        init = corpus[torch.from_numpy(init_idx).to(self.device)].cpu().numpy()
        if self.spherical:
            init = init / np.maximum(
                np.linalg.norm(init, axis=1, keepdims=True), 1e-12
            )
        cand = self._train_and_assign(corpus, init, kmeans_iters)
        t1 = time.perf_counter()

        # --- layout: greedy fill on the host ---
        row_ids = _greedy_fill(cand, self.n_total, self.n_clusters, self.capacity)
        self._set_layout_maps(row_ids)
        self.row_ids = torch.from_numpy(row_ids).to(self.device)
        t2 = time.perf_counter()

        # --- storage: rows (or PQ codes) gathered cluster-major on the device
        self._place_storage(corpus, row_ids, seed)
        _sync(self.device)
        t3 = time.perf_counter()

        self._finish_tuning(
            nprobe, max_nprobe, tune_sample, tune_k, seed,
            sample_fn=lambda idx: corpus[torch.from_numpy(idx).to(self.device)]
            .cpu().numpy(),
        )
        t4 = time.perf_counter()
        self.build_seconds.update(kmeans=t1 - t0, fill=t2 - t1, storage=t3 - t2,
                                  tune=t4 - t3)
        logger.info(
            "IVFIPIndex: %d rows, K %d, capacity %d, nprobe %d; build %s",
            self.n_total, self.n_clusters, self.capacity, self.nprobe,
            {k: round(v, 3) for k, v in self.build_seconds.items()},
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_chunk_fn(cls, *args, **kwargs):
        raise NotImplementedError(
            "IVFIPIndex.from_chunk_fn: " + _NOT_PORTED.format("the streamed build"))

    def append_sharded(self, *args, **kwargs):
        raise NotImplementedError(
            "IVFIPIndex.append_sharded: " + _NOT_PORTED.format("mutation"))

    def remove_rows(self, *args, **kwargs):
        raise NotImplementedError(
            "IVFIPIndex.remove_rows: " + _NOT_PORTED.format("mutation"))

    def reconstruct(self, ids):
        raise NotImplementedError(
            "IVFIPIndex.reconstruct: " + _NOT_PORTED.format("reconstruct"))

    # ------------------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.n_total

    @property
    def _pq_cols(self) -> bool:
        """True when PQ codes are stored transposed ``[m, slots]``."""
        return self.pq_m is not None and self.pq_layout == "cols"

    def _capacity_multiple(self) -> int:
        """Slot rounding, kept from the JAX package (the TPU's tilings: 8 for
        rows, 64 for PQ rows, 128 for transposed PQ) so that both packages
        build the same layout and read each other's files; the port's
        kernels take any capacity (ROADMAP.md lists it to re-measure)."""
        if self.pq_m is None:
            return 8
        return 128 if self.pq_layout == "cols" else 64

    def _set_store(self, store_dtype):
        """fp32/bf16 rows score at storage precision; int8 quantizes each
        slot's row symmetrically to its max-abs, the scale applied to the
        fp32 products."""
        dtype = _as_dtype(store_dtype)
        if dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"store_dtype={store_dtype} must be float32/bfloat16/int8")
        self.quantized = dtype == torch.int8
        self.store_dtype = dtype

    def _set_hybrid(self, candidates):
        """The PCA hybrid is not ported: ``reduced_dim`` is always None here;
        ``candidates`` is validated and kept for the file format."""
        self.reduced_dim = None
        if candidates != "auto":
            if int(candidates) < 1:
                raise ValueError("candidates must be >= 1")
            candidates = int(candidates)
        self.candidates = candidates

    def _set_pq(self, pq_m, pq_iters, pq_rotate="none", pq_layout="auto"):
        """Validate the product-quantization knobs (residual PQ: ``pq_m``
        uint8 codes per slot into per-subvector 256-entry codebooks trained
        on assignment residuals). ``pq_rotate``: 'random' (seeded QR) or
        'opq' (rotation trained against the codec) pre-rotates residuals;
        ``pq_layout``: 'rows' ``[slots, m]``, 'cols' ``[m, slots]``, or
        'auto' (the JAX package's rule)."""
        self.codebooks = None
        self._codebooks_host = None
        self.rotation = None
        self._rotation_host = None
        if pq_rotate not in ("none", "random", "opq"):
            raise ValueError(
                f"pq_rotate={pq_rotate!r} must be 'none', 'random' or 'opq'"
            )
        self.pq_rotate = pq_rotate
        if pq_layout not in ("auto", "rows", "cols"):
            raise ValueError(
                f"pq_layout={pq_layout!r} must be 'auto', 'rows' or 'cols'"
            )
        if pq_m is None:
            if pq_rotate != "none":
                raise ValueError("pq_rotate requires pq_m")
            self.pq_m = None
            self.pq_iters = 0
            self.pq_layout = None
            return
        m = int(pq_m)
        if m < 1 or self.dim % m:
            raise ValueError(
                f"pq_m={pq_m} must be a positive divisor of dim={self.dim}"
            )
        if self.quantized:
            raise ValueError(
                "pq_m and int8 store_dtype are exclusive storage codecs — "
                "pick one"
            )
        self.pq_m = m
        self.pq_iters = max(1, int(pq_iters))
        if pq_layout == "auto":
            pad_lanes = -(-m // 128) * 128  # rows layout pads m to this
            pq_layout = (
                "cols"
                if (
                    m % 32 == 0
                    and pad_lanes > m  # m x128 already tiles rows free
                    and float(self.n_total) * pad_lanes > _COLS_AUTO_BYTES
                )
                else "rows"
            )
        if pq_layout == "cols" and m % 32 != 0:
            raise ValueError(
                "pq_layout='cols' needs pq_m % 32 == 0 (int8 sublane "
                f"packing), got pq_m={m}"
            )
        self.pq_layout = pq_layout

    def _set_centroids(self, centroids: torch.Tensor) -> None:
        self.centroids = centroids
        self._centroids_host = centroids.cpu().numpy().astype(np.float32, copy=False)

    def _train_and_assign(self, corpus: torch.Tensor, init_centroids: np.ndarray,
                          kmeans_iters) -> np.ndarray:
        """The Lloyd loop and the top-``ASSIGN_CANDIDATES`` pass; sets the
        centroids and returns host [N, C] candidate cluster ids."""
        budget = _CHUNK_BUDGET_CUDA if corpus.is_cuda else _CHUNK_BUDGET
        chunk = _chunk_rows(corpus.shape[0], self.n_clusters, budget)
        cents = _lloyd_body(
            corpus, torch.from_numpy(init_centroids).to(self.device),
            n_iters=max(0, int(kmeans_iters)), chunk=chunk,
            spherical=self.spherical,
        )
        cand = _assign_top2_body(corpus, cents, chunk=chunk,
                                 n_cand=ASSIGN_CANDIDATES)
        self._set_centroids(cents)
        return cand.cpu().numpy()

    def _set_layout_maps(self, row_ids: np.ndarray):
        """Host-side row -> cluster / slot maps, kept for the analytic nprobe
        tuner (recall(p) follows from each true hit's cluster probe-rank)."""
        row_ids = np.asarray(row_ids, np.int32)
        self._row_ids_host = row_ids
        cluster = np.zeros(self.n_total, np.int32)
        filled = np.nonzero(row_ids >= 0)[0]
        cluster[row_ids[filled]] = (filled // self.capacity).astype(np.int32)
        self._cluster_of_row = cluster
        slot = np.full(self.n_total, -1, np.int64)
        slot[row_ids[filled]] = filled
        self._slot_of_row = slot

    def _place_storage(self, corpus: torch.Tensor, row_ids: np.ndarray, seed: int):
        """Cluster-major storage gathered from ``corpus`` chunk by chunk (no
        fp32 copy of the whole layout); empty slots hold zero rows."""
        dev = self.device
        perm = torch.from_numpy(np.clip(row_ids, 0, None).astype(np.int64)).to(dev)
        valid = torch.from_numpy(row_ids >= 0).to(dev)
        if self.pq_m is not None:
            self._train_pq_and_encode(corpus, perm, valid, row_ids, seed)
            return
        n_slots = len(row_ids)
        out = torch.empty((n_slots, self.dim), dtype=self.store_dtype, device=dev)
        scale = (torch.empty(n_slots, dtype=torch.float32, device=dev)
                 if self.quantized else None)
        for lo in range(0, n_slots, _ENCODE_CHUNK):
            sl = slice(lo, lo + _ENCODE_CHUNK)
            rows = torch.where(valid[sl, None], corpus[perm[sl]], 0.0)
            if self.quantized:
                out[sl], scale[sl] = _quantize_rows_int8(rows)
            else:
                out[sl] = rows.to(self.store_dtype)
        self.corpus = out
        self.slot_scale = scale

    def _train_pq_and_encode(self, corpus, perm, valid, row_ids, seed: int):
        """Fit the residual codebooks on a sample of the actual slot
        residuals (spilled rows train and encode against the cluster they
        landed in), then encode every slot; empty slots encode a zero
        residual."""
        m = self.pq_m
        cap = self.capacity
        dev = self.device
        t0 = time.perf_counter()
        sample_slots = torch.from_numpy(self._pq_sample_slot_ids(row_ids, seed)).to(dev)
        sample = corpus[perm[sample_slots]] - self.centroids[sample_slots // cap]
        self._fit_pq_codebooks(sample, seed)
        del sample
        t1 = time.perf_counter()
        cb = torch.from_numpy(self._codebooks_host).to(dev)
        n_slots = len(row_ids)
        codes = torch.empty((m, n_slots) if self._pq_cols else (n_slots, m),
                            dtype=torch.uint8, device=dev)
        for lo in range(0, n_slots, _ENCODE_CHUNK):
            hi = min(lo + _ENCODE_CHUNK, n_slots)
            cl = torch.arange(lo, hi, device=dev) // cap
            res = corpus[perm[lo:hi]] - self.centroids[cl]
            res = torch.where(valid[lo:hi, None], res, 0.0)
            block = _pq_encode_block(res, cb, self.rotation)
            if self._pq_cols:
                codes[:, lo:hi] = block.T
            else:
                codes[lo:hi] = block
        self.corpus = codes
        self.slot_scale = None
        _sync(dev)
        self.build_seconds.update(pq_fit=t1 - t0, pq_encode=time.perf_counter() - t1)

    @staticmethod
    def _pq_sample_slot_ids(row_ids: np.ndarray, seed: int) -> np.ndarray:
        """Filled-slot ids sampled for the codebook fit (the JAX package's
        one policy, so identical inputs give identical codebooks)."""
        valid = np.nonzero(row_ids >= 0)[0]
        rng = np.random.default_rng(seed + 2)
        n_sample = int(min(len(valid), PQ_TRAIN_SAMPLE))
        return rng.choice(valid, size=n_sample, replace=False)

    def _fit_pq_codebooks(self, sample: torch.Tensor, seed: int):
        """Lloyd-fit the per-subvector codebooks on fp32 residual rows
        [S, D] on the device; sets the fp32 host copy and the device search
        copy. 'random' rotates by one seeded QR rotation; 'opq' alternates
        Lloyd fits with orthogonal-Procrustes updates ``rot = U V^T`` of
        ``X^T decode(encode(X rot))`` (the [D, D] SVD runs on the host in
        float64)."""
        m, ds = self.pq_m, self.dim // self.pq_m
        dev = sample.device
        n_sample = sample.shape[0]
        rng = np.random.default_rng(seed + 3)
        pick = torch.from_numpy(
            rng.choice(n_sample, size=PQ_K, replace=n_sample < PQ_K)
        ).to(dev)
        chunk = min(n_sample, 16384 if dev.type == "cuda" else 2048)

        def fit(z, cb0, n_iters):
            return _pq_lloyd_body(z.reshape(n_sample, m, ds), cb0,
                                  n_iters=n_iters, chunk=chunk)

        def init_cb(z):
            return z[pick].reshape(PQ_K, m, ds).transpose(0, 1).contiguous()

        rot = None
        cb = None
        if self.pq_rotate != "none":
            g = np.random.default_rng(seed + 11).standard_normal(
                (self.dim, self.dim)
            )
            rot, _ = np.linalg.qr(g)  # orthogonal; rotated = x @ rot
            rot = np.ascontiguousarray(rot, np.float32)
        if self.pq_rotate == "opq":
            inner = max(2, self.pq_iters // 5)
            for _ in range(_OPQ_OUTER):
                z = _rotate_rows(sample, torch.from_numpy(rot).to(dev))
                cb = fit(z, cb if cb is not None else init_cb(z), inner)
                codes = _pq_encode_block(z, cb)
                recon = _pq_reconstruct(codes, cb.reshape(m * PQ_K, ds), m, ds)
                mtx = (sample.T @ recon).cpu().numpy().astype(np.float64)
                u, _, vt = np.linalg.svd(mtx)
                rot = np.ascontiguousarray(u @ vt, np.float32)
        z = sample if rot is None else _rotate_rows(sample, torch.from_numpy(rot).to(dev))
        cb = fit(z, cb if cb is not None else init_cb(z), self.pq_iters)
        self._codebooks_host = cb.cpu().numpy().astype(np.float32, copy=False)
        self._rotation_host = rot
        self._place_codebooks()

    def _place_codebooks(self):
        """Device codebooks for search: flattened [m*256, ds] bf16 (round to
        nearest even, as the JAX package's host cast), and the fp32
        rotation."""
        m, ds = self.pq_m, self.dim // self.pq_m
        flat = torch.from_numpy(
            np.ascontiguousarray(self._codebooks_host.reshape(m * PQ_K, ds))
        )
        self.codebooks = flat.to(self.device).to(torch.bfloat16)
        self.rotation = (
            torch.from_numpy(self._rotation_host).to(self.device)
            if self._rotation_host is not None else None
        )

    # ------------------------------------------------------------------
    def _finish_tuning(self, nprobe, max_nprobe, tune_sample, tune_k, seed,
                       *, sample_fn):
        self.local_clusters = self.n_clusters
        if nprobe == "auto":
            rng = np.random.default_rng(seed + 1)
            n_sample = min(tune_sample, self.n_total)
            sample_idx = rng.choice(
                self.n_total, size=n_sample, replace=False
            )
            sample = sample_fn(sample_idx)
            self.nprobe = self._tune_nprobe(
                sample, tune_k,
                max_nprobe if max_nprobe is not None else self.local_clusters,
            )
        else:
            self.nprobe = int(nprobe)
            if self.nprobe < 1:
                raise ValueError("nprobe must be >= 1")

    def _tune_nprobe(self, sample: np.ndarray, k: int, max_nprobe: int) -> int:
        """The smallest nprobe meeting ``recall_target`` against the
        storage-precision exact search over corpus-row pseudo-queries.
        Analytic: at probe count p the hit set is the rows whose cluster
        ranks below p among the query's centroid scores, so one exact search
        and a host rank computation give recall(p) for every p; the choice
        is then verified with real searches and bumped a bounded number of
        times if short."""
        k = min(k, self.n_total)
        cap = min(max_nprobe, self.local_clusters)
        n_sample = len(sample)
        _, ref_idx = self.exact_search(sample, k=k)
        ref_sets = [set(row.tolist()) for row in ref_idx]

        # per-query centroid ranks as the device computes them: bf16-rounded
        # inputs, fp32 products, ties to the lower index (stable sort)
        def bf16_host(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return _bf16(x).numpy()

        scores = bf16_host(sample) @ bf16_host(self._centroids_host).T  # [S, K]
        local_clusters = self.local_clusters
        order = np.argsort(-scores, axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(local_clusters), order.shape), axis=1,
        )
        cluster = self._cluster_of_row[ref_idx]  # [S, k]
        need = rank[np.arange(n_sample)[:, None], cluster].ravel()
        required = int(math.ceil(self.recall_target * need.size))
        if required <= 0:
            p = 1
        else:
            p = int(np.partition(need, required - 1)[required - 1]) + 1
        p = max(1, min(p, cap))
        logger.info(
            "IVFIPIndex tune (analytic): nprobe=%d predicted recall=%.4f "
            "(target %.2f)", p, float((need < p).mean()), self.recall_target,
        )
        for _ in range(3):
            _, idx = self.search(sample, k=k, nprobe=p)
            recall = float(np.mean([
                len(set(idx[r].tolist()) & ref_sets[r]) / k
                for r in range(n_sample)
            ]))
            logger.info(
                "IVFIPIndex tune (verify): nprobe=%d recall=%.4f (target %.2f)",
                p, recall, self.recall_target,
            )
            if recall >= self.recall_target or p >= cap:
                break
            p = min(max(p + 1, int(p * 1.5)), cap)
        else:
            logger.warning(
                "IVFIPIndex: recall below target %.2f at nprobe=%d after "
                "bounded verification — raise max_nprobe or capacity_slack, "
                "lower n_clusters, or use FlatIPIndex", self.recall_target, p,
            )
        return p

    # ------------------------------------------------------------------
    def _effective_probe(self, k: int, nprobe: Optional[int]) -> Tuple[int, int]:
        """(nprobe, k) with nprobe floored so the probed slots always reach
        k (probing every cluster covers the whole corpus)."""
        p = int(nprobe if nprobe is not None else self.nprobe)
        p = max(p, -(-k // self.capacity))
        p = min(p, self.local_clusters)
        return p, min(k, p * self.capacity)

    def _gather_bytes_per_query(self, p_used: int) -> float:
        """Per-query device bytes of one search's transients, for search()'s
        batch shrink: every probed slot's fp32 score with its stable sort
        (values and int64 order) and its int64 row id, plus, where the
        probed rows are gathered (int8 storage, or the plain versions on
        the CPU), the gathered rows or codes and their fp32 copy."""
        n = p_used * self.capacity
        transients = n * 24
        if self.device.type == "cuda" and not self.quantized:
            return transients  # the kernels read the probed rows in place
        if self.pq_m is not None:
            return transients + n * self.pq_m * 13  # codes, int64 index, fp32
        return transients + n * self.dim * (self.corpus.element_size() + 4)

    def _probe_clusters(self, queries: torch.Tensor, p: int):
        """Each query's top-p clusters by the bf16 centroid product (fp32
        result), ties to the lower id: (probe [Q, p] int64, scores [Q, p])."""
        cent_s, probe = exact_topk(_bf16_mm(queries, self.centroids.T), p)
        return probe, cent_s

    def _probe_block(self, queries: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
        """Rows: fp32 [Q, p * cap] scores of every probed slot."""
        q_n, cap = queries.shape[0], self.capacity
        if not self.quantized:
            return probe_scores(self.corpus, probe, queries, cap=cap).reshape(q_n, -1)
        # int8: no kernel (nor in the JAX package): gather, bf16-exact
        # product with fp32 sums, then the slot scales
        slots = (probe[:, :, None] * cap
                 + torch.arange(cap, device=probe.device)).reshape(q_n, -1)
        rows = self.corpus[slots].to(torch.float32)  # [Q, p*cap, D]
        s = torch.bmm(rows, _bf16(queries)[:, :, None])[..., 0]
        return s * self.slot_scale[slots]

    def _probe_block_pq(self, queries: torch.Tensor, probe: torch.Tensor,
                        cent_s: torch.Tensor) -> torch.Tensor:
        """PQ: the decode term q . x_hat through per-query tables
        ``lut[q, j, c] = q_sub[j] . codebook[j, c]`` (bf16 operands, fp32
        result), plus the q . centroid term from the probe step."""
        q_n, cap, m = queries.shape[0], self.capacity, self.pq_m
        ds = self.dim // m
        q_dec = queries if self.rotation is None else _rotate_rows(queries, self.rotation)
        q_sub = _bf16(q_dec).reshape(q_n, m, ds).transpose(0, 1)  # [m, Q, ds]
        cbm = self.codebooks.to(torch.float32).view(m, PQ_K, ds)
        lut = torch.bmm(q_sub, cbm.transpose(1, 2)).transpose(0, 1).contiguous()
        adc = pq_probe_scores_t if self._pq_cols else pq_probe_scores
        s = adc(self.corpus, probe, lut, cap=cap).reshape(q_n, -1)
        return s + torch.repeat_interleave(cent_s, cap, dim=1)

    def search_tensor(self, queries: torch.Tensor, k: int,
                      nprobe: Optional[int] = None):
        """Device-side search: (scores fp32 [Q, k'], indices int64 [Q, k'])
        on the index's device, k' = min(k, ntotal); unreachable tail slots
        are -inf / -1."""
        k = min(k, self.n_total)
        p, kk = self._effective_probe(k, nprobe)
        q = queries.to(self.device, torch.float32)
        probe, cent_s = self._probe_clusters(q, p)
        hit_ids = self.row_ids.view(self.n_clusters, self.capacity)[probe]
        hit_ids = hit_ids.reshape(q.shape[0], -1)
        if self.pq_m is not None:
            s = self._probe_block_pq(q, probe, cent_s)
        else:
            s = self._probe_block(q, probe)
        s = torch.where(hit_ids >= 0, s, NEG_INF)
        top_s, pos = exact_topk(s, kk)
        return top_s, torch.gather(hit_ids, 1, pos).long()

    def search(
        self,
        queries,
        k: int = 100,
        batch_size: int = 64,
        nprobe: Optional[int] = None,
        candidates: Optional[int] = None,
        *,
        allowed_ids=None,
        disallowed_ids=None,
        selector=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched probe-and-score search from host queries. Returns numpy
        fp32 scores and int32 indices [Q, k'] (FlatIPIndex's surface); tail
        slots no probe reaches are -inf / -1, as in FAISS IVF."""
        if candidates is not None:
            raise NotImplementedError("IVFIPIndex.search candidates: "
                                      + _NOT_PORTED.format("the PCA hybrid"))
        if any(x is not None for x in (allowed_ids, disallowed_ids, selector)):
            raise NotImplementedError("IVFIPIndex.search filters: "
                                      + _NOT_PORTED.format("selector filtering"))
        k = min(k, self.n_total)
        p_used, _ = self._effective_probe(k, nprobe)
        max_bq = max(1, int(_GATHER_BUDGET // max(self._gather_bytes_per_query(p_used), 1)))
        if max_bq < batch_size:
            logger.info("IVF search: shrinking query batch %d -> %d (nprobe %d x "
                        "capacity %d)", batch_size, max_bq, p_used, self.capacity)
            batch_size = max_bq
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size]).to(self.device)
            s, i = self.search_tensor(block, k, nprobe)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        return np.concatenate(scores), np.concatenate(indices)

    # ------------------------------------------------------------------
    def _exact_scan(self, queries: torch.Tensor, k: int):
        """Exact top-k over the STORED rows (int8 dequantized through the
        slot scale, PQ decoded as centroid + codebook rows in bf16), chunk
        by chunk with a running stable top-k merge."""
        cap, dev = self.capacity, self.device
        n_slots = self.n_clusters * cap
        q_n = queries.shape[0]
        k_local = min(k, n_slots)
        budget = _CHUNK_BUDGET_CUDA if dev.type == "cuda" else _CHUNK_BUDGET
        chunk = max(8, (budget // max(q_n, 1)) // 8 * 8)
        # and at most 1 GiB of decoded (bf16) or converted rows per chunk
        chunk = min(n_slots, chunk, max(8, (1 << 29) // self.dim // 8 * 8))
        pq = self.pq_m is not None
        exact_fp32 = not pq and self.store_dtype == torch.float32
        if pq:
            m, ds = self.pq_m, self.dim // self.pq_m
            if self.rotation is not None:
                # decode term (q @ rot) . z; the centroid term from ONE
                # [Q, K] product instead of adding centroids to every row
                q_dec = _rotate_rows(queries, self.rotation)
                qc_all = _bf16_mm(queries, self.centroids.T)
        best_s = torch.full((q_n, k_local), NEG_INF, dtype=torch.float32, device=dev)
        best_i = torch.full((q_n, k_local), -1, dtype=torch.int64, device=dev)
        for lo in range(0, n_slots, chunk):
            hi = min(lo + chunk, n_slots)
            ids_c = self.row_ids[lo:hi].long()
            if pq:
                codes = self.corpus[:, lo:hi].T if self._pq_cols else self.corpus[lo:hi]
                cl = torch.arange(lo, hi, device=dev) // cap
                recon = _pq_reconstruct(codes, self.codebooks, m, ds)  # bf16
                if self.rotation is not None:
                    s = _bf16_mm(q_dec, recon.T) + qc_all[:, cl]
                else:
                    rows = recon + self.centroids[cl].to(torch.bfloat16)  # bf16 add
                    s = _bf16_mm(queries, rows.T)
            elif exact_fp32:
                s = queries @ self.corpus[lo:hi].T
            else:  # bf16 rows, or int8 codes (exact in bf16) and their scales
                s = _bf16_mm(queries, self.corpus[lo:hi].T)
                if self.quantized:
                    s = s * self.slot_scale[lo:hi][None, :]
            s = torch.where(ids_c[None, :] >= 0, s, NEG_INF)
            cat_s = torch.cat([best_s, s], dim=1)
            cat_i = torch.cat([best_i, ids_c[None, :].expand(q_n, -1)], dim=1)
            best_s, pos = exact_topk(cat_s, k_local)
            best_i = torch.gather(cat_i, 1, pos)
        return best_s, best_i

    def exact_search(self, queries, k: int = 100, batch_size: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact (at storage precision) brute-force search over the stored
        rows, with search()'s output surface: the tuner's reference and a
        recall oracle where no second fp32 corpus copy exists."""
        k = min(k, self.n_total)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size]).to(self.device)
            s, i = self._exact_scan(block, k)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        return np.concatenate(scores), np.concatenate(indices)
