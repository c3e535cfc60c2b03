"""Inverted-file (clustered) approximate inner-product index on one device
or over the data group (port of ``rankpo_tpu.index.ivf.IVFIPIndex``: the
FAISS ``IndexIVFFlat`` / ``IndexIVFPQ`` analog).

Build, on the device the embeddings live on:

- spherical k-means (Lloyd): the assignment is a ``[rows, D] @ [D, K]``
  product of bf16-rounded operands with an fp32 result (JAX's
  ``preferred_element_type=float32``), argmax per row; the update sums each
  cluster's rows in fp32. Rows stream in chunks (bigger on the card than
  JAX's VMEM-sized ones: only the summation order changes). Options:
  ``kmeans_split`` (each iteration but the last, the emptiest clusters give
  their centroid to split the fullest ones) and ``balance_eta`` (a
  per-cluster assignment bias that prices full clusters up; probing then
  ranks clusters by the same biased scores);
- each row's top ``ASSIGN_CANDIDATES`` clusters, then the deterministic host
  fill ``_greedy_fill`` (numpy, verbatim from the JAX package) lays the rows
  out cluster-major as ``[K * capacity, D]`` with ``row_ids == -1`` marking
  empty slots;
- storage: fp32 or bf16 rows, int8 rows with a per-slot max-abs scale, or
  residual product-quantization codes (``pq_m`` bytes per slot, optionally
  after a random or OPQ rotation) in rows ``[slots, m]`` or transposed
  ``[m, slots]`` layout; with ``reduced_dim``, the PCA hybrid's projected
  bf16 rows ``[slots, d']`` beside them;
- ``nprobe`` tuned against ``recall_target``: analytic ranks from one exact
  search, then up to 3 verifying searches (4 for the hybrid, which may grow
  its candidate pool instead).

``from_chunk_fn`` builds the same index from row chunks made on demand, so
the fp32 corpus never exists whole; ``append_sharded`` / ``remove_rows``
mutate a built index (fixed centroids and codebooks, FAISS ``add`` /
``remove_ids`` semantics) and ``reconstruct`` decodes stored rows.

Search: the queries' top-``nprobe`` clusters by the bf16 centroid product,
then every probed slot scored by a hand-written kernel on the card
(``ops/ivf_gather.py`` for fp32/bf16 rows, ``ops/pq_adc.py`` for PQ codes;
the plain versions on a CPU tensor), empty and filtered-out slots masked,
and a stable top-k (ties to the lower position, as ``lax.top_k``). int8 rows
and the PCA hybrid take the JAX package's own paths without a kernel
(gather and product; the hybrid scores the projected rows, then reranks its
top candidates at full width).

With ``group=`` (the data group of a multi-process run; JAX's ``mesh=``)
the clusters shard over the group as JAX shards them over its data axis:
K is rounded up to a multiple of the group's size dp, and data index d
holds the whole clusters ``[d K/dp, (d+1) K/dp)`` on its own device (their
centroids, slot rows, ``row_ids``, int8 scales and balance bias), the
cluster-major layout cut into dp contiguous blocks. Each rank runs the
Lloyd loop on its own rows and all-reduces the per-cluster sums and counts
over the group every iteration (JAX's ``lax.psum``), so ``balance_eta``'s
bias and ``kmeans_split``'s donors come from the summed counts on every
rank alike; the top-8 candidates are all-gathered in rank order and every
rank runs the same host fill. A search probes each rank's own top-nprobe
clusters with K4 (K5 over PQ codes; the hybrid picks and reranks its
candidates per shard), and the shards' top-k candidates merge as the flat
tier's do (``index/flat.py`` ``Shards._merge``: a rank-order all-gather and
a stable top-k), so every rank returns the same hits; the filter mask stays
whole (hits are global row ids; JAX replicates it). The tuner ranks each
true hit's cluster among its own shard's clusters. Every call is then a
collective of the group, made in the same order on every rank.

PQ over the group (JAX ``_pq_from_gathered``): the codebook sample's slots
come from the global layout and their rows from the ranks that hold them;
rank 0 fits the codebooks (and the rotation) on the residuals to the
global centroids and broadcasts them, so every rank holds the same bits;
each rank encodes its own slots against its own centroids, in the 'rows'
layout ('cols' is one device's, as in JAX). The hybrid sums its second
moment over the group and rank 0's eigenvectors reach every rank, which
projects its own slots. ``append_sharded`` assigns the new rows (whole on
every rank) against every cluster's centroid and places them on the host
as one device does; each rank writes its own slots. ``remove_rows``
renumbers the global ids on the host. The filtered tuner
(``nprobe="filtered"``, the port's own option) and the streamed build stay
one device's (JAX's streamed build is too).

Every random draw is numpy's ``default_rng`` with the JAX package's seeds, so
both packages draw the same numbers.
"""

from __future__ import annotations

import hashlib
import logging
import math
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh as cmesh
from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.index.flat import (
    Shards,
    _canonical_recon_ids,
    _chunked_row_gather,
    build_selector_mask,
    mask_filtered_misses,
    quantize_rows_int8,
    validate_append_args,
)
from rankpo_tpu_torch.ops.ivf_gather import probe_scores
from rankpo_tpu_torch.ops.pq_adc import PQ_K, pq_probe_scores, pq_probe_scores_t
from rankpo_tpu_torch.ops.topk import bf16_mm as _bf16_mm
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

# rows per chunk of the PCA second moment and projection
_PROJ_CHUNK = 1 << 16
# slots per collective of a sharded reconstruct
_RECON_CHUNK = 1 << 14


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


def _bf16_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 batched ``a @ b`` of the bf16-rounded operands (exact products
    summed in fp32), as :func:`_bf16_mm`."""
    if a.is_cuda:
        return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(_bf16(a), _bf16(b))


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)


def _grow_slots(x: torch.Tensor, k_c: int, cap: int, new_cap: int, fill=0,
                axis: int = 0) -> torch.Tensor:
    """``x`` with its cluster-major slot axis ``axis`` (K * cap) widened to
    K * new_cap; each cluster's new slots hold ``fill``."""
    shape = list(x.shape)
    blocks = x.reshape(shape[:axis] + [k_c, cap] + shape[axis + 1:])
    out = x.new_full(shape[:axis] + [k_c, new_cap] + shape[axis + 1:], fill)
    out.narrow(axis + 1, 0, cap).copy_(blocks)
    return out.reshape(shape[:axis] + [k_c * new_cap] + shape[axis + 1:])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lloyd_body(corpus: torch.Tensor, centroids: torch.Tensor, *, n_iters: int,
                chunk: int, spherical: bool, balance_eta: float = 0.0,
                split_r: int = 0, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Lloyd loop over fp32 rows ``corpus`` [N, D] from ``centroids``
    [K, D] (JAX ``_lloyd_body``). Empty clusters keep their previous
    centroid. Returns ``(centroids, bias)``. ``group``: ``corpus`` is this
    rank's rows; each iteration's sums and counts are all-reduced over the
    group after the chunk loop (whose length may differ by shard), so every
    rank takes the same steps from the same totals.

    ``balance_eta > 0``: rows assign to ``argmax(score - bias)`` and after
    every iteration ``bias += eta * tanh(count / target - 1)`` (balanced
    k-means). ``split_r > 0``: every iteration but the last, the ``split_r``
    emptiest clusters give their centroid slot to split the ``split_r``
    fullest (those above 1.5x the mean fill): the full centroid becomes a
    pair perturbed by +-1% with alternating signs over the dimensions.
    Fullest and emptiest come from stable sorts of the counts, so tied
    counts pick the lower cluster ids, as JAX's ``argsort`` does."""
    k, d = centroids.shape
    dev = centroids.device
    cents = centroids
    bias = torch.zeros(k, dtype=torch.float32, device=dev)
    sign = (1.0 - 2.0 * (torch.arange(d, device=dev) % 2)).to(torch.float32)[None, :]
    for it in range(n_iters):
        cb_t = cents.T
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        for lo in range(0, corpus.shape[0], max(chunk, 1)):
            rows_b = _bf16(corpus[lo : lo + chunk])
            scores = _bf16_mm(rows_b, cb_t)
            if balance_eta:
                scores = scores - bias[None, :]
            assign = torch.argmax(scores, dim=1)
            sums.index_add_(0, assign, rows_b)
            counts += torch.bincount(assign, minlength=k).to(torch.float32)
        if group is not None:
            cmesh.all_reduce_(sums, group)
            cmesh.all_reduce_(counts, group)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        new = torch.where((counts > 0.0)[:, None], new, cents)
        if spherical:
            new = _unit_rows(new)
        if balance_eta:
            target = torch.clamp_min(torch.sum(counts) / k, 1.0)
            bias = bias + balance_eta * torch.tanh(counts / target - 1.0)
        if split_r:
            target = torch.clamp_min(torch.sum(counts) / k, 1.0)
            recv = torch.argsort(-counts, stable=True)[:split_r]  # fullest
            donor = torch.argsort(counts, stable=True)[:split_r]  # emptiest
            should = ((counts[recv] > 1.5 * target) & (it < n_iters - 1))[:, None]
            recv_c = new[recv]
            split_a = recv_c * (1.0 + 0.01 * sign)
            split_b = recv_c * (1.0 - 0.01 * sign)
            if spherical:
                split_a, split_b = _unit_rows(split_a), _unit_rows(split_b)
            # donors first, then receivers, as JAX's two scatters (a cluster
            # in both lists ends with its receiver value)
            new[donor] = torch.where(should, split_a, new[donor])
            new[recv] = torch.where(should, split_b, recv_c)
        cents = new
    return cents, bias


def _assign_top2_body(corpus: torch.Tensor, centroids: torch.Tensor, *,
                      chunk: int, n_cand: int = 2,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row top-``n_cand`` nearest centroids [N, n_cand] int32, ties to
    the lower cluster id; fewer clusters than ``n_cand`` repeat the last.
    ``bias``: the balanced build's assignment bias, subtracted from the
    scores as in training."""
    k = centroids.shape[0]
    take = min(n_cand, k)
    cb_t = centroids.T
    out = torch.empty((corpus.shape[0], n_cand), dtype=torch.int32,
                      device=corpus.device)
    for lo in range(0, corpus.shape[0], max(chunk, 1)):
        scores = _bf16_mm(corpus[lo : lo + chunk], cb_t)
        if bias is not None:
            scores = scores - bias[None, :]
        _, topc = exact_topk(scores, take)
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


def _procrustes(mtx: torch.Tensor) -> np.ndarray:
    """The orthogonal ``U V^T`` of the [D, D] cross moment ``mtx`` (its SVD
    in float64), as fp32 on the host: numpy's for a CPU tensor, as the JAX
    package computes it on its host, and cuSOLVER's for a CUDA tensor (at D
    2048 the host's SVDs took most of an OPQ fit's time on the card; the
    smoke's 7d codecs and 6w steps time it)."""
    if mtx.is_cuda:
        u, _, vt = torch.linalg.svd(mtx.double())
        return np.ascontiguousarray((u @ vt).float().cpu().numpy())
    u, _, vt = np.linalg.svd(mtx.numpy().astype(np.float64))
    return np.ascontiguousarray(u @ vt, np.float32)


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


class IVFIPIndex(Shards):
    """Inverted-file inner-product index on one device, or its clusters
    sharded over ``group`` (module docstring).

    ``embeddings``: [N_buf, D] tensor (the index is built on, and stays on,
    its device) or numpy array (built on the CPU); rows at or past
    ``n_total`` (default N_buf) are padding and never indexed.

    Storage: ``corpus`` — cluster-major rows ``[K * capacity, D]`` in
    ``store_dtype`` (fp32, bf16, or int8 with ``slot_scale``), or PQ codes
    (``pq_m``) ``[slots, m]`` / ``[m, slots]`` uint8 with bf16 ``codebooks``
    [m*256, D/m] (and an fp32 ``rotation`` for ``pq_rotate``); ``row_ids``
    [K * capacity] int32 (-1 = empty slot); ``centroids`` [K, D] fp32;
    ``assign_bias`` [K] fp32 for a balanced build; with ``reduced_dim``, the
    PCA basis ``proj`` [D, d'] fp32 and ``corpus_low`` [K * capacity, d']
    bf16. Contract: approximate (the hit set may miss true neighbours);
    scores are exact at storage precision (int8: against the quantized rows;
    PQ: ADC approximations); a query whose probed clusters hold fewer than k
    (eligible) rows pads with index -1 / score -inf. With ``group``,
    ``embeddings`` is the whole corpus on every rank (:meth:`from_sharded`
    takes each rank's row shard) and the storage tensors hold this rank's
    clusters; int8 scales round as the JAX constructor rounds them."""

    _replicated = ("codebooks", "rotation", "proj")

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
        group=None,
    ):
        require_fp32_matmul()
        if mesh is not None:
            raise NotImplementedError(
                "IVFIPIndex(mesh=...): rankpo_tpu_torch takes no JAX mesh; the clusters "
                "shard over group=, the data group's process group (ROADMAP.md Queue 1 "
                "item 8c, multi-card IVF)")
        # a tensor keeps its device; a numpy array becomes a CPU tensor
        corpus = torch.as_tensor(embeddings, dtype=torch.float32)
        if corpus.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(corpus.shape)}")
        n_total = int(corpus.shape[0] if n_total is None else n_total)
        if n_total > corpus.shape[0]:
            raise ValueError(f"n_total {n_total} > {corpus.shape[0]} rows")
        corpus = corpus[:n_total]
        self._setup(n_total, int(corpus.shape[1]), corpus.device, store_dtype=store_dtype,
                    recall_target=recall_target, capacity_slack=capacity_slack,
                    spherical=spherical, balance_eta=balance_eta,
                    kmeans_split=kmeans_split, reduced_dim=reduced_dim,
                    candidates=candidates, pq_m=pq_m, pq_iters=pq_iters,
                    pq_rotate=pq_rotate, pq_layout=pq_layout, n_clusters=n_clusters,
                    group=group)
        per = cmesh.padded_rows(n_total, self.dp) // self.dp  # JAX's row shards
        lo = self.shard * per
        local = corpus[lo : lo + self._local_valid_rows(lo, per)]

        def rows_at(idx):
            return corpus[torch.from_numpy(idx).to(self.device)].cpu().numpy()

        def place(row_ids):
            self._place_storage(corpus, row_ids, seed)

        self._build(local, rows_at, place, seed=seed, kmeans_iters=kmeans_iters, nprobe=nprobe,
                    max_nprobe=max_nprobe, tune_sample=tune_sample, tune_k=tune_k)

    @classmethod
    def from_sharded(
        cls,
        embeddings,
        n_total: int,
        *,
        group=None,
        times_reciprocal: bool = True,
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
    ) -> "IVFIPIndex":
        """Build from device-resident fp32 rows (JAX ``from_sharded``): with
        ``group``, ``embeddings`` is this rank's row shard in
        ``InferenceEncoder.encode_shard``'s layout (``n_total`` rows over
        the group, zero pad rows), else rows past ``n_total`` are ignored.
        k-means runs on each shard's own rows; the k-means init rows and the
        tuner's sample reach every rank through ``mesh.exchange_rows``, and
        each slot's row moves once, to the rank that owns its cluster. int8
        scales round as XLA does (``times_reciprocal``; False: as the JAX
        constructor)."""
        require_fp32_matmul()
        rows = torch.as_tensor(embeddings, dtype=torch.float32)
        if rows.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(rows.shape)}")
        self = cls.__new__(cls)
        dp = 1 if group is None else cmesh.group_size(group)
        if int(rows.shape[0]) * dp < n_total:
            raise ValueError(f"sharded embeddings rows ({rows.shape[0]} x {dp} shards) must "
                             f"be >= n_total ({n_total})")
        self._setup(n_total, int(rows.shape[1]), rows.device, store_dtype=store_dtype,
                    recall_target=recall_target, capacity_slack=capacity_slack,
                    spherical=spherical, balance_eta=balance_eta,
                    kmeans_split=kmeans_split, reduced_dim=reduced_dim,
                    candidates=candidates, pq_m=pq_m, pq_iters=pq_iters,
                    pq_rotate=pq_rotate, pq_layout=pq_layout, n_clusters=n_clusters,
                    group=group)
        if group is None:
            local = rows[: self.n_total]

            def rows_at(idx):
                return local[torch.from_numpy(idx).to(self.device)].cpu().numpy()

            def place(row_ids):
                self._place_storage(local, row_ids, seed, times_reciprocal=times_reciprocal)
        else:
            shard_rows = int(rows.shape[0])
            local = rows[: self._local_valid_rows(self.shard * shard_rows, shard_rows)]

            def rows_at(idx):
                return cmesh.exchange_rows(rows, idx, shard_rows, group).cpu().numpy()

            def place(row_ids):
                self._place_shard(rows, row_ids, seed, times_reciprocal)
        self._build(local, rows_at, place, seed=seed, kmeans_iters=kmeans_iters,
                    nprobe=nprobe, max_nprobe=max_nprobe, tune_sample=tune_sample,
                    tune_k=tune_k)
        return self

    def _local_valid_rows(self, lo: int, per: int) -> int:
        """Rows below ``n_total`` of the ``per`` rows of a shard that starts
        at global row ``lo`` (JAX's ``n_valid_local``)."""
        return int(np.clip(self.n_total - lo, 0, per))

    def _build(self, local: torch.Tensor, rows_at, place, *, seed, kmeans_iters, nprobe,
               max_nprobe, tune_sample, tune_k) -> None:
        """The build both constructors share: k-means over this shard's fp32
        rows ``local`` from the init rows ``rows_at(ids)`` (host fp32 rows
        of global ids, on every rank), the host fill, ``place(row_ids)``
        for the storage, and the tuner over ``rows_at`` of its sample."""
        # --- train: k-means on the device ---
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        init_idx = rng.choice(
            self.n_total, size=self.n_clusters,
            replace=self.n_clusters > self.n_total,
        )
        init = rows_at(init_idx)
        if self.spherical:
            init = init / np.maximum(
                np.linalg.norm(init, axis=1, keepdims=True), 1e-12
            )
        cand = self._train_and_assign(local, init, kmeans_iters)
        t1 = time.perf_counter()

        # --- layout: greedy fill on the host (every rank alike) ---
        row_ids = _greedy_fill(cand, self.n_total, self.n_clusters, self.capacity)
        self._set_layout_maps(row_ids)
        self.row_ids = torch.from_numpy(row_ids[self._own_slots()]).to(self.device)
        t2 = time.perf_counter()

        # --- storage: rows (or PQ codes) gathered cluster-major on the device
        place(row_ids)
        _sync(self.device)
        t3 = time.perf_counter()
        self._init_projection()

        t_tune = time.perf_counter()
        self._finish_tuning(nprobe, max_nprobe, tune_sample, tune_k, seed, sample_fn=rows_at)
        t4 = time.perf_counter()
        self.build_seconds.update(kmeans=t1 - t0, fill=t2 - t1, storage=t3 - t2,
                                  tune=t4 - t_tune)
        self._log_build()

    def _gather_slots(self, storage: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
        """Stored per-slot rows at global ``slots`` on every rank (a
        collective)."""
        return cmesh.exchange_rows(storage, slots, self.local_clusters * self.capacity,
                                   self.group)

    def _own_slots(self) -> slice:
        """This rank's slots of the global cluster-major layout."""
        n = self.local_clusters * self.capacity
        return slice(self.shard * n, (self.shard + 1) * n)

    def _setup(self, n_total: int, dim: int, device, *, store_dtype, recall_target,
               capacity_slack, spherical, balance_eta, kmeans_split, reduced_dim,
               candidates, pq_m, pq_iters, pq_rotate, pq_layout, n_clusters, group=None):
        """Validate and set the options both constructors share, the cluster
        count (a multiple of the group's size), the capacity and the shard
        layout."""
        self.n_total = int(n_total)
        self.dim = int(dim)
        self.device = device
        if self.n_total < 1:
            raise ValueError("IVFIPIndex needs a non-empty corpus")
        self._set_store(store_dtype)
        if capacity_slack < 1.0:
            raise ValueError("capacity_slack must be >= 1.0")
        self.recall_target = float(recall_target)
        self.spherical = bool(spherical)
        self.balance_eta = float(balance_eta)
        self._set_hybrid(reduced_dim, candidates)
        self._set_pq(pq_m, pq_iters, pq_rotate, pq_layout, sharded=group is not None)
        dp = 1 if group is None else cmesh.group_size(group)
        self.n_clusters = _resolve_clusters(self.n_total, dp, n_clusters)
        self.kmeans_split = int(kmeans_split)
        if not 0 <= self.kmeans_split <= self.n_clusters // 2:
            # past K // 2 the fullest and the emptiest clusters overlap, and
            # a receiver's write would undo a donor's split
            raise ValueError(
                f"kmeans_split={kmeans_split} must be in [0, n_clusters // 2 = "
                f"{self.n_clusters // 2}]")
        self.capacity = _resolve_capacity(
            self.n_total, self.n_clusters, capacity_slack,
            multiple=self._capacity_multiple(),
        )
        self._set_group(group)
        self.local_clusters = self.n_clusters // self.dp
        self._set_assign_bias(None)
        self.build_seconds = {}

    def _log_build(self) -> None:
        logger.info(
            "IVFIPIndex: %d rows, K %d, capacity %d, nprobe %d; build %s",
            self.n_total, self.n_clusters, self.capacity, self.nprobe,
            {k: round(v, 3) for k, v in self.build_seconds.items()},
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_chunk_fn(
        cls,
        get_chunk,
        n_total: int,
        dim: int,
        *,
        chunk_rows: int = 262144,
        train_rows: Optional[int] = None,
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
        device="cuda",
    ) -> "IVFIPIndex":
        """Streamed build on ``device``: the fp32 corpus never exists whole.

        ``get_chunk(lo, hi)`` returns fp32 rows ``[hi - lo, D]`` (numpy or a
        tensor on any device) for the global range [lo, hi); ranges are
        asked for in ascending order: whole chunks evenly spaced for the
        k-means sample (``train_rows``, default ~64 per cluster and at least
        65536), then every range once to assign and once to place. Device
        memory holds the final storage, the k-means sample and one fp32
        chunk. Pseudo-queries for the nprobe tuner are decoded stored rows
        (``reconstruct``). One device, as JAX's."""
        require_fp32_matmul()
        self = cls.__new__(cls)
        self._setup(n_total, dim, resolve_device(device), store_dtype=store_dtype,
                    recall_target=recall_target, capacity_slack=capacity_slack,
                    spherical=spherical, balance_eta=balance_eta,
                    kmeans_split=kmeans_split, reduced_dim=reduced_dim,
                    candidates=candidates, pq_m=pq_m, pq_iters=pq_iters,
                    pq_rotate=pq_rotate, pq_layout=pq_layout, n_clusters=n_clusters)
        dev, k_c = self.device, self.n_clusters
        chunk_rows = max(1, int(chunk_rows))
        budget = _CHUNK_BUDGET_CUDA if dev.type == "cuda" else _CHUNK_BUDGET

        def fetch(lo, hi):
            rows = torch.as_tensor(get_chunk(lo, hi), dtype=torch.float32).to(dev)
            if rows.shape != (hi - lo, self.dim):
                raise ValueError(f"get_chunk({lo}, {hi}) gave {tuple(rows.shape)}, "
                                 f"expected {(hi - lo, self.dim)}")
            return rows

        def ranges():
            for lo in range(0, self.n_total, chunk_rows):
                yield lo, min(lo + chunk_rows, self.n_total)

        # --- pass 0: whole chunks, evenly spaced, as the k-means sample ---
        t0 = time.perf_counter()
        s_target = int(train_rows if train_rows is not None
                       else min(self.n_total, max(64 * k_c, 1 << 16)))
        n_full = max(self.n_total // chunk_rows, 1)
        chunks_needed = min(n_full, max(1, -(-s_target // chunk_rows)))
        picked = sorted({round(i * (n_full - 1) / max(chunks_needed - 1, 1))
                         for i in range(chunks_needed)})
        train = torch.empty((len(picked) * chunk_rows, self.dim), dtype=torch.float32,
                            device=dev)
        n_train = 0
        for ci in picked:  # only the global last chunk is partial, and it is last
            rows = fetch(ci * chunk_rows, min((ci + 1) * chunk_rows, self.n_total))
            train[n_train : n_train + rows.shape[0]] = rows
            n_train += rows.shape[0]
        del rows
        train = train[:n_train]
        init_idx = np.random.default_rng(seed).choice(
            n_train, size=k_c, replace=k_c > n_train)
        init = train[torch.from_numpy(init_idx).to(dev)].cpu().numpy()
        if self.spherical:  # on the host, as the constructor does
            init = init / np.maximum(np.linalg.norm(init, axis=1, keepdims=True), 1e-12)
        cents, bias = _lloyd_body(
            train, torch.from_numpy(init).to(dev), n_iters=max(0, int(kmeans_iters)),
            chunk=_chunk_rows(n_train, k_c, budget), spherical=self.spherical,
            balance_eta=self.balance_eta, split_r=self.kmeans_split)
        self._set_centroids(cents)
        self._set_assign_bias(bias.cpu().numpy())
        t1 = time.perf_counter()
        if self.pq_m is not None:
            # codebooks train on the sample's top-1 residuals (FAISS IVFPQ
            # trains so); placement encodes each row against its slot's
            # cluster
            pq_target = min(n_train, 1 << 17)
            rows = train[:: max(1, n_train // pq_target)][:pq_target]
            top1 = _assign_top2_body(rows, cents, chunk=_chunk_rows(rows.shape[0], k_c, budget),
                                     bias=self.assign_bias)[:, 0]
            self._fit_pq_codebooks(rows - cents[top1.long()], seed)
            del rows, top1
        del train
        t2 = time.perf_counter()

        # --- pass 1: streamed top-8 assignment ---
        cand = np.empty((self.n_total, ASSIGN_CANDIDATES), np.int32)
        a_chunk = _chunk_rows(chunk_rows, k_c, budget)
        for lo, hi in ranges():
            cand[lo:hi] = _assign_top2_body(
                fetch(lo, hi), cents, chunk=a_chunk, n_cand=ASSIGN_CANDIDATES,
                bias=self.assign_bias).cpu().numpy()
        row_ids = _greedy_fill(cand, self.n_total, k_c, self.capacity)
        del cand
        self._set_layout_maps(row_ids)
        self.row_ids = torch.from_numpy(row_ids).to(dev)
        t3 = time.perf_counter()

        # --- pass 2: streamed placement into storage (empty slots stay 0) ---
        n_slots = k_c * self.capacity
        m = self.pq_m
        if m is not None:
            self.corpus = torch.zeros((m, n_slots) if self._pq_cols else (n_slots, m),
                                      dtype=torch.uint8, device=dev)
        else:
            self.corpus = torch.zeros((n_slots, self.dim), dtype=self.store_dtype, device=dev)
        self.slot_scale = (torch.zeros(n_slots, dtype=torch.float32, device=dev)
                           if self.quantized else None)
        for lo, hi in ranges():
            self._write_slots(fetch(lo, hi), torch.from_numpy(self._slot_of_row[lo:hi]).to(dev),
                              self.corpus, self.slot_scale, self.capacity)
        _sync(dev)
        t4 = time.perf_counter()
        self._init_projection()
        t_tune = time.perf_counter()
        self._finish_tuning(nprobe, max_nprobe, tune_sample, tune_k, seed,
                            sample_fn=self.reconstruct)
        self.build_seconds.update(kmeans=t1 - t0, pq_fit=t2 - t1, assign_fill=t3 - t2,
                                  storage=t4 - t3, tune=time.perf_counter() - t_tune)
        if m is None:
            del self.build_seconds["pq_fit"]
        self._log_build()
        return self

    def _write_slots(self, rows: torch.Tensor, slots: torch.Tensor, corpus, slot_scale,
                     capacity: int) -> None:
        """Encode fp32 ``rows`` at the storage codec and write them into
        ``corpus`` (and ``slot_scale``) at ``slots``: int8 codes and scales,
        PQ codes of the residual to the slot's cluster (fixed codebooks),
        or cast rows. Chunked so the PQ score transient stays small."""
        if self.pq_m is None:
            if self.quantized:
                corpus[slots], slot_scale[slots] = quantize_rows_int8(
                    rows, times_reciprocal=True)
            else:
                corpus[slots] = rows.to(self.store_dtype)
            return
        cb = torch.from_numpy(self._codebooks_host).to(self.device)
        for lo in range(0, rows.shape[0], _ENCODE_CHUNK):
            sl = slots[lo : lo + _ENCODE_CHUNK]
            res = rows[lo : lo + _ENCODE_CHUNK] - self.centroids[sl // capacity]
            codes = _pq_encode_block(res, cb, self.rotation)
            if self._pq_cols:
                corpus[:, sl] = codes.T
            else:
                corpus[sl] = codes

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

    def _set_hybrid(self, reduced_dim, candidates):
        """The PCA hybrid's knobs: probed rows score in a projected d' space
        (``reduced_dim``), and the top ``candidates`` rerank at full width."""
        if reduced_dim is not None:
            rd = int(reduced_dim)
            if not 0 < rd <= self.dim:
                raise ValueError(f"reduced_dim={reduced_dim} must be in (0, {self.dim}]")
            self.reduced_dim = rd
        else:
            self.reduced_dim = None
        if candidates != "auto":
            if int(candidates) < 1:
                raise ValueError("candidates must be >= 1")
            candidates = int(candidates)
        self.candidates = candidates

    def _local_clusters_of(self, x):
        """This rank's clusters' entries of a per-cluster array ``x`` [K, ...]
        (all of them on one device)."""
        lo = self.shard * self.local_clusters
        return x[lo : lo + self.local_clusters]

    def _set_assign_bias(self, bias: Optional[np.ndarray]):
        """The balanced build's assignment bias (None or all zero: off), on
        the host for every cluster and on the device for this rank's.
        Probing ranks clusters by ``q . centroid - bias``, the metric the
        rows were assigned by; score terms stay raw."""
        if bias is None or self.balance_eta == 0.0 or not np.any(bias):
            self._assign_bias_host = None
            self.assign_bias = None
        else:
            self._assign_bias_host = np.asarray(bias, np.float32)
            self.assign_bias = torch.from_numpy(
                np.ascontiguousarray(self._local_clusters_of(self._assign_bias_host))
            ).to(self.device)

    def _set_pq(self, pq_m, pq_iters, pq_rotate="none", pq_layout="auto",
                sharded: bool = False):
        """Validate the product-quantization knobs (residual PQ: ``pq_m``
        uint8 codes per slot into per-subvector 256-entry codebooks trained
        on assignment residuals). ``pq_rotate``: 'random' (seeded QR) or
        'opq' (rotation trained against the codec) pre-rotates residuals;
        ``pq_layout``: 'rows' ``[slots, m]``, 'cols' ``[m, slots]`` (one
        device's: ``sharded``, an index over a group, raises, as JAX's on a
        mesh), or 'auto' (the JAX package's rule: 'rows' over a group)."""
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
        if self.reduced_dim is not None:
            raise ValueError(
                "pq_m and reduced_dim are exclusive (PQ codes already cut the "
                "probed-row reads below the d'-projection's bytes)"
            )
        self.pq_m = m
        self.pq_iters = max(1, int(pq_iters))
        if pq_layout == "auto":
            pad_lanes = -(-m // 128) * 128  # rows layout pads m to this
            pq_layout = (
                "cols"
                if (
                    not sharded
                    and m % 32 == 0
                    and pad_lanes > m  # m x128 already tiles rows free
                    and float(self.n_total) * pad_lanes > _COLS_AUTO_BYTES
                )
                else "rows"
            )
        if pq_layout == "cols" and sharded:
            raise ValueError(
                "pq_layout='cols' is single-device (a group shards the slots, the "
                "transposed codes' inner axis) — use 'rows' on a group"
            )
        if pq_layout == "cols" and m % 32 != 0:
            raise ValueError(
                "pq_layout='cols' needs pq_m % 32 == 0 (int8 sublane "
                f"packing), got pq_m={m}"
            )
        self.pq_layout = pq_layout

    def _set_centroids(self, centroids: torch.Tensor) -> None:
        """Every cluster's centroid on the host (the tuner ranks them all),
        this rank's on the device."""
        self.centroids = self._local_clusters_of(centroids)
        self._centroids_host = centroids.cpu().numpy().astype(np.float32, copy=False)

    def _train_and_assign(self, corpus: torch.Tensor, init_centroids: np.ndarray,
                          kmeans_iters) -> np.ndarray:
        """The Lloyd loop and the top-``ASSIGN_CANDIDATES`` pass over
        ``corpus`` (this shard's valid rows); sets the centroids (and the
        balanced build's bias) and returns host [n_total, C] candidate
        cluster ids: with a group, every shard's in rank order (one
        all-gather of ceil(n_total / dp) rows a rank)."""
        budget = _CHUNK_BUDGET_CUDA if corpus.is_cuda else _CHUNK_BUDGET
        chunk = _chunk_rows(corpus.shape[0], self.n_clusters, budget)
        cents, bias = _lloyd_body(
            corpus, torch.from_numpy(init_centroids).to(self.device),
            n_iters=max(0, int(kmeans_iters)), chunk=chunk,
            spherical=self.spherical, balance_eta=self.balance_eta,
            split_r=self.kmeans_split, group=self.group,
        )
        cand = _assign_top2_body(corpus, cents, chunk=chunk, n_cand=ASSIGN_CANDIDATES,
                                 bias=bias if self.balance_eta else None)
        if self.group is not None:
            per = cmesh.padded_rows(self.n_total, self.dp) // self.dp
            padded = cand.new_zeros((per, ASSIGN_CANDIDATES))
            padded[: cand.shape[0]] = cand
            cand = cmesh.all_gather_rows(padded, self.group)[: self.n_total]
        self._set_centroids(cents)
        self._set_assign_bias(bias.cpu().numpy())
        return cand.cpu().numpy()

    def _set_layout_maps(self, row_ids: np.ndarray):
        """Host-side row -> cluster / slot maps: the analytic nprobe tuner
        (recall(p) follows from each true hit's cluster probe-rank),
        ``reconstruct`` and the mutations read them."""
        row_ids = np.asarray(row_ids, np.int32)
        self._row_ids_host = row_ids
        cluster = np.zeros(self.n_total, np.int32)
        filled = np.nonzero(row_ids >= 0)[0]
        cluster[row_ids[filled]] = (filled // self.capacity).astype(np.int32)
        self._cluster_of_row = cluster
        slot = np.full(self.n_total, -1, np.int64)
        slot[row_ids[filled]] = filled
        self._slot_of_row = slot

    def _place_storage(self, corpus: torch.Tensor, row_ids: np.ndarray, seed: int,
                       times_reciprocal: bool = False):
        """Cluster-major storage of this rank's slots of the global layout
        ``row_ids``, gathered from the whole ``corpus`` chunk by chunk (no
        fp32 copy of the whole layout); empty slots hold zero rows. int8
        scales round as the JAX constructor's (``times_reciprocal``: as
        XLA's)."""
        dev = self.device
        own = row_ids[self._own_slots()]
        perm = torch.from_numpy(np.clip(own, 0, None).astype(np.int64)).to(dev)
        valid = torch.from_numpy(own >= 0).to(dev)
        if self.pq_m is not None:
            def sample():
                slots = self._pq_sample_slot_ids(row_ids, seed)
                rows = corpus[torch.from_numpy(row_ids[slots].astype(np.int64)).to(dev)]
                return rows - self._all_centroids()[torch.from_numpy(slots // self.capacity)
                                                    .to(dev)]

            self._fit_pq_shared(sample, seed)
            self._encode_pq(lambda lo, hi: corpus[perm[lo:hi]], valid)
            return
        n_slots = len(own)
        out = torch.empty((n_slots, self.dim), dtype=self.store_dtype, device=dev)
        scale = (torch.empty(n_slots, dtype=torch.float32, device=dev)
                 if self.quantized else None)
        for lo in range(0, n_slots, _ENCODE_CHUNK):
            sl = slice(lo, lo + _ENCODE_CHUNK)
            rows = torch.where(valid[sl, None], corpus[perm[sl]], 0.0)
            if self.quantized:
                out[sl], scale[sl] = quantize_rows_int8(rows, times_reciprocal=times_reciprocal)
            else:
                out[sl] = rows.to(self.store_dtype)
        self.corpus = out
        self.slot_scale = scale

    def _place_shard(self, shard: torch.Tensor, row_ids: np.ndarray, seed: int,
                     times_reciprocal: bool) -> None:
        """This rank's slots from the row shards ``shard`` (this rank's fp32
        rows of the global layout): each filled slot's row moves once, from
        the rank that holds it to the rank that owns its cluster
        (``mesh.exchange_rows``), and only those rows are written; empty
        slots hold zero rows (int8: zero codes, scale 1e-12, as a zero row
        quantizes; PQ: the zero residual's code, as one device writes). PQ
        first fits its codebooks on rank 0, from the sample's rows sent
        there."""
        n_own = self.local_clusters * self.capacity
        shard_rows = int(shard.shape[0])
        if self.pq_m is not None:
            slots = self._pq_sample_slot_ids(row_ids, seed)
            # the sample's rows reach rank 0 alone, the one rank that fits
            rows = cmesh.exchange_rows(shard, row_ids[slots], shard_rows, self.group,
                                       np.zeros(len(slots), np.int64))
            self._fit_pq_shared(lambda: rows - self._all_centroids()[
                torch.from_numpy(slots // self.capacity).to(self.device)], seed)
        filled = np.nonzero(row_ids >= 0)[0]
        dest = filled // n_own
        rows = cmesh.exchange_rows(shard, row_ids[filled], shard_rows, self.group, dest)
        slots = torch.from_numpy(filled[dest == self.shard] - self.shard * n_own).to(
            self.device)
        if self.pq_m is not None:
            valid = torch.zeros(n_own, dtype=torch.bool, device=self.device)
            valid[slots] = True
            # each own slot's row in ``rows``; an empty slot reads the zero row
            # put after them
            rows = torch.cat([rows, rows.new_zeros((1, self.dim))])
            pos = torch.full((n_own,), rows.shape[0] - 1, dtype=torch.int64, device=self.device)
            pos[slots] = torch.arange(slots.shape[0], device=self.device)
            self._encode_pq(lambda lo, hi: rows[pos[lo:hi]], valid)
            return
        self.corpus = torch.zeros((n_own, self.dim), dtype=self.store_dtype, device=self.device)
        self.slot_scale = (torch.full((n_own,), 1e-12, dtype=torch.float32, device=self.device)
                           if self.quantized else None)
        for lo in range(0, rows.shape[0], _ENCODE_CHUNK):
            sl = slots[lo : lo + _ENCODE_CHUNK]
            if self.quantized:
                self.corpus[sl], self.slot_scale[sl] = quantize_rows_int8(
                    rows[lo : lo + _ENCODE_CHUNK], times_reciprocal=times_reciprocal)
            else:
                self.corpus[sl] = rows[lo : lo + _ENCODE_CHUNK].to(self.store_dtype)

    def _all_centroids(self) -> torch.Tensor:
        """Every cluster's centroid [K, D] fp32 on this rank's device (the
        device ``centroids`` hold this rank's alone)."""
        if self.group is None:
            return self.centroids
        return torch.from_numpy(self._centroids_host).to(self.device)

    def _fit_pq_shared(self, sample, seed: int) -> None:
        """Fit the codebooks (and the rotation) on the fp32 residual sample
        ``sample()`` [S, D] (JAX's sample of the actual slot residuals:
        spilled rows train against the cluster they landed in). Over a
        group rank 0 alone calls ``sample`` and fits, and broadcasts the
        fp32 codebooks and rotation, so every rank holds the same bits."""
        t0 = time.perf_counter()
        if self.shard == 0:
            self._fit_pq_codebooks(sample(), seed)
        if self.group is not None:
            m, ds = self.pq_m, self.dim // self.pq_m
            parts = {"_codebooks_host": (m, PQ_K, ds)}
            if self.pq_rotate != "none":
                parts["_rotation_host"] = (self.dim, self.dim)
            for name, shape in parts.items():
                buf = (torch.from_numpy(getattr(self, name)).to(self.device) if self.shard == 0
                       else torch.empty(shape, dtype=torch.float32, device=self.device))
                setattr(self, name, cmesh.broadcast_(buf, 0, self.group).cpu().numpy())
            self._place_codebooks()
        self.build_seconds["pq_fit"] = time.perf_counter() - t0

    def _encode_pq(self, own_rows, valid: torch.Tensor) -> None:
        """Encode every slot of this rank: ``own_rows(lo, hi)`` gives the
        fp32 rows of slots [lo, hi), each against its slot's cluster
        centroid; an empty slot (``valid`` False) encodes a zero
        residual."""
        m, cap, dev = self.pq_m, self.capacity, self.device
        t0 = time.perf_counter()
        cb = torch.from_numpy(self._codebooks_host).to(dev)
        n_slots = valid.shape[0]
        codes = torch.empty((m, n_slots) if self._pq_cols else (n_slots, m),
                            dtype=torch.uint8, device=dev)
        for lo in range(0, n_slots, _ENCODE_CHUNK):
            hi = min(lo + _ENCODE_CHUNK, n_slots)
            cl = torch.arange(lo, hi, device=dev) // cap
            res = own_rows(lo, hi) - self.centroids[cl]
            res = torch.where(valid[lo:hi, None], res, 0.0)
            block = _pq_encode_block(res, cb, self.rotation)
            if self._pq_cols:
                codes[:, lo:hi] = block.T
            else:
                codes[lo:hi] = block
        self.corpus = codes
        self.slot_scale = None
        _sync(dev)
        self.build_seconds["pq_encode"] = time.perf_counter() - t0

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
        ``X^T decode(encode(X rot))`` (the [D, D] SVD in float64,
        :func:`_procrustes`)."""
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
                rot = _procrustes(sample.T @ recon)
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


    def _init_projection(self):
        """The PCA hybrid's basis and projected rows, from the STORED rows
        (int8 dequantized): the uncentred second moment summed on the device
        in fp32 (empty slots are zero rows and add nothing), its top
        ``reduced_dim`` eigenvectors by ``np.linalg.eigh`` on the host, and
        the bf16 projections of every slot. Over a group each rank sums its
        own slots, the moment is all-reduced, and rank 0's basis is
        broadcast (the same bits on every rank); each rank projects its
        own slots."""
        if self.reduced_dim is None:
            self.proj = None
            self.corpus_low = None
            return
        t0 = time.perf_counter()
        n_slots = self.corpus.shape[0]
        cov = torch.zeros((self.dim, self.dim), dtype=torch.float32, device=self.device)
        for lo in range(0, n_slots, _PROJ_CHUNK):
            rows = self._slot_rows(torch.arange(lo, min(lo + _PROJ_CHUNK, n_slots),
                                                device=self.device))
            cov += rows.T @ rows
        if self.group is not None:
            cmesh.all_reduce_(cov, self.group)
        if self.shard == 0:
            _, v = np.linalg.eigh(cov.cpu().numpy())  # ascending eigenvalues
            self.proj = torch.from_numpy(
                np.ascontiguousarray(v[:, -self.reduced_dim:], np.float32)).to(self.device)
        else:
            self.proj = torch.empty((self.dim, self.reduced_dim), dtype=torch.float32,
                                    device=self.device)
        if self.group is not None:
            cmesh.broadcast_(self.proj, 0, self.group)
        self.corpus_low = torch.empty((n_slots, self.reduced_dim), dtype=torch.bfloat16,
                                      device=self.device)
        for lo in range(0, n_slots, _PROJ_CHUNK):
            sl = torch.arange(lo, min(lo + _PROJ_CHUNK, n_slots), device=self.device)
            self.corpus_low[sl] = (self._slot_rows(sl) @ self.proj).to(torch.bfloat16)
        _sync(self.device)
        self.build_seconds["projection"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _finish_tuning(self, nprobe, max_nprobe, tune_sample, tune_k, seed,
                       *, sample_fn):
        self.local_clusters = self.n_clusters // self.dp
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

    def _tune_nprobe(self, sample: np.ndarray, k: int, max_nprobe: int,
                     sel_mask: Optional[np.ndarray] = None) -> int:
        """The smallest nprobe meeting ``recall_target`` against the
        storage-precision exact search over corpus-row pseudo-queries.
        Analytic: at probe count p the hit set is the rows whose cluster
        ranks below p among the query's centroid scores (minus the balanced
        build's bias), so one exact search and a host rank computation give
        recall(p) for every p; the choice is then verified with real
        searches and bumped a bounded number of times if short. For the
        hybrid a bump that does not raise recall (more probed rows crowd the
        fixed candidate pool) doubles the candidate pool instead, which
        sticks to the instance. ``sel_mask``: searches and the reference
        under this filter (then the pool never grows)."""
        k = min(k, self.n_total)
        cap = min(max_nprobe, self.local_clusters)
        n_sample = len(sample)
        _, ref_idx = self.exact_search(sample, k=k, selector=sel_mask)
        # a filter may leave fewer than k eligible rows: -1 tails
        ref_sets = [set(row[row >= 0].tolist()) for row in ref_idx]

        # per-query centroid ranks as the device computes them: bf16-rounded
        # inputs, fp32 products, ties to the lower index (stable sort)
        def bf16_host(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return _bf16(x).numpy()

        scores = bf16_host(sample) @ bf16_host(self._centroids_host).T  # [S, K]
        if self._assign_bias_host is not None:
            scores = scores - self._assign_bias_host[None, :]
        # each shard probes its own top-p clusters: rank a hit's cluster
        # among its shard's (JAX ivf.py:2064-2077)
        local_clusters = self.local_clusters
        blocks = scores.reshape(n_sample, self.n_clusters // local_clusters, local_clusters)
        order = np.argsort(-blocks, axis=2, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(local_clusters), order.shape), axis=2,
        )
        cluster = self._cluster_of_row[ref_idx]  # [S, k] global ids
        need = rank[np.arange(n_sample)[:, None], cluster // local_clusters,
                    cluster % local_clusters][ref_idx >= 0]
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
        hybrid = self.reduced_dim is not None and sel_mask is None
        prev_recall = -1.0
        for _ in range(4 if hybrid else 3):
            _, idx = self.search(sample, k=k, nprobe=p, selector=sel_mask)
            recall = float(np.mean([
                len(set(idx[r].tolist()) & ref_sets[r]) / max(len(ref_sets[r]), 1)
                for r in range(n_sample)
            ]))
            logger.info(
                "IVFIPIndex tune (verify): nprobe=%d candidates=%s recall=%.4f "
                "(target %.2f)", p, self.candidates, recall, self.recall_target,
            )
            if recall >= self.recall_target:
                break
            if hybrid and recall <= prev_recall:
                self.candidates = min(2 * self._effective_candidates(k, None),
                                      p * self.capacity)
                logger.info("IVFIPIndex tune: probe bump did not raise recall; "
                            "candidates -> %d", self.candidates)
            elif p >= cap:
                break
            else:
                p = min(max(p + 1, int(p * 1.5)), cap)
            prev_recall = recall
        else:
            logger.warning(
                "IVFIPIndex: recall below target %.2f at nprobe=%d after "
                "bounded verification — raise max_nprobe or capacity_slack, "
                "lower n_clusters, or use FlatIPIndex", self.recall_target, p,
            )
        return p

    def tune_filtered_nprobe(self, k: int = TUNE_K, *, allowed_ids=None, disallowed_ids=None,
                             selector=None, tune_sample: int = TUNE_SAMPLE,
                             seed: int = 0) -> int:
        """The nprobe at which searches under this filter reach the index's
        ``recall_target``. A filter leaves the probed clusters as they are
        (FAISS IVF semantics), so each probe reaches fewer eligible rows and
        recall at the build's nprobe falls as the filter narrows. This is the
        build's tuner under the filter: ``tune_sample`` seeded stored rows
        (as :meth:`reconstruct` gives them) as pseudo-queries, the exact
        search over the allowed stored rows as the reference, an analytic
        nprobe verified by filtered searches. Cached per filter and k;
        ``search(..., nprobe="filtered")`` calls it."""
        k = min(k, self.n_total)
        mask = build_selector_mask(self.n_total, allowed_ids, disallowed_ids, selector)
        if mask is None:
            return self.nprobe
        if self.dp > 1:
            # the port's own option (the JAX package has no filtered tuner):
            # one device's by design, not a sharded path still to port
            raise NotImplementedError(
                f"nprobe='filtered' (IVFIPIndex.tune_filtered_nprobe) runs on one device; "
                f"over {self.dp} shards pass an int nprobe")
        key = (k, hashlib.sha1(np.packbits(mask).tobytes()).hexdigest())
        cache = self.__dict__.setdefault("_filtered_nprobes", {})
        if key not in cache:
            rng = np.random.default_rng(seed)
            sample_idx = rng.choice(self.n_total, size=min(tune_sample, self.n_total),
                                    replace=False)
            cache[key] = self._tune_nprobe(self.reconstruct(sample_idx), k,
                                           self.local_clusters, sel_mask=mask)
        return cache[key]

    # ------------------------------------------------------------------
    def _effective_probe(self, k: int, nprobe: Optional[int]) -> Tuple[int, int]:
        """(nprobe, per-shard k) with nprobe floored so the shards' merged
        candidates always reach k (probing every cluster covers the whole
        corpus)."""
        p = int(nprobe if nprobe is not None else self.nprobe)
        p = max(p, -(-k // (self.dp * self.capacity)))
        p = min(p, self.local_clusters)
        return p, min(k, p * self.capacity)

    def _effective_candidates(self, k: int, candidates) -> int:
        """The hybrid's rerank pool: the call's, else the instance's, else
        max(2k, 128); never below k."""
        c = candidates if candidates is not None else self.candidates
        if c == "auto":
            c = max(2 * k, 128)
        return max(int(c), k)

    def _gather_bytes_per_query(self, p_used: int, c_used: int = 0) -> float:
        """Per-query device bytes of one search's transients, for search()'s
        batch shrink: every probed slot's fp32 score with its stable sort
        (values and int64 order) and its int64 row id, plus what is gathered:
        the hybrid's projected bf16 rows (and their fp32 copy on the CPU) and
        its ``c_used`` full rows; int8 rows, or on the CPU the rows or codes
        the plain versions gather, with their fp32 copy."""
        n = p_used * self.capacity
        transients = n * 24
        cpu = self.device.type != "cuda"
        if self.reduced_dim is not None:
            low = n * self.reduced_dim * (6 if cpu else 2)
            return transients + low + c_used * self.dim * (self.corpus.element_size() + 4)
        if not cpu and not self.quantized:
            return transients  # the kernels read the probed rows in place
        if self.pq_m is not None:
            return transients + n * self.pq_m * 13  # codes, int64 index, fp32
        return transients + n * self.dim * (self.corpus.element_size() + 4)

    def _probe_clusters(self, queries: torch.Tensor, p: int):
        """Each query's top-p clusters by the bf16 centroid product (fp32
        result), ties to the lower id; a balanced build ranks by the product
        minus its bias and keeps the raw product for the PQ score. Returns
        (probe [Q, p] int64, the probed raw scores [Q, p])."""
        qc = _bf16_mm(queries, self.centroids.T)
        if self.assign_bias is None:
            cent_s, probe = exact_topk(qc, p)
            return probe, cent_s
        _, probe = exact_topk(qc - self.assign_bias[None, :], p)
        return probe, torch.gather(qc, 1, probe)

    def _slot_rows(self, slots: torch.Tensor) -> torch.Tensor:
        """Stored rows of this rank's ``slots`` as fp32 (:meth:`_decode`)."""
        stored = self.corpus[:, slots].T if self._pq_cols else self.corpus[slots]
        return self._decode(stored, lambda: self.centroids[slots // self.capacity],
                            self.slot_scale[slots] if self.quantized else None)

    def _decode(self, stored: torch.Tensor, centroids, scale: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """fp32 rows of stored slot entries ``stored`` [n, D] (PQ codes [n,
        m]): fp32/bf16 rows as stored, int8 codes times their ``scale``, PQ
        as the codebook decode (un-rotated) plus ``centroids()``, each
        slot's cluster centroid [n, D]."""
        if self.pq_m is None:
            rows = stored.to(torch.float32)
            if self.quantized:
                rows = rows * scale[:, None]
            return rows
        m = self.pq_m
        z = _pq_reconstruct(stored, self.codebooks, m, self.dim // m).to(torch.float32)
        if self.rotation is not None:
            z = z @ self.rotation.T  # codes hold z = residual @ rot
        return z + centroids()

    def _rerank_scores(self, queries: torch.Tensor, rows: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
        """fp32 [Q, C] scores of stored ``rows`` [Q, C, D] (of ``slots``
        [Q, C]) at storage precision: true fp32 products for fp32 rows,
        bf16 operands with fp32 sums for bf16 rows and int8 codes, the
        latter times their slot scales."""
        if rows.dtype == torch.float32:
            return torch.bmm(rows, queries[:, :, None])[..., 0]
        s = _bf16_bmm(rows, queries[:, :, None])[..., 0]
        if self.quantized:
            s = s * self.slot_scale[slots]
        return s

    def _probe_block(self, queries: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
        """Rows: fp32 [Q, p * cap] scores of every probed slot."""
        q_n, cap = queries.shape[0], self.capacity
        if not self.quantized:
            return probe_scores(self.corpus, probe, queries, cap=cap).reshape(q_n, -1)
        # int8: no kernel (nor in the JAX package): gather, bf16-exact
        # product with fp32 sums, then the slot scales
        slots = (probe[:, :, None] * cap
                 + torch.arange(cap, device=probe.device)).reshape(q_n, -1)
        return self._rerank_scores(queries, self.corpus[slots], slots)

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

    def _search_hybrid(self, queries, probe, hit_ids, ok, k: int, kk: int, candidates):
        """PCA hybrid: every probed slot scored in the projected space (bf16
        operands, fp32 sums), ineligible slots masked BEFORE the candidate
        pick, the top C slots (exact top-k, lowest position first; JAX's
        ``approx_max_k`` with ``aggregate_to_topk`` is this exact top-k on
        the CPU) reranked at full width and storage precision."""
        q_n, cap = queries.shape[0], self.capacity
        slots = (probe[:, :, None] * cap
                 + torch.arange(cap, device=probe.device)).reshape(q_n, -1)
        cc = min(self._effective_candidates(k, candidates), slots.shape[1])
        q_low = (queries @ self.proj).to(torch.bfloat16)
        s1 = _bf16_bmm(self.corpus_low[slots], q_low[:, :, None])[..., 0]
        s1 = torch.where(ok, s1, NEG_INF)
        _, cpos = exact_topk(s1, cc)
        slots_sel = torch.gather(slots, 1, cpos)
        cand_ids = torch.gather(hit_ids, 1, cpos)
        s2 = self._rerank_scores(queries, self.corpus[slots_sel], slots_sel)
        s2 = torch.where(torch.gather(ok, 1, cpos), s2, NEG_INF)
        top_s, pos = exact_topk(s2, min(kk, cc))
        return top_s, torch.gather(cand_ids, 1, pos).long()

    def search_tensor(self, queries: torch.Tensor, k: int,
                      nprobe: Optional[int] = None, candidates: Optional[int] = None,
                      *, sel: Optional[torch.Tensor] = None):
        """Device-side search: (scores fp32 [Q, k'], indices int64 [Q, k'])
        on the index's device, k' = min(k, ntotal). ``sel``: a bool [ntotal]
        eligibility mask on the index's device (ineligible rows score -inf
        after the kernels, before the top-k; the probed clusters do not
        change). Unreachable tail slots are -inf / -1. Sharded, each rank
        probes its own clusters (the hybrid picks and reranks its
        candidates there too) and the shards' candidates merge (a
        collective; every rank returns the same)."""
        k = min(k, self.n_total)
        p, kk = self._effective_probe(k, nprobe)
        q = queries.to(self.device, torch.float32)
        probe, cent_s = self._probe_clusters(q, p)
        hit_ids = self.row_ids.view(self.local_clusters, self.capacity)[probe]
        hit_ids = hit_ids.reshape(q.shape[0], -1)
        ok = hit_ids >= 0  # filled slots, and of those the rows the filter allows
        if sel is not None:
            ok &= sel[hit_ids.clamp_min(0).long()]
        if self.reduced_dim is not None:
            top_s, top_i = self._search_hybrid(q, probe, hit_ids, ok, k, kk, candidates)
        else:
            if self.pq_m is not None:
                s = self._probe_block_pq(q, probe, cent_s)
            else:
                s = self._probe_block(q, probe)
            s = torch.where(ok, s, NEG_INF)
            top_s, pos = exact_topk(s, kk)
            top_i = torch.gather(hit_ids, 1, pos).long()
        if self.group is not None:
            return self._merge(top_s, top_i, k)
        return top_s, top_i

    def search(
        self,
        queries,
        k: int = 100,
        batch_size: int = 64,
        nprobe: Union[int, str, None] = None,
        candidates: Optional[int] = None,
        *,
        allowed_ids=None,
        disallowed_ids=None,
        selector=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched probe-and-score search from host queries. Returns numpy
        fp32 scores and int32 indices [Q, k'] (FlatIPIndex's surface); tail
        slots no probe reaches are -inf / -1, as in FAISS IVF.
        ``candidates``: the hybrid's rerank pool for this call.
        ``allowed_ids`` / ``disallowed_ids`` / ``selector`` (at most one)
        restrict the hits to a subset of rows (FAISS ``IDSelector``); the
        unfillable tail of a filtered search is -inf / -1. The probes do not
        change with the filter unless ``nprobe="filtered"``: then the nprobe
        is :meth:`tune_filtered_nprobe`'s for this filter (tuned on the first
        such call, cached), and the build's without a filter."""
        k = min(k, self.n_total)
        sel_mask = build_selector_mask(self.n_total, allowed_ids, disallowed_ids, selector)
        if nprobe == "filtered":
            nprobe = self.tune_filtered_nprobe(k, selector=sel_mask)
        p_used, _ = self._effective_probe(k, nprobe)
        c_used = (self._effective_candidates(k, candidates)
                  if self.reduced_dim is not None else 0)
        per_q = self._gather_bytes_per_query(p_used, c_used)
        max_bq = max(1, int(_GATHER_BUDGET // max(per_q, 1)))
        if max_bq < batch_size:
            logger.info("IVF search: shrinking query batch %d -> %d (nprobe %d x "
                        "capacity %d)", batch_size, max_bq, p_used, self.capacity)
            batch_size = max_bq
        sel = None if sel_mask is None else torch.from_numpy(sel_mask).to(self.device)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size]).to(self.device)
            s, i = self.search_tensor(block, k, nprobe, candidates, sel=sel)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        out_s, out_i = np.concatenate(scores), np.concatenate(indices)
        if sel_mask is not None:
            out_i = mask_filtered_misses(out_s, out_i)
        return out_s, out_i

    # ------------------------------------------------------------------
    # mutation (FAISS add / remove_ids analogs): each returns a NEW index;
    # the old one keeps its tensors, so searches running on it stay valid
    _CLONE_FIELDS = (
        "device", "dim", "quantized", "store_dtype", "recall_target",
        "spherical", "reduced_dim", "candidates", "pq_m", "pq_iters",
        "pq_rotate", "pq_layout", "codebooks", "_codebooks_host", "rotation",
        "_rotation_host", "n_clusters", "centroids", "_centroids_host",
        "proj", "nprobe", "local_clusters", "balance_eta",
        "_assign_bias_host", "assign_bias", "kmeans_split", "group", "dp", "shard",
    )

    def _clone_shell(self) -> "IVFIPIndex":
        """A new index with this one's trained parts (centroids, codebooks,
        rotation, PCA basis, bias) and tuned knobs, but no row storage."""
        out = IVFIPIndex.__new__(IVFIPIndex)
        for name in self._CLONE_FIELDS:
            setattr(out, name, getattr(self, name))
        out.build_seconds = {}
        return out

    def _grown_storage(self, new_cap: int):
        """Every slot array widened to ``new_cap`` slots per cluster (new
        slots empty: zero rows and codes, scale 1e-12, id -1): this rank's
        clusters on the device (a growth never crosses a shard), every
        cluster's ids on the host. Returns (corpus, slot_scale, corpus_low,
        row_ids_host)."""
        k_c, cap = self.local_clusters, self.capacity
        corpus = _grow_slots(self.corpus, k_c, cap, new_cap, axis=1 if self._pq_cols else 0)
        slot_scale = (_grow_slots(self.slot_scale, k_c, cap, new_cap, fill=1e-12)
                      if self.slot_scale is not None else None)
        corpus_low = (_grow_slots(self.corpus_low, k_c, cap, new_cap)
                      if self.corpus_low is not None else None)
        row_ids_host = np.pad(self._row_ids_host.reshape(self.n_clusters, cap),
                              ((0, 0), (0, new_cap - cap)), constant_values=-1).reshape(-1)
        return corpus, slot_scale, corpus_low, row_ids_host

    def _place_free(self, row_ids_host: np.ndarray, cand: np.ndarray,
                    capacity: int) -> np.ndarray:
        """Slots for new rows: a free slot in the first-choice cluster, else
        the second choice, else any free slot (spill). Run-rank placement
        over the free-slot list (removal leaves holes anywhere); the caller
        guarantees enough free slots. Deterministic (the JAX package's)."""
        n_new = cand.shape[0]
        free = np.nonzero(row_ids_host < 0)[0]  # ascending == cluster-major
        free_cluster = free // capacity
        k_c = self.n_clusters
        starts = np.searchsorted(free_cluster, np.arange(k_c))
        counts = np.searchsorted(free_cluster, np.arange(k_c), side="right") - starts
        used = np.zeros(k_c, np.int64)
        taken = np.zeros(free.size, bool)
        slots = np.full(n_new, -1, np.int64)
        remaining = np.arange(n_new)
        for choice in range(cand.shape[1]):
            if remaining.size == 0:
                break
            c = cand[remaining, choice].astype(np.int64)
            order = np.argsort(c, kind="stable")
            cs = c[order]
            rank = np.arange(len(cs)) - np.searchsorted(cs, cs, side="left")
            pos = used[cs] + rank
            ok = pos < counts[cs]
            fidx = starts[cs[ok]] + pos[ok]
            slots[remaining[order[ok]]] = free[fidx]
            taken[fidx] = True
            used += np.bincount(cs[ok], minlength=k_c)
            remaining = remaining[order[~ok]]
        if remaining.size:
            slots[remaining] = free[~taken][: remaining.size]
            logger.info(
                "IVFIPIndex.append: %d of %d new rows (%.2f%%) spilled outside "
                "their top-2 clusters (capacity %d)", remaining.size, n_new,
                100.0 * remaining.size / n_new, capacity)
        return slots

    def append_sharded(self, new_rows, n_new: int, *,
                       headroom: float = 0.0) -> "IVFIPIndex":
        """Append rows (FAISS ``IndexIVF.add``): ``new_rows`` fp32 [n_buf,
        D] (a tensor, moved to the index's device, or numpy), rows past
        ``n_new`` ignored. Centroids, PQ codebooks, the rotation and the PCA
        basis stay fixed; new rows take a free slot of their nearest cluster
        (second choice, then spill); when free slots run out, every
        cluster's capacity grows by the same multiple of the slot rounding
        (``headroom`` pre-pays extra free slots). ``nprobe`` survives.
        Returns a new index. Over a group ``new_rows`` is every new row on
        every rank: each assigns them against every cluster's centroid, runs
        the same host placement, and writes the slots of its own clusters
        (a growth keeps each shard's clusters on it)."""
        rows = torch.as_tensor(new_rows, dtype=torch.float32)
        n_new = validate_append_args(rows, n_new, headroom, self.dim)
        rows = rows[:n_new].to(self.device)
        budget = _CHUNK_BUDGET_CUDA if self.device.type == "cuda" else _CHUNK_BUDGET
        bias = (None if self._assign_bias_host is None
                else torch.from_numpy(self._assign_bias_host).to(self.device))
        cand = _assign_top2_body(rows, self._all_centroids(),
                                 chunk=_chunk_rows(n_new, self.n_clusters, budget),
                                 bias=bias).cpu().numpy()
        out = self._clone_shell()
        total_free = int((self._row_ids_host < 0).sum())
        if total_free < n_new:
            mult = self._capacity_multiple()
            extra = int(np.ceil(headroom * (self.n_total + n_new)))
            grow = -(-(n_new - total_free + extra) // self.n_clusters)
            out.capacity = self.capacity + -(-grow // mult) * mult
            corpus, slot_scale, corpus_low, row_ids_host = self._grown_storage(out.capacity)
        else:
            out.capacity = self.capacity
            corpus = self.corpus.clone()
            slot_scale = self.slot_scale.clone() if self.slot_scale is not None else None
            corpus_low = self.corpus_low.clone() if self.corpus_low is not None else None
            row_ids_host = self._row_ids_host
        slots_np = out._place_free(row_ids_host, cand, out.capacity)
        own = out._own_slots()
        mine = (slots_np >= own.start) & (slots_np < own.stop)
        if not mine.all():  # the rows that land in this rank's clusters
            rows = rows[torch.from_numpy(mine).to(self.device)]
        slots = torch.from_numpy(slots_np[mine] - own.start).to(self.device)
        out._write_slots(rows, slots, corpus, slot_scale, out.capacity)
        if corpus_low is not None:
            corpus_low[slots] = (rows @ self.proj).to(torch.bfloat16)
        out.corpus, out.slot_scale, out.corpus_low = corpus, slot_scale, corpus_low
        new_row_ids = row_ids_host.copy()
        new_row_ids[slots_np] = np.arange(self.n_total, self.n_total + n_new,
                                          dtype=new_row_ids.dtype)
        out.row_ids = torch.from_numpy(new_row_ids[own]).to(self.device)
        out.n_total = self.n_total + n_new
        out._set_layout_maps(new_row_ids)
        return out

    def remove_rows(self, removed) -> "IVFIPIndex":
        """Drop rows by corpus position (FAISS ``remove_ids``): survivors
        renumber down in order. Only ``row_ids`` changes (removed slots
        become empty, -1); the storage tensors are shared with this index,
        and freed slots take later appends. Over a group every rank
        renumbers the global ids on the host and keeps its own slots'."""
        removed = np.unique(np.asarray(removed, np.int64).reshape(-1))
        if removed.size == 0:
            return self
        if removed[0] < 0 or removed[-1] >= self.n_total:
            raise IndexError(
                f"remove ids must be in [0, {self.n_total}); got "
                f"[{removed[0]}, {removed[-1]}]"
            )
        if removed.size >= self.n_total:
            raise ValueError("cannot remove every row; build a new index")
        out = self._clone_shell()
        out.capacity = self.capacity
        out.n_total = self.n_total - int(removed.size)
        out.corpus = self.corpus
        out.slot_scale = self.slot_scale
        out.corpus_low = self.corpus_low
        r = self._row_ids_host
        is_removed = np.isin(r, removed.astype(r.dtype)) & (r >= 0)
        shift = np.searchsorted(removed, np.clip(r, 0, None)).astype(r.dtype)
        new_row_ids = np.where((r < 0) | is_removed, np.int32(-1), r - shift)
        out.row_ids = torch.from_numpy(new_row_ids[out._own_slots()]).to(self.device)
        out._set_layout_maps(new_row_ids)
        return out

    def reconstruct(self, ids) -> np.ndarray:
        """Stored rows of corpus ids as fp32 (FAISS ``reconstruct_batch``):
        fp32/bf16 rows at storage precision, int8 dequantized, PQ as centroid
        plus codebook decode (un-rotated). Sharded, the rows reach every
        rank from the ranks that hold them (a collective)."""
        ids = _canonical_recon_ids(ids, self.n_total)
        if ids.size == 0:
            return np.zeros((0, self.dim), np.float32)
        slots = self._slot_of_row[ids]
        if self.group is None:
            return _chunked_row_gather(self._slot_rows, slots, self.device)
        out = []
        for lo in range(0, slots.size, _RECON_CHUNK):
            sl = slots[lo : lo + _RECON_CHUNK]
            rows = self._decode(
                self._gather_slots(self.corpus, sl),
                lambda: torch.from_numpy(self._centroids_host[sl // self.capacity]).to(
                    self.device),
                self._gather_slots(self.slot_scale, sl) if self.quantized else None)
            out.append(rows.cpu().numpy())
        return np.concatenate(out)

    # ------------------------------------------------------------------
    def _exact_scan(self, queries: torch.Tensor, k: int, sel: Optional[torch.Tensor] = None):
        """Exact top-k over the STORED rows (int8 dequantized through the
        slot scale, PQ decoded as centroid + codebook rows in bf16), chunk
        by chunk with a running stable top-k merge; ``sel`` as in
        :meth:`search_tensor`. Sharded, each rank scans its own slots and the
        shards' top-k merge (JAX's ``_exact_callable``)."""
        cap, dev = self.capacity, self.device
        n_slots = self.local_clusters * cap
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
            ok = ids_c >= 0
            if sel is not None:
                ok &= sel[ids_c.clamp_min(0)]
            s = torch.where(ok[None, :], s, NEG_INF)
            cat_s = torch.cat([best_s, s], dim=1)
            cat_i = torch.cat([best_i, ids_c[None, :].expand(q_n, -1)], dim=1)
            best_s, pos = exact_topk(cat_s, k_local)
            best_i = torch.gather(cat_i, 1, pos)
        if self.group is not None:
            return self._merge(best_s, best_i, k)
        return best_s, best_i

    def exact_search(self, queries, k: int = 100, batch_size: int = 256, *,
                     allowed_ids=None, disallowed_ids=None, selector=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact (at storage precision) brute-force search over the stored
        rows, with search()'s output surface and filters: the tuner's
        reference and a recall oracle where no second fp32 corpus copy
        exists."""
        k = min(k, self.n_total)
        sel_mask = build_selector_mask(self.n_total, allowed_ids, disallowed_ids, selector)
        sel = None if sel_mask is None else torch.from_numpy(sel_mask).to(self.device)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size]).to(self.device)
            s, i = self._exact_scan(block, k, sel)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        out_s, out_i = np.concatenate(scores), np.concatenate(indices)
        if sel_mask is not None:
            out_i = mask_filtered_misses(out_s, out_i)
        return out_s, out_i
