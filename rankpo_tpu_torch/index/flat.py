"""Brute-force inner-product index on one device (port of
``rankpo_tpu.index.flat``: ``numpy_search`` and ``FlatIPIndex``), and the
helpers every index tier shares: the append-argument contract, the int8
row codec, the ``IDSelector``-style filter mask and its tail rewrite, and
the reconstruct id check and row gather.

The corpus matrix stays on the device it was encoded on, stored as fp32
rows (FAISS ``IndexFlatIP`` parity: exact fp32 scores, descending, ties by
lower index), bf16 rows (``SQbf16``) or int8 codes with a per-row scale
(``SQ8``). A search runs ``ops/topk.py``'s ``matmul_topk`` there, exact or,
with ``recall_target < 1``, approximate. ``append_sharded`` /
``remove_rows`` mutate it (FAISS ``add`` / ``remove_ids``, each returning a
new index), ``reconstruct`` decodes stored rows, ``range_search`` returns
every row above a radius.

With ``group=`` (the data group of a multi-process run) the index is
row-sharded as the JAX index is over its data axis: ``n_padded`` is a
multiple of the group's size dp, and data index d stores the global rows
``core/mesh.py`` ``shard_bounds(n_padded, dp, d)`` on its own device. A
search runs the product and top-k on the shard (ids offset to global rows),
all-gathers the ``[Q, min(k, rows a shard)]`` candidates over the group in
rank order and takes a stable top-k of them, so every rank ends with the
same hits in FAISS's lowest-id tie order (JAX's ``lax.top_k`` over
shard-ordered candidates). Filters are each shard's slice of the global
mask; appends and removals keep JAX's global layout (rows whose shard
changes move through the group, ``mesh.exchange_rows``); ``reconstruct``
and ``rows`` gather to every rank. Every rank must make the same calls in
the same order (each is a collective). Without a group everything is one
device's, as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.ops.topk import (
    bf16_mm,
    divide_exact,
    exact_topk,
    matmul_topk,
    require_fp32_matmul,
)

_RECON_BATCH = 1024  # reconstruct gathers ids in chunks of this many
_QUANT_CHUNK = 1 << 16  # rows per chunk of the int8 and bf16 storage casts
_ROW_MULTIPLE = 8  # int8 storage rows: cuBLASLt's int8 GEMM takes N % 8 == 0


def quantize_rows_int8(rows: torch.Tensor, *, times_reciprocal: bool = False):
    """Symmetric per-row max-abs int8 codes and fp32 scales: the JAX
    package's one row codec, for the flat and IVF tiers (zero rows get
    scale 1e-12 and zero codes). Its host constructors compute the scale as
    ``max / 127``; its device path (``from_sharded``, the streamed build,
    appends) through XLA, which computes ``max * (1 / 127)``, one fp32 ulp
    apart in ~4% of rows: ``times_reciprocal`` takes that rounding, so both
    packages store the same scales on every path, on the card too
    (:func:`divide_exact`). Returns ``(codes int8 [N, D], scale fp32
    [N])``."""
    rows = rows.to(torch.float32)
    peak = rows.abs().amax(dim=1)
    scale = peak * (1.0 / 127.0) if times_reciprocal else divide_exact(peak, 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    codes = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def _as_store_dtype(dtype) -> torch.dtype:
    """A storage dtype given as a torch dtype or its name."""
    if isinstance(dtype, str):
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}[dtype]
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"flat storage dtype must be fp32, bf16 or int8, got {dtype}")
    return dtype


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


class Shards:
    """What every tier sharded over the data group shares: ``group`` (None:
    one device), its size ``dp``, this rank's data index ``shard``, and the
    merge of the shards' candidates."""

    group = None
    dp, shard = 1, 0
    # the tensor attributes every rank of a group holds whole
    _replicated: Tuple[str, ...] = ()

    def nbytes(self) -> int:
        """Bytes of every torch tensor the index holds; over a group, the sum
        over the ranks with a ``_replicated`` tensor counted once (JAX's
        global ``nbytes``; a collective)."""
        own = whole = 0
        for name, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                if name in self._replicated:
                    whole += v.numel() * v.element_size()
                else:
                    own += v.numel() * v.element_size()
        if self.group is None:
            return own + whole
        total = torch.tensor([own], dtype=torch.int64, device=self.device)
        return int(mesh.all_reduce_(total, self.group).item()) + whole

    def _set_group(self, group) -> None:
        self.group = group
        self.dp = mesh.group_size(group) if group is not None else 1
        self.shard = mesh.group_index(group) if group is not None else 0

    def _merge(self, scores: torch.Tensor, ids: torch.Tensor, k: int):
        """The shards' candidates ``[Q, k_local]`` (ids global) gathered over
        the group in rank order, then a stable top-k of them: every rank gets
        the same hits, equal scores in ascending-id order."""
        cand_s = mesh.all_gather_rows(scores.T, self.group).T
        cand_i = mesh.all_gather_rows(ids.T, self.group).T
        top_s, pos = exact_topk(cand_s, min(k, cand_s.shape[1]))
        return top_s, torch.gather(cand_i, 1, pos)


class RowShards(Shards):
    """The row-shard layout the flat and refine tiers share: the global
    ``n_total`` and ``n_padded``, and the shard's ``shard_rows`` from global
    row ``shard_lo`` on."""

    def _set_layout(self, group, n_padded: int) -> None:
        self._set_group(group)
        if n_padded % self.dp:
            raise ValueError(f"padded rows ({n_padded}) must be divisible by {self.dp} shards")
        self.n_padded = int(n_padded)
        self.shard_rows = self.n_padded // self.dp
        self.shard_lo = self.shard * self.shard_rows

    def _local_valid(self, n_total: Optional[int] = None) -> int:
        """Rows of this shard below ``n_total`` (default the index's)."""
        n = self.n_total if n_total is None else n_total
        if self.group is None:
            return n
        return int(np.clip(n - self.shard_lo, 0, self.shard_rows))

    def _local_mask(self, sel: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
        """This shard's slice of a bool [n_total] eligibility mask, padded
        with False to the stored rows."""
        if sel is None:
            return None
        rows = self.shard_rows if self.group is not None else self.n_padded
        lo = self.shard_lo if self.group is not None else 0
        mask = torch.zeros(rows, dtype=torch.bool, device=device)
        nv = self._local_valid()
        mask[:nv] = sel[lo : lo + nv].to(device)
        return mask

    def _gather_rows(self, storage: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
        """Stored rows at global ``ids`` on every rank (a collective)."""
        return mesh.exchange_rows(storage, ids, self.shard_rows, self.group)

    def _relayout(self, storage: torch.Tensor, src_ids: np.ndarray, shard_rows: int,
                  fill=0.0) -> torch.Tensor:
        """This rank's ``shard_rows`` rows of a new layout whose global row j
        is the old global row ``src_ids[j]`` (rows past ``src_ids``: ``fill``);
        rows whose shard changes move through the group."""
        n = len(src_ids)
        dest = np.arange(n) // shard_rows
        mine = mesh.exchange_rows(storage, src_ids, self.shard_rows, self.group, dest)
        out = storage.new_full((shard_rows,) + tuple(storage.shape[1:]), fill)
        out[: mine.shape[0]] = mine
        return out


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


class FlatIPIndex(RowShards):
    """Brute-force inner-product index over fp32, bf16 or int8 rows on one
    device (the device of ``embeddings`` when it is a tensor, else the CPU),
    or row-sharded over ``group`` (module docstring).

    ``embeddings``: [N_buf, D] numpy array or tensor; rows at or past
    ``n_total`` (default N_buf) are padding and never returned. ``dtype``:
    the storage, fp32 (exact FAISS parity), bf16 (half the memory) or
    ``torch.int8`` (a quarter: symmetric per-row max-abs codes, the scale
    applied to the scores). ``recall_target < 1``: approximate top-k (the
    serving mode); ``precision``: the fp32 rows' product ("float32" or
    "default", ``ops/topk.py``). The constructor quantizes with the JAX
    constructor's rounding, :meth:`from_sharded` and appends with its
    device path's. With ``group``, ``embeddings`` is the whole corpus on
    every rank and each keeps its shard."""

    def __init__(self, embeddings, *, n_total: Optional[int] = None, dtype=torch.float32,
                 recall_target: float = 1.0, precision: Optional[str] = None, group=None):
        self._init(embeddings, n_total, dtype, recall_target, precision,
                   times_reciprocal=False, group=group, whole=True)

    @classmethod
    def from_sharded(cls, embeddings, n_total: int, *, dtype=torch.float32,
                     recall_target: float = 1.0, precision: Optional[str] = None,
                     group=None, times_reciprocal: bool = True) -> "FlatIPIndex":
        """Build from device-resident fp32 rows (``InferenceEncoder.
        encode_device``'s layout, rows past ``n_total`` ignored), int8
        codes rounded as the JAX package's device path rounds them
        (``times_reciprocal=False``: as its host constructor does). With
        ``group``: this rank's shard (``encode_shard``'s layout) of a corpus
        of ``n_total`` rows."""
        self = cls.__new__(cls)
        self._init(embeddings, n_total, dtype, recall_target, precision,
                   times_reciprocal=times_reciprocal, group=group, whole=False)
        return self

    def _init(self, embeddings, n_total, dtype, recall_target, precision, *,
              times_reciprocal: bool, group, whole: bool) -> None:
        require_fp32_matmul()
        self.dtype = _as_store_dtype(dtype)
        self.quantized = self.dtype == torch.int8
        self.recall_target = float(recall_target)
        self.precision = precision
        # a tensor keeps its device (and, as fp32, its storage); numpy goes
        # to the CPU
        rows = torch.as_tensor(embeddings)
        if rows.dim() != 2:
            raise ValueError(f"embeddings must be [N, D], got {tuple(rows.shape)}")
        self.dim = int(rows.shape[1])
        if group is not None:
            self._init_shard(rows, n_total, group, whole, times_reciprocal)
            return
        self.n_total = int(rows.shape[0] if n_total is None else n_total)
        if not 0 < self.n_total <= rows.shape[0]:
            raise ValueError(f"n_total {self.n_total} outside (0, {rows.shape[0]}]")
        if self.dtype == torch.float32:
            self.corpus = rows.to(torch.float32)
            self.row_scale = None
        else:
            self.corpus, self.row_scale = self._encode_rows(
                rows[: self.n_total], self._storage_rows(self.n_total),
                times_reciprocal=times_reciprocal)
        self.n_padded = int(self.corpus.shape[0])
        # the row count written into storage the index owns: an append writes
        # in place only into rows no other index on that storage has written.
        # fp32 rows are the caller's tensor (or numpy memory): never written
        self._fill = [-1 if self.dtype == torch.float32 else self.n_total]

    def _init_shard(self, rows: torch.Tensor, n_total, group, whole: bool,
                    times_reciprocal: bool) -> None:
        """The shard of a sharded build: ``rows`` the whole corpus
        (``whole``) or this rank's shard."""
        dp = mesh.group_size(group)
        if whole:
            self.n_total = int(rows.shape[0] if n_total is None else n_total)
            self._set_layout(group, mesh.padded_rows(self.n_total, dp))
            local = rows[self.shard_lo : self.shard_lo + self._local_valid()]
        else:
            self.n_total = int(n_total)
            self._set_layout(group, int(rows.shape[0]) * dp)
            local = rows[: self._local_valid()]
        if not 0 < self.n_total <= self.n_padded:
            raise ValueError(f"n_total {self.n_total} outside (0, {self.n_padded}]")
        if self.dtype == torch.float32 and not whole:
            self.corpus, self.row_scale = rows.to(torch.float32), None
        else:
            self.corpus, self.row_scale = self._encode_rows(
                local, self.shard_rows, times_reciprocal=times_reciprocal)
        self._fill = [-1]

    def _storage_rows(self, rows: int) -> int:
        if self.group is not None:
            return self.shard_rows
        return -(-rows // _ROW_MULTIPLE) * _ROW_MULTIPLE if self.quantized else rows

    def _encode_rows(self, rows: torch.Tensor, n_rows: Optional[int] = None, *,
                     times_reciprocal: bool = True):
        """(stored rows, scales or None) of fp32 rows, cast or quantized
        chunk by chunk into storage of ``n_rows`` rows (default: as many as
        ``rows``; the rest zero rows of scale 1e-12), so that a 2^20-row
        corpus needs no second copy of its storage."""
        n = rows.shape[0]
        corpus, scale = self._empty_storage(n if n_rows is None else n_rows, rows.device)
        for lo in range(0, n, _QUANT_CHUNK):
            block = rows[lo : lo + _QUANT_CHUNK].to(torch.float32)
            hi = lo + block.shape[0]
            if self.quantized:
                corpus[lo:hi], scale[lo:hi] = quantize_rows_int8(
                    block, times_reciprocal=times_reciprocal)
            else:
                corpus[lo:hi] = block
        return corpus, scale

    def _empty_storage(self, n_rows: int, device):
        """(zero rows [n_rows, D] of the storage dtype, scales of the
        codec's zero-row floor 1e-12 or None)."""
        corpus = torch.zeros(n_rows, self.dim, dtype=self.dtype, device=device)
        scale = torch.full((n_rows,), 1e-12, device=device) if self.quantized else None
        return corpus, scale

    def _clone_shell(self) -> "FlatIPIndex":
        """A new index with this one's configuration and no storage."""
        out = FlatIPIndex.__new__(FlatIPIndex)
        for name in ("dtype", "quantized", "recall_target", "precision", "dim"):
            setattr(out, name, getattr(self, name))
        if self.group is not None:
            out._set_layout(self.group, self.n_padded)
        return out

    @property
    def ntotal(self) -> int:
        return self.n_total

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    # ------------------------------------------------------------------
    def search_tensor(self, queries: torch.Tensor, k: int, *,
                      sel: Optional[torch.Tensor] = None):
        """Device-side search: (scores fp32 [Q, k'], indices int64 [Q, k'])
        on the index's device, k' = min(k, ntotal). ``sel``: a bool
        [ntotal] eligibility mask (ineligible rows score -inf). int8 storage
        takes bf16 queries, as the JAX package casts them. Sharded: a
        collective, with the same queries on every rank."""
        k = min(k, self.n_total)
        q = queries.to(self.device)
        if self.quantized:
            q = q.to(torch.bfloat16)
        if self.group is None:
            return matmul_topk(q, self.corpus, k=k, n_valid=self.n_total,
                               recall_target=self.recall_target, col_scale=self.row_scale,
                               precision=self.precision,
                               row_mask=self._local_mask(sel, self.device))
        s, i = matmul_topk(q, self.corpus, k=min(k, self.shard_rows),
                           n_valid=self._local_valid(), recall_target=self.recall_target,
                           col_scale=self.row_scale, precision=self.precision,
                           row_mask=self._local_mask(sel, self.device))
        return self._merge(s, i + self.shard_lo, k)

    def search(self, queries, k: int = 100, batch_size: int = 256, *, allowed_ids=None,
               disallowed_ids=None, selector=None):
        """Batched top-k from host queries (analog of the reference's
        faiss_search). Returns numpy fp32 scores and int32 indices [Q, k'].
        ``allowed_ids`` / ``disallowed_ids`` / ``selector`` (at most one)
        restrict the search to a subset of rows (FAISS ``IDSelector``); when
        fewer than k rows are eligible the tail is -inf / -1."""
        k = min(k, self.n_total)
        sel_mask = build_selector_mask(self.n_total, allowed_ids, disallowed_ids, selector)
        sel = None if sel_mask is None else torch.from_numpy(sel_mask).to(self.device)
        queries = np.asarray(queries, np.float32)
        scores, indices = [], []
        for lo in range(0, queries.shape[0], batch_size):
            block = torch.from_numpy(queries[lo : lo + batch_size])
            s, i = self.search_tensor(block, k, sel=sel)
            scores.append(s.cpu().numpy())
            indices.append(i.to(torch.int32).cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        out_s, out_i = np.concatenate(scores), np.concatenate(indices)
        if sel_mask is not None:
            out_i = mask_filtered_misses(out_s, out_i)
        return out_s, out_i

    # ------------------------------------------------------------------
    def append_sharded(self, new_rows, n_new: int, *, headroom: float = 0.0
                       ) -> "FlatIPIndex":
        """Append rows (FAISS ``index.add``): ``new_rows`` fp32 [n_buf, D]
        (a tensor, moved to the index's device, or numpy), rows past
        ``n_new`` ignored. Existing rows ride over bit-exactly (int8 codes
        and scales are copied, never requantized); the new rows are cast or
        quantized with the device path's rounding. When they fit the pad
        rows that no other index on this storage has written, they are
        written there in place; otherwise the storage grows to
        ``(n_total + n_new) * (1 + headroom)`` rows, the headroom being pad
        rows for later appends. Returns a new index."""
        rows = torch.as_tensor(new_rows, dtype=torch.float32)
        n_new = validate_append_args(rows, n_new, headroom, self.dim)
        if self.group is not None:
            return self._append_shard(rows, n_new, headroom)
        new_store, new_scale = self._encode_rows(rows[:n_new].to(self.device))
        out = self._clone_shell()
        n_old, out.n_total = self.n_total, self.n_total + n_new
        if out.n_total <= self.n_padded and self._fill[0] == n_old:
            corpus, scale = self.corpus, self.row_scale
            out._fill = self._fill
        else:
            want = max(out.n_total, int(np.ceil(out.n_total * (1.0 + headroom))))
            corpus, scale = self._empty_storage(self._storage_rows(want), self.device)
            corpus[:n_old] = self.corpus[:n_old]
            if scale is not None:
                scale[:n_old] = self.row_scale[:n_old]
            out._fill = [n_old]
        with torch.inference_mode():  # storage a service made is an inference tensor
            corpus[n_old : out.n_total] = new_store
            if scale is not None:
                scale[n_old : out.n_total] = new_scale
        out._fill[0] = out.n_total
        out.corpus, out.row_scale = corpus, scale
        out.n_padded = int(corpus.shape[0])
        return out

    def _append_shard(self, rows: torch.Tensor, n_new: int, headroom: float
                      ) -> "FlatIPIndex":
        """``append_sharded`` of a sharded index: ``rows`` are the new rows
        on every rank; each keeps those that land in its shard. Storage grows
        as JAX's does, to ``ceil((n_total + n_new) * (1 + headroom))`` rows
        rounded up to a multiple of the group's size."""
        n_old = self.n_total
        out = self._clone_shell()
        out.n_total = n_old + n_new
        n_padded = self.n_padded
        if out.n_total > n_padded:
            n_padded = mesh.padded_rows(int(np.ceil(out.n_total * (1.0 + headroom))), self.dp)
        out._set_layout(self.group, n_padded)
        with torch.inference_mode():
            if n_padded == self.n_padded:
                corpus = self.corpus.clone()
                scale = None if self.row_scale is None else self.row_scale.clone()
            else:  # the layout grows: rows whose shard changes move
                src = np.arange(n_old)
                corpus = self._relayout(self.corpus, src, out.shard_rows)
                scale = (None if self.row_scale is None
                         else self._relayout(self.row_scale, src, out.shard_rows, 1e-12))
            lo = max(out.shard_lo, n_old)
            hi = min(out.shard_lo + out.shard_rows, out.n_total)
            if hi > lo:
                store, new_scale = self._encode_rows(
                    rows[lo - n_old : hi - n_old].to(self.device))
                corpus[lo - out.shard_lo : hi - out.shard_lo] = store
                if scale is not None:
                    scale[lo - out.shard_lo : hi - out.shard_lo] = new_scale
        out.corpus, out.row_scale, out._fill = corpus, scale, [-1]
        return out

    def remove_rows(self, removed) -> "FlatIPIndex":
        """Drop rows by corpus position (FAISS ``remove_ids``): survivors
        shift down in order; codes and scales are gathered, never
        requantized. The padded row count is kept, the freed rows becoming
        pad rows for later appends. Returns a new index."""
        removed = np.unique(np.asarray(removed, np.int64).reshape(-1))
        if removed.size == 0:
            return self
        if removed[0] < 0 or removed[-1] >= self.n_total:
            raise IndexError(f"remove ids must be in [0, {self.n_total}); got "
                             f"[{removed[0]}, {removed[-1]}]")
        keep = np.ones(self.n_total, bool)
        keep[removed] = False
        keep_idx = torch.from_numpy(np.nonzero(keep)[0]).to(self.device)
        if keep_idx.numel() == 0:
            raise ValueError("cannot remove every row; build a new index")
        if self.group is not None:  # survivors keep the layout, shifted down
            out = self._clone_shell()
            out.n_total = int(keep_idx.numel())
            src = np.nonzero(keep)[0]
            with torch.inference_mode():
                out.corpus = self._relayout(self.corpus, src, self.shard_rows)
                out.row_scale = (None if self.row_scale is None else
                                 self._relayout(self.row_scale, src, self.shard_rows, 1e-12))
            out._fill = [-1]
            return out
        out = self._clone_shell()
        out.n_total = int(keep_idx.numel())
        out.corpus, out.row_scale = self._empty_storage(self.n_padded, self.device)
        torch.index_select(self.corpus, 0, keep_idx, out=out.corpus[: out.n_total])
        if self.quantized:
            torch.index_select(self.row_scale, 0, keep_idx, out=out.row_scale[: out.n_total])
        out.n_padded = self.n_padded
        out._fill = [out.n_total]
        return out

    def _decoded(self, idx: torch.Tensor) -> torch.Tensor:
        rows = self.corpus[idx].to(torch.float32)
        if self.quantized:
            rows = rows * self.row_scale[idx][:, None]
        return rows

    def reconstruct(self, ids) -> np.ndarray:
        """Stored rows of corpus ids as fp32 (FAISS ``reconstruct_batch``):
        fp32 exactly, bf16 at storage precision, int8 codes times their
        scale (the stored approximation, not the original row)."""
        ids = _canonical_recon_ids(ids, self.n_total)
        if ids.size == 0:
            return np.zeros((0, self.dim), np.float32)
        if self.group is not None:
            rows = self._gather_rows(self.corpus, ids).to(torch.float32)
            if self.quantized:
                rows = rows * self._gather_rows(self.row_scale, ids)[:, None]
            return rows.cpu().numpy()
        return _chunked_row_gather(self._decoded, ids, self.device)

    def rows(self) -> np.ndarray:
        """The stored rows [ntotal, D] as host fp32 (decoded)."""
        return self.reconstruct(np.arange(self.n_total))

    def _range_counts(self, queries: torch.Tensor, radius: float) -> torch.Tensor:
        """Per query, the rows whose bf16-pass score clears ``radius`` (the
        JAX count pass: bf16 operands, fp32 sums, times the int8 scale);
        sharded, the shards' counts summed."""
        counts = torch.zeros(queries.shape[0], dtype=torch.int64, device=self.device)
        step = max(_ROW_MULTIPLE, (1 << 28) // max(queries.shape[0] * 4, 1))
        n_local = self._local_valid()
        for lo in range(0, n_local, step):
            hi = min(lo + step, n_local)
            s = bf16_mm(queries, self.corpus[lo:hi].T)
            if self.quantized:
                s = s * self.row_scale[lo:hi][None, :]
            counts += (s > radius).sum(dim=1)
        if self.group is not None:  # the shards' counts summed
            mesh.all_reduce_(counts, self.group)
        return counts

    def range_search(self, queries, radius: float, *, batch_size: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every row scoring strictly above ``radius`` per query (FAISS
        ``range_search`` for inner product). Returns CSR ``(lims [Q+1]
        int64, scores fp32, ids int64)``: query q's hits are
        ``ids[lims[q]:lims[q+1]]``, descending. A bf16 count pass sizes the
        top-k of each query batch (the largest count, rounded up to a power
        of two); while the k-th returned score still clears the radius (the
        two passes round differently at the boundary) the search reruns at
        twice the k. Membership always comes from the search's scores."""
        queries = np.asarray(queries, np.float32)
        radius = float(radius)
        n_q = queries.shape[0]
        per_s, per_i = [], []
        for lo in range(0, n_q, batch_size):
            block = queries[lo : lo + batch_size]
            counts = self._range_counts(torch.from_numpy(block).to(self.device), radius)
            # the count pass is bf16: with no count, still probe the top 1
            max_c = max(1, int(counts.max()))
            k = min(self.n_total, 1 << (max_c - 1).bit_length())
            while True:
                s, i = self.search(block, k=k, batch_size=batch_size)
                if k >= self.n_total or not (s[:, -1] > radius).any():
                    break
                k = min(self.n_total, k * 2)
            for r in range(block.shape[0]):
                m = s[r] > radius
                per_s.append(s[r][m])
                per_i.append(i[r][m].astype(np.int64))
        lims = np.zeros(n_q + 1, np.int64)
        np.cumsum([len(x) for x in per_i], out=lims[1:])
        scores = np.concatenate(per_s) if per_s else np.zeros(0, np.float32)
        ids = np.concatenate(per_i) if per_i else np.zeros(0, np.int64)
        return lims, scores.astype(np.float32, copy=False), ids
