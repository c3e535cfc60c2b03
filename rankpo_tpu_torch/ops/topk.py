"""Matmul + top-k, the compute core of the flat index (port of
``rankpo_tpu.ops.topk``: ``dense_matmul_topk`` and ``matmul_topk``).

Scores: exact search over fp32 rows promises the scores FAISS IndexFlatIP
would compute, so fp32 matrix products must not run in TF32
(:func:`require_fp32_matmul`; PyTorch's defaults already are
``allow_tf32 = False`` and precision "highest", the call pins them against
any other code that relaxed them). bf16 rows score as exact products of the
bf16 queries and rows summed in fp32 (JAX's ``preferred_element_type``);
int8 rows either dequantize to bf16 chunk by chunk, or, the default on the
card as on the JAX package's accelerator, take a true int8 x int8 -> int32
product of per-row quantized queries and the codes (``torch._int_mm``,
cuBLASLt; the JAX package computes this product outside any Pallas kernel).

Selection: FAISS, and ``index/flat.py:numpy_search``, return the lower corpus
index first among equal scores. PyTorch does not document the tie order of
``torch.topk`` on CUDA, so exact selection is a stable descending sort,
which keeps equal scores in ascending-index order by construction (the JAX
package's two-pass ``exact_topk_blockmax`` is a TPU sort workaround with the
same result). ``recall_target < 1`` is the approximate serving mode: one
pass of bf16 operands (fp32 rows rounded; int8 rows as always) with fp32
sums, and one ``torch.topk``. JAX writes bf16 scores there and calls
``lax.approx_max_k``; the port keeps the fp32 sums, whose error is that of
the operands' rounding alone, not also a bf16 rounding of every score (which
ties whole bands of near-equal scores). Its contract is recall against the
exact fp32 search at or above the target, not equal hits.

Chunking: ``matmul_topk`` cuts the columns under a score-matrix budget, and
further so that no chunk converts more than ``CAST_BUDGET`` bytes of rows
(int8 dequant, fp32 rows rounded to bf16), and merges previous best, then
chunk: the lower index still wins a tie across a chunk boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")
# bytes of fp32 scores one chunk may hold (the JAX package's default)
DENSE_SCORE_BUDGET = 1 << 32
# bytes of converted rows (dequantized int8, fp32 rounded to bf16) per chunk
CAST_BUDGET = 1 << 30
_INT_MM_MIN_ROWS = 17  # torch._int_mm: more than 16 rows in the left operand


def require_fp32_matmul() -> None:
    """fp32 products in full fp32 (no TF32) for exact search scores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties by lowest index."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def divide_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as an IEEE division on every device. PyTorch's CUDA
    kernel turns a division by a host scalar into a product with its
    reciprocal, one ulp off the quotient in some entries; a divisor tensor
    on ``x``'s device keeps the division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_queries_int8(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes [Q, D], fp32 scale [Q]) of queries, the JAX package's
    query codec for the int8 product: scale max|q| / 127 (floored at
    1e-12 before the division), codes rounded half to even and clipped to
    +-127."""
    qf = queries.to(torch.float32)
    q_scale = divide_exact(torch.clamp_min(qf.abs().amax(dim=1), 1e-12), 127.0)
    q8 = torch.clamp(torch.round(qf / q_scale[:, None]), -127, 127).to(torch.int8)
    return q8, q_scale


def int8_product(q8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int32 [Q, N] = q8 [Q, D] . codes [N, D] exactly. On the card one
    cuBLASLt int8 GEMM (``torch._int_mm``: the left operand padded to more
    than 16 rows, N padded to a multiple of 8; D must be one); on the CPU
    an int64 product cast back (the sums of a 2048-wide row stay far below
    2^31)."""
    if not q8.is_cuda:
        return (q8.to(torch.int64) @ codes.to(torch.int64).T).to(torch.int32)
    q_n, n = q8.shape[0], codes.shape[0]
    rows = max(q_n, _INT_MM_MIN_ROWS)
    rows = -(-rows // 8) * 8
    if rows != q_n:
        q8 = torch.nn.functional.pad(q8, (0, 0, 0, rows - q_n))
    n8 = -(-n // 8) * 8
    if n8 != n:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, n8 - n))
    return torch._int_mm(q8, codes.T)[:q_n, :n]


def int8_product_available(corpus: torch.Tensor) -> bool:
    """The default of ``int8_mm``: int8 storage on the card at a width
    cuBLASLt's int8 GEMM takes (the JAX package turns its int8 path on on
    its accelerator only)."""
    return corpus.dtype == torch.int8 and corpus.is_cuda and corpus.shape[1] % 8 == 0


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` of the bf16-rounded operands: exact products summed
    in fp32 (JAX's bf16 einsum with ``preferred_element_type=float32``;
    torch's bf16 matmul would round the result to bf16). On the card one
    bf16 tensor-core GEMM with an fp32 output; on the CPU an fp32 product
    of the rounded values (the same contract)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def dense_matmul_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    k: int,
    n_valid: Optional[int] = None,
    index_offset: int = 0,
    recall_target: float = 1.0,
    col_scale: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
    int8_mm: Optional[bool] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole [Q, N] score matrix and its top-k (k' = min(k, N)).

    ``corpus``: fp32, bf16 or int8 rows; ``col_scale`` the int8 rows'
    per-row scale, applied before selection. ``n_valid``: rows at or past
    it are padding and score -inf; ``row_mask`` (bool [N]): rows where it
    is False score -inf (the FAISS ``IDSelector`` analog).
    ``recall_target < 1``: the approximate mode (module docstring).
    ``precision`` (fp32 rows): "float32"/"highest" fp32 products, "default"
    one pass of bf16 operands; None is fp32 in exact mode and bf16 operands
    in the approximate mode, as the JAX package. ``int8_mm``: int8 rows take the
    int8 product (the queries quantized per row; selection needs only
    ``col_scale``, the query scale multiplies the selected scores after);
    None is :func:`int8_product_available`. Returns (scores fp32 [Q, k'],
    indices int64 [Q, k'] + ``index_offset``)."""
    n = corpus.shape[0]
    k = min(k, n)
    approx = recall_target < 1.0
    quantized = corpus.dtype == torch.int8
    if int8_mm is None:
        int8_mm = int8_product_available(corpus)
    q_scale = None
    if quantized and int8_mm:
        q8, q_scale = quantize_queries_int8(queries)
        scores = int8_product(q8, corpus).to(torch.float32)
    elif corpus.dtype != torch.float32 or (
            precision or ("default" if approx else "float32")) == "default":
        # bf16 rows, int8 codes (exact in bf16, the scale after) or fp32
        # rows in one bf16 pass
        scores = bf16_mm(queries, corpus.T)
    else:
        scores = queries.to(torch.float32) @ corpus.T
    if col_scale is not None:
        scores = scores * col_scale[None, :]
    if n_valid is not None and n_valid < n:
        scores[:, n_valid:] = NEG_INF
    if row_mask is not None:
        scores = torch.where(row_mask[None, :], scores, NEG_INF)
    if approx:
        top_s, idx = torch.topk(scores, k, dim=1)
    else:
        top_s, idx = exact_topk(scores, k)
    if q_scale is not None:
        top_s = top_s * q_scale[:, None]
    return top_s, idx + index_offset


def _converts_rows(corpus: torch.Tensor, recall_target: float, precision: Optional[str],
                   int8_mm: Optional[bool]) -> bool:
    """Whether the score product converts the rows first (int8 dequant, or
    fp32 rows rounded to bf16)."""
    if corpus.dtype == torch.int8:
        return not (int8_product_available(corpus) if int8_mm is None else int8_mm)
    if corpus.dtype == torch.float32:
        return precision == "default" or (precision is None and recall_target < 1.0)
    return False


def matmul_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    k: int,
    n_valid: Optional[int] = None,
    block_size: int = 4096,
    recall_target: float = 1.0,
    col_scale: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
    int8_mm: Optional[bool] = None,
    score_budget: Optional[int] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [N, D] -> (scores fp32 [Q, k'], indices int64
    [Q, k']), k' = min(k, N); the other arguments are
    :func:`dense_matmul_topk`'s.

    One dense pass when the fp32 score matrix fits ``score_budget`` (None:
    ``DENSE_SCORE_BUDGET``) and no more than ``CAST_BUDGET`` bytes of rows
    are converted; otherwise column chunks of at least ``block_size`` rows
    (a multiple of 8), each through the dense pass, merged as (previous
    best, chunk) so that a tie across a chunk boundary keeps the lower
    index."""
    n, d = corpus.shape
    q = queries.shape[0]
    k = min(k, n)
    if score_budget is None:
        score_budget = DENSE_SCORE_BUDGET
    chunk = max(min(block_size, n), min(n, score_budget // max(4 * q, 1)))
    if _converts_rows(corpus, recall_target, precision, int8_mm):
        chunk = min(chunk, max(block_size, CAST_BUDGET // max(4 * d, 1)))
    chunk = max(8, chunk // 8 * 8)
    kwargs = dict(recall_target=recall_target, precision=precision, int8_mm=int8_mm)
    if chunk >= n:
        return dense_matmul_topk(queries, corpus, k=k, n_valid=n_valid,
                                 col_scale=col_scale, row_mask=row_mask, **kwargs)
    n_valid = n if n_valid is None else n_valid
    best_s = best_i = None
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        blk_s, blk_i = dense_matmul_topk(
            queries, corpus[lo:hi], k=min(k, hi - lo),
            n_valid=max(0, min(n_valid - lo, hi - lo)), index_offset=lo,
            col_scale=None if col_scale is None else col_scale[lo:hi],
            row_mask=None if row_mask is None else row_mask[lo:hi], **kwargs)
        if best_s is None:
            best_s, best_i = blk_s, blk_i
            continue
        # chunks ascend in index: (previous best, chunk) and a stable sort
        # keep the lowest index first among equal scores
        cat_s = torch.cat([best_s, blk_s], dim=1)
        cat_i = torch.cat([best_i, blk_i], dim=1)
        best_s, pos = exact_topk(cat_s, min(k, cat_s.shape[1]))
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i
