"""Attention dispatch: the plain PyTorch reference and the hand-written
flash-attention kernel (port of ``rankpo_tpu.ops.attention``).

Shapes follow the JAX package: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with GQA
when Hq > Hkv (Hq % Hkv == 0); ``mask`` is a [B, Sk] key-validity mask
(non-zero = valid); ``causal`` adds the autoregressive constraint with
bottom-right alignment when Sq != Sk, and ``window`` (with ``causal`` only,
the HF Mistral/Qwen2 sliding-window rule) keeps the keys with
q_pos - k_pos < window, where q_pos = row + Sk - Sq. ``segment_ids`` [B, S]
(sequence packing, Sq == Sk, in place of ``mask``): contiguous segments
1..n and a 0-id pad tail; a query sees the keys of its own segment only
(block-diagonal attention, combined with ``causal`` and ``window``).

Dispatch is by device, never by a silent fallback: ``impl="auto"`` runs the
CUDA kernels (``ops/flash_attention.py``) on a CUDA tensor and
:func:`attention_reference` on a CPU tensor. ``impl="plain"`` forces the
reference (used to compare the two on the card); ``impl="flash"`` forces the
kernels, which raise on a CPU tensor. When a gradient is needed, the kernel
path goes through the ``FlashAttention`` autograd Function (forward K1, the
backward kernels K2 or K3a + K3b); the reference is differentiated by
autograd. The kernels take head_dim 64, 128 and 256 (Gemma's): any other
head_dim raises on a CUDA tensor (ROADMAP.md Queue 2), where the JAX
dispatcher sends such shapes to its XLA path
(``rankpo_tpu/ops/attention.py:83-89``).

Attention-probs dropout (``dropout_rate`` > 0 with a ``generator``) runs
:func:`attention_reference` on every device, as the JAX dispatcher sends it
to its XLA path (``rankpo_tpu/ops/attention.py:122-126``): the kernels, like
the Pallas kernel, have no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free for fully-masked rows

IMPLS = ("auto", "plain", "flash")
BWD_IMPLS = ("auto", "fused", "split")  # backward kernels on CUDA tensors


def check_segments(segment_ids: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                   b: int, sq: int, sk: int) -> None:
    """JAX's argument rules for ``segment_ids`` (``flash_attention.py:731-741``,
    ``attention.py:116-117``): self-attention shapes, [B, S], not with
    ``mask``."""
    if segment_ids is None:
        return
    if mask is not None:
        raise ValueError("pass segment_ids OR mask, not both "
                         "(key validity is segment_ids != 0)")
    if sq != sk:
        raise ValueError(f"segment_ids requires self-attention shapes (sq == sk), "
                         f"got sq={sq} sk={sk}")
    if tuple(segment_ids.shape) != (b, sk):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != {(b, sk)}")


def allowed_pairs(sq: int, sk: int, causal: bool, window: Optional[int], device,
                  segment_ids: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Bool mask of the (query, key) pairs causality, the window and the
    segments allow, or None when every pair is allowed: [Sq, Sk] without
    ``segment_ids``, else [B, 1, 1, Sq, Sk] (broadcast over the kv heads and
    the GQA group). Causality is bottom-right aligned; the window applies
    only under ``causal``, as in JAX's ``_xla_attention``
    (``attention.py:47-67``): keys with k_pos > q_pos - window; a packed
    pair needs the key's segment non-zero and equal to the query's."""
    allowed = None
    if causal:
        ones = torch.ones(sq, sk, dtype=torch.bool, device=device)
        allowed = ones.tril(diagonal=sk - sq)
        if window is not None:
            allowed &= ones.triu(diagonal=sk - sq - window + 1)
    if segment_ids is not None:
        seg = segment_ids.to(device)
        pairs = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
        allowed = pairs if allowed is None else pairs & allowed
        allowed = allowed[:, None, None]
    return allowed


def masked_logits(
    q: torch.Tensor,
    k: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled fp32 logits [B, Hkv, G, Sq, Sk] with masked entries at NEG_INF
    (pad keys, and the pairs :func:`allowed_pairs` leaves out). GQA groups
    ride a reshape of q, so K is never repeated."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    # q is scaled in its own dtype first, as _xla_attention does
    qf = (q * scale).reshape(b, sq, hkv, groups, d).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    if mask is not None:
        key_valid = mask.to(torch.bool)[:, None, None, None, :]
        logits.masked_fill_(~key_valid, NEG_INF)
    allowed = allowed_pairs(sq, sk, causal, window, q.device, segment_ids)
    if allowed is not None:
        logits.masked_fill_(~allowed, NEG_INF)
    return logits


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the JAX package's rule (``roberta._dropout``):
    each entry kept with probability 1 - rate (drawn from ``generator``,
    which must be on x's device) and divided by 1 - rate in x's dtype.
    The identity for rate 0 or no generator."""
    if rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention, ported from ``rankpo_tpu.ops.attention._xla_attention``:
    fp32 logits and softmax, probabilities cast to v's dtype for the PV
    product, rows with no valid key (all pad, a pad row of a packed row, or
    a window past every valid key) output zeros, then attention-probs
    dropout when ``dropout_rate`` > 0 and a ``generator`` is given (JAX
    ``attention.py:71-74``). Returns [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    check_segments(segment_ids, mask, b, sq, k.shape[1])
    logits = masked_logits(q, k, mask, causal, window, segment_ids)
    probs = torch.softmax(logits, dim=-1)
    # rows with NO attendable key output zeros (softmax over all-NEG_INF
    # logits is a meaningless uniform average); the kernel does the same
    any_valid = logits.amax(dim=-1, keepdim=True) > NEG_INF * 0.5
    probs = torch.where(any_valid, probs, 0.0).to(v.dtype)
    probs = dropout(probs, dropout_rate, generator)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    impl: str = "auto",
    skip_pad_q: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    bwd_impl: str = "auto",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, key mask, optional causality.

    ``skip_pad_q`` lets the kernel skip query tiles that start past the row's
    valid length (their rows become zeros, and their gradients too); the
    plain path computes them. Only self-attention over right-padded rows may
    set it: pad keys are masked everywhere, so pad rows never reach a valid
    row. ``window`` (sliding-window attention, with ``causal``) runs on both
    paths: the kernels skip the key tiles outside the band. ``bwd_impl``
    ("auto" | "fused" | "split") picks the backward kernels
    (``flash_attention.flash_attention_bwd``); "auto" is split.
    ``dropout_rate`` > 0 with a ``generator`` runs the plain path with
    attention-probs dropout on any device and any ``impl``, as the JAX
    dispatcher does. ``segment_ids`` (packing, see the module
    docstring) runs on every path; the kernels skip the tiles outside each
    query tile's segments."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    check_segments(segment_ids, mask, q.shape[0], q.shape[1], k.shape[1])
    if dropout_rate > 0.0 and generator is not None:
        return attention_reference(q, k, v, mask, causal, dropout_rate, generator,
                                   window=window, segment_ids=segment_ids)
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return attention_reference(q, k, v, mask, causal, window=window,
                                   segment_ids=segment_ids)
    from rankpo_tpu_torch.ops import flash_attention as flash

    kw = dict(causal=causal, skip_pad_q=skip_pad_q, window=window, segment_ids=segment_ids)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return flash.flash_attention(q, k, v, mask, bwd_impl=bwd_impl, **kw)
    out, _lse = flash.flash_attention_fwd(q, k, v, mask, **kw)
    return out
