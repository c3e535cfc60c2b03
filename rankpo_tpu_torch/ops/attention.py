"""Attention dispatch: the plain PyTorch reference and the hand-written
flash-attention kernel (port of ``rankpo_tpu.ops.attention``).

Shapes follow the JAX package: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with GQA
when Hq > Hkv (Hq % Hkv == 0); ``mask`` is a [B, Sk] key-validity mask
(non-zero = valid); ``causal`` adds the autoregressive constraint with
bottom-right alignment when Sq != Sk.

Dispatch is by device, never by a silent fallback: ``impl="auto"`` runs the
CUDA kernels (``ops/flash_attention.py``) on a CUDA tensor and
:func:`attention_reference` on a CPU tensor. ``impl="plain"`` forces the
reference (used to compare the two on the card); ``impl="flash"`` forces the
kernels, which raise on a CPU tensor. When a gradient is needed, the kernel
path goes through the ``FlashAttention`` autograd Function (forward K1, the
backward kernels K2 or K3a + K3b); the reference is differentiated by
autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free for fully-masked rows

IMPLS = ("auto", "plain", "flash")
BWD_IMPLS = ("auto", "fused", "split")  # backward kernels on CUDA tensors


def masked_logits(
    q: torch.Tensor,
    k: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
) -> torch.Tensor:
    """Scaled fp32 logits [B, Hkv, G, Sq, Sk] with masked entries at NEG_INF.
    GQA groups ride a reshape of q, so K is never repeated."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    # q is scaled in its own dtype first, as _xla_attention does
    qf = (q * scale).reshape(b, sq, hkv, groups, d).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    if mask is not None:
        key_valid = mask.to(torch.bool)[:, None, None, None, :]
        logits = logits.masked_fill(~key_valid, NEG_INF)
    if causal:
        allowed = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq
        )
        logits = logits.masked_fill(~allowed, NEG_INF)
    return logits


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
) -> torch.Tensor:
    """Plain attention, ported from ``rankpo_tpu.ops.attention._xla_attention``:
    fp32 logits and softmax, probabilities cast to v's dtype for the PV
    product, rows with no valid key output zeros. Returns [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    logits = masked_logits(q, k, mask, causal)
    probs = torch.softmax(logits, dim=-1)
    # rows with NO attendable key output zeros (softmax over all-NEG_INF
    # logits is a meaningless uniform average); the kernel does the same
    any_valid = logits.amax(dim=-1, keepdim=True) > NEG_INF * 0.5
    probs = torch.where(any_valid, probs, 0.0).to(v.dtype)
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
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, key mask, optional causality.

    ``skip_pad_q`` lets the kernel skip query tiles that start past the row's
    valid length (their rows become zeros, and their gradients too); the
    plain path computes them. Only self-attention over right-padded rows may
    set it: pad keys are masked everywhere, so pad rows never reach a valid
    row. ``bwd_impl`` ("auto" | "fused" | "split") picks the backward
    kernels (``flash_attention.flash_attention_bwd``); "auto" is split,
    which repeats bit for bit, under ``torch.use_deterministic_algorithms``
    and fused otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if window is not None or segment_ids is not None:
        raise NotImplementedError(
            "sliding-window and segment_ids (packed) attention are not ported "
            "yet (ROADMAP.md Queue 2, K1 variants)"
        )
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return attention_reference(q, k, v, mask, causal)
    from rankpo_tpu_torch.ops import flash_attention as flash

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return flash.flash_attention(
            q, k, v, mask, causal=causal, skip_pad_q=skip_pad_q,
            bwd_impl=bwd_impl,
        )
    out, _lse = flash.flash_attention_fwd(
        q, k, v, mask, causal=causal, skip_pad_q=skip_pad_q
    )
    return out
