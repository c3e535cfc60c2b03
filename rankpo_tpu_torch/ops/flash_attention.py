"""Flash-attention forward on Hopper: wrapper, launch counter and plain version.

Replaces ``rankpo_tpu/ops/flash_attention.py:_fwd_kernel`` (the Pallas TPU
FlashAttention-2 forward, reached through ``_flash_fwd_impl`` /
``flash_attention``) with a CUDA C++ kernel written for ``sm_90a``
(``ops/csrc/flash_fwd.cu``), built with nvcc at first use
(``ops/_build.py``) and called through a plain C entry point with ctypes.

What bounds it on an H100 at the serving shapes (S <= 512, D = 64, 32 query
heads over 8 kv heads): per (batch, head) the K/V rows are at most 128 KB and
are read about once per 64-row query tile, so the kernel is bound by latency
and occupancy rather than HBM bandwidth or tensor-core peak, and attention
is a small share of a layer's FLOPs next to the projections. The design keeps
many small blocks in flight (one per 64 query rows of one head), runs both
products on the tensor cores with ``mma.sync`` and skips whole key tiles past
the valid length and above the causal diagonal (see the kernel's header).

The kernel takes bf16 only, head_dim 64 or 128, a key mask, causal and
``skip_pad_q``. ``window`` and ``segment_ids`` are not ported yet and raise.
It is forward-only: the backward kernels (``_bwd_fused_kernel``, or
``_dq_kernel`` + ``_dkv_kernel``) are not ported, so a call that would need a
gradient raises.

:func:`flash_attention_fwd_reference` is the plain PyTorch version of the
same contract, used by the CPU tests and by ``chip_smoke.py`` to check the
kernel on the card.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from rankpo_tpu_torch.ops.attention import NEG_INF, masked_logits

# launches of the CUDA kernel in this process (read by chip_smoke.py to show
# the main path went through it); incremented only after a launch succeeded
launches = 0
_count_lock = threading.Lock()

HEAD_DIMS = (64, 128)


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out [B, Sq, Hq, D] in v's dtype,
    lse [B, Hq, Sq] fp32). Rows with no valid key give zeros and
    lse = NEG_INF, as the kernel does. Computes every row (no skip_pad_q)."""
    b, sq, hq, d = q.shape
    logits = masked_logits(q, k, mask, causal)  # [B, Hkv, G, Sq, Sk]
    any_valid = logits.amax(dim=-1) > NEG_INF * 0.5
    lse = torch.where(any_valid, torch.logsumexp(logits, dim=-1), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(any_valid[..., None], probs, 0.0).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, sq, hq, d)
    return out, lse.reshape(b, hq, sq)


def _check_rows(name: str, x: torch.Tensor) -> None:
    """The kernel reads each [D] row with 16-byte vector loads."""
    if x.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: strides {tuple(x.stride())} and the data pointer must "
            "keep each row 16-byte aligned"
        )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    skip_pad_q: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 on
    one CUDA device, mask [B, Sk] (non-zero = valid key, default all valid).
    Returns (out [B, Sq, Hq, D] bf16, lse [B, Hq, Sq] fp32).

    Strided inputs are read in place (no transpose copy). With
    ``skip_pad_q``, query tiles that start at or past the valid key length
    output zeros: compare only rows below the valid length."""
    global launches
    if window is not None or segment_ids is not None:
        raise NotImplementedError(
            "flash kernel: `window` and `segment_ids` are not ported yet "
            "(ROADMAP.md Queue 2, K1 variants)"
        )
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v)
    ):
        raise NotImplementedError(
            "flash kernel is forward-only: the backward kernels K2 "
            "(_bwd_fused_kernel) and K3 (_dq_kernel/_dkv_kernel) are not "
            "ported yet; run under torch.inference_mode()"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(
                f"flash kernel: {name} is on {x.device}; the kernel runs on "
                "CUDA tensors only (use impl='plain' for the reference)"
            )
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel: {name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash kernel: {name} must be [B, S, H, D]")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash kernel: shapes q {q.shape} k {k.shape} v {v.shape}")
    if hq % hkv:
        raise ValueError(f"flash kernel: Hq {hq} not a multiple of Hkv {hkv}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one device")
    if sq == 0 or sk == 0 or b == 0:
        raise ValueError("flash kernel: empty sequence or batch")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x)
    if mask is None:
        mask = torch.ones((b, sk), dtype=torch.int32, device=q.device)
    if mask.shape != (b, sk):
        raise ValueError(f"flash kernel: mask {tuple(mask.shape)} != {(b, sk)}")
    mask = mask.to(device=q.device, dtype=torch.int32).contiguous()

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    out = torch.empty((b, sq, hq, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rankpo_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
            int(causal), int(skip_pad_q), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {rc}")
    with _count_lock:
        launches += 1
    return out, lse
