"""Flash attention on Hopper: wrappers, launch counters and plain versions.

Replaces the Pallas TPU kernels of ``rankpo_tpu/ops/flash_attention.py``
with CUDA C++ kernels written for ``sm_90a``, built with nvcc at first use
(``ops/_build.py``) and called through plain C entry points with ctypes:

- ``_fwd_kernel`` (K1, the FlashAttention-2 forward, reached through
  ``_flash_fwd_impl``) -> :func:`flash_attention_fwd`,
  ``ops/csrc/flash_fwd.cu``;
- ``_bwd_fused_kernel`` (K2, ``flash_bwd_fused``), ``_dq_kernel`` (K3a,
  ``flash_dq``) and ``_dkv_kernel`` (K3b, ``flash_dkv``) ->
  :func:`flash_attention_bwd`, ``ops/csrc/flash_bwd.cu``.

:class:`FlashAttention` is the ``torch.autograd.Function`` around them, in
the role of JAX's ``_flash`` custom_vjp: its forward saves (q, k, v, mask,
out, lse), its backward computes ``delta = rowsum(dO * O)`` in fp32 and runs
the backward kernels.

What bounds them on an H100 at the encoder's shapes (S <= 512, D = 64, 32
query heads over 8 kv heads): per (batch, head) the K/V rows are at most
64 KB and are read once per 64-row tile, so the kernels are bound by
latency rather than HBM bandwidth or tensor-core peak, and attention is a
small share of a layer next to the projections. Every kernel skips whole
tiles past the valid length and above the causal diagonal. K1 is built for
Hopper (``sm_90a``): one producer warp loads K/V tiles with TMA into an
mbarrier ring shared by the query heads of a GQA group, one consumer
warpgroup per head, both products on ``wgmma``. K2 and K3b are built the
same way around one (batch, kv head, key tile): K and V loaded once, the
Q/dO tiles of the whole GQA group streamed through the ring, every product
on ``wgmma``, dK/dV summed over the group in the kernel; K2 adds each key
tile's dQ in key-tile order. K3a is K1's design with a third product: per
(batch, kv head, query heads of the group, query tile) the K/V tiles come
through the ring, and dQ = dS K stays in registers across the key tiles (see
the kernels' headers). Every kernel repeats bit for bit.

The kernels take bf16 only, head_dim 64, 128 or 256, a key mask, causal,
``skip_pad_q`` and ``window`` (sliding-window attention, with ``causal``:
row q sees keys with q_pos - k_pos < window). With a window every kernel
skips the key tiles (K1, K3a) or query tiles (K2, K3b) outside the band, as
the JAX kernels skip blocks, so its work grows with S * window rather than
S^2. ``segment_ids`` (sequence packing, Sq == Sk, in place of the mask)
makes attention block-diagonal: the mask buffer carries the segment ids, as
JAX's wrapper passes them (``flash_attention.py:741``), and builds of each
kernel with ``kPacked`` test each pair's segments and visit only the tiles
of a query tile's (K1, K3a) or key tile's (K2, K3b) segments, JAX's bounds
(``flash_attention.py:132-147``, ``:222-233``, ``:314-328``, ``:429-442``).
At head_dim 256 (Gemma) K1 and K3a run one query head per block, and K2
and K3b two blocks per key tile, one per 128-column half of dK/dV/dQ, each
computing the whole S^T and dP^T (``flash_bwd.cu``'s header). Other head
dims raise on a CUDA tensor (ROADMAP.md Queue 2).

:func:`flash_attention_fwd_reference` and :func:`flash_attention_bwd_reference`
are the plain PyTorch versions of the same contracts, used by the CPU tests
and by ``chip_smoke.py`` to check the kernels on the card.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from rankpo_tpu_torch.ops.attention import (BWD_IMPLS, NEG_INF, allowed_pairs,
                                            check_segments, masked_logits)

# launches of each CUDA kernel in this process (read by chip_smoke.py to show
# the main path went through them); incremented only after a launch
# succeeded. ``window_launches`` counts the launches among them that ran with
# a sliding window, ``d256_launches`` those at head_dim 256,
# ``packed_launches`` those with ``segment_ids``.
launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_dq": 0, "flash_dkv": 0}
window_launches = dict(launches)
d256_launches = dict(launches)
packed_launches = dict(launches)
_count_lock = threading.Lock()

HEAD_DIMS = (64, 128, 256)


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
            window_launches[name] = 0
            d256_launches[name] = 0
            packed_launches[name] = 0


def _count(name: str, window: Optional[int], head_dim: int, packed: bool) -> None:
    with _count_lock:
        launches[name] += 1
        if window is not None:
            window_launches[name] += 1
        if head_dim == 256:
            d256_launches[name] += 1
        if packed:
            packed_launches[name] += 1


def _check_window(window: Optional[int], causal: bool) -> int:
    """The kernels' window argument: -1 for none. As JAX's
    ``flash_attention`` (``flash_attention.py:722-725``): a window needs
    ``causal`` and must be positive."""
    if window is None:
        return -1
    if not causal:
        raise ValueError("window requires causal attention (HF SWA rule)")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return int(window)


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out [B, Sq, Hq, D] in v's dtype,
    lse [B, Hq, Sq] fp32). Rows with no valid key (pad rows of a packed
    row among them) give zeros and lse = NEG_INF, as the kernel does.
    Computes every row (no skip_pad_q)."""
    b, sq, hq, d = q.shape
    check_segments(segment_ids, mask, b, sq, k.shape[1])
    logits = masked_logits(q, k, mask, causal, window, segment_ids)  # [B, Hkv, G, Sq, Sk]
    any_valid = logits.amax(dim=-1) > NEG_INF * 0.5
    lse = torch.where(any_valid, torch.logsumexp(logits, dim=-1), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(any_valid[..., None], probs, 0.0).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, sq, hq, d)
    return out, lse.reshape(b, hq, sq)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward from the forward's stats, with the contract of JAX's
    ``flash_bwd_fused``: q/do [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], lse and
    delta [B, Hq, Sq] fp32. Returns fp32 (dq [B, Sq, Hq, D], dk, dv
    [B, Sk, Hkv, D]), dk/dv summed over each GQA group.

    s = scale * q.k in fp32; p = exp(s - lse) on valid entries and 0
    elsewhere, and 0 on rows whose lse is NEG_INF (no key seen by the
    forward); dv = p^T do with p cast to do's dtype; dp = do v^T;
    ds = p (dp - delta) scale cast to q's dtype; dk = ds^T q; dq = ds k."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    check_segments(segment_ids, mask, b, sq, sk)
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    qf = q.to(torch.float32).reshape(b, sq, hkv, groups, d)
    dof = do.to(torch.float32).reshape(b, sq, hkv, groups, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    valid = torch.ones(b, 1, 1, sq, sk, dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)[:, None, None, None, :]
    allowed = allowed_pairs(sq, sk, causal, window, q.device, segment_ids)
    if allowed is not None:
        valid = valid & allowed
    lse5 = lse.to(torch.float32).reshape(b, hkv, groups, sq, 1)
    delta5 = delta.to(torch.float32).reshape(b, hkv, groups, sq, 1)
    valid = valid & (lse5 > NEG_INF * 0.5)
    p = torch.where(valid, torch.exp(torch.where(valid, s - lse5, 0.0)), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).to(torch.float32), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = (p * (dp - delta5) * scale).to(q.dtype).to(torch.float32)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    return dq, dk, dv


def _check_rows(name: str, x: torch.Tensor) -> None:
    """The backward kernels read each [D] row with 16-byte vector loads, and
    K1 reads tiles by TMA, which needs a 16-byte-aligned base and strides
    that are multiples of 16 bytes."""
    if x.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: strides {tuple(x.stride())} and the data pointer must "
            "keep each row 16-byte aligned"
        )


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
        raise ValueError(
            f"flash kernel: head_dim {d} not in {HEAD_DIMS} (other head dims are "
            "not ported yet: ROADMAP.md Queue 2)"
        )
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


def _int_mask(mask: Optional[torch.Tensor], segment_ids: Optional[torch.Tensor], b: int,
              sk: int, device: torch.device) -> torch.Tensor:
    """The kernels' int32 [B, Sk] mask buffer: the key mask (all valid by
    default), or the segment ids in packed mode."""
    if segment_ids is not None:
        mask = segment_ids
    if mask is None:
        return torch.ones((b, sk), dtype=torch.int32, device=device)
    if mask.shape != (b, sk):
        raise ValueError(f"flash kernel: mask {tuple(mask.shape)} != {(b, sk)}")
    return mask.to(device=device, dtype=torch.int32).contiguous()


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
    """Launch K1: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 on one CUDA
    device, mask [B, Sk] (non-zero = valid key, default all valid).
    Returns (out [B, Sq, Hq, D] bf16, lse [B, Hq, Sq] fp32). No gradient
    flows through this call; :class:`FlashAttention` is the differentiable
    form.

    Strided inputs are read in place (no transpose copy). With
    ``skip_pad_q``, query tiles that start at or past the valid key length
    output zeros: compare only rows below the valid length. ``window``
    (with ``causal``): rows see keys with q_pos - k_pos < window; a row
    that sees no valid key outputs zeros and lse NEG_INF. ``segment_ids``
    [B, S] (Sq == Sk, no ``mask``): contiguous segments 1..n with a 0-id
    pad tail, attention within each segment only."""
    win = _check_window(window, causal)
    check_segments(segment_ids, mask, q.shape[0], q.shape[1], k.shape[1])
    _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    mask = _int_mask(mask, segment_ids, b, sk, q.device)
    packed = segment_ids is not None

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
            int(causal), int(skip_pad_q), win, int(packed), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {rc}")
    _count("flash_fwd", window, d, packed)
    return out, lse


def resolve_bwd_impl(bwd_impl: str) -> str:
    """"fused" or "split" for a ``bwd_impl`` of :data:`BWD_IMPLS`: "auto" is
    split, with or without ``torch.use_deterministic_algorithms``: on the
    H100 the split kernels ran faster than K2 at every shape measured
    (PERF.md), so the JAX package's VMEM threshold does not apply. Both
    repeat bit for bit; the split kernels need no workspace and no ordering
    between blocks."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    if bwd_impl == "auto":
        return "split"
    return bwd_impl


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = False,
    skip_pad_q: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    bwd_impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the forward's inputs and stats:
    q/do [B, Sq, Hq, D] bf16, k/v [B, Sk, Hkv, D] bf16, lse and delta
    [B, Hq, Sq] fp32. Returns (dq, dk, dv) in the inputs' dtype (bf16).

    ``bwd_impl``:

    - ``"fused"`` (K2): one pass per key tile; each key tile's dq is added in
      fp32 in key-tile order (a zeroed int32 workspace of counters orders
      the blocks), as JAX's resident dq block sums it;
    - ``"split"`` (K3a + K3b): the dq kernel loops over key tiles per query
      tile and holds dq in registers;
    - ``"auto"``: split (:func:`resolve_bwd_impl`). The JAX package picks
      split above 8·Sq·D > 4 MiB (``flash_attention.py:777``), a VMEM budget
      for its resident dq block; on the H100 split was the faster at every
      shape measured, below that size too.

    Both give dq, dk and dv that repeat bit for bit. K2 and K3b sum each GQA
    group's dk/dv in the kernel, as ``flash_bwd_fused`` sums them per
    group, and write them in bf16. ``window`` and ``segment_ids`` are the
    forward's."""
    bwd_impl = resolve_bwd_impl(bwd_impl)
    win = _check_window(window, causal)
    check_segments(segment_ids, mask, q.shape[0], q.shape[1], k.shape[1])
    _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash kernel: do {tuple(do.shape)} {do.dtype} must match q")
    _check_rows("do", do)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, hq, sq) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous fp32 {(b, hq, sq)}")
        if x.device != q.device:
            raise ValueError(f"flash kernel: {name} must be on {q.device}")
    mask = _int_mask(mask, segment_ids, b, sk, q.device)
    packed = segment_ids is not None

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    dev = q.device
    fused = bwd_impl == "fused"
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=dev)
    dv = torch.empty_like(dk)
    sync = None
    if fused:
        dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
        # the blocks' start order and one counter per (b * h, query tile,
        # column half: two at head_dim 256, flash_bwd.cu KvTiles::kSplit)
        halves = 2 if d == 256 else 1
        sync = torch.zeros(1 + b * hq * -(-sq // 64) * halves, dtype=torch.int32,
                           device=dev)
        steps = (("flash_bwd_fused", lib.rankpo_flash_bwd_fused_bf16),)
    else:
        dq = torch.empty((b, sq, hq, d), dtype=torch.bfloat16, device=dev)
        steps = (("flash_dq", lib.rankpo_flash_bwd_dq_bf16),
                 ("flash_dkv", lib.rankpo_flash_bwd_dkv_bf16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, fn in steps:
            rc = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if sync is None else sync.data_ptr(),
                b, sq, sk, hq, hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], mask.stride(0),
                int(causal), int(skip_pad_q), win, int(packed), stream,
            )
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
            _count(name, window, d, packed)
    if fused:
        dq = dq.permute(0, 2, 1, 3).to(q.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable K1 + backward kernels (JAX ``_flash`` custom_vjp,
    ``flash_attention.py:497-547`` and ``_flash_bwd``, ``:666-682``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal: bool, skip_pad_q: bool,
                bwd_impl: str, window: Optional[int] = None,
                segment_ids: Optional[torch.Tensor] = None):
        out, lse = flash_attention_fwd(
            q, k, v, mask, causal=causal, skip_pad_q=skip_pad_q, window=window,
            segment_ids=segment_ids,
        )
        ctx.save_for_backward(q, k, v, mask, segment_ids, out, lse)
        ctx.causal, ctx.skip_pad_q, ctx.bwd_impl = causal, skip_pad_q, bwd_impl
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, segment_ids, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O) in fp32 (flash_attention.py:669)
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
        delta = delta.permute(0, 2, 1).contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, mask, do, lse, delta, causal=ctx.causal,
            skip_pad_q=ctx.skip_pad_q, window=ctx.window, segment_ids=segment_ids,
            bwd_impl=ctx.bwd_impl,
        )
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    skip_pad_q: bool = False,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    bwd_impl: str = "auto",
) -> torch.Tensor:
    """Differentiable flash attention on CUDA tensors: out [B, Sq, Hq, D]."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    _check_window(window, causal)
    return FlashAttention.apply(q, k, v, mask, causal, skip_pad_q, bwd_impl, window,
                                segment_ids)
