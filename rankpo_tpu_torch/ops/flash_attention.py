"""Flash attention on Hopper: wrappers, launch counters and plain versions.

Replaces the Pallas TPU kernels of ``rankpo_tpu/ops/flash_attention.py``
with CUDA C++ kernels written for ``sm_90a``, built with nvcc at first use
(``ops/_build.py``) and called through plain C entry points with ctypes:

- ``_fwd_kernel`` (K1, the FlashAttention-2 forward, reached through
  ``_flash_fwd_impl``) -> :func:`flash_attention_fwd`,
  ``ops/csrc/flash_fwd.cu``;
- ``_bwd_fused_kernel`` (K2, ``flash_bwd_fused``), ``_dq_kernel`` (K3a,
  ``flash_dq``) and ``_dkv_kernel`` (K3b, ``flash_dkv``) ->
  :func:`flash_attention_bwd`, ``ops/csrc/flash_bwd.cu``. :func:`flash_dq`
  and :func:`flash_dkv` launch K3a and K3b alone on given lse and delta, as
  JAX's two functions do for its ring attention
  (``parallel/ring_attention.py``); :func:`flash_dkv` runs K3b's fp32-output
  build (counted in ``f32_launches``), so the ring sums its partials in
  fp32.

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

The Hopper kernels take bf16 at head_dim 64, 128 or 256, a key mask, causal,
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
computing the whole S^T and dP^T (``flash_bwd.cu``'s header).

Every other input JAX's kernels take (fp32, fp16, and bf16 at a head_dim
outside 64/128/256; any head_dim that is a multiple of 8) runs the generic
build of the same four kernels, ``ops/csrc/flash_generic.cu`` (one object
per dtype): the element type passed at run time, the same masks, tile
bounds and outputs, any head_dim (the output columns split over blocks
where one block cannot hold them). All four run on the tensor cores
through ``mma.sync`` (bf16/fp16 directly, fp32 as three TF32 passes that
keep fp32's accuracy) with sums in registers and ``cp.async`` staging.
:func:`kernel_for` names the build that runs (``generic_launches`` counts
its launches beside ``launches``). ``ops/attention.py``'s "auto" dispatch
runs the Hopper kernels where they are built, the generic build where JAX's
dispatch runs its kernel (:func:`jax_runs_kernel`), and the plain attention
elsewhere (:func:`routes_to_reference`, counted in ``reference_routes``).

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

# launches of each CUDA kernel in this process, either build (read by
# chip_smoke.py to show the main path went through them); incremented only
# after a launch succeeded. ``generic_launches`` counts the launches among
# them of the generic build, ``window_launches`` those that ran with a
# sliding window, ``d256_launches`` those at head_dim 256,
# ``packed_launches`` those with ``segment_ids``, ``f32_launches`` those
# with K3b's fp32 dK/dV (``flash_dkv``).
launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_dq": 0, "flash_dkv": 0}
generic_launches = dict(launches)
window_launches = dict(launches)
d256_launches = dict(launches)
packed_launches = dict(launches)
f32_launches = dict(launches)
# calls that ``ops/attention.py`` sent to the plain attention under
# impl="auto" on a CUDA tensor (routes_to_reference), by the reason: q's
# dtype, else its head_dim
reference_routes = {"dtype": 0, "head_dim": 0}
_count_lock = threading.Lock()

HEAD_DIMS = (64, 128, 256)
# the generic build's element types, by the code its C entry points take
GENERIC_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# JAX's "auto" runs its Pallas kernel from this many query positions on
JAX_FLASH_MIN_SEQ = 1024


def kernel_fits(q: torch.Tensor) -> bool:
    """Whether the Hopper kernels are built for ``q``'s dtype and head_dim
    (bf16 at HEAD_DIMS)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in HEAD_DIMS


def kernel_for(q: torch.Tensor) -> Optional[str]:
    """The build that runs the flash kernels on ``q`` [B, S, H, D]:
    "hopper" (``flash_fwd.cu``, ``flash_bwd.cu``) where :func:`kernel_fits`,
    "generic" (``flash_generic.cu``) for fp32, fp16 or bf16 at any other
    head_dim that is a multiple of 8, None for anything else."""
    if kernel_fits(q):
        return "hopper"
    d = q.shape[-1]
    if q.dtype in GENERIC_DTYPES and d > 0 and d % 8 == 0:
        return "generic"
    return None


def jax_runs_kernel(q: torch.Tensor) -> bool:
    """Whether JAX's "auto" dispatch runs its Pallas kernel on ``q`` [B, S,
    H, D] on the TPU (``_use_flash``, ``rankpo_tpu/ops/attention.py:83-89``):
    D a multiple of 8 and at least 64, S at least JAX_FLASH_MIN_SEQ, in any
    dtype."""
    s, d = q.shape[1], q.shape[-1]
    return d % 8 == 0 and d >= 64 and s >= JAX_FLASH_MIN_SEQ


def routes_to_reference(q: torch.Tensor) -> bool:
    """The "auto" dispatch's rule on a CUDA tensor, decided from q's dtype
    and shape alone, before anything launches: the plain attention where the
    Hopper kernels are not built for ``q`` and JAX's dispatch leaves its
    kernel too. Where JAX runs its kernel and the Hopper kernels are not
    built for ``q``, "auto" runs the generic build (:func:`kernel_for`)."""
    return not kernel_fits(q) and not jax_runs_kernel(q)


def auto_build(q: torch.Tensor) -> Optional[str]:
    """What ``impl="auto"`` runs on a CUDA tensor ``q``: "plain" (the plain
    attention) where :func:`routes_to_reference`, else the build
    :func:`kernel_for` names ("hopper" or "generic"; None where no build
    takes ``q``, and "auto" raises)."""
    return "plain" if routes_to_reference(q) else kernel_for(q)


def count_reference_route(q: torch.Tensor) -> None:
    with _count_lock:
        reference_routes["dtype" if q.dtype != torch.bfloat16 else "head_dim"] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
            generic_launches[name] = 0
            window_launches[name] = 0
            d256_launches[name] = 0
            packed_launches[name] = 0
            f32_launches[name] = 0
        for name in reference_routes:
            reference_routes[name] = 0


def _count(name: str, window: Optional[int], head_dim: int, packed: bool,
           f32: bool = False, generic: bool = False) -> None:
    with _count_lock:
        launches[name] += 1
        if generic:
            generic_launches[name] += 1
        if f32:
            f32_launches[name] += 1
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
    lse [B, Hq, Sq] fp32). As every build and JAX's ``_fwd_kernel``:
    s = scale * q.k in fp32 (q is not rounded to its dtype after scaling,
    as the plain attention's ``_xla_attention`` order does), P rounded to
    v's dtype before the PV product. Rows with no valid key (pad rows of a
    packed row among them) give zeros and lse = NEG_INF, as the kernel
    does. Computes every row (no skip_pad_q)."""
    b, sq, hq, d = q.shape
    check_segments(segment_ids, mask, b, sq, k.shape[1])
    logits = masked_logits(q, k, mask, causal, window, segment_ids,
                           scale_q=False)  # [B, Hkv, G, Sq, Sk]
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
    """Every build reads rows with a head_dim stride of 1, and copies them
    in 16-byte pieces (the Hopper kernels by TMA, the generic build by
    cp.async), which needs a 16-byte-aligned base and batch, sequence and
    head strides that are multiples of 16 bytes. A view that fails either
    raises; nothing is copied or routed elsewhere."""
    if x.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
    if any(s * x.element_size() % 16 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: 16-byte alignment: strides {tuple(x.stride())} of "
            f"{x.element_size()}-byte elements and the data pointer must keep "
            "each row 16-byte aligned"
        )


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernels' checks of q, k and v; returns the build that takes them
    (:func:`kernel_for`)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(
                f"flash kernel: {name} is on {x.device}; the kernel runs on "
                "CUDA tensors only (use impl='plain' for the reference)"
            )
        if x.dim() != 4:
            raise ValueError(f"flash kernel: {name} must be [B, S, H, D]")
    build = kernel_for(q)
    if build is None:
        raise ValueError(
            f"flash kernel: no build takes q {q.dtype} at head_dim {q.shape[-1]} (the "
            f"Hopper kernels: bf16 at head_dim {HEAD_DIMS}; the generic build: fp32, fp16 "
            "or bf16 at a head_dim that is a multiple of 8)"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel: q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
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
    return build


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
    """Launch K1: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] in one dtype on one
    CUDA device, mask [B, Sk] (non-zero = valid key, default all valid), on
    the build :func:`kernel_for` names. Returns (out [B, Sq, Hq, D] in q's
    dtype, lse [B, Hq, Sq] fp32). No gradient flows through this call;
    :class:`FlashAttention` is the differentiable form.

    Strided inputs are read in place (no transpose copy). With
    ``skip_pad_q``, query tiles that start at or past the valid key length
    output zeros: compare only rows below the valid length. ``window``
    (with ``causal``): rows see keys with q_pos - k_pos < window; a row
    that sees no valid key outputs zeros and lse NEG_INF. ``segment_ids``
    [B, S] (Sq == Sk, no ``mask``): contiguous segments 1..n with a 0-id
    pad tail, attention within each segment only."""
    win = _check_window(window, causal)
    check_segments(segment_ids, mask, q.shape[0], q.shape[1], k.shape[1])
    build = _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    mask = _int_mask(mask, segment_ids, b, sk, q.device)
    packed = segment_ids is not None

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    generic = build == "generic"
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
                int(causal), int(skip_pad_q), win, int(packed))
        if generic:
            rc = lib.rankpo_flash_fwd_generic(*args, GENERIC_DTYPES[q.dtype], stream)
        else:
            rc = lib.rankpo_flash_fwd_bf16(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {rc}")
    _count("flash_fwd", window, d, packed, generic=generic)
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


def _check_bwd(q, k, v, mask, do, lse, delta, causal, window,
               segment_ids) -> Tuple[torch.Tensor, str]:
    """The backward kernels' argument checks; returns the int32 mask buffer
    and the build that takes the inputs."""
    _check_window(window, causal)
    check_segments(segment_ids, mask, q.shape[0], q.shape[1], k.shape[1])
    build = _check_qkv(q, k, v)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash kernel: do {tuple(do.shape)} {do.dtype} must match q")
    _check_rows("do", do)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, hq, sq) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous fp32 {(b, hq, sq)}")
        if x.device != q.device:
            raise ValueError(f"flash kernel: {name} must be on {q.device}")
    return _int_mask(mask, segment_ids, b, k.shape[1], q.device), build


def _launch_bwd(name, build: str, q, k, v, mask, do, lse, delta, dq, dk, dv, sync,
                causal: bool, skip_pad_q: bool, window: Optional[int], packed: bool,
                f32: bool = False) -> None:
    """One backward kernel's launch on the current stream of q's device:
    ``name`` (flash_bwd_fused, flash_dq or flash_dkv) of ``build``, the
    Hopper kernel (bf16; ``f32``: K3b's fp32-output build) or the generic
    one (``f32``: fp32 dk/dv); counted under ``name`` once it succeeded."""
    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    generic = build == "generic"
    kind = {"flash_bwd_fused": "fused", "flash_dq": "dq", "flash_dkv": "dkv"}[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(),
            None if dv is None else dv.data_ptr(),
            None if sync is None else sync.data_ptr(),
            b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], mask.stride(0),
            int(causal), int(skip_pad_q), _check_window(window, causal), int(packed),
        )
        if generic:
            fn = getattr(lib, f"rankpo_flash_bwd_{kind}_generic")
            rc = fn(*args, GENERIC_DTYPES[q.dtype], int(f32), stream)
        else:
            fn = getattr(lib, f"rankpo_flash_bwd_{kind}_{'f32' if f32 else 'bf16'}")
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    _count(name, window, d, packed, f32, generic)


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
             causal: bool = False) -> torch.Tensor:
    """dq [B, Sq, Hq, D] in q's dtype from given lse and delta [B, Hq, Sq]
    fp32 (JAX ``flash_dq``, ``flash_attention.py:550``): K3a alone on a
    CUDA tensor (the build :func:`kernel_for` names), counted as
    ``flash_dq``; on a CPU tensor the plain version
    (:func:`flash_attention_bwd_reference`'s dq, cast)."""
    if q.device.type == "cpu":
        dq, _, _ = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=causal)
        return dq.to(q.dtype)
    mask, build = _check_bwd(q, k, v, mask, do, lse, delta, causal, None, None)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_dq", build, q, k, v, mask, do, lse, delta, dq, None, None, None, causal,
                False, None, False)
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Sk, Hkv, D] in fp32, each GQA group summed, from given
    lse and delta (JAX ``flash_dkv``, ``flash_attention.py:579``): on a CUDA
    tensor K3b with fp32 dK/dV (no window, no segments, as the ring takes
    it): the Hopper build's fp32-output kernel for bf16 at HEAD_DIMS, else
    the generic build's with ``f32_out``; counted as ``flash_dkv`` and in
    ``f32_launches``. On a CPU tensor the plain version
    (:func:`flash_attention_bwd_reference`, whose dk and dv are fp32)."""
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=causal)
        return dk, dv
    mask, build = _check_bwd(q, k, v, mask, do, lse, delta, causal, None, None)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _launch_bwd("flash_dkv", build, q, k, v, mask, do, lse, delta, None, dk, dv, None, causal,
                False, None, False, f32=True)
    return dk, dv


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
    """Launch the backward kernels on the forward's inputs and stats, on
    the build :func:`kernel_for` names: q/do [B, Sq, Hq, D], k/v [B, Sk,
    Hkv, D] in one dtype, lse and delta [B, Hq, Sq] fp32. Returns (dq, dk,
    dv) in the inputs' dtype.

    ``bwd_impl``:

    - ``"fused"`` (K2): one pass per key tile; each key tile's dq is added in
      fp32 in key-tile order (a zeroed int32 workspace of counters orders
      the blocks), as JAX's resident dq block sums it;
    - ``"split"`` (K3a + K3b): the dq kernel loops over key tiles per query
      tile and holds dq on chip;
    - ``"auto"``: split (:func:`resolve_bwd_impl`). The JAX package picks
      split above 8·Sq·D > 4 MiB (``flash_attention.py:777``), a VMEM budget
      for its resident dq block; on the H100 split was the faster at every
      shape measured, below that size too.

    Both give dq, dk and dv that repeat bit for bit. K2 and K3b sum each GQA
    group's dk/dv in the kernel, as ``flash_bwd_fused`` sums them per
    group, and write them in the inputs' dtype. ``window`` and
    ``segment_ids`` are the forward's."""
    bwd_impl = resolve_bwd_impl(bwd_impl)
    mask, build = _check_bwd(q, k, v, mask, do, lse, delta, causal, window, segment_ids)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    packed = segment_ids is not None
    dev = q.device
    fused = bwd_impl == "fused"
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=dev)
    dv = torch.empty_like(dk)
    sync = None
    if fused:
        dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
        # the blocks' start order and one counter per (b * h, query tile,
        # column block: two at head_dim 256 in the Hopper build,
        # flash_bwd.cu KvTiles::kSplit; at most one per 64 columns in the
        # generic build, flash_generic.cu plan_chunks)
        blocks = -(-d // 64) if build == "generic" else (2 if d == 256 else 1)
        sync = torch.zeros(1 + b * hq * -(-sq // 64) * blocks, dtype=torch.int32, device=dev)
        steps = ("flash_bwd_fused",)
    else:
        dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)
        steps = ("flash_dq", "flash_dkv")
    for name in steps:
        _launch_bwd(name, build, q, k, v, mask, do, lse, delta, dq, dk, dv, sync, causal,
                    skip_pad_q, window, packed)
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
