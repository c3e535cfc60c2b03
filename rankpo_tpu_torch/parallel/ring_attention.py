"""Ring attention: context parallelism over a process group (port of
``rankpo_tpu.parallel.ring_attention``).

The sequence axis is split over the W ranks of a group: rank r holds the
query, key and value rows ``[r * S/W, (r + 1) * S/W)``. Each rank keeps its
queries and passes its K/V shard around the ring, one hop per step (send
to rank r + 1, receive from rank r - 1, :func:`ring_hop`), accumulating
attention for its queries with an online softmax, so no rank ever holds
the whole sequence's K/V or an [S, S] score matrix. Blockwise exact.

Two rings, as in JAX:

- :func:`ring_attention_local` (``impl="xla"``): plain PyTorch blocks, an
  fp32 online softmax (JAX ``:35-120``), differentiated by autograd (the
  hop's backward is the hop the other way round);
- :func:`ring_flash_attention_local` (``impl="flash"``): :class:`RingFlash`,
  whose forward runs K1 (``ops/flash_attention.py``) on each (query shard,
  K/V shard) pair with its logsumexp and merges the partials by
  ``logaddexp`` (JAX ``_merge``, ``:127-133``); a causal ring skips the
  steps whose K/V shard lies after this rank's queries (rank ``my`` runs
  steps ``i <= my``). Its backward runs K3a (dq) and K3b with fp32 dk/dv
  per step on the forward's merged lse and ``delta = rowsum(dO * O)``, on
  the build ``flash_attention.kernel_for`` names (the Hopper kernels for
  bf16 at head_dim 64/128/256, the generic build for fp32, fp16 and other
  head dims); dq accumulates in fp32 on the rank, and the fp32 dk/dv
  partials travel with their K/V shard and are home after W hops
  (``:192-259``). On CPU tensors the kernels' plain versions run in their
  place (``flash_dq`` / ``flash_dkv`` dispatch by device), as the JAX tests
  run the Pallas kernels in interpret mode.

:func:`context_parallel_attention` takes global [B, S, H, D] tensors, the
same on every rank of the group: it slices this rank's shard, runs a ring
and all-gathers the output. Both ends are differentiable with replicated
semantics (the slice's backward all-gathers the gradient, the gather's
backward takes this rank's slice), so every rank ends with the whole
sequence's gradients, as ``jax.grad`` of JAX's function on global arrays.

The hop (:func:`ring_hop`) is ``batch_isend_irecv`` on the group's own
backend: NCCL sends the device tensors; gloo takes host tensors, so under
gloo the shard is copied to the host, sent, and the received one copied
back to the device. The form is chosen by the group's backend and nothing
else; a failed hop raises. ``hop_stats`` counts the hops, their bytes
(sent by this rank) and their host-clock seconds.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rankpo_tpu_torch.ops.attention import NEG_INF

IMPLS = ("xla", "flash")

# this process's hops: count, bytes sent, host-clock seconds (the copies
# to and from the host included under gloo)
hop_stats = {"hops": 0, "bytes": 0, "seconds": 0.0}


def reset_hop_stats() -> None:
    hop_stats.update(hops=0, bytes=0, seconds=0.0)


def ring_hop(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """Each tensor sent ``shift`` ranks on along ``group``'s ring and the
    tensors of the rank ``shift`` back received in their place (JAX's
    ``ppermute`` with ``perm = [(j, (j + shift) % W)]``; -1 walks the ring
    backwards). A collective of the group."""
    w = dist.get_world_size(group)
    if w == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + shift) % w)
    prv = dist.get_global_rank(group, (me - shift) % w)
    host = dist.get_backend(group) == "gloo"
    t0 = time.perf_counter()
    sends = [t.contiguous() for t in tensors]
    if host:
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        recvs = [r.to(t.device) for r, t in zip(recvs, tensors)]
    hop_stats["hops"] += 1
    hop_stats["bytes"] += sum(t.numel() * t.element_size() for t in sends)
    hop_stats["seconds"] += time.perf_counter() - t0
    return recvs


class _Hop(torch.autograd.Function):
    """A differentiable hop: the gradient goes one hop the other way
    (``ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_hop(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_hop(grads, ctx.group, -1))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor], *, group,
                         causal: bool = False) -> torch.Tensor:
    """The plain ring on this rank's shards: q [B, S_loc, Hq, D], k/v
    [B, S_loc, Hkv, D] (GQA: Hkv divides Hq), mask [B, S_loc] key validity.
    Returns this rank's output [B, S_loc, Hq, D] in q's dtype (JAX
    ``ring_attention_local``)."""
    b, s_loc, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    w, my = dist.get_world_size(group), dist.get_rank(group)
    if mask is None:
        mask = torch.ones((b, s_loc), dtype=torch.int32, device=q.device)
    qf = q.to(torch.float32)
    m = torch.full((b, hq, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s_loc, d), dtype=torch.float32, device=q.device)
    q_pos = my * s_loc + torch.arange(s_loc, device=q.device)
    for step in range(w):
        src = (my - step) % w  # whose K/V shard this rank holds this step
        k_full = k.repeat_interleave(groups, dim=2) if groups > 1 else k
        v_full = v.repeat_interleave(groups, dim=2) if groups > 1 else v
        s = scale * torch.einsum("bqhd,bkhd->bhqk", qf, k_full.to(torch.float32))
        k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
        valid = (mask != 0)[:, None, None, :]
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # rows that have seen no valid key keep m_new == NEG_INF: masked
        # entries are forced to 0 so they keep l == 0 and output zeros
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    v_full.to(torch.float32))
        m = m_new
        if step + 1 < w:
            k, v = _Hop.apply(group, k, v)
            (mask,) = ring_hop((mask,), group)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)


def _merge(out_acc, lse_acc, o_i, lse_i):
    """Online-softmax merge of two normalised partials with their lse
    (JAX ``_merge``): out [B, S, H, D] fp32, lse [B, H, S]."""
    lse_new = torch.logaddexp(lse_acc, lse_i)
    w_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return out_acc * w_old + o_i.to(torch.float32) * w_new, lse_new


def _fwd_step(q, k, v, mask, causal: bool):
    """(out, lse) of one (query shard, K/V shard) pair: K1 on a CUDA tensor,
    its plain version on a CPU tensor."""
    from rankpo_tpu_torch.ops import flash_attention as flash

    if q.device.type == "cpu":
        return flash.flash_attention_fwd_reference(q, k, v, mask, causal=causal)
    return flash.flash_attention_fwd(q, k, v, mask, causal=causal)


def _live(my: int, step: int, causal: bool) -> bool:
    """Whether step ``step`` of rank ``my`` sees any key: on a causal ring
    the shard of rank my - step (mod W) lies before this rank's queries
    only when there is no wrap (JAX's ``my >= i``)."""
    return not causal or my >= step


class RingFlash(torch.autograd.Function):
    """The flash ring on local shards (JAX ``_ring_flash`` custom_vjp):
    forward K1 per step, backward K3a + K3b (fp32 dk/dv) per step, in the
    inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal: bool):
        w, my = dist.get_world_size(group), dist.get_rank(group)
        b, s_loc, hq, d = q.shape
        out = torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, hq, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
        k_i, v_i, m_i = k, v, mask
        for i in range(w):
            if _live(my, i, causal):
                # the diagonal step keeps local-position causal masking
                o_i, lse_i = _fwd_step(q, k_i, v_i, m_i, causal and i == 0)
                out, lse = _merge(out, lse, o_i, lse_i)
            if i + 1 < w:
                k_i, v_i, m_i = ring_hop((k_i, v_i, m_i), group)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, out, lse.contiguous())
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        from rankpo_tpu_torch.ops import flash_attention as flash

        q, k, v, mask, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        w, my = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous().to(q.dtype)
        # delta = rowsum(dO * O) in fp32 [B, H, S] (flash_attention.py:669)
        delta = (g.to(torch.float32) * out.to(torch.float32)).sum(-1)
        delta = delta.permute(0, 2, 1).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # (k, v, mask, dk, dv) travel the ring together; after W hops each
        # shard's summed dk/dv is back on its home rank
        k_i, v_i, m_i = k, v, mask
        dk_i = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_i = torch.zeros_like(dk_i)
        for i in range(w):
            if _live(my, i, causal):
                step_causal = causal and i == 0
                dq += flash.flash_dq(q, k_i, v_i, m_i, g, lse, delta,
                                     causal=step_causal).to(torch.float32)
                dk_c, dv_c = flash.flash_dkv(q, k_i, v_i, m_i, g, lse, delta,
                                             causal=step_causal)
                dk_i += dk_c
                dv_i += dv_c
            if i + 1 < w:
                k_i, v_i, m_i, dk_i, dv_i = ring_hop((k_i, v_i, m_i, dk_i, dv_i), group)
            else:  # the last hop brings the partials home; K/V need not travel
                dk_i, dv_i = ring_hop((dk_i, dv_i), group)
        return dq.to(q.dtype), dk_i.to(k.dtype), dv_i.to(v.dtype), None, None, None


def ring_flash_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mask: Optional[torch.Tensor], *, group,
                               causal: bool = False) -> torch.Tensor:
    """The flash ring on this rank's shards (JAX
    ``ring_flash_attention_local``): q/k/v [B, S_loc, H, D] (GQA), mask
    [B, S_loc] key validity; on a CUDA tensor any input a kernel build takes
    (fp32, fp16 or bf16 at a head_dim that is a multiple of 8), as JAX's
    ring runs its kernels in any dtype."""
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return RingFlash.apply(q, k, v, mask.to(torch.int32), group, causal)


class _ShardSeq(torch.autograd.Function):
    """This rank's sequence shard of a replicated global tensor; the
    backward all-gathers the shards' gradients, so each rank holds the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w, me = dist.get_world_size(group), dist.get_rank(group)
        s_loc = x.shape[1] // w
        return x[:, me * s_loc:(me + 1) * s_loc].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [B, S_loc, ...] shard concatenated on dim 1."""
    w = dist.get_world_size(group)
    if w == 1:
        return x
    parts = torch.empty((w * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
    parts = parts.view(w, *x.shape).transpose(0, 1)
    return parts.reshape(x.shape[0], w * x.shape[1], *x.shape[2:])


class _GatherSeq(torch.autograd.Function):
    """The whole sequence from every rank's shard; the backward takes this
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        w, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        s_loc = g.shape[1] // w
        return g[:, me * s_loc:(me + 1) * s_loc].contiguous(), None


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                               mask: Optional[torch.Tensor] = None, causal: bool = False,
                               impl: str = "xla") -> torch.Tensor:
    """Global-tensor entry point (JAX ``context_parallel_attention``): q/k/v
    [B, S, H, D], the same on every rank of ``group`` (a process group, the
    ring), S divisible by its size; ``mask`` [B, S] key validity. Shards
    the sequence, runs the ring (``impl`` "xla": the plain ring, "flash":
    the kernels' ring) and returns the global output on every rank. A
    collective of the group."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    w = dist.get_world_size(group)
    s = q.shape[1]
    if s % w:
        raise ValueError(f"sequence {s} not divisible by the ring's {w} ranks")
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    q_l, k_l, v_l = (_ShardSeq.apply(x, group) for x in (q, k, v))
    s_loc = s // w
    me = dist.get_rank(group)
    m_l = mask[:, me * s_loc:(me + 1) * s_loc].contiguous()
    local = ring_flash_attention_local if impl == "flash" else ring_attention_local
    out = local(q_l, k_l, v_l, m_l, group=group, causal=causal)
    return _GatherSeq.apply(out, group)
