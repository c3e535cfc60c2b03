"""Sequence-packing model helpers: positions, per-segment pooling and the
scatter back to batch order (port of ``rankpo_tpu.models.packing``).

A packed row holds several texts as contiguous segments (ids 1..n, a 0-id
pad tail; ``data/packing.py``). :func:`packed_positions` restarts the
positions at every segment, so RoPE (llama family) and learned positions
(Roberta/BERT) see what each text would see alone; :func:`packed_pool`
applies the pooling rule (last token, CLS, mean) to each segment's span;
:func:`scatter_packed_reps` puts each segment's embedding at its batch
position.
"""

from __future__ import annotations

import torch


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids -> [B, S] int64 within-segment positions
    (0-based). The pad tail restarts at 0 too; attention and pooling never
    read it."""
    b, s = segment_ids.shape
    pos = torch.arange(s, device=segment_ids.device).expand(b, s)
    prev = torch.nn.functional.pad(segment_ids[:, :-1], (1, 0), value=-1)
    is_start = segment_ids != prev
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    return pos - seg_start


def packed_pool(hidden: torch.Tensor, segment_ids: torch.Tensor, max_segments: int,
                mode: str) -> tuple:
    """Per-segment pooling: [B, S, H], [B, S] -> (reps [B, M, H] in
    hidden's dtype, valid [B, M] bool). Slot j of row b pools segment j + 1;
    ``valid`` marks the segments that exist. "last_token" takes the
    segment's final token, "cls" its first, "mean" the fp32 mean of its
    tokens."""
    b, s, h = hidden.shape
    seg_range = torch.arange(1, max_segments + 1, device=segment_ids.device,
                             dtype=segment_ids.dtype)
    member = segment_ids[:, None, :] == seg_range[None, :, None]  # [B, M, S]
    counts = member.sum(dim=-1)  # [B, M]
    valid = counts > 0
    if mode == "mean":
        summed = torch.einsum("bms,bsh->bmh", member.to(torch.float32),
                              hidden.to(torch.float32))
        reps = summed / counts.clamp_min(1)[..., None].to(torch.float32)
        return reps.to(hidden.dtype), valid
    ends = torch.cumsum(counts, dim=-1)  # tokens in segments 1..j (contiguous, ordered)
    if mode == "last_token":
        idx = ends - 1
    elif mode == "cls":
        idx = ends - counts
    else:
        raise ValueError(f"Unknown packed pooling mode: {mode!r}; "
                         "one of ['last_token', 'cls', 'mean']")
    idx = idx.clamp(0, s - 1)  # empty slots gather position 0, marked invalid
    reps = torch.gather(hidden, 1, idx[..., None].expand(b, max_segments, h))
    return reps, valid


def scatter_packed_reps(reps: torch.Tensor, slot_index: torch.Tensor,
                        num_slots: int) -> torch.Tensor:
    """[R, M, H] packed reps + [R, M] slot table (values in [0, num_slots)
    or -1 for an empty slot) -> [num_slots, H] in batch order.
    Differentiable: the gradient of each slot flows back to its segment.
    Slot -1 goes to a dump row that is dropped."""
    h = reps.shape[-1]
    flat = reps.reshape(-1, h)
    idx = slot_index.reshape(-1).to(torch.int64)
    safe = torch.where(idx >= 0, idx, num_slots)
    out = torch.zeros((num_slots + 1, h), dtype=flat.dtype, device=flat.device)
    out = out.index_put((safe,), flat)
    return out[:num_slots]
