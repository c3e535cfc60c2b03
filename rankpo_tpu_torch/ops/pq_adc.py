"""Fused PQ asymmetric-distance scores for IVF-PQ search (port of
``rankpo_tpu.ops.pq_adc_pallas``).

Replaces the Pallas TPU kernels ``_kernel`` (K5, ``pq_probe_scores``, codes
in rows ``[K * cap, m]``) and ``_kernel_t`` (K6, ``pq_probe_scores_t``,
transposed codes ``[m, K * cap]``) with one CUDA C++ kernel for ``sm_90a``,
``ops/csrc/pq_adc.cu``, instantiated per layout and load route. The TPU
kernels' one-hot mask and reduce, and their ``mxu`` / ``via_transpose``
variants, are Mosaic formulations; the port keeps the contract:

    scores[q, p, c] = sum_j lut[q, j, codes[probe[q, p] * cap + c, j] & 255]

summed in fp32 in order j = 0 .. m - 1 (so every launch shape gives the same
bits). m may be any multiple of 8 (the JAX gate) and cap any size.

:func:`adc_plan` picks the launch from the shapes alone (no host sync): the
load route (codes staged by TMA where their alignment allows, else read from
global memory), the tile of slots and the blocks per query.

For a CPU tensor the wrappers compute :func:`pq_probe_scores_plain` /
:func:`pq_probe_scores_t_plain`; for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

PQ_K = 256  # 8-bit codes: entries per subspace table

# launches of the CUDA kernel per layout in this process (read by
# chip_smoke.py); incremented only after a launch succeeded
launches = {"pq_adc_rows": 0, "pq_adc_cols": 0}
# the same launches by load route ("tma": codes staged by bulk copies;
# "ldg": codes read from global memory)
route_launches = {f"{name}/{route}": 0 for name in launches for route in ("tma", "ldg")}
_count_lock = threading.Lock()

# the kernel's shapes (ops/csrc/pq_adc.cu)
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_TILE = 1024  # route "ldg": slots per tile (256 threads, up to 4 slots each)
MAX_BOX = 256  # route "tma": slots per tile, one TMA box
RESIDENT_M = 128  # m <= 128: the whole table stays in shared memory
CHUNK = 16 * PQ_K * 4  # 16 subspaces of table (16 KB), or a ring stage of codes
RING = 4  # route "ldg", m > 128: table chunks in flight
TWO_BLOCKS_SMEM = 115712  # shared memory of each of two blocks on one SM


def reset_launches() -> None:
    with _count_lock:
        for counts in (launches, route_launches):
            for name in counts:
                counts[name] = 0


@dataclass(frozen=True)
class AdcPlan:
    """One launch of the kernel: ``route`` "tma" or "ldg", ``tile`` slots
    per tile, ``blocks`` per query."""

    route: str
    tile: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def adc_plan(q_n: int, p_n: int, cap: int, m: int, *, aligned: bool) -> AdcPlan:
    """The launch for Q queries of P probes over clusters of ``cap`` slots
    with m subspaces; ``aligned``: the codes' start and row pitch (m bytes
    for rows, K * cap for cols) are multiples of 16 bytes.

    - Route "tma" where the codes are aligned and the table is resident
      (m <= 128): a tile is one TMA box of at most 256 slots of one probed
      cluster, the cluster cut into equal tiles (cap 384: two of 192).
      Route "ldg" otherwise: tiles of up to 1024 consecutive probed slots,
      shrunk (to no fewer than 64 slots, 256 where the table streams) until
      a query has as many tiles as it wants blocks.
    - Blocks per query: as many as fill the card once, two per SM where the
      shared memory allows, or one per tile if the query has fewer.
    """
    n_ch = _cdiv(m, 16)
    if aligned and m <= RESIDENT_M:
        tile = _cdiv(_cdiv(cap, _cdiv(cap, MAX_BOX)), 16) * 16
        n_tiles = p_n * _cdiv(cap, tile)
        smem = 128 + (n_ch + (3 if m <= 64 else 4)) * CHUNK
        want = max(1, SMS * (2 if smem <= TWO_BLOCKS_SMEM else 1) // q_n)
        return AdcPlan("tma", tile, min(want, n_tiles))
    smem = 128 + (n_ch if m <= RESIDENT_M else RING) * CHUNK
    want = max(1, SMS * (2 if smem <= TWO_BLOCKS_SMEM else 1) // q_n)
    n = p_n * cap
    least = 64 if m <= RESIDENT_M else 256  # a streamed table is loaded per tile
    tile = min(MAX_TILE, max(least, _cdiv(_cdiv(n, want), 16) * 16), _cdiv(n, 16) * 16)
    return AdcPlan("ldg", tile, min(want, _cdiv(n, tile)))


def plan_for(codes: torch.Tensor, probe: torch.Tensor, cap: int, m: int) -> AdcPlan:
    """:func:`adc_plan` for these codes (rows ``[K * cap, m]`` or cols
    ``[m, K * cap]``: ``codes.shape[1]`` is the row pitch either way) and
    probe ``[Q, P]``."""
    return adc_plan(probe.shape[0], probe.shape[1], cap, m,
                    aligned=codes.data_ptr() % 16 == 0 and codes.shape[1] % 16 == 0)


def _lut_sum(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes [Q, P, cap, m] (uint8) -> fp32 [Q, P, cap] table sums."""
    q_n, p_n, cap, m = codes.shape
    idx = (codes.long() & 255) + torch.arange(m, device=codes.device) * PQ_K
    flat = lut.to(torch.float32).reshape(q_n, 1, m * PQ_K)
    vals = torch.gather(flat, 2, idx.reshape(q_n, p_n * cap * m)[:, None, :])
    return vals.reshape(q_n, p_n, cap, m).sum(-1)


def pq_probe_scores_plain(codes: torch.Tensor, probe: torch.Tensor,
                          lut: torch.Tensor, *, cap: int) -> torch.Tensor:
    """Plain version over row-layout codes ``[K * cap, m]``."""
    m = codes.shape[1]
    return _lut_sum(codes.view(-1, cap, m)[probe.long()], lut)


def pq_probe_scores_t_plain(codes_t: torch.Tensor, probe: torch.Tensor,
                            lut: torch.Tensor, *, cap: int) -> torch.Tensor:
    """Plain version over transposed codes ``[m, K * cap]``."""
    m = codes_t.shape[0]
    blocks = codes_t.view(m, -1, cap)[:, probe.long()]  # [m, Q, P, cap]
    return _lut_sum(blocks.permute(1, 2, 3, 0), lut)


def _check(codes, probe, lut, cap, m, n_slots):
    if codes.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"pq scores: codes must be uint8 (or int8 bits), got {codes.dtype}")
    if codes.dim() != 2 or cap < 1 or n_slots % cap:
        raise ValueError(f"pq scores: codes {tuple(codes.shape)} do not hold whole "
                         f"clusters of cap {cap}")
    if probe.dim() != 2 or lut.shape != (probe.shape[0], m, PQ_K):
        raise ValueError(f"pq scores: lut {tuple(lut.shape)} is not [Q, m, {PQ_K}] "
                         f"for probe {tuple(probe.shape)} and m {m}")
    if not (codes.device == probe.device == lut.device):
        raise ValueError("pq scores: codes, probe and lut must be on one device")


def _launch(codes, probe, lut, cap, m, n_slots, layout, plan=None):
    name = ("pq_adc_rows", "pq_adc_cols")[layout]
    if codes.device.type != "cuda":
        raise ValueError(f"pq scores: no kernel for device {codes.device}")
    q_n, p_n = probe.shape
    if m % 8:
        raise ValueError(f"pq scores kernel: m {m} must be a multiple of 8")
    if q_n > 65535:
        raise ValueError(f"pq scores kernel: Q {q_n} must be <= 65535")
    out = torch.empty((q_n, p_n, cap), dtype=torch.float32, device=codes.device)
    if q_n == 0 or p_n == 0:
        return out
    if not codes.is_contiguous() or codes.data_ptr() % 8:
        raise ValueError("pq scores kernel: codes must be contiguous and 8-byte aligned")
    probe32 = probe.to(torch.int32).contiguous()
    lutf = lut.to(torch.float32).contiguous()
    if lutf.data_ptr() % 16:  # the table's bulk copies start on 16 bytes
        lutf = lutf.clone()
    if plan is None:
        plan = plan_for(codes, probe, cap, m)

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.rankpo_pq_adc_scores(
            codes.data_ptr(), probe32.data_ptr(), lutf.data_ptr(), out.data_ptr(),
            n_slots // cap, q_n, p_n, cap, m, layout, int(plan.route == "tma"), plan.tile,
            plan.blocks, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pq scores kernel ({name}, {plan}) launch failed: cudaError {rc}")
    with _count_lock:
        launches[name] += 1
        route_launches[f"{name}/{plan.route}"] += 1
    return out


def pq_probe_scores(codes: torch.Tensor, probe: torch.Tensor, lut: torch.Tensor,
                    *, cap: int) -> torch.Tensor:
    """fp32 ADC scores ``[Q, P, cap]``: codes ``[K * cap, m]`` uint8, probe
    ``[Q, P]`` cluster ids, lut ``[Q, m, 256]`` fp32 per-query tables."""
    m, n_slots = codes.shape[1], codes.shape[0]
    _check(codes, probe, lut, cap, m, n_slots)
    if codes.device.type == "cpu":
        return pq_probe_scores_plain(codes, probe, lut, cap=cap)
    return _launch(codes, probe, lut, cap, m, n_slots, 0)


def pq_probe_scores_t(codes_t: torch.Tensor, probe: torch.Tensor, lut: torch.Tensor,
                      *, cap: int) -> torch.Tensor:
    """:func:`pq_probe_scores` over transposed codes ``[m, K * cap]``."""
    m, n_slots = codes_t.shape
    _check(codes_t, probe, lut, cap, m, n_slots)
    if codes_t.device.type == "cpu":
        return pq_probe_scores_t_plain(codes_t, probe, lut, cap=cap)
    return _launch(codes_t, probe, lut, cap, m, n_slots, 1)
