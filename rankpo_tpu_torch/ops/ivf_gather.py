"""Probed-cluster scores for IVF search (port of
``rankpo_tpu.ops.ivf_gather_pallas``).

Replaces the Pallas TPU kernel ``_kernel`` (K4, reached through
``probe_scores``) with the CUDA C++ kernel ``ops/csrc/ivf_gather.cu`` for
``sm_90a``, built at first use (``ops/_build.py``) and called through its
plain C entry point with ctypes. It is bound by HBM bytes (a gathered
matrix-vector product) and reads each probed cluster block once for all the
queries of the batch that probe it: :func:`group_probes` orders the
(query, probe) pairs by cluster on the device, and the kernel takes one group
per block (the source's header says more).

Contract: ``probe_scores(corpus, probe, queries, cap=cap)`` returns fp32
scores ``[Q, P, cap]`` equal to

    einsum("qd,qpcd->qpc", qv, corpus.view(K, cap, D)[probe])

with exact products summed in fp32, where ``qv`` is the query rounded to
bf16 for bf16 rows (the TPU kernel's DEFAULT precision and the JAX XLA
path's explicit cast) and the fp32 query for fp32 rows (HIGHEST: true fp32
products, never TF32). The JAX kernel in interpret mode does not round the
query, so it agrees with this contract on fp32 rows, or on bf16 rows with
bf16-valued queries.

For a CPU tensor the wrapper computes :func:`probe_scores_plain`; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import threading

import torch

# launches of the CUDA kernel in this process (read by chip_smoke.py to show
# the main path went through it); incremented only after a launch succeeded
launches = {"ivf_probe_scores": 0}
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _query_operand(queries: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The query as the product sees it: bf16-rounded for bf16 rows."""
    q = queries.to(torch.float32)
    return q.to(torch.bfloat16).to(torch.float32) if dtype == torch.bfloat16 else q


def probe_scores_plain(corpus: torch.Tensor, probe: torch.Tensor,
                       queries: torch.Tensor, *, cap: int) -> torch.Tensor:
    """Plain version of the kernel's contract: gathers the probed blocks
    ``[Q, P, cap, D]`` and takes one fp32 batched product."""
    q_n, p_n = probe.shape
    d = corpus.shape[1]
    blocks = corpus.view(-1, cap, d)[probe.long()]  # [Q, P, cap, D]
    rows = blocks.reshape(q_n, p_n * cap, d).to(torch.float32)
    qv = _query_operand(queries, corpus.dtype)
    return torch.bmm(rows, qv[:, :, None]).reshape(q_n, p_n, cap)


def group_probes(probe: torch.Tensor, n_clusters: int):
    """The (query, probe) pairs of ``probe`` [Q, P] grouped by cluster id, on
    ``probe``'s device and without a host sync. Returns int32 tensors

    - ``pairs`` [Q * P]: the flat pair indices ``q * P + p``, in ascending
      cluster id and, within a cluster, ascending pair index (a stable sort);
    - ``start`` [G + 1]: group g holds ``pairs[start[g]:start[g + 1]]``;
    - ``cluster`` [G]: the cluster id group g probes,

    where G = min(Q * P, n_clusters + 1) bounds the group count. Every id
    outside [0, n_clusters) is read as ``n_clusters``, so those pairs form one
    group (whose scores the kernel sets to NaN). Groups past the last one
    are empty (``start[g] == start[g + 1] == Q * P``). A cluster listed twice
    by one query gives two pairs."""
    n, dev = probe.numel(), probe.device
    g_max = min(n, n_clusters + 1)
    flat = probe.reshape(-1)
    key = torch.where(flat < 0, n_clusters, flat.clamp(max=n_clusters)).int()
    key_sorted, order = torch.sort(key, stable=True)
    first = torch.ones(n, dtype=torch.int32, device=dev)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    group_no = torch.cumsum(first, 0, dtype=torch.int32)  # 1 + group of each sorted pair
    start = torch.searchsorted(group_no, torch.arange(1, g_max + 2, dtype=torch.int32, device=dev),
                               out_int32=True)
    return order.int(), start, key_sorted[start[:-1].clamp(max=n - 1)]


def _check(corpus, probe, queries, cap):
    if corpus.dtype not in _DTYPES:
        raise ValueError(f"probe_scores: rows must be fp32 or bf16, got {corpus.dtype}")
    if corpus.dim() != 2 or cap < 1 or corpus.shape[0] % cap:
        raise ValueError(
            f"probe_scores: corpus {tuple(corpus.shape)} is not [K * cap, D] for cap {cap}")
    if probe.dim() != 2 or queries.dim() != 2 or queries.shape != (probe.shape[0], corpus.shape[1]):
        raise ValueError(
            f"probe_scores: probe {tuple(probe.shape)} and queries "
            f"{tuple(queries.shape)} do not match corpus {tuple(corpus.shape)}")
    if not (corpus.device == probe.device == queries.device):
        raise ValueError("probe_scores: corpus, probe and queries must be on one device")


def probe_scores(corpus: torch.Tensor, probe: torch.Tensor, queries: torch.Tensor,
                 *, cap: int) -> torch.Tensor:
    """fp32 scores ``[Q, P, cap]`` of ``queries`` against their probed
    clusters.

    corpus:  [K * cap, D] cluster-major rows, fp32 or bf16
    probe:   [Q, P] cluster ids (any integer dtype)
    queries: [Q, D] (read as fp32)

    On the card D must be a multiple of 8 (16-byte row loads); any cap is
    taken. A probe id outside [0, K) gives NaN scores for that block."""
    _check(corpus, probe, queries, cap)
    if corpus.device.type == "cpu":
        return probe_scores_plain(corpus, probe, queries, cap=cap)
    if corpus.device.type != "cuda":
        raise ValueError(f"probe_scores: no kernel for device {corpus.device}")
    q_n, p_n = probe.shape
    d = corpus.shape[1]
    if d % 8 or 8 * d * 4 > 227 * 1024:
        raise ValueError(f"probe_scores kernel: D {d} must be a multiple of 8 and "
                         "8 fp32 queries must fit in shared memory")
    if q_n * p_n >= 2**31 or -(-cap // 64) > 65535:
        raise ValueError(f"probe_scores kernel: Q * P ({q_n} x {p_n}) must be < 2^31 and "
                         f"cap {cap} <= 65535 x 64")
    out = torch.empty((q_n, p_n, cap), dtype=torch.float32, device=corpus.device)
    if q_n == 0 or p_n == 0:
        return out
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError("probe_scores kernel: corpus must be contiguous and 16-byte aligned")
    n_clusters = corpus.shape[0] // cap
    pairs, start, cluster = group_probes(probe, n_clusters)
    qf = queries.to(torch.float32).contiguous()

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        rc = lib.rankpo_ivf_probe_scores(
            corpus.data_ptr(), pairs.data_ptr(), start.data_ptr(), cluster.data_ptr(),
            qf.data_ptr(), out.data_ptr(), n_clusters, q_n, p_n, cap, d,
            cluster.numel(), _DTYPES[corpus.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_scores kernel launch failed: cudaError {rc}")
    with _count_lock:
        launches["ivf_probe_scores"] += 1
    return out
