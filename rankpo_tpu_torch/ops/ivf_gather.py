"""Probed-cluster scores for IVF search (port of
``rankpo_tpu.ops.ivf_gather_pallas``).

Replaces the Pallas TPU kernel ``_kernel`` (K4, reached through
``probe_scores``) with the CUDA C++ kernel ``ops/csrc/ivf_gather.cu`` for
``sm_90a``, built at first use (``ops/_build.py``) and called through its
plain C entry point with ctypes. It is bound by HBM bytes (a gathered
matrix-vector product); the source's header says what its design does about
that.

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
    if d % 8 or d * 4 > 227 * 1024:
        raise ValueError(f"probe_scores kernel: D {d} must be a multiple of 8 and "
                         "its fp32 query fit in shared memory")
    if q_n > 65535 or p_n > 65535:
        raise ValueError(f"probe_scores kernel: Q {q_n} and P {p_n} must be <= 65535")
    out = torch.empty((q_n, p_n, cap), dtype=torch.float32, device=corpus.device)
    if q_n == 0 or p_n == 0:
        return out
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError("probe_scores kernel: corpus must be contiguous and 16-byte aligned")
    probe32 = probe.to(torch.int32).contiguous()
    qf = queries.to(torch.float32).contiguous()

    from rankpo_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        rc = lib.rankpo_ivf_probe_scores(
            corpus.data_ptr(), probe32.data_ptr(), qf.data_ptr(), out.data_ptr(),
            corpus.shape[0] // cap, q_n, p_n, cap, d, _DTYPES[corpus.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_scores kernel launch failed: cudaError {rc}")
    with _count_lock:
        launches["ivf_probe_scores"] += 1
    return out
