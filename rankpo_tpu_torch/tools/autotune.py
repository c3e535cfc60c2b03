"""Index auto-tuner, the FAISS ParameterSpace / autotune analog (port of
``rankpo_tpu.tools.autotune``).

Given corpus embeddings, build a ladder of candidate factory specs
(``index/factory.py`` grammar), measure each one's recall@k against the
exact fp32 flat search, its query throughput and its device memory, and
recommend the fastest spec that meets the recall target inside the memory
budget.

Measurement notes:
  - Recall is hit-set overlap with ``FlatIPIndex`` over fp32 rows (FAISS's
    exact contract).
  - Queries/s times ``index.search`` on the host clock, the device
    synchronized before and after: the path every consumer (evaluation,
    mining, the serving fallback) takes, results on the host included, so
    the candidates are compared on the same footing.
  - Memory is the index's ``nbytes()``: the bytes of every tensor it holds
    (storage, scales, centroids, projections, codebooks).
  - Build time is reported, never optimized for: an index builds once.

Over a process group (``group=``, the data group; JAX runs the ladder on
its mesh, ``local_mesh()``), the oracle and every tier of the ladder are
sharded over the group, as JAX builds them on that mesh: every rank holds
the whole embedding matrix and the same queries, and each build and
search is a collective. Memory is then the sum over the ranks, a tensor
every rank holds whole (codebooks, rotation, PCA basis) counted once:
JAX's global ``nbytes``. Each time is the slowest rank's, so
every rank ranks the specs alike and returns the same report.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.device import resolve_device

logger = logging.getLogger(__name__)


def default_specs(n: int, dim: int) -> List[str]:
    """A candidate ladder spanning the memory / recall trade-off at this
    corpus size: exact fp32, half- and quarter-width flat storage, the
    PCA-prefiltered refine tier, IVF (auto cluster count) over bf16 and int8
    rows, and the PQ codec tiers when the width divides."""
    specs = ["Flat", "SQbf16", "SQ8"]
    if dim >= 64:
        specs.append(f"PCA{max(32, dim // 8)},Flat")
    if n >= 4096:  # IVF needs enough rows for meaningful clusters
        specs += ["IVF,Flat", "IVF,SQ8"]
        if dim % 16 == 0:
            m = dim // 16
            specs += [f"IVF,PQ{m}", f"OPQ{m},IVF,PQ{m}"]
    return specs


def _slowest(seconds: float, group, device) -> float:
    """The largest of the ranks' ``seconds`` (a collective); ``seconds``
    without a group."""
    if group is None:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    return float(mesh.all_reduce_(t, group, op=torch.distributed.ReduceOp.MAX).item())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune_index(
    embeddings: np.ndarray,
    *,
    queries: Optional[np.ndarray] = None,
    k: int = 100,
    recall_target: float = 0.95,
    memory_budget_gb: Optional[float] = None,
    specs: Optional[Sequence[str]] = None,
    n_queries: int = 256,
    repeats: int = 3,
    batch_size: int = 1024,
    seed: int = 0,
    device="cuda",
    group=None,
) -> Dict:
    """Benchmark candidate factory specs on ``embeddings`` (host fp32 [N,
    D], placed on ``device``) and recommend one. ``group``: the process
    group to shard the oracle and every tier over (module docstring; a
    collective, every rank passes the same embeddings and queries).

    Returns {"results": [per-spec dicts], "best": spec or None, "k", ...}.
    ``best`` is the highest-QPS spec with recall >= recall_target and memory
    within budget; None if none qualifies (the table still ranks every
    candidate). A spec that fails to build or search (a PQ width that does
    not divide D, say) is reported with an ``error`` instead of ending the
    sweep."""
    from rankpo_tpu_torch.index.factory import resolve_index_spec
    from rankpo_tpu_torch.index.flat import FlatIPIndex
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.index.refined import RefineIPIndex

    device = resolve_device(device)
    embeddings = np.asarray(embeddings, np.float32)
    n, dim = embeddings.shape
    k = min(k, n)
    if queries is None:
        # self-queries with small noise: non-degenerate neighbourhoods while
        # every query keeps a well-defined exact answer
        rng = np.random.default_rng(seed)
        picks = rng.choice(n, size=min(n_queries, n), replace=False)
        queries = embeddings[picks] + 0.01 * rng.standard_normal(
            (len(picks), dim)).astype(np.float32)
    queries = np.asarray(queries, np.float32)
    emb = torch.from_numpy(embeddings).to(device)
    shard = {} if group is None else {"group": group}

    _, exact_ids = FlatIPIndex(emb, **shard).search(queries, k=k, batch_size=batch_size)
    exact_sets = [set(map(int, row[row >= 0])) for row in exact_ids]
    budget_bytes = memory_budget_gb * (1 << 30) if memory_budget_gb is not None else None

    results: List[Dict] = []
    for spec in (specs if specs is not None else default_specs(n, dim)):
        kind, kwargs = resolve_index_spec(spec)
        row: Dict = {"spec": spec, "kind": kind}
        try:
            _sync(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                if kind == "refine":
                    kwargs.setdefault("recall_target", recall_target)
                    index = RefineIPIndex(emb, **kwargs, **shard)
                elif kind == "ivf":
                    kwargs.setdefault("recall_target", recall_target)
                    index = IVFIPIndex(emb, **kwargs, **shard)
                else:
                    index = FlatIPIndex(emb, **kwargs, **shard)
            _sync(device)
            row["build_s"] = round(_slowest(time.perf_counter() - t0, group, device), 3)
        except Exception as e:  # report, don't end the sweep
            row["error"] = str(e)
            results.append(row)
            logger.warning("autotune: %s failed to build: %s", spec, e)
            continue

        try:
            _, ids = index.search(queries, k=k, batch_size=batch_size)
            hits = sum(len(exact_sets[i] & set(map(int, ids[i][ids[i] >= 0])))
                       for i in range(len(queries)))
            # the unrounded recall decides feasibility (rounding first can
            # lift 0.94996 to 0.95); rounded only for the report
            recall = hits / max(1, sum(map(len, exact_sets)))
            row["recall"] = round(recall, 4)
            best_dt = math.inf
            for _ in range(repeats):
                _sync(device)
                t0 = time.perf_counter()
                index.search(queries, k=k, batch_size=batch_size)
                _sync(device)
                best_dt = min(best_dt, _slowest(time.perf_counter() - t0, group, device))
        except Exception as e:  # e.g. a tuned nprobe that runs out of memory
            row["error"] = str(e)
            results.append(row)
            logger.warning("autotune: %s failed to search: %s", spec, e)
            del index
            continue
        row["qps"] = round(len(queries) / best_dt, 1)
        mem_bytes = index.nbytes()
        row["memory_mb"] = round(mem_bytes / (1 << 20), 2)
        row["feasible"] = bool(recall >= recall_target
                               and (budget_bytes is None or mem_bytes <= budget_bytes))
        results.append(row)
        del index

    feasible = [r for r in results if r.get("feasible")]
    best = max(feasible, key=lambda r: r["qps"])["spec"] if feasible else None
    results.sort(key=lambda r: -r.get("qps", -1.0))
    return {"results": results, "best": best, "k": k, "recall_target": recall_target,
            "n": n, "dim": dim, "n_queries": int(len(queries))}
