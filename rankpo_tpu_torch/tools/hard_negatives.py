"""Hard-negative mining: corpus encode + top-k search + selection policies
(port of ``rankpo_tpu.tools.hard_negatives``; reference
src/get_hard_negatives.py).

The corpus is encoded on the device and searched there (flat by default, or
IVF); its embeddings also come to the host once for the cluster policy.
Negatives are then selected per query by one of three policies (:43-122):

  - ``topk``:   the top candidates in rank order;
  - ``sample``: uniform sample from the search range;
  - ``cluster``: KMeans over the candidate embeddings, then sampling without
    replacement with weight λ^k where k = number already picked from that
    candidate's cluster (diversity-decay sampling).

Candidates that are positives of the query, or the query text itself, are
filtered first (:69-73). When λ is unset the reference sweeps λ ∈ {0.9..0.1}
(:254-259) and writes one jsonl per method/λ; same here. For the same seed
and candidates the rows equal the JAX package's.

Several processes (``group=``, the data group): each rank encodes the
queries and its own row shard of the corpus into a sharded index (every
rank gets the same hits); the shards' fp32 embeddings are gathered for the
cluster policy, and rank 0 alone selects and writes the files (the JAX tool
has every process write the same files, ``hard_negatives.py:125``, which
races on a shared disk).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.datasets import load_mining_rows
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import (
    build_offline_index,
    check_sharded_tier,
    shard_count,
    resolve_index_spec,
)

logger = logging.getLogger(__name__)

_METHODS = ("topk", "sample", "cluster")


def _lloyd_labels(matrix: np.ndarray, n_clusters: int, seed: int) -> np.ndarray:
    """Plain numpy Lloyd's iterations from seeded random centres: the
    fallback where scikit-learn is not installed."""
    rng = np.random.default_rng(seed)
    n = len(matrix)
    centers = matrix[rng.choice(n, size=min(n_clusters, n), replace=False)]
    labels = np.zeros(n, np.int64)
    for _ in range(25):
        d = ((matrix[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(len(centers)):
            members = matrix[labels == c]
            if len(members):
                centers[c] = members.mean(0)
    return labels


def _kmeans_labels(matrix: np.ndarray, n_clusters: int, seed: int) -> np.ndarray:
    """Cluster candidate embeddings. sklearn KMeans (k-means++, the reference's
    choice :97-98) when available; plain numpy Lloyd's otherwise."""
    try:
        from sklearn.cluster import KMeans
    except ImportError:
        return _lloyd_labels(matrix, n_clusters, seed)
    km = KMeans(n_clusters=n_clusters, init="k-means++", random_state=seed)
    return km.fit(matrix).labels_


def select_negative_ids(
    candidate_ids: Sequence[Sequence[int]],
    *,
    num_negatives: int,
    method: str,
    train_rows: Sequence[dict],
    corpus: Sequence[str],
    corpus_embedding: Optional[np.ndarray] = None,
    num_clusters: Optional[int] = None,
    lambda_: Optional[float] = None,
    seed: int = 42,
) -> List[np.ndarray]:
    """Per-query negative id selection (reference get_negative_ids :43-122)."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    rng = np.random.default_rng(seed)

    all_negative_ids: List[np.ndarray] = []
    for i, row in enumerate(train_rows):
        positives = set(row["positives"])
        filtered = []
        for j in candidate_ids[i]:
            j = int(j)
            if j < 0:
                raise RuntimeError(f"no hard negatives found for row {i}")
            if corpus[j] not in positives and corpus[j] != row["query"]:
                filtered.append(j)
        if len(filtered) < num_negatives:
            raise RuntimeError(
                f"row {i}: only {len(filtered)} candidates after filtering "
                f"(< num_negatives={num_negatives}); increase the search range"
            )

        if method == "topk":
            picked = np.asarray(filtered[:num_negatives])
        elif method == "sample":
            picked = rng.choice(filtered, size=num_negatives, replace=False)
        else:  # cluster
            matrix = np.asarray(
                [corpus_embedding[j] for j in filtered], dtype=np.float32
            )
            k = min(num_clusters, len(filtered))
            labels = _kmeans_labels(matrix, k, seed)
            weights = np.empty(len(filtered), np.float64)
            visited = [0] * k
            for pos, lab in enumerate(labels):
                weights[pos] = lambda_ ** visited[lab]
                visited[lab] += 1
            weights /= weights.sum()
            picked = rng.choice(filtered, size=num_negatives, replace=False, p=weights)
        all_negative_ids.append(np.asarray(picked, np.int64))
    return all_negative_ids


def _save_mined(
    output_file: str,
    all_negative_ids: List[np.ndarray],
    train_rows: Sequence[dict],
    corpus: Sequence[str],
    rng: np.random.Generator,
) -> None:
    """jsonl rows {query, positives=[one sampled], negatives=[...]} (reference
    save_data :128-148)."""
    with open(output_file, "w", encoding="utf-8") as f:
        for i, row in enumerate(train_rows):
            pick = int(rng.integers(len(row["positives"])))
            d = {
                "query": row["query"],
                "positives": [row["positives"][pick]],
                "negatives": [corpus[int(j)] for j in all_negative_ids[i]],
            }
            f.write(json.dumps(d, ensure_ascii=False) + "\n")
    logger.info("saved mined negatives to %s", output_file)


def find_hard_negatives(
    encoder: InferenceEncoder,
    input_file: str,
    output_prefix: str,
    *,
    max_query_length: int = 32,
    max_passage_length: int = 128,
    num_negatives: int = 10,
    search_range: Tuple[int, int] | str = (0, 100),
    method: Optional[str] = None,
    batch_size: int = 256,
    num_clusters: int = 10,
    lambda_: Optional[float] = None,
    seed: int = 42,
    index_type: str = "flat",
    index_recall_target: float = 0.95,
    index_kwargs: Optional[dict] = None,
    group=None,
) -> Dict[str, str]:
    """Run the full mining pipeline on the encoder's device; returns
    {output-name: path} (``group``: the data group the corpus is sharded
    over; the names on every rank, the files from rank 0)."""
    if isinstance(search_range, str):
        lo, hi = (int(x) for x in search_range.split("-"))
    else:
        lo, hi = search_range

    if method:
        methods = [m.strip() for m in method.split(",") if m.strip() in _METHODS]
    else:
        methods = []
    if not methods:
        methods = list(_METHODS)
    lambdas = [lambda_] if lambda_ is not None else [x / 10.0 for x in range(9, 0, -1)]

    # an invalid spec fails here, not after the corpus encode
    index_type, index_kwargs = resolve_index_spec(index_type, index_kwargs)
    check_sharded_tier(index_type, shard_count(group))

    train_rows, queries, corpus = load_mining_rows(input_file)
    # the reference samples ONE positive per row at load time (:207) for the
    # self-filter; all positives are kept for filtering (a superset filter,
    # strictly safer) and one is sampled at save time like save_data does
    logger.info(
        "mining: %d queries, %d corpus texts, range [%d, %d), methods %s",
        len(queries), len(corpus), lo, hi, methods,
    )
    q_emb = encoder.encode(queries, batch_size=batch_size,
                           max_length=max_query_length)
    if group is None:
        c_dev, n_corpus = encoder.encode_device(corpus, batch_size=batch_size,
                                                max_length=max_passage_length)
        c_emb = c_dev.cpu().numpy()  # the cluster policy's embeddings, on the host
    else:
        c_dev, n_corpus = encoder.encode_shard(
            corpus, mesh.group_size(group), mesh.group_index(group),
            batch_size=batch_size, max_length=max_passage_length)
        c_emb = (mesh.all_gather_rows(c_dev, group)[:n_corpus].cpu().numpy()
                 if "cluster" in methods else None)
    # the refine tier's PCA moment of the stored rows, as the JAX mining
    # tool's host constructor takes it
    index = build_offline_index(c_dev, n_corpus, index_type, index_kwargs,
                                index_recall_target, as_constructor=True, group=group)
    _scores, indices = index.search(q_emb, k=hi, batch_size=batch_size)
    del index, c_dev
    # drop IVF's -1 tail padding (unreachable slots) before sampling
    candidate_ids = [row[lo:hi][row[lo:hi] >= 0] for row in indices]

    main = mesh.is_main_process()
    if main:
        os.makedirs(output_prefix, exist_ok=True)
    outputs: Dict[str, str] = {}
    for m in methods:
        for lam in lambdas:
            if m in ("topk", "sample"):
                name = f"{m}.jsonl"
            else:
                name = f"cluster{int(lam * 10)}.jsonl"
            path = os.path.join(output_prefix, name)
            outputs[name] = path
            if not main:  # rank 0 selects and writes
                if m in ("topk", "sample"):
                    break
                continue
            ids = select_negative_ids(
                candidate_ids,
                num_negatives=num_negatives,
                method=m,
                train_rows=train_rows,
                corpus=corpus,
                corpus_embedding=c_emb,
                num_clusters=num_clusters,
                lambda_=lam,
                seed=seed,
            )
            _save_mined(path, ids, train_rows, corpus, np.random.default_rng(seed))
            if m in ("topk", "sample"):
                break  # λ sweep applies to cluster only (:296-298)
    return outputs
