"""Top-prediction pair generator for AI-preference annotation (port of
``rankpo_tpu.tools.predictions``; the same rows for the same candidates and
seed).

Fills the gap the reference leaves open: ``PredictionDataArguments``
(src/arguments.py:546-666) describes a get_predictions workload — retrieve
top-k candidates per query and select ``num_predictions`` of them by ``topk``
or ``sample`` — whose script is absent from the repo (SURVEY.md §2 "Prediction
generator (absent)"), even though scripts/train/run_rankpo.sh consumes its
output. The RankPO stage needs (query, passage1, passage2) pairs for the AI
judge; this emits both the ranked candidate dump and judge-ready pairs.

Output rows:
  {"query": ..., "query_id": i,
   "passage1": ..., "passage_id1": j1, "passage_rank1": r1,
   "passage2": ..., "passage_id2": j2, "passage_rank2": r2}
so an external judge only needs to add "preferred": "A"|"B" to produce
RankPO training data (data/annotated_pair_data-sample.jsonl schema).

Several processes (``group=``, the data group): each rank encodes the
queries and its own row shard of the corpus into a sharded index, every
rank gets the same hits and rows, and rank 0 alone writes the file (the
JAX tool has every process write the same file, ``predictions.py:156``,
which races on a shared disk).
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.datasets import load_eval_corpus, load_eval_queries
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import (
    build_offline_index,
    check_sharded_tier,
    shard_count,
    resolve_index_spec,
)
from rankpo_tpu_torch.utils.jsonl import write_jsonl

logger = logging.getLogger(__name__)


def generate_predictions(
    encoder: InferenceEncoder,
    query_data: str,
    corpus_data: str,
    output_file: str,
    *,
    max_query_length: int = 32,
    max_passage_length: int = 128,
    search_range: Tuple[int, int] | str = (0, 100),
    method: str = "topk",
    num_predictions: int = 10,
    batch_size: int = 256,
    seed: int = 42,
    emit_pairs: bool = True,
    index_type: str = "flat",
    index_recall_target: float = 0.95,
    index_kwargs: Optional[dict] = None,
    group=None,
) -> List[dict]:
    """Retrieve candidates and emit annotation-ready pairs (``group``: the
    data group the corpus is sharded over; module docstring).

    ``method='topk'`` keeps the top ``num_predictions`` of the search range;
    ``'sample'`` draws them uniformly from it. With ``emit_pairs`` every
    unordered pair of selected candidates becomes one row (the judge compares
    two passages per row); otherwise one row per query lists the candidates.
    """
    if isinstance(search_range, str):
        lo, hi = (int(x) for x in search_range.split("-"))
    else:
        lo, hi = search_range
    rng = np.random.default_rng(seed)

    # an invalid spec fails here, not after the corpus encode
    index_type, index_kwargs = resolve_index_spec(index_type, index_kwargs)
    check_sharded_tier(index_type, shard_count(group))
    queries, _labels = load_eval_queries(query_data)
    corpus = load_eval_corpus(corpus_data)

    q_emb = encoder.encode(queries, batch_size=batch_size,
                           max_length=max_query_length)
    # the corpus embeddings feed only the index: they stay on the device
    if group is None:
        c_emb, n_corpus = encoder.encode_device(corpus, batch_size=batch_size,
                                                max_length=max_passage_length)
    else:
        c_emb, n_corpus = encoder.encode_shard(
            corpus, mesh.group_size(group), mesh.group_index(group),
            batch_size=batch_size, max_length=max_passage_length)
    index = build_offline_index(c_emb, n_corpus, index_type, index_kwargs,
                                index_recall_target, group=group)
    scores, indices = index.search(q_emb, k=hi, batch_size=batch_size)

    rows: List[dict] = []
    for qi, query in enumerate(queries):
        cand = indices[qi][lo:hi]
        ranks = np.arange(lo, hi)
        valid = cand >= 0  # IVF pads unreachable tail slots with -1
        cand, ranks = cand[valid], ranks[valid]
        if method == "topk":
            sel = np.arange(min(num_predictions, len(cand)))
        elif method == "sample":
            sel = np.sort(
                rng.choice(len(cand), size=min(num_predictions, len(cand)),
                           replace=False)
            )
        else:
            raise ValueError(f"method must be 'topk' or 'sample', got {method!r}")
        picked = [(int(cand[s]), int(ranks[s])) for s in sel]

        if emit_pairs:
            for (j1, r1), (j2, r2) in itertools.combinations(picked, 2):
                rows.append(
                    {
                        "query": query,
                        "query_id": qi,
                        "passage1": corpus[j1],
                        "passage_id1": j1,
                        "passage_rank1": r1,
                        "passage2": corpus[j2],
                        "passage_id2": j2,
                        "passage_rank2": r2,
                    }
                )
        else:
            rows.append(
                {
                    "query": query,
                    "query_id": qi,
                    "predictions": [
                        {"passage": corpus[j], "passage_id": j, "rank": r}
                        for j, r in picked
                    ],
                }
            )

    if mesh.is_main_process():
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        write_jsonl(output_file, rows)
        logger.info("wrote %d prediction rows to %s", len(rows), output_file)
    return rows
