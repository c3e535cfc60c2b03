"""Random-negative bootstrap for iteration 0 of the mining loop (port of
``rankpo_tpu.tools.random_negatives``; the same rows for the same seed).

Capability parity with the reference (src/get_random_negatives.py): build the
corpus from all positives (+ any existing negatives), then per query uniformly
sample ``num_negatives`` corpus items that are neither among the query's
positives nor the query itself. Pure host-side; no accelerator involved.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from rankpo_tpu_torch.data.datasets import load_mining_rows
from rankpo_tpu_torch.utils.jsonl import write_jsonl

logger = logging.getLogger(__name__)


def find_random_negatives(
    input_file: str,
    output_file: str,
    num_negatives: int = 15,
    seed: Optional[int] = None,
) -> List[dict]:
    train_rows, _queries, corpus = load_mining_rows(input_file)
    rng = np.random.default_rng(seed)

    out_rows = []
    for row in train_rows:
        positives = set(row["positives"])
        n_eligible = sum(
            1 for c in corpus if c not in positives and c != row["query"]
        )
        if n_eligible < num_negatives:
            raise ValueError(
                f"cannot sample {num_negatives} random negatives: only "
                f"{n_eligible} corpus items are neither a positive of nor "
                f"equal to the query {row['query']!r} (reference would also "
                "fail here; shrink --num_negatives or grow the corpus)"
            )
        chosen: List[int] = []
        chosen_set = set()
        while len(chosen) < num_negatives:
            j = int(rng.integers(len(corpus)))
            if (
                j not in chosen_set
                and corpus[j] not in positives
                and corpus[j] != row["query"]
            ):
                chosen.append(j)
                chosen_set.add(j)
        out_rows.append(
            {
                "query": row["query"],
                "positives": row["positives"],  # all positives retained
                "negatives": [corpus[j] for j in chosen],
            }
        )
    write_jsonl(output_file, out_rows)
    logger.info("wrote %d rows to %s", len(out_rows), output_file)
    return out_rows
