"""Static-shape batch collators (port of ``rankpo_tpu.data.collators``).

- Contrastive (reference src/data_utils.py:25-77): per row, ONE random
  positive and ``num_negatives`` sampled negatives; passages flattened to
  [B*(1+n)]; query and passage blocks padded independently.
- RankPO (:181-214): chosen/rejected interleaved into a [2B] passage block.

Blocks are right-padded to a fixed length per field (``max_*_length``) or to
a multiple (``pad_multiple``). Right padding only: last-token pooling
(``models/pooling.py``) reads the position before the first pad.

Sampling draws from a ``numpy.random.Generator`` owned by the collator,
with the same calls in the same order as the JAX package, so one seed gives
the same batches bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _pad_block(
    seqs: Sequence[Sequence[int]],
    pad_token_id: int,
    fixed_length: Optional[int],
    pad_multiple: Optional[int],
) -> Dict[str, np.ndarray]:
    longest = max(len(s) for s in seqs)
    if fixed_length is not None and pad_multiple is None:
        target = fixed_length
    else:
        m = pad_multiple or 1
        target = -(-longest // m) * m
        if fixed_length is not None:
            target = min(target, fixed_length)
    target = max(target, 1)
    ids = np.full((len(seqs), target), pad_token_id, dtype=np.int32)
    mask = np.zeros((len(seqs), target), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:target]
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return {"input_ids": ids, "attention_mask": mask}


class ContrastiveCollator:
    def __init__(
        self,
        pad_token_id: int = 0,
        num_negatives: int = 5,
        max_query_length: Optional[int] = None,
        max_passage_length: Optional[int] = None,
        pad_multiple: Optional[int] = None,
        seed: int = 0,
    ):
        self.pad_token_id = pad_token_id
        self.num_negatives = num_negatives
        self.max_query_length = max_query_length
        self.max_passage_length = max_passage_length
        self.pad_multiple = pad_multiple
        self.rng = np.random.default_rng(seed)

    def sample(self, rows: List[dict]):
        """Per row, ONE random positive + ``num_negatives`` negatives drawn
        without replacement. Returns (queries, passages [B*(1+n)])."""
        queries, passages = [], []
        for row in rows:
            queries.append(row["query"])
            positives = row["positives"]
            negatives = row["negatives"]
            pick = self.rng.integers(len(positives))
            passages.append(positives[pick])
            if len(negatives) < self.num_negatives:
                raise ValueError(
                    f"row has {len(negatives)} negatives < num_negatives="
                    f"{self.num_negatives}"
                )
            neg_ids = self.rng.choice(len(negatives), size=self.num_negatives, replace=False)
            passages.extend(negatives[j] for j in neg_ids)
        return queries, passages

    def __call__(self, rows: List[dict]) -> Dict[str, Dict[str, np.ndarray]]:
        queries, passages = self.sample(rows)
        return {
            "query": _pad_block(queries, self.pad_token_id, self.max_query_length,
                                self.pad_multiple),
            "passage": _pad_block(passages, self.pad_token_id,
                                  self.max_passage_length, self.pad_multiple),
        }


class RankPOCollator:
    def __init__(
        self,
        pad_token_id: int = 0,
        max_query_length: Optional[int] = None,
        max_passage_length: Optional[int] = None,
        pad_multiple: Optional[int] = None,
    ):
        self.pad_token_id = pad_token_id
        self.max_query_length = max_query_length
        self.max_passage_length = max_passage_length
        self.pad_multiple = pad_multiple

    def __call__(self, rows: List[dict]) -> Dict[str, Dict[str, np.ndarray]]:
        for key in ("query", "chosen", "rejected"):
            if key not in rows[0]:
                raise KeyError(f"key '{key}' is missing from batch rows")
        queries = [row["query"] for row in rows]
        passages = []
        for row in rows:
            passages.append(row["chosen"])
            passages.append(row["rejected"])
        return {
            "query": _pad_block(queries, self.pad_token_id, self.max_query_length,
                                self.pad_multiple),
            "passage": _pad_block(passages, self.pad_token_id,
                                  self.max_passage_length, self.pad_multiple),
        }
