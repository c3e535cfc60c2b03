"""Tokenized in-memory datasets for training, the streaming contrastive
dataset, and the loaders of the eval, corpus and mining files (port of
``rankpo_tpu.data.datasets``).

Rows are tokenized eagerly on load with one batched tokenizer call per field;
the result is plain lists of variable-length id sequences consumed by the
static-shape collators (``data/collators.py``).
:class:`StreamingContrastiveDataset` keeps the rows on disk and tokenizes
each on access.
"""

from __future__ import annotations

import json
import threading
from typing import List, Tuple

import numpy as np

from rankpo_tpu_torch.utils.jsonl import iter_jsonl


def load_eval_queries(path: str) -> Tuple[List[str], List[List[int]]]:
    """Eval query file: {"query": {"text"}, "positives": {"index"}}
    (reference evaluate.py:144-151). Returns (query texts, label index lists)."""
    queries, labels = [], []
    for d in iter_jsonl(path):
        queries.append(d["query"]["text"])
        labels.append(d["positives"]["index"])
    return queries, labels


def load_eval_corpus(path: str) -> List[str]:
    """Eval corpus file: {"text": ...} per line (reference evaluate.py:153-158)."""
    return [d["text"] for d in iter_jsonl(path)]


def load_mining_rows(path: str) -> Tuple[List[dict], List[str], List[str]]:
    """Mining input: rows with {"query": {"text"}, "positives": {"text": []},
    optional "negatives": {"text": []}} (reference get_hard_negatives.py:186-218).
    Returns (train rows with raw text, query texts, deduped corpus). The
    corpus keeps first-insertion order (positives, then negatives, row by
    row): mined files index into it, so the order is part of the format."""
    train_rows, queries, corpus = [], [], []
    for d in iter_jsonl(path):
        positives = d["positives"]["text"]
        if not isinstance(positives, list):
            raise ValueError(f"positives.text must be a list, got {type(positives).__name__}")
        corpus.extend(positives)
        if "negatives" in d:
            corpus.extend(d["negatives"]["text"])
        train_rows.append({"query": d["query"]["text"], "positives": positives})
        queries.append(d["query"]["text"])
    return train_rows, queries, list(dict.fromkeys(corpus))


def _rows(path_or_rows) -> List[dict]:
    if isinstance(path_or_rows, str):
        return list(iter_jsonl(path_or_rows))
    return list(path_or_rows)


def _batch_tokenize(tokenizer, texts: List[str], max_length: int) -> List[list]:
    """One batched tokenizer call per field."""
    if not texts:
        return []
    return tokenizer(texts, max_length=max_length, truncation=True)["input_ids"]


class ContrastiveDataset:
    """Rows of {query, positives[], negatives[]} (reference
    run_contrastive.py:161-166 tokenize_row)."""

    def __init__(
        self,
        path_or_rows,
        tokenizer,
        max_query_length: int = 32,
        max_passage_length: int = 128,
    ):
        rows = _rows(path_or_rows)
        queries = _batch_tokenize(tokenizer, [r["query"] for r in rows], max_query_length)
        flat_pos, flat_neg = [], []
        pos_span, neg_span = [], []
        for r in rows:
            pos_span.append((len(flat_pos), len(r["positives"])))
            flat_pos.extend(r["positives"])
            neg_span.append((len(flat_neg), len(r["negatives"])))
            flat_neg.extend(r["negatives"])
        pos_ids = _batch_tokenize(tokenizer, flat_pos, max_passage_length)
        neg_ids = _batch_tokenize(tokenizer, flat_neg, max_passage_length)
        self.rows: List[dict] = []
        for i in range(len(rows)):
            p_off, p_n = pos_span[i]
            n_off, n_n = neg_span[i]
            self.rows.append({
                "query": queries[i],
                "positives": pos_ids[p_off : p_off + p_n],
                "negatives": neg_ids[n_off : n_off + n_n],
            })

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        return self.rows[i]


class StreamingContrastiveDataset:
    """:class:`ContrastiveDataset`'s rows, kept on disk (JAX
    ``datasets.py:126-190``): the byte offset of every non-blank line comes
    from one scan at construction, and each access does a locked seek and
    read, then parses and tokenizes that row, so resident memory does not
    grow with the file. The DataLoader's prefetch thread overlaps this host
    work with the device's. Item ``i`` equals ``ContrastiveDataset``'s on
    the same file (blank lines are skipped by both). A pickled copy, and
    each unpickled one, opens its own file handle."""

    def __init__(
        self,
        path: str,
        tokenizer,
        max_query_length: int = 32,
        max_passage_length: int = 128,
    ):
        self.path = path
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_passage_length = max_passage_length
        starts, ends = [], []
        offset = 0
        with open(path, "rb") as f:
            for line in f:
                if line.strip():
                    starts.append(offset)
                    ends.append(offset + len(line))
                offset += len(line)
        self.spans = np.asarray([starts, ends], dtype=np.int64).reshape(2, -1)
        self._file = open(path, "rb")
        self._lock = threading.Lock()  # seek + read must be atomic across threads

    def __len__(self) -> int:
        return self.spans.shape[1]

    def __getitem__(self, i: int) -> dict:
        lo, hi = int(self.spans[0, i]), int(self.spans[1, i])
        with self._lock:
            self._file.seek(lo)
            raw = self._file.read(hi - lo)
        row = json.loads(raw)
        tok = self.tokenizer
        return {
            "query": _batch_tokenize(tok, [row["query"]], self.max_query_length)[0],
            "positives": _batch_tokenize(tok, row["positives"], self.max_passage_length),
            "negatives": _batch_tokenize(tok, row["negatives"], self.max_passage_length),
        }

    def __getstate__(self):
        # the file handle and the lock are process-local
        state = self.__dict__.copy()
        state["_file"] = None
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._file = open(self.path, "rb")
        self._lock = threading.Lock()


class PairPreferenceDataset:
    """Annotated pairs -> (query, chosen, rejected) via the ``preferred`` A/B
    rule (reference rankpo_trainer.py:354-372 tokenize_row); other fields of
    the jsonl are ignored."""

    def __init__(
        self,
        path_or_rows,
        tokenizer,
        max_query_length: int = 32,
        max_passage_length: int = 128,
    ):
        rows = _rows(path_or_rows)
        chosen_texts, rejected_texts = [], []
        for row in rows:
            preferred = row["preferred"]
            if preferred == "A":
                chosen, rejected = row["passage1"], row["passage2"]
            elif preferred == "B":
                chosen, rejected = row["passage2"], row["passage1"]
            else:
                raise ValueError(
                    f"Unsupported 'preferred' value {preferred!r}; expected 'A' or 'B'"
                )
            chosen_texts.append(chosen)
            rejected_texts.append(rejected)
        queries = _batch_tokenize(tokenizer, [r["query"] for r in rows], max_query_length)
        chosen_ids = _batch_tokenize(tokenizer, chosen_texts, max_passage_length)
        rejected_ids = _batch_tokenize(tokenizer, rejected_texts, max_passage_length)
        self.rows: List[dict] = [
            {"query": q, "chosen": c, "rejected": r}
            for q, c, r in zip(queries, chosen_ids, rejected_ids)
        ]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        return self.rows[i]
