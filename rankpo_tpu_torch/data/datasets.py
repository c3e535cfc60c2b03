"""Tokenized in-memory datasets for training, and the loaders of the eval,
corpus and mining files (port of ``rankpo_tpu.data.datasets``).

Rows are tokenized eagerly on load with one batched tokenizer call per field;
the result is plain lists of variable-length id sequences consumed by the
static-shape collators (``data/collators.py``).
"""

from __future__ import annotations

from typing import List, Tuple

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
