"""Corpus loading for serving (``rankpo_tpu.data.datasets.load_eval_corpus``
and ``rankpo_tpu.utils.jsonl.iter_jsonl``)."""

from __future__ import annotations

import json
from typing import Iterator, List


def iter_jsonl(path: str) -> Iterator[dict]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_eval_corpus(path: str) -> List[str]:
    """Eval corpus file: {"text": ...} per line (reference evaluate.py:153-158)."""
    return [d["text"] for d in iter_jsonl(path)]
