"""JSONL reading and writing (port of ``rankpo_tpu.utils.jsonl``'s
``iter_jsonl`` and ``write_jsonl``).

Schemas used across the pipeline:
  - train rows:      {"query": str, "positives": [str], "negatives": [str]}
  - annotated pairs: {"query": str, "passage1": str, "passage2": str,
                     "preferred": "A"|"B", ...}
  - eval queries:    {"query": {"text": str}, "positives": {"index": [int]}}
    eval corpus:     {"text": str}
  - mining rows:     {"query": {"text": str}, "positives": {"text": [str]},
                     optional "negatives": {"text": [str]}}
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Iterator


def iter_jsonl(path: str) -> Iterator[dict]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def write_jsonl(path: str, rows: Iterable[Any]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
