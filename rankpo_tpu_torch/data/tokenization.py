"""Tokenizers for the port (a copy of ``rankpo_tpu.data.tokenization``'s
serving half).

``HashTokenizer`` is the hermetic word-hash tokenizer; it must produce the
same ids as the JAX package's copy, which the cross-package serving test
relies on. ``load_tokenizer`` imports ``transformers`` only when called: the
machine with the card has no ``transformers``, so runs there use
``hash:<vocab>`` tokenizers (``resolve_tokenizer``).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Union


def load_tokenizer(path: str, use_fast: bool = True):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, use_fast=use_fast)


def resolve_tokenizer(name_or_path: Optional[str], model_path: str):
    """'hash:<vocab>' -> HashTokenizer (hermetic); otherwise HF AutoTokenizer
    (``rankpo_tpu.cli.arguments.resolve_tokenizer``)."""
    target = name_or_path or model_path
    if target and target.startswith("hash:"):
        return HashTokenizer(vocab_size=int(target.split(":", 1)[1]))
    return load_tokenizer(target)


class HashTokenizer:
    """Deterministic, dependency-free tokenizer for tests and smoke runs.

    Word-level with md5 hashing into [n_reserved, vocab_size). Follows the HF
    call convention: ``tok(texts, max_length=, truncation=True)`` returns
    ``{'input_ids': [...], 'attention_mask': [...]}`` (lists, unpadded).
    """

    def __init__(
        self,
        vocab_size: int = 512,
        pad_token_id: int = 0,
        cls_token_id: int = 1,
        add_cls: bool = True,
    ):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.cls_token_id = cls_token_id
        self.add_cls = add_cls
        self.pad_token = "<pad>"
        self._n_reserved = 3

    def __len__(self) -> int:
        return self.vocab_size

    def _encode_one(self, text: str, max_length: Optional[int], truncation: bool):
        ids = []
        if self.add_cls:
            ids.append(self.cls_token_id)
        for word in text.split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            ids.append(self._n_reserved + h % (self.vocab_size - self._n_reserved))
        if truncation and max_length is not None:
            ids = ids[:max_length]
        if not ids:
            ids = [self.cls_token_id]
        return ids

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        max_length: Optional[int] = None,
        truncation: bool = False,
        **kwargs,
    ) -> dict:
        if isinstance(text, str):
            ids = self._encode_one(text, max_length, truncation)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        encoded = [self._encode_one(t, max_length, truncation) for t in text]
        return {
            "input_ids": encoded,
            "attention_mask": [[1] * len(e) for e in encoded],
        }
