"""Tokenizers for the port (a copy of ``rankpo_tpu.data.tokenization``).

``HashTokenizer`` is the hermetic word-hash tokenizer; it must produce the
same ids as the JAX package's copy, which the cross-package serving test
relies on. ``load_tokenizer`` imports ``transformers`` only when called: the
machine with the card has no ``transformers``, so runs there use
``hash:<vocab>`` tokenizers (``resolve_tokenizer``).

``prepare_tokenizer`` applies the reference's two rules to a HuggingFace
tokenizer (reference src/run_contrastive.py:110-143): Llama-3.2's reserved
pad token (EOS when the vocabulary lacks it) and the seven domain special
tokens of the title/abstract corpus format; the caller then resizes the
embedding table (``models/encoder.py`` ``resize_token_embeddings``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence, Union

LLAMA_PAD_TOKEN = "<|finetune_right_pad_id|>"

DOMAIN_SPECIAL_TOKENS = [
    "<keyword>",
    "</keyword>",
    "<title>",
    "</title>",
    "<abstract>",
    "</abstract>",
    "<sep>",
]


def load_tokenizer(path: str, use_fast: bool = True):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, use_fast=use_fast)


def prepare_tokenizer(tokenizer) -> int:
    """Apply the pad-token and special-token rules in place. Returns the
    vocabulary size the model's embedding table must be resized to."""
    if tokenizer.pad_token is None:
        # Llama-3.2 rule; EOS for tokenizers lacking the reserved token
        pad_id = tokenizer.convert_tokens_to_ids(LLAMA_PAD_TOKEN)
        if pad_id is not None and pad_id != getattr(tokenizer, "unk_token_id", None):
            tokenizer.pad_token = LLAMA_PAD_TOKEN
            tokenizer.pad_token_id = pad_id
        else:
            tokenizer.pad_token = tokenizer.eos_token
    tokenizer.add_special_tokens({"additional_special_tokens": DOMAIN_SPECIAL_TOKENS})
    return len(tokenizer)


def resolve_tokenizer(name_or_path: Optional[str], model_path: str):
    """'hash:<vocab>' -> HashTokenizer (hermetic); otherwise HF AutoTokenizer
    (``rankpo_tpu.cli.arguments.resolve_tokenizer``). The HashTokenizer's
    pad and CLS ids follow the model's ``config.json`` (:func:`hash_special_ids`)."""
    target = name_or_path or model_path
    if target and target.startswith("hash:"):
        return HashTokenizer(vocab_size=int(target.split(":", 1)[1]),
                             **hash_special_ids(model_path))
    return load_tokenizer(target)


def hash_special_ids(model_path: Optional[str]) -> dict:
    """Pad and CLS ids of a HashTokenizer for the model at ``model_path``:
    the config's ``pad_token_id`` when it is one of the reserved ids 0-2,
    with CLS at 0 when the pad is 1 (XLM-Roberta's ``<s>`` 0 and ``<pad>``
    1) and at 1 otherwise; the defaults (pad 0, CLS 1) without a config.
    The Roberta position rule counts every id other than the config's pad
    as text, so an XLM-Roberta model must be fed its own pad; a pad id
    outside the reserved range would collide with word ids and raises for
    the Roberta family (the llama body reads only the mask)."""
    path = os.path.join(model_path, "config.json") if model_path else None
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        config = json.load(f)
    pad = config.get("pad_token_id")
    if pad is None:
        return {}
    if pad not in (0, 1, 2):
        if config.get("model_type") in ("xlm-roberta", "roberta", "bert"):
            raise ValueError(
                f"{model_path}: pad_token_id {pad} lies in the hash tokenizer's "
                "word ids; a hash:<vocab> tokenizer needs a pad id of 0, 1 or 2"
            )
        return {}
    return {"pad_token_id": pad, "cls_token_id": 0 if pad == 1 else 1}


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
