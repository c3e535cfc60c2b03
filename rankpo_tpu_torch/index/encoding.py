"""Batched text -> embedding encoder for serving (port of
``rankpo_tpu.index.encoding.InferenceEncoder``).

Texts are tokenized on the host, right-padded to a length bucket (a multiple
of ``length_multiple`` capped at ``max_length``) and embedded on the device
under ``torch.inference_mode()``. Multi-batch calls process texts in length
order so each batch is length-homogeneous, then restore the input order.
``encode_device`` keeps the result on the device for the index build;
``encode`` returns host fp32.

``embed_packed_batch`` embeds sequence-packed query rows (serving's
``pack_queries``). Dropped from the JAX version, because they exist for
XLA's static shapes or for a device mesh: batch-size padding of the last
chunk, the bounded in-flight D2H window, mesh sharding; the sequence-packed
corpus encode (``encode_packed``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Union

import numpy as np
import torch

from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.data.collators import _pad_block
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed, embed_packed, encoder_class
from rankpo_tpu_torch.models.packing import scatter_packed_reps

logger = logging.getLogger(__name__)


class InferenceEncoder:
    def __init__(
        self,
        config: EncoderConfig,
        state: Dict[str, torch.Tensor],
        tokenizer,
        *,
        device="cuda",
        normalize_embeddings: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "auto",
        length_multiple: int = 64,
    ):
        self.config = config
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.normalize = normalize_embeddings
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.length_multiple = length_multiple
        self.model = encoder_class(config).from_state_dict(
            config, state, device=self.device, dtype=compute_dtype
        )

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, **kwargs) -> "InferenceEncoder":
        from rankpo_tpu_torch.data.tokenization import load_tokenizer
        from rankpo_tpu_torch.models.hf_io import load_pretrained

        config, state = load_pretrained(path)
        if tokenizer is None:
            tokenizer = load_tokenizer(path)
        return cls(config, state, tokenizer, **kwargs)

    # ------------------------------------------------------------------
    def _bucket_length(self, longest: int, max_length: int) -> int:
        m = self.length_multiple
        # the max_length cap wins over the multiple floor (a 32-token query
        # cap must not pad every query to 64)
        return min(max_length, max(m, -(-longest // m) * m))

    def prepare_batch(self, chunk: List[str], batch_size: int, max_length: int):
        """Tokenize + right-pad one chunk to [batch_size, bucket] host int32
        arrays; rows past len(chunk) are filler."""
        pad_id = self.config.pad_token_id or 0
        encoded = self.tokenizer(chunk, max_length=max_length, truncation=True)
        ids_list = encoded["input_ids"]
        longest = max(len(x) for x in ids_list)
        target = self._bucket_length(longest, max_length)
        block = _pad_block(ids_list, pad_id, target, None)
        pad_rows = batch_size - len(chunk)
        ids = np.pad(block["input_ids"], ((0, pad_rows), (0, 0)),
                     constant_values=pad_id)
        mask = np.pad(block["attention_mask"], ((0, pad_rows), (0, 0)))
        # filler rows get one attended (pad) token, so last-token pooling
        # never reads a row that has no valid key
        mask[len(chunk):, 0] = 1
        return {"input_ids": ids, "attention_mask": mask}

    @torch.inference_mode()
    def embed_batch(self, batch: Dict[str, np.ndarray], attn_impl=None) -> torch.Tensor:
        """fp32 [B, H] embeddings on the device for a ``prepare_batch`` dict."""
        dev = {
            "input_ids": torch.from_numpy(batch["input_ids"]).to(
                self.device, torch.int64),
            "attention_mask": torch.from_numpy(batch["attention_mask"]).to(
                self.device),
        }
        return embed(self.model, dev, normalize=self.normalize,
                     attn_impl=attn_impl or self.attn_impl)

    @torch.inference_mode()
    def embed_packed_batch(self, input_ids: np.ndarray, segment_ids: np.ndarray,
                           slot_index: np.ndarray, num_slots: int) -> torch.Tensor:
        """fp32 [num_slots, H] embeddings on the device of packed rows
        ([R, S] ids and segment ids, [R, M] slot table): each segment's
        embedding at its slot, zeros at slots no segment fills."""
        dev = {
            "input_ids": torch.from_numpy(input_ids).to(self.device, torch.int64),
            "segment_ids": torch.from_numpy(segment_ids).to(self.device),
        }
        reps, _valid = embed_packed(self.model, dev, slot_index.shape[1],
                                    normalize=self.normalize, attn_impl=self.attn_impl)
        return scatter_packed_reps(reps, torch.from_numpy(slot_index).to(self.device),
                                   num_slots)

    @torch.inference_mode()
    def encode_device(
        self,
        sentences: List[str],
        *,
        batch_size: int = 256,
        max_length: int = 512,
        sort_by_length: bool = True,
    ):
        """(fp32 [N, H] embeddings on the device in input order, N)."""
        sentences = list(sentences)
        if sentences and not isinstance(sentences[0], str):
            raise ValueError("Input items should be text.")
        n = len(sentences)
        order = None
        if sort_by_length and n > batch_size:
            # char length as the token-length proxy: length-homogeneous batches
            order = np.argsort([len(s) for s in sentences], kind="stable")
            sentences = [sentences[i] for i in order]
        out = torch.empty((n, self.config.hidden_size), dtype=torch.float32,
                          device=self.device)
        for lo in range(0, n, batch_size):
            chunk = sentences[lo : lo + batch_size]
            batch = self.prepare_batch(chunk, len(chunk), max_length)
            out[lo : lo + len(chunk)] = self.embed_batch(batch)
            if lo == 0:
                logger.info("encoding %d texts, batch %d, first seq %d", n,
                            batch_size, batch["input_ids"].shape[1])
        if order is not None:  # undo the length sort: row i <-> sentences[i]
            inverse = np.empty_like(order)
            inverse[order] = np.arange(n)
            out = out[torch.from_numpy(inverse).to(self.device)]
        return out, n

    def encode(
        self,
        sentences: Union[str, List[str]],
        *,
        batch_size: int = 256,
        max_length: int = 512,
        sort_by_length: bool = True,
    ) -> np.ndarray:
        """Host fp32 [N, H] embeddings (or [H] for a single string)."""
        single = isinstance(sentences, str)
        if single:
            sentences = [sentences]
        emb, _ = self.encode_device(sentences, batch_size=batch_size,
                                    max_length=max_length,
                                    sort_by_length=sort_by_length)
        result = emb.cpu().numpy()
        return result[0] if single else result
