"""Batched text -> embedding encoder for serving (port of
``rankpo_tpu.index.encoding.InferenceEncoder``).

Texts are tokenized on the host, right-padded to a length bucket (a multiple
of ``length_multiple`` capped at ``max_length``) and embedded on the device
under ``torch.inference_mode()``. Multi-batch calls process texts in length
order so each batch is length-homogeneous, then restore the input order.
``encode_device`` keeps the result on the device for the index build;
``encode`` returns host fp32.

``embed_packed_batch`` embeds sequence-packed query rows (serving's
``pack_queries``); ``encode_packed`` is the sequence-packed corpus encode.
An encoder built with ``model=`` encodes with that module's own tensors
(the in-training retrieval evaluation, ``eval/in_training.py``).

``encode_shard`` is the multi-process corpus encode: each rank of the data
group encodes only the texts of its own contiguous row shard
(``core/mesh.py`` ``shard_bounds``), in the length-sorted batches
``encode_device`` makes of them, and keeps the rows on its device; no
embedding crosses processes. The JAX package's ``encode_sharded`` slices
every global batch across the processes instead, so a passage may fall in
another batch here than in one process (its bf16 bits may differ). Dropped
from the JAX version, because they exist for XLA's static shapes: batch-size
padding of the last chunk (and of the packed encode's last rows), the
bounded in-flight D2H window.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.data.collators import _pad_block
from rankpo_tpu_torch.data.packing import occupancy, pack_token_lists
from rankpo_tpu_torch.models.base import EncoderModule
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed, embed_packed, encoder_class
from rankpo_tpu_torch.models.packing import scatter_packed_reps

logger = logging.getLogger(__name__)


class InferenceEncoder:
    def __init__(
        self,
        config: EncoderConfig,
        state: Optional[Dict[str, torch.Tensor]],
        tokenizer,
        *,
        device="cuda",
        normalize_embeddings: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "auto",
        length_multiple: int = 64,
        model: Optional[EncoderModule] = None,
    ):
        """The model is built from ``state`` in ``compute_dtype`` on
        ``device``; or, with ``model`` (and ``state`` None), the encoder
        runs that module as it stands: its tensors, its device and its
        compute dtype, no copy. ``model`` may be swapped later."""
        self.config = config
        self.tokenizer = tokenizer
        self.normalize = normalize_embeddings
        self.attn_impl = attn_impl
        self.length_multiple = length_multiple
        if model is not None:
            if state is not None:
                raise ValueError("give the encoder a state or a model, not both")
            self.device = next(model.parameters()).device
            self.model = model
            self.live_model = True
            return
        self.live_model = False
        self.device = resolve_device(device)
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

    @torch.inference_mode()
    def encode_shard(self, sentences: List[str], dp: int, d: int, *, batch_size: int = 256,
                     max_length: int = 512, group=None):
        """Shard ``d`` of ``dp`` of a row-sharded corpus: (fp32
        [n_padded / dp, H] on the device, the global rows
        ``mesh.shard_bounds(n_padded, dp, d)`` with rows past the corpus
        zero; the corpus's n_total). Only the shard's texts are encoded, in
        the batches :meth:`encode_device` makes of them alone. ``group``
        (the data group): every rank of it runs as many batches as the
        longest shard, the others padding with one masked row a batch (under
        fsdp and tensor parallelism a forward is a collective)."""
        n = len(sentences)
        lo, hi = mesh.shard_bounds(mesh.padded_rows(n, dp), dp, d)
        texts = list(sentences[lo:min(hi, n)])
        out = torch.zeros((hi - lo, self.config.hidden_size), dtype=torch.float32,
                          device=self.device)
        if texts:
            out[: len(texts)] = self.encode_device(texts, batch_size=batch_size,
                                                   max_length=max_length)[0]
        if group is not None:
            batches = -(-len(texts) // batch_size)
            most = torch.tensor([batches], dtype=torch.int64,
                                device="cpu" if mesh.host_collectives(group) else self.device)
            mesh.all_reduce_(most, group, op=torch.distributed.ReduceOp.MAX)
            pad_id = self.config.pad_token_id or 0
            filler = {"input_ids": np.full((1, self.length_multiple), pad_id, np.int32),
                      "attention_mask": np.zeros((1, self.length_multiple), np.int32)}
            filler["attention_mask"][:, 0] = 1
            for _ in range(int(most.item()) - batches):
                self.embed_batch(filler)
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

    @torch.inference_mode()
    def encode_packed(
        self,
        sentences: List[str],
        *,
        max_length: int = 512,
        pack_length: int = 0,
        tokens_per_batch: int = 65536,
        pack_chunk: int = 8192,
    ) -> np.ndarray:
        """Sequence-packed encode (JAX ``encoding.py:269-395``): host fp32
        [N, H] embeddings in input order.

        Each text is truncated to ``max_length``, then bin-packed with its
        neighbours into rows of ``pack_length`` tokens (0: the chunk's
        longest text rounded up to a power of two, at least 256), so the
        rows hold little padding. Each text's embedding is the one
        :meth:`encode` gives it, up to the kernels' rounding; only the
        batching differs. ``pack_chunk`` texts are tokenized and packed at
        a time; rows go to the device in batches of about
        ``tokens_per_batch`` tokens."""
        if isinstance(sentences, str):
            raise ValueError("encode_packed takes a list of texts")
        sentences = list(sentences)
        if sentences and not isinstance(sentences[0], str):
            raise ValueError("Input items should be text.")
        n = len(sentences)
        out = torch.zeros((n, self.config.hidden_size), dtype=torch.float32,
                          device=self.device)
        pad_id = self.config.pad_token_id or 0
        for lo in range(0, n, pack_chunk):
            chunk = sentences[lo : lo + pack_chunk]
            encoded = self.tokenizer(chunk, max_length=max_length, truncation=True)
            # an empty tokenization packs as one pad token (a finite
            # embedding, like the unpacked path's all-pad row)
            ids_list = [x or [pad_id] for x in encoded["input_ids"]]
            longest = max(len(x) for x in ids_list)
            if pack_length:
                cap = pack_length
                if longest > cap:
                    raise ValueError(
                        f"pack_length {cap} < longest tokenized text {longest}; "
                        "raise it or lower max_length")
            else:
                cap = 256
                while cap < longest:
                    cap *= 2
            # segment caps as powers of two, as the JAX package picks them
            mseg = 8
            while mseg < min(cap, 4 * max(1, cap // max(1, longest))):
                mseg *= 2
            packed = pack_token_lists(ids_list, cap, mseg, pad_id)
            m = 8
            while m < packed.max_segments:
                m *= 2
            rows_per_batch = max(1, tokens_per_batch // cap)
            if lo == 0:
                logger.info("packed encode: %d texts, rows %dx%d tokens, <=%d texts/row, "
                            "occupancy %.1f%%", n, rows_per_batch, cap, m,
                            100 * occupancy(packed))
            chunk_out = out[lo : lo + len(chunk)]
            for rlo in range(0, packed.n_rows, rows_per_batch):
                tidx = packed.text_index[rlo : rlo + rows_per_batch]
                tidx = np.pad(tidx, ((0, 0), (0, m - tidx.shape[1])), constant_values=-1)
                chunk_out += self.embed_packed_batch(
                    packed.input_ids[rlo : rlo + rows_per_batch],
                    packed.segment_ids[rlo : rlo + rows_per_batch], tidx, len(chunk))
        return out.cpu().numpy()
