"""Text encoder: backbone forward -> pooling -> optional L2 normalisation
(port of ``rankpo_tpu.models.encoder``). Serving and training both call
:func:`embed`, so the embedding semantics live in one place;
:func:`encoder_class` picks the body from the config (the llama body for
``config.is_llama``, else the Roberta/BERT body), as the JAX dispatch does;
:func:`resize_token_embeddings` grows the vocabulary after a tokenizer gains
special tokens. :func:`embed_packed` embeds sequence-packed rows
(``data/packing.py``): one embedding per segment."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

import torch

from rankpo_tpu_torch.models import llama, roberta
from rankpo_tpu_torch.models.base import EncoderModule
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.packing import packed_pool
from rankpo_tpu_torch.models.pooling import l2_normalize, pool


def _body(config: EncoderConfig):
    return llama if config.is_llama else roberta


def encoder_class(config: EncoderConfig) -> Type[EncoderModule]:
    """``LlamaEncoder`` or ``RobertaEncoder``; raises for a body that is not
    ported yet."""
    check_supported(config)
    return llama.LlamaEncoder if config.is_llama else roberta.RobertaEncoder


def check_supported(config: EncoderConfig) -> None:
    _body(config).check_supported(config)


def state_names(config: EncoderConfig):
    """HF tensor names of the config's body, in state_dict order."""
    return _body(config).state_names(config)


def init_params(config: EncoderConfig, generator: torch.Generator, **kwargs):
    """Random HF-named state dict of the config's body (``llama`` /
    ``roberta`` ``init_params``)."""
    return _body(config).init_params(config, generator, **kwargs)


def n_params(config: EncoderConfig) -> int:
    """Parameter count of the encoder body (tied LM head, pooler not
    counted)."""
    with torch.device("meta"):
        return sum(p.numel() for p in encoder_class(config)(config).parameters())


def forward_hidden(
    model: EncoderModule,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    attn_impl: str = "auto",
    generator: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Last hidden state [B, S, H] in the model's (compute) dtype; dropout
    is live when a ``generator`` is given and the body has any. With
    ``segment_ids`` (packed rows) ``attention_mask`` is not read."""
    return model(input_ids, attention_mask, attn_impl=attn_impl, generator=generator,
                 segment_ids=segment_ids)


def embed(
    model: EncoderModule,
    batch: Dict[str, torch.Tensor],
    *,
    normalize: Optional[bool] = None,
    attn_impl: str = "auto",
    output_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sentence embeddings [B, H] for {'input_ids', 'attention_mask'} inputs.

    Pooling comes from ``model.config`` (reference src/modeling.py:224-232);
    ``normalize`` defaults to ``config.normalize``. The compute dtype, and
    whether layers are recomputed in the backward pass, are the model's
    (``from_state_dict`` / ``for_training``, ``models/base.py``). With a
    ``generator`` the Roberta body's dropout is live (the JAX
    ``deterministic=False`` with a ``dropout_key``)."""
    config = model.config
    if normalize is None:
        normalize = config.normalize
    hidden = forward_hidden(
        model, batch["input_ids"], batch["attention_mask"], attn_impl=attn_impl,
        generator=generator,
    )
    reps = pool(hidden, batch["attention_mask"], config.pooling).to(output_dtype)
    if normalize:
        reps = l2_normalize(reps)
    return reps


def embed_packed(
    model: EncoderModule,
    batch: Dict[str, torch.Tensor],
    max_segments: int,
    *,
    normalize: Optional[bool] = None,
    attn_impl: str = "auto",
    output_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sentence embeddings of sequence-packed rows (JAX ``embed_packed``,
    ``encoder.py:115-165``): {'input_ids' [R, S], 'segment_ids' [R, S]}
    with several texts per row as contiguous segments 1..n and a 0-id pad
    tail. Returns (reps [R, max_segments, H], valid [R, max_segments]):
    slot j of row r embeds segment j + 1, as :func:`embed` embeds that text
    alone; invalid slots are zeros."""
    config = model.config
    if normalize is None:
        normalize = config.normalize
    segment_ids = batch["segment_ids"]
    hidden = forward_hidden(model, batch["input_ids"], None, attn_impl=attn_impl,
                            generator=generator, segment_ids=segment_ids)
    reps, valid = packed_pool(hidden, segment_ids, max_segments, config.pooling)
    reps = reps.to(output_dtype)
    if normalize:
        reps = l2_normalize(reps)
    return torch.where(valid[..., None], reps, 0.0), valid


def _tree_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """[1, H] fp32 sum of the rows of ``x`` [N, H] in the order XLA's CPU
    tree reduction takes: windows of 32 rows (zero rows padding the count
    to a multiple of 32, half before, half after) summed in order, level by
    level, until 32 or fewer remain, then those in order. The JAX package
    takes its mean as this sum times the fp32 reciprocal of the count, so
    the resized rows are bit-equal to its rows. The order is XLA's
    implementation, not its contract: should a jax release change it, the
    bit-equal test fails and ``table.float().mean(0)`` (within an ulp)
    takes this function's place."""
    while x.shape[0] > 32:
        n, h = x.shape
        pad = -n % 32
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2)).view(-1, 32, h)
        acc = torch.zeros_like(x[:, 0])
        for i in range(32):
            acc = acc + x[:, i]
        x = acc
    acc = torch.zeros_like(x[:1])
    for i in range(x.shape[0]):
        acc = acc + x[i : i + 1]
    return acc


def resize_token_embeddings(
    state: Dict[str, torch.Tensor],
    config,
    new_size: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], object]:
    """(state, config) with the embedding table grown or cut to ``new_size``
    rows (reference run_contrastive.py:132-143 adds 7 special tokens and
    resizes). New rows are the mean of the old rows, taken in fp32
    (:func:`_tree_sum_rows`) and cast to the table's dtype (HF's
    ``mean_resizing``), or normal(0.02) rows
    drawn in fp32 from ``generator`` when one is given. The table is
    ``embed_tokens.weight`` (llama body) or
    ``embeddings.word_embeddings.weight`` (Roberta body). The input state is
    not modified."""
    name = ("embed_tokens.weight" if config.is_llama
            else "embeddings.word_embeddings.weight")
    table = state[name]
    old_size, h = table.shape
    if new_size <= old_size:
        new_table = table[:new_size]
    elif generator is None:
        mean = _tree_sum_rows(table.to(torch.float32)) * torch.tensor(
            1.0 / old_size, dtype=torch.float32)
        new_table = torch.cat([table, mean.expand(new_size - old_size, h).to(table.dtype)])
    else:
        rows = torch.randn(new_size - old_size, h, generator=generator, dtype=torch.float32,
                           device=generator.device) * 0.02
        new_table = torch.cat([table, rows.to(table.device, table.dtype)])
    new_state = dict(state)
    new_state[name] = new_table
    return new_state, dataclasses.replace(config, vocab_size=new_size)
