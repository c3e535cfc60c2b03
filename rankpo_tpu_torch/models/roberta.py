"""XLM-Roberta / BERT encoder, the BGE families (PyTorch port of
``rankpo_tpu.models.roberta``).

Post-LayerNorm BERT layers with learned absolute positions: word + position
+ token-type-0 embeddings, the embedding LayerNorm, then per layer q/k/v
projections with biases, bidirectional attention through
:func:`rankpo_tpu_torch.ops.attention.multi_head_attention` (``causal=False,
skip_pad_q=True``: pad keys are masked everywhere, so query tiles past a
row's valid length may be skipped), the attention output projection,
residual and LayerNorm, the GELU MLP, residual and LayerNorm. LayerNorm
takes fp32 statistics and applies its weight and bias in the compute dtype
(JAX ``layer_norm``). ``gelu`` is the exact erf form; ``gelu_new`` and
``gelu_pytorch_tanh`` the tanh form.

Positions: ``xlm-roberta`` counts the non-pad tokens from
``pad_token_id + 1`` and gives pads ``pad_token_id`` (HF
``create_position_ids_from_input_ids``); ``bert`` is a plain arange. With
``segment_ids`` (sequence packing, in place of the attention mask; JAX
``roberta.py:199-215``) both rules restart at every segment: ``bert`` takes
the within-segment position, ``xlm-roberta`` ``pad_token_id + 1`` plus it
for segment tokens and ``pad_token_id`` for the pad tail; attention is
block-diagonal.

Dropout, as HF and the JAX body place it: hidden dropout at the embedding
output and after the attention output projection and the MLP output of each
layer; attention-probs dropout inside attention, which then runs the plain
path (``ops/attention.py``). It is live only when the forward is given a
``generator``; each layer draws its masks from a generator of its own,
seeded from the caller's (:func:`layer_seeds`), so gradient checkpointing
recomputes the same masks, under every ``checkpoint_policy`` ("full",
"dots", "attn"; ``models/base.py``).

Parameters use HuggingFace's names and ``[out, in]`` layout, so
``RobertaEncoder.state_dict()`` keys are the tensor names of an HF
``XLMRobertaModel`` / ``BertModel`` safetensors file without the pooler.
The builds (``from_state_dict``, ``for_training``) are
``models/base.py``'s.

Tensor parallelism (``models/base.py``): a layer of model rank i holds the
query/key/value heads ``[i * h / mp, (i + 1) * h / mp)`` with their biases
and the matching ``intermediate`` columns; the attention output and the
layer output sum their partial products over the model group
(``row_linear``) before their bias, dropout and LayerNorm, which see the
replicated activations. The attention-probs dropout draws the mask of all
heads from the layer's generator and keeps this rank's heads, so the
masks are one process's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from rankpo_tpu_torch.models.base import (
    EncoderModule,
    TensorParallel,
    column_input,
    init_state,
    linear,
    remat,
    row_linear,
)
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.packing import packed_positions
from rankpo_tpu_torch.ops.attention import dropout, multi_head_attention

MODEL_TYPES = ("xlm-roberta", "bert")
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def check_supported(config: EncoderConfig) -> None:
    if config.model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {config.model_type!r} is not a Roberta-family body "
            f"(one of {MODEL_TYPES})"
        )
    if config.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(
            f"hidden_act {config.hidden_act!r} is not ported; one of {sorted(ACTIVATIONS)}"
        )


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 mean and variance; weight and bias applied in x's dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return xf.to(x.dtype) * weight + bias


class LayerNorm(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


def position_ids(config: EncoderConfig, input_ids: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] absolute positions: the Roberta pad-offset rule for
    ``xlm-roberta``, arange for ``bert``; per segment when packed."""
    b, s = input_ids.shape
    pad = config.pad_token_id if config.pad_token_id is not None else 1
    if segment_ids is not None:
        within = packed_positions(segment_ids)
        if config.model_type == "bert":
            return within
        return torch.where(segment_ids != 0, within + pad + 1, pad)
    if config.model_type == "bert":
        return torch.arange(s, device=input_ids.device).expand(b, s)
    mask = (input_ids != pad).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad


def layer_seeds(generator: Optional[torch.Generator], n: int):
    """``n`` seeds drawn from ``generator`` (on its own device), or Nones
    without one. Each dropout site group seeds a generator of its own from
    one of them, so a layer recomputed by gradient checkpointing draws the
    same masks again (an explicit generator is not restored by
    ``torch.utils.checkpoint``), as each JAX layer gets its own split key."""
    if generator is None:
        return [None] * n
    return torch.randint(0, 2**62, (n,), generator=generator,
                         device=generator.device).tolist()


def site_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None for None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Modules (HF names, so state_dict keys are the safetensors tensor names)
# ---------------------------------------------------------------------------

class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, config.layer_norm_eps)


class _Dense(nn.Module):
    """A projection and, for the output sublayers, the post-LayerNorm."""

    def __init__(self, n_in: int, n_out: int, eps: Optional[float] = None):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)
        if eps is not None:
            self.LayerNorm = LayerNorm(n_out, eps)


class _SelfAttention(nn.Module):
    def __init__(self, h: int, local: int):
        super().__init__()
        self.query = nn.Linear(h, local)
        self.key = nn.Linear(h, local)
        self.value = nn.Linear(h, local)


class _Attention(nn.Module):
    def __init__(self, config: EncoderConfig, mp: int = 1):
        super().__init__()
        h = config.hidden_size
        self.self = _SelfAttention(h, h // mp)  # HF's key: "attention.self.query.weight"
        self.output = _Dense(h // mp, h, config.layer_norm_eps)


class RobertaLayer(nn.Module):
    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        mp = tp.size if tp else 1
        h, f = config.hidden_size, config.intermediate_size // mp
        self.attention = _Attention(config, mp)
        self.intermediate = _Dense(h, f)
        self.output = _Dense(f, h, config.layer_norm_eps)
        self.bwd_impl = "auto"  # the flash backward kernels (EncoderModule.for_training)

    def qkv(self, x):
        """The q/k/v projections (JAX ``_layer_qkv``)."""
        b, s, h = x.shape
        d = h // self.config.num_attention_heads
        sa = self.attention.self
        x = column_input(x, self.tp)
        # this rank's heads (all of them without tensor parallelism)
        return (linear(x, sa.query).view(b, s, -1, d),
                linear(x, sa.key).view(b, s, -1, d),
                linear(x, sa.value).view(b, s, -1, d))

    def attend(self, q, k, v, key_mask, attn_impl: str, gen, segment_ids=None):
        cfg = self.config
        return multi_head_attention(
            q, k, v, mask=key_mask, causal=False, impl=attn_impl, skip_pad_q=True,
            dropout_rate=cfg.attention_dropout if gen is not None else 0.0,
            generator=gen, segment_ids=segment_ids, bwd_impl=self.bwd_impl,
            head_shard=None if self.tp is None else (self.tp.index, self.tp.size),
        )

    def post(self, x, attn, gen):
        """The attention output projection, residual and LayerNorm, the MLP,
        residual and LayerNorm, each output with its hidden dropout (JAX
        ``_layer_post``)."""
        cfg = self.config
        b, s, h = x.shape
        out = self.attention.output
        a = dropout(row_linear(attn.reshape(b, s, -1), out.dense, self.tp), cfg.hidden_dropout,
                    gen)
        x = out.LayerNorm(x + a)
        inter = ACTIVATIONS[cfg.hidden_act](linear(column_input(x, self.tp),
                                                   self.intermediate.dense))
        y = dropout(row_linear(inter, self.output.dense, self.tp), cfg.hidden_dropout, gen)
        return self.output.LayerNorm(x + y)

    def _post_from_state(self, x, attn, gen_state):
        """:meth:`post` with a generator restored from ``gen_state`` (None
        without dropout), so a recompute draws the same masks."""
        gen = None
        if gen_state is not None:
            gen = torch.Generator(device=x.device)
            gen.set_state(gen_state)
        return self.post(x, attn, gen)

    def forward(self, x, key_mask, attn_impl: str, seed: Optional[int], segment_ids=None):
        gen = site_generator(seed, x.device)  # attention probs, then the two hidden sites
        q, k, v = self.qkv(x)
        return self.post(x, self.attend(q, k, v, key_mask, attn_impl, gen, segment_ids), gen)

    def remat_forward(self, policy: str, x, key_mask, attn_impl: str, seed: Optional[int],
                      segment_ids=None):
        """The layer recomputed in the backward pass under ``policy``
        (``models/base.py``). Under "attn" the two regions around the
        attention call are checkpointed (JAX ``roberta.py:266-285``); the
        post region restarts the layer's generator from its state after the
        attention's draws, so the recompute, and the layer without
        checkpointing, draw the same masks."""
        if policy != "attn":
            return remat(self, policy, x, key_mask, attn_impl, seed, segment_ids)
        gen = site_generator(seed, x.device)
        q, k, v = remat(self.qkv, "full", x)
        attn = self.attend(q, k, v, key_mask, attn_impl, gen, segment_ids)
        state = None if gen is None else gen.get_state()
        return remat(self._post_from_state, "full", x, attn, state)


class _Layers(nn.Module):
    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(config, tp)
                                   for _ in range(config.num_hidden_layers))


class RobertaEncoder(EncoderModule):
    """Token ids [B, S] + right-padded mask [B, S] (or packed
    ``segment_ids``) -> last hidden [B, S, H] in ``compute_dtype`` (by
    default the parameters' dtype)."""

    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        check_supported(config)
        super().__init__(config, tp)
        self.embeddings = Embeddings(config)
        self.encoder = _Layers(config, tp)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        *,
        attn_impl: str = "auto",
        generator: Optional[torch.Generator] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """With a ``generator`` (any device) every dropout site is live at
        the config's rates; without one the forward is deterministic. With
        ``segment_ids`` the attention mask is not read."""
        cfg = self.config
        emb = self.embeddings
        dtype = self.compute_dtype or emb.word_embeddings.weight.dtype
        # gathered from the master tables and summed there, then cast
        # (JAX roberta.py:221-225)
        x = (F.embedding(input_ids, emb.word_embeddings.weight)
             + F.embedding(position_ids(cfg, input_ids, segment_ids),
                           emb.position_embeddings.weight)
             + emb.token_type_embeddings.weight[0]).to(dtype)
        x = emb.LayerNorm(x)
        seeds = layer_seeds(generator, cfg.num_hidden_layers + 1)
        x = dropout(x, cfg.hidden_dropout, site_generator(seeds[0], x.device))
        key_mask = None if segment_ids is not None else attention_mask.to(torch.bool)
        remat_on = self.gradient_checkpointing and torch.is_grad_enabled()
        for layer, seed in zip(self.encoder.layer, seeds[1:]):
            if remat_on:
                x = layer.remat_forward(self.checkpoint_policy, x, key_mask, attn_impl, seed,
                                        segment_ids)
            else:
                x = layer(x, key_mask, attn_impl, seed, segment_ids)
        return x


def state_names(config: EncoderConfig) -> List[str]:
    """HF tensor names of a Roberta/BERT encoder (no pooler), in state_dict
    order."""
    names = [f"embeddings.{n}.weight" for n in
             ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    names += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(config.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for sub in ("attention.self.query", "attention.self.key", "attention.self.value",
                    "attention.output.dense", "attention.output.LayerNorm",
                    "intermediate.dense", "output.dense", "output.LayerNorm"):
            names += [p + sub + ".weight", p + sub + ".bias"]
    return names


def init_params(
    config: EncoderConfig,
    generator: torch.Generator,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Random init (normal 0.02, biases at zero, LayerNorms at one and zero)
    as an HF-named state dict, drawn in fp32 from ``generator`` and cast."""
    check_supported(config)
    device = generator.device if device is None else torch.device(device)
    with torch.device("meta"):
        shapes = {n: t.shape for n, t in RobertaEncoder(config).state_dict().items()}
    return init_state(state_names(config), shapes, generator, device, dtype,
                      ones=lambda n: n.endswith("LayerNorm.weight"),
                      zeros=lambda n: n.endswith(".bias"))
