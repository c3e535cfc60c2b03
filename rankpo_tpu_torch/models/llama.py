"""Llama-3.x decoder used as a text encoder (PyTorch port of
``rankpo_tpu.models.llama``).

The layer math follows the JAX body step for step (``_layer_qkv`` /
``_layer_post``): RMSNorm with fp32 statistics and the weight applied in the
compute dtype, HF rotate-half RoPE with the llama3 frequency scaling, GQA
attention through :func:`rankpo_tpu_torch.ops.attention.multi_head_attention`
(the hand-written flash kernel on a CUDA tensor), a gated MLP whose gate
takes the config's ``hidden_act`` (JAX ``_ACTS``: SwiGLU for ``silu``,
GeGLU for the GELUs).

Parameters use HuggingFace's names and its ``[out, in]`` Linear layout, so
``LlamaEncoder.state_dict()`` keys are exactly the tensor names of an HF
``LlamaModel`` safetensors file (``models/hf_io.py``). The JAX package stacks
layers on a leading axis and stores kernels ``[in, out]``;
``hf_io.params_from_jax`` converts.

Two builds: :meth:`LlamaEncoder.from_state_dict` (serving: frozen,
parameters in the compute dtype) and :meth:`LlamaEncoder.for_training`
(master parameters in the param dtype, trainable). The forward casts every
weight to ``compute_dtype`` where it is used and gathers the embedding from
the master table before casting, as ``rankpo_tpu.models.llama.apply`` does
(``llama.py:264,280``), so autograd returns gradients in the master dtype.
For the serving build the casts are no-ops. ``gradient_checkpointing``
recomputes each layer in the backward pass (``torch.utils.checkpoint``,
non-reentrant) under the model's ``checkpoint_policy``, the JAX
``remat_policy``: "full", "dots" (the projections' outputs kept) or "attn"
(the layer cut into ``qkv`` and ``post``, each recomputed, with the
attention call between them kept: K1's saved tensors serve the backward).

The llama body, Qwen2's (q/k/v biases; Llama's ``attention_bias`` adds the
o bias too) and Mistral's (Llama's tensors, no biases) are ported, with
sliding-window attention wherever the config sets ``sliding_window``
(Mistral, and Qwen2 with ``use_sliding_window`` on every layer): every layer
passes the window to the attention, in the checkpointed recompute too, and
on a CUDA tensor the kernels skip the tiles outside the band. Gemma runs
on the same body (HF ``GemmaModel``, JAX ``config.is_gemma``): RMSNorm
weights stored as offsets from 1 and applied as (1 + w) in fp32 before the
cast, zero-initialised; the GeGLU gate (``gelu_pytorch_tanh``); and the
embeddings scaled by sqrt(hidden) rounded to the compute dtype first. The
scale sits outside the layers, so the checkpointed recompute and the
training build take it as serving does. Its head_dim of 256 (2B and 7B
alike) runs the kernels' D 256 builds on a CUDA tensor. The Roberta family
has its own body (``models/roberta.py``).

``segment_ids`` [B, S] (sequence packing, in place of the attention mask;
JAX ``llama.py:269-275``): several texts per row as contiguous segments,
RoPE positions restart at each segment (``models/packing.py``), attention
is block-diagonal and takes no key mask; every layer passes the segments
to the attention, in the checkpointed recompute too.

Tensor parallelism (``models/base.py``): a layer of model rank i holds
query heads ``[i * hq / mp, (i + 1) * hq / mp)``, the matching kv heads and
MLP columns; the input norm's and the post-attention norm's outputs enter
the column-parallel projections through ``column_input``, and ``o_proj``
and ``down_proj`` sum their partial products over the model group
(``row_linear``).
"""

from __future__ import annotations

import math
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
from rankpo_tpu_torch.models.roberta import ACTIVATIONS as GELUS
from rankpo_tpu_torch.ops.attention import multi_head_attention

MODEL_TYPES = ("llama", "qwen2", "mistral", "gemma")
# the MLP gate's activation, JAX ``_ACTS`` (llama.py:98-104)
ACTIVATIONS = {"silu": F.silu, **GELUS}


def check_supported(config: EncoderConfig) -> None:
    """Raise for configurations the llama body does not take: another
    model_type, or an activation JAX's ``_ACTS`` has no entry for."""
    if config.model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {config.model_type!r} is not a llama-family body "
            f"(one of {MODEL_TYPES})"
        )
    if config.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(
            f"hidden_act {config.hidden_act!r} is not ported; one of {sorted(ACTIVATIONS)}"
        )


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_inv_freq(config: EncoderConfig, device=None) -> torch.Tensor:
    """Per-dim inverse frequencies [D/2] in fp32, with llama3 scaling."""
    d = config.head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    rs = config.rope_scaling
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        factor = rs["factor"]
        low = rs["low_freq_factor"]
        high = rs["high_freq_factor"]
        orig = rs["original_max_position_embeddings"]
        low_wavelen = orig / low
        high_wavelen = orig / high
        wavelen = 2 * math.pi / inv_freq
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv_freq = torch.where(is_medium, smoothed, scaled)
    return inv_freq


def rope_cos_sin(config: EncoderConfig, positions: torch.Tensor) -> tuple:
    """cos/sin tables [B, S, head_dim] in fp32, HF duplicated-half layout."""
    inv_freq = rope_inv_freq(config, positions.device)
    freqs = positions[..., None].to(torch.float32) * inv_freq  # [B, S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D] (cast to x's dtype, as in JAX)."""
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, *,
             gemma: bool = False) -> torch.Tensor:
    """fp32 statistics. Llama's weight multiplies in the input dtype (HF
    LlamaRMSNorm); Gemma's, stored as an offset from 1, is applied as
    (1 + w) in fp32 before the cast back (HF GemmaRMSNorm), as
    ``rankpo_tpu.models.llama.rms_norm`` does."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if gemma:
        return ((1.0 + weight.to(torch.float32)) * xf).to(x.dtype)
    return weight * xf.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float, gemma: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.eps = eps
        self.gemma = gemma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the weight in the activations' (compute) dtype, as JAX casts it
        return rms_norm(x, self.weight.to(x.dtype), self.eps, gemma=self.gemma)


# ---------------------------------------------------------------------------
# Modules (HF names, so state_dict keys are the safetensors tensor names)
# ---------------------------------------------------------------------------

class LlamaAttention(nn.Module):
    def __init__(self, config: EncoderConfig, mp: int = 1):
        super().__init__()
        h, d = config.hidden_size, config.head_dim
        hq, hkv = config.num_attention_heads // mp, config.num_key_value_heads // mp
        qkv_bias = config.attention_qkv_bias  # Qwen2; Llama attention_bias
        self.q_proj = nn.Linear(h, hq * d, bias=qkv_bias)
        self.k_proj = nn.Linear(h, hkv * d, bias=qkv_bias)
        self.v_proj = nn.Linear(h, hkv * d, bias=qkv_bias)
        self.o_proj = nn.Linear(hq * d, h, bias=config.attention_o_bias)


class LlamaMLP(nn.Module):
    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size // (tp.size if tp else 1)
        self.gate_proj = nn.Linear(h, f, bias=False)
        self.up_proj = nn.Linear(h, f, bias=False)
        self.down_proj = nn.Linear(f, h, bias=False)
        self.act = ACTIVATIONS[config.hidden_act]
        self.tp = tp

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = column_input(y, self.tp)
        gate = self.act(linear(y, self.gate_proj))
        return row_linear(gate * linear(y, self.up_proj), self.down_proj, self.tp)


class LlamaLayer(nn.Module):
    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        gemma = config.is_gemma
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, gemma)
        self.self_attn = LlamaAttention(config, tp.size if tp else 1)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, gemma
        )
        self.mlp = LlamaMLP(config, tp)
        self.bwd_impl = "auto"  # the flash backward kernels (EncoderModule.for_training)

    def qkv(self, x, cos, sin):
        """The input norm, the q/k/v projections and RoPE (JAX ``_layer_qkv``)."""
        cfg = self.config
        b, s, _ = x.shape
        d = cfg.head_dim
        attn = self.self_attn
        y = column_input(self.input_layernorm(x), self.tp)
        # this rank's heads (all of them without tensor parallelism)
        q = linear(y, attn.q_proj).view(b, s, -1, d)
        k = linear(y, attn.k_proj).view(b, s, -1, d)
        v = linear(y, attn.v_proj).view(b, s, -1, d)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def attend(self, q, k, v, key_mask, attn_impl: str, segment_ids=None):
        # pad keys are masked everywhere, so pad query tiles may be skipped
        return multi_head_attention(
            q, k, v, mask=key_mask, causal=True, impl=attn_impl,
            skip_pad_q=True, window=self.config.sliding_window, segment_ids=segment_ids,
            bwd_impl=self.bwd_impl,
        )

    def post(self, x, o):
        """The output projection, the residual and the MLP (JAX ``_layer_post``)."""
        b, s, _ = x.shape
        x = x + row_linear(o.reshape(b, s, -1), self.self_attn.o_proj, self.tp)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, cos, sin, key_mask, attn_impl: str, segment_ids=None):
        q, k, v = self.qkv(x, cos, sin)
        return self.post(x, self.attend(q, k, v, key_mask, attn_impl, segment_ids))

    def remat_forward(self, policy: str, x, cos, sin, key_mask, attn_impl: str,
                      segment_ids=None):
        """The layer recomputed in the backward pass under ``policy``
        (``models/base.py``). "attn" checkpoints the two regions around the
        attention call (JAX ``llama.py:294-312``); the window and the
        segments reach the attention either way."""
        if policy != "attn":
            return remat(self, policy, x, cos, sin, key_mask, attn_impl, segment_ids)
        q, k, v = remat(self.qkv, "full", x, cos, sin)
        o = self.attend(q, k, v, key_mask, attn_impl, segment_ids)
        return remat(self.post, "full", x, o)


class LlamaEncoder(EncoderModule):
    """Token ids [B, S] + right-padded mask [B, S] (or packed
    ``segment_ids``) -> last hidden [B, S, H] in ``compute_dtype`` (by
    default the parameters' dtype)."""

    def __init__(self, config: EncoderConfig, tp: Optional[TensorParallel] = None):
        check_supported(config)
        super().__init__(config, tp)
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            LlamaLayer(config, tp) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, config.is_gemma)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        *,
        attn_impl: str = "auto",
        generator: Optional[torch.Generator] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``generator`` is taken for the callers' sake and unused: the
        llama body has no dropout. With ``segment_ids`` the attention mask
        is not read (see the module docstring)."""
        del generator
        b, s = input_ids.shape
        weight = self.embed_tokens.weight
        # gathered from the master table, then cast (JAX llama.py:264)
        x = F.embedding(input_ids, weight).to(self.compute_dtype or weight.dtype)
        if self.config.is_gemma:
            # sqrt(hidden), rounded to the compute dtype first (HF
            # GemmaModel, JAX llama.py:265-268)
            x = x * torch.tensor(self.config.hidden_size**0.5, dtype=x.dtype)
        if segment_ids is not None:
            positions = packed_positions(segment_ids)
            key_mask = None
        else:
            # arange positions regardless of padding (HF default); with right
            # padding and causal attention, pad positions never reach real
            # tokens
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
            key_mask = attention_mask.to(torch.bool)
        cos, sin = rope_cos_sin(self.config, positions)
        remat_on = self.gradient_checkpointing and torch.is_grad_enabled()
        for layer in self.layers:
            if remat_on:
                x = layer.remat_forward(self.checkpoint_policy, x, cos, sin, key_mask,
                                        attn_impl, segment_ids)
            else:
                x = layer(x, cos, sin, key_mask, attn_impl, segment_ids)
        return self.norm(x)


def state_names(config: EncoderConfig) -> List[str]:
    """HF tensor names of a llama encoder, in state_dict order."""
    names = ["embed_tokens.weight"]
    qkv = ["weight", "bias"] if config.attention_qkv_bias else ["weight"]
    o = ["weight", "bias"] if config.attention_o_bias else ["weight"]
    for i in range(config.num_hidden_layers):
        p = f"layers.{i}."
        names += [p + "input_layernorm.weight"]
        names += [p + f"self_attn.{proj}.{t}" for proj in ("q_proj", "k_proj", "v_proj")
                  for t in qkv]
        names += [p + f"self_attn.o_proj.{t}" for t in o]
        names += [
            p + "post_attention_layernorm.weight",
            p + "mlp.gate_proj.weight",
            p + "mlp.up_proj.weight",
            p + "mlp.down_proj.weight",
        ]
    return names + ["norm.weight"]


def init_params(
    config: EncoderConfig,
    generator: torch.Generator,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Random init (normal 0.02 like HF, norms at one, or at zero for Gemma's
    (1 + w) offsets, biases at zero) as an HF-named state dict. Each tensor
    is drawn in fp32 from ``generator`` (whose device it is made on) and
    then cast, so the peak extra memory is one fp32 tensor."""
    check_supported(config)
    device = generator.device if device is None else torch.device(device)
    with torch.device("meta"):
        shapes = {n: t.shape for n, t in LlamaEncoder(config).state_dict().items()}
    def norm(n):
        return n.endswith("norm.weight")

    return init_state(state_names(config), shapes, generator, device, dtype,
                      ones=lambda n: norm(n) and not config.is_gemma,
                      zeros=lambda n: n.endswith(".bias") or (norm(n) and config.is_gemma))
