"""Llama-3.x decoder used as a text encoder (PyTorch port of
``rankpo_tpu.models.llama``).

The layer math follows the JAX body step for step (``_layer_qkv`` /
``_layer_post``): RMSNorm with fp32 statistics and the weight applied in the
compute dtype, HF rotate-half RoPE with the llama3 frequency scaling, GQA
attention through :func:`rankpo_tpu_torch.ops.attention.multi_head_attention`
(the hand-written flash kernel on a CUDA tensor), SwiGLU MLP.

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
non-reentrant): the JAX ``remat_policy="full"``.

Only the plain llama body is ported. Qwen2 / Mistral / Gemma (biases, sliding
windows, (1+w) norms) and the Roberta family raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.ops.attention import multi_head_attention


def check_supported(config: EncoderConfig) -> None:
    """Raise for configurations whose body is not ported yet (ROADMAP.md)."""
    if config.model_type != "llama":
        raise NotImplementedError(
            f"model_type {config.model_type!r} is not ported to rankpo_tpu_torch "
            "yet (ROADMAP.md Queue 1: Qwen2/Mistral/Gemma/Roberta bodies)"
        )
    if config.attention_qkv_bias or config.attention_o_bias:
        raise NotImplementedError("llama attention_bias is not ported yet")
    if config.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (flash kernel `window`)"
        )
    if config.hidden_act != "silu":
        raise NotImplementedError(f"hidden_act {config.hidden_act!r} is not ported")


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

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the weight multiplies in the input dtype (HF
    LlamaRMSNorm, ``rankpo_tpu.models.llama.rms_norm``)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return weight * xf.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the weight in the activations' (compute) dtype, as JAX casts it
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied with its weight cast to the activations' dtype."""
    return F.linear(x, layer.weight.to(x.dtype))


# ---------------------------------------------------------------------------
# Modules (HF names, so state_dict keys are the safetensors tensor names)
# ---------------------------------------------------------------------------

class LlamaAttention(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h, d = config.hidden_size, config.head_dim
        hq, hkv = config.num_attention_heads, config.num_key_value_heads
        self.q_proj = nn.Linear(h, hq * d, bias=False)
        self.k_proj = nn.Linear(h, hkv * d, bias=False)
        self.v_proj = nn.Linear(h, hkv * d, bias=False)
        self.o_proj = nn.Linear(hq * d, h, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, f, bias=False)
        self.up_proj = nn.Linear(h, f, bias=False)
        self.down_proj = nn.Linear(f, h, bias=False)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        gate = F.silu(_linear(y, self.gate_proj))
        return _linear(gate * _linear(y, self.up_proj), self.down_proj)


class LlamaLayer(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps
        )
        self.mlp = LlamaMLP(config)

    def forward(self, x, cos, sin, key_mask, attn_impl: str):
        cfg = self.config
        b, s, _ = x.shape
        d = cfg.head_dim
        attn = self.self_attn
        y = self.input_layernorm(x)
        q = _linear(y, attn.q_proj).view(b, s, cfg.num_attention_heads, d)
        k = _linear(y, attn.k_proj).view(b, s, cfg.num_key_value_heads, d)
        v = _linear(y, attn.v_proj).view(b, s, cfg.num_key_value_heads, d)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # pad keys are masked everywhere, so pad query tiles may be skipped
        o = multi_head_attention(
            q, k, v, mask=key_mask, causal=True, impl=attn_impl,
            skip_pad_q=True,
        )
        x = x + _linear(o.reshape(b, s, -1), attn.o_proj)
        return x + self.mlp(self.post_attention_layernorm(x))


CHECKPOINT_POLICIES = ("full",)


class LlamaEncoder(nn.Module):
    """Token ids [B, S] + right-padded mask [B, S] -> last hidden [B, S, H]
    in ``compute_dtype`` (by default the parameters' dtype)."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        check_supported(config)
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            LlamaLayer(config) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.compute_dtype: Optional[torch.dtype] = None
        self.gradient_checkpointing = False

    @classmethod
    def for_training(
        cls,
        config: EncoderConfig,
        state: Dict[str, torch.Tensor],
        *,
        device="cpu",
        param_dtype: torch.dtype = torch.float32,
        compute_dtype: torch.dtype = torch.bfloat16,
        gradient_checkpointing: bool = False,
        checkpoint_policy: str = "full",
    ) -> "LlamaEncoder":
        """Trainable build: master parameters in ``param_dtype`` on
        ``device``, forward in ``compute_dtype``. ``checkpoint_policy`` is
        the JAX ``remat_policy``; only "full" is ported."""
        if checkpoint_policy not in CHECKPOINT_POLICIES:
            raise NotImplementedError(
                f"gradient_checkpointing_policy {checkpoint_policy!r} is not "
                "ported yet (ROADMAP.md Queue 1 item 2: remat 'dots'/'attn'); "
                "use 'full'"
            )
        with torch.device("meta"):
            model = cls(config)
        # a copy even where device and dtype match: training updates the
        # parameters in place and must not write into the caller's tensors
        state = {n: t.to(device=device, dtype=param_dtype, copy=True)
                 for n, t in state.items()}
        model.load_state_dict(state, strict=True, assign=True)
        model.compute_dtype = compute_dtype
        model.gradient_checkpointing = gradient_checkpointing
        return model.requires_grad_(True).train()

    @classmethod
    def from_state_dict(
        cls,
        config: EncoderConfig,
        state: Dict[str, torch.Tensor],
        *,
        device="cpu",
        dtype: torch.dtype = torch.float32,
    ) -> "LlamaEncoder":
        """Build on the meta device (no throwaway random init) and adopt
        ``state`` converted to ``dtype`` on ``device``. Every parameter must
        be present; the result is frozen (serving has no backward yet)."""
        with torch.device("meta"):
            model = cls(config)
        state = {n: t.to(device=device, dtype=dtype) for n, t in state.items()}
        model.load_state_dict(state, strict=True, assign=True)
        return model.requires_grad_(False).eval()

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        *,
        attn_impl: str = "auto",
    ) -> torch.Tensor:
        b, s = input_ids.shape
        weight = self.embed_tokens.weight
        # gathered from the master table, then cast (JAX llama.py:264)
        x = F.embedding(input_ids, weight).to(self.compute_dtype or weight.dtype)
        # arange positions regardless of padding (HF default); with right
        # padding and causal attention, pad positions never reach real tokens
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
        cos, sin = rope_cos_sin(self.config, positions)
        key_mask = attention_mask.to(torch.bool)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, cos, sin, key_mask, attn_impl,
                               use_reentrant=False)
            else:
                x = layer(x, cos, sin, key_mask, attn_impl)
        return self.norm(x)


def state_names(config: EncoderConfig) -> List[str]:
    """HF tensor names of a llama encoder, in state_dict order."""
    names = ["embed_tokens.weight"]
    for i in range(config.num_hidden_layers):
        p = f"layers.{i}."
        names += [
            p + "input_layernorm.weight",
            p + "self_attn.q_proj.weight",
            p + "self_attn.k_proj.weight",
            p + "self_attn.v_proj.weight",
            p + "self_attn.o_proj.weight",
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
    """Random init (normal 0.02 like HF, norms at one) as an HF-named state
    dict. Each tensor is drawn in fp32 from ``generator`` (whose device it is
    made on) and then cast, so the peak extra memory is one fp32 tensor."""
    check_supported(config)
    device = generator.device if device is None else torch.device(device)
    with torch.device("meta"):
        shapes = {n: t.shape for n, t in LlamaEncoder(config).state_dict().items()}
    state = {}
    for name in state_names(config):
        shape = shapes[name]
        if name.endswith("norm.weight"):
            state[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            state[name] = (w * 0.02).to(dtype)
    return state


def n_params(config: EncoderConfig) -> int:
    """Parameter count of the encoder body (tied LM head not counted)."""
    with torch.device("meta"):
        return sum(p.numel() for p in LlamaEncoder(config).parameters())
