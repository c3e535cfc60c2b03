"""Encoder configuration (a copy of ``rankpo_tpu.models.config``).

Kept as a copy because importing ``rankpo_tpu.models.config`` runs
``rankpo_tpu/models/__init__.py``, which loads jax. The two files must stay
field-for-field identical: ``config.json`` written by either package is read
by the other (tests/test_torch_hf_io.py).

One config dataclass covers both backbone families the reference trains
(reference: src/modeling.py:175-178 loads any ``AutoModel``; the published runs
use meta-llama/Llama-3.2-1B and BGE/XLM-Roberta-family encoders). The pooling
rule is part of the config because the reference dispatches on
``config.architectures[0]`` (src/modeling.py:224-232): Llama-family -> last
non-pad token, everything else -> CLS/first token.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class EncoderConfig:
    # "llama" | "qwen2" | "mistral" | "gemma" (decoder family, one body) |
    # "xlm-roberta" | "bert" (encoder family, covers BGE)
    model_type: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8  # GQA; == num_attention_heads for MHA
    head_dim: Optional[int] = None
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5  # llama
    layer_norm_eps: float = 1e-5  # roberta
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None  # llama3-style {"rope_type": "llama3", ...}
    type_vocab_size: int = 1  # roberta token-type vocabulary
    pad_token_id: Optional[int] = None
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"  # llama: silu; roberta: gelu
    hidden_dropout: float = 0.0  # roberta hidden_dropout_prob; llama has none
    attention_dropout: float = 0.0
    pooling: str = "last_token"  # "last_token" | "cls" | "mean"
    normalize: bool = True
    architectures: tuple = ()
    # decoder-family attention biases: Qwen2 uses q/k/v bias (never o);
    # Llama's `attention_bias` flag turns on all four projections' biases
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    sliding_window: Optional[int] = None  # mistral/qwen2 SWA (ops/attention.py window=)

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if not self.pooling:
            self.pooling = default_pooling(self.architectures, self.model_type)

    @property
    def is_llama(self) -> bool:
        """True for the decoder family sharing the llama body
        (llama/qwen2/mistral/gemma)."""
        return self.model_type in ("llama", "qwen2", "mistral", "gemma")

    @property
    def is_gemma(self) -> bool:
        """Gemma variations on the llama body: (1+w) RMSNorm weights and
        sqrt(hidden)-scaled embeddings (matches HF GemmaModel)."""
        return self.model_type == "gemma"

    @classmethod
    def from_hf_dict(cls, d: dict) -> "EncoderConfig":
        """Build from a HuggingFace ``config.json`` dict (keeps checkpoint interop)."""
        model_type = d.get("model_type", "llama")
        archs = tuple(d.get("architectures") or ())
        if model_type in ("llama", "qwen2", "mistral", "gemma"):
            # Qwen2 always has q/k/v biases (HF Qwen2Attention hardcodes them);
            # Llama's optional attention_bias covers all four projections
            attention_bias = bool(d.get("attention_bias", False))
            qkv_bias = attention_bias or model_type == "qwen2"
            o_bias = attention_bias and model_type != "qwen2"
            sliding = d.get("sliding_window")
            if model_type == "qwen2":
                # qwen2 configs carry the field but usually disable it — and
                # SWA only applies to layers >= max_window_layers, so when
                # every layer is below that the model is full-attention
                mwl = d.get("max_window_layers", 0)
                if not d.get("use_sliding_window", False) or (
                    mwl >= d["num_hidden_layers"]
                ):
                    sliding = None
                elif 0 < mwl < d["num_hidden_layers"]:
                    # HF Qwen2 runs layers < max_window_layers with FULL
                    # attention and only the rest windowed; this body applies
                    # one uniform window to every scanned layer, which would
                    # silently produce wrong embeddings for hybrid checkpoints
                    raise ValueError(
                        "unsupported hybrid Qwen2 SWA config: "
                        f"use_sliding_window=True with 0 < max_window_layers="
                        f"{mwl} < num_hidden_layers={d['num_hidden_layers']} "
                        "mixes full-attention and windowed layers; this "
                        "framework applies a uniform window to all layers "
                        "(max_window_layers must be 0 or >= num_hidden_layers)"
                    )
            cfg = cls(
                model_type=model_type,
                vocab_size=d["vocab_size"],
                hidden_size=d["hidden_size"],
                intermediate_size=d["intermediate_size"],
                num_hidden_layers=d["num_hidden_layers"],
                num_attention_heads=d["num_attention_heads"],
                num_key_value_heads=d.get(
                    "num_key_value_heads", d["num_attention_heads"]
                ),
                head_dim=d.get("head_dim"),
                max_position_embeddings=d.get("max_position_embeddings", 131072),
                rms_norm_eps=d.get("rms_norm_eps", 1e-5),
                rope_theta=d.get("rope_theta", 10000.0),
                rope_scaling=d.get("rope_scaling"),
                pad_token_id=d.get("pad_token_id"),
                tie_word_embeddings=d.get("tie_word_embeddings", True),
                # newer gemma configs use "hidden_activation"
                hidden_act=d.get("hidden_activation") or d.get("hidden_act", "silu"),
                pooling="last_token",
                architectures=archs,
                attention_qkv_bias=qkv_bias,
                attention_o_bias=o_bias,
                sliding_window=sliding,
            )
        elif model_type in ("xlm-roberta", "roberta", "bert"):
            cfg = cls(
                # bert (BGE family) and roberta/xlm-roberta (BGE-M3 family)
                # share the encoder body but differ in the position-id rule
                model_type="bert" if model_type == "bert" else "xlm-roberta",
                vocab_size=d["vocab_size"],
                hidden_size=d["hidden_size"],
                intermediate_size=d["intermediate_size"],
                num_hidden_layers=d["num_hidden_layers"],
                num_attention_heads=d["num_attention_heads"],
                num_key_value_heads=d["num_attention_heads"],
                max_position_embeddings=d.get("max_position_embeddings", 512),
                layer_norm_eps=d.get("layer_norm_eps", 1e-12),
                type_vocab_size=d.get("type_vocab_size", 1),
                pad_token_id=d.get(
                    "pad_token_id", 0 if model_type == "bert" else 1
                ),
                tie_word_embeddings=False,
                hidden_act=d.get("hidden_act", "gelu"),
                hidden_dropout=d.get("hidden_dropout_prob", 0.1),
                attention_dropout=d.get("attention_probs_dropout_prob", 0.1),
                pooling="cls",
                architectures=archs,
            )
        else:
            raise ValueError(f"Unsupported model_type: {model_type}")
        return cfg

    @classmethod
    def from_pretrained(cls, path: str) -> "EncoderConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        if self.is_llama:
            default_arch = {
                "llama": "LlamaModel",
                "qwen2": "Qwen2Model",
                "mistral": "MistralModel",
                "gemma": "GemmaModel",
            }[self.model_type]
            d = {
                "model_type": self.model_type,
                "architectures": list(self.architectures) or [default_arch],
                "vocab_size": self.vocab_size,
                "hidden_size": self.hidden_size,
                "intermediate_size": self.intermediate_size,
                "num_hidden_layers": self.num_hidden_layers,
                "num_attention_heads": self.num_attention_heads,
                "num_key_value_heads": self.num_key_value_heads,
                "head_dim": self.head_dim,
                "max_position_embeddings": self.max_position_embeddings,
                "rms_norm_eps": self.rms_norm_eps,
                "rope_theta": self.rope_theta,
                "rope_scaling": self.rope_scaling,
                "pad_token_id": self.pad_token_id,
                "tie_word_embeddings": self.tie_word_embeddings,
                "hidden_act": self.hidden_act,
                "torch_dtype": "float32",
            }
            if self.model_type == "llama" and self.attention_o_bias:
                d["attention_bias"] = True
            if self.sliding_window is not None:
                d["sliding_window"] = self.sliding_window
                if self.model_type == "qwen2":
                    d["use_sliding_window"] = True
            return d
        default_arch = "BertModel" if self.model_type == "bert" else "XLMRobertaModel"
        return {
            "model_type": self.model_type,
            "architectures": list(self.architectures) or [default_arch],
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_hidden_layers,
            "num_attention_heads": self.num_attention_heads,
            "max_position_embeddings": self.max_position_embeddings,
            "layer_norm_eps": self.layer_norm_eps,
            "type_vocab_size": self.type_vocab_size,
            "pad_token_id": self.pad_token_id,
            "hidden_act": self.hidden_act,
            "torch_dtype": "float32",
        }

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_hf_dict(), f, indent=2)


def default_pooling(architectures, model_type: str) -> str:
    """Reference rule (src/modeling.py:224-232): 'Llama' in architectures[0] →
    last-non-pad-token pooling; otherwise CLS/first token. Extended to the
    other causal-decoder families (qwen2/mistral), where CLS pooling would
    read position 0 of a causal model — always wrong."""
    if architectures and any(
        fam in architectures[0] for fam in ("Llama", "Qwen2", "Mistral", "Gemma")
    ):
        return "last_token"
    if model_type in ("llama", "qwen2", "mistral", "gemma"):
        return "last_token"
    return "cls"


def tiny_llama_config(vocab_size: int = 512) -> EncoderConfig:
    """Small config for tests and smoke runs."""
    return EncoderConfig(
        model_type="llama",
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=2048,
        rope_theta=10000.0,
        rope_scaling=None,
        pad_token_id=0,
        architectures=("LlamaModel",),
        pooling="last_token",
    )
