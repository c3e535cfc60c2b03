"""Analytic FLOPs for the training log: tokens/s and MFU (port of
``rankpo_tpu.utils.flops``).

Conventions (the usual "model FLOPs" of MFU reporting):

- a multiply-accumulate counts 2 FLOPs;
- backward = 2x forward, so a train step is 3x the forward's model FLOPs;
- the extra forward of gradient checkpointing is NOT counted;
- padded positions count: batches are padded to the static ``max_*_length``
  (``skip_pad_q`` trims some of this work in the attention kernels, which
  makes the reported MFU a floor on the utilisation of real tokens).

:func:`peak_flops_per_chip` gives the dense bf16 tensor-core peak of the
CUDA card from its name (NVIDIA's data sheets), and None for a card it does
not know, or for the CPU, in which case the log carries no ``mfu``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _per_layer_matmul_flops(config) -> float:
    """Per-token forward FLOPs of one layer's weight products (attention
    projections + MLP), without the attention score/value products."""
    h = config.hidden_size
    head_dim = getattr(config, "head_dim", None) or (h // config.num_attention_heads)
    q_dim = config.num_attention_heads * head_dim
    kv_dim = config.num_key_value_heads * head_dim
    attn_proj = 2 * h * (q_dim + 2 * kv_dim) + 2 * q_dim * h
    gated = getattr(config, "hidden_act", "silu") in ("silu", "swish")
    mlp = (6 if gated else 4) * h * config.intermediate_size
    return float(attn_proj + mlp)


def encoder_fwd_flops(config, seq_len: int, *, causal: bool = True) -> float:
    """Forward FLOPs of ONE sequence of ``seq_len`` (padded) tokens: the
    layers' products plus attention's score and value products
    (``4 * q_dim * s_kv`` per token; causal halves the mean context). A
    sliding window is not counted: like the JAX package's formula, this
    counts the whole causal triangle, so a windowed model's MFU counts
    attention work its kernels skip past the window."""
    h = config.hidden_size
    head_dim = getattr(config, "head_dim", None) or (h // config.num_attention_heads)
    q_dim = config.num_attention_heads * head_dim
    s_kv = seq_len / 2.0 if causal else float(seq_len)
    per_token = _per_layer_matmul_flops(config) + 4.0 * q_dim * s_kv
    return config.num_hidden_layers * per_token * seq_len


def contrastive_sample_flops(
    config, *, query_len: int, passage_len: int, group_size: int,
    causal: bool = True,
) -> float:
    """Train-step model FLOPs per SAMPLE (one query + its ``group_size``
    passages, the unit ``samples_per_sec`` counts): 3x forward."""
    fwd = encoder_fwd_flops(config, query_len, causal=causal) + (
        group_size * encoder_fwd_flops(config, passage_len, causal=causal)
    )
    return 3.0 * fwd


def contrastive_sample_tokens(*, query_len: int, passage_len: int, group_size: int) -> int:
    return query_len + group_size * passage_len


def rankpo_sample_flops(
    config, *, query_len: int, passage_len: int,
    reference_free: bool = True, causal: bool = True,
) -> float:
    """RankPO step FLOPs per sample (query + chosen + rejected through the
    policy's forward and backward; a frozen reference model adds one
    forward)."""
    fwd = encoder_fwd_flops(config, query_len, causal=causal) + (
        2 * encoder_fwd_flops(config, passage_len, causal=causal)
    )
    return (3.0 + (0.0 if reference_free else 1.0)) * fwd


def rankpo_sample_tokens(*, query_len: int, passage_len: int) -> int:
    return query_len + 2 * passage_len


# dense bf16 tensor-core peak FLOP/s by CUDA device name (substring match):
# the SXM H100 (80 GB HBM3) and the H200, from NVIDIA's data sheets
_PEAK_BY_NAME = (
    ("H100 80GB HBM3", 989e12),
    ("H100 SXM", 989e12),
    ("H200", 989e12),
)


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the CUDA card ``device`` (default: the
    current one), or None for the CPU or a card not in the table."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in _PEAK_BY_NAME:
        if sub in name:
            return peak
    return None
