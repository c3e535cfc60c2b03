"""Port model layer (rankpo_tpu_torch.models) against the JAX package.

Same weights (the JAX init, carried over with ``params_from_jax``) and the
same numpy inputs go through both. Tolerances: fp32 pieces within 1e-6; the
whole ``embed`` in fp32 within 1e-4 max abs on the normalised embeddings (two
frameworks sum the projections in different orders over 2 layers); in bf16 a
cosine of at least 0.999 per row, because bf16 rounds at different places in
the two frameworks (XLA fuses elementwise chains, PyTorch rounds after each
op), so only the direction is comparable.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import llama as jllama
from rankpo_tpu.models import pooling as jpool
from rankpo_tpu.models.config import tiny_llama_config, tiny_qwen2_config
from rankpo_tpu_torch.models import llama, pooling
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed
from rankpo_tpu_torch.models.hf_io import params_from_jax

torch.set_num_threads(2)

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}


def _configs(rope_scaling=None):
    jcfg = dataclasses.replace(tiny_llama_config(vocab_size=256),
                               rope_scaling=rope_scaling)
    if rope_scaling:
        # long wavelengths only exist with a large theta
        jcfg = dataclasses.replace(jcfg, rope_theta=500000.0)
    return jcfg, EncoderConfig(**dataclasses.asdict(jcfg))


def _batch(lens, s=24, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (len(lens), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 0).astype(np.int32)
    return ids, mask


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    w = rng.standard_normal(64, dtype=np.float32)
    ref = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
def test_rope_inv_freq_and_apply(scaling):
    jcfg, pcfg = _configs(scaling)
    ref = np.asarray(jllama.rope_inv_freq(jcfg))
    out = llama.rope_inv_freq(pcfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    if scaling:  # the scaling branch changed the low frequencies
        plain = llama.rope_inv_freq(dataclasses.replace(pcfg, rope_scaling=None))
        assert not torch.allclose(torch.from_numpy(out), plain)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, pcfg.head_dim), dtype=np.float32)
    pos = np.broadcast_to(np.arange(7)[None] * 300, (2, 7))
    jcos, jsin = jllama.rope_cos_sin(jcfg, jnp.asarray(pos))
    ref = np.asarray(jllama.apply_rope(jnp.asarray(x), jcos, jsin))
    cos, sin = llama.rope_cos_sin(pcfg, torch.from_numpy(np.array(pos)))
    out = llama.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_last_token_pool_full_and_length_one_rows():
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 6, 8), dtype=np.float32)
    mask = np.array([[1, 1, 1, 1, 1, 1],   # full length: argmin 0 -> wraps to 5
                     [1, 0, 0, 0, 0, 0],   # length 1
                     [1, 1, 1, 0, 0, 0]], np.int32)
    ref = np.asarray(jpool.last_token_pool(jnp.asarray(hidden), jnp.asarray(mask)))
    out = pooling.last_token_pool(torch.from_numpy(hidden), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), hidden[[0, 1, 2], [5, 0, 2]])


@pytest.mark.parametrize("mode", ["cls", "mean"])
def test_pool_modes_match_jax(mode):
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((3, 6, 8), dtype=np.float32)
    mask = np.array([[1, 1, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0]], np.int32)
    ref = np.asarray(jpool.pool(jnp.asarray(hidden), jnp.asarray(mask), mode))
    out = pooling.pool(torch.from_numpy(hidden), torch.from_numpy(mask), mode).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_l2_normalize_keeps_eps_clamp():
    x = np.array([[3.0, 4.0], [0.0, 0.0], [1e-20, 0.0]], np.float32)
    ref = np.asarray(jpool.l2_normalize(jnp.asarray(x)))
    out = pooling.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-7, rtol=0)
    assert np.all(np.isfinite(out)) and np.all(out[1] == 0.0)


def _embed_both(scaling, lens, dtype):
    jcfg, pcfg = _configs(scaling)
    params = jenc.init_params(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    model = llama.LlamaEncoder.from_state_dict(
        pcfg, state, device="cpu",
        dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
    ids, mask = _batch(lens)
    ref = np.asarray(jenc.embed(
        params, jcfg, {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)},
        compute_dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16,
    ))
    with torch.inference_mode():
        out = embed(model, {"input_ids": torch.from_numpy(ids).long(),
                            "attention_mask": torch.from_numpy(mask)}).numpy()
    return out, ref


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
def test_embed_matches_jax_fp32(scaling):
    out, ref = _embed_both(scaling, [24, 13, 1], "float32")
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
def test_embed_matches_jax_bf16_cosine(scaling):
    out, ref = _embed_both(scaling, [24, 13, 1], "bfloat16")
    cos = np.sum(out * ref, axis=1) / (
        np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    assert np.all(cos >= 0.999), cos


def test_init_params_shapes_and_unported_bodies():
    _, pcfg = _configs()
    state = llama.init_params(pcfg, torch.Generator().manual_seed(0))
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    assert list(model.state_dict()) == llama.state_names(pcfg)
    assert torch.all(state["norm.weight"] == 1.0)
    assert abs(float(state["embed_tokens.weight"].std()) - 0.02) < 2e-3
    # Qwen2 (q/k/v biases on the llama body) builds, biases at zero
    qwen = EncoderConfig(**dataclasses.asdict(tiny_qwen2_config()))
    qstate = llama.init_params(qwen, torch.Generator().manual_seed(0))
    qmodel = llama.LlamaEncoder.from_state_dict(qwen, qstate, device="cpu")
    assert list(qmodel.state_dict()) == llama.state_names(qwen)
    assert torch.all(qstate["layers.0.self_attn.q_proj.bias"] == 0.0)
    assert "layers.0.self_attn.o_proj.bias" not in qstate
    # Gemma builds the llama body (the names are Llama's; its norms start at
    # zero, the (1 + w) offsets); Mistral builds
    gemma = dataclasses.replace(pcfg, model_type="gemma", hidden_act="gelu_pytorch_tanh")
    assert list(llama.LlamaEncoder(gemma).state_dict()) == llama.state_names(pcfg)
    gstate = llama.init_params(gemma, torch.Generator().manual_seed(0))
    assert torch.all(gstate["norm.weight"] == 0.0)
    mistral = dataclasses.replace(pcfg, model_type="mistral", sliding_window=4)
    assert list(llama.LlamaEncoder(mistral).state_dict()) == llama.state_names(pcfg)
    # a sliding window runs, as the plain windowed attention, and bites
    windowed = llama.LlamaEncoder.from_state_dict(
        dataclasses.replace(pcfg, sliding_window=4), state, device="cpu")
    ids = torch.arange(3, 15)[None]
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        got = windowed(ids, mask)
        assert torch.equal(got, windowed(ids, mask, attn_impl="plain"))
        assert (got - model(ids, mask)).abs().max() > 1e-4
