"""The port's Qwen2 body (q/k/v biases on the llama body) and Llama's
``attention_bias`` (q/k/v/o biases) against the JAX package and
``transformers``' ``Qwen2Model``.

Same weights (the JAX init with noise on every tensor, biases included,
carried over with ``params_from_jax``) and the same numpy inputs, fp32:
last hidden state and ``embed`` within 1e-5; gradients of a small InfoNCE
loss within 1e-4 relative L2 per tensor; files bit for bit both ways;
``transformers`` within 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models.config import tiny_llama_config, tiny_qwen2_config
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models import hf_io, llama
from rankpo_tpu_torch.models.config import EncoderConfig

torch.set_num_threads(2)

KINDS = ["qwen2", "llama-attention-bias"]


def _jcfg(kind):
    if kind == "qwen2":
        return tiny_qwen2_config(vocab_size=256)
    return dataclasses.replace(tiny_llama_config(vocab_size=256), attention_qkv_bias=True,
                               attention_o_bias=True)


def _setup(kind, seed=0):
    jcfg = _jcfg(kind)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.05, params)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, pcfg, hf_io.params_from_jax(params, pcfg)


def _batch(lens, s=24, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (len(lens), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def _torch(ids, mask):
    return {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask)}


def _jax(ids, mask):
    return {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}


@pytest.mark.parametrize("kind", KINDS)
def test_state_names_carry_the_biases(kind):
    _, _, pcfg, state = _setup(kind)
    names = llama.state_names(pcfg)
    assert list(state) == names
    assert "layers.1.self_attn.v_proj.bias" in names
    assert ("layers.1.self_attn.o_proj.bias" in names) == (kind != "qwen2")
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    assert isinstance(model, llama.LlamaEncoder)
    assert list(model.state_dict()) == names


@pytest.mark.parametrize("kind", KINDS)
def test_forward_hidden_matches_jax_fp32(kind):
    jcfg, params, pcfg, state = _setup(kind)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([24, 13, 1, 7])
    ref = np.asarray(jenc.forward_hidden(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                         compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.forward_hidden(model, *_torch(ids, mask).values()).numpy()
    valid = mask == 1  # pad rows attend causally to real keys only; compare the text
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_matches_jax_fp32(kind):
    jcfg, params, pcfg, state = _setup(kind, seed=1)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([24, 5, 17], seed=1)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
    assert pcfg.pooling == "last_token"
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_grads_match_jax():
    jcfg, params, pcfg, state = _setup("qwen2", seed=2)
    qi, qm = _batch([9, 12, 4], s=12, seed=2)
    pi, pm = _batch([20, 16, 3, 11, 24, 8], s=24, seed=3)

    def jloss_fn(p):
        q = jenc.embed(p, jcfg, _jax(qi, qm), compute_dtype=jnp.float32)
        d = jenc.embed(p, jcfg, _jax(pi, pm), compute_dtype=jnp.float32)
        logits = jax.nn.log_softmax(q @ d.T / 0.05, axis=-1)
        return -jnp.mean(logits[jnp.arange(3), jnp.arange(3) * 2])

    jloss, jgrads = jax.value_and_grad(jloss_fn)(params)
    model = llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)
    q = penc.embed(model, _torch(qi, qm))
    d = penc.embed(model, _torch(pi, pm))
    loss = torch.nn.functional.cross_entropy(q @ d.T / 0.05, torch.arange(3) * 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    # the key bias's gradient is zero up to rounding (it adds one constant to
    # every logit of a row): an absolute floor of 1e-8 of the global norm
    floor = 1e-8 * np.sqrt(sum(np.sum(r.numpy() ** 2) for r in ref.values()))
    for name, p in model.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        err = np.linalg.norm(g - r)
        assert err <= 1e-4 * np.linalg.norm(r) + floor, (name, err, np.linalg.norm(r))


def test_right_padding_invariance():
    _, _, pcfg, state = _setup("qwen2", seed=4)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([6, 6], s=6, seed=4)
    long_ids = np.concatenate([ids, np.zeros((2, 4), np.int32)], axis=1)
    long_mask = np.concatenate([mask, np.zeros((2, 4), np.int32)], axis=1)
    with torch.inference_mode():
        short = penc.embed(model, _torch(ids, mask))
        long = penc.embed(model, _torch(long_ids, long_mask))
    np.testing.assert_allclose(short.numpy(), long.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_files_both_ways(kind, tmp_path):
    jcfg, params, pcfg, state = _setup(kind, seed=5)
    jhf.save_pretrained(str(tmp_path / "jax"), jcfg, params)
    cfg, got = hf_io.load_pretrained(str(tmp_path / "jax"))
    assert cfg == pcfg
    for name, t in got.items():
        assert torch.equal(t, state[name]), name
    hf_io.save_pretrained(str(tmp_path / "port"), pcfg, state)
    jcfg2, jparams = jhf.load_pretrained(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    back = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg)
    for name, t in back.items():
        assert torch.equal(t, state[name]), name


def test_qwen2_parity_with_transformers(tmp_path):
    from transformers import Qwen2Config, Qwen2Model

    hf_cfg = Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, pad_token_id=0, attn_implementation="eager")
    torch.manual_seed(2)
    hf_model = Qwen2Model(hf_cfg).eval()
    with torch.no_grad():  # random biases, so the parity exercises them
        for layer in hf_model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(std=0.1)
    hf_model.save_pretrained(str(tmp_path))
    cfg, state = hf_io.load_pretrained(str(tmp_path))
    assert cfg.model_type == "qwen2" and cfg.attention_qkv_bias and cfg.sliding_window is None
    model = penc.encoder_class(cfg).from_state_dict(cfg, state, device="cpu")
    ids = np.array([[5, 6, 7, 8, 0, 0], [9, 10, 11, 12, 13, 14]])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.inference_mode():
        ref = hf_model(input_ids=torch.tensor(ids),
                       attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        ours = penc.forward_hidden(model, torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(ours[mask == 1], ref[mask == 1], atol=2e-4)


@pytest.mark.parametrize("model_type", ["mistral", "gemma"])
def test_unported_decoder_bodies_raise(model_type):
    """Mistral and Gemma, both ported, build the llama body
    (tests/test_torch_mistral.py, tests/test_torch_gemma.py); a model_type
    outside the llama family raises."""
    cfg = dataclasses.replace(_setup("qwen2")[2], model_type=model_type)
    assert penc.encoder_class(cfg) is llama.LlamaEncoder
    with pytest.raises(NotImplementedError, match="llama-family"):
        llama.check_supported(dataclasses.replace(cfg, model_type="gemma2"))
