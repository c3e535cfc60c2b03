"""The port's XLM-Roberta / BERT body (BGE families) against the JAX package
and ``transformers``.

Same weights (the JAX init, carried over with ``params_from_jax``) and the
same numpy inputs go through both packages, in fp32 with dropout off; the
JAX attention runs its XLA path, as its own CPU tests run it. Tolerances:
last hidden state and ``embed`` within 1e-5; gradients of a small InfoNCE
loss within 1e-4 relative L2 per tensor; positions and resized rows bit for
bit; ``transformers``' ``XLMRobertaModel`` / ``BertModel`` within 2e-4.
Dropout masks cannot match across frameworks, so the dropout tests check the
port's masks on their own: every site live, the keep rate, the scale, the
deterministic path and repeatability.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models import roberta as jroberta
from rankpo_tpu.models.config import tiny_roberta_config
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models import hf_io, roberta
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.ops.attention import dropout, multi_head_attention
from rankpo_tpu_torch.train.steps import make_rankpo_loss_fn

torch.set_num_threads(2)

KINDS = ["xlm-roberta", "bert"]


def _jcfg(kind, **kw):
    cfg = tiny_roberta_config(vocab_size=256)
    if kind == "bert":  # BGE-large-en style: arange positions, 2 token types
        cfg = dataclasses.replace(cfg, model_type="bert", pad_token_id=0,
                                  type_vocab_size=2, layer_norm_eps=1e-12,
                                  architectures=("BertModel",))
    return dataclasses.replace(cfg, **kw)


def _pcfg(jcfg):
    return EncoderConfig(**dataclasses.asdict(jcfg))


def _setup(kind, seed=0, **kw):
    jcfg = _jcfg(kind, **kw)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    # noise on every tensor, so the zero biases and unit LayerNorms of the
    # init are not special cases
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.05, params)
    pcfg = _pcfg(jcfg)
    return jcfg, params, pcfg, hf_io.params_from_jax(params, pcfg)


def _batch(cfg, lens, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (len(lens), s)).astype(np.int32)
    ids[:, 0] = 0 if cfg.pad_token_id == 1 else 1  # a CLS id that is not the pad
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, cfg.pad_token_id).astype(np.int32)
    return ids, mask


def _torch(ids, mask):
    return {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask)}


def _jax(ids, mask):
    return {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}


@pytest.mark.parametrize("kind", KINDS)
def test_forward_hidden_matches_jax_fp32(kind):
    jcfg, params, pcfg, state = _setup(kind)
    model = roberta.RobertaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch(jcfg, [24, 13, 1, 7])
    ref = np.asarray(jenc.forward_hidden(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                         compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.forward_hidden(model, *_torch(ids, mask).values()).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_matches_jax_fp32(kind):
    jcfg, params, pcfg, state = _setup(kind, seed=1)
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    assert isinstance(model, roberta.RobertaEncoder)
    ids, mask = _batch(jcfg, [24, 5, 17], seed=1)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
    assert pcfg.pooling == "cls"
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_matches_jax_bf16_cosine(kind):
    """bf16 rounds at other places in the two frameworks (XLA fuses
    elementwise chains): only the direction is compared, cosine >= 0.999
    per row, as for the llama body."""
    jcfg, params, pcfg, state = _setup(kind, seed=13)
    model = roberta.RobertaEncoder.from_state_dict(pcfg, state, device="cpu",
                                                   dtype=torch.bfloat16)
    ids, mask = _batch(jcfg, [24, 5, 17], seed=13)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.bfloat16))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
    cos = np.sum(out * ref, axis=1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    assert np.all(cos >= 0.999), cos


def _info_nce_jax(params, cfg, qb, pb):
    q = jenc.embed(params, cfg, qb, compute_dtype=jnp.float32)
    p = jenc.embed(params, cfg, pb, compute_dtype=jnp.float32)
    logits = q @ p.T / 0.05
    return -jnp.mean(jax.nn.log_softmax(logits, axis=-1)[jnp.arange(q.shape[0]),
                                                          jnp.arange(q.shape[0]) * 2])


def _info_nce_torch(model, qb, pb):
    q, p = penc.embed(model, qb), penc.embed(model, pb)
    logits = q @ p.T / 0.05
    return torch.nn.functional.cross_entropy(logits, torch.arange(q.shape[0]) * 2)


def _grads_against_jax(jcfg, params, pcfg, state, checkpointing=False):
    qi, qm = _batch(jcfg, [9, 12, 4], s=12, seed=2)
    pi, pm = _batch(jcfg, [20, 16, 3, 11, 24, 8], s=24, seed=3)
    jloss, jgrads = jax.value_and_grad(_info_nce_jax)(params, jcfg, _jax(qi, qm), _jax(pi, pm))
    model = penc.encoder_class(pcfg).for_training(
        pcfg, state, device="cpu", compute_dtype=torch.float32,
        gradient_checkpointing=checkpointing)
    loss = _info_nce_torch(model, _torch(qi, qm), _torch(pi, pm))
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


@pytest.mark.parametrize("kind", KINDS)
def test_grads_match_jax(kind):
    _grads_against_jax(*_setup(kind, seed=2))


def test_grads_match_jax_with_gradient_checkpointing():
    _grads_against_jax(*_setup("xlm-roberta", seed=3), checkpointing=True)


@pytest.mark.parametrize("kind", KINDS)
def test_right_padding_invariance(kind):
    _, _, pcfg, state = _setup(kind, seed=4)
    model = roberta.RobertaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch(pcfg, [6, 6], s=6, seed=4)
    long_ids = np.concatenate([ids, np.full((2, 4), pcfg.pad_token_id, np.int32)], axis=1)
    long_mask = np.concatenate([mask, np.zeros((2, 4), np.int32)], axis=1)
    with torch.inference_mode():
        short = penc.embed(model, _torch(ids, mask))
        long = penc.embed(model, _torch(long_ids, long_mask))
    np.testing.assert_allclose(short.numpy(), long.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_positions_match_jax(kind):
    cfg = _pcfg(_jcfg(kind))
    rng = np.random.default_rng(5)
    # ids that contain the pad id inside the text as well as in the tail
    ids = rng.integers(0, 6, (4, 16)).astype(np.int32)
    ids[1, 9:] = cfg.pad_token_id
    got = roberta.position_ids(cfg, torch.from_numpy(ids).long()).numpy()
    if kind == "bert":
        ref = np.broadcast_to(np.arange(16)[None], (4, 16))
    else:
        ref = np.asarray(jroberta.roberta_position_ids(jnp.asarray(ids), cfg.pad_token_id))
        assert got[1, 9:].tolist() == [cfg.pad_token_id] * 7
    np.testing.assert_array_equal(got, ref)


def test_resize_token_embeddings_roberta_bit_equal():
    jcfg, params, pcfg, state = _setup("xlm-roberta", seed=6)
    jparams, jnew = jenc.resize_token_embeddings(params, jcfg, 263)
    new_state, new_cfg = penc.resize_token_embeddings(state, pcfg, 263)
    assert new_cfg.vocab_size == jnew.vocab_size == 263
    name = "embeddings.word_embeddings.weight"
    np.testing.assert_array_equal(
        new_state[name].numpy(), np.asarray(jparams["embeddings"]["word_embeddings"]["weight"]))
    assert torch.equal(new_state[name][:256], state[name])
    cut, _ = penc.resize_token_embeddings(state, pcfg, 200)
    assert cut[name].shape == (200, pcfg.hidden_size)


def _without_dropout(cfg):
    """Neither package writes the dropout rates to config.json (a reload
    reads HF's default 0.1, BGE's published rate); the rest must match."""
    assert (cfg.hidden_dropout, cfg.attention_dropout) == (0.1, 0.1)
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_files_load_in_port(kind, tmp_path):
    jcfg, params, pcfg, state = _setup(kind, seed=7)
    jhf.save_pretrained(str(tmp_path), jcfg, params)
    cfg, got = hf_io.load_pretrained(str(tmp_path))
    assert _without_dropout(cfg) == pcfg
    assert list(got) == roberta.state_names(pcfg)
    for name, t in got.items():
        assert torch.equal(t, state[name]), name


@pytest.mark.parametrize("kind", KINDS)
def test_port_files_load_in_jax(kind, tmp_path):
    jcfg, params, pcfg, state = _setup(kind, seed=8)
    hf_io.save_pretrained(str(tmp_path), pcfg, state)
    cfg, jparams = jhf.load_pretrained(str(tmp_path))
    assert _without_dropout(cfg) == jcfg
    back = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg)
    for name, t in back.items():
        assert torch.equal(t, state[name]), name


def _hf_parity(tmp_path, hf_model, ids, mask):
    hf_model.save_pretrained(str(tmp_path))
    cfg, state = hf_io.load_pretrained(str(tmp_path))
    model = penc.encoder_class(cfg).from_state_dict(cfg, state, device="cpu")
    with torch.inference_mode():
        ref = hf_model(input_ids=torch.tensor(ids),
                       attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        ours = penc.forward_hidden(model, torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(ours[mask == 1], ref[mask == 1], atol=2e-4)
    return cfg


def test_xlm_roberta_parity_with_transformers(tmp_path):
    from transformers import XLMRobertaConfig, XLMRobertaModel

    hf_cfg = XLMRobertaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, type_vocab_size=1,
        pad_token_id=1, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf_model = XLMRobertaModel(hf_cfg, add_pooling_layer=True).eval()  # pooler dropped
    ids = np.array([[0, 6, 7, 8, 1, 1], [0, 10, 11, 12, 13, 14]])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    cfg = _hf_parity(tmp_path, hf_model, ids, mask)
    assert cfg.model_type == "xlm-roberta"


def test_bert_parity_with_transformers(tmp_path):
    from transformers import BertConfig, BertModel

    hf_cfg = BertConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, type_vocab_size=2,
        pad_token_id=0, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        attn_implementation="eager")
    torch.manual_seed(1)
    hf_model = BertModel(hf_cfg, add_pooling_layer=False).eval()
    ids = np.array([[101, 6, 7, 8, 0, 0], [101, 10, 11, 12, 13, 14]]) % 128
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    cfg = _hf_parity(tmp_path, hf_model, ids, mask)
    assert cfg.model_type == "bert" and cfg.type_vocab_size == 2


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _dropout_model(hidden, attention, seed=9):
    _, _, pcfg, state = _setup("xlm-roberta", seed=seed, hidden_dropout=hidden,
                               attention_dropout=attention)
    return roberta.RobertaEncoder.from_state_dict(pcfg, state, device="cpu")


def _hidden(model, generator=None):
    ids, mask = _batch(model.config, [12, 9], s=12, seed=10)
    with torch.inference_mode():
        return model(*_torch(ids, mask).values(), generator=generator)


@pytest.mark.parametrize("hidden,attention", [(0.5, 0.0), (0.0, 0.5)])
def test_dropout_site_is_live(hidden, attention):
    model = _dropout_model(hidden, attention)
    det = _hidden(model)
    stoch = _hidden(model, torch.Generator().manual_seed(1))
    assert (det - stoch).abs().max().item() > 1e-4


def test_each_hidden_site_is_live(monkeypatch):
    """The embedding output and, in every layer, the attention output and
    the MLP output each go through dropout and change there."""
    model = _dropout_model(0.5, 0.0)
    changed = []

    def spy(x, rate, generator):
        y = dropout(x, rate, generator)
        changed.append(not torch.equal(x, y))
        return y

    monkeypatch.setattr(roberta, "dropout", spy)
    _hidden(model, torch.Generator().manual_seed(1))
    assert changed == [True] * (1 + 2 * model.config.num_hidden_layers)
    changed.clear()
    _hidden(model)
    assert changed == [False] * (1 + 2 * model.config.num_hidden_layers)


def test_dropout_keep_rate_and_scale():
    rate = 0.1
    n = 1 << 20
    x = torch.full((n,), 3.0)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept.float().mean().item() - (1 - rate)) <= 3 * sigma
    assert torch.equal(y[kept], (torch.tensor(3.0) / (1 - rate)).expand(int(kept.sum())))


def test_attention_probs_dropout_keep_rate_and_scale():
    """With every value row one-hot and a single key per query, the output
    is the kept probability (1 / (1 - p)) or 0 entry by entry."""
    rate = 0.25
    b, s, h, d = 8, 1, 64, 64
    q = torch.randn(b, s, h, d)
    k = torch.randn(b, s, h, d)
    v = torch.ones(b, s, h, d)
    out = multi_head_attention(q, k, v, causal=False, dropout_rate=rate,
                               generator=torch.Generator().manual_seed(3))
    kept = out[..., 0] != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)
    assert torch.allclose(out[kept], torch.tensor(1 / (1 - rate)))


def test_no_generator_or_disable_dropout_is_deterministic():
    model = _dropout_model(0.5, 0.5)
    det = _hidden(model)
    zero = _dropout_model(0.0, 0.0)
    np.testing.assert_array_equal(det.numpy(), _hidden(zero).numpy())
    ids, mask = _batch(model.config, [12, 9, 7, 5, 10, 12], s=12, seed=11)
    batch = {"query": _torch(ids[:2], mask[:2]), "passage": _torch(ids[2:], mask[2:])}
    loss_fn = make_rankpo_loss_fn(model.config, disable_dropout=True)
    with torch.inference_mode():
        a, _ = loss_fn(model, batch)
        b, _ = loss_fn(model, batch, torch.Generator().manual_seed(5))
        live, _ = make_rankpo_loss_fn(model.config, disable_dropout=False)(
            model, batch, torch.Generator().manual_seed(5))
    assert a.item() == b.item()
    assert live.item() != a.item()


def test_same_seed_repeats():
    model = _dropout_model(0.3, 0.3)
    a = _hidden(model, torch.Generator().manual_seed(11))
    b = _hidden(model, torch.Generator().manual_seed(11))
    c = _hidden(model, torch.Generator().manual_seed(12))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_gradient_checkpointing_recomputes_the_same_masks():
    _, _, pcfg, state = _setup("xlm-roberta", seed=12, hidden_dropout=0.2,
                               attention_dropout=0.2)
    ids, mask = _batch(pcfg, [12, 9, 4], s=12, seed=12)
    grads = []
    for remat in (False, True):
        model = roberta.RobertaEncoder.for_training(
            pcfg, state, device="cpu", compute_dtype=torch.float32,
            gradient_checkpointing=remat)
        out = penc.embed(model, _torch(ids, mask), generator=torch.Generator().manual_seed(4))
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
