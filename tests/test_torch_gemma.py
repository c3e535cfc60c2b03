"""Head_dim 256 and the Gemma body in the port, against the JAX package and
``transformers``.

Attention at head_dim 256 (google/gemma-2b's 8 query heads over one kv
head, gemma-7b's one query head per kv head): the port's plain attention,
the plain versions of the kernels K1 (out and lse) and K2/K3a/K3b (dq, dk,
dv from the forward's statistics) and autograd through the plain attention
are held, on the same fp32 inputs made with numpy, to JAX's
``_xla_attention``, its gradient and the Pallas kernels in interpret mode.
Cases: GQA 4:1 and 2 / 2 heads, causal and not, key masks (a row of length
1), Sq < Sk and Sq > Sk (rows that see no key: zeros, lse NEG_INF).
Tolerances as tests/test_torch_mistral.py states them: atol 1e-5 (forward)
and 2e-5 (backward) against the Pallas kernels, 3e-4 against the autodiff
oracle. On a CUDA tensor the same calls run the kernels' D 256 builds
(tests/test_torch_gpu.py).

The Gemma body ((1 + w) RMSNorm in fp32, the GeGLU gate, embeddings scaled
by sqrt(hidden) in the compute dtype, zero-initialised norms) at two sizes:
2 layers of hidden 32 with 4 query heads over 1 kv head of 16 (head_dim !=
hidden / heads) and 2 layers of hidden 64 with 2 query heads over 1 kv head
of 256. Norm weights drawn N(0, 0.1) so that (1 + w) bites. Held: hidden
states and embeddings in fp32 within 1e-5 of ``rankpo_tpu.models``; bf16
embeddings at cosine >= 0.999; the bf16 scaled embedding bit-equal;
InfoNCE gradients within 1e-4 relative L2 per tensor, with and without
checkpointing; each activation of JAX's ``_ACTS``; ``transformers``'
``GemmaModel`` and ``GemmaForCausalLM`` within 2e-4; files both ways,
``params_from_jax`` and the config with and without ``hidden_activation``;
stage 1, stage 2, ``cli.evaluate`` and ``cli.serve`` on a tiny Gemma
checkpoint on the CPU.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.eval.metrics import compute_metrics as j_compute_metrics
from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models import llama as jllama
from rankpo_tpu.models.config import EncoderConfig as JaxEncoderConfig
from rankpo_tpu.ops.attention import _xla_attention
from rankpo_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    _flatten_heads,
    _unflatten_heads,
    fit_blocks,
    flash_attention,
    flash_bwd_fused,
    flash_dkv,
    flash_dq,
)
from rankpo_tpu_torch.cli import evaluate, run_contrastive, run_rankpo
from rankpo_tpu_torch.cli import serve as serve_cli
from rankpo_tpu_torch.data.tokenization import hash_special_ids
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models import hf_io, llama
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.ops.attention import NEG_INF, attention_reference, multi_head_attention
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

torch.set_num_threads(2)

ATOL = 1e-5
KERNEL_ATOL = 2e-5
ORACLE_ATOL = 3e-4

# name: (b, sq, sk, hq, hkv, d, key lengths, causal)
CASES = {
    "gqa_causal": (2, 64, 64, 4, 1, 256, [64, 23], True),
    "mha_noncausal": (2, 64, 64, 2, 2, 256, [64, 30], False),
    "mha_causal_len1": (2, 80, 80, 2, 2, 256, [80, 1], True),
    "sq_lt_sk": (2, 48, 80, 4, 1, 256, [80, 50], True),
    # causal Sq > Sk: the first rows sit before every key and see none
    "sq_gt_sk": (2, 80, 48, 4, 1, 256, [48, 20], True),
}


def _inputs(b, sq, sk, hq, hkv, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    do = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    mask = (np.arange(sk)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _no_key_rows(sq, sk, lens, causal):
    """[B, Sq] True where a row sees no valid key: causal rows before key 0
    (every row has a valid key 0)."""
    pos = np.arange(sq) + sk - sq
    return np.broadcast_to(causal & (pos < 0), (len(lens), sq))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_at_d256(case):
    b, sq, sk, hq, hkv, d, lens, causal = CASES[case]
    q, k, v, _, mask = _inputs(b, sq, sk, hq, hkv, d, lens)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), causal))
    out = attention_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask), causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    empty = _no_key_rows(sq, sk, lens, causal)
    assert np.all(out[empty] == 0.0)
    if case == "sq_gt_sk":
        assert empty.any()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_at_d256(case):
    b, sq, sk, hq, hkv, d, lens, causal = CASES[case]
    q, k, v, _, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=1)
    ref = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
        causal=causal, q_block=16, k_block=16, interpret=True))
    out = multi_head_attention(_t(q), _t(k), _t(v), mask=torch.from_numpy(mask),
                               causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _pallas_stats(q, k, v, do, mask, causal):
    """Flattened inputs, the Pallas forward's out, lse and delta ([B*H, S])."""
    hq = q.shape[2]
    q_block, k_block = fit_blocks(q.shape[1], k.shape[1], 16, 16)
    qf, kf, vf, gf = (_flatten_heads(jnp.asarray(x)) for x in (q, k, v, do))
    mask_bh = jnp.repeat(jnp.asarray(mask), hq, axis=0)
    out, lse = _flash_fwd_impl(qf, kf, vf, mask_bh, causal, q_block, k_block, True, False,
                               None)
    delta = jnp.sum(gf * out, axis=-1)
    kw = dict(causal=causal, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=False)
    return (qf, kf, vf, mask_bh, gf, lse, delta), out, kw


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_plain_version_matches_pallas_out_and_lse_at_d256(case):
    b, sq, sk, hq, hkv, d, lens, causal = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=2)
    (_, _, _, _, _, j_lse, _), j_out, _ = _pallas_stats(q, k, v, do, mask, causal)
    out, lse = flash_attention_fwd_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                             causal=causal)
    np.testing.assert_allclose(out.permute(0, 2, 1, 3).reshape(b * hq, sq, d).numpy(),
                               np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(b * hq, sq).numpy(), np.asarray(j_lse),
                               atol=ATOL, rtol=1e-6)
    empty = np.repeat(_no_key_rows(sq, sk, lens, causal)[:, None], hq, axis=1)
    assert np.all(lse.numpy()[empty] == np.float32(NEG_INF))


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_pallas_kernels_at_d256(case, impl):
    b, sq, sk, hq, hkv, d, lens, causal = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=3)
    args, _, kw = _pallas_stats(q, k, v, do, mask, causal)
    if impl == "fused":
        dq, dk, dv = flash_bwd_fused(*args, **kw)
    else:
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
    ref = (_unflatten_heads(dq, b, hq), _unflatten_heads(dk, b, hkv),
           _unflatten_heads(dv, b, hkv))
    port = flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), _t(do),
        _t(args[5]).reshape(b, hq, sq), _t(args[6]).reshape(b, hq, sq), causal=causal)
    for a, r, name in zip(port, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=KERNEL_ATOL, rtol=0,
                                   err_msg=f"{case}/{impl}: {name}")
    assert np.all(port[0].numpy()[_no_key_rows(sq, sk, lens, causal)] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax_grad_of_xla_at_d256(case):
    """Autograd of the port's plain attention against jax.grad of
    ``_xla_attention``."""
    b, sq, sk, hq, hkv, d, lens, causal = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=4)

    def f(q_, k_, v_):
        return jnp.sum(_xla_attention(q_, k_, v_, jnp.asarray(mask), causal)
                       * jnp.asarray(do))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention_reference(*leaves, torch.from_numpy(mask), causal)
    grads = torch.autograd.grad(out, leaves, _t(do))
    for a, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ORACLE_ATOL, rtol=0,
                                   err_msg=f"{case}: {name}")


def test_head_dims_the_kernels_take():
    """The Hopper kernels take head_dim 64, 128 and 256 (other head dims run
    the generic build on a CUDA tensor: tests/test_torch_gpu.py); CPU
    tensors at head_dim 256 never reach a kernel: "auto" runs the plain
    attention, "flash" and the kernel wrapper raise, and nothing is
    counted."""
    assert port_flash.HEAD_DIMS == (64, 128, 256)
    before = (dict(port_flash.launches), dict(port_flash.d256_launches))
    q, k, v, _, mask = (torch.from_numpy(a) for a in _inputs(2, 16, 16, 4, 1, 256, [16, 7]))
    out = multi_head_attention(q, k, v, mask=mask, causal=True, skip_pad_q=True)
    assert torch.equal(out, attention_reference(q, k, v, mask, True))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multi_head_attention(q, k, v, mask=mask, causal=True, impl="flash")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, causal=True)
    assert (port_flash.launches, port_flash.d256_launches) == before


# ---------------------------------------------------------------------------
# the Gemma body

SIZES = {
    # 4 q / 1 kv heads of 16 over hidden 32: head_dim != hidden / heads
    "hd16": dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                 num_attention_heads=4, num_key_value_heads=1, head_dim=16),
    # 2 q / 1 kv heads of 256, gemma's head_dim
    "hd256": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_attention_heads=2, num_key_value_heads=1, head_dim=256),
}
SEQ = 16


def _jcfg(size="hd16", act="gelu_pytorch_tanh"):
    return JaxEncoderConfig(model_type="gemma", num_hidden_layers=2,
                            max_position_embeddings=2048, rms_norm_eps=1e-6,
                            rope_theta=10000.0, pad_token_id=0, hidden_act=act,
                            architectures=("GemmaModel",), pooling="last_token",
                            **SIZES[size])


def _setup(size="hd16", seed=0, act="gelu_pytorch_tanh"):
    """The JAX init (norms at zero) with noise on every tensor, the norm
    weights drawn N(0, 0.1) so that (1 + w) bites; the port's config and
    state from them."""
    jcfg = _jcfg(size, act)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        std = 0.1 if "norm" in jax.tree_util.keystr(path) else 0.02
        return x + rng.standard_normal(x.shape).astype(np.float32) * std

    params = jax.tree_util.tree_map_with_path(perturb, params)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, pcfg, hf_io.params_from_jax(params, pcfg)


def _batch(lens, s=SEQ, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (len(lens), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def _torch(ids, mask):
    return {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask)}


def _jax(ids, mask):
    return {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}


def test_gemma_body_builds_with_llama_names_and_zero_norms():
    _, _, pcfg, state = _setup()
    assert pcfg.is_gemma and pcfg.head_dim == 16 and pcfg.pooling == "last_token"
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    assert isinstance(model, llama.LlamaEncoder)
    assert list(model.state_dict()) == llama.state_names(pcfg) == list(state)
    assert model.layers[0].mlp.act is llama.ACTIVATIONS["gelu_pytorch_tanh"]
    init = llama.init_params(pcfg, torch.Generator().manual_seed(0))
    norms = [n for n in init if n.endswith("norm.weight")]
    assert len(norms) == 2 * pcfg.num_hidden_layers + 1
    assert all(torch.all(init[n] == 0.0) for n in norms)  # (1 + 0): the identity
    assert abs(float(init["embed_tokens.weight"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("size", list(SIZES))
def test_forward_hidden_matches_jax_fp32(size):
    jcfg, params, pcfg, state = _setup(size)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([16, 11, 1, 7])
    ref = np.asarray(jenc.forward_hidden(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                         compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.forward_hidden(model, *_torch(ids, mask).values()).numpy()
    valid = mask == 1
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", list(SIZES))
def test_embed_matches_jax_fp32_and_bf16(size):
    jcfg, params, pcfg, state = _setup(size, seed=1)
    ids, mask = _batch([16, 5, 13], seed=1)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    ref16 = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.bfloat16))
    with torch.inference_mode():
        out = penc.embed(llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu"),
                         _torch(ids, mask)).numpy()
        out16 = penc.embed(llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu",
                                                              dtype=torch.bfloat16),
                           _torch(ids, mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    cos = np.sum(out16 * ref16, axis=1) / (np.linalg.norm(out16, axis=1)
                                           * np.linalg.norm(ref16, axis=1))
    assert cos.min() >= 0.999, cos


def test_scaled_embedding_bit_equal_in_bf16():
    """The table gathered, cast to bf16 and multiplied by sqrt(hidden)
    rounded to bf16 (HF GemmaModel): the first layer's input equals JAX's
    bit for bit, and differs from the unscaled rows."""
    jcfg, params, pcfg, state = _setup(seed=2)
    ids, mask = _batch([16, 9], seed=2)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu",
                                               dtype=torch.bfloat16)
    seen = []
    hook = model.layers[0].register_forward_pre_hook(lambda _, args: seen.append(args[0]))
    with torch.inference_mode():
        model(*_torch(ids, mask).values())
    hook.remove()
    table = params["embed_tokens"]["weight"]
    ref = (jnp.asarray(table)[jnp.asarray(ids)].astype(jnp.bfloat16)
           * jnp.asarray(jcfg.hidden_size**0.5, jnp.bfloat16))
    got = seen[0].float().numpy()
    assert np.array_equal(got, np.asarray(ref.astype(jnp.float32)))
    unscaled = torch.from_numpy(table)[torch.from_numpy(ids).long()].bfloat16().float()
    assert not np.array_equal(got, unscaled.numpy())


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_pytorch_tanh", "gelu_new"])
def test_each_activation_matches_jax(act):
    """Every entry of JAX's ``_ACTS`` (llama.py:98-104): elementwise within
    1e-6, and the whole Gemma body with it as the gate within 1e-5."""
    assert set(llama.ACTIVATIONS) == set(jllama._ACTS)
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(llama.ACTIVATIONS[act](_t(x)).numpy(),
                               np.asarray(jllama._ACTS[act](jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    jcfg, params, pcfg, state = _setup(seed=3, act=act)
    ids, mask = _batch([16, 6], seed=3)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu"),
                         _torch(ids, mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_unknown_activation_raises():
    pcfg = dataclasses.replace(_setup()[2], hidden_act="relu")
    with pytest.raises(NotImplementedError, match="relu"):
        penc.encoder_class(pcfg)


def _jax_loss_and_grads(params, jcfg, qi, qm, pi, pm, remat=False):
    def jloss_fn(p):
        q = jenc.embed(p, jcfg, _jax(qi, qm), compute_dtype=jnp.float32, remat=remat)
        d = jenc.embed(p, jcfg, _jax(pi, pm), compute_dtype=jnp.float32, remat=remat)
        logits = jax.nn.log_softmax(q @ d.T / 0.05, axis=-1)
        return -jnp.mean(logits[jnp.arange(3), jnp.arange(3) * 2])

    return jax.value_and_grad(jloss_fn)(params)


def _port_loss_and_grads(pcfg, state, qi, qm, pi, pm, checkpointing=False):
    model = llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)
    model.gradient_checkpointing = checkpointing
    q = penc.embed(model, _torch(qi, qm))
    d = penc.embed(model, _torch(pi, pm))
    loss = torch.nn.functional.cross_entropy(q @ d.T / 0.05, torch.arange(3) * 2)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("size", list(SIZES))
def test_grads_match_jax(size, checkpointing):
    """InfoNCE over 3 queries and 6 passages: the loss and every gradient
    tensor (norm offsets and the scaled embedding table included) within
    1e-4 relative L2 of jax.grad, with the layers recomputed in the backward
    pass (the JAX ``remat``) or not."""
    jcfg, params, pcfg, state = _setup(size, seed=4)
    qi, qm = _batch([9, 12, 4], s=12, seed=4)
    pi, pm = _batch([16, 14, 3, 11, 16, 8], seed=5)
    jloss, jgrads = _jax_loss_and_grads(params, jcfg, qi, qm, pi, pm, remat=checkpointing)
    loss, grads = _port_loss_and_grads(pcfg, state, qi, qm, pi, pm, checkpointing)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    ref = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    for name, g in grads.items():
        r = ref[name].numpy()
        err = np.linalg.norm(g.numpy() - r)
        assert err <= 1e-4 * np.linalg.norm(r), (name, err, np.linalg.norm(r))


@pytest.mark.parametrize("hidden_activation", [True, False])
def test_files_params_from_jax_and_config_both_ways(tmp_path, hidden_activation):
    """JAX's files load in the port and the port's in JAX, bit for bit; the
    config keeps head_dim 16 != 32 / 4 and the GeGLU gate whether the file
    names it ``hidden_activation`` (newer Gemma configs, read first) or only
    ``hidden_act``."""
    jcfg, params, pcfg, state = _setup(seed=6)
    jhf.save_pretrained(str(tmp_path / "jax"), jcfg, params)
    cfg, got = hf_io.load_pretrained(str(tmp_path / "jax"))
    assert cfg == pcfg
    for name, t in got.items():
        assert torch.equal(t, state[name]), name
    hf_io.save_pretrained(str(tmp_path / "port"), pcfg, state)
    saved = json.loads((tmp_path / "port" / "config.json").read_text())
    assert saved["model_type"] == "gemma" and saved["architectures"] == ["GemmaModel"]
    assert saved["head_dim"] == 16 and saved["hidden_size"] // saved["num_attention_heads"] == 8
    d = dict(saved)
    if hidden_activation:
        d["hidden_activation"], d["hidden_act"] = "gelu_pytorch_tanh", "gelu"
    for cls in (EncoderConfig, JaxEncoderConfig):
        back = cls.from_hf_dict(d)
        assert back.hidden_act == "gelu_pytorch_tanh" and back.head_dim == 16
    assert EncoderConfig.from_hf_dict(d) == pcfg
    jcfg2, jparams = jhf.load_pretrained(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    back = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg)
    for name, t in back.items():
        assert torch.equal(t, state[name]), name


@pytest.mark.parametrize("head", ["GemmaModel", "GemmaForCausalLM"])
def test_gemma_parity_with_transformers(tmp_path, head):
    """HF's eager Gemma at head_dim 16 != 32 / 4, norms drawn N(0, 0.1), as
    tests/test_models.py holds the JAX package; a saved ``GemmaForCausalLM``
    prefixes every tensor with 'model.' and ties its LM head, both dropped
    on load."""
    import transformers
    from transformers import GemmaConfig

    hf_cfg = GemmaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=16,
        max_position_embeddings=128, rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
        hidden_activation="gelu_pytorch_tanh", pad_token_id=0, attn_implementation="eager")
    torch.manual_seed(4)
    hf_model = getattr(transformers, head)(hf_cfg).eval()
    body = hf_model if head == "GemmaModel" else hf_model.model
    with torch.no_grad():
        for layer in body.layers:
            layer.input_layernorm.weight.normal_(std=0.1)
            layer.post_attention_layernorm.weight.normal_(std=0.1)
        body.norm.weight.normal_(std=0.1)
    hf_model.save_pretrained(str(tmp_path))
    cfg, state = hf_io.load_pretrained(str(tmp_path))
    assert cfg.model_type == "gemma" and cfg.is_gemma and cfg.head_dim == 16
    assert cfg.pooling == "last_token" and cfg.hidden_act == "gelu_pytorch_tanh"
    model = penc.encoder_class(cfg).from_state_dict(cfg, state, device="cpu")
    ids = np.array([[5, 6, 7, 8, 0, 0], [9, 10, 11, 12, 13, 14]])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.inference_mode():
        ref = body(input_ids=torch.tensor(ids),
                   attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        ours = penc.forward_hidden(model, torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(ours[mask == 1], ref[mask == 1], atol=2e-4)


# ---------------------------------------------------------------------------
# the CLIs on a tiny Gemma checkpoint (pad 0, as google/gemma-2b)

N_DOCS = 24
TOK = "hash:256"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("gemma_cli")
    docs = [f"field {i} research on subject {i} methods " + " ".join(
        f"w{(i * 7 + j) % 50}" for j in range(12)) for i in range(N_DOCS)]
    (root / "train.jsonl").write_text("\n".join(json.dumps({
        "query": f"job opening about subject {i} methods", "positives": [docs[i]],
        "negatives": [docs[(i + j) % N_DOCS] for j in range(4, 10)]}) for i in range(16)))
    (root / "pairs.jsonl").write_text("\n".join(json.dumps({
        "query": f"q {i}", "passage1": docs[i], "passage2": docs[i + 8],
        "preferred": "AB"[i % 2]}) for i in range(8)))
    (root / "queries.jsonl").write_text("\n".join(json.dumps({
        "query": {"text": f"job opening about subject {i} methods"},
        "positives": {"index": [i]}}) for i in range(8)))
    (root / "corpus.jsonl").write_text("\n".join(json.dumps({"text": t}) for t in docs))
    _, _, cfg, state = _setup(seed=7)
    hf_io.save_pretrained(str(root / "base"), cfg, state)
    return root


def test_two_stages_then_evaluate(workspace, tmp_path):
    root = workspace
    base = str(root / "base")
    assert hash_special_ids(base) == {"pad_token_id": 0, "cls_token_id": 1}
    _, before = hf_io.load_pretrained(base)
    hist1 = run_contrastive.main([
        "--model_name_or_path", base, "--tokenizer_name", TOK,
        "--train_data", str(root / "train.jsonl"), "--output_dir", str(tmp_path / "s1"),
        "--learning_rate", "1e-3", "--per_device_train_batch_size", "4",
        "--num_negatives", "3", "--max_query_length", "16", "--max_passage_length", "20",
        "--max_steps", "2", "--gradient_accumulation_steps", "2",
        "--gradient_checkpointing", "True", "--save_strategy", "no", "--device", "cpu"])
    assert [h["global_step"] for h in hist1] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist1)
    cfg1, s1 = hf_io.load_pretrained(str(tmp_path / "s1"))
    assert cfg1.is_gemma and cfg1.hidden_act == "gelu_pytorch_tanh"
    assert all(not torch.equal(s1[n], before[n]) for n in s1)
    _, jparams = jhf.load_pretrained(str(tmp_path / "s1"))
    from_jax = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg1)
    assert all(torch.equal(s1[n], from_jax[n]) for n in s1)

    torch.use_deterministic_algorithms(True)
    try:
        hist2 = run_rankpo.main([
            "--model_name_or_path", str(tmp_path / "s1"), "--tokenizer_name", TOK,
            "--train_data", str(root / "pairs.jsonl"), "--output_dir", str(tmp_path / "s2"),
            "--per_device_train_batch_size", "4", "--max_query_length", "16",
            "--max_passage_length", "20", "--beta", "2.0", "--temperature", "0.1",
            "--reference_free", "True", "--learning_rate", "1e-3", "--max_steps", "2",
            "--save_strategy", "no", "--device", "cpu"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(np.isfinite(h["loss"]) for h in hist2)
    _, s2 = hf_io.load_pretrained(str(tmp_path / "s2"))
    assert any(not torch.equal(s2[n], s1[n]) for n in s2)

    out = tmp_path / "results"
    results = evaluate.main([
        "--model_name_or_path", str(tmp_path / "s2"), "--tokenizer_name", TOK,
        "--query_data", str(root / "queries.jsonl"),
        "--corpus_data", str(root / "corpus.jsonl"), "--output_dir", str(out),
        "--batch_size", "8", "--max_query_length", "16", "--max_passage_length", "20",
        "--k", "10", "--cutoffs", "1,5,10", "--device", "cpu"])
    (name, metrics), = results.items()
    idx = np.load(out / "s2" / f"{name}-indices.npy")
    scores = np.load(out / "s2" / f"{name}-scores.npy")
    assert idx.shape == scores.shape == (8, 10)
    assert metrics == j_compute_metrics(idx, scores, [[i] for i in range(8)],
                                        cutoffs=[1, 5, 10])


def test_serve_answers_search(workspace):
    base = str(workspace / "base")
    server = serve_cli.make_server([
        "--model_name_or_path", base, "--tokenizer_name", TOK,
        "--corpus_data", str(workspace / "corpus.jsonl"), "--max_query_length", "16",
        "--max_passage_length", "20", "--batch_size", "8", "--serving_k_max", "10",
        "--port", "0", "--device", "cpu", "--log_level", "warning"])
    assert server.service.encoder.config.is_gemma
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/search", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        query = "job opening about subject 3 methods"
        code, body = post({"query": query, "k": 5})
        assert code == 200
        direct = server.service.query(query, k=5)
        assert [h["index"] for h in body["results"][0]["hits"]] == [
            h["index"] for h in direct["hits"]]
        code, body = post({"queries": [query, "field 7"], "k": 3})
        assert code == 200 and [len(r["hits"]) for r in body["results"]] == [3, 3]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)


def test_resize_of_the_256000_row_table_bit_equal_to_jax():
    """google/gemma-2b's vocabulary of 256,000 rows (at the tiny width)
    grown by the reference's 7 special tokens: the new rows are the fp32
    mean of the old rows, bit-equal to the JAX package's resize."""
    jcfg, params, pcfg, state = _setup(seed=8)
    rng = np.random.default_rng(8)
    table = (rng.standard_normal((256000, pcfg.hidden_size)) * 0.02).astype(np.float32)
    params["embed_tokens"]["weight"] = table
    state["embed_tokens.weight"] = torch.from_numpy(table.copy())
    jcfg, pcfg = (dataclasses.replace(c, vocab_size=256000) for c in (jcfg, pcfg))
    jparams, jcfg2 = jenc.resize_token_embeddings(params, jcfg, 256007)
    new_state, new_cfg = penc.resize_token_embeddings(state, pcfg, 256007)
    assert new_cfg.vocab_size == jcfg2.vocab_size == 256007 and new_cfg.is_gemma
    np.testing.assert_array_equal(new_state["embed_tokens.weight"].numpy(),
                                  np.asarray(jparams["embed_tokens"]["weight"]))
