"""Sliding-window attention and the Mistral body in the port, against the
JAX package and ``transformers``.

Windowed attention (``window``: row q sees keys with q_pos - k_pos < window,
bottom-right aligned, with ``causal`` only): the port's plain attention, the
plain versions of the kernels K1 (out and lse) and K2/K3a/K3b (dq, dk, dv from
the forward's statistics) and autograd through the plain attention are held,
on the same fp32 inputs made with numpy, to JAX's ``_xla_attention``, its
gradient, and the Pallas kernels run in interpret mode. Cases: GQA, Sq < Sk,
Sq > Sk, windows smaller than, equal to and larger than the sequence, a
window of 1, and rows that see no valid key (pad keys only inside the
window: zeros, lse NEG_INF, zero gradients). Tolerances as in
tests/test_torch_attention.py and tests/test_torch_flash_bwd.py: atol 1e-5
(forward) and 2e-5 (backward) against the Pallas kernels, 3e-4 against
the autodiff oracle.

The Mistral body (the llama body, no biases, ``sliding_window``) at seq 16
and window 5, so the window bites: hidden states and pooled embeddings in
fp32 within 1e-5 of ``rankpo_tpu.models``, gradients within 1e-4 relative
L2 per tensor, ``gradient_checkpointing`` on and off equal, files both ways,
``transformers``' ``MistralModel`` within 2e-4; Qwen2's
``use_sliding_window`` configs; and stage 1, stage 2, ``cli.evaluate`` and
``cli.serve`` on a tiny Mistral checkpoint on the CPU.
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
from rankpo_tpu.models.config import EncoderConfig as JaxEncoderConfig
from rankpo_tpu.models.config import tiny_llama_config
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
from rankpo_tpu_torch.data.tokenization import hash_special_ids, resolve_tokenizer
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

# name: (b, sq, sk, hq, hkv, d, key lengths, window)
CASES = {
    "gqa": (2, 32, 32, 4, 2, 8, [32, 11], 5),
    "sq_lt_sk": (2, 16, 48, 4, 2, 8, [48, 30], 7),
    "sq_gt_sk": (2, 40, 24, 4, 2, 8, [24, 13], 6),
    "window_1": (2, 32, 32, 4, 2, 8, [32, 20], 1),
    "window_eq_seq": (2, 32, 32, 4, 4, 8, [32, 17], 32),
    "window_gt_seq": (2, 32, 32, 4, 2, 8, [32, 9], 100),
    # several key blocks per query block and back: the window crosses blocks
    "many_blocks": (2, 64, 64, 8, 2, 8, [64, 41], 20),
    # the 6-key row's rows 10.. see only pad keys inside their window of 4
    "no_key_rows": (2, 32, 32, 4, 2, 8, [32, 6], 4),
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


def _no_key_rows(sq, sk, lens, window):
    """[B, Sq] True where a row sees no valid key inside its window."""
    pos = np.arange(sq)[None, :] + sk - sq
    lens = np.asarray(lens)[:, None]
    first = np.maximum(pos - window + 1, 0)
    last = np.minimum(pos, lens - 1)
    return last < first


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_plain_matches_xla(case):
    b, sq, sk, hq, hkv, d, lens, window = CASES[case]
    q, k, v, _, mask = _inputs(b, sq, sk, hq, hkv, d, lens)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), True, window))
    out = attention_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask), True,
                              window=window).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    empty = _no_key_rows(sq, sk, lens, window)
    assert np.all(out[empty] == 0.0)
    if case == "no_key_rows":
        assert empty.any()
    # the window changes the result wherever it is shorter than the rows
    full = attention_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask), True).numpy()
    assert (np.abs(full - out).max() > 1e-3) == (window < sq)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_plain_matches_pallas_interpret(case):
    b, sq, sk, hq, hkv, d, lens, window = CASES[case]
    q, k, v, _, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=1)
    ref = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
        causal=True, q_block=16, k_block=16, interpret=True, window=window))
    out = multi_head_attention(_t(q), _t(k), _t(v), mask=torch.from_numpy(mask),
                               causal=True, window=window).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _pallas_stats(q, k, v, do, mask, window):
    """Flattened inputs, the Pallas forward's out, lse and delta ([B*H, S])."""
    hq = q.shape[2]
    q_block, k_block = fit_blocks(q.shape[1], k.shape[1], 16, 16)
    qf, kf, vf, gf = (_flatten_heads(jnp.asarray(x)) for x in (q, k, v, do))
    mask_bh = jnp.repeat(jnp.asarray(mask), hq, axis=0)
    out, lse = _flash_fwd_impl(qf, kf, vf, mask_bh, True, q_block, k_block, True, False,
                               window)
    delta = jnp.sum(gf * out, axis=-1)
    kw = dict(causal=True, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=False, window=window)
    return (qf, kf, vf, mask_bh, gf, lse, delta), out, kw


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_kernel_plain_version_matches_pallas_out_and_lse(case):
    b, sq, sk, hq, hkv, d, lens, window = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=2)
    (_, _, _, _, _, j_lse, _), j_out, _ = _pallas_stats(q, k, v, do, mask, window)
    out, lse = flash_attention_fwd_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                             causal=True, window=window)
    np.testing.assert_allclose(out.permute(0, 2, 1, 3).reshape(b * hq, sq, d).numpy(),
                               np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(b * hq, sq).numpy(), np.asarray(j_lse),
                               atol=ATOL, rtol=1e-6)
    empty = np.repeat(_no_key_rows(sq, sk, lens, window)[:, None], hq, axis=1)
    assert np.all(lse.numpy()[empty] == np.float32(NEG_INF))


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", list(CASES))
def test_windowed_plain_bwd_matches_pallas_kernels(case, impl):
    b, sq, sk, hq, hkv, d, lens, window = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=3)
    args, _, kw = _pallas_stats(q, k, v, do, mask, window)
    if impl == "fused":
        dq, dk, dv = flash_bwd_fused(*args, **kw)
    else:
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
    ref = (_unflatten_heads(dq, b, hq), _unflatten_heads(dk, b, hkv),
           _unflatten_heads(dv, b, hkv))
    port = flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), _t(do),
        _t(args[5]).reshape(b, hq, sq), _t(args[6]).reshape(b, hq, sq),
        causal=True, window=window)
    for a, r, name in zip(port, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=KERNEL_ATOL, rtol=0,
                                   err_msg=f"{case}/{impl}: {name}")
    assert np.all(port[0].numpy()[_no_key_rows(sq, sk, lens, window)] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_grads_match_jax_grad_of_xla(case):
    """Autograd of the port's plain windowed attention against jax.grad of
    ``_xla_attention`` with the same window."""
    b, sq, sk, hq, hkv, d, lens, window = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=4)

    def f(q_, k_, v_):
        return jnp.sum(_xla_attention(q_, k_, v_, jnp.asarray(mask), True, window)
                       * jnp.asarray(do))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention_reference(*leaves, torch.from_numpy(mask), True, window=window)
    grads = torch.autograd.grad(out, leaves, _t(do))
    for a, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ORACLE_ATOL, rtol=0,
                                   err_msg=f"{case}: {name}")


def test_window_arguments_are_checked():
    """As JAX's ``flash_attention``: a window needs ``causal`` and must be
    positive; CPU tensors never reach a kernel and no launch is counted."""
    q, k, v, _, mask = (torch.from_numpy(a) for a in _inputs(2, 32, 32, 4, 2, 16, [32, 7]))
    before = (dict(port_flash.launches), dict(port_flash.window_launches))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention_fwd(qb, kb, vb, mask, window=4)
    with pytest.raises(ValueError, match="positive"):
        flash_attention_fwd(qb, kb, vb, mask, causal=True, window=0)
    with pytest.raises(ValueError, match="requires causal"):
        port_flash.flash_attention(qb.requires_grad_(), kb, vb, mask, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(qb.detach(), kb, vb, mask, causal=True, window=4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multi_head_attention(q, k, v, mask=mask, causal=True, impl="flash", window=4)
    with pytest.raises(ValueError, match="not both"):  # JAX's rule (flash_attention.py:737)
        flash_attention_fwd(qb.detach(), kb, vb, mask, causal=True, segment_ids=mask)
    assert (port_flash.launches, port_flash.window_launches) == before
    port_flash.reset_launches()
    assert not any(port_flash.window_launches.values())


# ---------------------------------------------------------------------------
# the Mistral body

WINDOW = 5
SEQ = 16


def _jcfg(window=WINDOW):
    return dataclasses.replace(tiny_llama_config(vocab_size=256), model_type="mistral",
                               sliding_window=window, architectures=("MistralModel",))


def _setup(seed=0, window=WINDOW):
    jcfg = _jcfg(window)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.05, params)
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


def test_mistral_body_builds_with_llama_names():
    _, _, pcfg, state = _setup()
    assert pcfg.model_type == "mistral" and pcfg.sliding_window == WINDOW
    assert not pcfg.attention_qkv_bias and not pcfg.attention_o_bias
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    assert isinstance(model, llama.LlamaEncoder)
    assert list(model.state_dict()) == llama.state_names(pcfg) == list(state)
    assert not any(n.endswith(".bias") for n in state)


@pytest.mark.parametrize("window", [WINDOW, None])
def test_forward_hidden_matches_jax_fp32(window):
    jcfg, params, pcfg, state = _setup(window=window)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([16, 11, 1, 7])
    ref = np.asarray(jenc.forward_hidden(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                         compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.forward_hidden(model, *_torch(ids, mask).values()).numpy()
    valid = mask == 1
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5, rtol=0)


def test_embed_matches_jax_fp32_and_the_window_bites():
    jcfg, params, pcfg, state = _setup(seed=1)
    model = llama.LlamaEncoder.from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([16, 5, 13], seed=1)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
        full_cfg = dataclasses.replace(pcfg, sliding_window=None)
        full = penc.embed(llama.LlamaEncoder.from_state_dict(full_cfg, state, device="cpu"),
                          _torch(ids, mask)).numpy()
    assert pcfg.pooling == "last_token"
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # rows longer than the window change; the 5-token row (= window) does not
    moved = np.abs(out - full).max(axis=1)
    assert moved[0] > 1e-3 and moved[2] > 1e-3 and moved[1] < 1e-6


def _jax_loss_and_grads(params, jcfg, qi, qm, pi, pm):
    def jloss_fn(p):
        q = jenc.embed(p, jcfg, _jax(qi, qm), compute_dtype=jnp.float32)
        d = jenc.embed(p, jcfg, _jax(pi, pm), compute_dtype=jnp.float32)
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


def test_grads_match_jax():
    jcfg, params, pcfg, state = _setup(seed=2)
    qi, qm = _batch([9, 12, 4], s=12, seed=2)
    pi, pm = _batch([16, 14, 3, 11, 16, 8], seed=3)
    jloss, jgrads = _jax_loss_and_grads(params, jcfg, qi, qm, pi, pm)
    loss, grads = _port_loss_and_grads(pcfg, state, qi, qm, pi, pm)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    ref = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    for name, g in grads.items():
        r = ref[name].numpy()
        err = np.linalg.norm(g.numpy() - r)
        assert err <= 1e-4 * np.linalg.norm(r), (name, err, np.linalg.norm(r))


def test_gradient_checkpointing_keeps_the_window():
    """The checkpointed recompute runs the same windowed attention (the JAX
    package once lost the window in a remat branch, tests/test_models.py):
    loss and gradients equal with checkpointing on and off, and different
    from the same weights without the window."""
    _, _, pcfg, state = _setup(seed=5)
    qi, qm = _batch([9, 12, 4], s=12, seed=5)
    pi, pm = _batch([16, 14, 3, 11, 16, 8], seed=6)
    base = _port_loss_and_grads(pcfg, state, qi, qm, pi, pm)
    remat = _port_loss_and_grads(pcfg, state, qi, qm, pi, pm, checkpointing=True)
    assert remat[0] == pytest.approx(base[0], abs=1e-6)
    for name, g in base[1].items():
        np.testing.assert_allclose(remat[1][name].numpy(), g.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    full_cfg = dataclasses.replace(pcfg, sliding_window=None)
    full = _port_loss_and_grads(full_cfg, state, qi, qm, pi, pm, checkpointing=True)
    assert abs(full[0] - base[0]) > 1e-4


def test_files_and_params_from_jax_both_ways(tmp_path):
    jcfg, params, pcfg, state = _setup(seed=7)
    jhf.save_pretrained(str(tmp_path / "jax"), jcfg, params)
    cfg, got = hf_io.load_pretrained(str(tmp_path / "jax"))
    assert cfg == pcfg and cfg.sliding_window == WINDOW
    for name, t in got.items():
        assert torch.equal(t, state[name]), name
    hf_io.save_pretrained(str(tmp_path / "port"), pcfg, state)
    saved = json.loads((tmp_path / "port" / "config.json").read_text())
    assert saved["sliding_window"] == WINDOW and saved["model_type"] == "mistral"
    assert saved["architectures"] == ["MistralModel"]
    assert EncoderConfig.from_hf_dict(pcfg.to_hf_dict()) == pcfg
    jcfg2, jparams = jhf.load_pretrained(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    back = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg)
    for name, t in back.items():
        assert torch.equal(t, state[name]), name


@pytest.mark.parametrize("head", ["MistralModel", "MistralForCausalLM"])
def test_mistral_parity_with_transformers(tmp_path, head):
    """HF's eager sliding-window mask at seq 12, window 5; a saved
    ``MistralForCausalLM`` prefixes every tensor with 'model.' and carries
    an LM head, both dropped on load."""
    import transformers
    from transformers import MistralConfig

    hf_cfg = MistralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, sliding_window=WINDOW, pad_token_id=2,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(3)
    hf_model = getattr(transformers, head)(hf_cfg).eval()
    hf_model.save_pretrained(str(tmp_path))
    body = hf_model if head == "MistralModel" else hf_model.model
    cfg, state = hf_io.load_pretrained(str(tmp_path))
    assert cfg.model_type == "mistral" and cfg.sliding_window == WINDOW
    assert cfg.pad_token_id == 2 and cfg.pooling == "last_token"
    model = penc.encoder_class(cfg).from_state_dict(cfg, state, device="cpu")
    ids = np.array([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 2],
                    [20, 21, 22, 23, 24, 25, 26, 2, 2, 2, 2, 2]])
    mask = (ids != 2).astype(np.int64)
    with torch.inference_mode():
        ref = body(input_ids=torch.tensor(ids),
                   attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        ours = penc.forward_hidden(model, torch.tensor(ids), torch.tensor(mask)).numpy()
        full_cfg = dataclasses.replace(cfg, sliding_window=None)
        full_model = llama.LlamaEncoder.from_state_dict(full_cfg, state, device="cpu")
        full = penc.forward_hidden(full_model, torch.tensor(ids), torch.tensor(mask)).numpy()
    valid = mask == 1
    np.testing.assert_allclose(ours[valid], ref[valid], atol=2e-4)
    assert np.abs(full[valid] - ref[valid]).max() > 1e-3


# HF Qwen2 configs with use_sliding_window (tests/test_models.py:522-551)
QWEN2_SWA = {"model_type": "qwen2", "vocab_size": 256, "hidden_size": 64,
             "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "use_sliding_window": True, "sliding_window": 5,
             "max_window_layers": 0, "rope_theta": 10000.0, "pad_token_id": 0}


def test_qwen2_uniform_window_runs_as_jax():
    """Every layer windowed (max_window_layers 0): the window is kept and the
    Qwen2 body runs it as the JAX package does."""
    pcfg = EncoderConfig.from_hf_dict(QWEN2_SWA)
    jcfg = JaxEncoderConfig.from_hf_dict(QWEN2_SWA)
    assert pcfg.sliding_window == jcfg.sliding_window == 5
    assert EncoderConfig.from_hf_dict(dict(QWEN2_SWA, max_window_layers=2)).sliding_window \
        is None
    assert EncoderConfig.from_hf_dict(dict(QWEN2_SWA, use_sliding_window=False)) \
        .sliding_window is None
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(8), jcfg))
    model = penc.encoder_class(pcfg).from_state_dict(
        pcfg, hf_io.params_from_jax(params, pcfg), device="cpu")
    ids, mask = _batch([16, 9], seed=8)
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_qwen2_hybrid_window_raises():
    """Layers below max_window_layers at full attention and the rest windowed
    is refused, as in JAX: one uniform window would give wrong embeddings."""
    d = dict(QWEN2_SWA, num_hidden_layers=4, max_window_layers=2)
    for cls in (EncoderConfig, JaxEncoderConfig):
        with pytest.raises(ValueError, match="hybrid Qwen2 SWA"):
            cls.from_hf_dict(d)


@pytest.mark.parametrize("change", [dict(model_type="gemma"), dict(hidden_act="gelu"),
                                    dict(hidden_act="relu")])
def test_gemma_still_raises(change):
    """Gemma ((1 + w) norms, scaled embeddings) and the GELU gates of JAX's
    ``_ACTS`` build the llama body and match ``rankpo_tpu.models`` on the
    windowed config (tests/test_torch_gemma.py holds the Gemma body in
    full); an activation ``_ACTS`` has no entry for still raises."""
    jcfg, params, pcfg, state = _setup()
    pcfg = dataclasses.replace(pcfg, **change)
    if change.get("hidden_act") == "relu":
        with pytest.raises(NotImplementedError, match="relu"):
            penc.encoder_class(pcfg)
        return
    jcfg = dataclasses.replace(jcfg, **change)
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    ids, mask = _batch([16, 11])
    ref = np.asarray(jenc.embed(params, jcfg, _jax(ids, mask), compute_dtype=jnp.float32))
    with torch.inference_mode():
        out = penc.embed(model, _torch(ids, mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the CLIs on a tiny Mistral checkpoint (pad 2, as e5-mistral-7b-instruct)

N_DOCS = 24
TOK = "hash:256"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("mistral_cli")
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
    cfg = EncoderConfig(**dataclasses.asdict(dataclasses.replace(_jcfg(), pad_token_id=2)))
    hf_io.save_pretrained(str(root / "base"), cfg, penc.init_params(
        cfg, torch.Generator().manual_seed(0)))
    return root


def test_hash_tokenizer_takes_the_mistral_pad(workspace):
    tok = resolve_tokenizer(TOK, str(workspace / "base"))
    assert hash_special_ids(str(workspace / "base")) == {"pad_token_id": 2, "cls_token_id": 1}
    assert (tok.pad_token_id, tok.cls_token_id) == (2, 1)


def test_hf_tokenizer_without_pad_takes_eos_as_jax_does():
    """A Mistral-style tokenizer (<unk> 0, <s> 1, </s> 2, no pad token and
    no Llama pad token): both packages' ``prepare_tokenizer`` pad with
    </s>, id 2, e5-mistral-7b-instruct's ``pad_token_id``."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from rankpo_tpu.data import tokenization as jtok
    from rankpo_tpu_torch.data import tokenization as ptok

    def tokenizer():
        vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"w{i}": 3 + i for i in range(20)}}
        tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                       bos_token="<s>", eos_token="</s>")

    port, ref = tokenizer(), tokenizer()
    assert ptok.prepare_tokenizer(port) == jtok.prepare_tokenizer(ref)
    assert (port.pad_token, port.pad_token_id) == (ref.pad_token, ref.pad_token_id)
    assert (port.pad_token, port.pad_token_id) == ("</s>", 2)


def test_two_stages_then_evaluate(workspace, tmp_path):
    root = workspace
    base = str(root / "base")
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
    assert cfg1.model_type == "mistral" and cfg1.sliding_window == WINDOW
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
    assert server.service.encoder.config.sliding_window == WINDOW
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
