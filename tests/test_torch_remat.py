"""Gradient checkpointing policies of the port's bodies (mirroring
``tests/test_models.py``'s remat tests).

- Under "full", "dots" and "attn" every gradient is bit-equal (rtol 0, atol
  0) to the gradient without checkpointing, for Llama, Qwen2 (biases),
  Mistral (a window that bites at these lengths), Gemma and packed
  ``segment_ids``: each policy recomputes the same operations in the same
  order, or keeps their outputs.
- Roberta with dropout live: the embeddings and gradients under each policy
  equal the run without checkpointing, so the recompute draws the same
  masks ("attn" restarts the layer's generator from its state after the
  attention's draws).
- "dots" keeps the products without batch dimensions (no ``aten.mm`` /
  ``aten.addmm`` in the recompute) and "attn" keeps the attention (no
  ``aten.bmm`` of the plain attention in the recompute), counted by a
  dispatch mode over the backward pass.
- Gradients under each policy agree with JAX's ``embed(..., remat=True,
  remat_policy=p)`` in fp32 within atol 5e-6, rtol 5e-5
  (``tests/test_torch_train.py``'s parameter and loss tolerances).
- An unknown policy raises ``ValueError`` naming the three.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.models.encoder import embed as jembed
from rankpo_tpu_torch.models.config import (
    EncoderConfig,
    tiny_llama_config,
    tiny_qwen2_config,
    tiny_roberta_config,
)
from rankpo_tpu_torch.models.encoder import embed, embed_packed, encoder_class, init_params
from rankpo_tpu_torch.models.hf_io import params_from_jax

torch.set_num_threads(2)

POLICIES = ["full", "dots", "attn"]
LENS = [16, 9, 1]


def _configs():
    llama = tiny_llama_config(vocab_size=256)
    return {
        "llama": llama,
        "qwen2": tiny_qwen2_config(vocab_size=256),
        "mistral": dataclasses.replace(llama, model_type="mistral", sliding_window=5),
        "gemma": dataclasses.replace(llama, model_type="gemma",
                                     hidden_act="gelu_pytorch_tanh"),
        "packed": llama,
    }


def _batch():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 256, (3, 16)))
    mask = torch.from_numpy((np.arange(16)[None] < np.array(LENS)[:, None]).astype(np.int32))
    return ids, mask


def _packed_batch():
    """Two rows of 16 holding texts of 7, 5 and 4 tokens, then 9 tokens and
    a pad tail; the slot table of the packed collators."""
    rng = np.random.default_rng(1)
    seg = torch.tensor([[1] * 7 + [2] * 5 + [3] * 4, [1] * 9 + [0] * 7])
    ids = torch.from_numpy(rng.integers(3, 256, (2, 16))) * (seg != 0)
    return {"input_ids": ids, "segment_ids": seg, "attention_mask": (seg != 0).int()}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _grads(cfg, state, policy, packed=False, generator_seed=None, count=None):
    model = encoder_class(cfg).for_training(
        cfg, state, device="cpu", compute_dtype=torch.float32,
        gradient_checkpointing=policy is not None, checkpoint_policy=policy or "full")
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    if packed:
        reps, valid = embed_packed(model, _packed_batch(), 3, generator=gen)
        reps = reps[valid]
    else:
        ids, mask = _batch()
        reps = embed(model, {"input_ids": ids, "attention_mask": mask}, generator=gen)
    loss = (reps * (torch.arange(reps.shape[1]) / reps.shape[1])).sum()
    with count or torch.enable_grad():
        loss.backward()
    return reps.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("body", ["llama", "qwen2", "mistral", "gemma", "packed"])
def test_policy_gradients_bit_equal_to_no_remat(body, policy):
    cfg = _configs()[body]
    state = init_params(cfg, torch.Generator().manual_seed(1))
    reps0, base = _grads(cfg, state, None, packed=body == "packed")
    reps, got = _grads(cfg, state, policy, packed=body == "packed")
    assert torch.equal(reps, reps0)
    for name, g in base.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=0, msg=name)
    if body == "mistral":  # the window bites at these lengths
        _, unwindowed = _grads(dataclasses.replace(cfg, sliding_window=None), state, policy)
        assert any(not torch.equal(unwindowed[n], g) for n, g in got.items())


@pytest.mark.parametrize("policy", POLICIES)
def test_roberta_dropout_masks_equal_under_each_policy(policy):
    cfg = dataclasses.replace(tiny_roberta_config(vocab_size=256), hidden_dropout=0.1,
                              attention_dropout=0.1)
    state = init_params(cfg, torch.Generator().manual_seed(1))
    reps0, base = _grads(cfg, state, None, generator_seed=5)
    other, _ = _grads(cfg, state, None, generator_seed=6)
    assert not torch.equal(reps0, other)  # dropout is live
    reps, got = _grads(cfg, state, policy, generator_seed=5)
    assert torch.equal(reps, reps0)
    for name, g in base.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("policy,kept", [("dots", ("aten.mm.default", "aten.addmm.default")),
                                         ("attn", ("aten.bmm.default",))])
def test_policy_keeps_what_it_saves(policy, kept):
    cfg = tiny_qwen2_config(vocab_size=256)  # q/k/v biases: addmm too
    state = init_params(cfg, torch.Generator().manual_seed(1))
    plain, remat = _Count(), _Count()
    _grads(cfg, state, None, count=plain)
    _grads(cfg, state, policy, count=remat)
    full = _Count()
    _grads(cfg, state, "full", count=full)
    for op in kept:
        assert remat.ops.get(op, 0) == plain.ops.get(op, 0), op
    assert any(full.ops.get(op, 0) > plain.ops.get(op, 0) for op in kept)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_jax_remat(policy):
    jcfg = jtiny(vocab_size=256)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    params = jinit(jax.random.key(0), jcfg)
    ids, mask = _batch()
    batch = {"input_ids": jnp.asarray(ids.numpy().astype(np.int32)),
             "attention_mask": jnp.asarray(mask.numpy())}
    weights = jnp.arange(jcfg.hidden_size, dtype=jnp.float32) / jcfg.hidden_size

    def loss(p):
        reps = jembed(p, jcfg, batch, compute_dtype=jnp.float32, remat=True,
                      remat_policy=policy)
        return jnp.sum(reps * weights)

    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)), pcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    _, got = _grads(pcfg, state, policy)
    for name, ref in jgrads.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=5e-6, rtol=5e-5,
                                   err_msg=name)


def test_unknown_policy_raises():
    cfg = tiny_llama_config(vocab_size=256)
    state = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"\['full', 'dots', 'attn'\]"):
        encoder_class(cfg).for_training(cfg, state, device="cpu", checkpoint_policy="nope")
