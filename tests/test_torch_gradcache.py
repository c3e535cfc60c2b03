"""Gradient caching for stage 1 (``rankpo_tpu_torch.train.gradcache``,
mirroring ``tests/test_gradcache.py``).

- The cached gradients equal those of one InfoNCE over the whole
  concatenated group (fp32 on the CPU: loss rtol 1e-5, gradients atol
  2e-5, the JAX test's numbers), padded and packed (the packed group holds
  the same sampled examples as the plain one; atol 5e-4, the JAX packed
  test's);
- its loss is the full-group loss, above the mean of the per-micro-batch
  losses (negatives cross micro-batches);
- the ``Trainer`` takes it as ``grad_fn`` and trains;
- against JAX's ``make_contrastive_gradcache_grad_fn`` on the same weights
  and batches: loss rtol 5e-5, gradients atol 5e-6 and rtol 5e-5
  (``tests/test_torch_train.py``'s tolerances; the gradients reach ~6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train.gradcache import make_contrastive_gradcache_grad_fn as jgradcache
from rankpo_tpu_torch.data.collators import ContrastiveCollator
from rankpo_tpu_torch.data.datasets import ContrastiveDataset
from rankpo_tpu_torch.data.loader import _stack
from rankpo_tpu_torch.data.packing import PackedContrastiveCollator
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.hf_io import params_from_jax
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.gradcache import make_contrastive_gradcache_grad_fn
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer, _to_device

torch.set_num_threads(2)

ACCUM, MB = 4, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = jtiny(vocab_size=128)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    params = jinit(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    rows = [{"query": f"topic {i} alpha", "positives": [f"topic {i} beta"],
             "negatives": [f"other {j} {i}" for j in range(4)]} for i in range(16)]
    ds = ContrastiveDataset(rows, HashTokenizer(vocab_size=128), 8, 8)
    return jcfg, pcfg, params, state, ds


def _group(ds, collator, accum=ACCUM):
    return _stack([collator([ds[i] for i in range(a * MB, (a + 1) * MB)])
                   for a in range(accum)])


def _collator(seed=0):
    return ContrastiveCollator(0, 2, 8, 8, seed=seed)


def _model(pcfg, state):
    return llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                           compute_dtype=torch.float32)


def _cached(pcfg, state, group):
    model = _model(pcfg, state)
    grad_fn = make_contrastive_gradcache_grad_fn(pcfg, temperature=0.05)
    loss, metrics = grad_fn(model, [_to_device(group, "cpu", i) for i in range(ACCUM)])
    return loss, metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


def _full_batch(pcfg, state, group):
    """One InfoNCE over the concatenated group."""
    flat = {f: {k: v.reshape((-1,) + v.shape[2:]) for k, v in block.items()}
            for f, block in group.items()}
    model = _model(pcfg, state)
    loss, _ = make_contrastive_loss_fn(pcfg, temperature=0.05)(model, _to_device(flat, "cpu"))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_matches_full_batch_gradients(setup):
    _, pcfg, _, state, ds = setup
    group = _group(ds, _collator())
    loss, metrics, grads = _cached(pcfg, state, group)
    ref_loss, ref = _full_batch(pcfg, state, group)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=2e-5, err_msg=name)


def test_packed_matches_full_batch_gradients(setup):
    _, pcfg, _, state, ds = setup
    plain = _group(ds, _collator(7))
    packed = _group(ds, PackedContrastiveCollator(0, 2, 8, 8, query_max_segments=4,
                                                  passage_max_segments=4, seed=7))
    loss, _, grads = _cached(pcfg, state, packed)
    ref_loss, ref = _full_batch(pcfg, state, plain)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=5e-4, err_msg=name)


def test_negatives_cross_micro_batches(setup):
    _, pcfg, _, state, ds = setup
    group = _group(ds, _collator(), accum=2)
    model = _model(pcfg, state)
    grad_fn = make_contrastive_gradcache_grad_fn(pcfg, temperature=0.05)
    loss, _ = grad_fn(model, [_to_device(group, "cpu", i) for i in range(2)])
    loss_fn = make_contrastive_loss_fn(pcfg, temperature=0.05)
    with torch.no_grad():
        per_micro = [float(loss_fn(model, _to_device(group, "cpu", i))[0]) for i in range(2)]
    assert float(loss) > np.mean(per_micro)  # more negatives: a harder problem


def test_trainer_integration(setup, tmp_path):
    _, pcfg, _, state, ds = setup
    cfg = TrainConfig(device="cpu", output_dir=str(tmp_path), learning_rate=1e-3,
                      warmup_ratio=0.0, lr_scheduler_type="constant",
                      per_device_train_batch_size=2, gradient_accumulation_steps=2,
                      num_train_epochs=2, save_strategy="no")
    trainer = Trainer(loss_fn=None, model=_model(pcfg, state), config=cfg, total_steps=8,
                      grad_fn=make_contrastive_gradcache_grad_fn(pcfg, temperature=0.05))
    history = trainer.train(ds, _collator())
    assert len(history) == 8 and trainer.updates == 8
    assert history[-1]["loss"] < history[0]["loss"]
    assert "accuracy" in history[0]


def test_matches_jax_gradcache(setup):
    jcfg, pcfg, params, state, ds = setup
    group = _group(ds, _collator())
    jgrad_fn = jgradcache(jcfg, temperature=0.05, compute_dtype=jnp.float32)
    jbatch = jax.tree_util.tree_map(jnp.asarray, group)
    jloss, jmetrics, jgrads = jax.jit(jgrad_fn)(params, jbatch, None)
    loss, metrics, grads = _cached(pcfg, state, group)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=5e-6, rtol=5e-5,
                                   err_msg=name)
