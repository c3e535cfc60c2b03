"""``Trainer.evaluate``, ``eval_strategy``, the profiler and ``debug_nans``
of the port's trainer (mirroring ``tests/test_train.py``'s evaluation
tests).

- ``evaluate`` against JAX's ``Trainer.evaluate`` on the same weights and
  rows, both stages, at a batch that splits the set and at one larger than
  the whole set (an eval set smaller than one batch still gives metrics):
  every ``eval_`` key within rtol 5e-5, atol 1e-6
  (``tests/test_torch_train.py``'s metric tolerances);
- ``eval_strategy`` "steps" and "epoch" put ``eval_loss`` rows in the
  history at the JAX package's points;
- ``profile_steps`` writes a Chrome trace under ``output_dir/profile/``;
- ``debug_nans`` raises ``FloatingPointError`` naming the first
  non-finite tensor (a poisoned loss; a poisoned gradient).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.core.mesh import MeshConfig, make_mesh
from rankpo_tpu.data import collators as jcoll
from rankpo_tpu.data import datasets as jdata
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu_torch.data import collators as pcoll
from rankpo_tpu_torch.data import datasets as pdata
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.hf_io import params_from_jax
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer
from test_torch_train import _contrastive_rows, _pair_rows, _Poisoned

torch.set_num_threads(2)

RANKPO_KW = dict(beta=2.0, temperature=0.1, loss_type="sigmoid", sft_weight=0.3)


def _setup(stage, n_rows):
    jcfg = jtiny(vocab_size=256)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    params = jinit(jax.random.key(1), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    tok_p, tok_j = HashTokenizer(vocab_size=256), JHashTokenizer(vocab_size=256)
    if stage == "contrastive":
        rows = _contrastive_rows(n=n_rows)
        data = (pdata.ContrastiveDataset(rows, tok_p, 12, 16),
                jdata.ContrastiveDataset(rows, tok_j, 12, 16),
                pcoll.ContrastiveCollator(0, 3, 12, 16, seed=2),
                jcoll.ContrastiveCollator(0, 3, 12, 16, seed=2))
        losses = (make_contrastive_loss_fn(pcfg, temperature=0.05),
                  jcontrastive(jcfg, temperature=0.05, compute_dtype=jnp.float32))
    else:
        rows = _pair_rows(n=n_rows)
        data = (pdata.PairPreferenceDataset(rows, tok_p, 12, 16),
                jdata.PairPreferenceDataset(rows, tok_j, 12, 16),
                pcoll.RankPOCollator(0, 12, 16), jcoll.RankPOCollator(0, 12, 16))
        losses = (make_rankpo_loss_fn(pcfg, **RANKPO_KW),
                  jrankpo(jcfg, compute_dtype=jnp.float32, **RANKPO_KW))
    return jcfg, pcfg, params, state, data, losses


def _port_trainer(pcfg, state, loss_fn, tmp_path, **extra):
    model = llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)
    cfg = TrainConfig(**{**dict(device="cpu", output_dir=str(tmp_path), learning_rate=1e-3,
                                per_device_train_batch_size=4, save_strategy="no"), **extra})
    return Trainer(loss_fn=loss_fn, model=model, config=cfg, total_steps=4)


@pytest.mark.parametrize("n_rows,batch", [(10, 4), (6, 8)])
@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_evaluate_matches_jax(tmp_path, stage, n_rows, batch):
    jcfg, pcfg, params, state, (ds_p, ds_j, co_p, co_j), (ploss, jloss) = _setup(stage, n_rows)
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JTrainer(loss_fn=jloss, params=params, mesh=mesh, total_steps=4,
                  config=JTrainConfig(output_dir=str(tmp_path), save_strategy="no",
                                      per_device_train_batch_size=4,
                                      per_device_eval_batch_size=batch))
    want = jt.evaluate(ds_j, co_j)
    pt = _port_trainer(pcfg, state, ploss, tmp_path, per_device_eval_batch_size=batch)
    got = pt.evaluate(ds_p, co_p)
    assert sorted(got) == sorted(want) and "eval_loss" in got
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=5e-5, atol=1e-6, err_msg=key)
    # evaluation leaves the parameters and the counters alone
    assert pt.step == 0 and all(p.grad is None for p in pt.params)


@pytest.mark.parametrize("strategy,points", [("steps", [2, 4]), ("epoch", [4])])
def test_eval_strategy_logs_eval_rows(tmp_path, strategy, points):
    _, pcfg, _, state, (ds_p, _, co_p, _), (ploss, _) = _setup("rankpo", 16)
    pt = _port_trainer(pcfg, state, ploss, tmp_path, eval_strategy=strategy, eval_steps=2,
                       num_train_epochs=1)
    history = pt.train(ds_p, co_p, eval_dataset=ds_p)
    evals = [h for h in history if "eval_loss" in h]
    assert [h["global_step"] for h in evals] == points
    assert all(np.isfinite(h["eval_loss"]) and "loss" not in h for h in evals)
    assert [h["global_step"] for h in history if "loss" in h] == [1, 2, 3, 4]


def test_profiler_writes_a_trace(tmp_path):
    _, pcfg, _, state, (ds_p, _, co_p, _), (ploss, _) = _setup("rankpo", 16)
    pt = _port_trainer(pcfg, state, ploss, tmp_path, profile_steps=2, profile_start_step=1,
                       max_steps=4)
    pt.train(ds_p, co_p)
    trace = tmp_path / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mm" in n or "aten::addmm" in n for n in names)
    # two steps traced: the step's optimizer update appears twice
    assert sum(n.startswith("Optimizer.step") for n in names) >= 1


def _poisoned_gradient(fn, name):
    """loss_fn whose gradient of the parameter ``name`` is NaN (the loss
    and the metrics stay finite)."""
    def loss_fn(model, batch):
        param = dict(model.named_parameters())[name]
        param.register_hook(lambda g: g * float("nan"))
        return fn(model, batch)

    return loss_fn


@pytest.mark.parametrize("poison", ["loss", "gradient"])
def test_debug_nans_names_the_first_bad_tensor(tmp_path, poison):
    _, pcfg, _, state, (ds_p, _, co_p, _), (ploss, _) = _setup("rankpo", 16)
    if poison == "loss":
        loss_fn, match = _Poisoned(ploss, bad_calls=[2]), "non-finite loss at step 2"
    else:
        loss_fn = _poisoned_gradient(ploss, "layers.1.mlp.up_proj.weight")
        match = "non-finite gradient of layers.1.mlp.up_proj.weight at step 1"
    pt = _port_trainer(pcfg, state, loss_fn, tmp_path, debug_nans=True, max_steps=4)
    with pytest.raises(FloatingPointError, match=match):
        pt.train(ds_p, co_p)
