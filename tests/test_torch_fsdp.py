"""Sharded parameters (``--fsdp``, ``parallel/fsdp.py``) of the PyTorch
port against the JAX package's ``fsdp`` Trainer on a 2-device data mesh,
against ZeRO-1 at W = 2 and against the port in one process.

Two gloo processes (``torch_dist_workers.fsdp_worker``, joined with a
timeout of its own) train the tiny llama (2 layers, width 64). Tolerances
are JAX's ``test_fsdp_params_sharded_and_loss_matches`` and the data-parallel
tests' (``test_torch_distributed.py``): loss
and gradient norm rtol 2e-4 against JAX and one process, the ranks' logs
identical, the parameters after 4 AdamW steps atol 1e-6 against one
process and ZeRO-1. A rank stores at most total / 2 plus the largest
tensor of parameters and of optimizer state, and a W = 2 checkpoint
resumes at W = 1 with the gathered optimizer state bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.core.mesh import MeshConfig as JMeshConfig
from rankpo_tpu.core.mesh import make_mesh
from rankpo_tpu.data import collators as jcoll
from rankpo_tpu.data import datasets as jdata
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax
from rankpo_tpu_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp"))
    jcfg = jtiny(vocab_size=256)
    params = jinit(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), workers.tiny_config())
    workers.save(out, "state.pt", state)
    workers.spawn(workers.fsdp_worker, 2, out, timeout=200.0)
    return dict(out=out, jcfg=jcfg, params=params, state=state,
                ranks=[workers.load(out, f"fsdp_{r}.pt") for r in range(2)])


def _losses(history, key="loss"):
    return [h[key] for h in history if key in h]


def _jax_fsdp(stage, params, jcfg):
    """JAX's Trainer with ``fsdp`` on a 2-device data mesh, per-device batch
    2, on the workers' rows and settings."""
    tok = JHashTokenizer(vocab_size=256)
    if stage == "stage1":
        ds = jdata.ContrastiveDataset(workers.contrastive_rows(32), tok, 12, 16)
        coll = jcoll.ContrastiveCollator(0, 3, 12, 16, seed=3)
        loss = jcontrastive(jcfg, compute_dtype=jnp.float32, **workers.STAGE1_LOSS)
    else:
        ds = jdata.PairPreferenceDataset(workers.pair_rows(32), tok, 12, 16)
        coll = jcoll.RankPOCollator(0, 12, 16)
        loss = jrankpo(jcfg, compute_dtype=jnp.float32, **workers.STAGE2_LOSS)
    cfg = JTrainConfig(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                       per_device_train_batch_size=2, gradient_accumulation_steps=2,
                       max_steps=4, save_strategy="no", weight_decay=0.01, seed=3, fsdp=True)
    jmesh = make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])
    return JTrainer(loss_fn=loss, params=params, mesh=jmesh, config=cfg,
                    total_steps=4).train(ds, coll)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_fsdp_matches_jax_one_process_and_zero1(fsdp_run, stage, tmp_path):
    ranks = [r[stage] for r in fsdp_run["ranks"]]
    h0, h1 = ranks[0]["history"], ranks[1]["history"]
    assert len(h0) == 4
    for key in ("loss", "grad_norm", "learning_rate"):
        assert _losses(h0, key) == _losses(h1, key), key
    history, final, _, _ = workers.run_stage(stage, fsdp_run["state"], str(tmp_path), 4)
    jhist = _jax_fsdp(stage, fsdp_run["params"], fsdp_run["jcfg"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(h0, key), _losses(history, key), rtol=2e-4)
        np.testing.assert_allclose(_losses(h0, key), _losses(jhist, key), rtol=2e-4)
    compare = [final]
    if stage == "stage1":
        zero1 = fsdp_run["ranks"][0]["stage1_zero1"]
        np.testing.assert_allclose(_losses(h0), _losses(zero1["history"]), rtol=2e-4)
        compare.append(zero1["state"])
    for name in final:
        assert torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]), name
        for want in compare:
            np.testing.assert_allclose(ranks[0]["state"][name].numpy(), want[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_fsdp_recompute_gathers_again(fsdp_run, tmp_path):
    """Gradient checkpointing under the "attn" policy: the recomputed
    regions read the parameters again (each access gathers), and the run
    is one process's with the same policy."""
    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.train.trainer import Trainer

    got = [r["stage1_remat"] for r in fsdp_run["ranks"]]
    assert _losses(got[0]["history"]) == _losses(got[1]["history"])
    model = llama.LlamaEncoder.for_training(workers.tiny_config(), fsdp_run["state"],
                                            device="cpu", compute_dtype=torch.float32,
                                            gradient_checkpointing=True,
                                            checkpoint_policy="attn")
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=workers.train_config(str(tmp_path), 4), total_steps=4)
    ds, make = workers.stage_parts("stage1")
    history = trainer.train(ds, make())
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(got[0]["history"], key), _losses(history, key),
                                   rtol=2e-4)
    for name, want in model.state_dict().items():
        np.testing.assert_allclose(got[0]["state"][name].numpy(), want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_fsdp_rank_holds_its_share(fsdp_run):
    """Between layers a rank stores its own tensors only: parameters and
    optimizer state each at most total / 2 plus the largest tensor's
    (the embedding), and the two ranks' parameters add up to the model."""
    state = fsdp_run["state"]
    total = sum(t.numel() * 4 for t in state.values())
    largest = max(t.numel() * 4 for t in state.values())
    held = [r["stage1"]["held"] for r in fsdp_run["ranks"]]
    assert sum(p for p, _ in held) == total
    for params, opt in held:
        assert 0 < params <= total / 2 + largest
        # AdamW: two fp32 moments per owned entry (and a step count each)
        assert opt <= 2 * (total / 2 + largest) + 4 * len(state)
    owners = fsdp_run["ranks"][0]["stage1"]["owners"]
    assert owners == fsdp_run["ranks"][1]["stage1"]["owners"] and set(owners) == {0, 1}


def test_fsdp_checkpoint_resumes_in_one_process(fsdp_run):
    """Rank 0 wrote checkpoint-2 and -4 in one process's layout: the
    weights gathered from their owners, the optimizer state gathered, bit
    for bit; one process resumes it and trains on."""
    from rankpo_tpu_torch.train.trainer import Trainer

    out = os.path.join(fsdp_run["out"], "fsdp", "stage1")
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4"]
    rank0 = fsdp_run["ranks"][0]["stage1"]
    payload = ckpt.load_opt_state(os.path.join(out, "checkpoint-4"))
    assert payload["step"] == payload["updates"] == 4
    _, weights = load_pretrained(os.path.join(out, "checkpoint-4"))
    assert list(weights) == list(rank0["state"])
    for name, value in rank0["state"].items():
        assert torch.equal(weights[name], value), name
    saved = payload["optimizer"]["state"]
    assert sorted(saved) == list(range(len(weights)))
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(rank0["optimizer"]["state"][i][key], value), (i, key)
    model = workers.model_from(weights)
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=workers.train_config(os.path.join(out, "resumed"), 4,
                                                  max_steps=6), total_steps=4)
    trainer.resume_from(os.path.join(out, "checkpoint-4"))
    state = trainer.optimizer.state_dict()["state"]
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(state[i][key], value), (i, key)
    ds, make = workers.stage_parts("stage1")
    history = trainer.train(ds, make())
    assert [h["global_step"] for h in history] == [5, 6]
    assert np.all(np.isfinite(_losses(history)))
