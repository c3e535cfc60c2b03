"""fsdp with a model axis (``--fsdp True --model_parallel 2``;
``parallel/fsdp.py`` over the data group of each model index, the
tensor-parallel bodies within each model group, the trainer's two-level
norm and checkpoints) against the JAX package's ``fsdp`` Trainer on a
(2 x 2) mesh and against the port in one process.

Four gloo processes (``torch_dist_workers.fsdp_grid_worker``, joined with
a timeout of their own) make a (2 x 2) grid and train the tiny llama (2
layers, width 64) on both stages with AdamW. Tolerances are the fsdp and
mp 2 tests' (``test_torch_fsdp.py``, ``test_torch_tensor_parallel.py``):
loss and gradient norm rtol 2e-4 against JAX and one process, the four
ranks' logs identical, the parameters after 4 steps atol 1e-6 against one
process. A rank stores at most half its model shard plus the shard's
largest tensor, of parameters and of optimizer state, and the grid's
checkpoint resumes in one process with its weights and optimizer state bit
for bit.
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
from rankpo_tpu_torch.parallel.sharding import tp_dim
from rankpo_tpu_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp_grid"))
    jcfg = jtiny(vocab_size=256)
    params = jinit(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), workers.tiny_config())
    workers.save(out, "grid_state.pt", state)
    workers.spawn(workers.fsdp_grid_worker, 4, out, timeout=240.0)
    return dict(out=out, jcfg=jcfg, params=params, state=state,
                ranks=[workers.load(out, f"fsdp_grid_{r}.pt") for r in range(4)])


def _losses(history, key="loss"):
    return [h[key] for h in history if key in h]


def _jax_fsdp_grid(stage, params, jcfg):
    """JAX's Trainer with ``fsdp`` on a (2 x 2) mesh, per-device batch 1
    (global 4), on the workers' rows and settings."""
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
                       per_device_train_batch_size=1, gradient_accumulation_steps=2,
                       max_steps=4, save_strategy="no", weight_decay=0.01, seed=3, fsdp=True,
                       model_parallel=2)
    jmesh = make_mesh(JMeshConfig(data_parallel=2, model_parallel=2), devices=jax.devices()[:4])
    return JTrainer(loss_fn=loss, params=params, mesh=jmesh, config=cfg,
                    total_steps=4).train(ds, coll)


def test_grid_groups(grid_run):
    for r, res in enumerate(grid_run["ranks"]):
        assert res["grid"] == (2, 2, *divmod(r, 2))


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_fsdp_grid_matches_jax_mesh_and_one_process(grid_run, stage, tmp_path):
    """Both stages at (2 x 2) with ``fsdp``: every rank logs the same; the
    losses and gradient norms against JAX's ``fsdp`` Trainer on a (2 x 2)
    mesh and one process on the same global batches; the gathered weights
    (the same on every rank) against one process's."""
    ranks = [r[stage] for r in grid_run["ranks"]]
    h0 = ranks[0]["history"]
    assert len(h0) == 4
    for r in ranks[1:]:
        for key in ("loss", "grad_norm", "learning_rate"):
            assert _losses(r["history"], key) == _losses(h0, key), key
    history, final, _, _ = workers.run_stage(stage, grid_run["state"], str(tmp_path), 4)
    jhist = _jax_fsdp_grid(stage, grid_run["params"], grid_run["jcfg"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(h0, key), _losses(history, key), rtol=2e-4)
        np.testing.assert_allclose(_losses(h0, key), _losses(jhist, key), rtol=2e-4)
    assert set(ranks[0]["state"]) == set(final)
    for name, want in final.items():
        for r in ranks[1:]:
            assert torch.equal(r["state"][name], ranks[0]["state"][name]), name
        np.testing.assert_allclose(ranks[0]["state"][name].numpy(), want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_fsdp_grid_rank_holds_half_its_shard(grid_run):
    """Each model rank's shards are partitioned over its data group: a
    rank stores at most half its model shard plus the shard's largest
    tensor, of parameters and of AdamW's state; the two ranks of a data
    group store the shard between them, and the shard is the whole model's
    split tensors halved."""
    state = grid_run["state"]
    for r, res in enumerate(grid_run["ranks"]):
        run = res["stage1"]
        sizes = [int(np.prod(s)) * 4 for s in run["shapes"]]
        shard, largest = sum(sizes), max(sizes)
        want = sum(t.numel() * 4 // (2 if tp_dim(n) is not None else 1)
                   for n, t in state.items())
        assert shard == want
        params, opt = run["held"]
        assert 0 < params <= shard / 2 + largest
        assert opt <= 2 * (shard / 2 + largest) + 4 * len(sizes)
        partner = grid_run["ranks"][(r + 2) % 4]["stage1"]
        assert params + partner["held"][0] == shard
        assert run["owners"] == partner["owners"] and set(run["owners"]) == {0, 1}


def test_fsdp_grid_checkpoint_resumes_in_one_process(grid_run):
    """Rank 0 wrote checkpoint-4 of stage 1 in one process's layout: the
    weights gathered from their owners and then over the model group, the
    optimizer state likewise, bit for bit; one process resumes it with that
    state and trains on."""
    from rankpo_tpu_torch.train.trainer import Trainer

    out = os.path.join(grid_run["out"], "fsdp_grid", "stage1")
    assert sorted(os.listdir(out)) == ["checkpoint-4"]
    rank0 = grid_run["ranks"][0]["stage1"]
    payload = ckpt.load_opt_state(os.path.join(out, "checkpoint-4"))
    assert payload["step"] == payload["updates"] == 4
    _, weights = load_pretrained(os.path.join(out, "checkpoint-4"))
    assert set(weights) == set(rank0["state"])
    for name, value in rank0["state"].items():
        assert torch.equal(weights[name], value), name
    model = workers.model_from(weights)
    names = [n for n, _ in model.named_parameters()]
    saved = payload["optimizer"]["state"]
    assert sorted(saved) == list(range(len(names)))
    for i, name in enumerate(names):
        assert saved[i]["exp_avg"].shape == weights[name].shape, name
        for key, value in saved[i].items():
            assert torch.equal(rank0["optimizer"]["state"][i][key], value), (name, key)
    assert all(r["stage1"]["optimizer"] is None for r in grid_run["ranks"][1:])
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=workers.train_config(os.path.join(out, "resumed"), 4,
                                                  max_steps=6), total_steps=4)
    trainer.resume_from(os.path.join(out, "checkpoint-4"))
    assert trainer.step == trainer.updates == 4
    state = trainer.optimizer.state_dict()["state"]
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(state[i][key], value), (i, key)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), weights[name]), name
    ds, make = workers.stage_parts("stage1")
    history = trainer.train(ds, make())
    assert [h["global_step"] for h in history] == [5, 6]
    assert np.all(np.isfinite(_losses(history)))
