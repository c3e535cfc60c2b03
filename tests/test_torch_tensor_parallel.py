"""Tensor parallelism of the PyTorch port (``core/mesh.py`` ``make_groups``,
``parallel/sharding.py``'s rules and model-axis sums, the bodies'
``tensor_parallel`` builds, the trainer's norm and checkpoints) against the
JAX package and against the port in one process.

Two gloo processes make one model group (dp 1, mp 2) and four make a
(2 x 2) grid (``torch_dist_workers.tp_worker`` / ``grid_worker``, each
joined with a timeout of its own), on the tiny bodies (2 layers, width 64).
Tolerances:

- the attention on each rank's heads, gathered, against JAX's
  ``multi_head_attention`` with its heads split over the model axis of the
  (4 x 2) mesh (``tests/test_flash_attention.py:161-192``): output atol
  2e-5, gradients atol 3e-4;
- each body's embedding loss and gathered parameter gradients against
  ``jax.grad`` of the unsplit JAX body (``tests/test_torch_roberta.py``'s
  bounds: loss rtol 1e-5, each gradient within 1e-4 of its norm) and
  against one process (loss rtol 1e-6, each gradient within 1e-5 of its
  norm: the split products sum in another order), with and
  without checkpointing under each policy; dropout draws one process's
  masks;
- the Trainer at mp 2 (and at 2 x 2) against JAX's Trainer on a (1 x 2)
  mesh and the port in one process on the same global batches: loss and
  gradient norm rtol 2e-4 (``test_torch_distributed.py``'s), the ranks' logs identical, the
  parameters after 4 AdamW steps atol 1e-6 against one process;
- an mp 2 checkpoint holds one process's layout and resumes at mp 1 with
  the gathered optimizer state bit for bit.
"""

import dataclasses
import functools
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
from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models.config import tiny_llama_config, tiny_qwen2_config, tiny_roberta_config
from rankpo_tpu.ops.attention import _xla_attention
from rankpo_tpu.ops.attention import multi_head_attention as jmha
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models.base import TensorParallel
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax
from rankpo_tpu_torch.parallel.sharding import (
    check_divisible,
    gather_state,
    shard_state,
    tp_dim,
)
from rankpo_tpu_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _attention_inputs(seed=0, b=4, s=16, hq=4, hkv=2, d=8, lens=(16, 10, 16, 12)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, mask


def _jcfg(body):
    if body == "llama":
        return tiny_llama_config(vocab_size=256)
    if body == "qwen2":
        return tiny_qwen2_config(vocab_size=256)
    cfg = tiny_roberta_config(vocab_size=256)
    if body == "xlm-roberta-dropout":
        cfg = dataclasses.replace(cfg, hidden_dropout=0.1, attention_dropout=0.1)
    return cfg


def _batch(cfg, lens, s, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (len(lens), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, cfg.pad_token_id).astype(np.int32)
    return ids, mask


def _body(body, seed=0):
    """(JAX config, params with noise on every tensor, port config, state,
    query batch, passage batch, dropout seed)."""
    jcfg = _jcfg(body)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.05, params)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    qb = _batch(jcfg, [9, 12, 4], 12, 2)
    pb = _batch(jcfg, [20, 16, 3, 11, 24, 8], 24, 3)
    seed_ = 7 if body.endswith("dropout") else None
    return jcfg, params, pcfg, params_from_jax(params, pcfg), qb, pb, seed_


def _torch_batch(b):
    return {"input_ids": torch.from_numpy(b[0]).long(),
            "attention_mask": torch.from_numpy(b[1])}


def _jax_model():
    jcfg = tiny_llama_config(vocab_size=256)
    params = jenc.init_params(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), workers.tiny_config())
    return jcfg, params, state


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    q, k, v, mask = _attention_inputs()
    bodies = {}
    for body in workers.TP_BODIES:
        _, _, pcfg, state, qb, pb, seed = _body(body)
        bodies[body] = (pcfg, state, _torch_batch(qb), _torch_batch(pb), seed)
    jcfg, params, state = _jax_model()
    workers.save(out, "tp_inputs.pt", {
        "attention": tuple(map(torch.from_numpy, (q, k, v, mask))), **bodies, "state": state})
    workers.spawn(workers.tp_worker, 2, out, timeout=200.0)
    ranks = [workers.load(out, f"tp_{r}.pt") for r in range(2)]
    return dict(out=out, ranks=ranks, jcfg=jcfg, params=params, state=state)


# ---------------------------------------------------------------------------
# without processes: the rules
# ---------------------------------------------------------------------------

def test_rules_split_the_megatron_layout():
    """Column-parallel weights and biases on dim 0 (torch's [out, in]),
    row-parallel weights on dim 1, their biases, embeddings and norms
    replicated; shards rejoin to the whole state."""
    cols = ["layers.0.self_attn.q_proj.weight", "layers.1.self_attn.k_proj.bias",
            "layers.0.self_attn.v_proj.weight", "layers.0.mlp.gate_proj.weight",
            "layers.0.mlp.up_proj.weight", "encoder.layer.0.attention.self.query.bias",
            "encoder.layer.0.attention.self.value.weight",
            "encoder.layer.1.intermediate.dense.weight",
            "encoder.layer.1.intermediate.dense.bias"]
    rows = ["layers.0.self_attn.o_proj.weight", "layers.0.mlp.down_proj.weight",
            "encoder.layer.0.attention.output.dense.weight",
            "encoder.layer.0.output.dense.weight"]
    repl = ["embed_tokens.weight", "norm.weight", "layers.0.input_layernorm.weight",
            "layers.0.self_attn.o_proj.bias", "encoder.layer.0.output.dense.bias",
            "encoder.layer.0.attention.output.LayerNorm.weight",
            "embeddings.word_embeddings.weight", "embeddings.LayerNorm.bias"]
    assert [tp_dim(n) for n in cols] == [0] * len(cols)
    assert [tp_dim(n) for n in rows] == [1] * len(rows)
    assert [tp_dim(n) for n in repl] == [None] * len(repl)
    _, _, pcfg, state, *_ = _body("qwen2")
    for mp in (1, 2, 4):
        parts = [shard_state(state, mp, i) for i in range(mp)]
        for name, t in state.items():
            dim = tp_dim(name)
            got = torch.cat([p[name] for p in parts], dim) if dim is not None else parts[0][name]
            assert torch.equal(got, t), name


def test_indivisible_heads_raise_at_build():
    """The port refuses what JAX would replicate: a model axis that does not
    divide the query heads, the kv heads or the MLP width."""
    _, _, pcfg, state, *_ = _body("llama")
    check_divisible(pcfg, 2)
    for mp in (3, 4):  # 4 heads / 2 kv heads / 128 columns
        with pytest.raises(ValueError, match="does not divide"):
            check_divisible(pcfg, mp)
        with pytest.raises(ValueError, match="num_key_value_heads|num_attention_heads"):
            penc.encoder_class(pcfg).for_training(
                pcfg, state, device="cpu", tensor_parallel=TensorParallel(None, mp, 0))


def test_groups_of_one_without_a_process_group():
    """No process group: the grid is (1, 1) with groups of one, and a model
    axis of 2 raises JAX's device-count error."""
    grid = mesh.make_groups(mesh.MeshConfig())
    assert (grid.dp, grid.mp, grid.data, grid.model) == (1, 1, None, None)
    assert mesh.data_count() == mesh.model_count() == 1
    assert TensorParallel.current() is None
    with pytest.raises(ValueError, match="model_parallel=2 does not divide device count 1"):
        mesh.make_groups(mesh.MeshConfig(model_parallel=2))


# ---------------------------------------------------------------------------
# two processes: attention, bodies, trainer
# ---------------------------------------------------------------------------

def test_grid_of_two_is_one_model_group(tp_run):
    assert [r["grid"] for r in tp_run["ranks"]] == [(1, 2, 0, 0), (1, 2, 0, 1)]


def test_attention_on_split_heads_matches_jax(tp_run, mesh8):
    """Each rank's heads through the plain attention, gathered over the
    model group, against JAX's ``multi_head_attention`` split over the model
    axis by ``shard_map`` and the XLA oracle on global arrays."""
    q, k, v, mask = map(jnp.asarray, _attention_inputs())
    ref = _xla_attention(q, k, v, mask, True)
    out = jmha(q, k, v, mask=mask, causal=True, impl="flash", mesh=mesh8)

    def loss_tp(q, k, v):
        return jnp.sum(jnp.square(jmha(q, k, v, mask=mask, causal=True, impl="flash",
                                       mesh=mesh8)))

    grads = jax.grad(loss_tp, argnums=(0, 1, 2))(q, k, v)
    for r in tp_run["ranks"]:
        got = r["attention"]
        np.testing.assert_allclose(got[0].numpy(), np.asarray(out), atol=2e-5)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=2e-5)
        for name, g, want in zip("qkv", got[1:], grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=3e-4,
                                       err_msg=f"d{name}")


def _jax_loss(params, cfg, qb, pb):
    q = jenc.embed(params, cfg, {"input_ids": jnp.asarray(qb[0]),
                                 "attention_mask": jnp.asarray(qb[1])},
                   compute_dtype=jnp.float32)
    p = jenc.embed(params, cfg, {"input_ids": jnp.asarray(pb[0]),
                                 "attention_mask": jnp.asarray(pb[1])},
                   compute_dtype=jnp.float32)
    logits = q @ p.T / 0.05
    return -jnp.mean(jax.nn.log_softmax(logits, axis=-1)[jnp.arange(q.shape[0]),
                                                          jnp.arange(q.shape[0]) * 2])


@functools.lru_cache(maxsize=None)
def _jax_grads(body):
    """JAX's loss and gradients (HF-named) of the unsplit body, once per
    body."""
    jcfg, params, pcfg, _, qb, pb, _ = _body(body)
    jloss, jgrads = jax.value_and_grad(_jax_loss)(params, jcfg, qb, pb)
    return float(jloss), params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), pcfg)


@pytest.mark.parametrize("policy", [None, *workers.TP_POLICIES])
@pytest.mark.parametrize("body", workers.TP_BODIES)
def test_split_body_matches_one_process_and_jax(tp_run, body, policy):
    """The body split over two ranks: its loss and its gradients, gathered
    to the one-process layout, against the unsplit body in one process
    (the same dropout masks where dropout is live) and, without dropout,
    against ``jax.grad`` of the JAX body."""
    jcfg, params, pcfg, state, qb, pb, seed = _body(body)
    model = penc.encoder_class(pcfg).for_training(
        pcfg, state, device="cpu", compute_dtype=torch.float32,
        gradient_checkpointing=policy is not None, checkpoint_policy=policy or "full")
    loss = workers.tp_embed_loss(model, _torch_batch(qb), _torch_batch(pb), seed)
    loss.backward()
    one = {n: p.grad for n, p in model.named_parameters()}
    got = [r[(body, policy)] for r in tp_run["ranks"]]
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    np.testing.assert_allclose(got[0]["loss"].item(), loss.item(), rtol=1e-6)
    # the key bias's gradient is zero up to rounding (it adds one constant
    # to every logit of a row): a floor of 1e-8 of the global norm, as in
    # tests/test_torch_roberta.py
    floor = 1e-8 * np.sqrt(sum(np.sum(g.numpy() ** 2) for g in one.values()))
    for name, g in one.items():
        err = np.linalg.norm(got[0]["grads"][name].numpy() - g.numpy())
        assert err <= 1e-5 * np.linalg.norm(g.numpy()) + floor, (name, err)
    if seed is not None:
        return
    jloss, ref = _jax_grads(body)
    np.testing.assert_allclose(got[0]["loss"].item(), jloss, rtol=1e-5)
    floor = 1e-8 * np.sqrt(sum(np.sum(r.numpy() ** 2) for r in ref.values()))
    for name, r in ref.items():
        err = np.linalg.norm(got[0]["grads"][name].numpy() - r.numpy())
        assert err <= 1e-4 * np.linalg.norm(r.numpy()) + floor, (name, err)


def _losses(history, key="loss"):
    return [h[key] for h in history if key in h]


def _jax_stage(stage, params, jcfg, model_parallel=2, per_device=2):
    """JAX's Trainer on a (1 x model_parallel) mesh on the workers' rows and
    settings; stage 2 against the frozen initial weights."""
    tok = JHashTokenizer(vocab_size=256)
    if stage == "stage1":
        ds = jdata.ContrastiveDataset(workers.contrastive_rows(32), tok, 12, 16)
        coll = jcoll.ContrastiveCollator(0, 3, 12, 16, seed=3)
        loss = jcontrastive(jcfg, compute_dtype=jnp.float32, **workers.STAGE1_LOSS)
    else:
        ds = jdata.PairPreferenceDataset(workers.pair_rows(32), tok, 12, 16)
        coll = jcoll.RankPOCollator(0, 12, 16)
        loss = jrankpo(jcfg, compute_dtype=jnp.float32, reference_free=False,
                       ref_params=params, **workers.STAGE2_LOSS)
    cfg = JTrainConfig(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                       per_device_train_batch_size=per_device, gradient_accumulation_steps=2,
                       max_steps=4, save_strategy="no", weight_decay=0.01, seed=3,
                       model_parallel=model_parallel)
    jmesh = make_mesh(JMeshConfig(data_parallel=1, model_parallel=model_parallel),
                      devices=jax.devices()[:model_parallel])
    return JTrainer(loss_fn=loss, params=params, mesh=jmesh, config=cfg,
                    total_steps=4).train(ds, coll)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_trainer_at_mp2_matches_one_process_and_jax_mesh(tp_run, stage, tmp_path):
    """Stage 1, and stage 2 against a frozen reference split like the
    model, at mp 2 against the port in one process and JAX's Trainer on a
    (1 x 2) mesh: every step's loss and gradient norm, the final weights."""
    ranks = [r[stage] for r in tp_run["ranks"]]
    h0, h1 = ranks[0]["history"], ranks[1]["history"]
    assert len(h0) == 4
    for key in ("loss", "grad_norm", "learning_rate"):
        assert _losses(h0, key) == _losses(h1, key), key
    ref = tp_run["state"] if stage == "stage2" else None
    history, final, _, _ = workers.run_stage(stage, tp_run["state"], str(tmp_path), 4,
                                             ref_state=ref)
    jhist = _jax_stage(stage, tp_run["params"], tp_run["jcfg"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(h0, key), _losses(history, key), rtol=2e-4)
        np.testing.assert_allclose(_losses(h0, key), _losses(jhist, key), rtol=2e-4)
    for name, want in final.items():
        assert torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]), name
        np.testing.assert_allclose(ranks[0]["state"][name].numpy(), want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_mp2_checkpoint_resumes_in_one_process(tp_run):
    """Rank 0 wrote checkpoint-2 and -4 of the mp 2 stage 1 in one
    process's layout: its weights are the gathered shards, its optimizer
    state the gathered state, bit for bit; one process resumes from it with
    that state and trains on."""
    from rankpo_tpu_torch.train.trainer import Trainer

    out = os.path.join(tp_run["out"], "tp", "stage1")
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4"]
    rank0 = tp_run["ranks"][0]["stage1"]
    payload = ckpt.load_opt_state(os.path.join(out, "checkpoint-4"))
    assert payload["step"] == payload["updates"] == 4
    _, weights = load_pretrained(os.path.join(out, "checkpoint-4"))
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
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=workers.train_config(os.path.join(out, "resumed"), 4,
                                                  max_steps=6), total_steps=4)
    trainer.resume_from(os.path.join(out, "checkpoint-4"))
    assert trainer.step == trainer.updates == 4
    state = trainer.optimizer.state_dict()["state"]
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(state[i][key], value), (i, key)
    ds, make = workers.stage_parts("stage1")
    history = trainer.train(ds, make())
    assert [h["global_step"] for h in history] == [5, 6]
    assert np.all(np.isfinite(_losses(history)))


# ---------------------------------------------------------------------------
# four processes: the (2 x 2) grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("grid"))
    jcfg, params, state = _jax_model()
    workers.save(out, "grid_state.pt", state)
    workers.spawn(workers.grid_worker, 4, out, timeout=200.0)
    return dict(out=out, state=state, ranks=[workers.load(out, f"grid_{r}.pt")
                                             for r in range(4)])


def test_grid_layout_puts_the_model_axis_innermost(grid_run):
    """Rank r = d * 2 + m: data index d, model index m; the model group of
    d holds ranks 2d and 2d + 1, the data group of m ranks m and 2 + m."""
    for r, res in enumerate(grid_run["ranks"]):
        d, m = divmod(r, 2)
        assert res["grid"] == (2, 2, d, m)
        assert res["sums"] == [float(4 * d + 1), float(2 * m + 2)]


def test_grid_trainer_matches_one_process(grid_run, tmp_path):
    """Stage 1 at (2 x 2) (cross-device negatives and ZeRO-1 over the data
    group, each model group split) against one process on the same global
    batches; every rank logs the same; the gathered optimizer state is the
    checkpoint's and has one process's shapes."""
    ranks = grid_run["ranks"]
    history, final, _, _ = workers.run_stage("stage1", grid_run["state"], str(tmp_path), 4)
    for r in ranks[1:]:
        assert _losses(r["history"]) == _losses(ranks[0]["history"])
        assert _losses(r["history"], "grad_norm") == _losses(ranks[0]["history"], "grad_norm")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(ranks[0]["history"], key), _losses(history, key),
                                   rtol=2e-4)
    for name, want in final.items():
        for r in ranks[1:]:
            assert torch.equal(r["state"][name], ranks[0]["state"][name]), name
        np.testing.assert_allclose(ranks[0]["state"][name].numpy(), want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    payload = ckpt.load_opt_state(os.path.join(grid_run["out"], "grid", "stage1",
                                               "checkpoint-4"))
    gathered = ranks[0]["optimizer"]["state"]
    assert sorted(payload["optimizer"]["state"]) == sorted(gathered)
    names = list(final)
    for i, entry in gathered.items():
        assert entry["exp_avg"].shape == final[names[i]].shape
        for key, value in entry.items():
            assert torch.equal(payload["optimizer"]["state"][i][key], value), (i, key)
    assert all(r["optimizer"] is None for r in ranks[1:])


def test_gather_state_of_one_is_the_state():
    state = {"layers.0.self_attn.q_proj.weight": torch.arange(6.0).reshape(3, 2)}
    assert gather_state(state, None) == state


# ---------------------------------------------------------------------------
# the CLIs as two processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("cli", ["run_contrastive", "run_rankpo"])
def test_cli_with_model_parallel_2_matches_one_process(tmp_path, cli):
    """``run_contrastive`` / ``run_rankpo --reference_free False`` started
    twice with ``--model_parallel 2`` and the three flags (gloo on the
    CPU): both ranks train, rank 0 alone writes the model in one process's
    layout, and its history is the one-process CLI's (rtol 2e-4) and each
    tensor's update within 1e-3 of it, on the same global batch (per
    device 2 over two devices, as JAX counts every device)."""
    import importlib
    import json
    import subprocess

    from rankpo_tpu_torch.models.hf_io import save_pretrained

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = tmp_path / "base"
    save_pretrained(str(base), workers.tiny_config(), _jax_model()[2])
    data = tmp_path / "train.jsonl"
    rows = workers.contrastive_rows(16) if cli == "run_contrastive" else workers.pair_rows(16)
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model_name_or_path", str(base), "--tokenizer_name", "hash:256",
              "--train_data", str(data), "--device", "cpu", "--bf16", "False",
              "--max_query_length", "12", "--max_passage_length", "16", "--max_steps", "2",
              "--learning_rate", "1e-3", "--save_strategy", "no", "--log_level", "warning"]
    if cli == "run_contrastive":
        common += ["--num_negatives", "3", "--negatives_cross_device", "True"]
    else:
        common += ["--reference_free", "False", "--sft_weight", "0.1"]
    port = _free_port()
    outs = [tmp_path / "rank0", tmp_path / "rank1"]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"rankpo_tpu_torch.cli.{cli}", *common, "--output_dir",
         str(outs[rank]), "--per_device_train_batch_size", "2", "--model_parallel", "2",
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(rank)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    assert not outs[1].exists()
    history = json.loads((outs[0] / "trainer_history.json").read_text())
    main = importlib.import_module(f"rankpo_tpu_torch.cli.{cli}").main
    one = main([*common, "--output_dir", str(tmp_path / "one"),
                "--per_device_train_batch_size", "4"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(history, key), _losses(one, key), rtol=2e-4)
    _, got = load_pretrained(str(outs[0]))
    _, want = load_pretrained(str(tmp_path / "one"))
    _, start = load_pretrained(str(base))
    assert set(got) == set(want)
    # each tensor's update within 1e-3 of one process's: an entry whose
    # gradient is zero up to rounding (a pad token's embedding row) takes
    # an AdamW step of up to lr * |g| / (|g| + eps) from that rounding alone
    for name, value in want.items():
        gap = np.linalg.norm(got[name].numpy() - value.numpy())
        moved = np.linalg.norm(value.numpy() - start[name].numpy())
        assert gap <= 1e-3 * moved + 1e-7, (name, gap, moved)


def test_tensor_parallel_refuses_what_it_does_not_take(monkeypatch, tmp_path):
    """Under a model axis the trainer takes AdamW for the split tensors
    only (the 8-bit blocks and Adafactor's factored moments of a shard are
    not the whole tensor's; JAX fails there too,
    ``test_torch_lora_sharded.py``) and LoRA with any optimizer (its
    adapters are whole on every model rank); ``run_rankpo --use_lora
    --model_parallel 2`` is no longer refused and meets the grid's
    device-count check in one process."""
    from rankpo_tpu_torch.cli import run_rankpo
    from rankpo_tpu_torch.models import lora
    from rankpo_tpu_torch.train.config import TrainConfig
    from rankpo_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(mesh, "model_count", lambda: 2)
    _, _, pcfg, state, *_ = _body("llama")
    for optim in ("adamw8bit", "adafactor"):
        model = penc.encoder_class(pcfg).for_training(
            pcfg, state, device="cpu", tensor_parallel=TensorParallel(None, 2, 0))
        with pytest.raises(NotImplementedError, match="JAX package raises IndexError"):
            Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                    config=TrainConfig(device="cpu", optim=optim), total_steps=1)
        model = penc.encoder_class(pcfg).for_training(
            pcfg, state, device="cpu", tensor_parallel=TensorParallel(None, 2, 0))
        lora.apply_lora(model, lora.LoraConfig(r=2, alpha=4, target_modules=("q_proj",)),
                        adapters={"q_proj": (torch.zeros(2, 64, 2), torch.zeros(2, 2, 64))})
        trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                          config=TrainConfig(device="cpu", optim=optim), total_steps=1)
        assert trainer._tp_dims == [None, None, None, None]
        # each rank's q_proj merge is its half of the output rows
        merged = model.layers[0].self_attn.q_proj.weight
        assert merged.shape == (32, 64)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="does not divide device count 1"):
        run_rankpo.main(["--model_name_or_path", str(tmp_path), "--train_data", "x.jsonl",
                         "--output_dir", str(tmp_path / "out"), "--use_lora", "True",
                         "--model_parallel", "2", "--device", "cpu"])
