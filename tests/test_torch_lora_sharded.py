"""LoRA under a model axis and under fsdp (``models/lora.py``,
``parallel/fsdp.py``, the trainer's norm and checkpoints) against the JAX
package and the port in one process, and the one optimizer refusal on a
split model, held to the JAX package's own failure.

Two gloo processes (``torch_dist_workers.sharded_lora_worker``, joined
with a timeout of its own) first make one model group (dp 1, mp 2), then
one data group (dp 2, mp 1), on the tiny bodies (2 layers, width 64).
The adapters are JAX's (``init_lora_params``, carried over by
``lora.adapters_from_jax``). Tolerances:

- each body's embedding loss and adapter gradients with LoRA on every
  target of the body (the seven of the llama body, the six of
  XLM-Roberta, so both column- and row-parallel slices) against the port
  in one process (loss rtol 1e-6, each gradient within 1e-5 of its norm)
  and ``jax.grad`` of JAX's merged body (loss rtol 1e-5, each gradient
  within 1e-4 of its norm): ``test_torch_tensor_parallel.py``'s bounds;
- the Trainer with LoRA at mp 2 on stage 2 against JAX's Trainer with
  ``frozen_params={"base": ...}`` on a (1 x 2) mesh and the port in one
  process on the same global batches: AdamW's losses and gradient norms
  rtol 2e-4 and adapters atol 1e-6 (the mp 2 gates); Adafactor's whole
  trace (``test_torch_train.assert_trace_matches``); the 8-bit AdamW's
  steps 1-2 at the trace's tolerances, then losses rtol 3e-3
  (``test_torch_optim.test_trainer_trace_matches_jax_per_optimizer``'s
  rule), and its adapters within twice the learning rates of steps 3-4
  (a moment on a code boundary rounds to the neighbouring code under a
  rounding-sized gradient difference, and an update is about one learning
  rate); both ranks' adapters bit-equal, the merged model one process's
  within the adapters' tolerance times their scale;
- LoRA under fsdp at dp 2, both stages, against JAX's ``fsdp`` LoRA
  Trainer on a 2-device data mesh and one process: rtol 2e-4, adapters
  atol 1e-6; each rank stores at most half the adapters plus the largest;
- each layout's checkpoint holds one process's layout and resumes in one
  process with its optimizer state bit for bit.
"""

import dataclasses
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
from rankpo_tpu.models.config import tiny_llama_config, tiny_roberta_config
from rankpo_tpu.models.lora import LoraConfig as JLoraConfig
from rankpo_tpu.models.lora import init_lora_params, make_lora_loss_fn
from rankpo_tpu.models.lora import merge_lora as jmerge
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models import lora
from rankpo_tpu_torch.models.base import TensorParallel
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax
from rankpo_tpu_torch.train import checkpoint as ckpt
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
from test_torch_train import assert_trace_matches  # noqa: E402

torch.set_num_threads(2)

# the Trainer runs: column-parallel (q, v) and row-parallel (o, down)
TARGETS = ("q_proj", "v_proj", "o_proj", "down_proj")
BODY_TARGETS = {"llama": tuple(lora._LLAMA_TARGETS), "xlm-roberta": tuple(lora._ROBERTA_TARGETS)}
SCALING = workers.LORA["alpha"] / workers.LORA["r"]


def _jcfg(body):
    return tiny_llama_config(vocab_size=256) if body == "llama" else \
        tiny_roberta_config(vocab_size=256)


def _batch(cfg, lens, s, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (len(lens), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, cfg.pad_token_id).astype(np.int32), mask


def _torch_batch(b):
    return {"input_ids": torch.from_numpy(b[0]).long(),
            "attention_mask": torch.from_numpy(b[1])}


def _lora_tree(params, targets, seed=1, trained=False):
    """JAX's adapters; ``trained``: a B drawn from numpy, so the merge and
    A's gradient are not zero."""
    tree = init_lora_params(jax.random.key(seed), params,
                            JLoraConfig(target_modules=targets, **workers.LORA))
    rng = np.random.default_rng(seed + 10)
    return {name: {"lora_a": np.asarray(ab["lora_a"]),
                   "lora_b": (rng.normal(0, 0.1, ab["lora_b"].shape).astype(np.float32)
                              if trained else np.asarray(ab["lora_b"]))}
            for name, ab in tree.items()}


def _body(body):
    """(JAX config, params, port config, state, query batch, passage
    batch, adapter tree)."""
    jcfg = _jcfg(body)
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(0), jcfg))
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    qb, pb = _batch(jcfg, [9, 12, 4], 12, 2), _batch(jcfg, [20, 16, 3, 11, 24, 8], 24, 3)
    return (jcfg, params, pcfg, params_from_jax(params, pcfg), qb, pb,
            _lora_tree(params, BODY_TARGETS[body], trained=True))


def _jax_model():
    jcfg = tiny_llama_config(vocab_size=256)
    params = jenc.init_params(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), workers.tiny_config())
    return jcfg, params, state, _lora_tree(params, TARGETS)


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_lora"))
    bodies = {}
    for body in BODY_TARGETS:
        _, _, pcfg, state, qb, pb, tree = _body(body)
        bodies[body] = (pcfg, state, _torch_batch(qb), _torch_batch(pb),
                        lora.adapters_from_jax(tree), BODY_TARGETS[body])
    jcfg, params, state, tree = _jax_model()
    workers.save(out, "lora_inputs.pt", {"state": state, "adapters": lora.adapters_from_jax(tree),
                                         "targets": TARGETS, "bodies": bodies})
    workers.spawn(workers.sharded_lora_worker, 2, out, timeout=240.0)
    return dict(out=out, jcfg=jcfg, params=params, state=state, tree=tree,
                ranks=[workers.load(out, f"sharded_lora_{r}.pt") for r in range(2)])


# ---------------------------------------------------------------------------
# the port in one process and the JAX package, each run once
# ---------------------------------------------------------------------------

_ONE = {}


def _one_process(lora_run, stage, optim, tmp_path_factory):
    """The port's LoRA run in one process (global batch 4), once per
    (stage, optimizer): (history, whole adapters, merged model)."""
    key = (stage, optim)
    if key not in _ONE:
        out = str(tmp_path_factory.mktemp("one"))
        history, trainer = workers.run_lora_stage(
            stage, lora_run["state"], lora.adapters_from_jax(lora_run["tree"]), TARGETS, out, 4,
            optim=optim)
        _ONE[key] = (history, lora.adapter_state_dict(trainer.model),
                     lora.merged_state_dict(trainer.model))
    return _ONE[key]


def _jax_lora(lora_run, stage, optim="adamw", model_parallel=1, data_parallel=1):
    """JAX's Trainer on the adapters over the frozen base
    (``frozen_params={"base": ...}``, as its ``run_rankpo --use_lora``) on
    a (data_parallel x model_parallel) mesh, ``fsdp`` with a data axis:
    (history, adapters under the port's names)."""
    jcfg, params = lora_run["jcfg"], lora_run["params"]
    tok = JHashTokenizer(vocab_size=256)
    if stage == "stage1":
        ds = jdata.ContrastiveDataset(workers.contrastive_rows(32), tok, 12, 16)
        coll = jcoll.ContrastiveCollator(0, 3, 12, 16, seed=3)
        inner = jcontrastive(jcfg, compute_dtype=jnp.float32, **workers.STAGE1_LOSS)
    else:
        ds = jdata.PairPreferenceDataset(workers.pair_rows(32), tok, 12, 16)
        coll = jcoll.RankPOCollator(0, 12, 16)
        inner = jrankpo(jcfg, compute_dtype=jnp.float32, **workers.STAGE2_LOSS)
    lcfg = JLoraConfig(target_modules=TARGETS, **workers.LORA)
    devices = data_parallel * model_parallel
    cfg = JTrainConfig(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                       per_device_train_batch_size=4 // devices, gradient_accumulation_steps=2,
                       max_steps=4, save_strategy="no", weight_decay=0.01, seed=3, optim=optim,
                       model_parallel=model_parallel, fsdp=data_parallel > 1)
    jmesh = make_mesh(JMeshConfig(data_parallel=data_parallel, model_parallel=model_parallel),
                      devices=jax.devices()[:devices])
    trainer = JTrainer(loss_fn=make_lora_loss_fn(inner, params, lcfg),
                       params={k: {n: jnp.asarray(v) for n, v in ab.items()}
                               for k, ab in lora_run["tree"].items()},
                       mesh=jmesh, config=cfg, total_steps=4, frozen_params={"base": params})
    history = trainer.train(ds, coll)
    return history, _port_adapters(jax.tree_util.tree_map(np.asarray, trainer.state.params))


def _port_adapters(tree) -> dict:
    out = {}
    for name, ab in tree.items():
        for i in range(ab["lora_a"].shape[0]):
            path = f"layers.{i}.{lora._LLAMA_TARGETS[name]}"
            out[f"{path}.lora_a"] = torch.from_numpy(np.array(ab["lora_a"][i]))
            out[f"{path}.lora_b"] = torch.from_numpy(np.array(ab["lora_b"][i]))
    return out


def _losses(history, key="loss"):
    return [h[key] for h in history if key in h]


def _close(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=atol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the bodies at mp 2
# ---------------------------------------------------------------------------

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


def _grads_within(got: dict, want: dict, rel: float) -> None:
    floor = 1e-8 * np.sqrt(sum(np.sum(g.numpy() ** 2) for g in want.values()))
    assert set(got) == set(want)
    for name, g in want.items():
        err = np.linalg.norm(got[name].numpy() - g.numpy())
        assert err <= rel * np.linalg.norm(g.numpy()) + floor, (name, err)


@pytest.mark.parametrize("body", list(BODY_TARGETS))
def test_split_body_adapters_match_one_process_and_jax(lora_run, body):
    """LoRA on every target of the body split over two ranks: the loss,
    each whole adapter's gradient (the same on both ranks) and the merged
    model, against the unsplit body in one process and, for the loss and
    gradients, ``jax.grad`` of JAX's loss over ``merge_lora``."""
    jcfg, params, pcfg, state, qb, pb, tree = _body(body)
    model = penc.encoder_class(pcfg).for_training(pcfg, state, device="cpu",
                                                  compute_dtype=torch.float32)
    lora.apply_lora(model, lora.LoraConfig(target_modules=BODY_TARGETS[body], **workers.LORA),
                    adapters=lora.adapters_from_jax(tree))
    loss = workers.tp_embed_loss(model, _torch_batch(qb), _torch_batch(pb))
    loss.backward()
    one = workers.adapter_grads(model)
    got = [r[("body", body)] for r in lora_run["ranks"]]
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    for name in one:
        assert torch.equal(got[0]["grads"][name], got[1]["grads"][name]), name
    np.testing.assert_allclose(got[0]["loss"].item(), loss.item(), rtol=1e-6)
    _grads_within(got[0]["grads"], one, 1e-5)
    _close(got[0]["merged"], lora.merged_state_dict(model), 1e-6)
    lcfg = JLoraConfig(target_modules=BODY_TARGETS[body], **workers.LORA)
    jloss, jgrads = jax.value_and_grad(
        lambda t: _jax_loss(jmerge(params, t, lcfg), jcfg, qb, pb))(tree)
    np.testing.assert_allclose(got[0]["loss"].item(), float(jloss), rtol=1e-5)
    want = {}
    layers = "layers" if body == "llama" else "encoder.layer"
    table = lora._LLAMA_TARGETS if body == "llama" else lora._ROBERTA_TARGETS
    for name, ab in jgrads.items():
        for i in range(pcfg.num_hidden_layers):
            for key in ("lora_a", "lora_b"):
                want[f"{layers}.{i}.{table[name]}.{key}"] = torch.from_numpy(
                    np.array(ab[key][i]))
    _grads_within(got[0]["grads"], want, 1e-4)


# ---------------------------------------------------------------------------
# the Trainer with LoRA at mp 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optim", workers.LORA_OPTIMIZERS)
def test_lora_at_mp2_matches_jax_mesh_and_one_process(lora_run, optim, tmp_path_factory):
    """Stage 2 with LoRA (column- and row-parallel targets) at mp 2 with
    each optimizer against JAX's LoRA Trainer on a (1 x 2) mesh and the
    port in one process: the histories, the adapters, the merged model."""
    ranks = [r[("mp2", optim)] for r in lora_run["ranks"]]
    h0 = ranks[0]["history"]
    assert len(h0) == 4
    for key in ("loss", "grad_norm", "learning_rate"):
        assert _losses(h0, key) == _losses(ranks[1]["history"], key), key
    for name, value in ranks[0]["adapters"].items():
        assert torch.equal(value, ranks[1]["adapters"][name]), name
    for name, value in ranks[0]["merged"].items():
        assert torch.equal(value, ranks[1]["merged"][name]), name
    history, adapters, merged = _one_process(lora_run, "stage2", optim, tmp_path_factory)
    jhist, jadapters = _jax_lora(lora_run, "stage2", optim, model_parallel=2)
    for want_hist, want in ((jhist, jadapters), (history, adapters)):
        if optim == "adamw":
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(_losses(h0, key), _losses(want_hist, key),
                                           rtol=2e-4)
            _close(ranks[0]["adapters"], want, 1e-6)
        elif optim == "adafactor":
            assert_trace_matches(want_hist, h0, want, ranks[0]["adapters"])
        else:
            assert_trace_matches(want_hist[:2], h0[:2], {}, {}, steps=2)
            for j, p in zip(want_hist[2:], h0[2:]):
                np.testing.assert_allclose(p["loss"], j["loss"], rtol=3e-3)
                np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-3)
            _close(ranks[0]["adapters"], want, _later_steps(h0))
    atol = {"adamw": 1e-6, "adafactor": 5e-6, "adamw8bit": _later_steps(h0)}[optim]
    # the merge moves a weight by scaling * A @ B: r terms of the adapters'
    # gap times their size
    _close(ranks[0]["merged"], merged, atol * SCALING * workers.LORA["r"])


def _later_steps(history) -> float:
    """The 8-bit AdamW's bound on an adapter's gap after step 2: an update
    moves a coordinate by about one learning rate at most, and a moment
    rounded to the neighbouring code can at most turn it round, so twice
    the learning rates of steps 3 on."""
    return 2 * sum(h["learning_rate"] for h in history[2:])


def test_lora_mp2_checkpoint_resumes_in_one_process(lora_run):
    """Rank 0 wrote the AdamW run's checkpoint-4: the merged model and the
    whole adapters gathered, the adapters' optimizer state (replicated,
    passed whole) bit for bit; one process resumes it with that state."""
    _check_lora_checkpoint(lora_run, os.path.join("lora_mp2", "adamw"),
                           lora_run["ranks"][0][("mp2", "adamw")], "stage2")


def _check_lora_checkpoint(lora_run, run_dir, rank0, stage):
    out = os.path.join(lora_run["out"], run_dir)
    directory = os.path.join(out, "checkpoint-4")
    assert sorted(os.listdir(out)) == ["checkpoint-4"]
    _, weights = load_pretrained(directory)
    for name, value in rank0["merged"].items():
        assert torch.equal(weights[name], value), name
    saved_adapters = torch.load(os.path.join(directory, "lora_adapters.pt"))
    for name, value in rank0["adapters"].items():
        assert torch.equal(saved_adapters[name], value), name
    payload = ckpt.load_opt_state(directory)
    assert payload["step"] == payload["updates"] == 4
    saved = payload["optimizer"]["state"]
    assert sorted(saved) == list(range(len(rank0["adapters"])))
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(rank0["optimizer"]["state"][i][key], value), (i, key)
    # JAX's rule: the checkpoint's merged weights are the base, the
    # adapters start afresh, their optimizer state comes back
    model = workers.lora_model_from(weights, lora.adapters_from_jax(lora_run["tree"]), TARGETS)
    trainer = Trainer(loss_fn=workers.loss_fn_for(stage), model=model,
                      config=workers.train_config(os.path.join(out, "resumed"), 4,
                                                  max_steps=6), total_steps=4)
    trainer.resume_from(directory)
    assert trainer.step == trainer.updates == 4
    state = trainer.optimizer.state_dict()["state"]
    for i, entry in saved.items():
        for key, value in entry.items():
            assert torch.equal(state[i][key], value), (i, key)
    ds, make = workers.stage_parts(stage)
    history = trainer.train(ds, make())
    assert [h["global_step"] for h in history] == [5, 6]
    assert np.all(np.isfinite(_losses(history)))


# ---------------------------------------------------------------------------
# LoRA under fsdp at dp 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_fsdp_over_lora_matches_jax_and_one_process(lora_run, stage, tmp_path_factory):
    """fsdp shards the adapters alone (the base stays whole on both ranks):
    both stages against JAX's ``fsdp`` LoRA Trainer on a 2-device data mesh
    and one process; each rank stores at most half the adapters plus the
    largest."""
    ranks = [r[("fsdp", stage)] for r in lora_run["ranks"]]
    h0 = ranks[0]["history"]
    assert len(h0) == 4
    for key in ("loss", "grad_norm", "learning_rate"):
        assert _losses(h0, key) == _losses(ranks[1]["history"], key), key
    history, adapters, merged = _one_process(lora_run, stage, "adamw", tmp_path_factory)
    jhist, jadapters = _jax_lora(lora_run, stage, data_parallel=2)
    for want_hist, want in ((jhist, jadapters), (history, adapters)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(_losses(h0, key), _losses(want_hist, key), rtol=2e-4)
        _close(ranks[0]["adapters"], want, 1e-6)
    for name, value in ranks[0]["adapters"].items():
        assert torch.equal(value, ranks[1]["adapters"][name]), name
    _close(ranks[0]["merged"], merged, 1e-6 * SCALING * workers.LORA["r"])
    sizes = [t.numel() * t.element_size() for t in adapters.values()]
    held = [r["held"] for r in ranks]
    assert sum(p for p, _ in held) == sum(sizes)
    for params, opt in held:
        assert 0 < params <= sum(sizes) / 2 + max(sizes)
        assert opt <= 2 * (sum(sizes) / 2 + max(sizes)) + 4 * len(sizes)


def test_fsdp_lora_checkpoint_resumes_in_one_process(lora_run):
    """The fsdp LoRA run's checkpoint-4: the adapters gathered from their
    owners, merged and written whole, the optimizer state gathered, bit for
    bit; one process resumes it."""
    _check_lora_checkpoint(lora_run, os.path.join("lora_fsdp", "stage2"),
                           lora_run["ranks"][0][("fsdp", "stage2")], "stage2")


# ---------------------------------------------------------------------------
# the refusal that stays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optim", ["adamw8bit", "adafactor"])
def test_split_model_optimizer_refusal_is_jax_own_failure(monkeypatch, optim):
    """The 8-bit AdamW and Adafactor on a split model: JAX's Trainer on a
    (1 x 2) mesh raises ``IndexError`` (``param_partition_specs`` indexes a
    kernel rule's dim on the optimizer state's leaves,
    ``rankpo_tpu/parallel/sharding.py:77``), and the port raises
    ``NotImplementedError`` naming that failure and ROADMAP.md Queue 3. LoRA
    on the same split model takes either optimizer."""
    jcfg, params, state, tree = _jax_model()
    jmesh = make_mesh(JMeshConfig(data_parallel=1, model_parallel=2), devices=jax.devices()[:2])
    cfg = JTrainConfig(optim=optim, model_parallel=2, max_steps=1, save_strategy="no")
    with pytest.raises(IndexError):
        JTrainer(loss_fn=jcontrastive(jcfg), params=params, mesh=jmesh, config=cfg,
                 total_steps=1)
    monkeypatch.setattr(mesh, "model_count", lambda: 2)
    split = TensorParallel(None, 2, 0)
    model = penc.encoder_class(workers.tiny_config()).for_training(
        workers.tiny_config(), state, device="cpu", tensor_parallel=split)
    with pytest.raises(NotImplementedError,
                       match=r"JAX package raises IndexError.*sharding.py:77.*Queue 3"):
        Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                config=TrainConfig(device="cpu", optim=optim), total_steps=1)
    model = penc.encoder_class(workers.tiny_config()).for_training(
        workers.tiny_config(), state, device="cpu", tensor_parallel=split)
    lora.apply_lora(model, lora.LoraConfig(target_modules=TARGETS, **workers.LORA),
                    adapters=lora.adapters_from_jax(tree))
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=TrainConfig(device="cpu", optim=optim), total_steps=1)
    assert all(d is None for d in trainer._tp_dims)
    assert all(n.endswith((".lora_a", ".lora_b")) for n in trainer.param_names)
