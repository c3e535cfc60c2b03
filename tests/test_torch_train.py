"""The port's training layer (rankpo_tpu_torch.train, data.loader,
collators) against the JAX package.

- schedules: all eight ``lr_scheduler_type``s value for value against the
  optax schedules, rtol 1e-6 plus atol 1.2e-7 x peak: optax evaluates in
  fp32, the port in fp64, and near the end of a cosine ``1 + cos`` cancels,
  leaving fp32's resolution of the peak (2^-23 x peak) as the difference;
- two clipped AdamW updates against
  ``optax.chain(clip_by_global_norm, adamw)``, clipping on and off: atol
  3e-7, two fp32 ulps of parameters of order 1 (torch's AdamW and optax
  order the update's operations differently);
- loader and collator batches bit-equal for one seed;
- a 4-step Trainer trace (loss, grad_norm, learning_rate) and the final
  parameters against ``rankpo_tpu.train.Trainer`` on a 1-device mesh, fp32
  compute, same initial weights (``params_from_jax``), accumulation 1 and 2,
  both stages. Tolerances: loss and grad_norm rtol 5e-5, parameters atol
  5e-6 after 4 steps of lr 1e-3: fp32 forward and backward in two
  frameworks, summed in other orders, compounded over 4 AdamW steps (on
  the CPU the largest differences seen were 4.7e-6, 1.4e-6 and 4.8e-7);
- the non-finite skip, and checkpointed gradients equal to plain ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rankpo_tpu.core.mesh import MeshConfig, make_mesh
from rankpo_tpu.data import collators as jcoll
from rankpo_tpu.data import datasets as jdata
from rankpo_tpu.data.loader import DataLoader as JLoader
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu.train.state import make_optimizer as jmake_optimizer
from rankpo_tpu.train.state import make_schedule as jmake_schedule
from rankpo_tpu_torch.data import collators as pcoll
from rankpo_tpu_torch.data import datasets as pdata
from rankpo_tpu_torch.data.loader import DataLoader as PLoader
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import embed
from rankpo_tpu_torch.models.hf_io import params_from_jax
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.state import (
    clip_grad_norm,
    global_norm,
    make_optimizer,
    make_schedule,
)
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

SCHEDULES = ["cosine", "linear", "constant", "constant_with_warmup", "polynomial",
             "cosine_with_restarts", "cosine_with_min_lr", "inverse_sqrt"]


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("kind", SCHEDULES)
def test_schedule_matches_optax(kind, warmup):
    kw = dict(learning_rate=3e-4, lr_scheduler_type=kind, warmup_steps=warmup,
              warmup_ratio=0.0, lr_end=1e-6, lr_power=2.0, lr_num_cycles=3)
    ref = jmake_schedule(JTrainConfig(**kw), 50)
    port = make_schedule(TrainConfig(**kw), 50)
    for step in range(0, 60):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6,
                                   atol=1.2e-7 * 3e-4, err_msg=f"{kind} step {step}")


def test_warmup_ratio_sets_warmup():
    kw = dict(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_ratio=0.1)
    ref = jmake_schedule(JTrainConfig(**kw), 100)
    port = make_schedule(TrainConfig(**kw), 100)
    assert port(0) == 0.0 and port(10) == pytest.approx(1e-3)
    for step in (3, 10, 55, 99):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1.2e-7 * 1e-3)


@pytest.mark.parametrize("max_grad_norm", [0.5, 100.0])
def test_clipped_adamw_matches_optax(max_grad_norm):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7), dtype=np.float32),
              "b": rng.standard_normal((11,), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in params.items()}
             for _ in range(2)]
    kw = dict(learning_rate=1e-3, lr_scheduler_type="linear", warmup_steps=0,
              warmup_ratio=0.0, weight_decay=0.01, max_grad_norm=max_grad_norm)
    tx, _ = jmake_optimizer(JTrainConfig(**kw), 10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt, schedule = make_optimizer(tp, TrainConfig(**kw), 10)
    for count, g in enumerate(grads):
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        gl = [p.grad for p in tp]
        norm = global_norm(gl)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        clip_grad_norm(gl, max_grad_norm, norm)
        for group in opt.param_groups:
            group["lr"] = schedule(count)
        opt.step()
    for p, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=3e-7, rtol=0)


def test_clip_rule_is_optax_not_clip_grad_norm_():
    """At ||g|| == max_norm optax scales by exactly 1 (g / n * n) and below it
    leaves g untouched."""
    g = [torch.tensor([3.0, 4.0])]
    clip_grad_norm(g, 5.0, global_norm(g))
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 5.0)
    g = [torch.tensor([0.3, 0.4])]
    clip_grad_norm(g, 5.0, global_norm(g))
    assert torch.equal(g[0], torch.tensor([0.3, 0.4]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _contrastive_rows(n=24, n_neg=6, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [{"query": text(2, 9), "positives": [text(4, 20) for _ in range(2)],
             "negatives": [text(3, 24) for _ in range(n_neg)]} for _ in range(n)]


def _pair_rows(n=16, seed=1):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [{"query": text(2, 9), "passage1": text(4, 20), "passage2": text(4, 20),
             "preferred": "AB"[i % 2]} for i in range(n)]


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)  # jax's stacking sorts dict keys
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_loader_and_collator_batches_bit_equal(stage):
    tok_p, tok_j = HashTokenizer(vocab_size=256), JHashTokenizer(vocab_size=256)
    if stage == "contrastive":
        rows = _contrastive_rows()
        ds_p = pdata.ContrastiveDataset(rows, tok_p, 12, 16)
        ds_j = jdata.ContrastiveDataset(rows, tok_j, 12, 16)
        co_p = pcoll.ContrastiveCollator(0, 3, 12, 16, seed=5)
        co_j = jcoll.ContrastiveCollator(0, 3, 12, 16, seed=5)
    else:
        rows = _pair_rows()
        ds_p = pdata.PairPreferenceDataset(rows, tok_p, 12, 16)
        ds_j = jdata.PairPreferenceDataset(rows, tok_j, 12, 16)
        co_p = pcoll.RankPOCollator(0, 12, None, pad_multiple=8)
        co_j = jcoll.RankPOCollator(0, 12, None, pad_multiple=8)
    assert ds_p.rows == ds_j.rows
    lp = PLoader(ds_p, co_p, batch_size=4, seed=9)
    lj = JLoader(ds_j, co_j, batch_size=4, seed=9)
    stack = 2 if stage == "contrastive" else 0
    n = 0
    for epoch in (0, 1):
        for a, b in zip(lp.epoch(epoch, stack=stack), lj.epoch(epoch, stack=stack),
                        strict=True):
            _assert_tree_equal(a, b)
            n += 1
    assert n == (6 if stage == "contrastive" else 8)


def test_loader_rejects_multiprocess_sharding():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PLoader([], None, batch_size=4, process_count=2)


# ---------------------------------------------------------------------------
# Trainer trace against rankpo_tpu.train.Trainer
# ---------------------------------------------------------------------------

def _tiny():
    jcfg = jtiny(vocab_size=256)
    return jcfg, EncoderConfig(**dataclasses.asdict(jcfg))


def _trace(stage, accum):
    jcfg, pcfg = _tiny()
    params = jinit(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    tok_p, tok_j = HashTokenizer(vocab_size=256), JHashTokenizer(vocab_size=256)
    common = dict(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                  per_device_train_batch_size=4, gradient_accumulation_steps=accum,
                  max_steps=4, save_strategy="no", weight_decay=0.01, seed=3)
    if stage == "contrastive":
        rows = _contrastive_rows(n=40)
        ds_p, ds_j = (pdata.ContrastiveDataset(rows, tok_p, 12, 16),
                      jdata.ContrastiveDataset(rows, tok_j, 12, 16))
        co_p, co_j = (pcoll.ContrastiveCollator(0, 3, 12, 16, seed=3),
                      jcoll.ContrastiveCollator(0, 3, 12, 16, seed=3))
        jloss = jcontrastive(jcfg, temperature=0.05, compute_dtype=jnp.float32)
        ploss = make_contrastive_loss_fn(pcfg, temperature=0.05)
    else:
        rows = _pair_rows(n=40)
        ds_p, ds_j = (pdata.PairPreferenceDataset(rows, tok_p, 12, 16),
                      jdata.PairPreferenceDataset(rows, tok_j, 12, 16))
        co_p, co_j = pcoll.RankPOCollator(0, 12, 16), jcoll.RankPOCollator(0, 12, 16)
        kw = dict(beta=2.0, temperature=0.1, loss_type="sigmoid", sft_weight=0.3)
        jloss = jrankpo(jcfg, compute_dtype=jnp.float32, **kw)
        ploss = make_rankpo_loss_fn(pcfg, **kw)
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JTrainer(loss_fn=jloss, params=params, mesh=mesh,
                  config=JTrainConfig(**common), total_steps=4)
    jhist = jt.train(ds_j, co_j)
    model = llama.LlamaEncoder.for_training(pcfg, state, compute_dtype=torch.float32)
    pt = Trainer(loss_fn=ploss, model=model, config=TrainConfig(device="cpu", **common),
                 total_steps=4)
    phist = pt.train(ds_p, co_p)
    jstate = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), pcfg)
    return jhist, phist, jstate, model.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_trainer_trace_matches_jax(stage, accum):
    jhist, phist, jstate, pstate = _trace(stage, accum)
    assert len(phist) == len(jhist) == 4
    for j, p in zip(jhist, phist):
        assert list(p)[:7] == ["global_step", "loss", "learning_rate", "grad_norm",
                               "global_epoch", "epoch", "step"]
        assert p["global_step"] == j["global_step"] and p["step"] == j["step"]
        assert p["global_epoch"] == j["global_epoch"]
        np.testing.assert_allclose(p["learning_rate"], j["learning_rate"], rtol=1e-6)
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=5e-5)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=5e-5)
        metric_keys = [k for k in j if k not in ("step_time", "samples_per_sec")]
        for key in metric_keys:
            np.testing.assert_allclose(p[key], j[key], rtol=5e-5, atol=1e-6, err_msg=key)
    for name, ref in jstate.items():
        np.testing.assert_allclose(pstate[name].numpy(), ref.numpy(), atol=5e-6, rtol=0,
                                   err_msg=name)


class _Poisoned:
    """loss_fn wrapper whose loss is NaN on the given calls."""

    def __init__(self, fn, bad_calls):
        self.fn, self.bad, self.calls = fn, set(bad_calls), 0

    def __call__(self, model, batch):
        loss, metrics = self.fn(model, batch)
        self.calls += 1
        if self.calls in self.bad:
            loss = loss * float("nan")
        return loss, metrics


def test_nonfinite_step_keeps_params_and_optimizer_state():
    _, pcfg = _tiny()
    state = llama.init_params(pcfg, torch.Generator().manual_seed(0))
    model = llama.LlamaEncoder.for_training(pcfg, state, compute_dtype=torch.float32)
    loss_fn = _Poisoned(make_contrastive_loss_fn(pcfg, temperature=0.05), bad_calls=[2])
    cfg = TrainConfig(device="cpu", learning_rate=1e-3, lr_scheduler_type="linear",
                      warmup_steps=0, warmup_ratio=0.0, max_steps=3,
                      per_device_train_batch_size=4, save_strategy="no")
    trainer = Trainer(loss_fn=loss_fn, model=model, config=cfg, total_steps=10)
    coll = pcoll.ContrastiveCollator(0, 3, 12, 16, seed=0)
    ds = pdata.ContrastiveDataset(_contrastive_rows(n=12), HashTokenizer(vocab_size=256), 12, 16)
    batches = list(PLoader(ds, coll, batch_size=4, seed=0).epoch(0, stack=1))

    trainer.train_step(batches[0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in s.items()}
                  for p, s in trainer.optimizer.state.items()}
    out = trainer.train_step(batches[1])  # the poisoned step
    assert not np.isfinite(out["loss"])
    assert trainer.step == 2 and trainer.updates == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in trainer.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[id(p)][k]), k
    trainer.train_step(batches[2])
    assert trainer.updates == 2
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_gradient_checkpointing_gives_plain_gradients():
    _, pcfg = _tiny()
    state = llama.init_params(pcfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    lens = np.array([16, 9, 1])
    ids = torch.from_numpy(rng.integers(3, 256, (3, 16)))
    mask = torch.from_numpy((np.arange(16)[None] < lens[:, None]).astype(np.int32))
    grads = []
    for remat in (False, True):
        model = llama.LlamaEncoder.for_training(pcfg, state, compute_dtype=torch.float32,
                                                gradient_checkpointing=remat)
        reps = embed(model, {"input_ids": ids, "attention_mask": mask})
        (reps * torch.arange(reps.shape[1])).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0, msg=name)


def test_unported_checkpoint_policy_and_options_raise():
    _, pcfg = _tiny()
    state = llama.init_params(pcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.LlamaEncoder.for_training(pcfg, state, checkpoint_policy="dots")
    for field, value in (("optim", "adafactor"), ("fsdp", True), ("eval_strategy", "steps"),
                         ("resume_from_checkpoint", "latest"), ("profile_steps", 3),
                         ("async_checkpointing", True), ("model_parallel", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainConfig(**{field: value}).check_supported()
    TrainConfig(zero1=True).check_supported()  # accepted, means nothing on one card


def test_epoch_logging_and_checkpoint_rotation(tmp_path):
    """logging_strategy='epoch' logs one row per epoch holding the mean of
    that epoch's per-step values (the same run logged per step), and
    save_strategy='steps' keeps the newest save_total_limit checkpoints.
    Training leaves the state dict the model was built from untouched."""
    _, pcfg = _tiny()
    state = llama.init_params(pcfg, torch.Generator().manual_seed(0))
    before = {n: t.clone() for n, t in state.items()}
    ds = pdata.ContrastiveDataset(_contrastive_rows(n=12), HashTokenizer(vocab_size=256), 12, 16)
    histories = []
    for strategy in ("steps", "epoch"):
        model = llama.LlamaEncoder.for_training(pcfg, state, compute_dtype=torch.float32)
        cfg = TrainConfig(device="cpu", learning_rate=1e-3, num_train_epochs=2,
                          per_device_train_batch_size=4, logging_strategy=strategy,
                          save_strategy="steps", save_steps=1, save_total_limit=2,
                          output_dir=str(tmp_path / strategy))
        trainer = Trainer(loss_fn=make_contrastive_loss_fn(pcfg, temperature=0.05),
                          model=model, config=cfg, total_steps=6)
        histories.append(trainer.train(ds, pcoll.ContrastiveCollator(0, 3, 12, 16, seed=0)))
    steps, epochs = histories
    assert [h["global_step"] for h in steps] == list(range(1, 7))
    assert [(h["global_step"], h["global_epoch"]) for h in epochs] == [(3, 1), (6, 2)]
    for e, rows in ((0, steps[:3]), (1, steps[3:])):
        for key in ("loss", "grad_norm", "accuracy"):
            assert epochs[e][key] == pytest.approx(np.mean([r[key] for r in rows]), rel=1e-6)
    for strategy in ("steps", "epoch"):
        kept = sorted(p.name for p in (tmp_path / strategy).iterdir())
        assert kept == ["checkpoint-5", "checkpoint-6"]
    assert all(torch.equal(state[n], before[n]) for n in state)
