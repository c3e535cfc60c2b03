"""Optimizer-state checkpoints, resume and the SIGTERM checkpoint of the
port's ``Trainer`` (mirroring ``tests/test_train.py``'s checkpoint, resume,
async, rotation and preemption tests).

- A run checkpointed at step 2 with its optimizer state
  (``save_only_model=False``, ``checkpoint-2/opt_state.pt``) and resumed in
  a fresh trainer from the checkpoint's weights gives the uninterrupted
  run's history rows and final parameters bit for bit: both stages,
  accumulation 1 and 2, each optimizer. The resumed loop skips the
  finished steps and replays the collator over them, so stage 1 samples
  the same negatives.
- A model-only checkpoint written by the JAX package's ``Trainer`` resumes
  in the port with the schedule fast-forwarded: the history equals JAX's
  continued run (loss and grad_norm rtol 5e-5, learning rate rtol 1e-6,
  parameters atol 5e-6, ``tests/test_torch_train.py``'s tolerances), and
  JAX's ``load_opt_state`` finds no optimizer state in a port checkpoint.
- The asynchronous save writes the same files as the synchronous one; a
  failed write raises from ``wait_for_saves``; rotation keeps
  ``save_total_limit``.
- SIGTERM to ``python -m rankpo_tpu_torch.cli.run_rankpo`` after its first
  logged step: exit code 0, "preempted: checkpoint" logged, a checkpoint
  with ``opt_state.pt``; the run then resumes to ``max_steps``.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

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
from rankpo_tpu.models import save_pretrained as jsave
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu.train.checkpoint import load_opt_state as jload_opt_state
from rankpo_tpu_torch.data import collators as pcoll
from rankpo_tpu_torch.data import datasets as pdata
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import EncoderConfig, tiny_llama_config
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained
from rankpo_tpu_torch.train import checkpoint as ckpt
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer
from test_torch_train import _contrastive_rows, _pair_rows

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCFG = tiny_llama_config(vocab_size=256)
KW = dict(temperature=0.05)
RANKPO_KW = dict(beta=2.0, temperature=0.1, loss_type="sigmoid", sft_weight=0.3)


def _data(stage):
    tok = HashTokenizer(vocab_size=256)
    if stage == "contrastive":
        ds = pdata.ContrastiveDataset(_contrastive_rows(n=40), tok, 12, 16)
        return ds, lambda: pcoll.ContrastiveCollator(0, 3, 12, 16, seed=3)
    ds = pdata.PairPreferenceDataset(_pair_rows(n=40), tok, 12, 16)
    return ds, lambda: pcoll.RankPOCollator(0, 12, 16)


def _trainer(stage, state, out, max_steps=4, **extra):
    model = llama.LlamaEncoder.for_training(PCFG, state, device="cpu",
                                            compute_dtype=torch.float32)
    loss = (make_contrastive_loss_fn(PCFG, **KW) if stage == "contrastive"
            else make_rankpo_loss_fn(PCFG, **RANKPO_KW))
    fields = dict(device="cpu", output_dir=str(out), learning_rate=1e-3,
                  lr_scheduler_type="cosine", warmup_steps=1, weight_decay=0.01,
                  per_device_train_batch_size=4, max_steps=max_steps, seed=3,
                  save_strategy="steps", save_steps=2, save_only_model=False)
    cfg = TrainConfig(**{**fields, **extra})
    return Trainer(loss_fn=loss, model=model, config=cfg, total_steps=4,
                   save_params_fn=lambda d, m: save_pretrained(d, PCFG, m.state_dict()))


def _rows(history):
    return [{k: v for k, v in h.items() if k not in ("step_time", "samples_per_sec")}
            for h in history]


@pytest.mark.parametrize("optim", ["adamw", "adamw8bit", "adafactor"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_resume_with_optimizer_state_is_bit_equal(tmp_path, stage, accum, optim):
    state = llama.init_params(PCFG, torch.Generator().manual_seed(0))
    ds, make_collator = _data(stage)
    extra = dict(gradient_accumulation_steps=accum, optim=optim)
    straight = _trainer(stage, state, tmp_path / "a", **extra)
    want = straight.train(ds, make_collator())
    assert [h["global_step"] for h in want] == [1, 2, 3, 4]

    first = _trainer(stage, state, tmp_path / "b", max_steps=2, **extra)
    first.train(ds, make_collator())
    directory = tmp_path / "b" / "checkpoint-2"
    assert (directory / "opt_state.pt").is_file()
    _, resumed_state = load_pretrained(str(directory))
    resumed = _trainer(stage, resumed_state, tmp_path / "b", **extra)
    resumed.resume_from(str(directory))
    assert resumed.step == resumed.updates == 2
    got = resumed.train(ds, make_collator())
    assert _rows(got) == _rows(want[2:])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(straight.params, resumed.params):
        for key, value in straight.optimizer.state[p].items():
            other = resumed.optimizer.state[q][key]
            assert (torch.equal(value, other) if torch.is_tensor(value) else value == other), key


def _jax_setup():
    jcfg = jtiny(vocab_size=256)
    return jcfg, EncoderConfig(**dataclasses.asdict(jcfg))


def test_jax_checkpoint_resumes_model_only_in_the_port(tmp_path):
    """Stage 2 (its collator draws nothing, so both packages' continued runs
    see the same batches): JAX trains 2 steps with a model-only
    checkpoint, then both packages resume from it to step 4."""
    jcfg, pcfg = _jax_setup()
    params = jinit(jax.random.key(0), jcfg)
    rows = _pair_rows(n=40)
    ds_j = jdata.PairPreferenceDataset(rows, JHashTokenizer(vocab_size=256), 12, 16)
    ds_p = pdata.PairPreferenceDataset(rows, HashTokenizer(vocab_size=256), 12, 16)
    common = dict(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                  per_device_train_batch_size=4, weight_decay=0.01, seed=3,
                  save_strategy="steps", save_steps=2)
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    jloss = jrankpo(jcfg, compute_dtype=jnp.float32, **RANKPO_KW)

    def jtrainer(p, out, max_steps):
        return JTrainer(loss_fn=jloss, params=p, mesh=mesh, total_steps=4,
                        config=JTrainConfig(output_dir=str(out), max_steps=max_steps,
                                            **common),
                        save_params_fn=lambda d, hp: jsave(d, jcfg, hp))

    jtrainer(params, tmp_path / "jax", 2).train(ds_j, jcoll.RankPOCollator(0, 12, 16))
    directory = str(tmp_path / "jax" / "checkpoint-2")
    assert not os.path.exists(os.path.join(directory, ckpt.OPT_STATE_FILE))
    from rankpo_tpu.models import load_pretrained as jload

    _, jparams = jload(directory)
    jt = jtrainer(jparams, tmp_path / "jax_more", 4)
    jt.resume_from(directory)
    jhist = jt.train(ds_j, jcoll.RankPOCollator(0, 12, 16))

    _, state = load_pretrained(directory)
    model = llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)
    pt = Trainer(loss_fn=make_rankpo_loss_fn(pcfg, **RANKPO_KW), model=model, total_steps=4,
                 config=TrainConfig(device="cpu", output_dir=str(tmp_path / "port"),
                                    max_steps=4, **common))
    pt.resume_from(directory)
    assert pt.step == pt.updates == 2
    assert all(float(s["step"]) == 2 for s in pt.optimizer.state.values())
    phist = pt.train(ds_p, pcoll.RankPOCollator(0, 12, 16))
    assert [h["global_step"] for h in phist] == [h["global_step"] for h in jhist] == [3, 4]
    for j, p in zip(jhist, phist):
        np.testing.assert_allclose(p["learning_rate"], j["learning_rate"], rtol=1e-6)
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=5e-5)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=5e-5)
    jstate = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), pcfg)
    for name, ref in jstate.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), ref.numpy(), atol=5e-6,
                                   rtol=0, err_msg=name)
    # a port checkpoint with its optimizer state is model-only to the JAX package
    port = str(tmp_path / "port" / "checkpoint-4")
    pt.config.save_only_model = False
    pt.save_checkpoint(4, 0)
    assert os.path.isfile(os.path.join(port, ckpt.OPT_STATE_FILE))
    assert jload_opt_state(port, jt.state.opt_state) is None


def test_async_save_writes_the_files_of_the_sync_save(tmp_path):
    state = llama.init_params(PCFG, torch.Generator().manual_seed(0))
    ds, make_collator = _data("rankpo")
    for name, flag in (("sync", False), ("async", True)):
        _trainer("rankpo", state, tmp_path / name, optim="adamw8bit",
                 async_checkpointing=flag).train(ds, make_collator())
    for step in (2, 4):
        sync, other = (tmp_path / n / f"checkpoint-{step}" for n in ("sync", "async"))
        assert sorted(os.listdir(sync)) == sorted(os.listdir(other))
        assert (sync / "model.safetensors").read_bytes() == \
            (other / "model.safetensors").read_bytes()
        a, b = ckpt.load_opt_state(str(sync)), ckpt.load_opt_state(str(other))
        assert (a["step"], a["updates"]) == (b["step"], b["updates"]) == (step, step)
        for key, value in a["optimizer"]["state"][0].items():
            other_value = b["optimizer"]["state"][0][key]
            assert (torch.equal(value, other_value) if torch.is_tensor(value)
                    else value == other_value), key


def test_async_writer_error_is_raised(tmp_path, monkeypatch):
    def fail(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    ckpt.save_opt_state(str(tmp_path), {"step": 1}, async_save=True)
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # the error is raised once
    assert not os.listdir(tmp_path)


def test_rotation_keeps_save_total_limit(tmp_path):
    state = llama.init_params(PCFG, torch.Generator().manual_seed(0))
    ds, make_collator = _data("rankpo")
    _trainer("rankpo", state, tmp_path, save_steps=1, save_total_limit=2,
             async_checkpointing=True).train(ds, make_collator())
    kept = ckpt.list_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in kept] == ["checkpoint-3", "checkpoint-4"]
    assert all(os.path.isfile(os.path.join(p, ckpt.OPT_STATE_FILE)) for p in kept)


def test_sigterm_checkpoints_exits_cleanly_and_resumes(tmp_path):
    base = tmp_path / "base"
    save_pretrained(str(base), PCFG, llama.init_params(PCFG, torch.Generator().manual_seed(0)))
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text("".join(json.dumps(r) + "\n" for r in _pair_rows(n=24)))
    out = tmp_path / "run"
    argv = [sys.executable, "-m", "rankpo_tpu_torch.cli.run_rankpo",
            "--model_name_or_path", str(base), "--tokenizer_name", "hash:256",
            "--train_data", str(pairs), "--output_dir", str(out),
            "--per_device_train_batch_size", "4", "--max_query_length", "12",
            "--max_passage_length", "16", "--learning_rate", "1e-3",
            "--num_train_epochs", "100000", "--save_strategy", "steps",
            "--save_steps", "1000000", "--save_only_model", "False", "--device", "cpu"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "'global_step': 1," in line:  # the first logged step
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    output = "".join(lines) + rest
    assert proc.returncode == 0, output[-3000:]
    assert "preempted: checkpoint" in output, output[-3000:]
    found = ckpt.latest_checkpoint(str(out))
    assert found is not None and os.path.isfile(os.path.join(found, ckpt.OPT_STATE_FILE))
    step = json.load(open(os.path.join(found, "trainer_state.json")))["global_step"]
    assert step >= 1
    resumed = subprocess.run(
        [*argv, "--max_steps", str(step + 2), "--save_strategy", "no",
         "--resume_from_checkpoint", "latest"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert resumed.returncode == 0, resumed.stdout[-3000:] + resumed.stderr[-3000:]
    history = json.load(open(out / "trainer_history.json"))
    assert [h["global_step"] for h in history] == [step + 1, step + 2]
