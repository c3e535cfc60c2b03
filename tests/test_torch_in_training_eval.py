"""In-training retrieval evaluation of the port (``eval/in_training.py``),
mirroring ``tests/test_in_training_eval.py`` (its two-process and FSDP
cases wait for the port's parallelism, ROADMAP.md Queue 1 item 8).

- the hook's metrics on a live model equal ``evaluate_checkpoint`` over the
  same weights saved to disk, in fp32 and in bf16 (rtol 1e-6, the JAX
  test's tolerance);
- one encoder serves every call and holds no weights between calls;
- the cutoffs are filtered again against k clamped to the corpus size;
- a factory spec resolves at construction, a bad one fails there;
- the trainer logs ``retrieval_*`` and ``retrieval_eval_runtime`` with no
  eval set; both training CLIs put ``retrieval_MRR@1`` in their history;
- the attach helper's validation;
- port and JAX hooks give equal metrics for the same carried-over weights
  (rtol 1e-6).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.eval.in_training import RetrievalEvalHook as JHook
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
from rankpo_tpu_torch.data.collators import ContrastiveCollator
from rankpo_tpu_torch.data.datasets import ContrastiveDataset
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.eval.evaluator import evaluate_checkpoint
from rankpo_tpu_torch.eval.in_training import RetrievalEvalHook, maybe_attach_retrieval_eval
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import EncoderConfig, tiny_llama_config
from rankpo_tpu_torch.models.hf_io import params_from_jax, save_pretrained
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

RTOL = 1e-6
CORPUS = [f"unique doc {i} topic {i}" for i in range(20)]
POSITIVES = (3, 11)
TOK = HashTokenizer(vocab_size=256)


def _write_eval_files(d):
    qf, cf = d / "q.jsonl", d / "c.jsonl"
    qf.write_text("\n".join(json.dumps({"query": {"text": CORPUS[i]},
                                        "positives": {"index": [i]}}) for i in POSITIVES))
    cf.write_text("\n".join(json.dumps({"text": t}) for t in CORPUS))
    return str(qf), str(cf)


def _hook(d, **kwargs):
    qf, cf = _write_eval_files(d)
    kw = dict(max_query_length=16, max_passage_length=16, k=10, cutoffs=(1, 5),
              batch_size=8, compute_dtype=torch.float32)
    kw.update(kwargs)
    return RetrievalEvalHook(TOK, qf, cf, **kw)


def _model(seed=0, compute_dtype=torch.float32):
    cfg = tiny_llama_config(vocab_size=256)
    state = llama.init_params(cfg, torch.Generator().manual_seed(seed))
    model = llama.LlamaEncoder.for_training(cfg, state, device="cpu",
                                            compute_dtype=compute_dtype)
    return cfg, state, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hook_matches_offline_evaluator(tmp_path, dtype):
    """The hook on a live (trainable, fp32-master) model equals
    ``evaluate_checkpoint`` over the same weights saved to disk, in the same
    compute dtype."""
    cfg, state, model = _model(0, dtype)
    save_pretrained(str(tmp_path / "ckpt"), cfg, state)
    live = _hook(tmp_path, compute_dtype=dtype)(model)
    offline, _, _ = evaluate_checkpoint(
        str(tmp_path / "ckpt"), [CORPUS[i] for i in POSITIVES], [[i] for i in POSITIVES],
        CORPUS, tokenizer=TOK, device="cpu", batch_size=8, max_query_length=16,
        max_passage_length=16, k=10, cutoffs=(1, 5), compute_dtype=dtype)
    assert live["retrieval_MRR@1"] == 1.0  # each query is its positive's text
    assert set(live) == {f"retrieval_{n}" for n in offline}
    for name, value in offline.items():
        np.testing.assert_allclose(live[f"retrieval_{name}"], value, rtol=RTOL, err_msg=name)
    assert model.compute_dtype == dtype and model.training


def test_encoder_reused_and_no_stale_weights(tmp_path):
    _, _, model = _model(1)
    hook = _hook(tmp_path)
    first = hook(model)
    enc = hook._encoder
    assert enc is not None and enc.model is None  # no weights between eval points
    assert hook(model) == first
    assert hook._encoder is enc
    # another model through the same encoder: its own metrics, not the first's
    _, _, other = _model(2)
    other_direct = _hook(tmp_path)(other)
    assert hook(other) == other_direct


def test_cutoffs_refiltered_against_clamped_k(tmp_path):
    hook = _hook(tmp_path, k=100, cutoffs=(1, 5, 100))
    assert hook.k == len(CORPUS) == 20
    assert hook.cutoffs == [1, 5]
    metrics = hook(_model(3)[2])
    assert "retrieval_MRR@100" not in metrics and "retrieval_MRR@5" in metrics
    assert _hook(tmp_path, k=50, cutoffs=(30, 40)).cutoffs == [20]


def test_factory_spec_resolves_and_bad_spec_fails(tmp_path):
    hook = _hook(tmp_path, index_type="PCA8,Flat")
    assert hook.index_type == "refine"
    assert "retrieval_MRR@1" in hook(_model(0)[2])
    with pytest.raises(Exception):
        _hook(tmp_path, index_type="OPQ64,Flat")


def test_empty_files_raise(tmp_path):
    qf, _ = _write_eval_files(tmp_path)
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(ValueError, match="non-empty"):
        RetrievalEvalHook(TOK, qf, str(tmp_path / "empty.jsonl"))


def test_trainer_logs_retrieval_without_eval_set(tmp_path):
    cfg, _, model = _model(0)
    config = TrainConfig(output_dir=str(tmp_path / "out"), device="cpu", learning_rate=1e-3,
                         lr_scheduler_type="constant", per_device_train_batch_size=1,
                         num_train_epochs=1, eval_strategy="epoch", save_strategy="no",
                         save_on_preemption=False)
    trainer = Trainer(loss_fn=make_contrastive_loss_fn(cfg, temperature=0.05), model=model,
                      config=config, total_steps=2)
    trainer.retrieval_eval_fn = _hook(tmp_path)
    rows = [{"query": f"common topic {i} alpha", "positives": [f"common topic {i} gamma"],
             "negatives": [f"other {j} {i}" for j in range(3)]} for i in range(4)]
    history = trainer.train(ContrastiveDataset(rows, TOK, 16, 16),
                            ContrastiveCollator(0, 3, 16, 16, seed=0))
    ev = [h for h in history if "retrieval_MRR@1" in h]
    assert len(ev) == 1 and "eval_loss" not in ev[0]
    assert "retrieval_nDCG@5" in ev[0] and "retrieval_eval_runtime" in ev[0]
    assert 0.0 <= ev[0]["retrieval_MRR@1"] <= 1.0


def test_attach_helper_validation(tmp_path):
    args = types.SimpleNamespace(retrieval_eval_query_file=None,
                                 retrieval_eval_corpus_file="c.jsonl", retrieval_eval_k=10,
                                 retrieval_eval_index="flat", max_query_length=16,
                                 max_passage_length=16)
    trainer = types.SimpleNamespace(config=TrainConfig(output_dir=str(tmp_path / "o")),
                                    retrieval_eval_fn=None)
    with pytest.raises(ValueError, match="requires"):
        maybe_attach_retrieval_eval(trainer, args, TOK)
    args.retrieval_eval_corpus_file = None
    assert not maybe_attach_retrieval_eval(trainer, args, TOK)
    args.retrieval_eval_query_file, _ = _write_eval_files(tmp_path)
    with pytest.raises(ValueError, match="requires"):
        maybe_attach_retrieval_eval(trainer, args, TOK)
    args.retrieval_eval_query_file, args.retrieval_eval_corpus_file = _write_eval_files(tmp_path)
    assert maybe_attach_retrieval_eval(trainer, args, TOK)
    hook = trainer.retrieval_eval_fn
    assert hook.k == 10 and hook.cutoffs == [1, 5, 10]
    assert hook.compute_dtype == torch.bfloat16  # --bf16 is the default
    trainer.config = TrainConfig(output_dir=str(tmp_path / "o"), bf16=False)
    assert maybe_attach_retrieval_eval(trainer, args, TOK)
    assert trainer.retrieval_eval_fn.compute_dtype == torch.float32


def test_port_and_jax_hooks_agree(tmp_path):
    """The same carried-over weights through the JAX hook and the port's
    give equal metrics (fp32, rtol 1e-6)."""
    jcfg = jtiny(vocab_size=256)
    params = jinit(jax.random.key(0), jcfg)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    model = llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)
    qf, cf = _write_eval_files(tmp_path)
    kw = dict(max_query_length=16, max_passage_length=16, k=10, cutoffs=(1, 5), batch_size=8)
    want = JHook(jcfg, JHashTokenizer(vocab_size=256), qf, cf, compute_dtype=jnp.float32,
                 **kw)(params)
    got = RetrievalEvalHook(TOK, qf, cf, compute_dtype=torch.float32, **kw)(model)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=RTOL, err_msg=name)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("retrieval_cli")
    cfg = tiny_llama_config(vocab_size=256)
    save_pretrained(str(d / "base"), cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    with open(d / "train.jsonl", "w") as f:
        for i in range(16):
            f.write(json.dumps({"query": f"q {i} topic", "positives": [f"doc {i} topic"],
                                "negatives": [f"other {j} {i}" for j in range(3)]}) + "\n")
    with open(d / "pairs.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps({"query": f"q {i}", "passage1": f"doc {i}",
                                "passage2": f"doc {i + 1}", "preferred": "AB"[i % 2]}) + "\n")
    _write_eval_files(d)
    return d


@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_retrieval_metrics_in_cli_history(cli_dir, tmp_path, stage):
    d = cli_dir
    common = ["--model_name_or_path", str(d / "base"), "--tokenizer_name", "hash:256",
              "--output_dir", str(tmp_path), "--per_device_train_batch_size", "4",
              "--max_query_length", "16", "--max_passage_length", "16", "--max_steps", "2",
              "--save_strategy", "no", "--device", "cpu", "--eval_strategy", "steps",
              "--eval_steps", "2", "--retrieval_eval_query_file", str(d / "q.jsonl"),
              "--retrieval_eval_corpus_file", str(d / "c.jsonl"), "--retrieval_eval_k", "10"]
    if stage == "contrastive":
        hist = run_contrastive.main([*common, "--train_data", str(d / "train.jsonl"),
                                     "--num_negatives", "3"])
    else:
        hist = run_rankpo.main([*common, "--train_data", str(d / "pairs.jsonl"),
                                "--reference_free", "True"])
    ev = [h for h in hist if "retrieval_MRR@1" in h]
    assert len(ev) == 1 and ev[0]["global_step"] == 2
    assert "retrieval_Recall@10" in ev[0] and "retrieval_MRR@20" not in ev[0]
    assert ev[0]["retrieval_eval_runtime"] >= 0.0
