"""The port's offline CLIs end to end on the CPU (``--device cpu``):
``evaluate``, ``get_random_negatives``, ``get_hard_negatives``,
``get_predictions`` and ``run_pipeline --iterations 2`` on a tiny
checkpoint written by the port's ``save_pretrained`` (the flag sets of
``tests/test_cli_pipeline.py``). The training CLIs' saved directories carry
a ``README.md`` byte-equal to the JAX package's ``write_model_card`` for the
same arguments; ``--wandb_project`` without wandb warns and carries on; and
every CLI left at its default ``--device cuda`` raises on a host without a
card.
"""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from rankpo_tpu.eval.metrics import compute_metrics as j_compute_metrics
from rankpo_tpu.utils.model_card import write_model_card as j_write_model_card
from rankpo_tpu_torch.cli import (
    evaluate,
    get_hard_negatives,
    get_predictions,
    get_random_negatives,
    run_contrastive,
    run_pipeline,
    run_rankpo,
)
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import save_pretrained
from rankpo_tpu_torch.utils.jsonl import iter_jsonl

torch.set_num_threads(2)

N_DOCS = 24
TOK = "hash:256"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    cfg = tiny_llama_config(vocab_size=256)
    base_model = str(root / "base-model")
    save_pretrained(base_model, cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    docs = [f"field {i} research on subject {i} methods" for i in range(N_DOCS)]
    (root / "train.jsonl").write_text("\n".join(json.dumps({
        "query": f"job opening about subject {i} methods", "positives": [docs[i]],
        "negatives": [docs[(i + j) % N_DOCS] for j in range(4, 10)]}) for i in range(16)))
    (root / "pairs.jsonl").write_text("\n".join(json.dumps({
        "query": f"q {i}", "passage1": f"good {i}", "passage2": f"bad {i}",
        "preferred": "AB"[i % 2]}) for i in range(8)))
    (root / "queries.jsonl").write_text("\n".join(json.dumps({
        "query": {"text": f"job opening about subject {i} methods"},
        "positives": {"index": [i]}}) for i in range(8)))
    (root / "corpus.jsonl").write_text("\n".join(json.dumps({"text": t}) for t in docs))
    (root / "mining.jsonl").write_text("\n".join(json.dumps({
        "query": {"text": f"job opening about subject {i} methods"},
        "positives": {"text": [docs[i]]},
        "negatives": {"text": [docs[(i + 5) % N_DOCS]]}}) for i in range(8)))
    return root, base_model


def _rows(path):
    return list(iter_jsonl(str(path)))


def _eval_argv(root, model, out):
    return ["--model_name_or_path", model, "--tokenizer_name", TOK,
            "--query_data", str(root / "queries.jsonl"),
            "--corpus_data", str(root / "corpus.jsonl"), "--output_dir", str(out),
            "--batch_size", "8", "--max_query_length", "16",
            "--max_passage_length", "16", "--k", "10", "--cutoffs", "1,5,10",
            "--device", "cpu"]


def _mine_argv(root, model, out):
    return ["--model_name_or_path", model, "--tokenizer_name", TOK,
            "--input_file", str(root / "mining.jsonl"), "--output_prefix", str(out),
            "--batch_size", "8", "--max_query_length", "16",
            "--max_passage_length", "16", "--num_negatives", "3",
            "--search_range", "0-12", "--method", "topk,cluster", "--lambda_", "0.5",
            "--num_clusters", "2", "--seed", "0", "--device", "cpu"]


def _pred_argv(root, model, out):
    return ["--model_name_or_path", model, "--tokenizer_name", TOK,
            "--query_data", str(root / "queries.jsonl"),
            "--corpus_data", str(root / "corpus.jsonl"), "--output_file", str(out),
            "--batch_size", "8", "--max_query_length", "16",
            "--max_passage_length", "16", "--search_range", "0-8",
            "--num_predictions", "3", "--device", "cpu"]


def _rand_argv(root, out):
    return ["--input_file", str(root / "mining.jsonl"), "--output_file", str(out),
            "--num_negatives", "4", "--seed", "0", "--device", "cpu"]


def _stage1_argv(root, model, out):
    return ["--model_name_or_path", model, "--tokenizer_name", TOK,
            "--train_data", str(root / "train.jsonl"), "--output_dir", str(out),
            "--learning_rate", "1e-3", "--per_device_train_batch_size", "4",
            "--num_negatives", "3", "--max_query_length", "16",
            "--max_passage_length", "16", "--max_steps", "1",
            "--save_strategy", "no", "--device", "cpu"]


def test_evaluate_cli(workspace, tmp_path):
    root, base = workspace
    ckpt_tree = tmp_path / "models" / "run"
    for step in (1, 2):
        os.makedirs(ckpt_tree / f"checkpoint-{step}")
        for name in ("config.json", "model.safetensors"):
            os.link(os.path.join(base, name), ckpt_tree / f"checkpoint-{step}" / name)
    out = tmp_path / "results"
    results = evaluate.main([*_eval_argv(root, str(ckpt_tree), out),
                             "--evaluate_all_checkpoints"])
    assert list(results) == ["checkpoint-1", "checkpoint-2"]
    labels = [[i] for i in range(8)]
    for name, metrics in results.items():
        idx = np.load(out / "run" / f"{name}-indices.npy")
        scores = np.load(out / "run" / f"{name}-scores.npy")
        assert idx.shape == scores.shape == (8, 10)
        assert metrics == j_compute_metrics(idx, scores, labels, cutoffs=[1, 5, 10])
        assert json.loads((out / "run" / f"{name}.json").read_text()) == metrics
    assert json.loads((out / "run" / "all_eval_results.json").read_text()) == results
    with pytest.raises(ValueError, match="JSON"):
        evaluate.main([*_eval_argv(root, base, tmp_path / "bad"), "--index_type", "ivf",
                       "--index_kwargs", "{nope"])


def test_random_negatives_cli(workspace, tmp_path):
    root, _ = workspace
    out = tmp_path / "rand.jsonl"
    rows = get_random_negatives.main(_rand_argv(root, out))
    assert _rows(out) == rows
    assert len(rows) == 8 and all(len(r["negatives"]) == 4 for r in rows)


def test_hard_negatives_cli(workspace, tmp_path):
    root, base = workspace
    out = tmp_path / "mined"
    outputs = get_hard_negatives.main(_mine_argv(root, base, out))
    assert sorted(outputs) == ["cluster5.jsonl", "topk.jsonl"]
    assert json.loads((out / "config.json").read_text())["device"] == "cpu"
    for path in outputs.values():
        rows = _rows(path)
        assert len(rows) == 8
        for row, src in zip(rows, _rows(root / "mining.jsonl")):
            assert len(row["negatives"]) == 3
            for neg in row["negatives"]:
                assert neg != row["query"] and neg not in src["positives"]["text"]


def test_predictions_cli(workspace, tmp_path):
    root, base = workspace
    out = tmp_path / "preds" / "pairs.jsonl"
    rows = get_predictions.main(_pred_argv(root, base, out))
    assert _rows(out) == rows
    assert len(rows) == 8 * 3  # Q x C(3, 2)


def test_iteration_pipeline(workspace, tmp_path):
    """bootstrap -> train -> mine -> retrain -> prediction pairs."""
    root, base = workspace
    out = str(tmp_path / "pipeline")
    final = run_pipeline.main([
        "--model_name_or_path", base, "--tokenizer_name", TOK,
        "--raw_data", str(root / "mining.jsonl"), "--output_dir", out,
        "--iterations", "2", "--num_negatives", "2", "--search_range", "0-8",
        "--num_train_epochs", "1", "--per_device_train_batch_size", "2",
        "--learning_rate", "1e-3", "--temperature", "0.05",
        "--max_query_length", "16", "--max_passage_length", "16",
        "--batch_size", "8", "--query_data", str(root / "queries.jsonl"),
        "--corpus_data", str(root / "corpus.jsonl"), "--num_predictions", "3",
        "--device", "cpu",
    ])
    assert final == os.path.join(out, "iter1")
    assert os.path.isfile(os.path.join(final, "model.safetensors"))
    assert os.path.isfile(os.path.join(out, "train_iter0.jsonl"))
    assert sorted(os.listdir(os.path.join(out, "mined_iter0"))) == ["topk.jsonl"]
    mined = _rows(os.path.join(out, "mined_iter0", "topk.jsonl"))
    assert len(mined) == 8 and all(len(r["negatives"]) == 4 for r in mined)
    assert len(_rows(os.path.join(out, "prediction_pairs.jsonl"))) == 8 * 3
    # the stage-1 model card, byte-equal to the JAX writer's for the same args
    card = tmp_path / "jax_card"
    j_write_model_card(
        str(card), stage="contrastive",
        tags=["rankpo_tpu", "contrastive", "dense-retrieval"],
        base_model=os.path.join(out, "iter0"),
        training_args={"temperature": 0.05, "negatives_cross_device": True,
                       "learning_rate": 1e-3, "per_device_train_batch_size": 2})
    with open(os.path.join(final, "README.md"), "rb") as f:
        got = f.read()
    assert got == (card / "README.md").read_bytes().replace(b"# jax_card", b"# iter1")


@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_model_card_byte_equal(workspace, tmp_path, stage):
    root, base = workspace
    out = tmp_path / "iter7"
    if stage == "contrastive":
        run_contrastive.main(_stage1_argv(root, base, out))
        kw = dict(tags=["rankpo_tpu", "contrastive", "dense-retrieval"],
                  training_args={"temperature": 0.02, "negatives_cross_device": True,
                                 "learning_rate": 1e-3, "per_device_train_batch_size": 4})
    else:
        run_rankpo.main([
            "--model_name_or_path", base, "--tokenizer_name", TOK,
            "--train_data", str(root / "pairs.jsonl"), "--output_dir", str(out),
            "--learning_rate", "1e-3", "--per_device_train_batch_size", "2",
            "--reference_free", "--beta", "2.0", "--max_query_length", "16",
            "--max_passage_length", "16", "--max_steps", "1",
            "--save_strategy", "no", "--device", "cpu"])
        kw = dict(tags=["rankpo_tpu", "rankpo", "preference-optimization",
                        "dense-retrieval"],
                  training_args={"loss_type": "sigmoid", "beta": 2.0,
                                 "temperature": 0.02, "reference_free": True,
                                 "learning_rate": 1e-3})
    j_write_model_card(str(tmp_path / "jax" / "iter7"), stage=stage, base_model=base, **kw)
    assert (out / "README.md").read_bytes() == (tmp_path / "jax" / "iter7" / "README.md").read_bytes()


def test_wandb_project_without_wandb(workspace, tmp_path, monkeypatch, caplog):
    root, base = workspace
    monkeypatch.setitem(sys.modules, "wandb", None)  # importing wandb raises
    with caplog.at_level(logging.WARNING):
        history = run_contrastive.main([*_stage1_argv(root, base, tmp_path / "w"),
                                        "--wandb_project", "proj"])
        results = evaluate.main([*_eval_argv(root, base, tmp_path / "e"),
                                 "--wandb_project", "proj"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert list(results) == ["main"]
    assert sum("wandb is not installed" in r.getMessage() for r in caplog.records) == 2


@pytest.mark.parametrize("cli", ["evaluate", "get_random_negatives",
                                 "get_hard_negatives", "get_predictions", "run_pipeline"])
def test_cli_default_device_needs_a_card(workspace, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default --device cuda is valid here")
    root, base = workspace
    argv = {
        "evaluate": lambda: _eval_argv(root, base, tmp_path / "o"),
        "get_random_negatives": lambda: _rand_argv(root, tmp_path / "o.jsonl"),
        "get_hard_negatives": lambda: _mine_argv(root, base, tmp_path / "o"),
        "get_predictions": lambda: _pred_argv(root, base, tmp_path / "o.jsonl"),
        "run_pipeline": lambda: ["--model_name_or_path", base, "--raw_data",
                                 str(root / "mining.jsonl"), "--output_dir",
                                 str(tmp_path / "o"), "--device", "cpu"],
    }[cli]()
    del argv[-2:]  # drop "--device cpu": the default is the card
    main = {"evaluate": evaluate, "get_random_negatives": get_random_negatives,
            "get_hard_negatives": get_hard_negatives, "get_predictions": get_predictions,
            "run_pipeline": run_pipeline}[cli].main
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        main(argv)
    assert not os.path.exists(tmp_path / "o") and not os.path.exists(tmp_path / "o.jsonl")
