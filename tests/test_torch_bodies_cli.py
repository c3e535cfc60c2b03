"""The port's CLIs on the XLM-Roberta, BERT and Qwen2 bodies, on the CPU
(``--device cpu``), from tiny checkpoints written by the port's
``save_pretrained``: stage 1 (``run_contrastive``, the Roberta body with its
dropout live) then stage 2 (``run_rankpo`` with a frozen reference model),
``cli.evaluate`` with metrics equal to the JAX ``compute_metrics`` over the
saved arrays, and ``cli.serve`` answering ``/search``. The ``hash:<vocab>``
tokenizer takes the checkpoint's pad id (XLM-Roberta: ``<s>`` 0, ``<pad>``
1), so the Roberta position rule sees the same text as with the model's own
tokenizer.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rankpo_tpu.eval.metrics import compute_metrics as j_compute_metrics
from rankpo_tpu.models import load_pretrained as jload
from rankpo_tpu.models.config import tiny_qwen2_config, tiny_roberta_config
from rankpo_tpu_torch.cli import evaluate, run_contrastive, run_rankpo
from rankpo_tpu_torch.cli import serve as serve_cli
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.encoder import init_params, state_names
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained

torch.set_num_threads(2)

N_DOCS = 24
TOK = "hash:256"


def _config(kind):
    if kind == "qwen2":
        cfg = tiny_qwen2_config(vocab_size=256)
    else:
        cfg = tiny_roberta_config(vocab_size=256)
        if kind == "bert":
            cfg = dataclasses.replace(cfg, model_type="bert", pad_token_id=0,
                                      type_vocab_size=2, architectures=("BertModel",))
    return EncoderConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("bodies_cli")
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
    return root


def _base(root, kind):
    path = root / f"base-{kind}"
    if not path.exists():
        cfg = _config(kind)
        save_pretrained(str(path), cfg, init_params(cfg, torch.Generator().manual_seed(0)))
    return str(path)


def _moved_and_loads_in_jax(directory, before):
    cfg, state = load_pretrained(str(directory))
    _, jparams = jload(str(directory))
    from_jax = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert list(state) == list(from_jax) == state_names(cfg)
    for name, t in state.items():
        assert torch.equal(t, from_jax[name]), name
    moved = [n for n in state if not torch.equal(state[n], before[n])]
    return cfg, state, moved


@pytest.mark.parametrize("kind", ["xlm-roberta", "qwen2"])
def test_two_stages_then_evaluate(workspace, tmp_path, kind):
    root = workspace
    base = _base(root, kind)
    cfg0, before = load_pretrained(base)
    hist1 = run_contrastive.main([
        "--model_name_or_path", base, "--tokenizer_name", TOK,
        "--train_data", str(root / "train.jsonl"), "--output_dir", str(tmp_path / "s1"),
        "--learning_rate", "1e-3", "--per_device_train_batch_size", "4",
        "--num_negatives", "3", "--max_query_length", "16", "--max_passage_length", "16",
        "--max_steps", "2", "--gradient_accumulation_steps", "2",
        "--gradient_checkpointing", "True", "--save_strategy", "no", "--device", "cpu"])
    assert [h["global_step"] for h in hist1] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist1)
    _, s1, moved = _moved_and_loads_in_jax(tmp_path / "s1", before)
    # the BERT family's unused token types and positions past 16 keep their rows
    fixed = {n for n in s1 if "position_embeddings" in n or "token_type" in n}
    assert set(s1) - set(moved) <= fixed and len(moved) >= len(s1) - 2

    hist2 = run_rankpo.main([
        "--model_name_or_path", str(tmp_path / "s1"), "--tokenizer_name", TOK,
        "--train_data", str(root / "pairs.jsonl"), "--output_dir", str(tmp_path / "s2"),
        "--per_device_train_batch_size", "4", "--max_query_length", "16",
        "--max_passage_length", "16", "--beta", "2.0", "--temperature", "0.1",
        "--reference_free", "False", "--learning_rate", "1e-3", "--max_steps", "2",
        "--save_strategy", "no", "--device", "cpu"])
    assert all(np.isfinite(h["loss"]) for h in hist2)
    # the frozen reference starts equal to the policy and dropout is off;
    # the reference holds
    # bf16 parameters, so the Roberta body sums its three embedding rows in
    # bf16 where the policy sums them in fp32 before the cast
    assert hist2[0]["rewards/chosen"] == pytest.approx(0.0, abs=1e-4)
    _moved_and_loads_in_jax(tmp_path / "s2", s1)

    out = tmp_path / "results"
    results = evaluate.main([
        "--model_name_or_path", str(tmp_path / "s2"), "--tokenizer_name", TOK,
        "--query_data", str(root / "queries.jsonl"),
        "--corpus_data", str(root / "corpus.jsonl"), "--output_dir", str(out),
        "--batch_size", "8", "--max_query_length", "16", "--max_passage_length", "16",
        "--k", "10", "--cutoffs", "1,5,10", "--device", "cpu"])
    (name, metrics), = results.items()
    idx = np.load(out / "s2" / f"{name}-indices.npy")
    scores = np.load(out / "s2" / f"{name}-scores.npy")
    assert idx.shape == scores.shape == (8, 10)
    assert metrics == j_compute_metrics(idx, scores, [[i] for i in range(8)],
                                        cutoffs=[1, 5, 10])


def test_dropout_is_live_in_stage1_and_repeats(workspace, tmp_path):
    """Stage 1 of the Roberta body draws its masks from a generator seeded
    from --seed, step and micro-batch: a rerun repeats the losses bit for
    bit, another seed changes them."""
    base = _base(workspace, "xlm-roberta")
    assert load_pretrained(base)[0].hidden_dropout == 0.1  # HF's default, BGE's rate

    def run(out, seed):
        return [h["loss"] for h in run_contrastive.main([
            "--model_name_or_path", base, "--tokenizer_name", TOK,
            "--train_data", str(workspace / "train.jsonl"), "--output_dir", str(out),
            "--learning_rate", "1e-3", "--per_device_train_batch_size", "4",
            "--num_negatives", "3", "--max_query_length", "16",
            "--max_passage_length", "16", "--max_steps", "2", "--seed", str(seed),
            "--save_strategy", "no", "--device", "cpu"])]

    a, b = run(tmp_path / "a", 3), run(tmp_path / "b", 3)
    assert a == b
    assert run(tmp_path / "c", 4) != a


@pytest.mark.parametrize("kind", ["xlm-roberta", "bert", "qwen2"])
def test_serve_answers_search(workspace, kind):
    base = _base(workspace, kind)
    tok = resolve_tokenizer(TOK, base)
    cfg = _config(kind)
    assert tok.pad_token_id == cfg.pad_token_id
    assert tok.cls_token_id == (0 if cfg.pad_token_id == 1 else 1)
    server = serve_cli.make_server([
        "--model_name_or_path", base, "--tokenizer_name", TOK,
        "--corpus_data", str(workspace / "corpus.jsonl"), "--max_query_length", "16",
        "--max_passage_length", "16", "--batch_size", "8", "--serving_k_max", "10",
        "--port", "0", "--device", "cpu", "--log_level", "warning"])
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/search", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        query = "job opening about subject 3 methods"
        code, body = post({"query": query, "k": 5})
        assert code == 200
        direct = server.service.query(query, k=5)
        assert [h["index"] for h in body["results"][0]["hits"]] == [
            h["index"] for h in direct["hits"]]
        code, body = post({"queries": [query, "field 7"], "k": 3})
        assert code == 200 and [len(r["hits"]) for r in body["results"]] == [3, 3]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
