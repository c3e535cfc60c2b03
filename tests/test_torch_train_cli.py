"""The port's training CLIs end to end on the CPU (``--device cpu``).

Stage 1 (``rankpo_tpu_torch.cli.run_contrastive``) trains a tiny llama from
a checkpoint written by the port; stage 2 (``run_rankpo``) trains on stage
1's output with a frozen reference model. The written directories are read
back by both packages' ``load_pretrained``: the tensors must be equal bit
for bit (fp32 files). The flags of ROADMAP.md Queue 1 item 7 (LoRA, the
in-training retrieval evaluation, streaming) train, and ``--device cuda``
must fail without a card.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rankpo_tpu.models import load_pretrained as jload
from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained

torch.set_num_threads(2)

WORDS = [f"w{i}" for i in range(80)]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    cfg = tiny_llama_config(vocab_size=256)
    save_pretrained(str(d / "base"), cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))

    with open(d / "train.jsonl", "w") as f:
        for _ in range(32):
            f.write(json.dumps({"query": text(2, 8), "positives": [text(5, 20)],
                                "negatives": [text(3, 30) for _ in range(7)]}) + "\n")
    with open(d / "pairs.jsonl", "w") as f:
        for i in range(24):
            f.write(json.dumps({"query": text(2, 8), "passage1": text(5, 20),
                                "passage2": text(5, 20), "preferred": "AB"[i % 2],
                                "confidence_score": 0.9}) + "\n")
    return d


def _stage1_argv(d, out, *extra):
    return ["--model_name_or_path", str(d / "base"), "--tokenizer_name", "hash:256",
            "--train_data", str(d / "train.jsonl"), "--output_dir", str(out),
            "--per_device_train_batch_size", "4", "--num_negatives", "3",
            "--gradient_accumulation_steps", "2", "--max_query_length", "16",
            "--max_passage_length", "32", "--temperature", "0.05",
            "--learning_rate", "1e-3", "--lr_scheduler_type", "cosine",
            "--warmup_ratio", "0.5", "--max_steps", "3", "--bf16", "True",
            "--gradient_checkpointing", "True", "--save_total_limit", "1",
            "--device", "cpu", *extra]


def _assert_loads_in_both(directory, state_before):
    cfg, state = load_pretrained(str(directory))
    jcfg, jparams = jload(str(directory))
    from_jax = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert list(state) == list(from_jax) == llama.state_names(cfg)
    for name, t in state.items():
        assert t.dtype == torch.float32
        assert torch.equal(t, from_jax[name]), name
    moved = [n for n in state if not torch.equal(state[n], state_before[n])]
    assert len(moved) == len(state), set(state) - set(moved)
    return state


def test_two_stages_end_to_end_on_cpu(workdir):
    d = workdir
    _, base = load_pretrained(str(d / "base"))
    hist1 = run_contrastive.main(_stage1_argv(d, d / "s1"))
    assert [h["global_step"] for h in hist1] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist1)
    # one warmup step (int(0.5 * 3)): the first logged rate is 0, then the peak
    assert [h["learning_rate"] for h in hist1[:2]] == [0.0, 1e-3]
    assert {"accuracy", "step_time", "samples_per_sec", "tokens_per_sec"} <= set(hist1[0])
    assert "mfu" not in hist1[0]  # no peak is known for the CPU
    assert hist1[0]["tokens_per_sec"] == pytest.approx(
        hist1[0]["samples_per_sec"] * (16 + 4 * 32), rel=0.01)
    s1 = _assert_loads_in_both(d / "s1", base)
    assert sorted(os.listdir(d / "s1")) == [
        "README.md", "checkpoint-3", "config.json", "model.safetensors",
        "train_results.json", "trainer_history.json"]
    assert os.path.isfile(d / "s1" / "checkpoint-3" / "README.md")  # the model card
    with open(d / "s1" / "checkpoint-3" / "trainer_state.json") as f:
        assert json.load(f) == {"global_step": 3, "epoch": 0}
    with open(d / "s1" / "train_results.json") as f:
        results = json.load(f)
    assert results["train_steps"] == 3 and results["final_loss"] == hist1[-1]["loss"]

    hist2 = run_rankpo.main([
        "--model_name_or_path", str(d / "s1"), "--tokenizer_name", "hash:256",
        "--train_data", str(d / "pairs.jsonl"), "--output_dir", str(d / "s2"),
        "--per_device_train_batch_size", "4", "--max_query_length", "16",
        "--max_passage_length", "32", "--beta", "2.0", "--temperature", "0.1",
        "--loss_type", "sigmoid", "--reference_free", "False", "--sft_weight", "0.1",
        "--learning_rate", "1e-3", "--max_steps", "4", "--bf16", "True",
        "--save_strategy", "no", "--device", "cpu"])
    assert [h["global_step"] for h in hist2] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist2)
    # the frozen reference starts equal to the policy: zero reward margin
    assert hist2[0]["rewards/chosen"] == pytest.approx(0.0, abs=1e-6)
    assert {"rankpo_loss", "sft_loss", "rewards/accuracies", "scores/margins"} <= set(hist2[0])
    _assert_loads_in_both(d / "s2", s1)
    assert "checkpoint-4" not in os.listdir(d / "s2")


@pytest.mark.parametrize("flag", [
    ["--use_lora", "True"], ["--retrieval_eval_query_file", "q.jsonl"], ["--streaming", "True"],
])
def test_formerly_unported_flags_train(workdir, tmp_path, flag):
    """The three flags the port refused before it had ROADMAP.md Queue 1
    item 7 train, each checked by its own output: LoRA moves only the
    adapted projections and saves the merge; the retrieval evaluation logs
    ``retrieval_*`` metrics; streaming gives the eager run's losses."""
    d = workdir
    _, base = load_pretrained(str(d / "base"))
    if flag[0] == "--use_lora":
        hist = run_rankpo.main([
            "--model_name_or_path", str(d / "base"), "--tokenizer_name", "hash:256",
            "--train_data", str(d / "pairs.jsonl"), "--output_dir", str(tmp_path),
            "--per_device_train_batch_size", "4", "--max_query_length", "16",
            "--max_passage_length", "32", "--reference_free", "True",
            "--learning_rate", "1e-2", "--max_steps", "2", "--save_strategy", "no",
            "--device", "cpu", *flag])
        assert all(np.isfinite(h["loss"]) for h in hist)
        _, saved = load_pretrained(str(tmp_path))
        moved = {n for n in saved if not torch.equal(saved[n], base[n])}
        assert moved == {f"layers.{i}.self_attn.{p}.weight" for i in range(2)
                         for p in ("q_proj", "v_proj")}
        return
    if flag[0] == "--retrieval_eval_query_file":
        with open(tmp_path / "q.jsonl", "w") as f:
            for i in range(4):
                f.write(json.dumps({"query": {"text": f"w{i} w{i + 1}"},
                                    "positives": {"index": [i]}}) + "\n")
        with open(tmp_path / "c.jsonl", "w") as f:
            for i in range(12):
                f.write(json.dumps({"text": f"w{i} w{i + 1} w{i + 2}"}) + "\n")
        flag = ["--retrieval_eval_query_file", str(tmp_path / "q.jsonl"),
                "--retrieval_eval_corpus_file", str(tmp_path / "c.jsonl"),
                "--eval_strategy", "steps", "--eval_steps", "3", "--retrieval_eval_k", "10"]
        hist = run_contrastive.main(_stage1_argv(d, tmp_path / "out", *flag))
        ev = [h for h in hist if "retrieval_MRR@1" in h]
        assert len(ev) == 1 and ev[0]["global_step"] == 3
        assert 0.0 <= ev[0]["retrieval_nDCG@10"] <= 1.0
        return
    eager = run_contrastive.main(_stage1_argv(d, tmp_path / "eager", "--save_strategy", "no"))
    hist = run_contrastive.main(_stage1_argv(d, tmp_path / "out", "--save_strategy", "no",
                                             *flag))
    assert [(h["loss"], h["grad_norm"]) for h in hist] == [
        (h["loss"], h["grad_norm"]) for h in eager]


@pytest.mark.parametrize("flag", [
    ["--optim", "adafactor"], ["--gradient_checkpointing_policy", "dots"],
    ["--eval_strategy", "epoch"], ["--grad_cache", "True"],
])
def test_ported_flags_train(workdir, tmp_path, flag):
    """Flags the port refused before it had item 2 and gradient caching:
    stage 1 trains with each."""
    extra = []
    if flag[0] == "--eval_strategy":  # one whole epoch (4 steps), then its eval
        extra = ["--eval_data", str(workdir / "train.jsonl"), "--max_steps", "-1",
                 "--num_train_epochs", "1"]
    hist = run_contrastive.main(_stage1_argv(workdir, tmp_path, *flag, *extra))
    steps = [h for h in hist if "loss" in h]
    assert [h["global_step"] for h in steps] == ([1, 2, 3, 4] if extra else [1, 2, 3])
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in steps)
    if extra:
        assert np.isfinite(hist[-1]["eval_loss"])


def test_pack_sequences_trains(workdir, tmp_path):
    """``--pack_sequences True``: stage 1 packs each micro-batch's texts
    several to a row and trains; the output loads in both packages."""
    _, base = load_pretrained(str(workdir / "base"))
    hist = run_contrastive.main(_stage1_argv(workdir, tmp_path, "--pack_sequences", "True",
                                             "--pack_max_segments", "8"))
    assert [h["global_step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    _assert_loads_in_both(tmp_path, base)


def test_cuda_device_without_card_fails(workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    argv = _stage1_argv(workdir, tmp_path)
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_contrastive.main(argv)
    assert not os.listdir(tmp_path)


def test_output_dir_guard(workdir, tmp_path):
    (tmp_path / "keep.txt").write_text("x")
    with pytest.raises(ValueError, match="overwrite_output_dir"):
        run_contrastive.main(_stage1_argv(workdir, tmp_path))
