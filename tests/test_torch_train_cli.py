"""The port's training CLIs end to end on the CPU (``--device cpu``).

Stage 1 (``rankpo_tpu_torch.cli.run_contrastive``) trains a tiny llama from
a checkpoint written by the port; stage 2 (``run_rankpo``) trains on stage
1's output with a frozen reference model. The written directories are read
back by both packages' ``load_pretrained``: the tensors must be equal bit
for bit (fp32 files). Flags of features not ported must fail naming
ROADMAP.md, and ``--device cuda`` must fail without a card.
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
        "checkpoint-3", "config.json", "model.safetensors", "train_results.json",
        "trainer_history.json"]
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
    ["--use_lora", "True"], ["--pack_sequences", "True"], ["--streaming", "True"],
    ["--optim", "adafactor"], ["--gradient_checkpointing_policy", "dots"],
    ["--eval_strategy", "epoch"], ["--grad_cache", "True"],
])
def test_unported_flags_fail(workdir, tmp_path, flag):
    module = run_rankpo if flag[0] == "--use_lora" else run_contrastive
    if module is run_rankpo:
        argv = ["--model_name_or_path", str(workdir / "base"), "--tokenizer_name", "hash:256",
                "--train_data", str(workdir / "pairs.jsonl"), "--output_dir", str(tmp_path),
                "--device", "cpu", *flag]
    else:
        argv = _stage1_argv(workdir, tmp_path, *flag)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.main(argv)


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
