"""The port's streaming dataset (``data/datasets.py``
``StreamingContrastiveDataset``) and ``run_contrastive --streaming True``.

- every item equals the eager ``ContrastiveDataset``'s on the same file, and
  the JAX ``StreamingContrastiveDataset``'s, row for row (token ids are
  integers: equal exactly); blank lines are skipped as the eager loader
  skips them;
- the dataset pickles and unpickles, each copy with its own file handle,
  and is read from several threads at once;
- stage 1 with ``--streaming True`` gives losses and gradient norms bit
  for bit equal to the same run without it: plain, packed
  (``--pack_sequences``), and resumed from a checkpoint (the loader's
  replay).
"""

import json
import pickle
import threading

import numpy as np
import pytest
import torch

from rankpo_tpu.data.datasets import StreamingContrastiveDataset as JStreaming
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu_torch.cli import run_contrastive
from rankpo_tpu_torch.data import ContrastiveDataset, StreamingContrastiveDataset
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import save_pretrained

torch.set_num_threads(2)

WORDS = [f"w{i}" for i in range(80)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("streaming")
    rng = np.random.default_rng(0)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))

    rows = [{"query": text(2, 8), "positives": [text(5, 20) for _ in range(1 + i % 2)],
             "negatives": [text(3, 30) for _ in range(7)]} for i in range(32)]
    with open(d / "train.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    cfg = tiny_llama_config(vocab_size=256)
    save_pretrained(str(d / "base"), cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    return d


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def test_items_equal_eager_and_jax(data, tmp_path):
    tok = HashTokenizer(vocab_size=256)
    path = str(data / "train.jsonl")
    stream = StreamingContrastiveDataset(path, tok, 8, 24)
    eager = ContrastiveDataset(path, tok, 8, 24)
    jax_stream = JStreaming(path, JHashTokenizer(vocab_size=256), 8, 24)
    assert len(stream) == len(eager) == len(jax_stream) == 32
    for a, b, c in zip(_items(stream), _items(eager), _items(jax_stream)):
        assert a == b
        assert a == {k: [list(x) for x in v] if k != "query" else list(v) for k, v in c.items()}
    # a blank line in the middle and none at the end: skipped, as eagerly
    lines = (data / "train.jsonl").read_text().splitlines()
    gappy = tmp_path / "gappy.jsonl"
    gappy.write_text("\n".join(lines[:5] + ["", "  "] + lines[5:]))
    assert _items(StreamingContrastiveDataset(str(gappy), tok, 8, 24)) == _items(eager)


def test_pickles_and_reads_from_threads(data):
    ds = StreamingContrastiveDataset(str(data / "train.jsonl"), HashTokenizer(vocab_size=256),
                                     8, 24)
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._file is not ds._file and not copy._file.closed
    assert _items(copy) == _items(ds)
    got = {}

    def read(lo):
        got[lo] = [copy[i] for i in range(lo, len(copy), 4)]

    threads = [threading.Thread(target=read, args=(lo,)) for lo in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for lo in range(4):
        assert got[lo] == [ds[i] for i in range(lo, len(ds), 4)]


def _argv(d, out, *extra):
    return ["--model_name_or_path", str(d / "base"), "--tokenizer_name", "hash:256",
            "--train_data", str(d / "train.jsonl"), "--output_dir", str(out),
            "--per_device_train_batch_size", "4", "--num_negatives", "3",
            "--gradient_accumulation_steps", "2", "--max_query_length", "16",
            "--max_passage_length", "32", "--temperature", "0.05",
            "--learning_rate", "1e-3", "--max_steps", "3", "--bf16", "True",
            "--device", "cpu", *extra]


def _steps(history):
    return [(h["global_step"], h["loss"], h["grad_norm"]) for h in history if "loss" in h]


@pytest.mark.parametrize("extra", [[], ["--pack_sequences", "True", "--pack_max_segments", "8"]])
def test_streaming_stage1_bit_equal(data, tmp_path, extra):
    eager = run_contrastive.main(_argv(data, tmp_path / "eager", "--save_strategy", "no",
                                       *extra))
    stream = run_contrastive.main(_argv(data, tmp_path / "stream", "--save_strategy", "no",
                                        "--streaming", "True", *extra))
    assert len(_steps(eager)) == 3
    assert _steps(stream) == _steps(eager)


def test_streaming_resume_replays_bit_equal(data, tmp_path):
    """Resumed from the checkpoint of step 1: the loader replays the skipped
    batches over the streamed rows, so steps 2 and 3 are the uninterrupted
    eager run's."""
    eager = run_contrastive.main(_argv(data, tmp_path / "eager", "--save_strategy", "no"))
    common = ["--streaming", "True", "--save_strategy", "steps", "--save_steps", "1",
              "--save_only_model", "False"]
    first = run_contrastive.main(_argv(data, tmp_path / "first", *common))
    assert _steps(first) == _steps(eager)
    resumed = run_contrastive.main(_argv(data, tmp_path / "resumed", *common,
                                         "--resume_from_checkpoint",
                                         str(tmp_path / "first" / "checkpoint-1")))
    assert _steps(resumed) == _steps(eager)[1:]
