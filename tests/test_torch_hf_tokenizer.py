"""HuggingFace tokenizers in the port's training CLIs, against the JAX
package (after tests/test_hf_tokenizer_path.py): the pad-token rule and the
seven domain special tokens (``prepare_tokenizer``), the embedding resize
(``resize_token_embeddings``: the new rows the fp32 mean of the old, bit-equal
to the JAX package's), and stage 1 then stage 2 through the CLIs with a
``PreTrainedTokenizerFast`` built offline from a ``tokenizers`` WordLevel
model, the tokenizer saved beside every model directory and loaded again.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from rankpo_tpu.cli.arguments import ModelArguments as JaxModelArguments
from rankpo_tpu.cli.run_contrastive import setup_model_and_tokenizer as jax_setup
from rankpo_tpu.data import tokenization as jtok
from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models.config import tiny_llama_config as jax_tiny
from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
from rankpo_tpu_torch.cli.arguments import ModelArguments
from rankpo_tpu_torch.data import tokenization as ptok
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.encoder import resize_token_embeddings
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained

torch.set_num_threads(2)

WORDS = ["job", "doc", "about", "topic", "methods", "research"] + [f"w{i}" for i in range(50)]


def _fast_tokenizer(with_llama_pad: bool = True):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "</s>": 1}
    if with_llama_pad:
        vocab[ptok.LLAMA_PAD_TOKEN] = 2
    for w in WORDS:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="</s>")


def test_special_tokens_are_the_jax_packages():
    assert ptok.LLAMA_PAD_TOKEN == jtok.LLAMA_PAD_TOKEN
    assert ptok.DOMAIN_SPECIAL_TOKENS == jtok.DOMAIN_SPECIAL_TOKENS


@pytest.mark.parametrize("with_llama_pad", [True, False])
def test_prepare_tokenizer_matches_jax(with_llama_pad):
    """The same pad token and id, vocabulary size and ids; idempotent."""
    p, j = _fast_tokenizer(with_llama_pad), _fast_tokenizer(with_llama_pad)
    assert p.pad_token is None
    n_p, n_j = ptok.prepare_tokenizer(p), jtok.prepare_tokenizer(j)
    assert n_p == n_j == len(p) == len(WORDS) + 2 + with_llama_pad + 7
    assert p.pad_token == j.pad_token == (ptok.LLAMA_PAD_TOKEN if with_llama_pad else "</s>")
    assert p.pad_token_id == j.pad_token_id
    text = "<title> research methods </title> <sep> w3 w49 unknown"
    assert p(text)["input_ids"] == j(text)["input_ids"]
    assert ptok.prepare_tokenizer(p) == n_p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("new_size", [1067, 60, 50])
def test_resize_mean_rows_bit_equal_to_jax(dtype, new_size):
    """Grow: the new rows are the fp32 mean of the old rows cast to the
    table's dtype, bit-equal to the JAX package's; shrink cuts rows."""
    old = 1000 if new_size > 1000 else 60  # 1000 rows: two levels of XLA's tree sum
    cfg = jax_tiny(vocab_size=old)
    params = jenc.init_params(jax.random.key(5), cfg)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params["embed_tokens"]["weight"] = params["embed_tokens"]["weight"].astype(jdt)
    jparams, jcfg = jenc.resize_token_embeddings(params, cfg, new_size)
    pcfg = tiny_llama_config(vocab_size=old)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    state["embed_tokens.weight"] = state["embed_tokens.weight"].to(dtype)
    before = state["embed_tokens.weight"].clone()
    new_state, new_cfg = resize_token_embeddings(state, pcfg, new_size)
    assert new_cfg.vocab_size == jcfg.vocab_size == new_size and pcfg.vocab_size == old
    table = new_state["embed_tokens.weight"]
    assert table.dtype == dtype and table.shape == (new_size, 64)
    ref = np.asarray(jparams["embed_tokens"]["weight"].astype(jnp.float32))
    np.testing.assert_array_equal(table.float().numpy(), ref)
    assert torch.equal(state["embed_tokens.weight"], before)  # input untouched


def test_resize_normal_rows_from_a_generator():
    cfg = tiny_llama_config(vocab_size=60)
    state = llama.init_params(cfg, torch.Generator().manual_seed(0))
    a, _ = resize_token_embeddings(state, cfg, 2060, torch.Generator().manual_seed(3))
    b, _ = resize_token_embeddings(state, cfg, 2060, torch.Generator().manual_seed(3))
    new = a["embed_tokens.weight"][60:]
    assert torch.equal(new, b["embed_tokens.weight"][60:])
    assert abs(new.std().item() - 0.02) < 1e-3 and abs(new.mean().item()) < 1e-3


@pytest.fixture(scope="module")
def hf_workdir(tmp_path_factory):
    """A tiny checkpoint at the tokenizer's own vocabulary (no special
    tokens yet), the tokenizer saved beside it, and training files."""
    d = tmp_path_factory.mktemp("hf_cli")
    tok = _fast_tokenizer()
    cfg = tiny_llama_config(vocab_size=len(tok))
    cfg.pad_token_id = None  # set from the tokenizer by the setup
    save_pretrained(str(d / "base"), cfg, llama.init_params(cfg, torch.Generator().manual_seed(1)))
    tok.save_pretrained(str(d / "base"))
    rng = np.random.default_rng(0)

    def text(lo, hi):
        words = rng.choice(WORDS, int(rng.integers(lo, hi)))
        return "<title> " + " ".join(words) + " </title>"

    with open(d / "train.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"query": text(2, 6), "positives": [text(5, 12)],
                                "negatives": [text(3, 12) for _ in range(3)]}) + "\n")
    with open(d / "pairs.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps({"query": text(2, 6), "passage1": text(5, 12),
                                "passage2": text(5, 12), "preferred": "AB"[i % 2],
                                "confidence_score": 0.9}) + "\n")
    return d


def test_setup_model_and_tokenizer_matches_jax(hf_workdir):
    """The port's setup resizes the table to the prepared vocabulary and
    sets the pad id as the JAX CLI does: the same size, pad id and table."""
    base = str(hf_workdir / "base")
    config, state, tok, pad_id = run_contrastive.setup_model_and_tokenizer(
        ModelArguments(model_name_or_path=base))
    jcfg, jparams, jtok_, jpad = jax_setup(JaxModelArguments(model_name_or_path=base))
    assert config.vocab_size == jcfg.vocab_size == len(tok) == len(WORDS) + 3 + 7
    assert pad_id == jpad == config.pad_token_id == jcfg.pad_token_id == 2
    np.testing.assert_array_equal(state["embed_tokens.weight"].numpy(),
                                  np.asarray(jparams["embed_tokens"]["weight"]))


def test_two_stages_with_an_hf_tokenizer(hf_workdir):
    """Stage 1 for 2 steps with the tokenizer (loaded from the checkpoint
    directory), then stage 2 from its output: every saved directory holds
    the tokenizer with the added tokens, the resized table loads, and the
    second stage resizes nothing."""
    d = hf_workdir
    hist1 = run_contrastive.main([
        "--model_name_or_path", str(d / "base"), "--train_data", str(d / "train.jsonl"),
        "--output_dir", str(d / "s1"), "--per_device_train_batch_size", "4",
        "--num_negatives", "3", "--max_query_length", "16", "--max_passage_length", "16",
        "--learning_rate", "1e-3", "--max_steps", "2", "--save_steps", "2",
        "--device", "cpu"])
    assert [h["global_step"] for h in hist1] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist1)
    n_vocab = len(WORDS) + 3 + 7
    for out in (d / "s1", d / "s1" / "checkpoint-2"):
        assert os.path.isfile(out / "tokenizer.json"), sorted(os.listdir(out))
        tok = ptok.resolve_tokenizer(None, str(out))
        assert len(tok) == n_vocab and tok.pad_token == ptok.LLAMA_PAD_TOKEN
        assert tok.convert_tokens_to_ids("<sep>") == n_vocab - 1
        cfg, state = load_pretrained(str(out))
        assert cfg.vocab_size == n_vocab and cfg.pad_token_id == 2
        assert state["embed_tokens.weight"].shape[0] == n_vocab
    hist2 = run_rankpo.main([
        "--model_name_or_path", str(d / "s1"), "--train_data", str(d / "pairs.jsonl"),
        "--output_dir", str(d / "s2"), "--per_device_train_batch_size", "4",
        "--max_query_length", "16", "--max_passage_length", "16", "--reference_free", "True",
        "--learning_rate", "1e-3", "--max_steps", "2", "--save_strategy", "no",
        "--device", "cpu"])
    assert [h["global_step"] for h in hist2] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist2)
    cfg, _ = load_pretrained(str(d / "s2"))
    assert cfg.vocab_size == n_vocab
    assert len(ptok.resolve_tokenizer(None, str(d / "s2"))) == n_vocab
