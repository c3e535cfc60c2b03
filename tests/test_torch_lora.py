"""LoRA of the port (``models/lora.py`` and ``run_rankpo --use_lora``),
mirroring ``tests/test_lora.py``.

- the merge of JAX adapters carried over (``adapters_from_jax``) equals the
  JAX package's ``merge_lora`` in the llama and the XLM-Roberta body
  (rtol 1e-6: both sum the r products in fp32, in their own order), and
  ``merge_lora`` over a state dict equals the model's merge bit for bit;
- a fresh adapter (B = 0) leaves the embeddings and the merged state bit
  for bit as they were;
- an unknown target raises with the list of the body's targets;
- the adapters hold under 10% of the base's parameters;
- ``run_rankpo --use_lora``: one step moves only the adapters (every other
  tensor of the saved model equals the base bit for bit), the saved model is
  the merge of the base and the saved adapters bit for bit and loads in both
  packages, the card carries the ``lora`` tag, the optimizer state holds the
  adapters alone, and a resumed run continues.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models import load_pretrained as jload
from rankpo_tpu.models.config import tiny_llama_config as jtiny_llama
from rankpo_tpu.models.config import tiny_roberta_config as jtiny_roberta
from rankpo_tpu.models.lora import LoraConfig as JLoraConfig
from rankpo_tpu.models.lora import init_lora_params, merge_lora as jmerge
from rankpo_tpu_torch.cli import run_rankpo
from rankpo_tpu_torch.models import lora
from rankpo_tpu_torch.models.config import EncoderConfig, tiny_llama_config
from rankpo_tpu_torch.models.encoder import embed, encoder_class
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained
from rankpo_tpu_torch.models import llama

torch.set_num_threads(2)

MERGE_RTOL = 1e-6


def _jax_setup(body):
    jcfg = jtiny_llama(vocab_size=128) if body == "llama" else jtiny_roberta(vocab_size=128)
    params = jinit(jax.random.key(0), jcfg)
    targets = ("q_proj", "v_proj") if body == "llama" else ("query", "value")
    lcfg = JLoraConfig(r=4, alpha=8.0, target_modules=targets)
    tree = init_lora_params(jax.random.key(1), params, lcfg)
    # a trained-looking B, so the merge is not the identity
    tree = {name: {"lora_a": np.asarray(ab["lora_a"]),
                   "lora_b": np.random.default_rng(2).normal(
                       0, 0.1, ab["lora_b"].shape).astype(np.float32)}
            for name, ab in tree.items()}
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    return jcfg, params, lcfg, tree, pcfg, state


def _port_model(pcfg, state):
    return encoder_class(pcfg).for_training(pcfg, state, device="cpu",
                                            compute_dtype=torch.float32)


@pytest.mark.parametrize("body", ["llama", "roberta"])
def test_merge_of_carried_adapters_matches_jax(body):
    jcfg, params, lcfg, tree, pcfg, state = _jax_setup(body)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jmerge(params, tree, lcfg)),
                           pcfg)
    model = _port_model(pcfg, state)
    plcfg = lora.LoraConfig(r=4, alpha=8.0, target_modules=lcfg.target_modules)
    lora.apply_lora(model, plcfg, adapters=lora.adapters_from_jax(tree))
    got = lora.merged_state_dict(model)
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=MERGE_RTOL,
                                   atol=1e-7, err_msg=name)
        moved += not torch.equal(w, state[name])
    assert moved == 2 * pcfg.num_hidden_layers  # the two targets of every layer
    # the same fold over a state dict, bit for bit
    again = lora.merge_lora(state, lora.adapter_state_dict(model), plcfg.scaling)
    for name, t in got.items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("body", ["llama", "roberta"])
def test_identity_at_init_bit_equal(body):
    *_, pcfg, state = _jax_setup(body)
    base = _port_model(pcfg, state)
    adapted = lora.apply_lora(_port_model(pcfg, state), lora.LoraConfig(
        r=4, alpha=8.0, target_modules=tuple(lora.auto_targets(pcfg).split(","))),
        torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    batch = {"input_ids": torch.randint(5, 128, (2, 8), generator=g),
             "attention_mask": torch.ones(2, 8, dtype=torch.int64)}
    with torch.no_grad():
        assert torch.equal(embed(base, batch, attn_impl="plain"),
                           embed(adapted, batch, attn_impl="plain"))
    merged = lora.merged_state_dict(adapted)
    for name, t in base.state_dict().items():
        assert torch.equal(merged[name], t), name


def test_adapters_train_alone_and_count_is_small():
    *_, pcfg, state = _jax_setup("llama")
    model = lora.apply_lora(_port_model(pcfg, state), lora.LoraConfig(r=4, alpha=8.0),
                            torch.Generator().manual_seed(0))
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trainable and all(n.endswith((".lora_a", ".lora_b")) for n in trainable)
    assert len(trainable) == 2 * 2 * pcfg.num_hidden_layers
    adapters = lora.count_params(p for p in model.parameters() if p.requires_grad)
    base = lora.count_params(p for p in model.parameters() if not p.requires_grad)
    assert 0 < adapters < 0.1 * base
    a = model.layers[0].self_attn.q_proj.parametrizations.weight[0].lora_a
    assert a.shape == (pcfg.hidden_size, 4) and a.dtype == torch.float32
    # A ~ N(0, 1/d_in): the draw's spread is near 1/sqrt(d_in)
    assert abs(float(a.detach().std()) * pcfg.hidden_size ** 0.5 - 1.0) < 0.2


def test_unknown_target_raises():
    *_, pcfg, state = _jax_setup("llama")
    with pytest.raises(ValueError, match="available: .*'q_proj'"):
        lora.apply_lora(_port_model(pcfg, state), lora.LoraConfig(target_modules=("nope",)),
                        torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def lora_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_cli")
    cfg = tiny_llama_config(vocab_size=256)
    save_pretrained(str(d / "base"), cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    with open(d / "pairs.jsonl", "w") as f:
        for i in range(16):
            f.write(json.dumps({"query": f"q {i} w{i}", "passage1": f"doc {i} w{i + 1}",
                                "passage2": f"doc {i + 2} w{i}", "preferred": "AB"[i % 2]})
                    + "\n")
    return d


def _lora_argv(d, out, *extra):
    return ["--model_name_or_path", str(d / "base"), "--tokenizer_name", "hash:256",
            "--train_data", str(d / "pairs.jsonl"), "--output_dir", str(out),
            "--per_device_train_batch_size", "4", "--max_query_length", "16",
            "--max_passage_length", "16", "--beta", "2.0", "--temperature", "0.1",
            "--reference_free", "True", "--learning_rate", "1e-2", "--bf16", "True",
            "--use_lora", "True", "--lora_r", "4", "--lora_alpha", "8",
            "--gradient_checkpointing", "True", "--device", "cpu", *extra]


def test_cli_step_moves_only_adapters_and_saves_the_merge(lora_dir, tmp_path):
    d = lora_dir
    _, base = load_pretrained(str(d / "base"))
    hist = run_rankpo.main(_lora_argv(d, tmp_path, "--max_steps", "1",
                                      "--save_only_model", "False"))
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    cfg, saved = load_pretrained(str(tmp_path))
    adapters = torch.load(tmp_path / "lora_adapters.pt")
    assert len(adapters) == 2 * 2 * cfg.num_hidden_layers
    assert any(k.endswith(".lora_b") and t.abs().max() > 0 for k, t in adapters.items())
    targets = {k[: -len(".lora_a")] + ".weight" for k in adapters if k.endswith(".lora_a")}
    for name, t in saved.items():
        if name not in targets:
            assert torch.equal(t, base[name]), name
        else:
            assert not torch.equal(t, base[name]), name
    merged = lora.merge_lora(base, adapters, 8 / 4)
    for name, t in saved.items():
        assert torch.equal(merged[name], t), name
    # the JAX package reads the merged model: the same tensors
    _, jparams = jload(str(tmp_path))
    from_jax = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    for name, t in saved.items():
        assert torch.equal(from_jax[name], t), name
    assert "lora" in (tmp_path / "README.md").read_text()
    opt = torch.load(tmp_path / "checkpoint-1" / "opt_state.pt", weights_only=False)
    assert len(opt["optimizer"]["state"]) == len(adapters)


def test_cli_resume_reinitialises_adapters(lora_dir, tmp_path):
    """A resumed LoRA run (JAX's rule): the checkpoint's merged weights are
    the base, the adapters are drawn again from the seed, and the adapters'
    optimizer state and the counters come back."""
    d = lora_dir
    run_rankpo.main(_lora_argv(d, tmp_path, "--max_steps", "1", "--save_only_model", "False"))
    hist = run_rankpo.main(_lora_argv(d, tmp_path, "--max_steps", "2",
                                      "--save_only_model", "False",
                                      "--resume_from_checkpoint", "latest"))
    assert [h["global_step"] for h in hist] == [2]
    _, first = load_pretrained(str(tmp_path / "checkpoint-1"))
    _, second = load_pretrained(str(tmp_path / "checkpoint-2"))
    adapters = torch.load(tmp_path / "checkpoint-2" / "lora_adapters.pt")
    merged = lora.merge_lora(first, adapters, 8 / 4)
    for name, t in second.items():
        assert torch.equal(merged[name], t), name
