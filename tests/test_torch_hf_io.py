"""Checkpoint interop between the two packages (HF safetensors directories).

The port reads and writes safetensors itself (the machine with the card has
no ``safetensors`` package); the package installed here is the independent
check of its files. Comparisons are bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models.config import tiny_llama_config
from rankpo_tpu_torch.models import hf_io
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.llama import state_names

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_model():
    cfg = tiny_llama_config(vocab_size=256)
    params = jenc.init_params(jax.random.key(3), cfg)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _port_cfg(cfg):
    return EncoderConfig(**dataclasses.asdict(cfg))


def _assert_state_equal(a, b):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def test_jax_checkpoint_loads_bit_exact(jax_model, tmp_path):
    cfg, params = jax_model
    jhf.save_pretrained(str(tmp_path), cfg, params)
    pcfg, state = hf_io.load_pretrained(str(tmp_path))
    assert pcfg == _port_cfg(cfg)
    _assert_state_equal(state, hf_io.params_from_jax(params, pcfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_files_round_trip(jax_model, tmp_path, dtype):
    cfg, params = jax_model
    pcfg = _port_cfg(cfg)
    state = hf_io.params_from_jax(params, pcfg)
    hf_io.save_pretrained(str(tmp_path), pcfg, state, dtype=dtype)
    _, back = hf_io.load_pretrained(str(tmp_path))
    _assert_state_equal(back, {n: t.to(dtype) for n, t in state.items()})

    from safetensors.torch import load_file  # the reference reader

    ref = load_file(str(tmp_path / "model.safetensors"))
    assert sorted(ref) == sorted(state_names(pcfg))
    for name in ref:
        assert torch.equal(ref[name], back[name]), name
    if dtype == torch.float32:
        from safetensors.numpy import load_file as np_load

        arrays = np_load(str(tmp_path / "model.safetensors"))
        for name, arr in arrays.items():
            np.testing.assert_array_equal(arr, back[name].numpy())


def test_port_fp32_save_loads_in_jax(jax_model, tmp_path):
    cfg, params = jax_model
    pcfg = _port_cfg(cfg)
    hf_io.save_pretrained(str(tmp_path), pcfg, hf_io.params_from_jax(params, pcfg))
    jcfg, jparams = jhf.load_pretrained(str(tmp_path))
    assert jcfg == cfg
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_prefixed_and_truncated_files(jax_model, tmp_path):
    cfg, params = jax_model
    pcfg = _port_cfg(cfg)
    state = hf_io.params_from_jax(params, pcfg)
    pcfg.save_pretrained(str(tmp_path))
    path = str(tmp_path / "model.safetensors")
    # a LlamaForCausalLM-style save: 'model.' prefix plus an lm_head
    prefixed = {"model." + n: t for n, t in state.items()}
    prefixed["lm_head.weight"] = state["embed_tokens.weight"]
    hf_io.write_safetensors(path, prefixed)
    _, back = hf_io.load_pretrained(str(tmp_path))
    _assert_state_equal(back, state)

    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-16])
    with pytest.raises(ValueError, match="truncated"):
        hf_io.load_pretrained(str(tmp_path))


def test_header_is_valid_json_padded_to_8(tmp_path):
    path = str(tmp_path / "x.safetensors")
    hf_io.write_safetensors(path, {"a": torch.arange(3, dtype=torch.float32)})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and header["a"]["data_offsets"] == [0, 12]
    assert os.path.getsize(path) == 8 + n + 12
