"""HuggingFace checkpoint interop for the port (``rankpo_tpu.models.hf_io``).

The state dict uses HF tensor names and the ``[out, in]`` Linear layout, so a
directory written by ``rankpo_tpu.models.hf_io.save_pretrained`` loads here
unchanged, and one written here loads in the JAX package (fp32 files).

The safetensors format is read and written by this module itself, because
the machine with the card has no ``safetensors`` package: an 8-byte
little-endian header length, a JSON header mapping each tensor name to
``{"dtype", "shape", "data_offsets"}`` (offsets relative to the end of the
header), then the raw little-endian buffers back to back.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.llama import check_supported, state_names

_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(
                    f"{path}: tensor {name} has dtype {info['dtype']}; "
                    f"supported: {sorted(_DTYPES)}"
                )
            start, end = info["data_offsets"]
            raw = torch.empty(end - start, dtype=torch.uint8)
            f.seek(base + start)
            if f.readinto(raw.numpy()) != end - start:
                raise ValueError(f"{path}: tensor {name} is truncated")
            out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write fp32/bf16 tensors (any device) as one .safetensors file."""
    header: Dict[str, dict] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} not in {list(_NAMES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the format pads the header to 8 bytes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(flat.view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def _strip_prefix(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A saved LlamaForCausalLM prefixes 'model.'; bare saves have none."""
    prefix = "model."
    if any(k.startswith(prefix) for k in state):
        state = {(k[len(prefix):] if k.startswith(prefix) else k): v
                 for k, v in state.items()}
    return state


def load_pretrained(path: str):
    """(config, state dict of CPU tensors) from an HF-format directory. Only
    the encoder's tensors are kept (an LM head, if present, is dropped)."""
    config = EncoderConfig.from_pretrained(path)
    check_supported(config)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    raw: Dict[str, torch.Tensor] = {}
    for f in files:
        raw.update(read_safetensors(f))
    raw = _strip_prefix(raw)
    missing = [n for n in state_names(config) if n not in raw]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} tensors, e.g. {missing[:3]}")
    return config, {n: raw[n] for n in state_names(config)}


def save_pretrained(
    path: str,
    config: EncoderConfig,
    state: Dict[str, torch.Tensor],
    dtype: torch.dtype = torch.float32,
) -> None:
    """Write ``config.json`` and ``model.safetensors`` with every tensor in
    ``dtype`` (fp32, which the JAX package reads, or bf16)."""
    check_supported(config)
    os.makedirs(path, exist_ok=True)
    config.save_pretrained(path)
    write_safetensors(
        os.path.join(path, "model.safetensors"),
        {n: state[n].to(dtype) for n in state_names(config)},
    )


def params_from_jax(params: dict, config: EncoderConfig) -> Dict[str, torch.Tensor]:
    """The JAX llama pytree (stacked layers, kernels ``[L, in, out]``, as
    numpy arrays or anything ``np.asarray`` takes) -> the port's fp32 state
    dict (HF names, ``[out, in]``)."""
    check_supported(config)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    layers = params["layers"]
    state = {"embed_tokens.weight": t(params["embed_tokens"]["weight"])}
    for i in range(config.num_hidden_layers):
        p = f"layers.{i}."
        state[p + "input_layernorm.weight"] = t(layers["input_layernorm"]["weight"][i])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            state[p + f"self_attn.{proj}.weight"] = t(layers[proj]["kernel"][i]).T.contiguous()
        state[p + "post_attention_layernorm.weight"] = t(
            layers["post_attention_layernorm"]["weight"][i]
        )
        for proj in ("gate_proj", "up_proj", "down_proj"):
            state[p + f"mlp.{proj}.weight"] = t(layers[proj]["kernel"][i]).T.contiguous()
    state["norm.weight"] = t(params["norm"]["weight"])
    return state
