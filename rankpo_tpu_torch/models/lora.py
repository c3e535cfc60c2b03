"""LoRA adapters for the encoder bodies (port of ``rankpo_tpu.models.lora``;
reference src/rankpo_trainer.py:60-61, 127-165: PEFT's ``get_peft_model``
and ``merge_and_unload``).

Each targeted projection of each layer gets an A of [in, r] and a B of
[r, out] in the weight's dtype (the JAX package's per-layer slices of its
stacked [L, in, r] / [L, r, out] factors); A ~ N(0, 1/d_in), B = 0, so a
fresh adapter leaves the model as it was. The projection's weight becomes
``(W.float() + scaling * (A @ B).float()).to(W.dtype)``, transposed to
``nn.Linear``'s [out, in] layout: JAX's fp32 einsum, add and cast.

The merge is a ``torch.nn.utils.parametrize`` parametrization of the
targeted weights, so the bodies, ``models/base.py``'s ``linear()`` and its
checkpointing policies see a plain weight (``layer.weight`` is the merge)
and no code path of the bodies changes; a merge inside ``linear()`` would
put a LoRA branch on every projection of every model. :func:`apply_lora`
freezes everything else, so only A and B require grad and the Trainer's
optimizer holds them alone. :func:`merged_state_dict` is the model with the
adapters folded in (the ``merge_and_unload`` analogue, what the training
CLI saves), :func:`merge_lora` the same fold over a state dict.

Under tensor parallelism (a model whose ``tp`` is set) the adapters stay
whole and replicated on every rank of the model group, as JAX keeps them
(no rule of ``rankpo_tpu/parallel/sharding.py`` matches ``lora_a`` or
``lora_b``; only the frozen base is split). Each rank's merge folds in its
slice of the product: a column-parallel target (``tp_dim`` 0) takes the
columns of B for the rank's output rows, a row-parallel one (``tp_dim`` 1)
the rows of A for its input columns. A and B pass through
``sharding.copy_to_model`` before the slice, so each rank's adapter
gradient is the sum over the model group, and the ranks hold the same
gradient, optimizer state and update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

DEFAULT_TARGETS = ("q_proj", "v_proj")

# JAX target name -> the projection's path inside one layer, by body
_LLAMA_TARGETS = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                  "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                  "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                  "down_proj": "mlp.down_proj"}
_ROBERTA_TARGETS = {"query": "attention.self.query", "key": "attention.self.key",
                    "value": "attention.self.value", "attn_output": "attention.output.dense",
                    "intermediate": "intermediate.dense", "output": "output.dense"}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: float = 16.0
    target_modules: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def auto_targets(config) -> str:
    """``--lora_target_modules auto``: q_proj,v_proj for the llama body
    (Llama, Qwen2, Mistral, Gemma), query,value for Roberta/BERT (JAX
    ``run_rankpo.py:166-169``)."""
    return "q_proj,v_proj" if config.is_llama else "query,value"


def merge_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scaling: float) -> torch.Tensor:
    """``w`` [out, in] with the adapter (``a`` [in, r], ``b`` [r, out])
    folded in: the product and the sum in fp32, cast to ``w``'s dtype."""
    delta = torch.matmul(a.float(), b.float()) * scaling
    return (w.float() + delta.T).to(w.dtype)


class LoraMerge(nn.Module):
    """The parametrization of one targeted weight: ``W -> merge_weight``.
    With ``tp`` (the model axis) and the weight's split ``dim``, ``W`` is
    the rank's shard and the whole adapter's slice for it is folded in
    (module docstring)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scaling: float, tp=None,
                 dim: Optional[int] = None):
        super().__init__()
        self.lora_a = nn.Parameter(a)
        self.lora_b = nn.Parameter(b)
        self.scaling = scaling
        self.tp = tp if dim is not None else None
        self.dim = dim

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        a, b = self.lora_a, self.lora_b
        if self.tp is not None:
            from rankpo_tpu_torch.parallel.sharding import copy_to_model

            tp = self.tp
            a, b = copy_to_model(a, tp.group), copy_to_model(b, tp.group)
            if self.dim == 0:  # the rank's output rows: columns of B
                b = b.chunk(tp.size, 1)[tp.index]
            else:  # the rank's input columns: rows of A
                a = a.chunk(tp.size, 0)[tp.index]
        return merge_weight(w, a, b, self.scaling)


def _layers(model: nn.Module):
    """The body's layers, and the target table of its family."""
    if model.config.is_llama:
        return model.layers, _LLAMA_TARGETS
    return model.encoder.layer, _ROBERTA_TARGETS


def _check_targets(model: nn.Module, config: LoraConfig) -> None:
    _, table = _layers(model)
    for name in config.target_modules:
        if name not in table:
            raise ValueError(f"LoRA target {name!r} not found; available: {list(table)}")


def target_paths(model: nn.Module, config: LoraConfig):
    """(JAX target name, layer index, module path) of every adapted
    projection, in the JAX package's order: by target, then by layer."""
    _check_targets(model, config)
    layers, table = _layers(model)
    prefix = "layers" if model.config.is_llama else "encoder.layer"
    for name in config.target_modules:
        for i in range(len(layers)):
            yield name, i, f"{prefix}.{i}.{table[name]}"


def _split_dim(model: nn.Module, path: str) -> Optional[int]:
    """The model-axis dim of the weight at ``path`` (None without tensor
    parallelism or for a replicated weight)."""
    if getattr(model, "tp", None) is None:
        return None
    from rankpo_tpu_torch.parallel.sharding import tp_dim

    return tp_dim(f"{path}.weight")


def init_adapters(model: nn.Module, config: LoraConfig,
                  generator: torch.Generator) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """target -> (A [L, in, r], B [L, r, out]) in fp32: A ~ N(0, 1/d_in)
    drawn from ``generator``, one target after another, B = 0 (JAX
    ``init_lora_params``: a fan-in scale, so the adapter's effective
    learning rate does not move with r). The shapes are the whole
    weight's under tensor parallelism, so every model rank draws the same
    adapters."""
    _check_targets(model, config)
    layers, table = _layers(model)
    out = {}
    for name in config.target_modules:
        shape = list(layers[0].get_submodule(table[name]).weight.shape)
        dim = _split_dim(model, table[name])
        if dim is not None:
            shape[dim] *= model.tp.size
        d_out, d_in = shape
        a = torch.randn((len(layers), d_in, config.r), generator=generator,
                        dtype=torch.float32, device=generator.device) * (1.0 / float(d_in) ** 0.5)
        out[name] = (a, torch.zeros((len(layers), config.r, d_out), dtype=torch.float32))
    return out


def adapters_from_jax(lora_params: dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX package's adapter tree (``{target: {"lora_a": [L, in, r],
    "lora_b": [L, r, out]}}``, numpy or anything ``np.asarray`` takes) as
    :func:`apply_lora`'s ``adapters`` (fp32)."""
    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    return {name: (t(ab["lora_a"]), t(ab["lora_b"])) for name, ab in lora_params.items()}


def apply_lora(model: nn.Module, config: LoraConfig,
               generator: Optional[torch.Generator] = None,
               adapters: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
               ) -> nn.Module:
    """Adapt ``model`` in place and return it: every targeted weight gets a
    :class:`LoraMerge` with the ``adapters`` (:func:`init_adapters` from
    ``generator`` when None), cast to the weight's dtype and device; every
    other parameter, the base weights included, stops requiring grad. An
    unknown target raises with the list of the body's targets. Under
    tensor parallelism the adapters are the whole ones on every model rank
    (module docstring)."""
    if adapters is None:
        adapters = init_adapters(model, config, generator)
    model.requires_grad_(False)
    tp = getattr(model, "tp", None)
    for name, i, path in target_paths(model, config):
        module = model.get_submodule(path)
        w = module.weight
        a, b = adapters[name]
        merge = LoraMerge(a[i].to(w.device, w.dtype, copy=True),
                          b[i].to(w.device, w.dtype, copy=True), config.scaling, tp,
                          _split_dim(model, path))
        parametrize.register_parametrization(module, "weight", merge)
    return model


@torch.no_grad()
def adapter_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{path}.lora_a`` [in, r] and ``{path}.lora_b`` [r, out] of every
    adapted projection, whole (what ``cli/run_rankpo.py`` saves as
    ``lora_adapters.pt`` beside the merged model). Under fsdp each is
    gathered from its owner: a collective of the data group."""
    out = {}
    for path, module in model.named_modules():
        if parametrize.is_parametrized(module, "weight"):
            merge = module.parametrizations.weight[0]
            out[f"{path}.lora_a"] = merge.lora_a.detach()
            out[f"{path}.lora_b"] = merge.lora_b.detach()
    return out


@torch.no_grad()
def merged_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's HF-named state dict with every adapter folded into its
    weight (PEFT's ``merge_and_unload``), in the one-process layout: under
    fsdp the adapters are gathered from their owners (a collective of the
    data group), under tensor parallelism the merged shards over the model
    group (a collective of the model group)."""
    state = {n: t for n, t in model.state_dict().items() if ".parametrizations." not in n}
    for path, module in model.named_modules():
        if parametrize.is_parametrized(module, "weight"):
            state[f"{path}.weight"] = module.weight.detach()
    tp = getattr(model, "tp", None)
    if tp is None:
        return state
    from rankpo_tpu_torch.parallel.sharding import gather_state

    return gather_state(state, tp.group)


def merge_lora(state: Dict[str, torch.Tensor], adapters: Dict[str, torch.Tensor],
               scaling: float) -> Dict[str, torch.Tensor]:
    """A state dict with the adapters of :func:`adapter_state_dict` folded
    into its weights (JAX ``merge_lora``); the input is not modified."""
    out = dict(state)
    for key in adapters:
        if key.endswith(".lora_a"):
            path = key[: -len(".lora_a")]
            out[f"{path}.weight"] = merge_weight(state[f"{path}.weight"], adapters[key],
                                                 adapters[f"{path}.lora_b"], scaling)
    return out


def count_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)
