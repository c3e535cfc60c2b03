"""The two builds every encoder body has (``LlamaEncoder``,
``RobertaEncoder``): :meth:`EncoderModule.from_state_dict` (serving: frozen,
parameters in the compute dtype) and :meth:`EncoderModule.for_training`
(master parameters in the param dtype, trainable). Both build on the meta
device, so no throwaway random init is made, and adopt an HF-named state
dict."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.models.config import EncoderConfig

CHECKPOINT_POLICIES = ("full",)


class EncoderModule(nn.Module):
    """Token ids [B, S] + right-padded mask [B, S] -> last hidden [B, S, H]
    in ``compute_dtype`` (by default the parameters' dtype). Every body's
    ``forward`` also takes ``segment_ids`` [B, S] (sequence packing,
    ``models/packing.py``) in place of the mask."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.compute_dtype: Optional[torch.dtype] = None
        self.gradient_checkpointing = False

    @classmethod
    def for_training(
        cls,
        config: EncoderConfig,
        state: Dict[str, torch.Tensor],
        *,
        device="cuda",
        param_dtype: torch.dtype = torch.float32,
        compute_dtype: torch.dtype = torch.bfloat16,
        gradient_checkpointing: bool = False,
        checkpoint_policy: str = "full",
    ) -> "EncoderModule":
        """Trainable build: master parameters in ``param_dtype`` on
        ``device`` (the card unless the caller asks for the CPU; no card
        raises), forward in ``compute_dtype``. ``checkpoint_policy`` is
        the JAX ``remat_policy``; only "full" is ported."""
        if checkpoint_policy not in CHECKPOINT_POLICIES:
            raise NotImplementedError(
                f"gradient_checkpointing_policy {checkpoint_policy!r} is not "
                "ported yet (ROADMAP.md Queue 1 item 2: remat 'dots'/'attn'); "
                "use 'full'"
            )
        device = resolve_device(device)
        with torch.device("meta"):
            model = cls(config)
        # a copy even where device and dtype match: training updates the
        # parameters in place and must not write into the caller's tensors
        state = {n: t.to(device=device, dtype=param_dtype, copy=True)
                 for n, t in state.items()}
        model.load_state_dict(state, strict=True, assign=True)
        model.compute_dtype = compute_dtype
        model.gradient_checkpointing = gradient_checkpointing
        return model.requires_grad_(True).train()

    @classmethod
    def from_state_dict(
        cls,
        config: EncoderConfig,
        state: Dict[str, torch.Tensor],
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ) -> "EncoderModule":
        """Adopt ``state`` converted to ``dtype`` on ``device`` (the card
        unless the caller asks for the CPU; no card raises). Every parameter
        must be present; the result is frozen (serving has no backward)."""
        device = resolve_device(device)
        with torch.device("meta"):
            model = cls(config)
        state = {n: t.to(device=device, dtype=dtype) for n, t in state.items()}
        model.load_state_dict(state, strict=True, assign=True)
        return model.requires_grad_(False).eval()


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied with its weight (and bias) cast to the activations'
    dtype, as the JAX bodies cast every parameter to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return torch.nn.functional.linear(x, layer.weight.to(x.dtype), bias)


def init_state(
    names,
    shapes: Dict[str, torch.Size],
    generator: torch.Generator,
    device,
    dtype: torch.dtype,
    ones,
    zeros,
) -> Dict[str, torch.Tensor]:
    """Random init as an HF-named state dict, in the order of ``names``:
    ones where ``ones(name)``, zeros where ``zeros(name)`` (neither draws
    from ``generator``), else normal(0, 0.02) drawn in fp32 and cast, so the
    peak extra memory is one fp32 tensor."""
    state = {}
    for name in names:
        shape = shapes[name]
        if ones(name):
            state[name] = torch.ones(shape, dtype=dtype, device=device)
        elif zeros(name):
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            state[name] = (w * 0.02).to(dtype)
    return state
