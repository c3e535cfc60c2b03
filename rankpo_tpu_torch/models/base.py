"""The two builds every encoder body has (``LlamaEncoder``,
``RobertaEncoder``): :meth:`EncoderModule.from_state_dict` (serving: frozen,
parameters in the compute dtype) and :meth:`EncoderModule.for_training`
(master parameters in the param dtype, trainable). Both build on the meta
device, so no throwaway random init is made, and adopt an HF-named state
dict. :func:`remat` runs a body's layer (or part of one) under a
gradient-checkpointing policy."""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.ops.attention import BWD_IMPLS

# the JAX remat_policy values (llama.py:286-323, roberta.py:261-285):
# "full" recomputes the whole layer in the backward pass; "dots" keeps the
# products without batch dimensions (the projections) and recomputes the
# rest; "attn" recomputes all but the attention call, whose saved tensors
# (q, k, v, out, lse) serve the backward, so K1 does not run again
CHECKPOINT_POLICIES = ("full", "dots", "attn")

# products without batch dimensions: F.linear's mm / addmm (jax
# dots_with_no_batch_dims_saveable); aten.bmm (the plain attention's
# batched products) is recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str, *args):
    """``fn(*args)`` recomputed in the backward pass (non-reentrant
    ``torch.utils.checkpoint``): everything under "full" (and for the two
    regions of "attn", which the bodies split around the attention call),
    all but the saved products under "dots" (selective checkpointing)."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_products))
    return checkpoint(fn, *args, use_reentrant=False)


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
        self.checkpoint_policy = "full"

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
        bwd_impl: str = "auto",
    ) -> "EncoderModule":
        """Trainable build: master parameters in ``param_dtype`` on
        ``device`` (the card unless the caller asks for the CPU; no card
        raises), forward in ``compute_dtype``. ``checkpoint_policy`` is
        the JAX ``remat_policy`` (:data:`CHECKPOINT_POLICIES`), applied
        with ``gradient_checkpointing``. ``bwd_impl`` picks every layer's
        flash backward kernels (``ops/attention.py`` ``BWD_IMPLS``)."""
        if checkpoint_policy not in CHECKPOINT_POLICIES:
            raise ValueError(f"unknown remat_policy {checkpoint_policy!r}; "
                             f"one of {list(CHECKPOINT_POLICIES)}")
        if bwd_impl not in BWD_IMPLS:
            raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
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
        model.checkpoint_policy = checkpoint_policy
        for layer in model.modules():
            if hasattr(layer, "bwd_impl"):
                layer.bwd_impl = bwd_impl
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
