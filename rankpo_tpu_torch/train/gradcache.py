"""Cross-accumulation in-batch negatives for stage 1 by gradient caching
(port of ``rankpo_tpu.train.gradcache``; Gao et al., "Scaling Deep
Contrastive Learning Batch Size under Memory Limited Setup").

Plain accumulation computes InfoNCE per micro-batch, so negatives never
cross accumulation steps. The cached gradient decouples the two, in three
passes over one [accum, B, ...] group:

- pass 1: embed every micro-batch under ``torch.no_grad`` and keep only the
  pooled reps (each micro-batch's activations are freed at once);
- bridge: InfoNCE on the whole [accum * B, H] rep matrices, the reps as
  leaf tensors that require grad; its backward gives d(loss)/d(reps);
- pass 2: embed each micro-batch again with gradients and call
  ``backward`` with its slice of the rep gradients, summing the parameter
  gradients in ``.grad``.

The gradients equal those of one InfoNCE over the whole group (not the
mean of per-micro-batch losses), at one micro-batch's activation memory,
for one more encoder forward. With cross-device negatives (``axis_name``)
the bridge pools the passage reps of every rank's group, as the JAX
bridge's global arrays do (JAX ``gradcache.py:20``); each rank's rep
gradients are then those of its own rows. Packed micro-batches scatter their segment
reps back to batch order (``steps._embed_field``), so the bridge sees the
plain path's rep matrices. Both passes take micro-batch i's dropout from a
fresh generator of the same seed (the trainer's ``make_generator``), so
they draw the same masks. On the card pass 1 runs K1 once per layer, field
and micro-batch; pass 2 is the ordinary training forward and backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from rankpo_tpu_torch.losses.contrastive import validate_temperature
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.train.steps import contrastive_terms, embed_pair


def make_contrastive_gradcache_grad_fn(
    model_config: EncoderConfig,
    *,
    temperature: float = 0.02,
    normalize_embeddings: bool = True,
    use_inbatch_neg: bool = True,
    attn_impl: str = "auto",
    axis_name=None,
) -> Callable:
    """Returns grad_fn(model, micro_batches, make_generator) -> (loss,
    metrics) for the ``Trainer``'s ``grad_fn`` hook: ``micro_batches`` is
    the group's list of device batches, ``make_generator(i)`` a fresh
    dropout generator for micro-batch i (or None). The parameters'
    ``.grad`` holds the full-batch loss's gradients when it returns."""
    del model_config  # the model carries its config
    temperature = validate_temperature(normalize_embeddings, temperature)
    kwargs = dict(normalize=normalize_embeddings, attn_impl=attn_impl)

    def generator(make_generator, i):
        return None if make_generator is None else make_generator(i)

    def grad_fn(model, micro_batches, make_generator=None):
        # pass 1: reps only
        with torch.no_grad():
            reps = [embed_pair(model, mb, generator(make_generator, i), **kwargs)
                    for i, mb in enumerate(micro_batches)]
        q_all = torch.cat([q for q, _ in reps]).requires_grad_(True)
        p_all = torch.cat([p for _, p in reps]).requires_grad_(True)
        del reps
        # bridge: the full-batch loss and its rep gradients
        with torch.enable_grad():
            loss, accuracy = contrastive_terms(q_all, p_all, temperature=temperature,
                                               use_inbatch_neg=use_inbatch_neg,
                                               axis_name=axis_name)
            loss.backward()
        # every micro-batch of a group holds B rows
        q_grads = q_all.grad.chunk(len(micro_batches))
        p_grads = p_all.grad.chunk(len(micro_batches))
        # pass 2: each micro-batch's rep gradients back to the parameters
        for i, mb in enumerate(micro_batches):
            q, p = embed_pair(model, mb, generator(make_generator, i), **kwargs)
            torch.autograd.backward([q, p], [q_grads[i], p_grads[i]])
        return loss.detach(), {"accuracy": accuracy.detach()}

    return grad_fn
