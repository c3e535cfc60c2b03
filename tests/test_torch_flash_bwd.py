"""The port's plain flash backward against the JAX package.

``flash_attention_bwd_reference`` (the plain version of the backward kernels
K2, K3a and K3b) is held, on the same fp32 inputs made with numpy, against:

- the Pallas backward kernels ``flash_bwd_fused``, ``flash_dq`` and
  ``flash_dkv`` run in interpret mode (as tests/test_flash_attention.py runs
  them on the CPU), fed the same forward statistics (lse from the Pallas
  forward, delta = rowsum(dO * O));
- ``jax.grad`` of ``_xla_attention``, and torch autograd of the port's
  ``attention_reference``, fed the plain forward's own statistics.

Cases mirror tests/test_flash_attention.py: key mask, causal, GQA, sq != sk
(bottom-right causal alignment), a row with every key masked, and
``skip_pad_q`` (rows of skipped query blocks have lse = NEG_INF and get zero
gradients). Tolerance: atol 2e-5 against the Pallas kernels (fp32 round-off
of two summation orders over <= 48 keys, gradients of order 1) and 3e-4
against the autodiff oracles, the tolerance tests/test_flash_attention.py
uses for the same comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.ops.attention import _xla_attention
from rankpo_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    _flatten_heads,
    _unflatten_heads,
    fit_blocks,
    flash_bwd_fused,
    flash_dkv,
    flash_dq,
)
from rankpo_tpu_torch.ops.attention import attention_reference
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
    resolve_bwd_impl,
)

torch.set_num_threads(2)

KERNEL_ATOL = 2e-5
ORACLE_ATOL = 3e-4

# (b, sq, sk, hq, hkv, d, key lengths, causal, skip_pad_q)
CASES = {
    "mask": (2, 32, 32, 4, 4, 8, [32, 20], False, False),
    "causal": (2, 32, 32, 4, 4, 8, [32, 20], True, False),
    "gqa": (2, 32, 32, 4, 2, 8, [32, 20], True, False),
    "sq_lt_sk": (2, 16, 32, 4, 2, 8, [32, 27], True, False),
    "sq_gt_sk": (2, 32, 16, 4, 2, 8, [16, 9], True, False),
    "all_masked_row": (2, 32, 32, 4, 2, 8, [32, 0], False, False),
    "skip_pad_q": (2, 32, 32, 4, 2, 8, [32, 10], True, True),
    # a GQA group of 8 query heads, summed into one kv head's dk/dv
    "gqa8": (2, 32, 32, 8, 1, 8, [32, 23], True, False),
    # several key blocks reaching each query block, as the fused kernel's
    # ordered dq sums them
    "many_key_blocks": (2, 64, 64, 4, 2, 8, [64, 37], True, False),
}


def _inputs(b, sq, sk, hq, hkv, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    do = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    mask = (np.arange(sk)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _pallas_stats(q, k, v, do, mask, causal, skip):
    """Flattened inputs, the Pallas forward's lse and delta ([B*H, S])."""
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    q_block, k_block = fit_blocks(sq, sk, 16, 16)
    qf, kf, vf, gf = (_flatten_heads(jnp.asarray(x)) for x in (q, k, v, do))
    mask_bh = jnp.repeat(jnp.asarray(mask), hq, axis=0)
    out, lse = _flash_fwd_impl(qf, kf, vf, mask_bh, causal, q_block, k_block,
                               True, skip, None)
    delta = jnp.sum(gf * out, axis=-1)
    kw = dict(causal=causal, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=skip)
    return (qf, kf, vf, mask_bh, gf, lse, delta), kw


def _port_grads(q, k, v, do, mask, lse_bh, delta_bh, causal):
    b, sq, hq, _ = q.shape
    lse = _t(lse_bh).reshape(b, hq, sq)
    delta = _t(delta_bh).reshape(b, hq, sq)
    return flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), _t(do), lse, delta, causal=causal)


def _assert_grads(port, ref, atol, what):
    for a, r, name in zip(port, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_pallas_kernels(case, impl):
    b, sq, sk, hq, hkv, d, lens, causal, skip = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens)
    args, kw = _pallas_stats(q, k, v, do, mask, causal, skip)
    if impl == "fused":
        dq, dk, dv = flash_bwd_fused(*args, **kw)
    else:
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
    ref = (_unflatten_heads(dq, b, hq), _unflatten_heads(dk, b, hkv),
           _unflatten_heads(dv, b, hkv))
    port = _port_grads(q, k, v, do, mask, args[5], args[6], causal)
    _assert_grads(port, ref, KERNEL_ATOL, f"{case}/{impl}")
    if skip:
        # rows of the skipped query block (16..31 of the 10-key row) get zeros
        assert torch.all(port[0][1, 16:] == 0)
    if lens[-1] == 0:
        assert torch.all(port[0][-1] == 0) and torch.all(port[1][-1] == 0)


def _plain_stats(q, k, v, do, mask, causal):
    out, lse = flash_attention_fwd_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                             causal=causal)
    delta = (_t(do) * out).sum(-1).permute(0, 2, 1).contiguous()
    return lse, delta


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][-1]])
def test_plain_bwd_matches_jax_grad_of_xla(case):
    b, sq, sk, hq, hkv, d, lens, causal, _ = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens)

    def f(q_, k_, v_):
        out = _xla_attention(q_, k_, v_, jnp.asarray(mask), causal)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    lse, delta = _plain_stats(q, k, v, do, mask, causal)
    port = flash_attention_bwd_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                         _t(do), lse, delta, causal=causal)
    _assert_grads(port, ref, ORACLE_ATOL, case)


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][-1]])
def test_plain_bwd_matches_torch_autograd(case):
    b, sq, sk, hq, hkv, d, lens, causal, _ = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, hq, hkv, d, lens, seed=1)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention_reference(*leaves, torch.from_numpy(mask), causal)
    grads = torch.autograd.grad(out, leaves, _t(do))
    lse, delta = _plain_stats(q, k, v, do, mask, causal)
    port = flash_attention_bwd_reference(_t(q), _t(k), _t(v), torch.from_numpy(mask),
                                         _t(do), lse, delta, causal=causal)
    _assert_grads(port, [g.numpy() for g in grads], ORACLE_ATOL, case)


def test_plain_bwd_rounds_like_the_bf16_kernels():
    """With bf16 inputs, P is rounded to do's dtype before dV and dS to q's
    dtype before dK/dQ (flash_attention.py:393-413): the result differs from
    the fp32 computation on the same values by bf16 rounding only."""
    q, k, v, do, mask = _inputs(2, 32, 32, 4, 2, 8, [32, 20])
    tb = [_t(x).bfloat16() for x in (q, k, v, do)]
    lse, delta = _plain_stats(*[x.float().numpy() for x in tb], mask, True)
    bf = flash_attention_bwd_reference(tb[0], tb[1], tb[2], torch.from_numpy(mask),
                                       tb[3], lse, delta, causal=True)
    f32 = flash_attention_bwd_reference(*[x.float() for x in tb[:3]],
                                        torch.from_numpy(mask), tb[3].float(),
                                        lse, delta, causal=True)
    for a, r in zip(bf, f32):
        assert a.dtype == torch.float32
        assert not torch.equal(a, r)
        torch.testing.assert_close(a, r, atol=0.05, rtol=0.02)


@pytest.mark.parametrize("body", ["llama", "roberta"])
def test_for_training_sets_every_layers_bwd_impl(body):
    """``for_training(bwd_impl=...)`` reaches each layer's attention call
    (``--flash_bwd_impl``); a value outside ``BWD_IMPLS`` raises."""
    from rankpo_tpu_torch.models.config import tiny_llama_config, tiny_roberta_config
    from rankpo_tpu_torch.models.encoder import encoder_class, init_params

    cfg = (tiny_llama_config if body == "llama" else tiny_roberta_config)(vocab_size=64)
    state = init_params(cfg, torch.Generator().manual_seed(0))
    cls = encoder_class(cfg)
    for impl in ("auto", "fused", "split"):
        model = cls.for_training(cfg, state, device="cpu", bwd_impl=impl)
        got = {m.bwd_impl for m in model.modules() if hasattr(m, "bwd_impl")}
        assert got == {impl}
        assert sum(hasattr(m, "bwd_impl") for m in model.modules()) == cfg.num_hidden_layers
    with pytest.raises(ValueError, match="bwd_impl"):
        cls.for_training(cfg, state, device="cpu", bwd_impl="xla")


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("impl", ["auto", "fused", "split"])
def test_auto_bwd_is_split_with_or_without_deterministic_algorithms(impl, deterministic):
    """"auto" picks the split kernels (the faster on the H100) whether or
    not torch's deterministic algorithms are on; an explicit choice is
    kept."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        got = resolve_bwd_impl(impl)
    finally:
        torch.use_deterministic_algorithms(before)
    assert got == ("split" if impl == "auto" else impl)
    with pytest.raises(ValueError):
        resolve_bwd_impl("xla")
