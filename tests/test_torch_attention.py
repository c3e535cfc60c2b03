"""Port attention (rankpo_tpu_torch.ops) against the JAX package.

The plain PyTorch attention is held against ``_xla_attention`` and against
the Pallas flash kernel run in interpret mode (as tests/test_flash_attention.py
runs it on the CPU), on the same fp32 inputs made with numpy: atol 1e-5, the
fp32 round-off of two summation orders over at most 48 keys. The CUDA kernel
is compared with the plain version on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.ops.attention import _xla_attention
from rankpo_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    _flatten_heads,
    flash_attention,
)
from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.ops.attention import attention_reference, multi_head_attention
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(b=2, sq=32, sk=32, hq=4, hkv=4, d=16, lens=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    lens = [sk] * b if lens is None else lens
    mask = (np.arange(sk)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, mask


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = {
    # name: (inputs kwargs, causal)
    "mask": (dict(lens=[32, 20]), False),
    "causal": (dict(lens=[32, 20]), True),
    "gqa": (dict(hq=4, hkv=2, lens=[32, 11]), True),
    "sq_ne_sk": (dict(sq=16, sk=48, hq=4, hkv=2, lens=[48, 30]), True),
    "all_masked_row": (dict(lens=[0, 17]), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_xla(name):
    kw, causal = CASES[name]
    q, k, v, mask = _inputs(**kw)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask), causal))
    out = attention_reference(*_port(q, k, v, mask), causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if name == "all_masked_row":
        assert np.all(out[0] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_pallas_interpret(name):
    kw, causal = CASES[name]
    q, k, v, mask = _inputs(**kw)
    ref = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), causal=causal, q_block=16, k_block=16,
        interpret=True,
    ))
    out = attention_reference(*_port(q, k, v, mask), causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_plain_version_matches_pallas_out_and_lse(name):
    """The kernel's plain version returns what _fwd_kernel returns: O and
    lse (NEG_INF where a row has no valid key)."""
    kw, causal = CASES[name]
    q, k, v, mask = _inputs(**kw)
    hq = q.shape[2]
    jq, jk, jv = (_flatten_heads(jnp.asarray(x)) for x in (q, k, v))
    j_out, j_lse = _flash_fwd_impl(
        jq, jk, jv, jnp.repeat(jnp.asarray(mask), hq, axis=0), causal,
        16, 16, True, False, None,
    )
    out, lse = flash_attention_fwd_reference(*_port(q, k, v, mask), causal=causal)
    b, sq = q.shape[:2]
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(b * hq, sq, -1).numpy(),
        np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(b * hq, sq).numpy(),
                               np.asarray(j_lse), atol=ATOL, rtol=1e-6)


def test_skip_pad_q_valid_rows_match_pallas():
    """skip_pad_q is block-granular in both kernels with different tile
    sizes, so only rows below each row's valid length are compared."""
    lens = [32, 9]
    q, k, v, mask = _inputs(hq=4, hkv=2, lens=lens)
    ref = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), causal=True, q_block=16, k_block=16,
        interpret=True, skip_pad_q=True,
    ))
    out = multi_head_attention(*_port(q, k, v), mask=torch.from_numpy(mask),
                               causal=True, skip_pad_q=True).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=ATOL, rtol=0)


def test_dispatch_on_cpu():
    q, k, v, mask = _port(*_inputs(hq=4, hkv=2, lens=[32, 5]))
    auto = multi_head_attention(q, k, v, mask=mask, causal=True)
    plain = multi_head_attention(q, k, v, mask=mask, causal=True, impl="plain")
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multi_head_attention(q, k, v, mask=mask, causal=True, impl="flash")
    # a window runs on the CPU through the plain version, and bites on the
    # 32-key row
    windowed = multi_head_attention(q, k, v, mask=mask, causal=True, window=8)
    assert torch.equal(windowed, multi_head_attention(q, k, v, mask=mask, causal=True,
                                                      impl="plain", window=8))
    assert torch.equal(windowed, attention_reference(q, k, v, mask, True, window=8))
    assert (windowed - auto).abs().max() > 1e-3
    with pytest.raises(ValueError, match="impl"):
        multi_head_attention(q, k, v, mask=mask, impl="xla")


def test_kernel_wrapper_rejects_gradients_and_cpu():
    """CPU tensors never reach a kernel: the forward wrapper and the
    differentiable Function (what a gradient-needing call takes) both raise,
    and no launch is counted."""
    q, k, v, mask = _port(*_inputs())
    before = dict(port_flash.launches)
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.flash_attention(q.bfloat16().requires_grad_(), k.bfloat16(),
                                   v.bfloat16(), mask, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q.detach().bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    assert port_flash.launches == before
