"""The port's CUDA kernel and device search on the card.

This file imports no jax (the machine with the card has none), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips. The CPU tests compare the plain versions
used here with the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rankpo_tpu_torch.index.flat import FlatIPIndex, numpy_search
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.encoder import embed
from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

pytestmark = pytest.mark.gpu

# bf16 kernel against the plain version in fp32 on the same bf16 inputs:
# the output is rounded to bf16 (values of order 1, half an ulp ~ 8e-3) and
# P is rounded to bf16 before the PV product
OUT_ATOL = 1.5e-2
LSE_ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(b, sq, sk, hq, hkv, d, seed=0, lens=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g).bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=g).bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=g).bfloat16()
    if lens is None:
        lens = torch.randint(1, sk + 1, (b,), generator=g)
        lens[0], lens[-1] = 1, sk
    lens = torch.as_tensor(lens)
    mask = (torch.arange(sk)[None] < lens[:, None]).int()
    return q, k, v, mask, lens


@pytest.mark.parametrize("shape,causal,skip", [
    ((8, 512, 512, 32, 8, 64), True, True),
    ((16, 40, 40, 32, 8, 64), True, True),
    ((4, 64, 128, 32, 8, 64), True, False),
    ((4, 128, 64, 32, 8, 64), True, False),
    ((4, 256, 256, 16, 8, 128), True, True),
    ((4, 100, 100, 4, 4, 64), False, False),
])
def test_kernel_matches_plain(cuda, shape, causal, skip):
    b, sq, sk = shape[:3]
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(*shape))
    before = port_flash.launches
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip)
        ref, rlse = flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), mask, causal=causal)
    torch.cuda.synchronize()
    assert port_flash.launches == before + 1
    pos = torch.arange(sq, device=cuda)[None] + (sk - sq)
    rows = pos < lens[:, None] if skip else torch.ones_like(pos, dtype=torch.bool).expand(b, sq)
    err = (out.float() - ref).abs().amax(dim=(2, 3))[rows]
    assert err.max().item() <= OUT_ATOL
    has_key = rlse > -1e29
    keep = rows[:, None, :] & has_key
    assert (lse - rlse).abs()[keep].max().item() <= LSE_ATOL
    nokey = ~has_key.permute(0, 2, 1)
    assert torch.all(out.abs().amax(-1)[nokey] == 0)


def test_kernel_reads_strided_fused_qkv(cuda):
    """q/k/v as views of one fused projection output, read without a copy."""
    b, s, hq, hkv, d = 4, 192, 32, 8, 64
    g = torch.Generator().manual_seed(3)
    fused = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g).bfloat16().to(cuda)
    q = fused[..., : hq * d].view(b, s, hq, d)
    k = fused[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (hq + hkv) * d :].view(b, s, hkv, d)
    with torch.inference_mode():
        out, _ = flash_attention_fwd(q, k, v, None, causal=True)
        ref, _ = flash_attention_fwd_reference(q.float(), k.float(), v.float(), None, causal=True)
    assert (out.float() - ref).abs().max().item() <= OUT_ATOL


def test_exact_search_tie_order_on_card(cuda):
    """fp32 cuBLAS without TF32 on dyadic data (exact in any summation
    order): ties and order equal the numpy oracle bit for bit."""
    rng = np.random.default_rng(0)
    corpus = (rng.integers(-8, 9, (4096, 64)) / 16.0).astype(np.float32)
    for j in (11, 17, 30, 4000):
        corpus[j] = corpus[5]
    queries = (rng.integers(-8, 9, (9, 64)) / 16.0).astype(np.float32)
    queries[0] = corpus[5]
    index = FlatIPIndex(torch.from_numpy(corpus).to(cuda))
    for k in (1, 3, 10, 100):
        s, i = index.search(queries, k=k)
        rs, ri = numpy_search(corpus, queries, k)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(i, ri)


def test_encoder_kernel_against_plain(cuda):
    """A tiny random llama in bf16: embeddings through the kernel and through
    the plain attention agree to cosine >= 0.999 per row."""
    # head_dim 64: the kernel takes 64 or 128
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), hidden_size=256,
                              intermediate_size=512, head_dim=64)
    state = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    model = llama.LlamaEncoder.from_state_dict(cfg, state, device=cuda,
                                               dtype=torch.bfloat16)
    lens = torch.tensor([1, 37, 64, 100, 128, 5])
    ids = torch.randint(3, 512, (6, 128), generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(128)[None] < lens[:, None]).int()
    batch = {"input_ids": ids.to(cuda), "attention_mask": mask.to(cuda)}
    with torch.inference_mode():
        a = embed(model, batch, attn_impl="auto")
        p = embed(model, batch, attn_impl="plain")
    assert torch.all(torch.nn.functional.cosine_similarity(a, p) >= 0.999)
