"""The port's CUDA kernels and device search on the card.

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
from rankpo_tpu_torch.ops.attention import attention_reference
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn

pytestmark = pytest.mark.gpu

# bf16 kernel against the plain version in fp32 on the same bf16 inputs:
# the output is rounded to bf16 (values of order 1, half an ulp ~ 8e-3) and
# P is rounded to bf16 before the PV product
OUT_ATOL = 1.5e-2
LSE_ATOL = 1e-5
# bf16 backward kernels against the plain backward in fp32 on the same bf16
# inputs and the kernel's own lse: dq/dk/dv are rounded to bf16 (half an ulp
# is 2^-9 of the largest entry); 2^-7 of max|plain| per tensor also covers
# single-ulp flips of the bf16 P and dS where __expf and torch.exp differ
BWD_TOL_OF_MAX = 2.0**-7
# ... and, per tensor, ||kernel - plain|| / ||plain|| within 1e-2: bf16
# rounding alone gives about 1e-3; a tile whose contribution is dropped or
# counted twice moves a whole block of entries, far past 1e-2
BWD_REL_L2 = 1e-2

SHAPES = [
    ((8, 512, 512, 32, 8, 64), True, True),
    ((16, 40, 40, 32, 8, 64), True, True),
    ((4, 64, 128, 32, 8, 64), True, False),
    ((4, 128, 64, 32, 8, 64), True, False),
    ((4, 256, 256, 16, 8, 128), True, True),
    ((4, 100, 100, 4, 4, 64), False, False),
]


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


@pytest.mark.parametrize("shape,causal,skip", SHAPES)
def test_kernel_matches_plain(cuda, shape, causal, skip):
    b, sq, sk = shape[:3]
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(*shape))
    before = port_flash.launches["flash_fwd"]
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip)
        ref, rlse = flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), mask, causal=causal)
    torch.cuda.synchronize()
    assert port_flash.launches["flash_fwd"] == before + 1
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


def _bwd_inputs(shape, causal, skip, cuda, seed=0):
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(*shape, seed=seed))
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g).bfloat16().to(cuda)
    out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, mask, do, lse, delta


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("shape,causal,skip", SHAPES)
def test_bwd_kernels_match_plain(cuda, shape, causal, skip, impl):
    q, k, v, mask, do, lse, delta = _bwd_inputs(shape, causal, skip, cuda)
    names = ["flash_bwd_fused"] if impl == "fused" else ["flash_dq", "flash_dkv"]
    before = dict(port_flash.launches)
    grads = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal,
                                skip_pad_q=skip, bwd_impl=impl)
    ref = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    for name in port_flash.launches:
        assert port_flash.launches[name] == before[name] + (name in names)
    for a, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        err = (a.float() - r).abs().max().item()
        assert err <= BWD_TOL_OF_MAX * r.abs().max().item(), (name, err)
        rel = ((a.float() - r).norm() / r.norm()).item()
        assert rel <= BWD_REL_L2, (name, rel)


def test_auto_bwd_under_deterministic_algorithms_runs_split(cuda):
    q, k, v, mask, do, lse, delta = _bwd_inputs(SHAPES[1][0], True, True, cuda, seed=3)
    before = dict(port_flash.launches)
    torch.use_deterministic_algorithms(True)
    try:
        flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True, skip_pad_q=True)
    finally:
        torch.use_deterministic_algorithms(False)
    flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True, skip_pad_q=True)
    got = {n: port_flash.launches[n] - before[n] for n in port_flash.launches}
    assert got == {"flash_fwd": 0, "flash_bwd_fused": 1, "flash_dq": 1, "flash_dkv": 1}


def test_split_bwd_repeats_bit_for_bit_and_fused_dq_varies_by_rounding(cuda):
    q, k, v, mask, do, lse, delta = _bwd_inputs(SHAPES[0][0], True, True, cuda, seed=4)
    args = (q, k, v, mask, do, lse, delta)
    split = [flash_attention_bwd(*args, causal=True, skip_pad_q=True, bwd_impl="split")
             for _ in range(2)]
    for a, b in zip(*split):
        assert torch.equal(a, b)
    fused = [flash_attention_bwd(*args, causal=True, skip_pad_q=True, bwd_impl="fused")
             for _ in range(2)]
    # dk/dv have no atomics; dq's fp32 atomic sums may end one bf16 ulp apart
    assert torch.equal(fused[0][1], fused[1][1]) and torch.equal(fused[0][2], fused[1][2])
    a, b = fused[0][0].float(), fused[1][0].float()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0**-7
    assert torch.all((a - b).abs() <= ulp)


def test_autograd_step_through_function(cuda):
    """One backward through the FlashAttention Function against autograd
    through attention_reference (both bf16): gradients agree to 2^-6 of
    their largest entry (bf16 roundings sit at other places in the two) and
    to cosine >= 0.999."""
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(4, 192, 192, 32, 8, 64, seed=7))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    grads = []
    for fn in (lambda *a: flash_attention(*a, mask, causal=True),
               lambda *a: attention_reference(*a, mask, True)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves).float() * w).sum().backward()
        grads.append([x.grad.float() for x in leaves])
    for a, r, name in zip(*grads, ("dq", "dk", "dv")):
        assert (a - r).abs().max().item() <= 2.0**-6 * r.abs().max().item(), name
        cos = torch.nn.functional.cosine_similarity(a.flatten(), r.flatten(), dim=0)
        assert cos.item() >= 0.999, name


def test_encoder_training_step_flash_against_plain(cuda):
    """A tiny llama (fp32 master weights, bf16 compute): one contrastive
    loss and its gradients through the kernels and through the plain
    attention agree to 1e-2 relative loss and cosine >= 0.99 per tensor."""
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), hidden_size=256,
                              intermediate_size=512, head_dim=64)
    state = llama.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)

    def block(n, s):
        lens = torch.randint(1, s + 1, (n,), generator=g)
        ids = torch.randint(3, 512, (n, s), generator=g)
        mask = (torch.arange(s)[None] < lens[:, None]).int()
        return {"input_ids": ids.to(cuda), "attention_mask": mask.to(cuda)}

    batch = {"query": block(4, 64), "passage": block(16, 192)}
    results = []
    for impl in ("flash", "plain"):
        model = llama.LlamaEncoder.for_training(cfg, state, device=cuda,
                                                gradient_checkpointing=True)
        loss, _ = make_contrastive_loss_fn(cfg, temperature=0.05, attn_impl=impl)(model, batch)
        loss.backward()
        results.append((loss.item(), {n: p.grad.flatten() for n, p in model.named_parameters()}))
    (lf, gf), (lp, gp) = results
    assert abs(lf - lp) <= 1e-2 * abs(lp)
    for name in gf:
        cos = torch.nn.functional.cosine_similarity(gf[name], gp[name], dim=0).item()
        assert cos >= 0.99, (name, cos)
