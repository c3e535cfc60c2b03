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

from rankpo_tpu_torch.data.collators import ContrastiveCollator
from rankpo_tpu_torch.data.datasets import ContrastiveDataset
from rankpo_tpu_torch.data.tokenization import HashTokenizer
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
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer

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

# (B, Sq, Sk, Hq, Hkv, D), causal, skip_pad_q, every key length full, window
SHAPES = [
    ((8, 512, 512, 32, 8, 64), True, True, False, None),
    ((16, 40, 40, 32, 8, 64), True, True, False, None),
    ((4, 64, 128, 32, 8, 64), True, False, False, None),
    ((4, 128, 64, 32, 8, 64), True, False, False, None),
    ((4, 256, 256, 16, 8, 128), True, True, False, None),
    ((4, 100, 100, 4, 4, 64), False, False, False, None),
    ((4, 100, 100, 64, 8, 64), True, True, False, None),  # 8 query heads per kv head
    ((4, 1, 128, 32, 8, 64), True, False, False, None),  # one query row
    ((4, 65, 200, 32, 8, 64), True, True, False, None),  # ragged Sq < Sk
    ((4, 256, 256, 32, 8, 128), True, True, False, None),  # D 128, 4 per kv head
    ((8, 512, 512, 32, 8, 64), True, True, True, None),
    ((4, 128, 128, 32, 32, 64), True, True, False, None),  # one query head per kv head
    ((4, 128, 128, 32, 32, 64), True, True, True, None),
    ((4, 100, 100, 64, 8, 64), True, True, True, None),
    ((4, 65, 200, 32, 8, 64), True, True, True, None),
    ((4, 256, 256, 32, 8, 128), True, True, True, None),
    ((4, 128, 128, 16, 16, 128), True, True, False, None),  # D 128, one per kv head
    ((4, 192, 192, 64, 8, 128), True, True, False, None),  # D 128, 8 per kv head
    # the BGE encoders: non-causal, skip_pad_q, one query head per kv head
    ((8, 512, 512, 16, 16, 64), False, True, False, None),
    ((8, 512, 512, 16, 16, 64), False, True, True, None),
    ((4, 100, 100, 16, 16, 64), False, True, False, None),  # ragged S
    # Qwen2-1.5B: causal, D 128, 6 query heads per kv head
    ((8, 512, 512, 12, 2, 128), True, True, False, None),
    ((8, 512, 512, 12, 2, 128), True, True, True, None),
    # sliding windows (causal): off the tile, a multiple of it, Mistral's
    # heads at D 128, rows with no visible key (no skip_pad_q, long pad
    # tails), Sq < Sk and Sq > Sk, a window of three keys (of one:
    # test_kernel_window_of_one_key)
    ((4, 512, 512, 32, 8, 64), True, True, False, 100),
    ((4, 512, 512, 32, 8, 64), True, True, True, 128),
    ((2, 1024, 1024, 32, 8, 128), True, True, False, 256),
    ((2, 1024, 1024, 32, 8, 128), True, True, True, 300),
    ((4, 256, 256, 32, 8, 64), True, False, False, 40),
    ((4, 65, 200, 32, 8, 64), True, True, False, 50),
    ((4, 200, 100, 16, 8, 64), True, False, False, 30),
    ((4, 128, 128, 32, 32, 64), True, True, False, 3),
    # head_dim 256 (Gemma): google/gemma-2b's 8 query heads over one kv
    # head, random and full lengths; gemma-7b's 16 / 16; non-causal; ragged
    # Sq < Sk and Sq > Sk (no skip_pad_q); a window; many key tiles
    ((8, 512, 512, 8, 1, 256), True, True, False, None),
    ((8, 512, 512, 8, 1, 256), True, True, True, None),
    ((4, 256, 256, 16, 16, 256), True, True, False, None),
    ((4, 100, 100, 4, 4, 256), False, False, False, None),
    ((4, 65, 200, 8, 1, 256), True, True, False, None),
    ((4, 200, 100, 8, 2, 256), True, False, False, None),
    ((4, 512, 512, 8, 1, 256), True, True, False, 100),
    ((2, 1024, 1024, 8, 1, 256), True, True, True, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(b, sq, sk, hq, hkv, d, seed=0, lens=None, full=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g).bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=g).bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=g).bfloat16()
    if lens is None:
        lens = torch.randint(1, sk + 1, (b,), generator=g)
        lens[0], lens[-1] = 1, sk
    if full:
        lens = [sk] * b
    lens = torch.as_tensor(lens)
    mask = (torch.arange(sk)[None] < lens[:, None]).int()
    return q, k, v, mask, lens


@pytest.mark.parametrize("shape,causal,skip,full,window", SHAPES)
def test_kernel_matches_plain(cuda, shape, causal, skip, full, window):
    b, sq, sk = shape[:3]
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(*shape, full=full))
    before = port_flash.launches["flash_fwd"]
    before_w = port_flash.window_launches["flash_fwd"]
    before_d = port_flash.d256_launches["flash_fwd"]
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip,
                                       window=window)
        ref, rlse = flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), mask, causal=causal, window=window)
    torch.cuda.synchronize()
    assert port_flash.launches["flash_fwd"] == before + 1
    assert port_flash.window_launches["flash_fwd"] == before_w + (window is not None)
    assert port_flash.d256_launches["flash_fwd"] == before_d + (shape[5] == 256)
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


def test_kernel_reads_head_major_k(cuda):
    """k and v as views of one head-major [B, 2 Hkv, S, D] projection: the
    [B, S, H, D] views have the head stride above the sequence stride."""
    b, s, hq, hkv, d = 4, 192, 32, 8, 64
    g = torch.Generator().manual_seed(4)
    q, _, _, mask, _ = (t.to(cuda) for t in _inputs(b, s, s, hq, hkv, d, seed=5))
    kv = torch.randn(b, 2 * hkv, s, d, generator=g).bfloat16().to(cuda)
    k, v = kv[:, :hkv].transpose(1, 2), kv[:, hkv:].transpose(1, 2)
    assert k.stride(2) > k.stride(1)
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True)
        ref, rlse = flash_attention_fwd_reference(q.float(), k.float(), v.float(), mask,
                                                  causal=True)
    assert (out.float() - ref).abs().max().item() <= OUT_ATOL
    has_key = rlse > -1e29
    assert (lse - rlse).abs()[has_key].max().item() <= LSE_ATOL


def test_kernel_window_of_one_key(cuda):
    """Window 1: every row sees its own key only, so out is that key's V row
    (rounded to bf16) and lse its scaled logit. (The backward is not
    compared here: with P = 1, dS = P (dP - delta) is 0 up to rounding.)"""
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(4, 128, 128, 32, 32, 64, seed=5))
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True, window=1)
        ref, rlse = flash_attention_fwd_reference(q.float(), k.float(), v.float(), mask,
                                                  causal=True, window=1)
    torch.cuda.synchronize()
    has_key = (torch.arange(128, device=cuda)[None] < lens[:, None])
    assert torch.equal(out[has_key], v[has_key])
    assert torch.all(out[~has_key] == 0)
    assert (lse - rlse).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("full", [False, True])
def test_kernel_repeats_bit_for_bit(cuda, full):
    """No atomics: two launches on the same inputs give identical out and lse."""
    q, k, v, mask, _ = (t.to(cuda) for t in _inputs(8, 512, 512, 32, 8, 64, seed=6,
                                                      full=full))
    with torch.inference_mode():
        runs = [flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
                for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


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


@pytest.mark.parametrize("q_n", [1, 16, 64])
def test_int8_product_on_card(cuda, q_n):
    """cuBLASLt's int8 GEMM (``torch._int_mm``, the left operand padded past
    16 rows, N past a multiple of 8) gives the exact integer sums."""
    from rankpo_tpu_torch.ops.topk import int8_product

    gen = torch.Generator().manual_seed(q_n)
    q8 = torch.randint(-127, 128, (q_n, 2048), generator=gen, dtype=torch.int8)
    codes = torch.randint(-127, 128, (1003, 2048), generator=gen, dtype=torch.int8)
    got = int8_product(q8.to(cuda), codes.to(cuda)).cpu()
    assert torch.equal(got, (q8.long() @ codes.long().T).int())


def test_int8_codecs_on_card_match_cpu(cuda):
    """The row codec on both rounding paths and the query codec give the
    CPU's bits on the card (no division by a host scalar turned into a
    product with its reciprocal)."""
    from rankpo_tpu_torch.index.flat import quantize_rows_int8
    from rankpo_tpu_torch.ops.topk import quantize_queries_int8

    x = torch.randn(4096, 512, generator=torch.Generator().manual_seed(3))
    for recip in (False, True):
        dev = quantize_rows_int8(x.to(cuda), times_reciprocal=recip)
        cpu = quantize_rows_int8(x, times_reciprocal=recip)
        assert torch.equal(dev[0].cpu(), cpu[0]) and torch.equal(dev[1].cpu(), cpu[1])
    dev = quantize_queries_int8(x.to(cuda).bfloat16())
    cpu = quantize_queries_int8(x.bfloat16())
    assert torch.equal(dev[0].cpu(), cpu[0]) and torch.equal(dev[1].cpu(), cpu[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("approx", [False, True])
def test_flat_storage_on_card_matches_cpu(cuda, dtype, approx):
    """bf16 and int8 flat rows on the card: the same stored rows as on the
    CPU; exact mode's hits equal the CPU's outside 1e-5 near-ties (int8:
    against the int8 product's own oracle, the queries quantized as it
    quantizes them); the approximate mode at or above its recall target;
    filtered search, append and remove as on the CPU."""
    from rankpo_tpu_torch.ops.topk import quantize_queries_int8

    rng = np.random.default_rng(1)
    x = rng.standard_normal((5000, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:64] + 0.05 * rng.standard_normal((64, 256)).astype(np.float32)
    kw = {"recall_target": 0.9} if approx else {}
    dev = FlatIPIndex.from_sharded(torch.from_numpy(x).to(cuda), 5000, dtype=dtype, **kw)
    cpu = FlatIPIndex.from_sharded(torch.from_numpy(x), 5000, dtype=dtype, **kw)
    ids = np.arange(5000)
    np.testing.assert_array_equal(dev.reconstruct(ids), cpu.reconstruct(ids))
    s, i = dev.search(q, k=20)
    rows = cpu.reconstruct(ids)
    qb = torch.from_numpy(q).bfloat16()
    if dtype == torch.int8:
        q8, qs = quantize_queries_int8(qb)
        q_eff = (q8.float() * qs[:, None]).numpy()
    else:
        q_eff = qb.float().numpy()
    rs, ri = numpy_search(rows, q_eff, 21)
    if approx:
        assert np.mean([len(set(a) & set(b)) / 20 for a, b in zip(i, ri)]) >= 0.9
    else:
        np.testing.assert_allclose(s, rs[:, :20], atol=1e-5, rtol=0)
        gap = np.abs(np.diff(rs, axis=1)) > 1e-5
        clear = gap[:, 1:] & gap[:, :-1]
        np.testing.assert_array_equal(i[:, 1:][clear], ri[:, 1:20][clear])
    allowed = ids[::7]
    fs, fi = dev.search(q, k=20, allowed_ids=allowed)
    assert np.isin(fi, allowed).all()
    grown = dev.append_sharded(torch.from_numpy(q).to(cuda), 64).remove_rows([0, 4999])
    assert grown.ntotal == 5062 and grown.device.type == "cuda"
    np.testing.assert_array_equal(
        grown.reconstruct([4997, 4998, 5061]),
        cpu.append_sharded(torch.from_numpy(q), 64).remove_rows([0, 4999])
        .reconstruct([4997, 4998, 5061]))


@pytest.mark.parametrize("window", [None, 40])
def test_encoder_kernel_against_plain(cuda, window):
    """A tiny random llama in bf16 (and a Mistral with a window of 40 keys):
    embeddings through the kernel and through the plain attention agree to
    cosine >= 0.999 per row; the windowed kernel launched once per layer."""
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), hidden_size=256,
                              intermediate_size=512, head_dim=64)
    if window is not None:
        cfg = dataclasses.replace(cfg, model_type="mistral", sliding_window=window)
    before = port_flash.window_launches["flash_fwd"]
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
    assert port_flash.window_launches["flash_fwd"] - before == (
        0 if window is None else cfg.num_hidden_layers)


def test_gemma_encoder_kernel_against_plain(cuda):
    """A tiny random Gemma in bf16 at head_dim 256 ((1+w) norms drawn
    N(0, 0.1), GeGLU, scaled embeddings): embeddings through the kernel and
    through the plain attention agree to cosine >= 0.999 per row, K1 at
    head_dim 256 launched once per layer."""
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), model_type="gemma",
                              hidden_size=256, intermediate_size=512, num_attention_heads=4,
                              num_key_value_heads=1, head_dim=256,
                              hidden_act="gelu_pytorch_tanh", architectures=("GemmaModel",))
    g = torch.Generator(device=cuda).manual_seed(0)
    state = llama.init_params(cfg, g)
    for name, t in state.items():
        if name.endswith("norm.weight"):
            t.normal_(0.0, 0.1, generator=g)
    model = llama.LlamaEncoder.from_state_dict(cfg, state, device=cuda,
                                               dtype=torch.bfloat16)
    lens = torch.tensor([1, 37, 64, 100, 128, 5])
    ids = torch.randint(3, 512, (6, 128), generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(128)[None] < lens[:, None]).int()
    batch = {"input_ids": ids.to(cuda), "attention_mask": mask.to(cuda)}
    before = port_flash.d256_launches["flash_fwd"]
    with torch.inference_mode():
        a = embed(model, batch, attn_impl="auto")
        p = embed(model, batch, attn_impl="plain")
    assert torch.all(torch.nn.functional.cosine_similarity(a, p) >= 0.999)
    assert port_flash.d256_launches["flash_fwd"] - before == cfg.num_hidden_layers


def _bwd_inputs(shape, causal, skip, cuda, seed=0, full=False, window=None):
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(*shape, seed=seed, full=full))
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g).bfloat16().to(cuda)
    out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip,
                                   window=window)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, mask, do, lse, delta


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("shape,causal,skip,full,window", SHAPES)
def test_bwd_kernels_match_plain(cuda, shape, causal, skip, full, window, impl):
    q, k, v, mask, do, lse, delta = _bwd_inputs(shape, causal, skip, cuda, full=full,
                                                window=window)
    names = ["flash_bwd_fused"] if impl == "fused" else ["flash_dq", "flash_dkv"]
    before = dict(port_flash.launches)
    before_w = dict(port_flash.window_launches)
    before_d = dict(port_flash.d256_launches)
    grads = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal,
                                skip_pad_q=skip, window=window, bwd_impl=impl)
    ref = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    for name in port_flash.launches:
        assert port_flash.launches[name] == before[name] + (name in names)
        assert port_flash.window_launches[name] == before_w[name] + (
            name in names and window is not None)
        assert port_flash.d256_launches[name] == before_d[name] + (
            name in names and shape[5] == 256)
    again = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal,
                                skip_pad_q=skip, window=window, bwd_impl=impl)
    for a, b, name in zip(grads, again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), f"{name} differs between two launches"
    for a, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        err = (a.float() - r).abs().max().item()
        assert err <= BWD_TOL_OF_MAX * r.abs().max().item(), (name, err)
        rel = ((a.float() - r).norm() / r.norm()).item()
        assert rel <= BWD_REL_L2, (name, rel)


def test_bwd_reads_strided_fused_qkv(cuda):
    """The backward reads q/k/v as views of one fused projection output, as
    the encoder hands them over, without a copy."""
    b, s, hq, hkv, d = 4, 192, 32, 8, 64
    g = torch.Generator().manual_seed(9)
    fused = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g).bfloat16().to(cuda)
    q = fused[..., : hq * d].view(b, s, hq, d)
    k = fused[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (hq + hkv) * d :].view(b, s, hkv, d)
    lens = torch.tensor([1, 70, 130, 192])
    mask = (torch.arange(s)[None] < lens[:, None]).int().to(cuda)
    do = torch.randn(q.shape, generator=g).bfloat16().to(cuda)
    out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    ref = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=True)
    for impl in ("fused", "split"):
        grads = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                    skip_pad_q=True, bwd_impl=impl)
        for a, r, name in zip(grads, ref, ("dq", "dk", "dv")):
            err = (a.float() - r).abs().max().item()
            assert err <= BWD_TOL_OF_MAX * r.abs().max().item(), (impl, name, err)
            rel = ((a.float() - r).norm() / r.norm()).item()
            assert rel <= BWD_REL_L2, (impl, name, rel)


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
    assert got == {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_dq": 2, "flash_dkv": 2}


def test_fused_bwd_impl_reaches_k2_through_the_model(cuda):
    """``for_training(bwd_impl="fused")`` (the CLIs' ``--flash_bwd_impl
    fused``) runs K2 in every layer's backward; the default runs K3a and
    K3b."""
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), hidden_size=256,
                              intermediate_size=512, head_dim=64)
    state = llama.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"input_ids": torch.randint(5, 512, (2, 128), generator=g).to(cuda),
             "attention_mask": torch.ones(2, 128, dtype=torch.int64, device=cuda)}
    for impl, ran in (("fused", "flash_bwd_fused"), ("auto", "flash_dq")):
        model = llama.LlamaEncoder.for_training(cfg, state, device=cuda, bwd_impl=impl)
        before = dict(port_flash.launches)
        embed(model, batch).sum().backward()
        got = {n: port_flash.launches[n] - before[n] for n in port_flash.launches}
        assert got[ran] == cfg.num_hidden_layers, (impl, got)
        assert sum(got[n] for n in ("flash_bwd_fused", "flash_dq")) == cfg.num_hidden_layers


def test_fused_and_split_bwd_repeat_bit_for_bit(cuda):
    """The split kernels hold dq in registers; the fused kernel adds each key
    tile's dq in key-tile order (with a window, from the first key tile that
    reaches the query tile). Both give identical dq, dk, dv on every launch,
    with random and with full lengths, with and without a window."""
    for full, window in ((False, None), (True, None), (False, 100), (True, 128)):
        q, k, v, mask, do, lse, delta = _bwd_inputs(SHAPES[0][0], True, True, cuda, seed=4,
                                                    full=full, window=window)
        args = (q, k, v, mask, do, lse, delta)
        for impl in ("split", "fused"):
            runs = [flash_attention_bwd(*args, causal=True, skip_pad_q=True, window=window,
                                        bwd_impl=impl)
                    for _ in range(3)]
            for grads in runs[1:]:
                for a, b in zip(runs[0], grads):
                    assert torch.equal(a, b), (impl, full, window)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("full", [False, True])
def test_d256_bwd_repeats_bit_for_bit(cuda, full, window):
    """At head_dim 256 the kv kernels run two blocks per key tile, one per
    column half, and K2 adds each half's dq in key-tile order on its own
    counters: both backwards give identical dq, dk, dv on every launch."""
    shape = (8, 512, 512, 8, 1, 256)
    q, k, v, mask, do, lse, delta = _bwd_inputs(shape, True, True, cuda, seed=5, full=full,
                                                window=window)
    for impl in ("split", "fused"):
        runs = [flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                    skip_pad_q=True, window=window, bwd_impl=impl)
                for _ in range(3)]
        for grads in runs[1:]:
            for a, b in zip(runs[0], grads):
                assert torch.equal(a, b), (impl, full, window)


# sequence packing (segment_ids): (B, S, Hq, Hkv, D), causal, window, the
# longest segment. BGE's non-causal 16 / 16 at D 64, Llama's causal 32 / 8,
# Qwen2's 12 / 2 at D 128, gemma-2b's 8 / 1 at D 256, a window shorter than
# the segments, and S off the 64-row tile
PACKED_SHAPES = [
    ((4, 512, 16, 16, 64), False, None, 300),
    ((4, 512, 32, 8, 64), True, None, 300),
    ((4, 512, 32, 8, 64), True, None, 40),  # many segments per tile
    ((4, 256, 12, 2, 128), True, None, 150),
    ((4, 512, 8, 1, 256), True, None, 300),
    ((2, 1024, 32, 8, 128), True, 100, 700),
    ((4, 200, 32, 8, 64), True, None, 90),
]


def _packed_segments(b, s, max_len, seed=0):
    """[B, S] int32 segment ids, contiguous runs 1..n and a pad tail: row 0
    one segment over the whole row, row 1 all pad (a row the packer padded
    on), the others segments of random lengths in [1, max_len] that start
    mid-tile and cross tiles, then a pad tail of up to a quarter of the row,
    so whole query tiles lie in the pad."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    seg[0] = 1
    for r in range(2, b):
        end = s - int(rng.integers(0, s // 4 + 1))
        pos, i = 0, 1
        while pos < end:
            n = min(int(rng.integers(1, max_len + 1)), end - pos)
            seg[r, pos : pos + n] = i
            pos, i = pos + n, i + 1
    return torch.from_numpy(seg)


def _packed_inputs(shape, max_len, cuda, seed=0):
    b, s, hq, hkv, d = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=g).bfloat16().to(cuda)
    k = torch.randn(b, s, hkv, d, generator=g).bfloat16().to(cuda)
    v = torch.randn(b, s, hkv, d, generator=g).bfloat16().to(cuda)
    do = torch.randn(b, s, hq, d, generator=g).bfloat16().to(cuda)
    return q, k, v, do, _packed_segments(b, s, max_len, seed).to(cuda)


@pytest.mark.parametrize("shape,causal,window,max_len", PACKED_SHAPES)
def test_packed_kernels_match_plain(cuda, shape, causal, window, max_len):
    """K1, K2, K3a and K3b with segment_ids against their plain versions
    (every row: pad rows give zeros, lse NEG_INF and zero gradients), two
    launches of each bit-equal, each launch counted as packed."""
    q, k, v, do, seg = _packed_inputs(shape, max_len, cuda)
    kw = dict(causal=causal, window=window, segment_ids=seg)
    before = dict(port_flash.packed_launches)
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, None, skip_pad_q=True, **kw)
        again = flash_attention_fwd(q, k, v, None, skip_pad_q=True, **kw)
        ref, rlse = flash_attention_fwd_reference(q.float(), k.float(), v.float(), None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert (out.float() - ref).abs().max().item() <= OUT_ATOL
    has_key = rlse > -1e29
    assert (lse - rlse).abs()[has_key].max().item() <= LSE_ATOL
    assert torch.all(lse[~has_key] == rlse[~has_key])
    assert torch.all(out.abs().amax(-1)[~has_key.permute(0, 2, 1)] == 0)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    plain = flash_attention_bwd_reference(q, k, v, None, do, lse, delta, **kw)
    got = {}
    for impl in ("fused", "split"):
        got[impl] = flash_attention_bwd(q, k, v, None, do, lse, delta, skip_pad_q=True,
                                        bwd_impl=impl, **kw)
        again = flash_attention_bwd(q, k, v, None, do, lse, delta, skip_pad_q=True,
                                    bwd_impl=impl, **kw)
        for a, b_, name in zip(got[impl], again, ("dq", "dk", "dv")):
            assert torch.equal(a, b_), f"{impl} {name} differs between two launches"
        for a, r, name in zip(got[impl], plain, ("dq", "dk", "dv")):
            err = (a.float() - r).abs().max().item()
            assert err <= BWD_TOL_OF_MAX * r.abs().max().item(), (impl, name, err)
            rel = ((a.float() - r).norm() / r.norm()).item()
            assert rel <= BWD_REL_L2, (impl, name, rel)
    torch.cuda.synchronize()
    # dk and dv come from the same code in K2 and K3b
    for a, b_, name in zip(got["fused"][1:], got["split"][1:], ("dk", "dv")):
        assert torch.equal(a, b_), f"fused and split {name} differ"
    assert {n: port_flash.packed_launches[n] - before[n] for n in before} == {
        "flash_fwd": 2, "flash_bwd_fused": 2, "flash_dq": 2, "flash_dkv": 2}


def test_packed_fused_dq_order_with_pad_tiles(cuda):
    """K2's dq order with segments: layouts whose query tiles lie wholly in
    the pad, whose segments start mid-tile and span several tiles, and whose
    key tiles meet no query tile of theirs but the first (one long segment
    then one-token ones). Each finishes (no block waits on a key tile that
    never counts), repeats bit for bit and agrees with split."""
    b, s, hq, hkv, d = 3, 768, 8, 2, 64
    seg = np.zeros((b, s), np.int32)
    seg[0, :650] = 1  # one segment over 11 tiles, then 2 pad tiles
    seg[1, :100], seg[1, 100:101], seg[1, 101:700] = 1, 2, 3  # starts mid-tile
    seg[2, :500] = 1
    seg[2, 500:530] = np.arange(2, 32)  # one-token segments in a tile
    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g).bfloat16().to(cuda)
                   for h in (hq, hkv, hkv, hq))
    seg = torch.from_numpy(seg).to(cuda)
    for causal in (True, False):
        out, lse = flash_attention_fwd(q, k, v, None, causal=causal, skip_pad_q=True,
                                       segment_ids=seg)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, None, do, lse, delta)
        runs = {impl: [flash_attention_bwd(*args, causal=causal, skip_pad_q=True,
                                           segment_ids=seg, bwd_impl=impl) for _ in range(3)]
                for impl in ("fused", "split")}
        torch.cuda.synchronize()
        for impl, grads in runs.items():
            for again in grads[1:]:
                assert all(torch.equal(x, y) for x, y in zip(grads[0], again)), impl
        plain = flash_attention_bwd_reference(*args, causal=causal, segment_ids=seg)
        for impl, grads in runs.items():
            for a, r, name in zip(grads[0], plain, ("dq", "dk", "dv")):
                rel = ((a.float() - r).norm() / r.norm()).item()
                assert rel <= BWD_REL_L2, (causal, impl, name, rel)


def test_packed_autograd_through_function(cuda):
    """The FlashAttention Function with segment_ids against autograd through
    the plain attention (both bf16): gradients agree to cosine >= 0.999."""
    q, k, v, do, seg = _packed_inputs((4, 384, 32, 8, 64), 120, cuda, seed=3)
    grads = []
    for fn in (lambda *a: flash_attention(*a, None, causal=True, segment_ids=seg),
               lambda *a: attention_reference(*a, None, True, segment_ids=seg)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves).float() * do.float()).sum().backward()
        grads.append([x.grad.float() for x in leaves])
    for a, r, name in zip(*grads, ("dq", "dk", "dv")):
        cos = torch.nn.functional.cosine_similarity(a.flatten(), r.flatten(), dim=0)
        assert cos.item() >= 0.999, name


def test_other_head_dims_raise_on_card(cuda):
    """Head dims other than 64, 128 and 256 raise on a CUDA tensor, naming
    the queue that ports them, and launch nothing."""
    before = dict(port_flash.launches)
    for d in (80, 96, 512):
        q, k, v, mask, _ = (t.to(cuda) for t in _inputs(2, 64, 64, 4, 2, d))
        with pytest.raises(ValueError, match="Queue 2"):
            flash_attention_fwd(q, k, v, mask, causal=True)
    assert port_flash.launches == before


@pytest.mark.parametrize("window", [None, 70])
def test_autograd_step_through_function(cuda, window):
    """One backward through the FlashAttention Function against autograd
    through attention_reference (both bf16, with and without a window):
    gradients agree to 2^-6 of their largest entry (bf16 roundings sit at
    other places in the two) and to cosine >= 0.999."""
    q, k, v, mask, lens = (t.to(cuda) for t in _inputs(4, 192, 192, 32, 8, 64, seed=7))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    grads = []
    for fn in (lambda *a: flash_attention(*a, mask, causal=True, window=window),
               lambda *a: attention_reference(*a, mask, True, window=window)):
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


def _trainer_losses(cuda, out_dir):
    """Four Trainer steps on the card from seed 0 with default settings (so
    the backward's "auto" picks the split kernels): a small llama at head_dim
    64, passages of up to 256 tokens (several 64-key tiles, so dq sums over
    key tiles), batch 4 x group 4."""
    cfg = dataclasses.replace(tiny_llama_config(vocab_size=512), hidden_size=256,
                              intermediate_size=512, head_dim=64)
    state = llama.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(400)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    rows = [{"query": text(4, 60), "positives": [text(20, 250)],
             "negatives": [text(20, 250) for _ in range(3)]} for _ in range(32)]
    dataset = ContrastiveDataset(rows, HashTokenizer(vocab_size=512), 64, 256)
    collator = ContrastiveCollator(0, 3, 64, 256, seed=3)
    model = llama.LlamaEncoder.for_training(cfg, state, device=cuda)
    config = TrainConfig(output_dir=str(out_dir), device="cuda", learning_rate=1e-3,
                         max_steps=4, per_device_train_batch_size=4, save_strategy="no",
                         save_on_preemption=False, seed=3)
    trainer = Trainer(loss_fn=make_contrastive_loss_fn(cfg, temperature=0.05), model=model,
                      config=config, total_steps=4)
    return [h["loss"] for h in trainer.train(dataset, collator)]


def test_trainer_loss_history_repeats_bit_for_bit(cuda, tmp_path):
    """Two trainers built the same way give equal loss histories, as
    tests/test_train.py asserts for the JAX package (docs/DETERMINISM.md)."""
    assert not torch.are_deterministic_algorithms_enabled()
    before = dict(port_flash.launches)
    first = _trainer_losses(cuda, tmp_path / "a")
    assert port_flash.launches["flash_dq"] > before["flash_dq"]
    assert port_flash.launches["flash_bwd_fused"] == before["flash_bwd_fused"]
    second = _trainer_losses(cuda, tmp_path / "b")
    assert len(first) == 4 and np.all(np.isfinite(first))
    assert first == second


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_remat_policies_bit_equal_on_card(cuda, policy):
    """The kernels under each checkpointing policy: the loss and every
    gradient equal the run without checkpointing bit for bit, and "attn"
    runs K1 once per layer and field (its saved tensors serve the
    backward), the others twice."""
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
    runs = []
    for remat in (False, True):
        model = llama.LlamaEncoder.for_training(cfg, state, device=cuda,
                                                gradient_checkpointing=remat,
                                                checkpoint_policy=policy)
        before = port_flash.launches["flash_fwd"]
        loss, _ = make_contrastive_loss_fn(cfg, temperature=0.05)(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: p.grad for n, p in model.named_parameters()},
                     port_flash.launches["flash_fwd"] - before))
    (l0, g0, k0), (l1, g1, k1) = runs
    assert l1 == l0
    for name, grad in g0.items():
        assert torch.equal(g1[name], grad), name
    layers_fields = cfg.num_hidden_layers * 2
    assert k0 == layers_fields
    assert k1 == (layers_fields if policy == "attn" else 2 * layers_fields)


def test_adamw8bit_card_step_equals_cpu_step(cuda):
    """Three 8-bit AdamW steps on the card give the CPU's codes, scales and
    parameters: every operation is elementwise or a per-block max, and the
    bias-correction divisions are true divisions on both."""
    from rankpo_tpu_torch.train.optim8bit import AdamW8bit

    g = torch.Generator().manual_seed(0)
    shapes = [(10, 300), (7,), (64, 256)]
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * torch.exp(torch.rand(s, generator=g) * 8 - 6)
              for s in shapes] for _ in range(3)]
    results = []
    for device in ("cpu", cuda):
        ps = [torch.nn.Parameter(p.to(device, copy=True)) for p in params]
        opt = AdamW8bit(ps, lr=1e-3, weight_decay=0.01)
        for step in grads:
            for p, gr in zip(ps, step):
                p.grad = gr.to(device)
            opt.step()
        results.append(([p.detach().cpu() for p in ps],
                        [{k: v.cpu() for k, v in opt.state[p].items() if torch.is_tensor(v)}
                         for p in ps]))
    (cpu_p, cpu_s), (card_p, card_s) = results
    for a, b in zip(cpu_s, card_s):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for a, b in zip(cpu_p, card_p):
        assert torch.equal(a, b)


# ---- the IVF kernels: K4 (probed-block scores), K5/K6 (PQ ADC, rows/cols) ----
# fp32 sums of the same exact products in another order: the scores are of
# order 1 (unit rows, or sums of m table entries), and the two orders differ
# by a few fp32 ulps of the largest partial sum
IVF_RTOL_OF_MAX = 1e-5


def _probe(n_clusters, q_n, p_n, g):
    probe = torch.stack([torch.randperm(n_clusters, generator=g)[:p_n] for _ in range(q_n)])
    probe[0, 0], probe[-1, -1] = 0, n_clusters - 1  # boundary cluster ids
    return probe.int()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_n,p_n,cap,d", [(64, 8, 336, 2048), (5, 3, 37, 64),
                                           (3, 17, 64, 8), (130, 2, 129, 1024)])
def test_probe_scores_kernel_matches_plain(cuda, dtype, q_n, p_n, cap, d):
    from rankpo_tpu_torch.ops import ivf_gather

    g = torch.Generator().manual_seed(cap + d)
    n_clusters = max(p_n, 24)
    corpus = torch.nn.functional.normalize(torch.randn(n_clusters * cap, d, generator=g), dim=1)
    queries = torch.nn.functional.normalize(torch.randn(q_n, d, generator=g), dim=1)
    probe = _probe(n_clusters, q_n, p_n, g)
    corpus, queries, probe = corpus.to(cuda, dtype), queries.to(cuda), probe.to(cuda)
    before = ivf_gather.launches["ivf_probe_scores"]
    got = ivf_gather.probe_scores(corpus, probe, queries, cap=cap)
    ref = ivf_gather.probe_scores_plain(corpus, probe, queries, cap=cap)
    torch.cuda.synchronize()
    assert ivf_gather.launches["ivf_probe_scores"] == before + 1
    assert got.shape == (q_n, p_n, cap) and got.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert err <= IVF_RTOL_OF_MAX * ref.abs().max().item(), err


def _skewed_probe(kind, n_clusters, q_n, p_n, g):
    """Probe sets that stress K4's grouping: every query probing the same P
    clusters (one group per cluster of Q pairs, more than one chunk of 8),
    one hot cluster probed by every query beside random others, clusters
    listed twice in a row, and ids outside [0, K)."""
    probe = _probe(n_clusters, q_n, p_n, g).long()
    if kind == "same":
        probe[:] = probe[0]
    elif kind == "hot":
        probe[:, 0] = 3
    elif kind == "duplicates":
        probe[:, 1] = probe[:, 0]
        probe[0, :] = probe[0, 0]
    elif kind == "outside":
        probe[::2, 1] = -1
        probe[1::3, 0] = n_clusters
        probe[-1, -1] = n_clusters + 100
    return probe.int()


@pytest.mark.parametrize("kind", ["same", "hot", "duplicates", "outside"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cap,d", [(333, 64), (336, 2048)])
def test_probe_scores_kernel_on_skewed_probe_sets(cuda, kind, dtype, cap, d):
    """K4 against the plain version where the (query, probe) groups are
    large, repeated or invalid: scores within IVF_RTOL_OF_MAX of the largest,
    NaN exactly over the blocks of ids outside [0, K); two launches
    bit-equal."""
    from rankpo_tpu_torch.ops import ivf_gather

    g = torch.Generator().manual_seed(cap + d + len(kind))
    n_clusters, q_n, p_n = 24, 21, 6
    corpus = torch.nn.functional.normalize(torch.randn(n_clusters * cap, d, generator=g), dim=1)
    queries = torch.nn.functional.normalize(torch.randn(q_n, d, generator=g), dim=1)
    probe = _skewed_probe(kind, n_clusters, q_n, p_n, g)
    corpus, queries, probe = corpus.to(cuda, dtype), queries.to(cuda), probe.to(cuda)
    got = ivf_gather.probe_scores(corpus, probe, queries, cap=cap)
    again = ivf_gather.probe_scores(corpus, probe, queries, cap=cap)
    valid = (probe >= 0) & (probe < n_clusters)
    ref = ivf_gather.probe_scores_plain(corpus, torch.where(valid, probe, 0), queries, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), ~valid[:, :, None].expand(-1, -1, cap))
    assert torch.equal(got[valid], again[valid]) and again[~valid].isnan().all()
    err = (got[valid] - ref[valid]).abs().max().item()
    assert err <= IVF_RTOL_OF_MAX * ref[valid].abs().max().item(), err


def test_probe_scores_kernel_rounds_query_for_bf16_rows(cuda):
    """bf16 rows score the bf16-rounded query (the TPU kernel's DEFAULT
    precision): an fp32 query off the bf16 grid gives the rounded scores."""
    from rankpo_tpu_torch.ops import ivf_gather

    g = torch.Generator().manual_seed(5)
    corpus = torch.randn(4 * 16, 128, generator=g).to(cuda, torch.bfloat16)
    queries = (torch.randn(2, 128, generator=g) * (1 + 2.0**-12)).to(cuda)
    probe = torch.tensor([[0, 3], [2, 1]], dtype=torch.int32, device=cuda)
    got = ivf_gather.probe_scores(corpus, probe, queries, cap=16)
    rounded = ivf_gather.probe_scores(corpus, probe, queries.bfloat16().float(), cap=16)
    assert torch.equal(got, rounded)


def _sequential_adc(codes, probe, lut, cap, cols):
    """The contract's sum, written as a torch loop of fp32 adds over j = 0 ..
    m - 1 from 0; probe ids outside [0, K) read cluster 0 (the kernel writes
    NaN there)."""
    rows = codes.T if cols else codes
    m = rows.shape[1]
    n_clusters = rows.shape[0] // cap
    ok = (probe >= 0) & (probe < n_clusters)
    blocks = rows.view(-1, cap, m)[torch.where(ok, probe, 0).long()]  # [Q, P, cap, m]
    q_n = probe.shape[0]
    acc = torch.zeros(blocks.shape[:3], dtype=torch.float32, device=codes.device)
    for j in range(m):
        idx = (blocks[..., j].long() & 255).reshape(q_n, -1)
        acc = acc + torch.gather(lut[:, j, :], 1, idx).view_as(acc)
    return acc


# (Q, P, cap, m, codes offset in bytes): the scale path (P 1), the served
# IVF64,PQ64 tier (Q 1, P 18, cap 128), a wider probe set, m 256 (the table
# streams), caps off every tile (37, 333, 2049), m 128 (one block per SM),
# m 24 (a half chunk: cols read it by TMA, rows from global memory), and
# shapes that take route "ldg": m not a multiple of 16 in rows, K * cap not
# a multiple of 16 in cols, codes starting 8 bytes off a 16-byte boundary
PQ_CASES = [(64, 1, 384, 64, 0), (1, 18, 128, 64, 0), (16, 18, 128, 64, 0),
            (64, 8, 384, 64, 0), (5, 3, 37, 8, 0), (7, 4, 333, 256, 0),
            (200, 1, 2049, 32, 0), (9, 5, 37, 24, 0), (6, 7, 384, 64, 8),
            (3, 5, 37, 128, 0), (4, 6, 64, 24, 0)]


@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("q_n,p_n,cap,m,offset", PQ_CASES)
def test_pq_adc_kernels_match_plain(cuda, layout, q_n, p_n, cap, m, offset):
    """K5/K6 against the plain version, and bit-equal to the contract's
    sequential fp32 sum over j, on the route adc_plan picks; ids outside
    [0, K) give NaN; two launches are bit-equal."""
    from rankpo_tpu_torch.ops import pq_adc

    g = torch.Generator().manual_seed(cap + m)
    n_clusters = max(p_n, 20)
    codes = torch.randint(0, 256, (n_clusters * cap, m), generator=g, dtype=torch.uint8)
    codes[:cap] = 255  # unsigned reads past 127
    lut = torch.randn(q_n, m, pq_adc.PQ_K, generator=g) / m**0.5
    probe = _probe(n_clusters, q_n, p_n, g)
    if q_n > 1:
        probe[1, 0], probe[-1, 0] = -3, n_clusters  # ids outside [0, K): NaN
    cols = layout == "cols"
    if cols:
        codes = codes.T.contiguous()
    storage = torch.empty(codes.numel() + offset, dtype=torch.uint8, device=cuda)
    codes_dev = storage[offset:].view(codes.shape)
    codes_dev.copy_(codes)
    codes, lut, probe = codes_dev, lut.to(cuda), probe.to(cuda)
    fn, plain = ((pq_adc.pq_probe_scores_t, pq_adc.pq_probe_scores_t_plain) if cols
                 else (pq_adc.pq_probe_scores, pq_adc.pq_probe_scores_plain))
    name = f"pq_adc_{layout}"
    pitch = n_clusters * cap if cols else m  # bytes from one row of codes to the next
    plan = pq_adc.plan_for(codes, probe, cap, m)
    assert plan.route == ("tma" if offset == 0 and m <= 128 and pitch % 16 == 0 else "ldg")
    before, routes = dict(pq_adc.launches), dict(pq_adc.route_launches)
    got = fn(codes, probe, lut, cap=cap)
    torch.cuda.synchronize()
    assert {n: pq_adc.launches[n] - before[n] for n in before} == {
        n: int(n == name) for n in before}
    assert {n: pq_adc.route_launches[n] - routes[n] for n in routes} == {
        n: int(n == f"{name}/{plan.route}") for n in routes}
    assert got.shape == (q_n, p_n, cap) and got.dtype == torch.float32
    valid = (probe >= 0) & (probe < n_clusters)
    assert torch.equal(got.isnan(), ~valid[:, :, None].expand(-1, -1, cap))
    seq = _sequential_adc(codes, probe, lut, cap, cols)
    assert torch.equal(got[valid], seq[valid])  # the contract's order, bit for bit
    ref = plain(codes, torch.where(valid, probe, 0), lut, cap=cap)
    err = (got[valid] - ref[valid]).abs().max().item()
    assert err <= IVF_RTOL_OF_MAX * ref[valid].abs().max().item(), err
    again = fn(codes, probe, lut, cap=cap)
    assert torch.equal(again[valid], got[valid])
    # int8 bits of the same codes read as unsigned
    assert torch.equal(fn(codes.view(torch.int8), probe, lut, cap=cap)[valid], got[valid])


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_pq_adc_every_launch_shape_gives_the_same_bits(cuda, layout):
    """The tile, the blocks per query and the route change nothing: at the
    scale path's cap every launch the kernel takes gives the bits of the
    sequential sum."""
    from rankpo_tpu_torch.ops import pq_adc

    g = torch.Generator().manual_seed(11)
    q_n, p_n, cap, m, n_clusters = 8, 3, 384, 64, 40
    codes = torch.randint(0, 256, (n_clusters * cap, m), generator=g, dtype=torch.uint8)
    lut = (torch.randn(q_n, m, pq_adc.PQ_K, generator=g) / 8).to(cuda)
    probe = _probe(n_clusters, q_n, p_n, g).to(cuda)
    cols = layout == "cols"
    codes = (codes.T.contiguous() if cols else codes).to(cuda)
    seq = _sequential_adc(codes, probe, lut, cap, cols)
    n_slots = n_clusters * cap
    for plan in [pq_adc.AdcPlan("tma", 192, 1), pq_adc.AdcPlan("tma", 192, 6),
                 pq_adc.AdcPlan("tma", 64, 18), pq_adc.AdcPlan("tma", 128, 4),
                 pq_adc.AdcPlan("tma", 256, 3), pq_adc.AdcPlan("ldg", 1024, 2),
                 pq_adc.AdcPlan("ldg", 48, 6)]:
        got = pq_adc._launch(codes, probe, lut, cap, m, n_slots, int(cols), plan)
        assert torch.equal(got, seq), plan


def test_ivf_kernels_reject_what_they_do_not_take(cuda):
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    probe = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        ivf_gather.probe_scores(torch.zeros(4 * 16, 12, device=cuda), probe,
                                torch.zeros(2, 12, device=cuda), cap=16)
    with pytest.raises(ValueError, match="multiple of 8"):
        pq_adc.pq_probe_scores(torch.zeros(4 * 16, 12, dtype=torch.uint8, device=cuda),
                               probe, torch.zeros(2, 12, 256, device=cuda), cap=16)


@pytest.mark.parametrize("kw,kernel", [({}, "ivf_probe_scores"),
                                       ({"store_dtype": torch.float32}, "ivf_probe_scores"),
                                       ({"pq_m": 16, "pq_layout": "rows"}, "pq_adc_rows"),
                                       ({"pq_m": 32, "pq_layout": "cols"}, "pq_adc_cols")])
def test_ivf_index_on_card_matches_cpu(cuda, kw, kernel):
    """An IVF index built on the card searches through its kernel and agrees
    with the same index carried to the CPU (plain versions there): indices
    equal outside 1e-5 near-ties, scores within 1e-5."""
    from rankpo_tpu_torch.index import io as pio
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    rng = np.random.default_rng(0)
    centres = rng.standard_normal((40, 128)).astype(np.float32)
    x = centres[rng.integers(0, 40, 5000)] + 0.3 * rng.standard_normal((5000, 128))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    index = IVFIPIndex(torch.from_numpy(x[:4900]).to(cuda), n_clusters=32,
                       recall_target=0.9, **kw)
    host = pio.index_from_state(pio.index_state(index), device="cpu")
    counters = {**ivf_gather.launches, **pq_adc.launches}
    s, i = index.search(x[4900:], k=20, batch_size=32)
    hs, hi = host.search(x[4900:], k=20, batch_size=32)
    after = {**ivf_gather.launches, **pq_adc.launches}
    assert after[kernel] > counters[kernel]
    np.testing.assert_allclose(s, hs, atol=1e-5, rtol=0)
    gaps = np.abs(np.diff(hs, axis=1)) > 1e-5
    clear = np.ones_like(hi, dtype=bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    np.testing.assert_array_equal(i[clear], hi[clear])
    es, ei = index.exact_search(x[4900:], k=20)
    recall = np.mean([len(set(a) & set(b)) / 20 for a, b in zip(i, ei)])
    assert recall >= 0.85


def _same_hits(s, i, hs, hi, tol=1e-5):
    """Indices equal outside ``tol`` near-ties of the reference, scores
    within ``tol`` (-inf tails equal)."""
    np.testing.assert_array_equal(np.isneginf(s), np.isneginf(hs))
    fin = np.isfinite(hs)
    np.testing.assert_allclose(s[fin], hs[fin], atol=tol, rtol=0)
    ref = np.where(fin, hs, -1e9)
    gaps = np.abs(np.diff(ref, axis=1)) > tol
    clear = np.ones_like(hi, dtype=bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    np.testing.assert_array_equal(i[clear], hi[clear])


def _card_data(n=5000, d=128, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((40, d)).astype(np.float32)
    x = centres[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kw,kernel", [({}, "ivf_probe_scores"),
                                       ({"store_dtype": torch.float32}, "ivf_probe_scores"),
                                       ({"pq_m": 16, "pq_layout": "rows"}, "pq_adc_rows"),
                                       ({"pq_m": 32, "pq_layout": "cols"}, "pq_adc_cols")])
def test_filtered_and_mutated_search_launch_kernels(cuda, kw, kernel):
    """Filtered search, and search after an append that grows the capacity
    and after a removal, launch the index's kernel on the card (the filter
    masks its output), and equal the same searches through the plain
    versions (the same index carried to the CPU)."""
    from rankpo_tpu_torch.index import io as pio
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    x = _card_data()
    queries = x[4900:]
    index = IVFIPIndex(torch.from_numpy(x[:3000]).to(cuda), n_clusters=32, nprobe=8,
                       capacity_slack=1.05, **kw)
    allowed = np.random.default_rng(1).choice(3000, size=1500, replace=False)
    grown = index.append_sharded(torch.from_numpy(x[3000:4900]).to(cuda), 1900)
    assert grown.capacity > index.capacity
    assert grown.capacity % grown._capacity_multiple() == 0
    removed = grown.remove_rows(np.arange(0, 4900, 3))
    for idx, filt in ((index, {"allowed_ids": allowed}), (grown, {}),
                      (removed, {"disallowed_ids": np.arange(100)})):
        host = pio.index_from_state(pio.index_state(idx), device="cpu")
        before = {**ivf_gather.launches, **pq_adc.launches}[kernel]
        s, i = idx.search(queries, k=20, batch_size=32, **filt)
        assert {**ivf_gather.launches, **pq_adc.launches}[kernel] > before
        _same_hits(s, i, *host.search(queries, k=20, batch_size=32, **filt))
    host = pio.index_from_state(pio.index_state(grown), device="cpu")
    ids = np.arange(2990, 3064)
    np.testing.assert_array_equal(grown.reconstruct(ids), host.reconstruct(ids))


@pytest.mark.parametrize("kw", [{"kmeans_split": 8}, {"balance_eta": 0.05},
                                {"pq_m": 16, "pq_rotate": "random"}])
def test_streamed_and_split_builds_on_card_match_cpu(cuda, kw):
    """``from_chunk_fn`` on the card (with the k-means options) launches its
    kernel and equals the same streamed build's search on the CPU."""
    from rankpo_tpu_torch.index import io as pio
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    x = _card_data()
    index = IVFIPIndex.from_chunk_fn(lambda lo, hi: torch.from_numpy(x[lo:hi]), 4800, 128,
                                     chunk_rows=1000, n_clusters=32, recall_target=0.9,
                                     device="cuda", **kw)
    host = pio.index_from_state(pio.index_state(index), device="cpu")
    counter = "pq_adc_rows" if "pq_m" in kw else "ivf_probe_scores"
    before = {**ivf_gather.launches, **pq_adc.launches}[counter]
    s, i = index.search(x[4800:], k=20)
    assert {**ivf_gather.launches, **pq_adc.launches}[counter] > before
    _same_hits(s, i, *host.search(x[4800:], k=20))


def test_refine_and_hybrid_on_card_match_cpu(cuda):
    """The two-stage tiers (torch products, no kernel) on the card against
    the same indexes on the CPU."""
    from rankpo_tpu_torch.index import io as pio
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.index.refined import RefineIPIndex

    x = _card_data()
    rows = torch.from_numpy(x[:4800]).to(cuda)
    for index in (RefineIPIndex.from_sharded(rows, 4800, reduced_dim=32, recall_target=0.9),
                  IVFIPIndex(rows, n_clusters=32, reduced_dim=32, recall_target=0.9)):
        host = pio.index_from_state(pio.index_state(index), device="cpu")
        _same_hits(*index.search(x[4800:], k=20), *host.search(x[4800:], k=20))
        sel = {"allowed_ids": np.arange(0, 4800, 2)}
        _same_hits(*index.search(x[4800:], k=20, **sel), *host.search(x[4800:], k=20, **sel))
