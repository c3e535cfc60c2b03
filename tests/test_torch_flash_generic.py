"""The plain versions of the generic flash build against the JAX package.

The generic build (``ops/csrc/flash_generic.cu``) runs K1, K3a, K3b and K2
in fp32, fp16 and bf16 at any head_dim that is a multiple of 8. On the card
it is held to the port's plain versions, ``flash_attention_fwd_reference``
and ``flash_attention_bwd_reference`` (``chip_smoke.py`` phase 2f,
``tests/test_torch_gpu.py``). Here those plain versions are held, on the
same inputs in the same dtype (made with numpy, cast once), to JAX's Pallas
kernels run in interpret mode, as tests/test_torch_flash_bwd.py holds them
in fp32: ``_flash_fwd_impl`` (out, lse), and ``flash_dq``, ``flash_dkv`` and
``flash_bwd_fused`` fed the Pallas forward's lse and delta = rowsum(dO * O).

Cases: every dtype at head_dim 72, 80, 96 and 320 with a key mask, causal
attention with Sq != Sk (bottom-right alignment), GQA and a row whose every
key is masked; and at head_dim 80 and 320, a sliding window with
``skip_pad_q`` (only rows below the valid length are compared: JAX's
kernel zeroes its skipped 16-row blocks, the plain version computes every
row) and ``segment_ids`` with a pad tail.

Tolerances, each tensor against the Pallas kernel's:

- lse: 2e-5 in every dtype (fp32 sums on both sides of s = scale * q.k);
- fp32: 2e-5 absolute on every tensor (``KERNEL_ATOL`` of
  test_torch_flash_bwd.py: two summation orders, values of order 1-10);
- a tensor rounded to fp16 or bf16 (out, the split dq): one ulp of the
  dtype at the largest |value| (2^-10 and 2^-7 of max|ref|), as two
  summation orders may round a value to either neighbour;
- an fp32 tensor of fp16 or bf16 inputs (dk, dv, the fused dq), which JAX
  sums from P rounded to the inputs' dtype before dV and dS before dK and
  dQ: relative L2 error 1e-4 (fp16) and 2e-5 (bf16), and 2^-10 of max|ref|
  per entry (an entry of P or dS that lies near a rounding boundary may
  round either way in the two). The same backward without those roundings
  (fp32 P and dS) lies about 2e-4 (fp16) and 1.5e-3 (bf16) from JAX's in
  relative L2; each test asserts it lies beyond 1.5 times the limit, so the
  limits catch a plain version that does not round.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    _flatten_heads,
    _unflatten_heads,
    fit_blocks,
    flash_bwd_fused,
    flash_dkv,
    flash_dq,
)
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32), "fp16": (jnp.float16, torch.float16),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_ATOL = 2e-5
LSE_ATOL = 2e-5
ULP_OF_MAX = {"fp16": 2.0**-10, "bf16": 2.0**-7}
SUMS_REL_L2 = {"fp16": 1e-4, "bf16": 2e-5}
SUMS_OF_MAX = 2.0**-10

# (b, sq, sk, hq, hkv, key lengths or segment rows, causal, window, skip_pad_q)
CASES = {
    # key mask, causal with Sq < Sk, GQA 2:1, a row with every key masked
    "mask_causal_gqa": (2, 16, 32, 4, 2, [27, 0], True, None, False),
    # a window of 8 keys over a 4:1 group, pad tail skipped
    "window_skip_pad_q": (2, 32, 32, 4, 1, [32, 10], True, 8, True),
    # packed rows: two texts and a pad tail, and two texts filling the row
    "segments": (2, 32, 32, 4, 2, [[1] * 9 + [2] * 15 + [0] * 8, [1] * 20 + [2] * 12],
                 True, None, False),
}
PARAMS = ([(dtype, d, "mask_causal_gqa") for dtype in DTYPES for d in (72, 80, 96, 320)]
          + [(dtype, d, case) for dtype in DTYPES for d in (80, 320)
             for case in ("window_skip_pad_q", "segments")])


def _inputs(dtype, d, case, seed=0):
    b, sq, sk, hq, hkv, rows, causal, window, skip = CASES[case]
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    xs = [jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(jd)
          for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(td) for x in xs]
    if case == "segments":
        seg = np.asarray(rows, dtype=np.int32)
        mask, lens = seg, (seg != 0).sum(1)
    else:
        lens = np.asarray(rows)
        mask, seg = (np.arange(sk)[None, :] < lens[:, None]).astype(np.int32), None
    return xs, ts, mask, seg, lens


def _pallas(xs, mask, causal, window, skip, packed):
    """JAX's kernels in interpret mode: out and dq in the inputs' dtype, lse,
    delta, split dk/dv and the fused dq/dk/dv in fp32, unflattened."""
    q, k, v, do = xs
    b, sq, hq, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q_block, k_block = fit_blocks(sq, sk, 16, 16)
    qf, kf, vf, gf = (_flatten_heads(x) for x in xs)
    mask_bh = jnp.repeat(jnp.asarray(mask), hq, axis=0)
    out, lse = _flash_fwd_impl(qf, kf, vf, mask_bh, causal, q_block, k_block, True, skip,
                               window, packed)
    delta = jnp.sum(gf.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    kw = dict(causal=causal, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=skip, window=window, packed=packed)
    dq = flash_dq(qf, kf, vf, mask_bh, gf, lse, delta, **kw)
    dk, dv = flash_dkv(qf, kf, vf, mask_bh, gf, lse, delta, **kw)
    fdq, fdk, fdv = flash_bwd_fused(qf, kf, vf, mask_bh, gf, lse, delta, **kw)

    def host(x, h):
        return np.asarray(_unflatten_heads(x, b, h).astype(jnp.float32))

    return dict(out=host(out, hq), lse=np.asarray(lse).reshape(b, hq, sq),
                delta=np.asarray(delta).reshape(b, hq, sq), dq=host(dq, hq), dk=host(dk, hkv),
                dv=host(dv, hkv), fused_dq=host(fdq, hq), fused_dk=host(fdk, hkv),
                fused_dv=host(fdv, hkv))


def _rounded_close(got, ref, dtype, what):
    """A tensor rounded to the inputs' dtype."""
    atol = KERNEL_ATOL if dtype == "fp32" else ULP_OF_MAX[dtype] * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=what)


def _sums_close(got, ref, unrounded, dtype, what):
    """An fp32 tensor summed from P and dS rounded to the inputs' dtype;
    ``unrounded``: the same from fp32 P and dS, which must miss the limit."""
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=KERNEL_ATOL, rtol=0, err_msg=what)
        return
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= SUMS_REL_L2[dtype], (what, rel)
    np.testing.assert_allclose(got, ref, atol=SUMS_OF_MAX * np.abs(ref).max(), rtol=0,
                               err_msg=what)
    miss = np.linalg.norm(unrounded - ref) / np.linalg.norm(ref)
    assert miss > 1.5 * SUMS_REL_L2[dtype], (what, "unrounded", miss)


@pytest.mark.parametrize("dtype,d,case", PARAMS)
def test_plain_versions_match_pallas_kernels(dtype, d, case):
    b, sq, sk, hq, hkv, _, causal, window, skip = CASES[case]
    xs, (q, k, v, do), mask, seg, lens = _inputs(dtype, d, case)
    ref = _pallas(xs, mask, causal, window, skip, seg is not None)
    kw = dict(causal=causal, window=window,
              segment_ids=None if seg is None else torch.from_numpy(seg))
    tmask = None if seg is not None else torch.from_numpy(mask)
    out, lse = flash_attention_fwd_reference(q, k, v, tmask, **kw)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    # rows the Pallas forward ran (skip_pad_q drops its blocks past the
    # valid length; bottom-right alignment shifts a row by Sk - Sq)
    rows = (np.arange(sq)[None, :] + sk - sq < lens[:, None]) if skip else np.ones((b, sq), bool)
    _rounded_close(out.float().numpy()[rows], ref["out"][rows], dtype, "out")
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[rows],
                               ref["lse"].transpose(0, 2, 1)[rows], atol=LSE_ATOL, rtol=0,
                               err_msg="lse")
    # the backward from the Pallas forward's statistics
    stats = [torch.from_numpy(ref[name].copy()) for name in ("lse", "delta")]
    grads = flash_attention_bwd_reference(q, k, v, tmask, do, *stats, **kw)
    unrounded = flash_attention_bwd_reference(q.float(), k.float(), v.float(), tmask,
                                              do.float(), *stats, **kw)
    dq, dk, dv = (g.numpy() for g in grads)
    _rounded_close(grads[0].to(q.dtype).float().numpy(), ref["dq"], dtype, "split dq")
    for name, got, idx in (("dk", dk, 1), ("dv", dv, 2), ("fused_dq", dq, 0),
                           ("fused_dk", dk, 1), ("fused_dv", dv, 2)):
        _sums_close(got, ref[name], unrounded[idx].numpy(), dtype, name)
    if case == "mask_causal_gqa":  # row 1 sees no key: zeros, lse NEG_INF, no gradient
        assert torch.all(out[1] == 0) and torch.all(lse[1] == -1e30)
        assert not dq[1].any() and not dk[1].any() and not dv[1].any()
