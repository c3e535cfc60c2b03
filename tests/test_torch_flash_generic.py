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


# The generic build's fp32 kernels multiply on the tensor cores as three
# TF32 passes (flash_generic.cu's header): each operand x splits into hi =
# tf32(x) and lo = tf32(x - hi), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
# with fp32 sums. A model of that product, the forward (O, lse), K3b's dK/dV
# and dQ in K3a's and K2's summation orders on it, against JAX's Pallas
# kernels in interpret mode in fp32: within the card tests' fp32 limits
# (tests/test_torch_gpu.py GENERIC_TOL_OF_MAX, GENERIC_REL_L2), where one
# TF32 pass (hi b_hi alone) misses them.
TF32_TOL_OF_MAX = 1e-5
TF32_REL_L2 = 1e-5
TF32_PARAMS = [(d, case) for d in (64, 72, 128) for case in CASES]


def _tf32(x):
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 rounds it: to 10 mantissa
    bits, to nearest with ties away from zero, on the fp32 bit pattern (the
    13 low bits cleared)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b (fp32, [..., m, k] @ [..., k, n]) on TF32 operands: three
    passes, or one (a_hi b_hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        out = _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + out
    return out.astype(np.float32)


def _valid_pairs(case, b, sq, sk, mask, seg):
    """[B, Sq, Sk]: the pairs JAX's kernels take (key mask or segments,
    causal aligned bottom-right, the window's band)."""
    _, _, _, _, _, _, causal, window, _ = CASES[case]
    qpos = np.arange(sq)[:, None] + sk - sq
    kpos = np.arange(sk)[None, :]
    band = np.ones((sq, sk), bool)
    if causal:
        band &= kpos <= qpos
    if window:
        band &= kpos > qpos - window
    if seg is not None:
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
        return same & band[None]
    return (mask[:, None, :] != 0) & band[None]


def _tf32_model(q, k, v, do, valid, lse_ref, delta_ref, passes, dq_keys=64):
    """The kernels' K1 (out, lse), K3b (dk, dv from the given lse and
    delta, each GQA group summed) and dQ = dS K with every product on the
    TF32 model; softmax and sums in fp32, masked logits at NEG_INF as the
    kernels. dQ is summed as the kernels sum it: each run of ``dq_keys``
    keys one product, the runs added in fp32 in key order (K3a: 8, one
    m16n8k8 step taken fresh; K2: 64, a key tile's sum added to its fp32
    buffer in key-tile order)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros(q.shape, np.float32)
    lse = np.zeros((b, hq, sq), np.float32)
    dk = np.zeros(k.shape, np.float32)
    dv = np.zeros(v.shape, np.float32)
    dq = np.zeros(q.shape, np.float32)
    for bi in range(b):
        for h in range(hq):
            qh, kh, vh, gh = q[bi, :, h], k[bi, :, h // groups], v[bi, :, h // groups], do[bi, :, h]
            s = _tf32_matmul(qh, kh.T, passes) * scale
            s = np.where(valid[bi], s, np.float32(-1e30))
            m = s.max(-1, keepdims=True)
            p = np.where(valid[bi], np.exp(s - m), np.float32(0))
            l = p.sum(-1, keepdims=True)
            safe = np.where(l == 0, np.float32(1), l)
            out[bi, :, h] = _tf32_matmul(p, vh, passes) / safe
            lse[bi, h] = (m + np.log(safe))[:, 0]
            row_lse = lse_ref[bi, h][:, None]
            ok = valid[bi] & (row_lse > -0.5e30)
            pb = np.where(ok, np.exp(np.where(ok, s - row_lse, 0)), np.float32(0))
            dp = _tf32_matmul(gh, vh.T, passes)
            ds = pb * (dp - delta_ref[bi, h][:, None]) * scale
            dv[bi, :, h // groups] += _tf32_matmul(pb.T, gh, passes)
            dk[bi, :, h // groups] += _tf32_matmul(ds.T, qh, passes)
            for k0 in range(0, sk, dq_keys):
                dq[bi, :, h] += _tf32_matmul(ds[:, k0:k0 + dq_keys], kh[k0:k0 + dq_keys], passes)
    return out, lse, dk, dv, dq


def _fp32_close(got, ref):
    """(max|got - ref| within 1e-5 of max|ref|, relative L2 within 1e-5)"""
    return (np.abs(got - ref).max() <= TF32_TOL_OF_MAX * np.abs(ref).max(),
            np.linalg.norm(got - ref) <= TF32_REL_L2 * np.linalg.norm(ref))


def _fp32_case(d, case):
    """The fp32 inputs of a TF32 case (seed 1) as numpy and as JAX's flat
    heads, JAX's forward statistics, the valid pairs and the kernels'
    keyword arguments."""
    b, sq, sk, hq, hkv, _, causal, window, _ = CASES[case]
    xs, _, mask, seg, _ = _inputs("fp32", d, case, seed=1)
    packed = seg is not None
    q_block, k_block = fit_blocks(sq, sk, 16, 16)
    flat = [_flatten_heads(x) for x in xs]
    mask_bh = jnp.repeat(jnp.asarray(mask), hq, axis=0)
    o_ref, lse_ref = _flash_fwd_impl(*flat[:3], mask_bh, causal, q_block, k_block, True, False,
                                     window, packed)
    delta_ref = jnp.sum(flat[3] * o_ref, axis=-1)
    kw = dict(causal=causal, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=False, window=window, packed=packed)
    return dict(np=[np.asarray(x) for x in xs], flat=flat, mask_bh=mask_bh, o_ref=o_ref,
                lse_ref=lse_ref, delta_ref=delta_ref, kw=kw,
                valid=_valid_pairs(case, b, sq, sk, mask, seg))


@pytest.mark.parametrize("d,case", TF32_PARAMS)
def test_three_tf32_passes_hold_fp32_limits(d, case):
    b, sq, _, hq, hkv = CASES[case][:5]
    c = _fp32_case(d, case)
    qf, kf, vf, gf = c["flat"]
    dk_ref, dv_ref = flash_dkv(qf, kf, vf, c["mask_bh"], gf, c["lse_ref"], c["delta_ref"],
                               **c["kw"])
    ref = {"out": np.asarray(_unflatten_heads(c["o_ref"], b, hq)),
           "dk": np.asarray(_unflatten_heads(dk_ref, b, hkv)),
           "dv": np.asarray(_unflatten_heads(dv_ref, b, hkv))}
    lse_ref = np.asarray(c["lse_ref"]).reshape(b, hq, sq)
    delta_ref = np.asarray(c["delta_ref"]).reshape(b, hq, sq)
    for passes in (3, 1):
        out, lse, dk, dv, _ = _tf32_model(*c["np"], c["valid"], lse_ref, delta_ref, passes)
        for name, got in (("out", out), ("dk", dk), ("dv", dv)):
            close = _fp32_close(got, ref[name])
            if passes == 3:
                assert all(close), (name, close)
            else:  # one pass misses: why the kernels take three
                assert not all(close), (name, close)
        if passes == 3:
            np.testing.assert_allclose(lse, lse_ref, atol=LSE_ATOL, rtol=0)


# keys of dS K that K3a and K2 take as one product before an fp32 add
DQ_KEYS = {"K3a": 8, "K2": 64}


@pytest.mark.parametrize("d,case", TF32_PARAMS)
def test_three_tf32_passes_hold_fp32_limits_for_dq(d, case):
    """dQ = dS K on the TF32 model in K3a's and K2's summation orders
    (``_tf32_model``'s ``dq_keys``), against JAX's ``flash_dq`` and
    ``flash_bwd_fused`` dq in interpret mode: within the fp32 limits with
    three passes, not with one."""
    b, sq, _, hq, _ = CASES[case][:5]
    c = _fp32_case(d, case)
    qf, kf, vf, gf = c["flat"]
    args = (qf, kf, vf, c["mask_bh"], gf, c["lse_ref"], c["delta_ref"])
    refs = {"flash_dq": flash_dq(*args, **c["kw"]), "flash_bwd_fused": flash_bwd_fused(
        *args, **c["kw"])[0]}
    refs = {name: np.asarray(_unflatten_heads(x, b, hq)) for name, x in refs.items()}
    lse_ref = np.asarray(c["lse_ref"]).reshape(b, hq, sq)
    delta_ref = np.asarray(c["delta_ref"]).reshape(b, hq, sq)
    for order, keys in DQ_KEYS.items():
        for passes in (3, 1):
            dq = _tf32_model(*c["np"], c["valid"], lse_ref, delta_ref, passes, dq_keys=keys)[4]
            for name, ref in refs.items():
                close = _fp32_close(dq, ref)
                if passes == 3:
                    assert all(close), (order, name, close)
                else:  # one pass misses, as for out, dk and dv
                    assert not all(close), (order, name, close)
