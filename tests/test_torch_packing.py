"""Sequence packing in the port against the JAX package.

The same inputs, made from a seed with numpy, go through both packages:

- the packers and collators (``data/packing.py``): arrays equal, on the
  sticky row budget, its overflow, the fixed budget with truncation and
  ``slot_offset``; ``probe_needs`` leaves the sampling RNG untouched;
  ``data/loader.py`` ``_stack`` pads uneven packed groups as JAX
  ``_stack_microbatches`` does;
- ``models/packing.py`` (positions, the three pooling modes, the scatter and
  its gradient): within 1e-6 (fp32 gathers and sums in either order);
- the plain attention with ``segment_ids`` (causal and not, GQA, a window,
  head dims 64, 128 and 256 at two heads) against ``_xla_attention`` and
  its ``jax.grad``, and against the Pallas ``flash_attention`` in interpret
  mode, forward and gradients: atol 1e-5 / 2e-5 (fp32 sums in other orders)
  and 3e-4 against the autodiff oracle, as tests/test_torch_mistral.py;
- the plain K1 (out, lse) and K2/K3a/K3b (dq, dk, dv from the forward's
  statistics) with segments against ``_flash_fwd_impl``, ``flash_bwd_fused``,
  ``flash_dq`` and ``flash_dkv`` (packed, interpret mode): atol 1e-5 / 2e-5;
- ``embed_packed`` for the Llama, Qwen2, windowed Mistral, Gemma and Roberta
  (CLS and mean pooling) bodies in fp32 against JAX ``embed_packed`` (1e-5)
  and the port's own ``embed`` of each text alone (1e-5);
- contrastive and RankPO loss and gradients, packed against unpacked on
  the same sampled examples (1e-5 on the loss, 5e-4 on the gradients, as
  tests/test_packing.py) and against the JAX packed loss (1e-5, 1e-4
  relative L2 per gradient);
- both training CLIs with ``--pack_sequences True`` and ``cli.serve`` with
  ``--pack_queries`` on the CPU: hits equal to the unpacked service's and
  to the JAX service's with ``pack_queries``;
- ``InferenceEncoder.encode_packed`` (the packed corpus encode) in fp32
  against the port's ``encode`` and JAX ``encode_packed`` on carried-over
  weights, over several rows a batch and over chunk boundaries: atol 2e-4
  (tests/test_packing.py ``TestEncodePacked``); an empty list gives [0, H],
  a bare string raises, as in JAX.
"""

import copy
import dataclasses
import json
import threading
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.data import packing as jpack
from rankpo_tpu.data.loader import _stack_microbatches
from rankpo_tpu.data.tokenization import HashTokenizer as JaxHashTokenizer
from rankpo_tpu.index import InferenceEncoder as JaxEncoder
from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models import packing as jmp
from rankpo_tpu.models.config import tiny_llama_config as jax_tiny_llama
from rankpo_tpu.models.config import tiny_roberta_config as jax_tiny_roberta
from rankpo_tpu.ops.attention import _xla_attention
from rankpo_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    _flatten_heads,
    _unflatten_heads,
    fit_blocks,
    flash_attention,
    flash_bwd_fused,
    flash_dkv,
    flash_dq,
)
from rankpo_tpu.serve import RetrievalService as JaxService
from rankpo_tpu.train import steps as jsteps
from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
from rankpo_tpu_torch.cli import serve as serve_cli
from rankpo_tpu_torch.data import packing as ppack
from rankpo_tpu_torch.data.collators import ContrastiveCollator, RankPOCollator
from rankpo_tpu_torch.data.loader import _stack
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.models import encoder as penc
from rankpo_tpu_torch.models import hf_io, llama
from rankpo_tpu_torch.models import packing as pmp
from rankpo_tpu_torch.models.config import EncoderConfig, tiny_llama_config
from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.ops.attention import NEG_INF, attention_reference, multi_head_attention
from rankpo_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from rankpo_tpu_torch.serve.service import RetrievalService
from rankpo_tpu_torch.train import steps as psteps

torch.set_num_threads(2)

ATOL = 1e-5
KERNEL_ATOL = 2e-5
ORACLE_ATOL = 3e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _tree_equal(a[key], b[key])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _token_lists(rng, n, lo, hi, vocab=64):
    return [list(rng.integers(3, vocab, int(rng.integers(lo, hi)))) for _ in range(n)]


# ---------------------------------------------------------------------------
# packers and collators


@pytest.mark.parametrize("capacity,max_segments,lo,hi", [(128, 8, 1, 65), (64, 3, 1, 33),
                                                          (32, 1, 1, 33), (512, 16, 16, 481)])
def test_packers_equal_jax(capacity, max_segments, lo, hi):
    rng = np.random.default_rng(capacity + max_segments)
    lengths = rng.integers(lo, hi, 150)
    assert ppack.pack_lengths(lengths, capacity, max_segments) == jpack.pack_lengths(
        lengths, capacity, max_segments)
    ids = _token_lists(rng, 90, lo, hi)
    got = ppack.pack_token_lists(ids, capacity, max_segments, pad_id=2)
    want = jpack.pack_token_lists(ids, capacity, max_segments, pad_id=2)
    for name in ("input_ids", "segment_ids", "text_index"):
        _tree_equal(getattr(got, name), getattr(want, name))
    assert got.n_rows == want.n_rows and got.max_segments == want.max_segments
    assert ppack.occupancy(got) == jpack.occupancy(want)
    assert ppack.pack_lengths([], 8, 2) == [] and ppack.occupancy(
        ppack.PackedRows(*(np.zeros((0, 4), np.int32),) * 3)) == 1.0
    for bad, match in (([10, capacity + 1], "exceeds pack capacity"), ([10, 0], "empty")):
        with pytest.raises(ValueError, match=match):
            ppack.pack_lengths(bad, capacity, max_segments)


def test_block_packer_equals_jax():
    """The sticky budget (first batch plus 1/8, reused, overflow rounded up
    to a multiple of it), rows_multiple, an empty text, the fixed budget
    with its truncation to fit, and slot_offset."""
    rng = np.random.default_rng(1)
    sizes = [(40, 4, 30), (12, 4, 30), (40, 20, 31), (40, 4, 30)]
    for rows_multiple in (1, 4):
        got = ppack._BlockPacker(32, 4, pad_id=0, rows_multiple=rows_multiple)
        want = jpack._BlockPacker(32, 4, pad_id=0, rows_multiple=rows_multiple)
        for n, lo, hi in sizes:
            seqs = _token_lists(rng, n, lo, hi) + [[]]
            _tree_equal(got(seqs), want(seqs))
            assert got.probe_rows(seqs) == want.probe_rows(seqs)
        got.slot_offset = want.slot_offset = 7
        seqs = _token_lists(rng, 20, 1, 30)
        _tree_equal(got(seqs), want(seqs))
        budget = got.set_budget(5)
        assert budget == want.set_budget(5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for n, lo, hi in [(12, 4, 30), (16, 20, 31), (8, 4, 30)]:  # 16 long: truncated
                seqs = _token_lists(rng, n, lo, hi)
                _tree_equal(got(seqs), want(seqs))
        assert got.n_truncated == want.n_truncated > 0
        with pytest.raises(ValueError, match="cannot hold"):
            got(_token_lists(rng, budget * 4 + 1, 1, 3))


def _contrastive_rows(rng, n, vocab=64, n_neg=4):
    def text(lo, hi):
        return list(rng.integers(5, vocab, int(rng.integers(lo, hi))))

    return [{"query": text(3, 12), "positives": [text(4, 20) for _ in range(2)],
             "negatives": [text(4, 20) for _ in range(n_neg)]} for _ in range(n)]


def _pair_rows(rng, n, vocab=64):
    def text(lo, hi):
        return list(rng.integers(5, vocab, int(rng.integers(lo, hi))))

    return [{"query": text(3, 12), "chosen": text(4, 20), "rejected": text(4, 20)}
            for _ in range(n)]


def test_packed_collators_equal_jax():
    """Both collators over several batches, with probe_needs between them
    (sampled on a copy: the stream is the JAX collator's without probes),
    fixed budgets and a process shard's slot offsets."""
    rng = np.random.default_rng(2)
    kw = dict(pad_token_id=0, max_query_length=16, max_passage_length=24,
              query_max_segments=4, passage_max_segments=4)
    got = ppack.PackedContrastiveCollator(num_negatives=2, seed=5, **kw)
    want = jpack.PackedContrastiveCollator(num_negatives=2, seed=5, **kw)
    for step in range(4):
        rows = _contrastive_rows(rng, 4)
        if step == 1:
            state = copy.deepcopy(got._sampler.rng.bit_generator.state)
            assert got.probe_needs(rows) == want.probe_needs(rows)
            assert got._sampler.rng.bit_generator.state == state
        if step == 2:
            assert got.set_budgets(3, 6) == want.set_budgets(3, 6)
            got.set_process_shard(1, 4)
            want.set_process_shard(1, 4)
        _tree_equal(got(rows), want(rows))
    got = ppack.PackedRankPOCollator(**kw)
    want = jpack.PackedRankPOCollator(**kw)
    for step in range(3):
        rows = _pair_rows(rng, 4)
        assert got.probe_needs(rows) == want.probe_needs(rows)
        if step == 1:
            assert got.set_budgets(2, 5) == want.set_budgets(2, 5)
            got.set_process_shard(2, 4)
            want.set_process_shard(2, 4)
        _tree_equal(got(rows), want(rows))
    with pytest.raises(KeyError, match="chosen"):
        got([{"query": [1]}])


def test_multi_process_packing_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        ppack.sync_packed_budgets(None, [])
    with pytest.raises(NotImplementedError, match="item 8"):
        ppack.configure_multiprocess_packing(None, [], 4)


def test_stack_pads_uneven_groups_as_jax():
    """Packed micro-batches of one accumulation group with different row
    budgets: rows padded to the group's largest, slot_index with -1."""
    rng = np.random.default_rng(3)
    coll = ppack.PackedContrastiveCollator(pad_token_id=0, num_negatives=2,
                                           max_query_length=16, max_passage_length=24,
                                           query_max_segments=4, passage_max_segments=4)
    groups = [coll(_contrastive_rows(rng, n)) for n in (2, 9)]  # the second overflows
    assert groups[0]["passage"]["input_ids"].shape != groups[1]["passage"]["input_ids"].shape
    want = jax.tree_util.tree_map_with_path(_stack_microbatches, *groups)
    got = _stack(groups)
    _tree_equal(got, want)
    assert (got["passage"]["slot_index"][0, groups[0]["passage"]["slot_index"].shape[0]:]
            == -1).all()
    plain = [{"input_ids": np.ones((2, 3), np.int32)}] * 2
    assert _stack(plain)["input_ids"].shape == (2, 2, 3)


# ---------------------------------------------------------------------------
# models/packing.py


def _segments(b, s, max_len, seed=0, pad_rows=True):
    """[B, S] int32 segment ids: contiguous runs 1..n with random lengths in
    [1, max_len], a random pad tail; with ``pad_rows``, row 0 one segment
    over the whole row and row 1 all pad."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        end = s - int(rng.integers(0, s // 3 + 1))
        pos, i = 0, 1
        while pos < end:
            n = min(int(rng.integers(1, max_len + 1)), end - pos)
            seg[r, pos : pos + n] = i
            pos, i = pos + n, i + 1
    if pad_rows:
        seg[0] = 1
        seg[1] = 0
    return seg


def test_packed_positions_and_pool_match_jax():
    seg = _segments(4, 40, 9, seed=1)
    np.testing.assert_array_equal(pmp.packed_positions(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jmp.packed_positions(jnp.asarray(seg))))
    hidden = np.random.default_rng(2).standard_normal((4, 40, 8)).astype(np.float32)
    for mode in ("last_token", "cls", "mean"):
        reps, valid = pmp.packed_pool(_t(hidden), torch.from_numpy(seg), 12, mode)
        jreps, jvalid = jmp.packed_pool(jnp.asarray(hidden), jnp.asarray(seg), 12, mode)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_allclose(reps.numpy(), np.asarray(jreps), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="pooling mode"):
        pmp.packed_pool(_t(hidden), torch.from_numpy(seg), 12, "max")


def test_scatter_packed_reps_values_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    reps = rng.standard_normal((3, 4, 6)).astype(np.float32)
    slots = np.array([[2, 0, -1, -1], [5, 1, 3, -1], [4, -1, -1, -1]], np.int32)
    w = rng.standard_normal((7, 6)).astype(np.float32)
    out = pmp.scatter_packed_reps(_t(reps).requires_grad_(), torch.from_numpy(slots), 7)
    jout = jmp.scatter_packed_reps(jnp.asarray(reps), jnp.asarray(slots), 7)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert np.all(out.detach().numpy()[6] == 0)  # slot 6 holds no segment
    leaf = _t(reps).requires_grad_()
    (pmp.scatter_packed_reps(leaf, torch.from_numpy(slots), 7) * _t(w)).sum().backward()
    jgrad = jax.grad(lambda r: jnp.sum(jmp.scatter_packed_reps(r, jnp.asarray(slots), 7)
                                       * jnp.asarray(w)))(jnp.asarray(reps))
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(jgrad))


# ---------------------------------------------------------------------------
# attention with segment_ids

# name: (b, s, hq, hkv, d, causal, window, longest segment)
CASES = {
    "causal_gqa": (3, 48, 4, 2, 64, True, None, 20),
    "bidirectional": (3, 48, 2, 2, 64, False, None, 20),
    "d128": (3, 40, 2, 1, 128, True, None, 15),
    "d256": (3, 40, 2, 2, 256, True, None, 15),
    "window": (3, 64, 4, 2, 64, True, 6, 30),  # segments longer than the window
    "many_blocks": (3, 64, 4, 2, 16, True, None, 40),  # segments cross 16-row blocks
}


def _inputs(b, s, hq, hkv, d, max_len, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    do = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    return q, k, v, do, _segments(b, s, max_len, seed)


@pytest.mark.parametrize("case", list(CASES))
def test_packed_plain_matches_xla_and_its_grad(case):
    b, s, hq, hkv, d, causal, window, max_len = CASES[case]
    q, k, v, do, seg = _inputs(b, s, hq, hkv, d, max_len)
    jseg = jnp.asarray(seg)

    def f(q_, k_, v_):
        return _xla_attention(q_, k_, v_, None, causal, window, segment_ids=jseg)

    ref = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention_reference(*leaves, None, causal, window=window,
                              segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    assert np.all(out.detach().numpy()[seg == 0] == 0.0)  # pad rows see no key
    jgrads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(do)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = torch.autograd.grad(out, leaves, _t(do))
    for a, r, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ORACLE_ATOL, rtol=0,
                                   err_msg=f"{case}: {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_packed_plain_matches_pallas_interpret(case):
    """The dispatcher's plain path on CPU tensors against the Pallas kernel
    with segment_ids in interpret mode (16-row blocks, so blocks are
    skipped), forward and jax.grad."""
    b, s, hq, hkv, d, causal, window, max_len = CASES[case]
    q, k, v, do, seg = _inputs(b, s, hq, hkv, d, max_len, seed=1)
    jseg = jnp.asarray(seg)

    def f(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=causal, window=window, segment_ids=jseg,
                               q_block=16, k_block=16, interpret=True)

    ref = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = multi_head_attention(*leaves, causal=causal, window=window,
                               segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    jgrads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(do)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = torch.autograd.grad(out, leaves, _t(do))
    for a, r, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ORACLE_ATOL, rtol=0,
                                   err_msg=f"{case}: {name}")


def _pallas_stats(q, k, v, do, seg, causal, window):
    """Flattened inputs, the packed Pallas forward's out, lse and delta."""
    hq, s = q.shape[2], q.shape[1]
    q_block, k_block = fit_blocks(s, s, 16, 16)
    qf, kf, vf, gf = (_flatten_heads(jnp.asarray(x)) for x in (q, k, v, do))
    seg_bh = jnp.repeat(jnp.asarray(seg), hq, axis=0)
    out, lse = _flash_fwd_impl(qf, kf, vf, seg_bh, causal, q_block, k_block, True, True,
                               window, packed=True)
    delta = jnp.sum(gf * out, axis=-1)
    kw = dict(causal=causal, q_block=q_block, k_block=k_block, interpret=True,
              skip_pad_q=True, window=window, packed=True)
    return (qf, kf, vf, seg_bh, gf, lse, delta), out, kw


@pytest.mark.parametrize("case", list(CASES))
def test_packed_kernel_plain_versions_match_pallas(case):
    """The plain K1 (out, lse) and the plain backward from the Pallas
    forward's stats against the packed Pallas kernels (skip_pad_q, as the
    bodies call them: rows of pad tiles are zeros either way)."""
    b, s, hq, hkv, d, causal, window, max_len = CASES[case]
    q, k, v, do, seg = _inputs(b, s, hq, hkv, d, max_len, seed=2)
    args, j_out, kw = _pallas_stats(q, k, v, do, seg, causal, window)
    pseg = torch.from_numpy(seg)
    out, lse = flash_attention_fwd_reference(_t(q), _t(k), _t(v), None, causal=causal,
                                             window=window, segment_ids=pseg)
    np.testing.assert_allclose(out.permute(0, 2, 1, 3).reshape(b * hq, s, d).numpy(),
                               np.asarray(j_out), atol=ATOL, rtol=0)
    keep = np.repeat(seg[:, None] != 0, hq, axis=1).reshape(b * hq, s)
    np.testing.assert_allclose(lse.reshape(b * hq, s).numpy()[keep],
                               np.asarray(args[5])[keep], atol=ATOL, rtol=1e-6)
    assert np.all(lse.numpy()[np.repeat(seg[:, None] == 0, hq, axis=1)]
                  == np.float32(NEG_INF))
    p_lse = torch.from_numpy(np.where(keep, np.asarray(args[5]), NEG_INF).astype(np.float32))
    for impl in ("fused", "split"):
        if impl == "fused":
            dq, dk, dv = flash_bwd_fused(*args, **kw)
        else:
            dq = flash_dq(*args, **kw)
            dk, dv = flash_dkv(*args, **kw)
        ref = (_unflatten_heads(dq, b, hq), _unflatten_heads(dk, b, hkv),
               _unflatten_heads(dv, b, hkv))
        port = flash_attention_bwd_reference(
            _t(q), _t(k), _t(v), None, _t(do), p_lse.reshape(b, hq, s),
            _t(args[6]).reshape(b, hq, s), causal=causal, window=window, segment_ids=pseg)
        for a, r, name in zip(port, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=KERNEL_ATOL, rtol=0,
                                       err_msg=f"{case}/{impl}: {name}")


def test_segment_arguments_are_checked():
    """JAX's rules: segment_ids needs Sq == Sk and no mask; a CPU tensor
    never reaches a kernel and no launch is counted."""
    q, k, v, _, seg = (torch.from_numpy(x) for x in _inputs(2, 32, 4, 2, 64, 9))
    mask = torch.ones(2, 32, dtype=torch.int32)
    before = (dict(port_flash.launches), dict(port_flash.packed_launches))
    with pytest.raises(ValueError, match="not both"):
        multi_head_attention(q, k, v, mask=mask, segment_ids=seg)
    with pytest.raises(ValueError, match="not both"):
        attention_reference(q, k, v, mask, True, segment_ids=seg)
    with pytest.raises(ValueError, match="sq == sk"):
        multi_head_attention(q[:, :16], k, v, segment_ids=seg)
    with pytest.raises(ValueError, match="sq == sk"):
        flash_attention_fwd_reference(q[:, :16], k, v, None, segment_ids=seg)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="not both"):
        flash_attention_fwd(qb, kb, vb, mask, segment_ids=seg)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(qb, kb, vb, None, causal=True, segment_ids=seg)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multi_head_attention(q, k, v, causal=True, impl="flash", segment_ids=seg)
    assert (port_flash.launches, port_flash.packed_launches) == before
    # dropout with a generator takes the plain path, with the segments
    out = multi_head_attention(q, k, v, segment_ids=seg, dropout_rate=0.5,
                               generator=torch.Generator().manual_seed(0))
    assert torch.all(out[seg == 0] == 0)


# ---------------------------------------------------------------------------
# embed_packed for every body

SEQ = 24


def _body_setup(kind, seed=0):
    if kind in ("llama", "qwen2", "mistral", "gemma"):
        jcfg = jax_tiny_llama(vocab_size=256)
        extra = {"qwen2": dict(model_type="qwen2", attention_qkv_bias=True,
                               architectures=("Qwen2Model",)),
                 "mistral": dict(model_type="mistral", sliding_window=5,
                                 architectures=("MistralModel",)),
                 "gemma": dict(model_type="gemma", head_dim=32, num_key_value_heads=1,
                               hidden_act="gelu_pytorch_tanh", rms_norm_eps=1e-6,
                               architectures=("GemmaModel",))}.get(kind, {})
        jcfg = dataclasses.replace(jcfg, **extra)
    else:
        jcfg = jax_tiny_roberta(vocab_size=256)
        if kind == "roberta_mean":
            jcfg = dataclasses.replace(jcfg, pooling="mean")
        if kind == "bert":
            jcfg = dataclasses.replace(jcfg, model_type="bert", pad_token_id=0,
                                       type_vocab_size=2, layer_norm_eps=1e-12,
                                       architectures=("BertModel",))
    params = jax.tree_util.tree_map(np.asarray, jenc.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.05, params)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, pcfg, hf_io.params_from_jax(params, pcfg)


BODIES = ["llama", "qwen2", "mistral", "gemma", "roberta", "roberta_mean", "bert"]


@pytest.mark.parametrize("kind", BODIES)
def test_embed_packed_matches_jax_and_each_text_alone(kind):
    jcfg, params, pcfg, state = _body_setup(kind)
    model = penc.encoder_class(pcfg).from_state_dict(pcfg, state, device="cpu")
    pad = pcfg.pad_token_id or 0
    rng = np.random.default_rng(7)
    texts = _token_lists(rng, 9, 1, 11, vocab=256)
    packed = ppack.pack_token_lists(texts, SEQ, 5, pad)
    m = packed.max_segments
    batch = {"input_ids": torch.from_numpy(packed.input_ids).long(),
             "segment_ids": torch.from_numpy(packed.segment_ids)}
    reps, valid = penc.embed_packed(model, batch, m)
    jreps, jvalid = jenc.embed_packed(
        params, jcfg, {"input_ids": jnp.asarray(packed.input_ids),
                       "segment_ids": jnp.asarray(packed.segment_ids)},
        m, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(reps.numpy(), np.asarray(jreps), atol=ATOL, rtol=0)
    assert np.all(reps.numpy()[~valid.numpy()] == 0)
    # each text alone, right-padded, through the port's own embed
    longest = max(len(t) for t in texts)
    ids = np.full((len(texts), longest), pad, np.int64)
    mask = np.zeros((len(texts), longest), np.int32)
    for i, t in enumerate(texts):
        ids[i, : len(t)], mask[i, : len(t)] = t, 1
    alone = penc.embed(model, {"input_ids": torch.from_numpy(ids),
                               "attention_mask": torch.from_numpy(mask)})
    scattered = pmp.scatter_packed_reps(reps, torch.from_numpy(packed.text_index), len(texts))
    np.testing.assert_allclose(scattered.numpy(), alone.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the packed loss and gradients


def _train_model(pcfg, state, checkpointing=False):
    return llama.LlamaEncoder.for_training(pcfg, state, device="cpu",
                                           compute_dtype=torch.float32,
                                           gradient_checkpointing=checkpointing)


def _device_batch(collated):
    out = {}
    for key, value in collated.items():
        if isinstance(value, dict):
            out[key] = _device_batch(value)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
            out[key] = t.long() if key == "input_ids" else t
    return out


def _loss_and_grads(model, loss_fn, batch):
    for p in model.parameters():
        p.grad = None
    loss, metrics = loss_fn(model, _device_batch(batch))
    loss.backward()
    return loss.item(), metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_packed_loss_and_grads_match_unpacked_and_jax(stage):
    jcfg, params, pcfg, state = _body_setup("llama", seed=3)
    rng = np.random.default_rng(8)
    kw = dict(pad_token_id=0, max_query_length=16, max_passage_length=24)
    seg_kw = dict(query_max_segments=4, passage_max_segments=4)
    if stage == "contrastive":
        rows = _contrastive_rows(rng, 4, vocab=256, n_neg=3)
        plain = ContrastiveCollator(num_negatives=2, seed=1, **kw)(rows)
        packed = ppack.PackedContrastiveCollator(num_negatives=2, seed=1, **kw,
                                                 **seg_kw)(rows)
        jpacked = jpack.PackedContrastiveCollator(num_negatives=2, seed=1, **kw,
                                                  **seg_kw)(rows)
        loss_fn = psteps.make_contrastive_loss_fn(pcfg, temperature=0.05)
        jloss_fn = jsteps.make_contrastive_loss_fn(jcfg, temperature=0.05,
                                                   compute_dtype=jnp.float32)
    else:
        rows = _pair_rows(rng, 4, vocab=256)
        plain = RankPOCollator(**kw)(rows)
        packed = ppack.PackedRankPOCollator(**kw, **seg_kw)(rows)
        jpacked = jpack.PackedRankPOCollator(**kw, **seg_kw)(rows)
        loss_fn = psteps.make_rankpo_loss_fn(pcfg, beta=2.0, temperature=0.1)
        jloss_fn = jsteps.make_rankpo_loss_fn(jcfg, beta=2.0, temperature=0.1,
                                              compute_dtype=jnp.float32)
    _tree_equal(packed, jpacked)
    assert packed["passage"]["input_ids"].shape[0] < plain["passage"]["input_ids"].shape[0]
    model = _train_model(pcfg, state, checkpointing=True)
    l0, m0, g0 = _loss_and_grads(model, loss_fn, plain)
    l1, m1, g1 = _loss_and_grads(model, loss_fn, packed)
    assert l1 == pytest.approx(l0, abs=1e-5)
    for key in m0:
        assert float(m1[key]) == pytest.approx(float(m0[key]), abs=1e-5), key
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)
    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, jpacked), None)
    assert l1 == pytest.approx(float(jl), abs=1e-5)
    ref = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pcfg)
    for name, g in g1.items():
        rel = ((g - ref[name]).norm() / ref[name].norm().clamp_min(1e-12)).item()
        assert rel <= 1e-4, (name, rel)


# ---------------------------------------------------------------------------
# the CLIs

WORDS = [f"w{i}" for i in range(80)]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("packing_cli")
    cfg = tiny_llama_config(vocab_size=256)
    hf_io.save_pretrained(str(d / "base"), cfg,
                          llama.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))

    with open(d / "train.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"query": text(2, 8), "positives": [text(5, 20)],
                                "negatives": [text(3, 30) for _ in range(4)]}) + "\n")
    with open(d / "pairs.jsonl", "w") as f:
        for i in range(16):
            f.write(json.dumps({"query": text(2, 8), "passage1": text(5, 20),
                                "passage2": text(5, 20), "preferred": "AB"[i % 2],
                                "confidence_score": 0.9}) + "\n")
    return d


def test_training_clis_with_pack_sequences(workdir):
    """Stage 1 then stage 2 with --pack_sequences True on the CPU: finite
    losses and the first step's loss equal to the unpacked run's on the
    same sampled examples (bf16 compute: 2e-3)."""
    d = workdir
    common = ["--tokenizer_name", "hash:256", "--per_device_train_batch_size", "4",
              "--max_query_length", "16", "--max_passage_length", "32",
              "--learning_rate", "1e-3", "--max_steps", "2", "--bf16", "True",
              "--save_strategy", "no", "--device", "cpu", "--pack_max_segments", "8"]
    s1 = ["--model_name_or_path", str(d / "base"), "--train_data", str(d / "train.jsonl"),
          "--num_negatives", "3", "--temperature", "0.05", "--gradient_accumulation_steps",
          "2", "--gradient_checkpointing", "True", *common]
    hist = {}
    for pack in ("True", "False"):
        hist[pack] = run_contrastive.main([*s1, "--output_dir", str(d / f"s1_{pack}"),
                                           "--pack_sequences", pack])
    assert [h["global_step"] for h in hist["True"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist["True"])
    assert hist["True"][0]["loss"] == pytest.approx(hist["False"][0]["loss"], abs=2e-3)
    s2 = ["--model_name_or_path", str(d / "s1_True"), "--train_data", str(d / "pairs.jsonl"),
          "--beta", "2.0", "--temperature", "0.1", *common]
    hist2 = {pack: run_rankpo.main([*s2, "--output_dir", str(d / f"s2_{pack}"),
                                    "--pack_sequences", pack]) for pack in ("True", "False")}
    assert all(np.isfinite(h["loss"]) for h in hist2["True"])
    assert hist2["True"][0]["loss"] == pytest.approx(hist2["False"][0]["loss"], abs=2e-3)
    _, state = hf_io.load_pretrained(str(d / "s2_True"))
    assert all(torch.isfinite(t).all() for t in state.values())


VOCAB = 256
QUERIES = ["w1 w2 w3", "w4", "w5 w6 w7 w8 w9 w10 w11", "w12 w13", "w14 w15 w16 w17",
           "w18 w19 w20", "", "w21 w22 w23 w24 w25 w26 w27 w28 w29 w30 w31"]


@pytest.fixture(scope="module")
def serve_checkpoint(tmp_path_factory):
    cfg = jax_tiny_llama(vocab_size=VOCAB)
    params = jenc.init_params(jax.random.key(7), cfg)
    path = tmp_path_factory.mktemp("pack_ckpt")
    jhf.save_pretrained(str(path), cfg, params)
    rng = np.random.default_rng(0)
    corpus = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 40)))) for _ in range(40)]
    (path / "corpus.jsonl").write_text("".join(json.dumps({"text": t}) + "\n"
                                               for t in corpus))
    return str(path), cfg, params, corpus


def _hits(results):
    return [[(h["index"], h["score"]) for h in r["hits"]] for r in results]


def test_service_pack_queries_matches_unpacked_and_jax(serve_checkpoint):
    """RetrievalService with pack_queries (query_batch_size 3, so several
    groups, 4 queries at most a row) against itself unpacked and against
    the JAX service with pack_queries: equal indices, scores within 1e-5."""
    path, cfg, params, corpus = serve_checkpoint
    port = {}
    for pack in (False, True):
        svc = RetrievalService(
            InferenceEncoder.from_pretrained(path, tokenizer=HashTokenizer(VOCAB),
                                             device="cpu", compute_dtype=torch.float32),
            max_query_length=16, query_batch_size=3, pack_queries=pack, pack_max_segments=4)
        svc.build_index(corpus, max_passage_length=48, batch_size=16)
        port[pack] = svc.query(QUERIES, k=5)
    jsvc = JaxService(JaxEncoder(cfg, params, JaxHashTokenizer(VOCAB), mesh=None,
                                 compute_dtype=jnp.float32),
                      mesh=None, max_query_length=16, query_batch_size=3, pack_queries=True,
                      pack_max_segments=4)
    jsvc.build_index(corpus, max_passage_length=48, batch_size=16)
    jres = jsvc.query(QUERIES, k=5)
    for other in (port[False], jres):
        for got, want in zip(_hits(port[True]), _hits(other)):
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)


def test_serve_cli_pack_queries(serve_checkpoint):
    """``cli.serve --pack_queries --device cpu`` answers /search with the
    hits of the unpacked server."""
    path, _, _, _ = serve_checkpoint
    answers = {}
    for flags in ([], ["--pack_queries", "--pack_max_segments", "4"]):
        server = serve_cli.make_server([
            "--model_name_or_path", path, "--tokenizer_name", f"hash:{VOCAB}",
            "--corpus_data", f"{path}/corpus.jsonl", "--port", "0", "--device", "cpu",
            "--max_query_length", "16", "--microbatch_wait_ms", "0", *flags])
        assert server.service.pack_queries == bool(flags)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/search",
                data=json.dumps({"queries": QUERIES, "k": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[bool(flags)] = json.loads(resp.read())["results"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    for got, want in zip(_hits(answers[True]), _hits(answers[False])):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)


def _packed_encoders():
    jcfg = jax_tiny_llama(vocab_size=256)
    params = jenc.init_params(jax.random.key(0), jcfg)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    state = hf_io.params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    jax_e = JaxEncoder(jcfg, params, JaxHashTokenizer(vocab_size=256), mesh=None,
                       compute_dtype=jnp.float32, length_multiple=8)
    port_e = InferenceEncoder(pcfg, state, HashTokenizer(vocab_size=256), device="cpu",
                              compute_dtype=torch.float32, length_multiple=8)
    return jax_e, port_e


ENCODE_PACKED_ATOL = 2e-4


@pytest.mark.parametrize("case", ["rows", "chunks"])
def test_encode_packed_matches_encode_and_jax(case):
    jax_e, port_e = _packed_encoders()
    if case == "rows":  # 37 texts, batches of 512 tokens: several rows a batch
        rng = np.random.RandomState(0)
        texts = ["word " * int(n) + f"tail{i}" for i, n in enumerate(rng.randint(1, 40, 37))]
        kw = dict(max_length=48, tokens_per_batch=512)
    else:  # chunks of 10 texts, one row a batch
        texts = [f"text {i} " + "pad " * (i % 7) for i in range(23)]
        kw = dict(max_length=32, tokens_per_batch=256, pack_chunk=10)
    got = port_e.encode_packed(texts, **kw)
    assert got.dtype == np.float32 and got.shape == (len(texts), 64)
    base = port_e.encode(texts, batch_size=8, max_length=kw["max_length"])
    np.testing.assert_allclose(got, base, atol=ENCODE_PACKED_ATOL)
    np.testing.assert_allclose(got, jax_e.encode_packed(texts, **kw), atol=ENCODE_PACKED_ATOL)


def test_encode_packed_empty_and_validation():
    jax_e, port_e = _packed_encoders()
    assert port_e.encode_packed([], max_length=16).shape == (0, 64)
    assert jax_e.encode_packed([], max_length=16).shape == (0, 64)
    for enc in (port_e, jax_e):
        with pytest.raises(ValueError, match="list of texts"):
            enc.encode_packed("just one string", max_length=16)
    with pytest.raises(ValueError, match="pack_length"):
        port_e.encode_packed(["a " * 40], max_length=64, pack_length=16)
