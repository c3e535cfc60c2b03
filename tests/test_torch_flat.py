"""The flat tier completed: ``FlatIPIndex`` over fp32, bf16 and int8 rows and
``ops/topk.py``'s ``matmul_topk`` against the JAX package's on the same
numpy inputs (after tests/test_index.py, tests/test_index_selector.py and
tests/test_index_mutation.py).

Tolerances: int8 codes and scales bit-equal (both quantize paths); stored
rows after append / remove / reconstruct bit-equal; hits equal wherever
neighbouring scores differ by more than 1e-5 and scores within 1e-5 (fp32
sums of the same exact products in two orders, at D 64 over unit rows);
the approximate mode's recall@10 against the exact fp32 search at or above
its target (not equal hits: ``torch.topk`` over bf16 scores is not
``lax.approx_max_k``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.index.flat import FlatIPIndex as JaxFlat
from rankpo_tpu.ops import topk as jtopk
from rankpo_tpu_torch.index.flat import FlatIPIndex, numpy_search, quantize_rows_int8
from rankpo_tpu_torch.index import ivf as pivf
from rankpo_tpu_torch.ops import topk as ptopk

torch.set_num_threads(2)

TOL = 1e-5
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


def _data(n=301, n_q=9, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + n_q, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[7] = 0.0  # a zero row: scale 1e-12, zero codes
    return x[:n], x[n:]


def _same_hits(got, ref, tol=TOL):
    """Scores within ``tol``; indices equal where neighbouring reference
    scores differ by more than ``tol`` (the reference may hold one rank
    more, so a near-tie across the k boundary is seen)."""
    (s1, i1), (s2, i2) = got, ref
    k = s1.shape[1]
    np.testing.assert_allclose(s1, s2[:, :k], atol=tol, rtol=0)
    gaps = np.abs(np.diff(s2, axis=1)) > tol
    clear = np.ones(i2.shape, dtype=bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    clear = clear[:, :k] & np.isfinite(s2[:, :k])
    np.testing.assert_array_equal(i1[clear], i2[:, :k][clear])


def _pair(dtype, x, **kw):
    p_dt, j_dt = DTYPES[dtype]
    return FlatIPIndex(x, dtype=p_dt, **kw), JaxFlat(x, dtype=j_dt, **kw)


@pytest.mark.parametrize("path", ["constructor", "device"])
def test_int8_codec_bit_equal(path):
    """Codes and scales bit-equal to the JAX host constructor (``max /
    127``) and to its device path (XLA's ``max * (1/127)``): the flat
    constructor / ``from_sharded``; one codec shared with the IVF tier."""
    x, _ = _data()
    if path == "constructor":
        p, j = FlatIPIndex(x, dtype=torch.int8), JaxFlat(x, dtype=jnp.int8)
    else:
        p = FlatIPIndex.from_sharded(torch.from_numpy(x), len(x), dtype=torch.int8)
        j = JaxFlat.from_sharded(jnp.asarray(x), len(x), dtype=jnp.int8)
    n = len(x)
    np.testing.assert_array_equal(p.corpus[:n].numpy(), np.asarray(j.corpus)[:n])
    np.testing.assert_array_equal(p.row_scale[:n].numpy(), np.asarray(j.row_scale)[:n])
    assert p.row_scale[7] == np.float32(1e-12) and not p.corpus[7].any()
    assert pivf.quantize_rows_int8 is quantize_rows_int8  # the IVF tier's too


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 10, 301])
def test_search_matches_jax(dtype, k):
    x, q = _data()
    p, j = _pair(dtype, x)
    got = p.search(q, k=k, batch_size=4)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert got[0].shape == (len(q), min(k, len(x)))
    _same_hits(got, j.search(q, k=min(k + 1, len(x))))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["allowed", "disallowed", "selector", "few"])
def test_filtered_search_matches_jax(dtype, form):
    """The three filter forms (FAISS IDSelector); with fewer eligible rows
    than k the tail is -inf / -1."""
    x, q = _data()
    p, j = _pair(dtype, x)
    rng = np.random.default_rng(3)
    ids = np.sort(rng.choice(len(x), 120, replace=False))
    kw = {"allowed": {"allowed_ids": ids}, "disallowed": {"disallowed_ids": ids},
          "few": {"allowed_ids": ids[:4]}}.get(form)
    if kw is None:
        mask = np.zeros(len(x), bool)
        mask[ids] = True
        kw = {"selector": mask}
    got = p.search(q, k=10, **kw)
    ref = j.search(q, k=11, **kw)
    _same_hits(got, ref)
    np.testing.assert_array_equal(got[1] < 0, ~np.isfinite(got[0]))
    if form == "few":
        assert (got[1][:, 4:] == -1).all() and np.isneginf(got[0][:, 4:]).all()
        assert (np.sort(got[1][:, :4], axis=1) == ids[:4]).all()
    with pytest.raises(ValueError, match="at most one"):
        p.search(q, k=3, allowed_ids=ids, disallowed_ids=ids)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_append_remove_reconstruct_match_jax(dtype):
    """append (into pad rows and grown with headroom), remove (FAISS
    renumbering) and reconstruct: stored rows bit-equal to the JAX index's
    at every step, hits as its search. int8 rows appended take the device
    path's rounding, and survivors of a removal keep their codes."""
    x, q = _data()
    p, j = _pair(dtype, x[:200])
    p = FlatIPIndex.from_sharded(torch.from_numpy(x[:200]), 200, dtype=DTYPES[dtype][0])
    j = JaxFlat.from_sharded(jnp.asarray(x[:200]), 200, dtype=DTYPES[dtype][1])
    steps = [("append", x[200:250], 0.5), ("append", x[250:260], 0.0),
             ("remove", [0, 7, 100, 255]), ("append", x[260:301], 0.25),
             ("remove", np.arange(0, 290, 3))]
    for step in steps:
        if step[0] == "append":
            rows, headroom = step[1], step[2]
            p = p.append_sharded(torch.from_numpy(rows), len(rows), headroom=headroom)
            j = j.append_sharded(jnp.asarray(rows), len(rows), headroom=headroom)
        else:
            p, j = p.remove_rows(step[1]), j.remove_rows(step[1])
        assert p.ntotal == j.ntotal
        ids = np.arange(p.ntotal)
        np.testing.assert_array_equal(p.reconstruct(ids), j.reconstruct(ids))
        _same_hits(p.search(q, k=10), j.search(q, k=11))
    assert p.reconstruct(np.zeros(0, np.int64)).shape == (0, 64)
    with pytest.raises(IndexError):
        p.reconstruct([p.ntotal])
    with pytest.raises(IndexError):
        p.remove_rows([-1])
    with pytest.raises(ValueError, match="every row"):
        p.remove_rows(np.arange(p.ntotal))


def test_append_in_place_keeps_earlier_snapshots():
    """An append that fits pad rows writes them in place only when no other
    index on the storage wrote them: a second append to an older snapshot
    copies, and each snapshot keeps its own rows."""
    x, q = _data()
    base = FlatIPIndex(x[:100], dtype=torch.bfloat16).append_sharded(
        torch.from_numpy(x[100:110]), 10, headroom=1.0)
    a = base.append_sharded(torch.from_numpy(x[110:120]), 10)
    b = base.append_sharded(torch.from_numpy(x[200:210]), 10)
    assert a.corpus is base.corpus and b.corpus is not base.corpus
    bf = lambda r: torch.from_numpy(r).bfloat16().float().numpy()
    np.testing.assert_array_equal(a.reconstruct(np.arange(110, 120)), bf(x[110:120]))
    np.testing.assert_array_equal(b.reconstruct(np.arange(110, 120)), bf(x[200:210]))
    assert base.search(q, k=base.ntotal)[1].max() == 109
    # fp32 rows are the caller's memory: never written
    f = FlatIPIndex(np.concatenate([x[:50], np.zeros((8, 64), np.float32)]), n_total=50)
    g = f.append_sharded(torch.from_numpy(x[50:52]), 2)
    assert g.corpus is not f.corpus and not f.corpus[50:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_range_search_matches_jax(dtype):
    """CSR (lims, scores, ids) of the rows above a radius: lims and ids as
    the JAX index's, scores within 1e-5 (including its completeness rerun:
    a radius low enough that the count pass's k must double)."""
    x, q = _data()
    p, j = _pair(dtype, x)
    for radius in (0.4, 0.1, 2.0):
        got, ref = p.range_search(q, radius, batch_size=4), j.range_search(q, radius)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[1], ref[1], atol=TOL, rtol=0)
        assert (got[1] > radius).all()
    lims, scores, ids = p.range_search(np.zeros((0, 64), np.float32), 1.0)
    assert lims.tolist() == [0] and scores.size == ids.size == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("target", [0.9, 0.95])
def test_approximate_mode_recall(dtype, target):
    """recall_target < 1: recall@10 against the exact fp32 search at or
    above the target, as the JAX index's is; the scores are those of the
    rows returned, within the bf16 scores' rounding."""
    x, q = _data(n=2000, n_q=64, seed=5)
    exact = numpy_search(x, q, 10)[1]
    p, j = _pair(dtype, x, recall_target=target)
    s, i = p.search(q, k=10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, exact)])
    j_recall = np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(j.search(q, k=10)[1], exact)])
    assert recall >= target and j_recall >= target
    true = np.einsum("qd,qkd->qk", q, p.reconstruct(i.reshape(-1)).reshape(64, 10, 64))
    np.testing.assert_allclose(s, true, rtol=2 ** -7, atol=0.01)


def _tied(n=80, d=16, seed=1):
    rng = np.random.default_rng(seed)
    corpus = (rng.integers(-8, 9, (n, d)) / 16.0).astype(np.float32)
    # a tie group across the chunk boundary at 32 and 64
    for j in (31, 32, 33, 63, 64, 70):
        corpus[j] = corpus[5]
    queries = (rng.integers(-8, 9, (5, d)) / 16.0).astype(np.float32)
    queries[0] = corpus[5]
    return torch.from_numpy(corpus), torch.from_numpy(queries)


@pytest.mark.parametrize("k", [3, 7, 80])
def test_chunked_matmul_topk_equals_dense(k):
    """Column chunks of 32 rows merged (previous best, chunk): bit-equal to
    the dense pass and to numpy_search, with exact ties on both sides of
    the chunk boundaries (dyadic data: every sum exact), padding rows and a
    row mask."""
    corpus, queries = _tied()
    dense = ptopk.dense_matmul_topk(queries, corpus, k=k)
    chunked = ptopk.matmul_topk(queries, corpus, k=k, block_size=32, score_budget=1)
    for a, b in zip(dense, chunked):
        assert torch.equal(a, b)
    ref = numpy_search(corpus.numpy(), queries.numpy(), k)
    np.testing.assert_array_equal(chunked[0].numpy(), ref[0])
    np.testing.assert_array_equal(chunked[1].numpy(), ref[1])
    mask = torch.ones(80, dtype=torch.bool)
    mask[[5, 32]] = False
    kw = dict(k=k, n_valid=75, row_mask=mask)
    dense_s, dense_i = ptopk.dense_matmul_topk(queries, corpus, index_offset=1000, **kw)
    chunk_s, chunk_i = ptopk.matmul_topk(queries, corpus, block_size=32, score_budget=1, **kw)
    assert torch.equal(dense_s, chunk_s)
    assert torch.equal(dense_i, chunk_i + 1000)
    j = jtopk.matmul_topk(jnp.asarray(queries.numpy()), jnp.asarray(corpus.numpy()),
                          k=min(k, 73), n_valid=75, row_mask=jnp.asarray(mask.numpy()),
                          block_size=32, score_budget=1, precision="float32")
    got = ptopk.matmul_topk(queries, corpus, k=min(k, 73), n_valid=75, row_mask=mask,
                            block_size=32, score_budget=1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(j[1]))


def test_cast_budget_chunks_dequant():
    """The int8 dequant and the fp32 -> bf16 rounding run chunk by chunk
    under CAST_BUDGET; the chunked result equals the dense one."""
    x, q = _data(n=600)
    codes, scale = quantize_rows_int8(torch.from_numpy(x))
    qb = torch.from_numpy(q).bfloat16()
    dense = ptopk.dense_matmul_topk(qb, codes, k=20, col_scale=scale, int8_mm=False)
    old = ptopk.CAST_BUDGET
    try:
        ptopk.CAST_BUDGET = 64 * 4 * 100  # 100 rows a chunk, rounded to 96
        chunked = ptopk.matmul_topk(qb, codes, k=20, col_scale=scale, int8_mm=False,
                                    block_size=8)
    finally:
        ptopk.CAST_BUDGET = old
    for a, b in zip(dense, chunked):
        assert torch.equal(a, b)


def test_int8_product_matches_jax():
    """The int8 x int8 -> int32 product (the default on the card): queries
    quantized as JAX quantizes them, the same integer sums, col_scale before
    selection and the query scale after; equal to JAX's int8_mxu path."""
    x, q = _data()
    codes, scale = quantize_rows_int8(torch.from_numpy(x))
    qb = torch.from_numpy(q).bfloat16()
    q8, qs = ptopk.quantize_queries_int8(qb)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jqf = jq.astype(jnp.float32)
    j_qs = jnp.maximum(jnp.max(jnp.abs(jqf), axis=1), 1e-12) / 127.0
    np.testing.assert_array_equal(qs.numpy(), np.asarray(j_qs))
    got = ptopk.dense_matmul_topk(qb, codes, k=10, col_scale=scale, int8_mm=True)
    ref = jtopk.dense_matmul_topk(jq, jnp.asarray(codes.numpy()), k=11,
                                  col_scale=jnp.asarray(scale.numpy()), int8_mxu=True)
    _same_hits(tuple(t.numpy() for t in got), tuple(np.asarray(t) for t in ref))
    exact = ptopk.int8_product(q8, codes)
    assert torch.equal(exact, (q8.long() @ codes.long().T).int())
    assert not ptopk.int8_product_available(codes)  # the CPU keeps dequant
