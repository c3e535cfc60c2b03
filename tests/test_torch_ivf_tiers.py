"""The port's IVF options and index operations against the JAX package's, on
numpy inputs from a seed, on the CPU: ``kmeans_split``, ``balance_eta``, the
PCA hybrid (``reduced_dim``), filtered search, ``append_sharded`` /
``remove_rows`` / ``reconstruct``, ``from_chunk_fn`` and index files of
these in both directions.

Tolerances:

- Lloyd centroids and the balance bias within 1e-6: both sum the same
  bf16-rounded rows in fp32, in another order.
- Whole builds: ``row_ids``, capacity and the tuned nprobe equal; bf16 rows
  and int8 codes bit-equal; PQ codes of appended rows agree on >= 99% (one
  flipped argmin in another summation order moves a code).
- The hybrid's PCA basis equal up to each column's sign within 1e-4 (the
  eigenvectors of two fp32 second moments summed in another order; these
  data's eigenvalue gaps keep the columns apart).
- Search hits equal wherever neighbouring reference scores differ by more
  than 1e-5, scores within 1e-5 (``test_torch_ivf._assert_same_hits``).
- ``reconstruct`` bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.index import io as jio
from rankpo_tpu.index import ivf as jivf
from rankpo_tpu.index.flat import (
    build_selector_mask as j_build_selector_mask,
    mask_filtered_misses as j_mask_filtered_misses,
    numpy_search,
)
from rankpo_tpu_torch.index import flat as pflat
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index import ivf as pivf
from rankpo_tpu_torch.ops import ivf_gather

from test_torch_ivf import TOL, _assert_same_hits, _blobs, _corpus_queries, _storage_bits

torch.set_num_threads(2)

CENT_TOL = 1e-6
PROJ_TOL = 1e-4
COMMON = dict(recall_target=0.9, kmeans_iters=5, pq_iters=8, tune_sample=64, tune_k=10)


def _jkw(kw):
    return {k: getattr(jnp, v) if k == "store_dtype" else v for k, v in kw.items()}


def _skewed(n=2400, d=48, seed=11):
    """Rows around 12 centres with Zipf-like sizes: the largest blobs
    overflow a uniform capacity, so splits and the bias have work to do."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(12, d).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    weights = 1.0 / np.arange(1, 13) ** 1.2
    assign = rng.choice(12, size=n, p=weights / weights.sum())
    x = centres[assign] + 0.25 * rng.randn(n, d).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _jax_lloyd(corpus, init, chunk, **kw):
    padded = jivf._pad_to_chunks(jnp.asarray(corpus), chunk)
    fit = jax.jit(lambda c, i: jivf._lloyd_body(c, i, corpus.shape[0], chunk=chunk,
                                                axis_name=None, **kw))
    cents, bias = fit(padded, jnp.asarray(init))
    return np.asarray(cents), np.asarray(bias)


# ----------------------------------------------------------------------
# k-means options
LLOYD_CASES = {
    "split": dict(split_r=3),
    "balance": dict(balance_eta=0.1),
    "split_and_balance": dict(split_r=2, balance_eta=0.05),
}


@pytest.mark.parametrize("case", list(LLOYD_CASES))
def test_lloyd_options_match_jax(case):
    corpus = _skewed()
    k, chunk = 16, 256
    init = corpus[np.random.default_rng(0).choice(len(corpus), k, replace=False)]
    kw = LLOYD_CASES[case]
    j_cents, j_bias = _jax_lloyd(corpus, init, chunk, n_iters=6, spherical=True, **kw)
    p_cents, p_bias = pivf._lloyd_body(torch.from_numpy(corpus), torch.from_numpy(init),
                                       n_iters=6, chunk=chunk, spherical=True, **kw)
    np.testing.assert_allclose(p_cents.numpy(), j_cents, atol=CENT_TOL, rtol=0)
    np.testing.assert_allclose(p_bias.numpy(), j_bias, atol=CENT_TOL, rtol=0)
    plain, _ = pivf._lloyd_body(torch.from_numpy(corpus), torch.from_numpy(init),
                                n_iters=6, chunk=chunk, spherical=True)
    assert not torch.equal(plain, p_cents)  # the option did something
    if "balance_eta" in kw:
        assert p_bias.abs().max() > 0
    else:
        assert not p_bias.any()


def test_split_with_tied_counts_matches_jax():
    """Three equal blobs of 100 rows and five centroids that attract none:
    the fullest (100, 100, 100) and the emptiest (0 x 5) are tied, so the
    stable sorts pick clusters 0, 1 to split and 3, 4 to give up."""
    rng = np.random.RandomState(2)
    d = 32
    centres = rng.randn(3, d).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    corpus = np.repeat(centres, 100, axis=0) + 0.05 * rng.randn(300, d).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    far = rng.randn(5, d).astype(np.float32)
    init = np.concatenate([centres, far / np.linalg.norm(far, axis=1, keepdims=True)])
    init = init.astype(np.float32)
    j_cents, _ = _jax_lloyd(corpus, init, 100, n_iters=2, spherical=True, split_r=2)
    p_cents, _ = pivf._lloyd_body(torch.from_numpy(corpus), torch.from_numpy(init),
                                  n_iters=2, chunk=100, spherical=True, split_r=2)
    np.testing.assert_allclose(p_cents.numpy(), j_cents, atol=CENT_TOL, rtol=0)
    # the donors 3 and 4 moved next to blobs 0 and 1; 2, 5, 6, 7 did not split
    moved = np.sum(p_cents.numpy() * init, axis=1) < 0.9  # cosine to the start
    np.testing.assert_array_equal(moved, [0, 0, 0, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(np.argmax(p_cents.numpy()[[3, 4]] @ centres.T, axis=1),
                                  [0, 1])


@pytest.mark.parametrize("kw", [{"kmeans_split": 4}, {"balance_eta": 0.1},
                                {"kmeans_split": 2, "balance_eta": 0.05,
                                 "store_dtype": "int8"}],
                         ids=["split", "balance", "split_balance_int8"])
def test_split_and_balanced_builds_match_jax(kw):
    corpus = _skewed()
    j = jivf.IVFIPIndex(corpus, n_clusters=24, **COMMON, **_jkw(kw))
    p = pivf.IVFIPIndex(corpus, n_clusters=24, **COMMON, **kw)
    assert (p.capacity, p.nprobe) == (j.capacity, j.nprobe)
    np.testing.assert_array_equal(p.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(j.centroids), atol=CENT_TOL)
    np.testing.assert_array_equal(_storage_bits(p.corpus), _storage_bits(j.corpus))
    if "balance_eta" in kw:
        np.testing.assert_allclose(p._assign_bias_host, j._assign_bias_host, atol=CENT_TOL)
    else:
        assert p.assign_bias is None and j._assign_bias_host is None
    queries = corpus[::97]
    _assert_same_hits(*p.search(queries, k=10), *j.search(queries, k=10))


def test_kmeans_split_bound():
    corpus = _skewed(n=300)
    with pytest.raises(ValueError, match="n_clusters // 2"):
        pivf.IVFIPIndex(corpus, n_clusters=8, kmeans_split=5)
    with pytest.raises(ValueError, match="kmeans_split"):
        pivf.IVFIPIndex(corpus, n_clusters=8, kmeans_split=-1)
    with pytest.raises(ValueError, match="n_clusters // 2"):
        pivf.IVFIPIndex.from_chunk_fn(lambda lo, hi: corpus[lo:hi], 300, 48,
                                      n_clusters=8, kmeans_split=5, device="cpu")
    index = pivf.IVFIPIndex(corpus, n_clusters=8, nprobe=2, kmeans_split=4)
    assert index.kmeans_split == 4


# ----------------------------------------------------------------------
# the PCA hybrid
def test_hybrid_build_matches_jax():
    corpus, queries = _corpus_queries()
    kw = dict(n_clusters=16, reduced_dim=16, **COMMON)
    j = jivf.IVFIPIndex(corpus, **kw)
    p = pivf.IVFIPIndex(corpus, **kw)
    np.testing.assert_array_equal(p.row_ids.numpy(), np.asarray(j.row_ids))
    j_proj, p_proj = np.asarray(j.proj), p.proj.numpy()
    sign = np.sign(np.sum(j_proj * p_proj, axis=0))
    np.testing.assert_allclose(p_proj * sign, j_proj, atol=PROJ_TOL, rtol=0)
    assert (p.nprobe, p.candidates) == (j.nprobe, j.candidates)
    # at full probe and a pool of 256, both rerank every true top-10 row
    ref = j.search(queries, k=10, nprobe=16, candidates=256)
    got = p.search(queries, k=10, nprobe=16, candidates=256)
    _assert_same_hits(*got, *ref)


HYBRID_VARIANTS = {"bf16": {}, "fp32": {"store_dtype": jnp.float32},
                   "int8": {"store_dtype": jnp.int8}}


@pytest.fixture(scope="module")
def hybrids():
    """One JAX hybrid build per storage, carried into the port."""
    corpus, queries = _corpus_queries()
    out = {}
    for name, kw in HYBRID_VARIANTS.items():
        j = jivf.IVFIPIndex(corpus, n_clusters=16, nprobe=4, reduced_dim=16,
                            candidates=64, kmeans_iters=5, **kw)
        out[name] = (j, pio.index_from_state(jio.index_state(j), device="cpu"))
    return corpus, queries, out


@pytest.mark.parametrize("name", list(HYBRID_VARIANTS))
def test_hybrid_search_through_carried_index_matches_jax(hybrids, name):
    _, queries, indexes = hybrids
    j, p = indexes[name]
    assert p.reduced_dim == 16 and p.candidates == 64
    for kw in ({}, {"candidates": 200}, {"nprobe": 16, "candidates": 300}):
        _assert_same_hits(*p.search(queries, k=20, **kw), *j.search(queries, k=20, **kw))
    assert ivf_gather.launches["ivf_probe_scores"] == 0  # the hybrid has no kernel


def test_hybrid_tuner_grows_candidates_like_jax(monkeypatch):
    """A tiny pool and a high target: the verify loop doubles the pool when a
    probe bump does not raise recall, in both packages alike."""
    corpus, _ = _corpus_queries(n=1500, d=32, seed=5)
    kw = dict(n_clusters=24, reduced_dim=4, candidates=12, recall_target=0.99,
              kmeans_iters=4, tune_sample=32, tune_k=10)
    j = jivf.IVFIPIndex(corpus, **kw)
    p = pivf.IVFIPIndex(corpus, **kw)
    assert (p.nprobe, p.candidates) == (j.nprobe, j.candidates)
    assert p.candidates != 12


def test_gather_pricing_of_the_hybrid():
    corpus, _ = _corpus_queries(n=600, d=64, seed=6)
    p = pivf.IVFIPIndex(corpus, n_clusters=8, nprobe=2, reduced_dim=8)
    flat = pivf.IVFIPIndex(corpus, n_clusters=8, nprobe=2)
    n = 2 * p.capacity
    assert p._gather_bytes_per_query(2, 100) == n * 24 + n * 8 * 6 + 100 * 64 * 6
    assert p._gather_bytes_per_query(2, 100) < flat._gather_bytes_per_query(2)


# ----------------------------------------------------------------------
# filtered search
FILTER_VARIANTS = {
    "bf16": ({}, 4),
    "fp32": ({"store_dtype": jnp.float32}, 4),
    "int8": ({"store_dtype": jnp.int8}, 4),
    "pq_rows": ({"pq_m": 8}, 8),
    "pq_cols": ({"pq_m": 32, "pq_layout": "cols"}, 4),
    "hybrid": ({"reduced_dim": 16, "candidates": 64}, 4),
}


@pytest.fixture(scope="module")
def filtered():
    corpus, queries = _corpus_queries()
    out = {}
    for name, (kw, nprobe) in FILTER_VARIANTS.items():
        j = jivf.IVFIPIndex(corpus, n_clusters=16, nprobe=nprobe, kmeans_iters=5,
                            pq_iters=8, **kw)
        out[name] = (j, pio.index_from_state(jio.index_state(j), device="cpu"))
    return corpus, queries, out


def _filters(n):
    rng = np.random.default_rng(4)
    allowed = np.sort(rng.choice(n, size=n // 3, replace=False))
    sel = np.zeros(n, bool)
    sel[rng.choice(n, size=n // 2, replace=False)] = True
    return {"allowed": {"allowed_ids": allowed},
            "disallowed": {"disallowed_ids": allowed},
            "selector": {"selector": sel},
            "tiny": {"allowed_ids": [5, 17, 2900]}}


@pytest.mark.parametrize("name", list(FILTER_VARIANTS))
@pytest.mark.parametrize("flt", ["allowed", "disallowed", "selector", "tiny"])
def test_filtered_search_matches_jax(filtered, name, flt):
    corpus, queries, indexes = filtered
    j, p = indexes[name]
    kw = _filters(len(corpus))[flt]
    ref_s, ref_i = j.search(queries, k=20, **kw)
    got_s, got_i = p.search(queries, k=20, **kw)
    mask = j_build_selector_mask(len(corpus), **kw)
    assert mask[got_i[got_i >= 0]].all()
    np.testing.assert_array_equal(got_i < 0, ref_i < 0)  # the -1 tail
    if flt == "tiny":  # three rows allowed, far apart: hits equal outright
        assert (got_i[:, 3:] == -1).all() and np.isneginf(got_s[:, 3:]).all()
        np.testing.assert_array_equal(got_i, ref_i)
        np.testing.assert_allclose(got_s, ref_s, atol=TOL, rtol=0)
        return
    fin = np.isfinite(ref_s)
    _assert_same_hits(np.where(fin, got_s, 0), np.where(fin, got_i, 0),
                      np.where(fin, ref_s, 0), np.where(fin, ref_i, 0))


@pytest.mark.parametrize("name", ["bf16", "fp32", "int8"])
def test_filtered_full_probe_equals_flat_oracle(filtered, name):
    """At full probe a filtered IVF search is the exact search over the
    allowed stored rows."""
    corpus, queries, indexes = filtered
    _, p = indexes[name]
    allowed = _filters(len(corpus))["allowed"]["allowed_ids"]
    stored = p.reconstruct(np.arange(len(corpus)))
    qv = queries if name == "fp32" else torch.from_numpy(queries).bfloat16().float().numpy()
    o_s, o_i = numpy_search(stored[allowed], qv, 10)
    got_s, got_i = p.search(queries, k=10, nprobe=16, allowed_ids=allowed)
    _assert_same_hits(got_s, got_i, o_s, allowed[o_i].astype(np.int32))


@pytest.mark.parametrize("name", ["bf16", "int8", "pq_rows"])
def test_filtered_exact_search_equals_flat_oracle(filtered, name):
    """exact_search under a filter: the exact search over the allowed stored
    rows (PQ: the decoded rows, in bf16 as the scan decodes them)."""
    corpus, queries, indexes = filtered
    _, p = indexes[name]
    allowed = _filters(len(corpus))["allowed"]["allowed_ids"]
    got_s, got_i = p.exact_search(queries, k=10, allowed_ids=allowed)
    assert np.isin(got_i, allowed).all()
    if name == "pq_rows":
        unfiltered = p.exact_search(queries, k=len(corpus))[1]
        keep = [row[np.isin(row, allowed)][:10] for row in unfiltered]
        np.testing.assert_array_equal(got_i, np.stack(keep))
        return
    stored = p.reconstruct(np.arange(len(corpus)))
    qv = torch.from_numpy(queries).bfloat16().float().numpy()
    o_s, o_i = numpy_search(stored[allowed], qv, 10)
    _assert_same_hits(got_s, got_i, o_s, allowed[o_i].astype(np.int32))


@pytest.mark.parametrize("kw", [{}, {"pq_m": 8}, {"reduced_dim": 16, "candidates": 64}],
                         ids=["bf16", "pq_rows", "hybrid"])
def test_filtered_nprobe_is_tuned_by_the_index(kw, monkeypatch):
    """nprobe="filtered": the build's tuner under the filter. Its nprobe
    reaches the recall target on its own pseudo-queries (or probes every
    cluster), is at least the build's for a narrow filter, is cached per
    filter, and the search at it equals the search at that int; without a
    filter it is the build's nprobe, and search(allowed_ids=...) alone keeps
    the build's probes (FAISS semantics, as the JAX package)."""
    corpus, queries = _corpus_queries()
    p = pivf.IVFIPIndex(corpus, n_clusters=16, kmeans_iters=5, pq_iters=8, recall_target=0.9,
                        tune_sample=64, tune_k=10, **kw)
    allowed = np.sort(np.random.default_rng(4).choice(len(corpus), len(corpus) // 8,
                                                      replace=False))
    assert p.tune_filtered_nprobe(10) == p.nprobe
    tuned = p.tune_filtered_nprobe(10, allowed_ids=allowed)
    assert p.nprobe <= tuned <= p.n_clusters
    sample = p.reconstruct(np.random.default_rng(0).choice(len(corpus), 64, replace=False))
    ref = p.exact_search(sample, k=10, allowed_ids=allowed)[1]
    hits = p.search(sample, k=10, nprobe=tuned, allowed_ids=allowed)[1]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(hits, ref)])
    assert recall >= 0.9 or tuned == p.n_clusters
    calls = []
    monkeypatch.setattr(p, "_tune_nprobe", lambda *a, **k: calls.append(a) or 1)
    for a, b in zip(p.search(queries, k=10, nprobe="filtered", allowed_ids=allowed),
                    p.search(queries, k=10, nprobe=tuned, allowed_ids=allowed)):
        np.testing.assert_array_equal(a, b)
    assert not calls  # the cached nprobe
    mask = np.zeros(len(corpus), bool)
    mask[allowed] = True
    assert p.tune_filtered_nprobe(10, selector=mask) == tuned
    assert p.tune_filtered_nprobe(10, disallowed_ids=allowed) == 1 and len(calls) == 1
    for a, b in zip(p.search(queries, k=10, nprobe="filtered"), p.search(queries, k=10)):
        np.testing.assert_array_equal(a, b)


def test_selector_helpers_match_jax():
    n = 50
    for kw in ({"allowed_ids": [1, 4, 4]}, {"disallowed_ids": np.arange(10)},
               {"selector": np.arange(n) % 3 == 0}, {}):
        got, ref = pflat.build_selector_mask(n, **kw), j_build_selector_mask(n, **kw)
        assert (got is None and ref is None) or np.array_equal(got, ref)
    for bad, err in (({"allowed_ids": [1], "disallowed_ids": [2]}, ValueError),
                     ({"allowed_ids": [n]}, IndexError),
                     ({"selector": np.ones(n - 1, bool)}, ValueError),
                     ({"selector": np.ones(n, np.int8)}, ValueError)):
        with pytest.raises(err):
            pflat.build_selector_mask(n, **bad)
    s = np.array([[1.0, -np.inf]], np.float32)
    i = np.array([[3, 7]], np.int32)
    np.testing.assert_array_equal(pflat.mask_filtered_misses(s, i),
                                  j_mask_filtered_misses(s, i))


# ----------------------------------------------------------------------
# mutation and reconstruct
MUTATION_VARIANTS = {
    "bf16": {},
    "int8": {"store_dtype": jnp.int8},
    "pq_rows": {"pq_m": 8},
    "pq_cols": {"pq_m": 32, "pq_layout": "cols"},
    "pq_opq": {"pq_m": 16, "pq_rotate": "opq"},
    "hybrid": {"reduced_dim": 16, "candidates": 64},
    "balanced": {"balance_eta": 0.1},
}


def _chain(index, extra, rng_seed=0):
    """append (fills the free slots and grows capacity), remove, append
    again (reuses freed slots)."""
    rng = np.random.default_rng(rng_seed)
    a = index.append_sharded(extra[:900], 900, headroom=0.1)
    removed = np.sort(rng.choice(a.n_total, size=400, replace=False))
    r = a.remove_rows(removed)
    b = r.append_sharded(extra[900:], len(extra) - 900)
    return a, r, b


@pytest.fixture(scope="module")
def mutated():
    corpus, queries = _corpus_queries(n=1200, n_q=24, d=64, seed=8)
    extra = _blobs(1200, 64, n_blobs=30, seed=9)
    out = {}
    for name, kw in MUTATION_VARIANTS.items():
        j = jivf.IVFIPIndex(corpus, n_clusters=12, nprobe=4, kmeans_iters=5, pq_iters=8,
                            capacity_slack=1.05, **kw)
        p = pio.index_from_state(jio.index_state(j), device="cpu")
        jt = (jnp.asarray(extra[:900]), jnp.asarray(extra[900:]))
        ja = j.append_sharded(jt[0], 900, headroom=0.1)
        removed = np.sort(np.random.default_rng(0).choice(ja.n_total, size=400, replace=False))
        jr = ja.remove_rows(removed)
        jb = jr.append_sharded(jt[1], 300)
        out[name] = (j.capacity, (ja, jr, jb), _chain(p, torch.from_numpy(extra)))
    return queries, out


@pytest.mark.parametrize("name", list(MUTATION_VARIANTS))
def test_mutation_chain_matches_jax(mutated, name):
    queries, indexes = mutated
    built_cap, jax_chain, port_chain = indexes[name]
    grown = port_chain[0]  # the first append outgrew the free slots
    assert grown.capacity > built_cap and grown.capacity % grown._capacity_multiple() == 0
    for step, (j, p) in enumerate(zip(jax_chain, port_chain)):
        assert (p.n_total, p.capacity, p.nprobe) == (j.n_total, j.capacity, j.nprobe)
        np.testing.assert_array_equal(p.row_ids.numpy(), np.asarray(j.row_ids))
        same = _storage_bits(p.corpus) == _storage_bits(j.corpus)
        filled = p.row_ids.numpy() >= 0
        if p.pq_m is not None:
            cols = same.T if p.pq_layout == "cols" else same
            assert cols[filled].mean() >= 0.99
        else:
            assert same[filled].all()
        if p.quantized:
            np.testing.assert_array_equal(p.slot_scale.numpy()[filled],
                                          np.asarray(j.slot_scale)[filled])
        if p.reduced_dim is not None:
            # appended rows project through the fixed basis in two fp32
            # products summed in another order: their bf16 rounding may
            # differ by an ulp or two
            low_p = p.corpus_low.float().numpy()[filled]
            low_j = np.asarray(j.corpus_low, np.float32)[filled]
            np.testing.assert_allclose(low_p, low_j, rtol=2.0**-7, atol=1e-6)
            assert (low_p == low_j).mean() > 0.99
        if p.pq_m is None:
            _assert_same_hits(*p.search(queries, k=15), *j.search(queries, k=15))
            ids = np.arange(0, p.n_total, 7)
            np.testing.assert_array_equal(p.reconstruct(ids), j.reconstruct(ids))
        else:  # other codes for a few rows: hit sets mostly equal
            got, ref = p.search(queries, k=15)[1], j.search(queries, k=15)[1]
            assert np.mean([len(set(a) & set(b)) / 15 for a, b in zip(got, ref)]) >= 0.95


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
def test_appended_rows_self_retrieval_matches_jax(store):
    """Rows of one tight blob appended into slots freed anywhere, each sent
    back as a query at the index's nprobe: the append rule (nearest
    cluster, else second, else any free slot) spills the same rows into the
    same clusters in both packages, outside their queries' probes, so the
    same rows come back at rank 1 and the same rows do not."""
    corpus, _ = _corpus_queries(n=600, n_q=8, d=32, seed=12)
    j = jivf.IVFIPIndex(corpus, n_clusters=8, nprobe=2, kmeans_iters=5,
                        capacity_slack=1.05, store_dtype=getattr(jnp, store))
    p = pio.index_from_state(jio.index_state(j), device="cpu")
    removed = np.sort(np.random.default_rng(1).choice(600, size=150, replace=False))
    rng = np.random.default_rng(2)
    blob = (corpus[7] + 0.05 * rng.standard_normal((120, 32))).astype(np.float32)
    blob /= np.linalg.norm(blob, axis=1, keepdims=True)
    j = j.remove_rows(removed).append_sharded(jnp.asarray(blob), len(blob))
    p = p.remove_rows(removed).append_sharded(torch.from_numpy(blob), len(blob))
    new = np.arange(p.n_total - len(blob), p.n_total)
    j_ids = np.asarray(j.row_ids)
    j_cluster = np.empty(j.n_total, np.int64)
    j_cluster[j_ids[j_ids >= 0]] = np.nonzero(j_ids >= 0)[0] // j.capacity
    np.testing.assert_array_equal(p._cluster_of_row[new], j_cluster[new])
    got = p.search(blob, k=1)[1][:, 0] == new
    ref = np.asarray(j.search(jnp.asarray(blob), k=1)[1])[:, 0] == new
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(new)  # the spilled rows lie outside the probes


def test_mutation_details():
    corpus, queries = _corpus_queries(n=600, n_q=8, d=32, seed=12)
    p = pivf.IVFIPIndex(corpus, n_clusters=8, nprobe=8, capacity_slack=1.0,
                        store_dtype=torch.float32)
    extra = _blobs(200, 32, seed=13)
    a = p.append_sharded(np.concatenate([extra, np.full((8, 32), 7.0, np.float32)]), 200)
    assert a.capacity > p.capacity and a.n_total == 800 and p.n_total == 600
    np.testing.assert_array_equal(a.reconstruct(np.arange(600, 800)), extra)
    np.testing.assert_array_equal(a.reconstruct(np.arange(600)), corpus)
    s, i = a.search(queries, k=5)
    o_s, o_i = numpy_search(np.concatenate([corpus, extra]), queries, 5)
    _assert_same_hits(s, i, o_s, o_i.astype(np.int32))
    r = a.remove_rows([0, 1, 650])
    assert r.n_total == 797 and r.corpus is a.corpus
    np.testing.assert_array_equal(r.reconstruct([0, 647]), a.reconstruct([2, 649]))
    assert p.remove_rows([]) is p
    for bad, err in (([800], IndexError), ([-1], IndexError),
                     (np.arange(800), ValueError)):
        with pytest.raises(err):
            a.remove_rows(bad)
    for rows, n, err in ((extra, 0, ValueError), (extra[:, :16], 10, ValueError),
                         (extra[:5], 10, ValueError)):
        with pytest.raises(err):
            p.append_sharded(rows, n)
    with pytest.raises(ValueError, match="headroom"):
        p.append_sharded(extra, 10, headroom=-1.0)
    with pytest.raises(IndexError):
        p.reconstruct([600])
    assert p.reconstruct([]).shape == (0, 32)
    assert p.reconstruct(3).shape == (1, 32)


# ----------------------------------------------------------------------
# the streamed build
CHUNK_VARIANTS = {
    "bf16_split": {"kmeans_split": 3},
    "int8": {"store_dtype": "int8"},
    "pq_random": {"pq_m": 16, "pq_rotate": "random"},
    "hybrid_balanced": {"reduced_dim": 12, "balance_eta": 0.05},
}


@pytest.mark.parametrize("name", list(CHUNK_VARIANTS))
def test_from_chunk_fn_matches_jax(name):
    corpus = _skewed(n=2000, d=48, seed=14)
    queries = corpus[::111]
    # whole chunks only: the JAX build writes the pad rows of a partial last
    # chunk into the last slot (a -1 index wraps under mode="drop"), which
    # the port does not copy
    kw = dict(CHUNK_VARIANTS[name], n_clusters=16, chunk_rows=250, train_rows=900,
              **COMMON)
    calls = []

    def get_chunk(lo, hi):
        calls.append((lo, hi))
        return corpus[lo:hi]

    j = jivf.IVFIPIndex.from_chunk_fn(lambda lo, hi: corpus[lo:hi], 2000, 48, **_jkw(kw))
    p = pivf.IVFIPIndex.from_chunk_fn(get_chunk, 2000, 48, device="cpu", **kw)
    assert calls[-8:] == [(lo, lo + 250) for lo in range(0, 2000, 250)]
    assert calls[:4] == [(0, 250), (500, 750), (1250, 1500), (1750, 2000)]
    assert (p.capacity, p.nprobe) == (j.capacity, j.nprobe)
    np.testing.assert_array_equal(p.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(j.centroids), atol=CENT_TOL)
    same = _storage_bits(p.corpus) == _storage_bits(j.corpus)
    assert same.mean() >= (0.99 if "pq_m" in kw else 1.0)
    if p.reduced_dim is not None:
        sign = np.sign(np.sum(np.asarray(j.proj) * p.proj.numpy(), axis=0))
        np.testing.assert_allclose(p.proj.numpy() * sign, np.asarray(j.proj), atol=PROJ_TOL)
        np.testing.assert_allclose(p._assign_bias_host, j._assign_bias_host, atol=CENT_TOL)
    if "pq_m" not in kw:
        ref = j.search(queries, k=10, nprobe=16, candidates=200)
        _assert_same_hits(*p.search(queries, k=10, nprobe=16, candidates=200), *ref)


def test_from_chunk_fn_equals_constructor_layout_on_one_chunk():
    corpus, queries = _corpus_queries(n=800, n_q=6, d=32, seed=15)
    kw = dict(n_clusters=8, nprobe=3, kmeans_iters=4)
    built = pivf.IVFIPIndex(corpus, **kw)
    streamed = pivf.IVFIPIndex.from_chunk_fn(lambda lo, hi: torch.from_numpy(corpus[lo:hi]),
                                             800, 32, chunk_rows=1000, device="cpu", **kw)
    np.testing.assert_array_equal(streamed.row_ids.numpy(), built.row_ids.numpy())
    np.testing.assert_array_equal(_storage_bits(streamed.corpus), _storage_bits(built.corpus))
    with pytest.raises(ValueError, match="get_chunk"):
        pivf.IVFIPIndex.from_chunk_fn(lambda lo, hi: corpus[:3], 800, 32, device="cpu", **kw)


# ----------------------------------------------------------------------
# index files in both directions
def _io_indexes():
    corpus, _ = _corpus_queries(n=900, n_q=1, d=32, seed=16)
    extra = _blobs(300, 32, seed=17)
    base = dict(n_clusters=8, nprobe=3, kmeans_iters=4, capacity_slack=1.05)
    return corpus, extra, {
        "hybrid": dict(base, reduced_dim=8, candidates=40),
        "balanced": dict(base, balance_eta=0.1),
        "split_int8": dict(base, kmeans_split=2, store_dtype="int8"),
        "mutated_pq": dict(base, pq_m=8),
    }


@pytest.mark.parametrize("name", ["hybrid", "balanced", "split_int8", "mutated_pq"])
def test_ivf_files_both_ways(tmp_path, name):
    corpus, extra, configs = _io_indexes()
    _, queries = _corpus_queries(n=900, n_q=12, d=32, seed=16)
    kw = configs[name]
    p = pivf.IVFIPIndex(corpus, **kw)
    if name == "mutated_pq":  # grown capacity and freed slots ride in the file
        p = p.append_sharded(extra, 300).remove_rows(np.arange(0, 1200, 5))
    pio.write_index(p, str(tmp_path / "p"))
    j = jio.read_index(str(tmp_path / "p.npz"))
    cfg = json.loads(str(np.load(tmp_path / "p.npz")[pio.CONFIG_KEY]))
    assert (cfg["balance_eta"], cfg["kmeans_split"]) == (p.balance_eta, p.kmeans_split)
    assert (j.n_total, j.capacity, j.nprobe) == (p.n_total, p.capacity, p.nprobe)
    _assert_same_hits(*p.search(queries, k=10), *j.search(queries, k=10))
    jio.write_index(j, str(tmp_path / "j"))
    back = pio.read_index(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(back.row_ids.numpy(), p.row_ids.numpy())
    np.testing.assert_array_equal(_storage_bits(back.corpus), _storage_bits(p.corpus))
    for attr in ("reduced_dim", "candidates", "balance_eta", "kmeans_split", "capacity"):
        assert getattr(back, attr) == getattr(p, attr)
    if p.assign_bias is not None:
        np.testing.assert_array_equal(back._assign_bias_host, p._assign_bias_host)
    if p.reduced_dim is not None:
        np.testing.assert_array_equal(back.proj.numpy(), p.proj.numpy())
    s, i = back.search(queries, k=10)
    np.testing.assert_array_equal(i, p.search(queries, k=10)[1])
    # appends to the loaded index place rows as the original would
    more = back.append_sharded(extra[:50], 50)
    np.testing.assert_array_equal(more.row_ids.numpy(),
                                  p.append_sharded(extra[:50], 50).row_ids.numpy())
