"""The port's IVFIPIndex (``rankpo_tpu_torch.index.ivf``) against the JAX
package's, on numpy inputs from a seed, on the CPU.

- The host helpers (cluster count, capacity, greedy fill with its spill) are
  compared bit for bit.
- Lloyd plus the top-8 candidate pass from one init on well-separated data:
  centroids within 1e-5 (fp32 sums in another order), candidates equal.
- A whole build on that data: cluster count, capacity, ``row_ids`` and the
  tuned nprobe equal; bf16 rows and int8 codes bit-equal. PQ codes agree on
  at least 99%: the codebook Lloyd sums in another order, and one flipped
  argmin moves a codeword.
- Search through a JAX index carried across with ``index_state`` ->
  ``index_from_state``, for bf16, fp32, int8, PQ rows, PQ cols and PQ with a
  random rotation: indices equal wherever neighbouring reference scores
  differ by more than 1e-5, scores within 1e-5. Both sides sum exact
  products in fp32 (bf16 operands, or true fp32 ones for fp32 rows): the
  port's PQ tables sum the same products as the JAX CPU path's product with
  rows rebuilt from the bf16 codebooks, and as its ADC kernel in interpret
  mode; only the summation order differs.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.index import io as jio
from rankpo_tpu.index import ivf as jivf
from rankpo_tpu.index.flat import numpy_search
from rankpo_tpu.ops import pq_adc_pallas
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index import ivf as pivf
from rankpo_tpu_torch.ops import ivf_gather, pq_adc

torch.set_num_threads(2)

TOL = 1e-5


def _blobs(n, d, n_blobs=20, seed=0, spread=0.15):
    """Unit-norm rows around random unit centres (as tests/test_index_ivf.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_blobs, d).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.randint(0, n_blobs, size=n)
    x = centers[assign] + spread * rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _corpus_queries(n=3000, n_q=32, d=64, seed=3):
    x = _blobs(n + n_q, d, n_blobs=30, seed=seed)
    return x[:n], x[n:]


def _assert_same_hits(got_s, got_i, ref_s, ref_i, tol=TOL):
    np.testing.assert_allclose(got_s, ref_s, atol=tol, rtol=0)
    gaps = np.abs(np.diff(ref_s, axis=1)) > tol
    clear = np.ones_like(ref_i, dtype=bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    np.testing.assert_array_equal(got_i[clear], ref_i[clear])
    assert clear.mean() > 0.5  # the comparison is not vacuous


# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,shards,req", [
    (1, 1, "auto"), (10, 1, "auto"), (3000, 1, "auto"), (1 << 20, 1, "auto"),
    (100, 8, "auto"), (100, 1, 7), (50, 4, 5)])
def test_resolve_clusters_bit_for_bit(n, shards, req):
    assert pivf._resolve_clusters(n, shards, req) == jivf._resolve_clusters(n, shards, req)


@pytest.mark.parametrize("n,k,slack,mult", [
    (1 << 20, 4096, 1.3, 8), (1 << 20, 4096, 1.3, 64), (1 << 20, 4096, 1.3, 128),
    (7, 16, 1.0, 8), (3000, 16, 1.15, 64), (4096, 256, 1.3, 8)])
def test_resolve_capacity_bit_for_bit(n, k, slack, mult):
    got = pivf._resolve_capacity(n, k, slack, multiple=mult)
    assert got == jivf._resolve_capacity(n, k, slack, multiple=mult)
    assert got * k >= n and got % mult == 0


def test_resolve_helpers_reject_bad_cluster_count():
    with pytest.raises(ValueError, match="n_clusters"):
        pivf._resolve_clusters(10, 1, 0)


@pytest.mark.parametrize("case", ["random", "spill", "top8"])
def test_greedy_fill_bit_for_bit(case):
    rng = np.random.default_rng(0)
    if case == "random":
        n, k, cap = 1000, 16, 80
        cand = rng.integers(0, k, (n, 2)).astype(np.int32)
    elif case == "spill":  # every row prefers clusters 0 then 1
        n, k, cap = 100, 8, 16
        cand = np.zeros((n, 2), np.int32)
        cand[:, 1] = 1
    else:  # skewed 8-candidate lists that overflow several choices
        n, k, cap = 2000, 32, 72
        cand = np.minimum(rng.geometric(0.2, (n, 8)) - 1, k - 1).astype(np.int32)
    got = pivf._greedy_fill(cand, n, k, cap)
    np.testing.assert_array_equal(got, jivf._greedy_fill(cand, n, k, cap))
    assert sorted(got[got >= 0].tolist()) == list(range(n))


def test_lloyd_and_top8_match_jax_from_shared_init():
    corpus = _blobs(1500, 32, n_blobs=12, seed=5, spread=0.1)
    k = 12
    init = corpus[np.random.default_rng(0).choice(len(corpus), k, replace=False)]
    chunk = 256
    padded = jivf._pad_to_chunks(jnp.asarray(corpus), chunk)

    @functools.partial(jax.jit)
    def jax_fit(c, cents):
        cents, _ = jivf._lloyd_body(c, cents, corpus.shape[0], n_iters=6, chunk=chunk,
                                    axis_name=None, spherical=True)
        return cents, jivf._assign_top2_body(c, cents, chunk=chunk, n_cand=8)

    j_cents, j_cand = jax_fit(padded, jnp.asarray(init))
    p_cents, _ = pivf._lloyd_body(torch.from_numpy(corpus), torch.from_numpy(init),
                                  n_iters=6, chunk=chunk, spherical=True)
    p_cand = pivf._assign_top2_body(torch.from_numpy(corpus), p_cents, chunk=chunk, n_cand=8)
    np.testing.assert_allclose(p_cents.numpy(), np.asarray(j_cents), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p_cand.numpy(), np.asarray(j_cand)[: len(corpus)])


def _storage_bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("kw", [{}, {"store_dtype": "int8"}, {"pq_m": 8},
                                {"pq_m": 32, "pq_layout": "cols"}],
                         ids=["bf16", "int8", "pq_rows", "pq_cols"])
def test_whole_build_matches_jax(kw):
    corpus, _ = _corpus_queries()
    jkw = {k: getattr(jnp, v) if k == "store_dtype" else v for k, v in kw.items()}
    common = dict(recall_target=0.9, kmeans_iters=5, pq_iters=10, tune_sample=64, tune_k=10)
    j = jivf.IVFIPIndex(corpus, **common, **jkw)
    p = pivf.IVFIPIndex(corpus, **common, **kw)
    assert (p.n_clusters, p.capacity, p.nprobe) == (j.n_clusters, j.capacity, j.nprobe)
    assert p.pq_layout == j.pq_layout
    np.testing.assert_array_equal(p.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(j.centroids), atol=1e-5)
    same = _storage_bits(p.corpus) == _storage_bits(j.corpus)
    if "pq_m" in kw:
        assert same.mean() >= 0.99
    else:
        assert same.all()
    if p.quantized:
        np.testing.assert_array_equal(p.slot_scale.numpy(), np.asarray(j.slot_scale))


# OPQ (the sharded tests' build: pq_m 8, pq_iters 10) alternates its Lloyd
# fits and Procrustes rotations eight times, and fp32 sums in another order
# move the rotation: its codes are held to JAX's at a lower agreement than
# plain PQ's, in one process as over two shards
OPQ = dict(recall_target=0.9, kmeans_iters=5, tune_sample=32, tune_k=10, pq_m=8,
           pq_iters=10, pq_rotate="opq")
OPQ_BUILD_AGREEMENT = 0.95


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_opq_build_matches_jax_in_one_process(seed):
    """One process: K, capacity and ``row_ids`` equal JAX's, the tuned
    nprobe within one, and the filled slots' codes agree in at least
    OPQ_BUILD_AGREEMENT of their entries (the limit two shards are held to
    in tests/test_torch_sharded_ivf.py)."""
    corpus, _ = _corpus_queries(n=2000, n_q=24, d=64, seed=seed)
    j = jivf.IVFIPIndex(corpus, **OPQ)
    p = pivf.IVFIPIndex(corpus, **OPQ)
    assert (p.n_clusters, p.capacity) == (j.n_clusters, j.capacity)
    assert abs(p.nprobe - j.nprobe) <= 1
    row_ids = p.row_ids.numpy()
    np.testing.assert_array_equal(row_ids, np.asarray(j.row_ids))
    filled = row_ids >= 0
    same = _storage_bits(p.corpus)[filled] == _storage_bits(j.corpus)[filled]
    assert same.mean() >= OPQ_BUILD_AGREEMENT, same.mean()


# ----------------------------------------------------------------------
VARIANTS = {  # name -> (JAX constructor kwargs, nprobe)
    "bf16": ({}, 4),
    "fp32": ({"store_dtype": jnp.float32}, 4),
    "int8": ({"store_dtype": jnp.int8}, 4),
    "pq_rows": ({"pq_m": 8}, 8),
    "pq_cols": ({"pq_m": 32, "pq_layout": "cols"}, 4),
    "pq_random": ({"pq_m": 16, "pq_rotate": "random"}, 4),
}


@pytest.fixture(scope="module")
def carried():
    """One JAX build per variant, carried into the port on the CPU."""
    corpus, queries = _corpus_queries()
    out = {}
    for name, (kw, nprobe) in VARIANTS.items():
        j = jivf.IVFIPIndex(corpus, n_clusters=16, nprobe=nprobe, kmeans_iters=5,
                            pq_iters=10, **kw)
        out[name] = (j, pio.index_from_state(jio.index_state(j), device="cpu"))
    return corpus, queries, out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_search_through_carried_index_matches_jax(carried, name):
    _, queries, indexes = carried
    j, p = indexes[name]
    assert p.nprobe == j.nprobe and p.capacity == j.capacity
    ref_s, ref_i = j.search(queries, k=20, batch_size=32)
    got_s, got_i = p.search(queries, k=20, batch_size=32)
    assert got_s.dtype == np.float32 and got_i.dtype == np.int32
    _assert_same_hits(got_s, got_i, ref_s, ref_i, TOL)
    # exact search over the stored rows decodes the same storage
    ref_s, ref_i = j.exact_search(queries, k=20)
    got_s, got_i = p.exact_search(queries, k=20)
    _assert_same_hits(got_s, got_i, ref_s, ref_i, TOL)
    # a per-call nprobe; probing every cluster reaches every row
    got_s, got_i = p.search(queries[:4], k=20, nprobe=16)
    ref_s, ref_i = j.search(queries[:4], k=20, nprobe=16)
    _assert_same_hits(got_s, got_i, ref_s, ref_i, TOL)
    assert (got_i >= 0).all()
    assert ivf_gather.launches["ivf_probe_scores"] == 0
    assert not any(pq_adc.launches.values())


@pytest.mark.parametrize("name", ["pq_rows", "pq_cols"])
def test_pq_search_matches_jax_adc_kernel(carried, name, monkeypatch):
    """The JAX package's fused ADC kernel (interpret mode) sums the same fp32
    table entries as the port, so scores agree to fp32 summation order. The
    rows kernel serves only batches of >= 65536 probed slots."""
    _, queries, indexes = carried
    j, p = indexes[name]
    assert len(queries) * j.nprobe * j.capacity >= 1 << 16 or name == "pq_cols"
    monkeypatch.setattr(pq_adc_pallas, "FORCE_INTERPRET", True)
    j._search_fns = {}  # drop programs built for the XLA decode
    ref_s, ref_i = j.search(queries, k=20, batch_size=32)
    got_s, got_i = p.search(queries, k=20, batch_size=32)
    _assert_same_hits(got_s, got_i, ref_s, ref_i, TOL)


def test_full_probe_is_storage_exact():
    corpus, queries = _corpus_queries(n=500, n_q=9, d=32, seed=1)
    index = pivf.IVFIPIndex(corpus, n_clusters=8, nprobe=8, store_dtype=torch.float32)
    s, i = index.search(queries, k=10, batch_size=4)
    es, ei = numpy_search(corpus, queries, 10)
    np.testing.assert_allclose(s, es, atol=1e-5)
    for r in range(len(queries)):
        assert set(i[r].tolist()) == set(ei[r].tolist())


def test_tensor_input_keeps_device_and_pads():
    corpus, queries = _corpus_queries(n=300, n_q=5, d=32, seed=2)
    buf = np.concatenate([corpus, np.full((20, 32), 9.0, np.float32)])
    index = pivf.IVFIPIndex(torch.from_numpy(buf), n_total=300, n_clusters=4, nprobe=4)
    assert index.device == torch.device("cpu") and index.ntotal == 300
    s, i = index.search_tensor(torch.from_numpy(queries), 300)
    assert s.shape == (5, 300) and int(i.max()) < 300 and (i >= 0).all()
    assert index.corpus.dtype == torch.bfloat16
    assert set(index.build_seconds) == {"kmeans", "fill", "storage", "tune"}


def test_unported_options_raise():
    """A mesh is not ported (ROADMAP.md Queue 1 item 8c); bad storage and PQ
    options raise ValueError, as in the JAX package."""
    corpus, _ = _corpus_queries(n=200, n_q=1, d=16, seed=4)
    with pytest.raises(NotImplementedError, match="item 8c, multi-card"):
        pivf.IVFIPIndex(corpus, mesh=object())
    for kw in ({"store_dtype": "float16"}, {"capacity_slack": 0.5}, {"pq_m": 5},
               {"pq_m": 8, "pq_layout": "cols"}, {"pq_rotate": "random"},
               {"pq_m": 4, "store_dtype": torch.int8}, {"pq_m": 4, "reduced_dim": 8},
               {"reduced_dim": 17}, {"candidates": 0}):
        with pytest.raises(ValueError):
            pivf.IVFIPIndex(corpus, **kw)
