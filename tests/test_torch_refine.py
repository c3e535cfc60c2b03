"""The port's RefineIPIndex (``rankpo_tpu_torch.index.refined``) against the
JAX package's, on numpy inputs from a seed, on the CPU.

Both packages build the same PCA basis from fp32 second moments summed in
another order, so each column is compared up to its sign within 1e-4.
Stage 1 rounds the projected products to bf16 (both), where an ulp of the
basis can reorder near-equal rows at the candidate boundary; so hits are
compared as in ``test_torch_ivf``: equal wherever neighbouring reference
scores differ by more than 1e-5, scores (exact reranks at storage
precision) within 1e-5. The tuned candidate count is equal. Indexes carried
across with ``index_state`` -> ``index_from_state`` share the basis and the
projected rows, so their searches agree the same way; ``reconstruct`` is
bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.index import io as jio
from rankpo_tpu.index.flat import numpy_search
from rankpo_tpu.index.refined import RefineIPIndex as JaxRefine
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index.factory import build_offline_index, resolve_index_spec
from rankpo_tpu_torch.index.refined import RefineIPIndex

from test_torch_ivf import TOL, _assert_same_hits, _storage_bits

torch.set_num_threads(2)

PROJ_TOL = 1e-4


def _spectral(n=2000, n_q=24, d=64, seed=21):
    """Rows with a decaying spectrum (as real embeddings have), normalised,
    so a low-dimensional projection keeps most of the geometry."""
    rng = np.random.RandomState(seed)
    scales = (1.0 / np.arange(1, d + 1) ** 0.7).astype(np.float32)
    x = rng.randn(n + n_q, d).astype(np.float32) * scales
    x = x @ np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x[:n].astype(np.float32), x[n:].astype(np.float32)


def _assert_proj(p, j):
    j_proj, p_proj = np.asarray(j.proj), p.proj.numpy()
    sign = np.sign(np.sum(j_proj * p_proj, axis=0))
    np.testing.assert_allclose(p_proj * sign, j_proj, atol=PROJ_TOL, rtol=0)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("ctor", ["init", "from_sharded"])
def test_build_and_tuned_candidates_match_jax(store, ctor):
    corpus, queries = _spectral()
    kw = dict(reduced_dim=12, recall_target=0.9, tune_sample=64, tune_k=10,
              store_dtype=store)
    jkw = dict(kw, store_dtype=getattr(jnp, store))
    if ctor == "init":
        j = JaxRefine(corpus, **jkw)
        p = RefineIPIndex(corpus, **kw)
    else:
        j = JaxRefine.from_sharded(jnp.asarray(corpus), len(corpus), **jkw)
        p = RefineIPIndex.from_sharded(torch.from_numpy(corpus), len(corpus), **kw)
    _assert_proj(p, j)
    assert p.candidates == j.candidates
    assert p.corpus.dtype == getattr(torch, store)
    np.testing.assert_array_equal(_storage_bits(p.corpus), _storage_bits(j.corpus))
    for c in (None, 40, 300):
        _assert_same_hits(*p.search(queries, k=10, candidates=c),
                          *j.search(queries, k=10, candidates=c))


@pytest.fixture(scope="module")
def carried():
    corpus, queries = _spectral()
    j = JaxRefine(corpus, reduced_dim=12, candidates=64)
    return corpus, queries, j, pio.index_from_state(jio.index_state(j), device="cpu")


def test_carried_index_search_and_filters_match_jax(carried):
    corpus, queries, j, p = carried
    assert (p.candidates, p.reduced_dim, p.n_total) == (64, 12, len(corpus))
    _assert_same_hits(*p.search(queries, k=20), *j.search(queries, k=20))
    rng = np.random.default_rng(3)
    allowed = np.sort(rng.choice(len(corpus), size=len(corpus) // 4, replace=False))
    sel = np.zeros(len(corpus), bool)
    sel[::3] = True
    for kw in ({"allowed_ids": allowed}, {"disallowed_ids": allowed},
               {"selector": sel}):
        ref_s, ref_i = j.search(queries, k=20, **kw)
        got_s, got_i = p.search(queries, k=20, **kw)
        _assert_same_hits(got_s, got_i, ref_s, ref_i)
    got_s, got_i = p.search(queries, k=5, allowed_ids=[4, 9])
    ref_s, ref_i = j.search(queries, k=5, allowed_ids=[4, 9])
    np.testing.assert_array_equal(got_i, ref_i)
    assert (got_i[:, 2:] == -1).all() and np.isneginf(got_s[:, 2:]).all()
    np.testing.assert_allclose(got_s[:, :2], ref_s[:, :2], atol=TOL, rtol=0)


def test_full_candidates_are_exact_at_storage_precision(carried):
    corpus, queries, _, p = carried
    stored = p.reconstruct(np.arange(len(corpus)))
    o_s, o_i = numpy_search(stored, torch.from_numpy(queries).bfloat16().float().numpy(), 10)
    _assert_same_hits(*p.search(queries, k=10, candidates=len(corpus)),
                      o_s, o_i.astype(np.int32))


def test_mutation_matches_jax(carried):
    corpus, queries, j, p = carried
    extra, _ = _spectral(n=300, n_q=1, seed=22)
    removed = np.random.default_rng(5).choice(len(corpus) + 300, size=250, replace=False)
    ja = j.append_sharded(jnp.asarray(extra), 300, headroom=0.5)
    pa = p.append_sharded(torch.from_numpy(extra), 300, headroom=0.5)
    jr, pr = ja.remove_rows(removed), pa.remove_rows(removed)
    jb = jr.append_sharded(jnp.asarray(extra[:100]), 100)  # into the freed rows
    pb = pr.append_sharded(torch.from_numpy(extra[:100]), 100)
    for jj, pp in ((ja, pa), (jr, pr), (jb, pb)):
        assert (pp.n_total, pp.n_padded) == (jj.n_total, jj.n_padded)
        np.testing.assert_array_equal(pp.proj.numpy(), np.asarray(j.proj))  # fixed basis
        _assert_same_hits(*pp.search(queries, k=10), *jj.search(queries, k=10))
        ids = np.arange(0, pp.n_total, 9)
        np.testing.assert_array_equal(pp.reconstruct(ids), jj.reconstruct(ids))
    assert pb.n_padded == pa.n_padded  # the freed rows took the append
    np.testing.assert_array_equal(pa.reconstruct(np.arange(2000, 2300)),
                                  torch.from_numpy(extra).bfloat16().float().numpy())
    assert p.remove_rows([]) is p
    with pytest.raises(IndexError):
        p.remove_rows([len(corpus)])
    with pytest.raises(ValueError):
        p.remove_rows(np.arange(len(corpus)))
    with pytest.raises(ValueError):
        p.append_sharded(extra[:, :8], 10)
    with pytest.raises(IndexError):
        p.reconstruct([-1])


def test_files_both_ways(tmp_path):
    corpus, queries = _spectral(n=800, seed=23)
    p = RefineIPIndex(corpus, reduced_dim=8, candidates=48, store_dtype=torch.float32)
    p = p.append_sharded(corpus[:50] * 0.5, 50, headroom=0.2).remove_rows([0, 3])
    pio.write_index(p, str(tmp_path / "p"))
    j = jio.read_index(str(tmp_path / "p.npz"))
    assert (j.n_total, j.candidates, j.reduced_dim) == (p.n_total, 48, 8)
    _assert_same_hits(*p.search(queries, k=10), *j.search(queries, k=10))
    jio.write_index(j, str(tmp_path / "j"))
    back = pio.read_index(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(back, RefineIPIndex) and back.store_dtype == torch.float32
    np.testing.assert_array_equal(back.proj.numpy(), p.proj.numpy())
    np.testing.assert_array_equal(back.search(queries, k=10)[1], p.search(queries, k=10)[1])


def test_padding_rows_never_surface():
    corpus, queries = _spectral(n=300, seed=24)
    buf = np.concatenate([corpus, np.full((40, corpus.shape[1]), 3.0, np.float32)])
    p = RefineIPIndex.from_sharded(torch.from_numpy(buf), 300, reduced_dim=8,
                                   candidates=300)
    assert (p.n_total, p.n_padded) == (300, 340)
    s, i = p.search(queries, k=300)
    assert (i >= 0).all() and i.max() < 300 and np.isfinite(s).all()
    t_s, t_i = p.search_tensor(torch.from_numpy(queries), 5)
    assert t_i.dtype == torch.int64 and t_s.shape == (len(queries), 5)


def test_validation():
    corpus, _ = _spectral(n=100, seed=25)
    for kw in ({"reduced_dim": 0}, {"reduced_dim": 65}, {"store_dtype": "int8"},
               {"candidates": 0}):
        with pytest.raises(ValueError):
            RefineIPIndex(corpus, **kw)
    with pytest.raises(ValueError, match="n_total"):
        RefineIPIndex.from_sharded(torch.from_numpy(corpus), 101)


def test_build_offline_index_takes_the_tool_constructor():
    """``build_offline_index`` makes refine as the JAX tools do: reduced_dim
    min(256, D); the moment of the fp32 rows (evaluator, predictions) or of
    the stored rows (mining)."""
    corpus, queries = _spectral(n=600, seed=26)
    kind, kw = resolve_index_spec("PCA16,Flat")
    assert (kind, kw) == ("refine", {"reduced_dim": 16})
    default = build_offline_index(torch.from_numpy(corpus), 600, "refine", {}, 0.9)
    assert default.reduced_dim == 64  # min(256, D)
    for stored in (False, True):
        p = build_offline_index(torch.from_numpy(corpus), 600, "refine", kw, 0.9,
                                as_constructor=stored)
        j = (JaxRefine(corpus, reduced_dim=16, recall_target=0.9) if stored else
             JaxRefine.from_sharded(jnp.asarray(corpus), 600, reduced_dim=16,
                                    recall_target=0.9))
        _assert_proj(p, j)
        assert p.candidates == j.candidates
        _assert_same_hits(*p.search(queries, k=10), *j.search(queries, k=10))
