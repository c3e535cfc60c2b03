"""Port exact flat search against ``rankpo_tpu.index.flat.numpy_search``.

The bit-equality tests use dyadic data (small integers over 16): every
product and partial sum is exact in fp32, so any summation order gives the
same scores and the comparison isolates selection and tie order. Random
float data is compared with indices equal and scores within 1e-6.
"""

import numpy as np
import pytest
import torch

from rankpo_tpu.index.flat import numpy_search as jax_numpy_search
from rankpo_tpu_torch.index.flat import FlatIPIndex, numpy_search
from rankpo_tpu_torch.ops.topk import dense_matmul_topk

torch.set_num_threads(2)


def _dyadic(rng, shape):
    return (rng.integers(-8, 9, shape) / 16.0).astype(np.float32)


def _tied_corpus(seed=0, n=40, d=16):
    """Corpus with exact duplicates: row 5 repeats at 11, 17 and 30 (at 6
    in a corpus too small for those), so a tie group straddles small k."""
    rng = np.random.default_rng(seed)
    corpus = _dyadic(rng, (n, d))
    for j in [j for j in (11, 17, 30) if j < n] or [6]:
        corpus[j] = corpus[5]
    queries = _dyadic(rng, (6, d))
    queries[0] = corpus[5]  # the tie group tops query 0's ranking
    return corpus, queries


def _assert_bit_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("k", [1, 2, 3, 5, 10])
def test_tie_order_bit_equal(k):
    corpus, queries = _tied_corpus()
    ref = jax_numpy_search(corpus, queries, k)
    _assert_bit_equal(numpy_search(corpus, queries, k), ref)
    _assert_bit_equal(FlatIPIndex(corpus).search(queries, k=k, batch_size=4), ref)
    if k >= 3:
        assert list(ref[1][0, :3]) == [5, 11, 17]


def test_k_larger_than_corpus():
    corpus, queries = _tied_corpus(n=7)
    ref = jax_numpy_search(corpus, queries, 50)
    assert ref[1].shape == (6, 7)
    got = FlatIPIndex(corpus).search(queries, k=50)
    _assert_bit_equal(got, ref)
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32


def test_n_valid_masks_pad_rows():
    corpus, queries = _tied_corpus()
    n = 33
    buf = corpus.copy()
    buf[n:] = 100.0  # pad rows that would win every query if searched
    index = FlatIPIndex(torch.from_numpy(buf), n_total=n)
    assert index.ntotal == n
    _assert_bit_equal(index.search(queries, k=8),
                      jax_numpy_search(corpus[:n], queries, 8))
    _assert_bit_equal(index.search(queries, k=100),
                      jax_numpy_search(corpus[:n], queries, 100))
    np.testing.assert_array_equal(index.rows(), corpus[:n])


def test_random_float_data():
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((300, 32), dtype=np.float32)
    queries = rng.standard_normal((9, 32), dtype=np.float32)
    ref_s, ref_i = jax_numpy_search(corpus, queries, 20)
    s, i = dense_matmul_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k=20)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=1e-6, rtol=0)


def test_empty_queries_and_bad_n_total():
    corpus, _ = _tied_corpus()
    s, i = FlatIPIndex(corpus).search(np.zeros((0, 16), np.float32), k=4)
    assert s.shape == (0, 4) and i.shape == (0, 4)
    with pytest.raises(ValueError):
        FlatIPIndex(corpus, n_total=0)
