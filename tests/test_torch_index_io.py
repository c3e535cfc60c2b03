"""Index files exchanged between the packages: an npz written by the JAX
package's ``write_index`` loads in the port's ``read_index`` and the other
way round, for the flat and ivf kinds, and both search alike (indices equal
outside 1e-5 near-ties, scores within 1e-5: fp32 sums of the same exact
products in two orders)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.index import io as jio
from rankpo_tpu.index.flat import FlatIPIndex as JaxFlat
from rankpo_tpu.index.ivf import IVFIPIndex as JaxIVF
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index.flat import FlatIPIndex
from rankpo_tpu_torch.index.ivf import IVFIPIndex

torch.set_num_threads(2)

TOL = 1e-5


def _data(n=600, n_q=12, d=32, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(12, d).astype(np.float32)
    x = centers[rng.randint(0, 12, n + n_q)] + 0.2 * rng.randn(n + n_q, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x[:n].astype(np.float32), x[n:].astype(np.float32)


def _same_hits(a, b):
    (s1, i1), (s2, i2) = a, b
    np.testing.assert_allclose(s1, s2, atol=TOL, rtol=0)
    gaps = np.abs(np.diff(s2, axis=1)) > TOL
    clear = np.ones_like(i2, dtype=bool)
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    np.testing.assert_array_equal(i1[clear], i2[clear])


IVF_KW = {
    "bf16": {}, "fp32": {"store_dtype": "float32"}, "int8": {"store_dtype": "int8"},
    "pq_rows": {"pq_m": 8}, "pq_cols": {"pq_m": 32, "pq_layout": "cols"},
    "pq_opq": {"pq_m": 8, "pq_rotate": "opq"},
}


def _jax_kw(kw):
    return {k: getattr(jnp, v) if k == "store_dtype" else v for k, v in kw.items()}


@pytest.mark.parametrize("variant", list(IVF_KW))
def test_ivf_jax_file_loads_in_port(tmp_path, variant):
    corpus, queries = _data()
    j = JaxIVF(corpus, n_clusters=8, recall_target=0.9, kmeans_iters=4, pq_iters=6,
               tune_sample=32, tune_k=10, **_jax_kw(IVF_KW[variant]))
    path = str(tmp_path / "jax_index")
    jio.write_index(j, path)
    p = pio.read_index(path + ".npz", device="cpu")
    assert isinstance(p, IVFIPIndex) and p.device == torch.device("cpu")
    assert (p.n_clusters, p.capacity, p.nprobe, p.pq_layout) == (
        j.n_clusters, j.capacity, j.nprobe, j.pq_layout)
    _same_hits(p.search(queries, k=10), j.search(queries, k=10))


@pytest.mark.parametrize("variant", list(IVF_KW))
def test_ivf_port_file_loads_in_jax(tmp_path, variant):
    corpus, queries = _data(seed=1)
    p = IVFIPIndex(corpus, n_clusters=8, recall_target=0.9, kmeans_iters=4, pq_iters=6,
                   tune_sample=32, tune_k=10, **IVF_KW[variant])
    path = str(tmp_path / "port_index.npz")
    pio.write_index(p, path)
    j = jio.read_index(path)
    assert (j.n_clusters, j.capacity, j.nprobe, j.pq_layout) == (
        p.n_clusters, p.capacity, p.nprobe, p.pq_layout)
    assert np.asarray(j.corpus).dtype.name == {
        "bf16": "bfloat16", "fp32": "float32", "int8": "int8"}.get(variant, "uint8")
    _same_hits(p.search(queries, k=10), j.search(queries, k=10))
    # and back again: a second round trip through the port is bit-identical
    again = pio.index_from_state(jio.index_state(j), device="cpu")
    for a, b in ((again.corpus, p.corpus), (again.row_ids, p.row_ids),
                 (again.centroids, p.centroids)):
        assert torch.equal(a, b)
    assert np.array_equal(p.search(queries, k=10)[1], again.search(queries, k=10)[1])


def test_flat_files_both_ways(tmp_path):
    corpus, queries = _data(n=100, seed=2)
    jio.write_index(JaxFlat(corpus), str(tmp_path / "j"))
    p = pio.read_index(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(p, FlatIPIndex) and p.ntotal == 100
    ref = JaxFlat(corpus).search(queries, k=7)
    got = p.search(queries, k=7)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], atol=TOL, rtol=0)
    buf = np.concatenate([corpus, np.zeros((5, 32), np.float32)])
    pio.write_index(FlatIPIndex(buf, n_total=100), str(tmp_path / "p"))
    j = jio.read_index(str(tmp_path / "p.npz"))
    assert j.n_total == 100
    got = j.search(queries, k=7)
    np.testing.assert_array_equal(got[1], ref[1])


def test_unported_kinds_and_formats_raise(tmp_path):
    corpus, queries = _data(n=64, seed=3)
    # int8 flat storage loads now (it raised before the port had it): the
    # codes and scales as written, the JAX index's hits
    j8 = JaxFlat(corpus, dtype=jnp.int8)
    jio.write_index(j8, str(tmp_path / "int8"))
    p8 = pio.read_index(str(tmp_path / "int8.npz"), device="cpu")
    np.testing.assert_array_equal(p8.corpus[:64].numpy(), np.asarray(j8.corpus)[:64])
    _same_hits(p8.search(queries, k=7), j8.search(queries, k=7))
    # the PCA hybrid loads (it raised before the port had it)
    j = JaxIVF(corpus, n_clusters=4, nprobe=2, reduced_dim=8)
    p = pio.index_from_state(jio.index_state(j), device="cpu")
    assert p.reduced_dim == 8 and p.corpus_low.dtype == torch.bfloat16
    np.testing.assert_array_equal(p.search(corpus[:3], k=5)[1], j.search(corpus[:3], k=5)[1])
    state = jio.index_state(JaxFlat(corpus))
    cfg = json.loads(str(state[pio.CONFIG_KEY]))
    cfg["format"] = "other"
    state[pio.CONFIG_KEY] = np.asarray(json.dumps(cfg))
    with pytest.raises(ValueError, match="format"):
        pio.index_from_state(state, device="cpu")
    with pytest.raises(TypeError):
        pio.index_state(object())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("approx", [False, True])
def test_flat_storage_files_both_ways(tmp_path, dtype, approx):
    """Flat bf16 / int8 files (with the approximate mode's recall_target)
    cross the packages both ways: stored rows bit-equal, the same knobs,
    hits as the writer's index (exact mode)."""
    corpus, queries = _data(n=100, seed=4)
    kw = {"recall_target": 0.9} if approx else {}
    j = JaxFlat(corpus, dtype=getattr(jnp, dtype), **kw)
    p = FlatIPIndex(corpus, dtype=getattr(torch, dtype), **kw)
    jio.write_index(j, str(tmp_path / "j"))
    pio.write_index(p.append_sharded(torch.from_numpy(queries), 4), str(tmp_path / "p"))
    from_j = pio.read_index(str(tmp_path / "j.npz"), device="cpu")
    from_p = jio.read_index(str(tmp_path / "p.npz"))
    assert from_j.dtype == getattr(torch, dtype) and from_j.recall_target == j.recall_target
    assert from_p.dtype == getattr(jnp, dtype) and from_p.ntotal == 104
    assert from_p.recall_target == p.recall_target
    ids = np.arange(100)
    np.testing.assert_array_equal(from_j.reconstruct(ids), j.reconstruct(ids))
    np.testing.assert_array_equal(from_p.reconstruct(np.arange(104)),
                                  p.append_sharded(torch.from_numpy(queries), 4)
                                  .reconstruct(np.arange(104)))
    if not approx:
        _same_hits(from_j.search(queries, k=7), j.search(queries, k=7))
    assert pio.is_index_state(jio.index_state(j)) and pio.state_kind(
        pio.index_state(p)) == jio.state_kind(jio.index_state(j)) == "flat"
    assert not pio.is_index_state({"embeddings": corpus})


def test_read_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    corpus, _ = _data(n=64, seed=4)
    pio.write_index(FlatIPIndex(corpus), str(tmp_path / "f"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pio.read_index(str(tmp_path / "f.npz"))
