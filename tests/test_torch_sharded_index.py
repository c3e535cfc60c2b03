"""The flat and refine tiers row-sharded over two gloo processes (the
PyTorch port's ``group=``) against the JAX package's indexes on a 2-device
data mesh, and the flat tier against the port in one process.

The workers (``torch_serve_workers.sharded_index_worker``, joined with a
timeout of their own) run the same operations the test runs in one process
(``flat_ops``, ``refine_ops`` with ``group=None``). Tolerances are those of
``tests/test_torch_flat.py`` and ``tests/test_torch_refine.py`` against JAX:
hits equal wherever neighbouring scores differ by more than 1e-5, scores
within 1e-5, stored rows after every mutation bit-equal, refine's basis
within 1e-4 up to sign and its tuned C equal. On a corpus of exact ties
(products of multiples of 1/4, exact in every summation order) the indices
are equal whole, so the rank-order merge's FAISS tie order is held. The
flat tier at W = 2 equals the port at W = 1 bit for bit (indices and
scores), and both ranks return the same arrays. Files move between W = 1
and W = 2 with identical hits.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.core.mesh import MeshConfig as JMeshConfig
from rankpo_tpu.core.mesh import make_mesh
from rankpo_tpu.index import io as jio
from rankpo_tpu.index.flat import FlatIPIndex as JaxFlat
from rankpo_tpu.index.refined import RefineIPIndex as JaxRefine
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index.flat import FlatIPIndex

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
import torch_serve_workers as sw  # noqa: E402
from test_torch_flat import _data, _same_hits  # noqa: E402
from test_torch_ivf import _assert_same_hits  # noqa: E402
from test_torch_refine import PROJ_TOL, _spectral  # noqa: E402

torch.set_num_threads(2)

DTYPES = ("float32", "bfloat16", "int8")


def _ties(seed=5):
    """201 rows drawn from 20 distinct ones and 5 queries, all multiples of
    1/4 with entries in [-1/2, 1/2]: every score is exact, so duplicate rows
    tie exactly in every package and summation order."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, (20, 64)).astype(np.float32) * 0.25
    rows = base[rng.integers(0, 20, 201)]
    return rows, rng.integers(-2, 3, (5, 64)).astype(np.float32) * 0.25


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_index"))
    x, q = _data()
    ties, tq = _ties()
    xs, qs = _spectral()
    extra = _spectral(n=300, n_q=1, seed=22)[0]
    data = dict(x=x, q=q, ties=ties, tq=tq, xs=xs, qs=qs, extra=extra)
    workers.save(out, "index_data.pt", data)
    jref = JaxRefine(xs, reduced_dim=12, candidates=64)
    pio.save_state(jio.index_state(jref), os.path.join(out, "refine_jax.npz"))
    w1 = FlatIPIndex(x, dtype=torch.int8)
    pio.write_index(w1, os.path.join(out, "flat_w1.npz"))
    workers.spawn(sw.sharded_index_worker, 2, out, timeout=200.0)
    return dict(out=out, data=data, w1_file_index=w1,
                ranks=[workers.load(out, f"index_{r}.pt") for r in range(2)])


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])


def _equal(a, b):
    """Nested results (tuples and lists of arrays and numbers) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _equal(a[key], b[key])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_every_rank_returns_the_same(run):
    _equal(run["ranks"][0], run["ranks"][1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_equals_one_process_bit_for_bit(run, dtype):
    """Indices and scores of every search, stored rows after every
    mutation and the range searches: W = 2 as W = 1."""
    one = sw.flat_ops(run["data"], dtype, None)
    got = run["ranks"][0][dtype]
    assert got.keys() == one.keys()
    for key in got:
        _equal(got[key], one[key])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_matches_jax_on_a_two_device_mesh(run, mesh2, dtype):
    data, got = run["data"], run["ranks"][0][dtype]
    x, q = data["x"], data["q"]
    jdt = getattr(jnp, dtype)
    j = JaxFlat(x, mesh2, dtype=jdt)
    _same_hits(got["search"], j.search(q, k=11))
    _same_hits(got["search_all"], j.search(q, k=len(x)))
    _same_hits(got["from_sharded"], JaxFlat.from_sharded(
        jnp.asarray(np.concatenate([x, np.zeros((1, 64), np.float32)])), len(x), mesh2,
        dtype=jdt).search(q, k=11))
    # exact ties: the whole index order is FAISS's lowest id first
    jt = JaxFlat(data["ties"], mesh2, dtype=jdt).search(data["tq"], k=25)
    np.testing.assert_array_equal(got["ties"][1], jt[1])
    np.testing.assert_array_equal(got["ties"][0], jt[0])
    assert (np.diff(got["ties"][0], axis=1) == 0).any()  # ties cross ranks
    for form, kw in sw.filters(len(x)).items():
        s, i = got[f"filter_{form}"]
        _same_hits((s, i), j.search(q, k=11, **kw))
        np.testing.assert_array_equal(i < 0, ~np.isfinite(s))
    j = JaxFlat.from_sharded(jnp.asarray(x[:200]), 200, mesh2, dtype=jdt)
    for (op, arg, *headroom), (n, rows, hits) in zip(sw.FLAT_CHAIN, got["chain"]):
        if op == "append":
            j = j.append_sharded(jnp.asarray(x[arg[0]:arg[1]]), arg[1] - arg[0],
                                 headroom=headroom[0])
        else:
            j = j.remove_rows(arg)
        assert n == j.ntotal
        np.testing.assert_array_equal(rows, j.reconstruct(np.arange(n)))
        _same_hits(hits, j.search(q, k=11))
    j = JaxFlat(x, mesh2, dtype=jdt)
    for radius, (lims, scores, ids) in zip(sw.RADII, got["range"]):
        ref = j.range_search(q, radius)
        np.testing.assert_array_equal(lims, ref[0])
        np.testing.assert_array_equal(ids, ref[2])
        np.testing.assert_allclose(scores, ref[1], atol=1e-5, rtol=0)


def test_refine_matches_jax_on_a_two_device_mesh(run, mesh2):
    """A carried index (the JAX build's basis and projected rows) searched
    per shard, filtered and mutated as JAX's sharded index; both builds
    tune JAX's C over the shards."""
    data, got = run["data"], run["ranks"][0]["refine"]
    qs, xs = data["qs"], data["xs"]
    with np.load(os.path.join(run["out"], "refine_jax.npz")) as f:
        j = jio.index_from_state(f, mesh2)
    for c in (None, 40, 300):
        _assert_same_hits(*got[f"search_{c}"], *j.search(qs, k=10, candidates=c))
    for form, kw in sw.filters(len(xs)).items():
        s, i = got[f"filter_{form}"]
        ref_s, ref_i = j.search(qs, k=10, **kw)
        np.testing.assert_array_equal(i < 0, ref_i < 0)
        fin = np.isfinite(ref_s)
        np.testing.assert_allclose(s[fin], ref_s[fin], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.sort(i, axis=1), np.sort(ref_i, axis=1))
    for step, (n, rows, hits) in enumerate(got["chain"]):
        if step == 1:
            j = j.remove_rows([0, 5, 999, 1500])
        else:
            lo = 1000 + 100 * step
            j = j.append_sharded(jnp.asarray(data["extra"][lo - 1000:lo - 900]), 100,
                                 headroom=0.5)
        assert n == j.ntotal
        np.testing.assert_array_equal(rows, j.reconstruct(np.arange(n)))
        _assert_same_hits(*hits, *j.search(qs, k=10))
    kw = dict(reduced_dim=12, recall_target=0.9, tune_sample=64, tune_k=10,
              store_dtype=jnp.bfloat16)
    for name, jb in (("built", JaxRefine(xs, mesh2, **kw)),
                     ("built_sharded", JaxRefine.from_sharded(jnp.asarray(xs), len(xs), mesh2,
                                                              **kw))):
        c, proj, hits = got[name]
        assert c == jb.candidates
        sign = np.sign(np.sum(np.asarray(jb.proj) * proj, axis=0))
        np.testing.assert_allclose(proj * sign, np.asarray(jb.proj), atol=PROJ_TOL, rtol=0)
        _assert_same_hits(*hits, *jb.search(qs, k=10))


def test_refine_equals_one_process_where_the_shards_do_not_show(run):
    """The carried refine index at W = 2 and W = 1 store the same rows after
    every mutation (reconstruct bit-equal) and agree on the hits as JAX's
    two do (each shard picks its own C candidates)."""
    one = sw.refine_ops(run["data"], os.path.join(run["out"], "refine_jax.npz"), None)
    got = run["ranks"][0]["refine"]
    for (n1, rows1, hits1), (n2, rows2, hits2) in zip(one["chain"], got["chain"]):
        assert n1 == n2
        np.testing.assert_array_equal(rows1, rows2)
    _assert_same_hits(*got["search_300"], *one["search_300"])


def test_files_move_between_shard_counts(run):
    """A W = 1 file searched at W = 2, and a W = 2 file at W = 1: hits
    identical to the index that wrote it."""
    q = run["data"]["q"]
    _equal(run["ranks"][0]["from_w1_file"], run["w1_file_index"].search(q, k=10))
    w2 = pio.read_index(os.path.join(run["out"], "flat_w2.npz"), device="cpu")
    _equal(w2.search(q, k=10), run["ranks"][0]["w2_file_source"])
    with np.load(os.path.join(run["out"], "flat_w2.npz")) as f:
        import json

        assert json.loads(str(f[pio.CONFIG_KEY]))["tuned_shards"] == 2
