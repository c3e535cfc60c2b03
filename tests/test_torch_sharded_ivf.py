"""The IVF tier with its clusters sharded over two gloo processes (the
PyTorch port's ``IVFIPIndex(group=)`` and ``IVFIPIndex.from_sharded(group=)``)
against the JAX package's ``IVFIPIndex`` on a 2-device data mesh, on numpy
inputs from a seed (2000 blob rows at D 64, 24 queries).

The workers (``torch_serve_workers.sharded_ivf_worker``, joined with a
timeout of their own) build each variant of ``IVF_BUILDS`` (bf16, fp32 and
int8 rows; the constructor and ``from_sharded``; ``balance_eta``;
``kmeans_split``) and search it. Tolerances are those of
``tests/test_torch_ivf.py``: the cluster count, capacity, clusters per
shard, ``row_ids`` and the tuned nprobe equal; centroids within 1e-5 (fp32
sums in another order); bf16 rows, int8 codes and their scales bit-equal
shard by shard; search indices equal wherever neighbouring reference scores
differ by more than 1e-5, scores within 1e-5, filtered and at a per-call
nprobe too. Empty slots are zero rows on both sides (JAX's
``from_sharded`` writes row 0 times 0 there, so its zeros keep row 0's
signs; the port writes +0). Probing every cluster of each shard gives the
sharded exact search's hits. Both ranks return the same arrays. Files move between one
and two shards with the total of probed clusters kept, and a file the JAX
package wrote on its mesh loads at W = 2 with JAX's hits. What is left of
the tier (ROADMAP.md item 8c-ii) raises at W = 2.
"""

import json
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
from rankpo_tpu.index import ivf as jivf
from rankpo_tpu_torch.index import io as pio
from rankpo_tpu_torch.index import ivf as pivf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
import torch_serve_workers as sw  # noqa: E402
from test_torch_ivf import TOL, _assert_same_hits, _corpus_queries, _storage_bits  # noqa: E402
from test_torch_sharded_index import _equal  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])


@pytest.fixture(scope="module")
def run(tmp_path_factory, mesh2):
    out = str(tmp_path_factory.mktemp("sharded_ivf"))
    x, q = _corpus_queries(n=2000, n_q=24, d=64, seed=3)
    rng = np.random.default_rng(4)
    data = dict(ivf_x=x, ivf_q=q, ivf_allowed=np.sort(rng.choice(len(x), 600, replace=False)),
                ivf_recon_ids=rng.choice(len(x), 50))
    workers.save(out, "ivf_data.pt", data)
    # the files the ranks load: the port's at W = 1 (probing 4 of 16
    # clusters, then every one), a PQ one, and the JAX package's on its mesh
    w1 = pivf.IVFIPIndex(x, n_clusters=16, nprobe=4, store_dtype=torch.float32)
    pio.write_index(w1, os.path.join(out, "ivf_w1_partial.npz"))
    w1.nprobe = 16
    pio.write_index(w1, os.path.join(out, "ivf_w1_full.npz"))
    pio.write_index(pivf.IVFIPIndex(x[:400], n_clusters=8, nprobe=2, pq_m=8),
                    os.path.join(out, "ivf_pq_w1.npz"))
    jm = jivf.IVFIPIndex(x, mesh2, n_clusters=16, nprobe=3)
    pio.save_state(jio.index_state(jm), os.path.join(out, "ivf_jax_mesh2.npz"))
    workers.spawn(sw.sharded_ivf_worker, 2, out, timeout=200.0)
    return dict(out=out, data=data, w1=w1, jax_mesh2=jm,
                ranks=[workers.load(out, f"ivf_{r}.pt") for r in range(2)])


_JAX_BUILDS = {}


def _jax_build(name, x, mesh2):
    """JAX's build of ``IVF_BUILDS[name]`` on the mesh (made once)."""
    if name not in _JAX_BUILDS:
        how, kw = sw.IVF_BUILDS[name]
        kw = {k: getattr(jnp, v) if k == "store_dtype" else v for k, v in kw.items()}
        if how == "ctor":
            _JAX_BUILDS[name] = jivf.IVFIPIndex(x, mesh2, **sw.IVF_COMMON, **kw)
        else:
            _JAX_BUILDS[name] = jivf.IVFIPIndex.from_sharded(jnp.asarray(x), len(x), mesh2,
                                                             **sw.IVF_COMMON, **kw)
    return _JAX_BUILDS[name]


def test_every_rank_returns_the_same(run):
    _equal(run["ranks"][0]["shared"], run["ranks"][1]["shared"])


@pytest.mark.parametrize("name", list(sw.IVF_BUILDS))
def test_build_matches_jax_on_a_two_device_mesh(run, mesh2, name):
    """K, capacity, clusters per shard, the tuned nprobe and ``row_ids``
    equal; each rank holds JAX's shard of the storage bit for bit."""
    j = _jax_build(name, run["data"]["ivf_x"], mesh2)
    got = run["ranks"][0]["shared"][name]
    assert got["knobs"] == (j.n_clusters, j.capacity, j.local_clusters, j.nprobe)
    assert j.n_clusters % 2 == 0 and j.local_clusters == j.n_clusters // 2
    local = [r["local"][name] for r in run["ranks"]]
    cat = {key: np.concatenate([part[key] for part in local]) for key in local[0]}
    np.testing.assert_array_equal(cat["row_ids"], np.asarray(j.row_ids))
    np.testing.assert_allclose(cat["centroids"], np.asarray(j.centroids), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["centroids_host"], cat["centroids"])
    # filled slots bit for bit; empty slots are zero rows in both (JAX's
    # from_sharded multiplies row 0 by 0 there, which keeps its signs: -0.0)
    filled = cat["row_ids"] >= 0
    np.testing.assert_array_equal(cat["corpus"][filled], _storage_bits(j.corpus)[filled])
    assert not np.asarray(j.corpus, np.float32)[~filled].any()
    assert not cat["corpus"][~filled].any()
    if "slot_scale" in cat:
        np.testing.assert_array_equal(cat["slot_scale"], np.asarray(j.slot_scale))
    if j.assign_bias is not None:
        assert got["knobs"][0] == len(np.asarray(j.assign_bias))


@pytest.mark.parametrize("name", list(sw.IVF_BUILDS))
def test_search_matches_jax_on_a_two_device_mesh(run, mesh2, name):
    data = run["data"]
    q, allowed = data["ivf_q"], data["ivf_allowed"]
    j = _jax_build(name, data["ivf_x"], mesh2)
    got = run["ranks"][0]["shared"][name]
    _assert_same_hits(*got["search"], *j.search(q, k=20), TOL)
    _assert_same_hits(*got["nprobe_2"], *j.search(q, k=20, nprobe=2), TOL)
    s, i = got["filtered"]
    ref_s, ref_i = j.search(q, k=20, allowed_ids=allowed)
    _assert_same_hits(s, i, ref_s, ref_i, TOL)
    np.testing.assert_array_equal(i < 0, ref_i < 0)
    assert np.isin(i[i >= 0], allowed).all()
    _assert_same_hits(*got["exact"], *j.exact_search(q, k=20), TOL)
    # the filtered exact search: JAX's whole exact ranking, cut to the allowed
    all_s, all_i = j.exact_search(q, k=len(data["ivf_x"]))
    keep = np.isin(all_i, allowed)
    ref_s = np.stack([row[m][:20] for row, m in zip(all_s, keep)])
    ref_i = np.stack([row[m][:20] for row, m in zip(all_i, keep)])
    _assert_same_hits(*got["exact_filtered"], ref_s, ref_i, TOL)
    np.testing.assert_array_equal(got["reconstruct"], j.reconstruct(data["ivf_recon_ids"]))


@pytest.mark.parametrize("name", list(sw.IVF_BUILDS))
def test_full_probe_is_the_sharded_exact_search(run, name):
    """Every cluster of each shard probed: the exact search over the stored
    rows (JAX's ``test_sharded_full_probe_exact``)."""
    got = run["ranks"][0]["shared"][name]
    _assert_same_hits(*got["full"], *got["exact"], TOL)
    assert (got["full"][1] >= 0).all() and int(got["full"][1].max()) < 2000


def test_files_move_between_shard_counts(run, mesh2):
    """The total of probed clusters is kept: a W = 1 file probing 4 of 16
    clusters probes 2 of 8 on each of two shards, JAX's mesh file 3 a shard
    as JAX tuned it, and a W = 2 file probing p a shard probes 2p in one
    process; each search equals JAX's over the same file at that width, and
    probing every cluster gives the writer's hits. A rank keeps the rows of
    its own clusters alone, not the whole file's."""
    q, shared, out = run["data"]["ivf_q"], run["ranks"][0]["shared"], run["out"]
    for r in range(2):
        for name in sw.IVF_FILES:
            kept, own = run["ranks"][r]["local"][f"file_{name}"]
            assert kept == own, (r, name, kept, own)
    with np.load(os.path.join(out, "ivf_w1_partial.npz")) as f:
        jpart = jio.index_from_state(f, mesh2)
    p, local, hits, full = shared["file_w1_partial"]
    assert (p, local) == (2, 8) == (jpart.nprobe, jpart.local_clusters)
    _assert_same_hits(*hits, *jpart.search(q, k=20), TOL)
    w1_full = run["w1"].search(q, k=20, nprobe=16)
    _assert_same_hits(*full, *w1_full, TOL)
    p, local, hits, _ = shared["file_w1_full"]
    assert (p, local) == (8, 8)
    _assert_same_hits(*hits, *w1_full, TOL)
    p, local, hits, _ = shared["file_jax_mesh2"]
    assert (p, local) == (3, 8)
    _assert_same_hits(*hits, *run["jax_mesh2"].search(q, k=20), TOL)
    # the W = 2 file in one process
    path = os.path.join(out, "ivf_w2.npz")
    with np.load(path) as f:
        assert json.loads(str(f[pio.CONFIG_KEY]))["tuned_shards"] == 2
        jone = jio.index_from_state(f, None)
    one = pio.read_index(path, device="cpu")
    p2, w2_hits, w2_full = shared["w2_file_source"]
    assert one.nprobe == min(2 * p2, one.n_clusters) == jone.nprobe
    _assert_same_hits(*one.search(q, k=20), *jone.search(q, k=20), TOL)
    _equal(one.search(q, k=20, nprobe=one.n_clusters), w2_full)


@pytest.mark.parametrize("name", ["pq", "hybrid", "append", "remove", "filtered_tune",
                                  "pq_file", "autotune"])
def test_what_is_left_raises_at_two_ranks(run, name):
    for r in range(2):
        msg = run["ranks"][r]["refusals"][name]
        assert "item 8c-ii" in msg and "not ported" in msg, msg
