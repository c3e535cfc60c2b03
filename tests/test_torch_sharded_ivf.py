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
package wrote on its mesh loads at W = 2 with JAX's hits.

PQ codes (rows layout; a random and an OPQ rotation) and the PCA hybrid,
each built by the constructor or ``from_sharded`` (``IVF_CODEC_BUILDS``):
K, capacity, clusters a rank, the tuned nprobe, the layout and ``row_ids``
equal JAX's; PQ codes agree with JAX's in at least 99% of the filled slots'
entries, shard by shard (the codebook Lloyd sums in another order, and one
flipped argmin moves a codeword; an empty slot holds the zero residual's
code, as one device writes it, where JAX's ``from_sharded`` encodes minus
the centroid); OPQ's in 95%, the limit one process is held to, and in 99%
against JAX's fit of the ranks' own residual sample; every rank holds the
same codebooks, rotation and PCA basis.
Searched through JAX's file of the same build loaded at W = 2, the hits,
exact search and reconstruct hold to JAX's at the tolerances above;
probing every cluster gives the sharded exact search. The mutation chain
(an append of 1100 rows that grows every cluster, then a removal) on a
JAX mesh file of bf16 rows, int8 rows and PQ codes equals JAX's
``append_sharded`` / ``remove_rows`` on its mesh: capacity and ``row_ids``
equal, the filled slots' storage bit-equal (PQ codes in 99% of entries),
the searches within the tolerances. PQ and hybrid files move between one
process and two. 'cols' codes raise on a group and 'auto' picks rows. The
filtered tuner (the port's own option) stays one device's and raises.
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
from test_torch_ivf import (OPQ_BUILD_AGREEMENT, TOL, _assert_same_hits,  # noqa: E402
                            _corpus_queries, _storage_bits)
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
                ivf_recon_ids=rng.choice(len(x), 50),
                ivf_extra=_corpus_queries(n=sw.IVF_MUTATION["append"], n_q=0, d=64,
                                          seed=8)[0])
    workers.save(out, "ivf_data.pt", data)
    # the files the ranks load: the port's at W = 1 (probing 4 of 16
    # clusters, then every one), a PQ one, and the JAX package's on its mesh
    w1 = pivf.IVFIPIndex(x, n_clusters=16, nprobe=4, store_dtype=torch.float32)
    pio.write_index(w1, os.path.join(out, "ivf_w1_partial.npz"))
    w1.nprobe = 16
    pio.write_index(w1, os.path.join(out, "ivf_w1_full.npz"))
    w1_codecs = {}
    for name, kw in sw.IVF_W1_CODECS.items():
        w1_codecs[name] = pivf.IVFIPIndex(x, n_clusters=16, nprobe=4, kmeans_iters=5, **kw)
        pio.write_index(w1_codecs[name], os.path.join(out, f"ivf_w1_{name}.npz"))
    jm = jivf.IVFIPIndex(x, mesh2, n_clusters=16, nprobe=3)
    pio.save_state(jio.index_state(jm), os.path.join(out, "ivf_jax_mesh2.npz"))
    for name in sw.IVF_CODEC_BUILDS:
        pio.save_state(jio.index_state(_jax_codec(name, x, mesh2)),
                       os.path.join(out, f"ivf_jax_{name}.npz"))
    for name in sw.IVF_MUTATED:
        pio.save_state(jio.index_state(_jax_mutation_base(name, x, mesh2, jm)),
                       os.path.join(out, f"ivf_jax_mut_{name}.npz"))
    workers.spawn(sw.sharded_ivf_worker, 2, out, timeout=300.0)
    return dict(out=out, data=data, w1=w1, jax_mesh2=jm, w1_codecs=w1_codecs, mesh2=mesh2,
                ranks=[workers.load(out, f"ivf_{r}.pt") for r in range(2)])


_JAX_BUILDS = {}
_JAX_CODECS = {}
_JAX_MUTATED = {}


def _jax_codec(name, x, mesh2):
    """JAX's build of ``IVF_CODEC_BUILDS[name]`` on the mesh (made once)."""
    if name not in _JAX_CODECS:
        how, kw = sw.IVF_CODEC_BUILDS[name]
        if how == "ctor":
            _JAX_CODECS[name] = jivf.IVFIPIndex(x, mesh2, **sw.IVF_COMMON, **kw)
        else:
            _JAX_CODECS[name] = jivf.IVFIPIndex.from_sharded(jnp.asarray(x), len(x), mesh2,
                                                             **sw.IVF_COMMON, **kw)
    return _JAX_CODECS[name]


def _jax_mutation_base(name, x, mesh2, bf16):
    """The JAX mesh index each mutation chain starts from (K 16)."""
    if name == "bf16":
        return bf16
    kw = {"store_dtype": jnp.int8} if name == "int8" else {"pq_m": 8, "pq_iters": 10}
    return jivf.IVFIPIndex(x, mesh2, n_clusters=16, nprobe=3, kmeans_iters=5, **kw)


def _jax_chain(run, name):
    """JAX's append_sharded then remove_rows on its mesh index of the same
    file the ranks mutated (loaded on the mesh, made once)."""
    if name not in _JAX_MUTATED:
        extra = run["data"]["ivf_extra"]
        with np.load(os.path.join(run["out"], f"ivf_jax_mut_{name}.npz")) as f:
            j = jio.index_from_state(f, run["mesh2"])
        grown = j.append_sharded(extra, len(extra))
        removed = grown.remove_rows(np.arange(0, grown.ntotal, sw.IVF_MUTATION["remove_step"]))
        _JAX_MUTATED[name] = (grown, removed)
    return _JAX_MUTATED[name]


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


@pytest.mark.parametrize("name", ["filtered_tune"])
def test_what_is_left_raises_at_two_ranks(run, name):
    """The filtered tuner is the port's own option (JAX has none) and stays
    one device's by design: it raises at W = 2 and names no open item."""
    for r in range(2):
        msg = run["ranks"][r]["refusals"][name]
        assert "runs on one device" in msg and "pass an int nprobe" in msg, msg
        assert "8c" not in msg and "not ported" not in msg, msg


# OPQ's eight alternations of a Lloyd fit and a Procrustes rotation carry
# the fp32 sum-order differences into the rotation: its codes agree with
# JAX's in fewer of the filled entries than plain PQ's do, in one process
# (tests/test_torch_ivf.py ``test_opq_build_matches_jax_in_one_process``)
# as over the group, and its tuned nprobe may differ by one
CODE_AGREEMENT = {"pq_opq": OPQ_BUILD_AGREEMENT}


def _filled_codes_agree(got, want, row_ids, name):
    """PQ codes of the filled slots: at least 99% of entries equal (OPQ:
    ``CODE_AGREEMENT``)."""
    filled = row_ids >= 0
    same = got[filled] == want[filled]
    assert same.mean() >= CODE_AGREEMENT.get(name, 0.99), (name, same.mean())


def _full_probe_holds(full, exact, pq: bool):
    """Every cluster probed gives the sharded exact search at storage
    precision; PQ's ADC scores sum otherwise than its decoded rows, so
    there recall@20 against it is at least 0.95 (JAX's
    ``test_sharded_build_and_search``)."""
    if not pq:
        _assert_same_hits(*full, *exact, TOL)
        return
    hits = [len(set(a[a >= 0]) & set(b[b >= 0])) / len(b) for a, b in zip(full[1], exact[1])]
    assert np.mean(hits) >= 0.95, np.mean(hits)


@pytest.mark.parametrize("name", list(sw.IVF_CODEC_BUILDS))
def test_codec_build_matches_jax_on_a_two_device_mesh(run, mesh2, name):
    """K, capacity, clusters a rank, the tuned nprobe, the layout and
    ``row_ids`` equal JAX's; PQ codes in 99% of the filled slots' entries
    shard by shard, the hybrid's bf16 rows bit-equal; every rank holds the
    same codebooks, rotation and PCA basis."""
    j = _jax_codec(name, run["data"]["ivf_x"], mesh2)
    got = run["ranks"][0]["shared"][f"codec_{name}"]
    assert got["knobs"][:3] == (j.n_clusters, j.capacity, j.local_clusters)
    assert abs(got["knobs"][3] - j.nprobe) <= (1 if name in CODE_AGREEMENT else 0)
    assert got["layout"] == j.pq_layout and (j.pq_m is None or j.pq_layout == "rows")
    local = [r["local"][f"codec_{name}"] for r in run["ranks"]]
    row_ids = np.concatenate([part["row_ids"] for part in local])
    np.testing.assert_array_equal(row_ids, np.asarray(j.row_ids))
    jrows = np.asarray(j.row_ids).reshape(2, -1)
    jcodes = _storage_bits(j.corpus)
    for d, part in enumerate(local):
        want = jcodes.reshape(2, -1, jcodes.shape[1])[d]
        if j.pq_m is not None:
            _filled_codes_agree(part["corpus"], want, jrows[d], name)
        else:
            filled = jrows[d] >= 0
            np.testing.assert_array_equal(part["corpus"][filled], want[filled])
    for key in ("_codebooks_host", "_rotation_host", "proj"):
        if key in local[0]:
            np.testing.assert_array_equal(local[0][key], local[1][key])
    if j.pq_rotate != "none":
        assert "_rotation_host" in local[0]


def test_opq_codes_at_two_ranks_are_jax_fit_of_their_sample(run):
    """The OPQ codes the two ranks hold against JAX's OPQ fit of the same
    residual sample (the sample slots of the global ``row_ids``, rows less
    the ranks' centroids), encoded by JAX: at least 99% of the filled
    slots' entries equal. The sample's exchange, rank 0's fit and its
    broadcast, and the per-shard encode add nothing to what the two fits'
    sum orders give; the lower agreement with JAX's own mesh build
    (``CODE_AGREEMENT``) comes from its centroids, an ulp away from the
    ranks', fed through the fit."""
    x = run["data"]["ivf_x"]
    local = [r["local"]["codec_pq_opq"] for r in run["ranks"]]
    row_ids = np.concatenate([part["row_ids"] for part in local])
    centroids = np.concatenate([part["centroids"] for part in local])
    cap = run["ranks"][0]["shared"]["codec_pq_opq"]["knobs"][1]
    kw = sw.IVF_CODEC_BUILDS["pq_opq"][1]
    slots = pivf.IVFIPIndex._pq_sample_slot_ids(row_ids, 0)
    ref = object.__new__(jivf.IVFIPIndex)
    ref.__dict__.update(dim=x.shape[1], pq_m=kw["pq_m"], pq_iters=kw["pq_iters"],
                        pq_rotate="opq", _place_codebooks=lambda: None)
    ref._fit_pq_codebooks((x[row_ids[slots]] - centroids[slots // cap]).astype(np.float32), 0)
    filled = np.nonzero(row_ids >= 0)[0]
    residuals = (x[row_ids[filled]] - centroids[filled // cap]).astype(np.float32)
    want = np.asarray(jivf._pq_encode_block(jnp.asarray(residuals),
                                            jnp.asarray(ref._codebooks_host),
                                            jnp.asarray(ref._rotation_host)))
    got = np.concatenate([part["corpus"] for part in local])[filled]
    assert (got == want).mean() >= 0.99, (got == want).mean()


@pytest.mark.parametrize("name", list(sw.IVF_CODEC_BUILDS))
def test_codec_search_through_jax_file_at_two_ranks(run, mesh2, name):
    """JAX's mesh build of each codec, written by JAX and loaded at W = 2 in
    the port: its search, exact search and reconstruct hold to JAX's; the
    codebooks reach every rank whole."""
    q, ids = run["data"]["ivf_q"], run["data"]["ivf_recon_ids"]
    j = _jax_codec(name, run["data"]["ivf_x"], mesh2)
    got = run["ranks"][0]["shared"][f"jax_file_{name}"]
    assert got["nprobe"] == j.nprobe
    _assert_same_hits(*got["search"], *j.search(q, k=20, batch_size=16), TOL)
    _assert_same_hits(*got["exact"], *j.exact_search(q, k=20), TOL)
    _assert_same_hits(*got["full"], *j.search(q, k=20, nprobe=j.local_clusters,
                                              candidates=j.local_clusters * j.capacity), TOL)
    np.testing.assert_allclose(got["reconstruct"], j.reconstruct(ids), atol=1e-5, rtol=0)
    if j.pq_m is not None:
        np.testing.assert_array_equal(got["replicated"], j._codebooks_host)


@pytest.mark.parametrize("name", list(sw.IVF_CODEC_BUILDS))
def test_codec_full_probe_is_the_sharded_exact_search(run, name):
    got = run["ranks"][0]["shared"][f"codec_{name}"]
    _full_probe_holds(got["full"], got["exact"], name.startswith("pq"))
    assert (got["full"][1] >= 0).all() and int(got["full"][1].max()) < 2000


@pytest.mark.parametrize("name", sw.IVF_MUTATED)
def test_mutation_matches_jax_on_a_two_device_mesh(run, name):
    """An append that grows every cluster's capacity, then a removal, on a
    JAX mesh file at W = 2, against JAX's on its mesh: capacity, count and
    ``row_ids`` equal; the filled slots' storage bit-equal (PQ codes in 99%
    of entries); searches, exact search, the appended rows' self-search
    and reconstruct within the tolerances; the appended bf16 rows find
    themselves first."""
    q, ids, extra = (run["data"][k] for k in ("ivf_q", "ivf_recon_ids", "ivf_extra"))
    shared = run["ranks"][0]["shared"][f"mutated_{name}"]
    local = [r["local"][f"mutated_{name}"] for r in run["ranks"]]
    for step, j in enumerate(_jax_chain(run, name)):
        got = shared[step]
        assert (got["capacity"], got["ntotal"]) == (j.capacity, j.n_total)
        row_ids = np.concatenate([part[step]["row_ids"] for part in local])
        np.testing.assert_array_equal(row_ids, np.asarray(j.row_ids))
        jrows = np.asarray(j.row_ids).reshape(2, -1)
        jstore = _storage_bits(j.corpus)
        for d, part in enumerate(local):
            want = jstore.reshape(2, -1, jstore.shape[1])[d]
            filled = jrows[d] >= 0
            if name == "pq":
                _filled_codes_agree(part[step]["corpus"], want, jrows[d], name)
            else:
                np.testing.assert_array_equal(part[step]["corpus"][filled], want[filled])
            if name == "int8":
                np.testing.assert_array_equal(
                    part[step]["slot_scale"][filled],
                    np.asarray(j.slot_scale).reshape(2, -1)[d][filled])
        _assert_same_hits(*got["search"], *j.search(q, k=20, batch_size=16), TOL)
        _assert_same_hits(*got["exact"], *j.exact_search(q, k=20), TOL)
        _full_probe_holds(got["full"], got["exact"], name == "pq")
        np.testing.assert_allclose(got["reconstruct"], j.reconstruct(ids), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["self_hits"], j.search(extra[:50], k=10)[1])
    with np.load(os.path.join(run["out"], f"ivf_jax_mut_{name}.npz")) as f:
        assert shared[0]["capacity"] > json.loads(str(f[pio.CONFIG_KEY]))["capacity"]
    if name == "bf16":  # appended as corpus rows 2000.., each found first
        np.testing.assert_array_equal(shared[0]["self_hits"][:, 0], 2000 + np.arange(50))


@pytest.mark.parametrize("name", list(sw.IVF_W1_CODECS))
def test_codec_files_move_between_one_and_two_processes(run, name):
    """A PQ or hybrid file written at W = 1 (16 clusters, nprobe 4) loads at
    W = 2 probing 2 of 8 a rank, and probing every cluster gives the W = 1
    index's hits; the W = 2 build's file loads at W = 1 with nprobe 2p and,
    probing every cluster, the W = 2 index's full-probe hits."""
    q, out = run["data"]["ivf_q"], run["out"]
    p, local, full = run["ranks"][0]["shared"][f"w1_file_{name}"]
    assert (p, local) == (2, 8)
    _assert_same_hits(*full, *sw.full_probe(run["w1_codecs"][name], q), TOL)
    got = run["ranks"][0]["shared"][f"codec_{name}"]
    one = pio.read_index(os.path.join(out, f"ivf_w2_{name}.npz"), device="cpu")
    assert one.nprobe == min(2 * got["knobs"][3], one.n_clusters)
    assert (one.n_clusters, one.capacity) == got["knobs"][:2]
    _assert_same_hits(*sw.full_probe(one, q), *got["full"], TOL)


@pytest.mark.parametrize("name", sw.IVF_MUTATED)
def test_mutated_file_at_one_process_gives_the_full_probe_hits(run, name):
    """The mutated W = 2 index's file, loaded in one process and probing
    every cluster, gives the W = 2 index's full-probe hits."""
    q = run["data"]["ivf_q"]
    one = pio.read_index(os.path.join(run["out"], f"ivf_w2_mutated_{name}.npz"),
                         device="cpu")
    want = run["ranks"][0]["shared"][f"mutated_{name}"][1]
    assert (one.capacity, one.ntotal) == (want["capacity"], want["ntotal"])
    _assert_same_hits(*sw.full_probe(one, q), *want["full"], TOL)


def test_cols_rejected_on_a_group_and_auto_picks_rows(run):
    """JAX's ``test_cols_rejected_on_mesh``: an explicit 'cols' layout raises
    ValueError over the group, and 'auto' resolves to 'rows'."""
    for r in range(2):
        shared = run["ranks"][r]["shared"]
        assert "single-device" in shared["cols"] and "'rows'" in shared["cols"]
        assert shared["auto_layout"] == "rows"
