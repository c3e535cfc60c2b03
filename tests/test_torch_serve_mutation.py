"""Serving mutation, persistence, stable ids and request-level filters: the
port's RetrievalService and HTTP endpoints against the JAX package's on the
same tiny weights (after tests/test_serve.py's TestAddPassages,
TestRemovePassages, TestSaveEndpoint and TestStableIds).

One tiny llama checkpoint (written by the JAX package), the hermetic
HashTokenizer and a 24-passage corpus go through both services in fp32 on
the CPU. Tolerance: scores within 1e-5 and equal indices wherever
neighbouring scores differ by more than 1e-5 (tests/test_torch_serve.py).
"""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankpo_tpu.data.tokenization import HashTokenizer as JaxHashTokenizer
from rankpo_tpu.index import InferenceEncoder as JaxEncoder
from rankpo_tpu.models import encoder as jenc
from rankpo_tpu.models import hf_io as jhf
from rankpo_tpu.models.config import tiny_llama_config
from rankpo_tpu.serve import RetrievalService as JaxService
from rankpo_tpu_torch.cli.serve import make_handler
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.serve.service import RetrievalService, finalize_hits

torch.set_num_threads(2)

VOCAB = 256
TOL = 1e-5
N = 24
CORPUS = [f"document {i} on distinct topic {i}" for i in range(N)]
NEW = [f"document {i} on distinct topic {i}" for i in (90, 91, 92)]
QUERIES = [f"document {i} on distinct topic {i}" for i in (1, 7, 20, 91)]

# tier -> (JAX service kwargs, port service kwargs)
TIERS = {
    "flat": ({}, {}),
    "SQ8": ({"index_type": "SQ8"}, {"index_type": "SQ8"}),
    "SQbf16": ({"index_dtype": jnp.bfloat16}, {"index_dtype": torch.bfloat16}),
    "ivf": ({"index_type": "ivf", "index_dtype": jnp.float32,
             "index_kwargs": {"n_clusters": 4, "nprobe": 2}},
            {"index_type": "ivf", "index_dtype": torch.float32,
             "index_kwargs": {"n_clusters": 4, "nprobe": 2}}),
    "pq": ({"index_type": "IVF4,PQ8", "index_kwargs": {"nprobe": 4}},
           {"index_type": "IVF4,PQ8", "index_kwargs": {"nprobe": 4}}),
    "refine": ({"index_type": "refine", "index_dtype": jnp.float32,
                "index_kwargs": {"reduced_dim": 8, "candidates": 12}},
               {"index_type": "refine", "index_dtype": torch.float32,
                "index_kwargs": {"reduced_dim": 8, "candidates": 12}}),
}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = tiny_llama_config(vocab_size=VOCAB)
    params = jenc.init_params(jax.random.key(3), cfg)
    path = tmp_path_factory.mktemp("ckpt")
    jhf.save_pretrained(str(path), cfg, params)
    return str(path), cfg, params


def _port(checkpoint, **kw) -> RetrievalService:
    path = checkpoint[0]
    return RetrievalService(
        InferenceEncoder.from_pretrained(path, tokenizer=HashTokenizer(VOCAB), device="cpu",
                                         compute_dtype=torch.float32),
        max_query_length=16, query_batch_size=8, **kw)


def _jax(checkpoint, **kw) -> JaxService:
    _, cfg, params = checkpoint
    return JaxService(JaxEncoder(cfg, params, JaxHashTokenizer(VOCAB), mesh=None,
                                 compute_dtype=jnp.float32),
                      mesh=None, max_query_length=16, query_batch_size=8, **kw)


def _build(svc, n=N, ids=None):
    svc.build_index(CORPUS[:n], max_passage_length=16, batch_size=8, ids=ids)
    return svc


def _assert_hits_match(port_hits, jax_hits, tol=TOL):
    """``jax_hits`` may hold one rank more than ``port_hits``, so that a
    near-tie across the k boundary is seen."""
    k = len(port_hits)
    assert len(jax_hits) - k in (0, 1)
    ps = np.array([h["score"] for h in port_hits])
    js = np.array([h["score"] for h in jax_hits])
    np.testing.assert_allclose(ps, js[:k], atol=tol, rtol=0)
    gaps = np.abs(np.diff(js))
    for r, (ph, jh) in enumerate(zip(port_hits, jax_hits)):
        near_tie = (r > 0 and gaps[r - 1] <= tol) or (r < len(gaps) and gaps[r] <= tol)
        if not near_tie:
            assert ph["index"] == jh["index"], (r, ph, jh)
            assert ph.get("id") == jh.get("id") and ph["passage"] == jh["passage"]


def _assert_services_match(psvc, jsvc, k=6, **kw):
    assert psvc.ntotal == jsvc.ntotal
    assert psvc.corpus_texts == jsvc.corpus_texts
    np.testing.assert_array_equal(psvc.passage_ids, jsvc.passage_ids)
    for p, j in zip(psvc.query(QUERIES, k=k, **kw), jsvc.query(QUERIES, k=k + 1, **kw)):
        assert len(p["hits"]) == min(k, len(j["hits"]))
        _assert_hits_match(p["hits"], j["hits"][: len(p["hits"]) + 1])


@pytest.mark.parametrize("tier", list(TIERS))
def test_mutations_match_jax(checkpoint, tier):
    """Build, add three passages, remove three positions (one of them an
    added passage): after each step both services hold the same corpus and
    answer the same hits; every added passage retrieves itself at rank 1
    (flat tiers and the refine rerank); the storage dtype is kept."""
    jkw, pkw = TIERS[tier]
    jsvc, psvc = _build(_jax(checkpoint, **jkw)), _build(_port(checkpoint, **pkw))
    _assert_services_match(psvc, jsvc)
    for svc in (jsvc, psvc):
        svc.add_passages(NEW, max_passage_length=16, batch_size=8)
    _assert_services_match(psvc, jsvc)
    if tier in ("flat", "SQ8", "SQbf16"):
        for text, hit in zip(NEW, psvc.query(NEW, k=1)):
            assert hit["hits"][0]["passage"] == text
    for svc in (jsvc, psvc):
        assert svc.remove_passages([1, 5, N + 1]) == 3
    _assert_services_match(psvc, jsvc)
    stored = {"SQ8": torch.int8, "SQbf16": torch.bfloat16}.get(tier)
    if stored is not None:
        assert psvc.index.dtype == stored


@pytest.mark.parametrize("tier", ["flat", "SQ8", "ivf", "refine"])
def test_filters_match_jax(checkpoint, tier):
    """Request-level allowed_ids / disallowed_ids in positional mode: every
    hit allowed, the same hits as the JAX service, and a filter with fewer
    eligible rows than k returns only them."""
    jkw, pkw = TIERS[tier]
    jsvc, psvc = _build(_jax(checkpoint, **jkw)), _build(_port(checkpoint, **pkw))
    allowed = [0, 3, 7, 11, 12, 19, 20, 23]
    _assert_services_match(psvc, jsvc, allowed_ids=allowed)
    _assert_services_match(psvc, jsvc, disallowed_ids=allowed)
    for res in psvc.query(QUERIES, k=6, allowed_ids=allowed):
        assert {h["index"] for h in res["hits"]} <= set(allowed)
    few = psvc.query(QUERIES, k=6, allowed_ids=[4, 9])
    for r in few:  # IVF: only the rows its probes reach
        got = sorted(h["index"] for h in r["hits"])
        assert set(got) <= {4, 9} if tier == "ivf" else got == [4, 9]
    with pytest.raises(ValueError, match="at most one"):
        psvc.query(QUERIES[0], k=3, allowed_ids=[1], disallowed_ids=[2])


def test_stable_ids_match_jax(checkpoint):
    """stable_ids (FAISS IndexIDMap): custom ids at build, removal by
    external id (unknown ids ignored), survivors keep their ids, adds with
    and without ids, filters by external id: as the JAX service."""
    ids = [100 + 3 * i for i in range(N)]
    jsvc = _build(_jax(checkpoint, stable_ids=True), ids=ids)
    psvc = _build(_port(checkpoint, stable_ids=True), ids=ids)
    _assert_services_match(psvc, jsvc)
    hit = psvc.query(QUERIES[1], k=1)["hits"][0]
    assert hit["index"] == 7 and hit["id"] == 121
    for svc in (jsvc, psvc):
        assert svc.remove_passages([103, 106, 99999]) == 2
        assert svc.remove_passages([103]) == 0
    hit = psvc.query(QUERIES[1], k=1)["hits"][0]
    assert hit["index"] == 5 and hit["id"] == 121
    for svc in (jsvc, psvc):
        svc.add_passages(NEW[:1], ids=[500], max_passage_length=16, batch_size=8)
        svc.add_passages(NEW[1:], max_passage_length=16, batch_size=8)
    np.testing.assert_array_equal(psvc.passage_ids[-3:], [500, 501, 502])
    _assert_services_match(psvc, jsvc)
    _assert_services_match(psvc, jsvc, allowed_ids=[121, 500, 502, 4242])
    _assert_services_match(psvc, jsvc, disallowed_ids=[121, 500])
    with pytest.raises(ValueError, match="already present"):
        psvc.add_passages(["dup"], ids=[500], max_passage_length=16, batch_size=8)
    with pytest.raises(ValueError, match="unique"):
        _build(_port(checkpoint, stable_ids=True), n=4, ids=[1, 2, 2, 3])
    with pytest.raises(ValueError, match="match the corpus"):
        _build(_port(checkpoint, stable_ids=True), n=4, ids=[1, 2, 3])


def test_positional_mode_rejects_ids_and_renumbers(checkpoint):
    psvc = _build(_port(checkpoint), n=8)
    assert "id" not in psvc.query(QUERIES[0], k=1)["hits"][0]
    psvc.remove_passages([0])
    np.testing.assert_array_equal(psvc.passage_ids, np.arange(7))
    with pytest.raises(ValueError, match="stable_ids"):
        psvc.add_passages(["doc x"], ids=[100], max_passage_length=16, batch_size=8)
    with pytest.raises(ValueError, match="stable_ids"):
        psvc.build_index(["doc y"], max_passage_length=16, batch_size=8, ids=[0])
    with pytest.raises(ValueError, match="out of range"):
        psvc.remove_passages([7])
    with pytest.raises(ValueError, match="every passage"):
        psvc.remove_passages(list(range(7)))
    # hit decoration comes from the snapshot the search ran on
    res = psvc.query(["document 6 on distinct topic 6"], k=2)[0]
    psvc.remove_passages([0])
    hit = finalize_hits(res, 1)["hits"][0]
    assert hit["passage"] == f"document {hit['index'] + 1} on distinct topic {hit['index'] + 1}"


@pytest.mark.parametrize("tier", ["flat", "SQ8", "SQbf16", "ivf", "refine"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_files_cross_packages(checkpoint, tmp_path, tier, writer):
    """``save_index`` of a mutated stable-ids service loads with
    ``load_index_file`` in the other package: the same corpus, ids and
    hits, storage restored bit-equal (int8 codes and scales included)."""
    jkw, pkw = TIERS[tier]
    ids = [7 * i + 2 for i in range(N)]
    jsvc = _build(_jax(checkpoint, stable_ids=True, **jkw), ids=ids)
    psvc = _build(_port(checkpoint, stable_ids=True, **pkw), ids=ids)
    src, dst = (psvc, jsvc) if writer == "port" else (jsvc, psvc)
    src.remove_passages([2])
    src.add_passages(NEW[:2], max_passage_length=16, batch_size=8)
    path = str(tmp_path / "idx.npz")
    src.save_index(path)
    dst.load_index_file(path)
    restored = psvc.index
    assert restored.ntotal == N + 1
    if tier in ("SQ8", "flat", "SQbf16"):
        np.testing.assert_array_equal(
            restored.reconstruct(np.arange(restored.ntotal)),
            np.asarray(jsvc.index.reconstruct(np.arange(restored.ntotal))))
    _assert_services_match(psvc, jsvc)
    # the restored index keeps mutating as the other package's would
    for svc in (jsvc, psvc):
        svc.add_passages(NEW[2:], max_passage_length=16, batch_size=8)
    _assert_services_match(psvc, jsvc)


def test_load_index_file_checks(checkpoint, tmp_path):
    """A stable-ids file refuses a positional service (an arange map loads
    either way); a file of another kind refuses the configured tier; an
    int8 file restored into a default service keeps int8 through its
    mutations."""
    stable = _build(_port(checkpoint, stable_ids=True), ids=[100 + i for i in range(N)])
    stable.save_index(str(tmp_path / "stable.npz"))
    positional = _port(checkpoint)
    with pytest.raises(ValueError, match="--stable_ids"):
        positional.load_index_file(str(tmp_path / "stable.npz"))
    _build(_port(checkpoint, stable_ids=True), ids=list(range(N))).save_index(
        str(tmp_path / "arange"))
    positional.load_index_file(str(tmp_path / "arange.npz"))
    assert positional.ntotal == N
    with pytest.raises(ValueError, match="index_type"):
        _port(checkpoint, index_type="ivf").load_index_file(str(tmp_path / "arange.npz"))
    _build(_port(checkpoint, index_dtype=torch.int8)).save_index(str(tmp_path / "i8.npz"))
    svc = _port(checkpoint)
    svc.load_index_file(str(tmp_path / "i8.npz"))
    codes = svc.index.corpus[4:N].clone()
    svc.remove_passages([0, 1, 2, 3])
    assert svc.index.dtype == torch.int8
    assert torch.equal(svc.index.corpus[: N - 4], codes)  # gathered, not requantized
    svc.add_passages(NEW[:1], max_passage_length=16, batch_size=8)
    assert svc.index.dtype == torch.int8


@pytest.mark.parametrize("tier", ["flat", "ivf", "refine"])
def test_legacy_file_matches_jax(checkpoint, tmp_path, tier):
    """The JAX service's legacy format (raw embeddings, texts and tuned
    knobs): both packages rebuild from it, reusing the saved nprobe or
    candidate count, and answer the same hits."""
    jkw, pkw = TIERS[tier]
    emb = _build(_port(checkpoint)).index.rows()
    data = {"embeddings": emb, "corpus_texts": np.asarray(CORPUS, dtype=object)}
    if tier == "ivf":
        data.update(ivf_nprobe=np.asarray(3), ivf_n_clusters=np.asarray(4))
    if tier == "refine":
        data.update(refine_candidates=np.asarray(10), refine_reduced_dim=np.asarray(8))
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **data)
    jkw = {**jkw, "index_kwargs": {k: v for k, v in jkw.get("index_kwargs", {}).items()
                                   if k not in ("nprobe", "candidates")}}
    pkw = {**pkw, "index_kwargs": dict(jkw["index_kwargs"])}
    jsvc, psvc = _jax(checkpoint, **jkw), _port(checkpoint, **pkw)
    for svc in (jsvc, psvc):
        svc.load_index_file(path)
    if tier == "ivf":
        assert psvc.index.nprobe == jsvc.index.nprobe == 3
    if tier == "refine":
        assert psvc.index.candidates == jsvc.index.candidates == 10
    _assert_services_match(psvc, jsvc)


def test_load_and_adopt_place_rows_on_the_encoder_device(checkpoint):
    """``load_index`` builds over host embeddings on the encoder's device,
    as the JAX constructors build (host int8 rounding); ``adopt_index``
    takes external ids and checks the row count."""
    from rankpo_tpu_torch.index.flat import FlatIPIndex

    ref = _build(_port(checkpoint))
    emb = ref.index.rows()
    jsvc = _jax(checkpoint, index_dtype=jnp.int8, stable_ids=True)
    psvc = _port(checkpoint, index_dtype=torch.int8, stable_ids=True)
    ids = np.arange(N) * 2
    for svc in (jsvc, psvc):
        svc.load_index(emb, CORPUS, ids=ids)
    assert psvc.index.device == psvc.encoder.device
    np.testing.assert_array_equal(psvc.index.row_scale.numpy()[:N],
                                  np.asarray(jsvc.index.row_scale)[:N])
    _assert_services_match(psvc, jsvc)
    psvc.adopt_index(FlatIPIndex(emb), CORPUS, ids=ids + 1)
    assert psvc.query(QUERIES[1], k=1)["hits"][0]["id"] == 15
    with pytest.raises(ValueError, match="rows"):
        psvc.adopt_index(FlatIPIndex(emb), CORPUS[:-1])


def test_index_without_device_mutation_is_rebuilt(checkpoint):
    """An adopted index that has no ``append_sharded`` / ``remove_rows``
    is rebuilt from its decoded rows with its storage knobs
    (``_rebuild_overrides``), as the JAX service's host fallback does."""

    class ReadOnly:  # search and decode only
        def __init__(self, index):
            self.inner, self.dim, self.dtype = index, index.dim, index.dtype
            self.device, self.ntotal = index.device, index.ntotal

        def search_tensor(self, queries, k, **kw):
            return self.inner.search_tensor(queries, k, **kw)

        def reconstruct(self, ids):
            return self.inner.reconstruct(ids)

    ref = _build(_port(checkpoint, index_dtype=torch.bfloat16))
    svc = _port(checkpoint)  # an fp32 service: the rebuild keeps the bf16 rows
    svc.adopt_index(ReadOnly(ref.index), CORPUS)
    svc.add_passages(NEW[:1], max_passage_length=16, batch_size=8)
    assert type(svc.index).__name__ == "FlatIPIndex" and svc.index.dtype == torch.bfloat16
    assert svc.query(NEW[0], k=1)["hits"][0]["index"] == N
    svc.adopt_index(ReadOnly(svc.index), svc.corpus_texts)
    assert svc.remove_passages([0]) == 1 and svc.ntotal == N
    ref.add_passages(NEW[:1], max_passage_length=16, batch_size=8)
    ref.remove_passages([0])
    for p, r in zip(svc.query(QUERIES, k=5), ref.query(QUERIES, k=5)):
        assert [h["index"] for h in p["hits"]] == [h["index"] for h in r["hits"]]


def test_rewarm_after_mutation(checkpoint):
    """rewarm_after_mutation replays the last warmup inside each mutation
    (the port keeps no compiled programs to carry over)."""
    svc = _build(_port(checkpoint, rewarm_after_mutation=True), n=8)
    svc.remove_passages([0])  # no warmup yet: nothing to replay
    svc.warmup(k=3)
    calls = []
    orig = svc.warmup
    svc.warmup = lambda **kw: calls.append(kw) or orig(**kw)
    svc.remove_passages([0])
    svc.add_passages(NEW[:1], max_passage_length=16, batch_size=8)
    assert calls == [{"k": 3}, {"k": 3}]
    with pytest.raises(ValueError, match="mutation_headroom"):
        _port(checkpoint, mutation_headroom=-1.0)


def test_mutation_headroom_sizes_the_grown_storage(checkpoint):
    """An add that outgrows the storage pre-pays ``mutation_headroom`` of
    extra rows; the next add fits them (written in place)."""
    svc = _build(_port(checkpoint, index_dtype=torch.bfloat16, mutation_headroom=0.5), n=8)
    assert svc.index.n_padded == 8
    svc.add_passages(NEW[:1], max_passage_length=16, batch_size=8)
    grown = svc.index
    assert grown.n_padded == 14  # ceil(9 * 1.5)
    svc.add_passages(NEW[1:], max_passage_length=16, batch_size=8)
    assert svc.index.corpus is grown.corpus and svc.index.ntotal == 11
    # the earlier snapshot still searches its own 9 rows
    assert grown.search(grown.reconstruct([8]), k=1)[1][0, 0] == 8


# ---------------------------------------------------------------------------
def _serve(service, **kw):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service, None, k_max=10, **kw))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _post(port, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_add_remove_save(checkpoint, tmp_path):
    """/add, /remove and /save with --autosave: status codes and bodies as
    the JAX handler's; a restart from the autosaved file sees each
    mutation; bad requests are 400 and leave the index as it was."""
    svc = _build(_port(checkpoint, stable_ids=True), n=16)
    index_file = str(tmp_path / "live.npz")
    server, port = _serve(svc, index_file=index_file, autosave=True)
    try:
        assert _post(port, "/add", {"passages": NEW[:1], "ids": [777]}) == (
            200, {"status": "ok", "ntotal": 17, "saved": index_file})
        status, body = _post(port, "/search", {"query": NEW[0], "k": 1})
        assert status == 200 and body["results"][0]["hits"][0]["id"] == 777
        restarted = _port(checkpoint, stable_ids=True)
        restarted.load_index_file(index_file)
        assert restarted.ntotal == 17 and restarted.passage_ids[-1] == 777
        assert _post(port, "/remove", {"ids": [0, 99999]}) == (
            200, {"status": "ok", "ntotal": 16, "removed": 1, "saved": index_file})
        restarted.load_index_file(index_file)
        assert restarted.ntotal == 16 and 0 not in restarted.passage_ids
        alt = str(tmp_path / "alt.npz")
        assert _post(port, "/save", {"path": alt}) == (
            200, {"status": "ok", "saved": alt, "ntotal": 16})
        assert os.path.exists(alt)
        assert _post(port, "/save")[1]["saved"] == index_file
        status, body = _post(port, "/add", {"passages": ["x"], "ids": [777]})
        assert status == 400 and "already present" in body["error"]
        status, body = _post(port, "/add", {"texts": ["x"]})
        assert status == 400 and "passages" in body["error"]
        status, body = _post(port, "/remove", {})
        assert status == 400 and "ids" in body["error"]
        status, body = _post(port, "/search", {"query": NEW[0], "k": 3,
                                               "allowed_ids": [777, 5]})
        assert status == 200 and {h["id"] for h in body["results"][0]["hits"]} == {777, 5}
        assert svc.ntotal == 16
    finally:
        server.shutdown()
        server.server_close()


def test_http_positional_remove_and_save_errors(checkpoint):
    svc = _build(_port(checkpoint), n=8)
    server, port = _serve(svc)
    try:
        assert _post(port, "/remove", {"ids": [0]}) == (
            200, {"status": "ok", "ntotal": 7, "removed": 1})
        status, body = _post(port, "/remove", {"ids": [10**6]})
        assert status == 400 and "out of range" in body["error"]
        status, body = _post(port, "/save")
        assert status == 400 and "no save target" in body["error"]
    finally:
        server.shutdown()
        server.server_close()


def test_http_autosave_failure_reports_committed_mutation(checkpoint, tmp_path,
                                                          monkeypatch):
    """A failed autosave after a committed mutation is a 500 carrying
    ``mutated`` true, not a 400 inviting a retry."""
    svc = _build(_port(checkpoint), n=8)

    def boom(path):
        raise OSError("disk full")

    monkeypatch.setattr(svc, "save_index", boom)
    server, port = _serve(svc, index_file=str(tmp_path / "x.npz"), autosave=True)
    try:
        status, body = _post(port, "/add", {"passages": ["doc 71 topic 71"]})
        assert status == 500 and body["mutated"] is True and "disk full" in body["error"]
        assert body["ntotal"] == svc.ntotal == 9
    finally:
        server.shutdown()
        server.server_close()
