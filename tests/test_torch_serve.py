"""The serving slice end to end: the port's RetrievalService and HTTP server
against the JAX package's RetrievalService on the same checkpoint.

One tiny llama checkpoint (written by the JAX package), the hermetic
HashTokenizer and a 50-passage corpus go through both services in fp32 on
the CPU. Tolerance: scores within 1e-5 (fp32 round-off of two frameworks'
summation orders through 2 layers and a 64-wide dot), and equal indices
wherever neighbouring scores differ by more than 1e-5 (inside that band the
order of a near-tie may legitimately flip).
"""

import json
import threading
import urllib.error
import urllib.request

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
from rankpo_tpu_torch.cli import serve as cli
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.serve.service import RetrievalService

torch.set_num_threads(2)

VOCAB = 256
TOL = 1e-5
WORDS = ("retrieval ranking preference model corpus passage query dense "
         "encoder alignment contrastive negative search index score").split()
QUERIES = ["dense retrieval encoder", "preference alignment ranking",
           "contrastive negative passage search", "index", "score corpus query model"]


def _corpus(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(1, 40)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = tiny_llama_config(vocab_size=VOCAB)
    params = jenc.init_params(jax.random.key(7), cfg)
    path = tmp_path_factory.mktemp("ckpt")
    jhf.save_pretrained(str(path), cfg, params)
    corpus = _corpus()
    corpus_file = path / "corpus.jsonl"
    corpus_file.write_text("".join(json.dumps({"text": t}) + "\n" for t in corpus))
    return str(path), cfg, params, corpus, str(corpus_file)


@pytest.fixture(scope="module")
def services(checkpoint):
    path, cfg, params, corpus, _ = checkpoint
    jsvc = JaxService(
        JaxEncoder(cfg, params, JaxHashTokenizer(VOCAB), mesh=None,
                   compute_dtype=jnp.float32),
        mesh=None, max_query_length=32, query_batch_size=8,
    )
    jsvc.build_index(corpus, max_passage_length=48, batch_size=16)
    psvc = RetrievalService(
        InferenceEncoder.from_pretrained(path, tokenizer=HashTokenizer(VOCAB),
                                         device="cpu", compute_dtype=torch.float32),
        max_query_length=32, query_batch_size=8,
    )
    psvc.build_index(corpus, max_passage_length=48, batch_size=16)
    return jsvc, psvc


def _assert_hits_match(port_hits, jax_hits, tol=TOL):
    ps = np.array([h["score"] for h in port_hits])
    js = np.array([h["score"] for h in jax_hits])
    np.testing.assert_allclose(ps, js, atol=tol, rtol=0)
    gaps = np.abs(np.diff(js))
    for r, (ph, jh) in enumerate(zip(port_hits, jax_hits)):
        near_tie = (r > 0 and gaps[r - 1] <= tol) or (r < len(gaps) and gaps[r] <= tol)
        if not near_tie:
            assert ph["index"] == jh["index"], (r, ph, jh)


@pytest.mark.parametrize("k", [1, 10, 50])
def test_query_matches_jax_service(services, k):
    jsvc, psvc = services
    jres = jsvc.query(QUERIES, k=k)
    pres = psvc.query(QUERIES, k=k)
    assert len(pres) == len(QUERIES)
    for p, j in zip(pres, jres):
        assert p["query"] == j["query"] and len(p["hits"]) == len(j["hits"]) == k
        _assert_hits_match(p["hits"], j["hits"])
        for h in p["hits"]:
            assert h["passage"] == psvc.corpus_texts[h["index"]]


def test_single_query_and_k_clamp(services):
    _, psvc = services
    res = psvc.query(QUERIES[0], k=500, return_passages=False)
    assert len(res["hits"]) == psvc.ntotal == 50
    assert "passage" not in res["hits"][0]
    scores = [h["score"] for h in res["hits"]]
    assert scores == sorted(scores, reverse=True)


def test_corpus_embeddings_match_jax(services):
    jsvc, psvc = services
    jemb = np.asarray(jsvc.index.corpus)[: jsvc.ntotal]
    np.testing.assert_allclose(psvc.index.rows(), jemb, atol=1e-4, rtol=0)


def test_encode_restores_order_and_matches_jax(services):
    """Multi-batch encode sorts by length and restores input order."""
    jsvc, psvc = services
    texts = _corpus(n=20, seed=3)
    ref = jsvc.encoder.encode(texts, batch_size=8, max_length=48)
    out = psvc.encoder.encode(texts, batch_size=8, max_length=48)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    one = psvc.encoder.encode(texts[5], max_length=48)
    np.testing.assert_allclose(one, out[5], atol=1e-5, rtol=0)


def test_prepare_batch_filler_rows(services):
    """Filler rows get one attended token (JAX index/encoding.py guard), so
    last-token pooling never reads a row with no valid key."""
    jsvc, psvc = services
    chunk = ["dense retrieval", "query"]
    pb = psvc.encoder.prepare_batch(chunk, 4, 32)
    jb = jsvc.encoder.prepare_batch(chunk, 4, 32)
    np.testing.assert_array_equal(pb["input_ids"], np.asarray(jb["input_ids"]))
    np.testing.assert_array_equal(pb["attention_mask"], np.asarray(jb["attention_mask"]))
    assert pb["attention_mask"][2:].sum(axis=1).tolist() == [1, 1]
    reps = psvc.encoder.embed_batch(pb)
    assert torch.isfinite(reps).all() and reps.shape == (4, 64)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _argv(checkpoint, *extra):
    path, _, _, _, corpus_file = checkpoint
    return ["--model_name_or_path", path, "--tokenizer_name", f"hash:{VOCAB}",
            "--corpus_data", corpus_file, "--max_query_length", "32",
            "--max_passage_length", "48", "--batch_size", "16",
            "--serving_k_max", "20", "--port", "0", *extra]


def test_http_server(checkpoint):
    """Served replies against the server's own service.query. The CLI
    computes in bf16, as the JAX CLI does (the fp32 cross-package check is
    test_query_matches_jax_service), and a micro-batched group pads to its
    longest member, which changes the matmul shapes and so where bf16 rounds:
    scores within 1e-3, indices equal outside 1e-3 near-ties."""
    server = cli.make_server(_argv(checkpoint, "--device", "cpu",
                                   "--log_level", "warning"))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert _get(port, "/healthz") == {"status": "ok", "ntotal": 50}
        # single queries go through the micro-batcher
        results = [None] * 4
        def one(i):
            results[i] = _post(port, "/search", {"query": QUERIES[i], "k": 5})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i, (code, body) in enumerate(results):
            assert code == 200
            direct = server.service.query(QUERIES[i], k=5)
            assert body["results"][0]["query"] == QUERIES[i]
            _assert_hits_match(body["results"][0]["hits"], direct["hits"], 1e-3)
        code, body = _post(port, "/search", {"queries": QUERIES, "k": 3})
        assert code == 200 and [len(r["hits"]) for r in body["results"]] == [3] * 5
        stats = _get(port, "/statsz")
        assert stats["ntotal"] == 50 and stats["k_max"] == 20
        assert stats["microbatch_queries"] == 4
        assert _post(port, "/search", {"query": "x", "k": 21})[0] == 400
        assert _post(port, "/search", {"queries": "not a list"})[0] == 400
        # a request-level filter bypasses the batcher; every hit is allowed
        code, body = _post(port, "/search", {"queries": QUERIES, "k": 5,
                                             "allowed_ids": [1, 3, 4]})
        assert code == 200 and _get(port, "/statsz")["microbatch_queries"] == 4
        assert all({h["index"] for h in r["hits"]} == {1, 3, 4}
                   for r in body["results"])
        code, body = _post(port, "/add", {"passages": ["new"]})
        assert code == 200 and body == {"status": "ok", "ntotal": 51}
        code, body = _post(port, "/save", {})
        assert code == 400 and "no save target" in body["error"]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    # the CPU path never reaches the CUDA kernel
    assert not any(port_flash.launches.values())


@pytest.mark.parametrize("flag,item", [
    (["--coordinator_address", "127.0.0.1:1"], "needs --num_processes and --process_id")])
def test_unported_flags_fail(checkpoint, flag, item):
    """The three multi-process flags are ported, and every index spec
    shards over several processes; what still fails: half a set of them,
    as ``DistributedArguments.initialize`` fails in the training CLIs."""
    with pytest.raises(ValueError, match=item):
        cli.main(_argv(checkpoint, "--device", "cpu", *flag))


def test_pack_queries_serves_the_unpacked_hits(checkpoint):
    """``--pack_queries`` (several queries to a row, block-diagonal
    attention): the server's service packs, and its hits for QUERIES are
    the unpacked service's (the same indices, scores within 1e-5)."""
    services = [cli.make_server(_argv(checkpoint, "--device", "cpu", *flags))
                for flags in ([], ["--pack_queries", "--pack_max_segments", "3"])]
    try:
        plain, packed = (server.service for server in services)
        assert packed.pack_queries and packed.pack_max_segments == 3
        assert not plain.pack_queries
        for p, u in zip(packed.query(QUERIES, k=10), plain.query(QUERIES, k=10)):
            assert [h["index"] for h in p["hits"]] == [h["index"] for h in u["hits"]]
            np.testing.assert_allclose([h["score"] for h in p["hits"]],
                                       [h["score"] for h in u["hits"]], atol=1e-5)
    finally:
        for server in services:
            server.batcher.close()
            server.server_close()


@pytest.mark.parametrize("flag,check", [
    (["--index_dtype", "int8"], lambda idx: idx.dtype == torch.int8),
    (["--recall_target", "0.9"], lambda idx: idx.recall_target == 0.9),
    (["--stable_ids"], lambda idx: idx.dtype == torch.float32),
    (["--index_file", "{tmp}/i.npz"], lambda idx: idx.dtype == torch.float32),
    (["--index_type", "SQ8"], lambda idx: idx.dtype == torch.int8),
    (["--index_type", "flat", "--index_dtype", "bfloat16"],
     lambda idx: idx.dtype == torch.bfloat16),
])
def test_formerly_unported_flags_serve(checkpoint, flag, check, tmp_path):
    """The flags the flat tier refused before bf16/int8 storage, the
    approximate mode, stable ids and persistence were ported: the server
    starts on the CPU with each and answers one /search over the flat tier
    with its storage (hits as the service's own query; under
    ``--stable_ids`` each hit carries its id; ``--index_file`` writes the
    file)."""
    flag = [f.format(tmp=tmp_path) for f in flag]
    server = cli.make_server(_argv(checkpoint, "--device", "cpu", "--log_level", "warning",
                                   *flag))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        index = server.service.index
        assert type(index).__name__ == "FlatIPIndex" and check(index)
        code, body = _post(port, "/search", {"queries": QUERIES[:2], "k": 5})
        assert code == 200
        for res, direct in zip(body["results"], server.service.query(QUERIES[:2], k=5)):
            assert len(res["hits"]) == 5
            _assert_hits_match(res["hits"], direct["hits"])
            assert all(("id" in h) == ("--stable_ids" in flag) for h in res["hits"])
        if "--index_file" in flag:
            assert (tmp_path / "i.npz").exists()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)


def test_ivf_flag_checks(checkpoint, capsys):
    for flag in (["--index_type", "ivf", "--ivf_pq_rotate", "opq"], ["--index_type", "HNSW8"],
                 ["--ivf_balance_eta", "0.1"],
                 ["--index_type", "refine", "--index_dtype", "int8"]):
        with pytest.raises(SystemExit):
            cli.main(_argv(checkpoint, "--device", "cpu", *flag))
    err = capsys.readouterr().err
    assert "--ivf_pq_rotate requires --ivf_pq_m" in err and "unknown" in err
    assert "--ivf_balance_eta requires --index_type ivf" in err
    assert "refine' stores fp32/bf16 rerank rows" in err


@pytest.mark.parametrize("flags,kind", [
    (["--index_type", "ivf", "--recall_target", "0.9", "--ivf_clusters", "6"], "fp32"),
    (["--index_type", "ivf", "--index_dtype", "bfloat16"], "bf16"),
    (["--index_type", "IVF8,PQ8"], "pq"),
    (["--index_type", "ivf", "--ivf_clusters", "6", "--ivf_reduced_dim", "8",
      "--ivf_candidates", "24"], "hybrid"),
    (["--index_type", "PCA16,IVF6,Flat"], "hybrid_spec"),
    (["--index_type", "ivf", "--ivf_clusters", "6", "--ivf_balance_eta", "0.2"], "balanced"),
])
def test_http_server_ivf(checkpoint, flags, kind):
    """The CLI over an IVF index on the CPU: single queries through the
    micro-batcher, a batched request and a per-request nprobe (which
    bypasses the batcher), and a per-request candidate pool. Hits equal the
    index's own search on the same query embeddings outside 1e-5 near-ties;
    probing every cluster of a row index reaches the exact search over the
    stored rows (PQ's exact search decodes rows, its search sums tables: two
    approximations; the hybrid reranks only its candidate pool). The checks
    run at k_max 20 and a request k of 10."""
    server = cli.make_server(_argv(checkpoint, "--device", "cpu", "--log_level", "warning",
                                   *flags))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service = server.service
    index = service.index
    try:
        assert type(index).__name__ == "IVFIPIndex"
        assert {"fp32": index.store_dtype == torch.float32,
                "bf16": index.store_dtype == torch.bfloat16,
                "pq": index.pq_m == 8,
                "hybrid": (index.reduced_dim, index.candidates) == (8, 24),
                "hybrid_spec": (index.reduced_dim, index.store_dtype) == (16, torch.bfloat16),
                "balanced": index.balance_eta == 0.2}[kind]
        assert index.recall_target == (0.9 if kind == "fp32" else 0.95)
        assert _get(port, "/healthz") == {"status": "ok", "ntotal": 50}
        results = [None] * 3
        def one(i):
            results[i] = _post(port, "/search", {"query": QUERIES[i], "k": 5})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(code == 200 and len(body["results"][0]["hits"]) == 5
                   for code, body in results)
        assert _get(port, "/statsz")["microbatch_queries"] == 3
        for nprobe in (None, 1, index.n_clusters):
            payload = {"queries": QUERIES, "k": 10}
            if nprobe is not None:
                payload["nprobe"] = nprobe
            code, body = _post(port, "/search", payload)
            assert code == 200
            batch = service.encoder.prepare_batch(QUERIES, len(QUERIES), 32)
            q_emb = service.encoder.embed_batch(batch).numpy()
            # the server searches at its k_max (20), which also floors the
            # probe count to reach it, and slices to the request's k
            ref = index.search(q_emb, k=20, nprobe=nprobe)
            if nprobe == index.n_clusters and kind in ("fp32", "bf16", "balanced"):
                # PQ: ADC != decode; the hybrid reranks only its pool
                ref = index.exact_search(q_emb, k=20)
            for r, res in enumerate(body["results"]):
                hits = res["hits"]
                want = [{"index": int(i), "score": float(s)}
                        for s, i in zip(*(a[r] for a in ref)) if i >= 0][:10]
                assert len(hits) == len(want)
                _assert_hits_match(hits, want)
        # a per-request candidate pool (the hybrid's; the other IVF indexes
        # take and ignore it, as the JAX service does)
        code, body = _post(port, "/search", {"queries": QUERIES, "k": 10, "candidates": 12})
        assert code == 200
        batch = service.encoder.prepare_batch(QUERIES, len(QUERIES), 32)
        q_emb = service.encoder.embed_batch(batch).numpy()
        ref = index.search(q_emb, k=20, candidates=12)
        for r, res in enumerate(body["results"]):
            want = [{"index": int(i), "score": float(s)}
                    for s, i in zip(*(a[r] for a in ref)) if i >= 0][:10]
            _assert_hits_match(res["hits"], want)
        assert _get(port, "/statsz")["microbatch_queries"] == 3  # both bypassed it
        # a request filter keeps the build's probes: hits are the index's
        # own filtered search, every one allowed
        allowed = list(range(0, 50, 3))
        code, body = _post(port, "/search", {"queries": QUERIES, "k": 10,
                                             "allowed_ids": allowed})
        assert code == 200
        ref = index.search(q_emb, k=20, allowed_ids=allowed)
        for r, res in enumerate(body["results"]):
            assert {h["index"] for h in res["hits"]} <= set(allowed)
            want = [{"index": int(i), "score": float(s)}
                    for s, i in zip(*(a[r] for a in ref)) if i >= 0][:10]
            _assert_hits_match(res["hits"], want)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("flags,store", [
    (["--index_type", "refine", "--refine_dim", "16", "--recall_target", "0.9"],
     torch.float32),
    (["--index_type", "PCA16,Flat", "--refine_candidates", "999"], torch.bfloat16),
])
def test_http_server_refine(checkpoint, flags, store):
    """The CLI over the refine tier on the CPU: single queries through the
    micro-batcher, batched requests with and without a per-request
    ``candidates`` (which bypasses the batcher); hits equal the index's own
    search on the same query embeddings outside 1e-5 near-ties, and at
    ``candidates`` 50 (every row reranked) the exact search over its stored
    rows. A factory spec keeps the tier's bf16 rows and tunes C (the
    --refine_* flags are ignored)."""
    server = cli.make_server(_argv(checkpoint, "--device", "cpu", "--log_level", "warning",
                                   *flags))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service = server.service
    index = service.index
    try:
        assert type(index).__name__ == "RefineIPIndex"
        assert (index.reduced_dim, index.store_dtype) == (16, store)
        assert index.candidates != 999 and index.ntotal == 50
        results = [None] * 3
        def one(i):
            results[i] = _post(port, "/search", {"query": QUERIES[i], "k": 5})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(code == 200 and len(body["results"][0]["hits"]) == 5
                   for code, body in results)
        batch = service.encoder.prepare_batch(QUERIES, len(QUERIES), 32)
        q_emb = service.encoder.embed_batch(batch).numpy()
        stored = index.reconstruct(np.arange(50))
        for cand in (None, 20, 50):
            payload = {"queries": QUERIES, "k": 10}
            if cand is not None:
                payload["candidates"] = cand
            code, body = _post(port, "/search", payload)
            assert code == 200
            ref = index.search(q_emb, k=20, candidates=cand)
            if cand == 50:
                qv = torch.from_numpy(q_emb).to(store).float().numpy()
                scores = qv @ stored.T
                order = np.argsort(-scores, axis=1, kind="stable")[:, :20]
                ref = (np.take_along_axis(scores, order, axis=1), order)
            for r, res in enumerate(body["results"]):
                want = [{"index": int(i), "score": float(s)}
                        for s, i in zip(*(a[r] for a in ref))][:10]
                _assert_hits_match(res["hits"], want)
        assert _get(port, "/statsz")["microbatch_queries"] == 3  # candidates bypassed it
        code, body = _post(port, "/search", {"query": "x", "nprobe": 2})
        assert code == 400 and "IVF indexes only" in body["error"]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("candidates", [None, 30])
def test_refine_service_matches_jax(checkpoint, candidates):
    """Both services over the refine tier in fp32 (d' 16, tuned to 0.9):
    the same tuned C, hits within 1e-5 outside near-ties, with and without
    a per-call candidate pool."""
    path, cfg, params, corpus, _ = checkpoint
    kw = dict(max_query_length=32, query_batch_size=8, recall_target=0.9,
              index_type="refine", index_kwargs={"reduced_dim": 16})
    jsvc = JaxService(JaxEncoder(cfg, params, JaxHashTokenizer(VOCAB), mesh=None,
                                 compute_dtype=jnp.float32), mesh=None, **kw)
    psvc = RetrievalService(InferenceEncoder.from_pretrained(
        path, tokenizer=HashTokenizer(VOCAB), device="cpu", compute_dtype=torch.float32), **kw)
    for svc in (jsvc, psvc):
        svc.build_index(corpus, max_passage_length=48, batch_size=16)
    assert psvc.index.candidates == jsvc.index.candidates
    assert psvc.index.store_dtype == torch.float32
    jres = jsvc.query(QUERIES, k=10, candidates=candidates)
    pres = psvc.query(QUERIES, k=10, candidates=candidates)
    for p, j in zip(pres, jres):
        _assert_hits_match(p["hits"], j["hits"])


def test_adopt_index_serves_a_streamed_build(services):
    """An index built elsewhere (here the streamed IVF build over the
    service's own corpus embeddings) served through ``adopt_index``."""
    from rankpo_tpu_torch.index.ivf import IVFIPIndex

    _, psvc = services
    emb = psvc.index.rows()
    texts = list(psvc.corpus_texts)
    streamed = IVFIPIndex.from_chunk_fn(lambda lo, hi: emb[lo:hi], len(emb), emb.shape[1],
                                        chunk_rows=16, n_clusters=4, nprobe=4,
                                        store_dtype=torch.float32, device="cpu")
    flat = psvc.index
    try:
        psvc.adopt_index(streamed, texts)
        hits = psvc.query(QUERIES[0], k=5)["hits"]
        psvc.adopt_index(flat, texts)
        want = psvc.query(QUERIES[0], k=5)["hits"]
        _assert_hits_match(hits, want)
        with pytest.raises(ValueError, match="rows"):
            psvc.adopt_index(streamed, texts[:-1])
    finally:
        psvc.adopt_index(flat, texts)


def test_nprobe_on_flat_service_is_rejected(services):
    _, psvc = services
    with pytest.raises(ValueError, match="IVF indexes only"):
        psvc.query(QUERIES[0], k=3, nprobe=4)


def test_cuda_device_without_card_fails(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(_argv(checkpoint, "--device", "cuda"))
