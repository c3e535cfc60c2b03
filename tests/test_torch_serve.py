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
        code, body = _post(port, "/search", {"query": "x", "allowed_ids": [1]})
        assert code == 400 and "not ported" in body["error"]
        code, body = _post(port, "/add", {"passages": ["new"]})
        assert code == 501 and "not ported" in body["error"]
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    # the CPU path never reaches the CUDA kernel
    assert not any(port_flash.launches.values())


@pytest.mark.parametrize("flag", [["--index_type", "ivf"], ["--index_dtype", "int8"],
                                  ["--recall_target", "0.9"], ["--stable_ids"],
                                  ["--num_processes", "2"]])
def test_unported_flags_fail(checkpoint, flag, capsys):
    with pytest.raises(SystemExit):
        cli.main(_argv(checkpoint, "--device", "cpu", *flag))
    assert "not ported" in capsys.readouterr().err


def test_cuda_device_without_card_fails(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(_argv(checkpoint, "--device", "cuda"))
