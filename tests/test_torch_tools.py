"""The mining and prediction tools against the JAX package on the CPU.

``find_random_negatives`` and ``select_negative_ids`` (topk, sample, and
cluster with sklearn's KMeans and with the numpy Lloyd fallback forced in
both packages) must give rows equal to the JAX functions' for the same seed
and candidates; the JAX tests' invariants ride along. ``find_hard_negatives``
and ``generate_predictions`` run end to end on one tiny checkpoint (written
by the port's ``save_pretrained``, read by both packages, fp32): the same
files and jsonl rows as the JAX run, once the test has asserted that the
JAX run's candidate scores are apart by more than the two frameworks'
fp32 round-off (1e-5), so that no near-tie may legitimately reorder them.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.data import HashTokenizer as JaxHashTokenizer
from rankpo_tpu.index import FlatIPIndex as JaxFlatIPIndex
from rankpo_tpu.index import InferenceEncoder as JaxEncoder
from rankpo_tpu.models import load_pretrained as jload
from rankpo_tpu.tools import find_hard_negatives as j_find_hard
from rankpo_tpu.tools import find_random_negatives as j_find_random
from rankpo_tpu.tools import generate_predictions as j_predictions
from rankpo_tpu.tools import select_negative_ids as j_select
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.ivf import IVFIPIndex
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import save_pretrained
from rankpo_tpu_torch.tools import (
    find_hard_negatives,
    find_random_negatives,
    generate_predictions,
    select_negative_ids,
)
from rankpo_tpu_torch.utils.jsonl import iter_jsonl

torch.set_num_threads(2)

VOCAB = 256
GAP = 1e-5


def _mining_file(tmp_path, n=8, n_pos=2):
    rows = [{
        "query": {"text": f"query text {i}"},
        "positives": {"text": [f"positive {i} {j}" for j in range(n_pos)]},
        "negatives": {"text": [f"old negative {i}"]},
    } for i in range(n)]
    path = tmp_path / "mine.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _rows(path):
    return list(iter_jsonl(path))


@pytest.fixture
def no_sklearn_kmeans(monkeypatch):
    """Force both packages' k-means onto the numpy Lloyd fallback: importing
    sklearn.cluster raises ImportError while this fixture is active."""
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,num", [(0, 5), (1, 3), (7, 9)])
def test_random_negatives_equal_jax(tmp_path, seed, num):
    inp = _mining_file(tmp_path)
    rows = find_random_negatives(inp, str(tmp_path / "p.jsonl"), num, seed=seed)
    want = j_find_random(inp, str(tmp_path / "j.jsonl"), num, seed=seed)
    assert rows == want
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert len(rows) == 8
    for row in rows:
        assert set(row) == {"query", "positives", "negatives"}
        assert len(set(row["negatives"])) == num
        for neg in row["negatives"]:
            assert neg not in row["positives"] and neg != row["query"]


def test_random_negatives_too_few_raises(tmp_path):
    inp = _mining_file(tmp_path, n=2)
    with pytest.raises(ValueError, match="cannot sample"):
        find_random_negatives(inp, str(tmp_path / "p.jsonl"), 50, seed=0)


def _select_fixture():
    corpus = [f"doc {i}" for i in range(20)]
    train_rows = [{"query": "doc 0", "positives": ["doc 1", "doc 2"]},
                  {"query": "other", "positives": ["doc 5"]}]
    candidates = [list(range(12)), list(range(19, 3, -1))]  # query/positives included
    emb = np.random.RandomState(0).randn(20, 8).astype(np.float32)
    return corpus, train_rows, candidates, emb


@pytest.mark.parametrize("kmeans", ["sklearn", "numpy"])
@pytest.mark.parametrize("method,lam", [("topk", None), ("sample", None),
                                        ("cluster", 0.5), ("cluster", 0.9),
                                        ("cluster", 1e-9)])
def test_select_negative_ids_equal_jax(method, lam, kmeans, request):
    if kmeans == "sklearn":
        pytest.importorskip("sklearn.cluster")
    else:
        request.getfixturevalue("no_sklearn_kmeans")
    corpus, rows, cands, emb = _select_fixture()
    kw = dict(num_negatives=4, method=method, train_rows=rows, corpus=corpus,
              corpus_embedding=emb, num_clusters=3, lambda_=lam, seed=3)
    got = select_negative_ids(cands, **kw)
    want = j_select(cands, **kw)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    for ids, row in zip(got, rows):
        assert ids.dtype == np.int64 and len(set(ids.tolist())) == 4
        for j in ids:
            assert corpus[j] not in row["positives"] and corpus[j] != row["query"]
    if method == "topk":
        assert got[0].tolist() == [3, 4, 5, 6]  # 0, 1, 2 filtered, then rank order


@pytest.mark.parametrize("kmeans", ["sklearn", "numpy"])
def test_lambda_zero_spreads_clusters(kmeans, request):
    """λ -> 0 forbids re-drawing from a visited cluster (weight 0^k)."""
    if kmeans == "sklearn":
        pytest.importorskip("sklearn.cluster")
    else:
        request.getfixturevalue("no_sklearn_kmeans")
    corpus = [f"d{i}" for i in range(8)]
    rows = [{"query": "other", "positives": []}]
    emb = np.zeros((8, 2), np.float32)
    emb[4:] = [10.0, 10.0]
    emb += np.random.RandomState(1).randn(8, 2).astype(np.float32) * 0.01
    kw = dict(num_negatives=2, method="cluster", train_rows=rows, corpus=corpus,
              corpus_embedding=emb, num_clusters=2, lambda_=1e-9, seed=0)
    got = select_negative_ids([list(range(8))], **kw)
    assert got[0].tolist() == j_select([list(range(8))], **kw)[0].tolist()
    assert {int(j) // 4 for j in got[0]} == {0, 1}


def test_select_errors():
    corpus, rows, _, _ = _select_fixture()
    with pytest.raises(RuntimeError, match="after filtering"):
        select_negative_ids([[0, 1, 2], [3]], num_negatives=4, method="topk",
                            train_rows=rows, corpus=corpus)
    with pytest.raises(RuntimeError, match="no hard negatives"):
        select_negative_ids([[3, -1], [3]], num_negatives=1, method="topk",
                            train_rows=rows, corpus=corpus)
    with pytest.raises(ValueError, match="method"):
        select_negative_ids([[3]], num_negatives=1, method="best",
                            train_rows=rows, corpus=corpus)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """(port encoder, JAX encoder) over one checkpoint written by the port."""
    path = str(tmp_path_factory.mktemp("tools_ckpt") / "ckpt")
    cfg = tiny_llama_config(vocab_size=VOCAB)
    save_pretrained(path, cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    port = InferenceEncoder.from_pretrained(
        path, tokenizer=HashTokenizer(VOCAB), device="cpu",
        compute_dtype=torch.float32, length_multiple=8)
    jcfg, jparams = jload(path)
    jax_enc = JaxEncoder(jcfg, jparams, JaxHashTokenizer(VOCAB), mesh=None,
                         compute_dtype=jnp.float32, length_multiple=8)
    return port, jax_enc


def _assert_separated(jax_enc, queries, corpus, k):
    """Test premise: the JAX run's top-k candidates are apart by more than
    GAP, so equal rows are required, not merely likely."""
    q = jax_enc.encode(queries, batch_size=8, max_length=16)
    c = jax_enc.encode(corpus, batch_size=8, max_length=16)
    scores, _ = JaxFlatIPIndex(c).search(q, k=k)
    gaps = -np.diff(scores, axis=1)
    assert gaps.min() > GAP, f"near-tie {gaps.min():.2e} in the candidates"


MINE_KW = dict(max_query_length=16, max_passage_length=16, num_negatives=3,
               search_range=(0, 10), batch_size=8, num_clusters=2, seed=0)


@pytest.mark.parametrize("method,lam", [("topk,cluster", 0.5), ("sample", None),
                                        ("cluster", None)])
def test_find_hard_negatives_equal_jax(tmp_path, encoders, method, lam):
    port, jax_enc = encoders
    inp = _mining_file(tmp_path, n=6, n_pos=2)
    from rankpo_tpu_torch.data.datasets import load_mining_rows

    _, queries, corpus = load_mining_rows(inp)
    _assert_separated(jax_enc, queries, corpus, 10)
    kw = dict(MINE_KW, method=method, lambda_=lam)
    got = find_hard_negatives(port, inp, str(tmp_path / "port"), **kw)
    want = j_find_hard(jax_enc, inp, str(tmp_path / "jax"), mesh=None, **kw)
    assert sorted(got) == sorted(want)
    if lam is None and method == "cluster":  # the λ sweep
        assert sorted(got) == [f"cluster{i}.jsonl" for i in range(1, 10)]
    for name in got:
        rows = _rows(got[name])
        assert rows == _rows(want[name]), name
        assert len(rows) == 6
        for row, src in zip(rows, _rows(inp)):
            assert len(row["positives"]) == 1 and len(row["negatives"]) == 3
            for neg in row["negatives"]:
                assert neg != row["query"] and neg not in src["positives"]["text"]


def test_index_kwargs_reach_constructor(tmp_path, encoders, monkeypatch):
    port, _ = encoders
    seen = {}
    orig = IVFIPIndex.__init__

    def spy(self, *a, **k):
        seen.update(k)
        return orig(self, *a, **k)

    monkeypatch.setattr(IVFIPIndex, "__init__", spy)
    inp = _mining_file(tmp_path, n=6, n_pos=2)
    outputs = find_hard_negatives(port, inp, str(tmp_path / "mined_kw"),
                                  **dict(MINE_KW, method="topk", index_type="ivf",
                                         index_kwargs={"n_clusters": 4, "nprobe": 4}))
    assert seen.get("n_clusters") == 4 and seen.get("nprobe") == 4
    assert seen.get("recall_target") == 0.95
    assert len(_rows(outputs["topk.jsonl"])) == 6


@pytest.mark.parametrize("tool", ["mining", "predictions"])
def test_refine_raises(tmp_path, encoders, tool):
    """A refine spec the tier cannot take raises before any file is read;
    the refine tier itself (PCA prefilter and exact rerank, reduced_dim
    min(256, D), tuned to the tool's recall target) gives the JAX tool's
    rows."""
    port, jax_enc = encoders
    with pytest.raises(ValueError, match="refine tier"):
        if tool == "mining":
            find_hard_negatives(port, str(tmp_path / "missing.jsonl"), str(tmp_path / "o"),
                                index_type="PCA16,SQ8")
        else:
            generate_predictions(port, str(tmp_path / "q"), str(tmp_path / "c"),
                                 str(tmp_path / "o.jsonl"), index_type="PCA16,SQ8")
    if tool == "mining":
        inp = _mining_file(tmp_path, n=6, n_pos=2)
        from rankpo_tpu_torch.data.datasets import load_mining_rows

        _, queries, corpus = load_mining_rows(inp)
        _assert_separated(jax_enc, queries, corpus, 10)
        kw = dict(MINE_KW, method="topk", index_type="refine")
        got = find_hard_negatives(port, inp, str(tmp_path / "port"), **kw)
        want = j_find_hard(jax_enc, inp, str(tmp_path / "jax"), mesh=None, **kw)
        assert sorted(got) == sorted(want) == ["topk.jsonl"]
        assert _rows(got["topk.jsonl"]) == _rows(want["topk.jsonl"])
    else:
        qf, cf, queries, corpus = _qc_files(tmp_path)
        _assert_separated(jax_enc, queries, corpus, 8)
        kw = dict(max_query_length=16, max_passage_length=16, search_range=(0, 8),
                  method="topk", num_predictions=3, batch_size=8, index_type="refine")
        got = generate_predictions(port, qf, cf, str(tmp_path / "p.jsonl"), **kw)
        want = j_predictions(jax_enc, qf, cf, str(tmp_path / "j.jsonl"), mesh=None, **kw)
        assert got == want and len(got) == 9


@pytest.mark.parametrize("spec", ["SQ8", "SQbf16"])
@pytest.mark.parametrize("tool", ["mining", "predictions"])
def test_flat_storage_tiers_equal_jax(tmp_path, encoders, tool, spec):
    """Mining and prediction pairs over the flat tier's int8 and bf16 rows
    (factory specs SQ8 / SQbf16): the JAX tools' rows. Mining builds as the
    JAX constructor (host int8 rounding), predictions as ``from_sharded``."""
    port, jax_enc = encoders
    if tool == "mining":
        inp = _mining_file(tmp_path, n=6, n_pos=2)
        from rankpo_tpu_torch.data.datasets import load_mining_rows

        _, queries, corpus = load_mining_rows(inp)
        _assert_separated(jax_enc, queries, corpus, 10)
        kw = dict(MINE_KW, method="topk,cluster", lambda_=0.5, index_type=spec)
        got = find_hard_negatives(port, inp, str(tmp_path / "port"), **kw)
        want = j_find_hard(jax_enc, inp, str(tmp_path / "jax"), mesh=None, **kw)
        assert sorted(got) == sorted(want)
        for name in got:
            assert _rows(got[name]) == _rows(want[name]), name
    else:
        qf, cf, queries, corpus = _qc_files(tmp_path)
        _assert_separated(jax_enc, queries, corpus, 8)
        kw = dict(max_query_length=16, max_passage_length=16, search_range=(0, 8),
                  method="topk", num_predictions=3, batch_size=8, index_type=spec)
        got = generate_predictions(port, qf, cf, str(tmp_path / "p.jsonl"), **kw)
        want = j_predictions(jax_enc, qf, cf, str(tmp_path / "j.jsonl"), mesh=None, **kw)
        assert got == want and len(got) == 9


def _qc_files(tmp_path, n_q=3, n_c=12):
    corpus = [f"candidate doc {i}" for i in range(n_c)]
    qf, cf = tmp_path / "q.jsonl", tmp_path / "c.jsonl"
    qf.write_text("\n".join(
        json.dumps({"query": {"text": f"query {i}"}, "positives": {"index": [i]}})
        for i in range(n_q)))
    cf.write_text("\n".join(json.dumps({"text": t}) for t in corpus))
    return str(qf), str(cf), [f"query {i}" for i in range(n_q)], corpus


@pytest.mark.parametrize("method,n,pairs", [("topk", 3, True), ("sample", 4, False),
                                            ("sample", 3, True)])
def test_generate_predictions_equal_jax(tmp_path, encoders, method, n, pairs):
    port, jax_enc = encoders
    qf, cf, queries, corpus = _qc_files(tmp_path)
    _assert_separated(jax_enc, queries, corpus, 8)
    kw = dict(max_query_length=16, max_passage_length=16, search_range=(0, 8),
              method=method, num_predictions=n, batch_size=8, emit_pairs=pairs)
    got = generate_predictions(port, qf, cf, str(tmp_path / "p" / "preds.jsonl"), **kw)
    want = j_predictions(jax_enc, qf, cf, str(tmp_path / "j" / "preds.jsonl"),
                         mesh=None, **kw)
    assert got == want
    assert _rows(tmp_path / "p" / "preds.jsonl") == got
    if pairs:
        assert len(got) == 3 * n * (n - 1) // 2  # Q x C(n, 2)
        assert all(r["passage_rank1"] < r["passage_rank2"] for r in got)
    else:
        assert len(got) == 3 and all(len(r["predictions"]) == n for r in got)
