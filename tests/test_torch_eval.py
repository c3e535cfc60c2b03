"""The evaluation slice against the JAX package on the CPU.

``compute_metrics`` is held bit-equal (``==`` on every value) to
``rankpo_tpu.eval.metrics.compute_metrics`` on both the sklearn and the
numpy paths; the save-path helpers take the JAX tests' cases; and
``evaluate_path`` runs over a tiny two-checkpoint tree (written by the
port's ``save_pretrained``, read by both packages) in fp32, flat, IVF and
refine:
the same files, scores within 1e-5 (fp32 round-off of two frameworks'
summation orders through 2 layers and a 64-wide dot), metrics bit-equal to
JAX ``compute_metrics`` over the port's own arrays, and equal to the JAX
run's metrics where the two runs' hits are equal, which the well-separated
data makes them (MRR and Recall bit for bit; AUC and nDCG, which also read
the scores, within 1e-12 relative).
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.eval import evaluator as jevaluator
from rankpo_tpu.eval import metrics as jmetrics
from rankpo_tpu.data import HashTokenizer as JaxHashTokenizer
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.eval import evaluator, metrics
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import save_pretrained

torch.set_num_threads(2)

VOCAB = 256
TOL = 1e-5


def _case(name):
    """(preds [Q, k], scores [Q, k], labels, cutoffs) from a numpy seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k = 24, 10
    preds = np.stack([rng.permutation(40)[:k] for _ in range(q)])
    scores = -np.sort(-rng.random((q, k)), axis=1)
    labels = [list(rng.choice(40, size=int(rng.integers(1, 5)), replace=False))
              for _ in range(q)]
    cutoffs = [1, 3, 5, 10]
    if name == "tied_scores":
        scores = np.round(scores * 4) / 4  # many exact ties, within and across rows
        scores = -np.sort(-scores, axis=1)
    elif name == "labels_longer_than_k":
        labels = [list(rng.choice(40, size=15, replace=False)) for _ in range(q)]
    elif name == "cutoffs_above_k":
        cutoffs = [1, 5, 10, 20, 100]
    elif name == "minus_one_ids":
        preds[:, 7:] = -1  # IVF tail padding, scores clamped below the rest
        scores[:, 7:] = scores[:, :7].min() - 1.0
    elif name == "all_hits":
        labels = [list(p) for p in preds]
    elif name == "no_hits":
        labels = [[100 + i] for i in range(q)]
    return preds, scores.astype(np.float32), labels, cutoffs


CASES = ["tied_scores", "labels_longer_than_k", "cutoffs_above_k",
         "minus_one_ids", "all_hits", "no_hits"]


@pytest.mark.parametrize("path", ["sklearn", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_compute_metrics_bit_equal(case, path, monkeypatch):
    if path == "sklearn":
        pytest.importorskip("sklearn")
        assert metrics._HAS_SKLEARN and jmetrics._HAS_SKLEARN
    else:
        monkeypatch.setattr(metrics, "_HAS_SKLEARN", False)
        monkeypatch.setattr(jmetrics, "_HAS_SKLEARN", False)
    preds, scores, labels, cutoffs = _case(case)
    got = metrics.compute_metrics(preds, scores, labels, cutoffs=cutoffs)
    want = jmetrics.compute_metrics(preds, scores, labels, cutoffs=cutoffs)
    assert list(got) == list(want)
    assert got == want
    if case == "all_hits":
        assert all(got[f"AUC@{c}"] == 1.0 for c in cutoffs)
    if case == "no_hits":
        assert all(got[f"AUC@{c}"] == 0.0 for c in cutoffs)


def test_auc_fallback_matches_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.metrics import roc_auc_score

    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, 200)
    labels[0], labels[1] = 1, 0
    scores = rng.randn(200)
    scores[::7] = scores[0]  # inject ties
    np.testing.assert_allclose(
        metrics._auc_numpy(labels, scores), roc_auc_score(labels, scores), rtol=1e-10)
    assert metrics._auc_numpy(np.ones(4, int), np.ones(4)) == 1.0
    assert metrics._auc_numpy(np.zeros(4, int), np.ones(4)) == 0.0


def test_ndcg_fallback_matches_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.metrics import ndcg_score

    rng = np.random.RandomState(1)
    rel = rng.randint(0, 2, (8, 10))
    rel[0] = 1
    scores = rng.randn(8, 10)
    for k in (1, 3, 10):
        np.testing.assert_allclose(
            metrics._ndcg_numpy(rel, scores, k), ndcg_score(rel, scores, k=k), rtol=1e-10)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        metrics.compute_metrics([[1]], np.ones((1, 1)), [[1], [2]], cutoffs=[1])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model_path,expect", [
    ("models/run-x/checkpoint-42", ("run-x", "checkpoint-42.json")),
    ("models/final-model", ("final-model", "main.json")),
])
def test_save_path_convention(tmp_path, model_path, expect):
    got = evaluator.get_save_path(model_path, str(tmp_path / "a"))
    want = jevaluator.get_save_path(model_path, str(tmp_path / "b"))
    assert got == str(tmp_path / "a" / expect[0] / expect[1])
    assert os.path.relpath(got, tmp_path / "a") == os.path.relpath(want, tmp_path / "b")


def test_save_path_no_overwrite_appends_timestamp(tmp_path):
    p1 = evaluator.get_save_path("models/m", str(tmp_path))
    open(p1, "w").write("{}")
    p2 = evaluator.get_save_path("models/m", str(tmp_path), can_overwrite=False)
    assert p1 != p2 and p2.startswith(str(tmp_path / "m" / "main_"))


def test_find_checkpoints(tmp_path):
    for sub in ("run/checkpoint-2", "run/checkpoint-10", "run", "other/x"):
        os.makedirs(tmp_path / sub, exist_ok=True)
    for sub in ("run/checkpoint-2", "run/checkpoint-10", "run"):
        (tmp_path / sub / "config.json").write_text("{}")
    got = evaluator.find_checkpoints(str(tmp_path))
    assert got == jevaluator.find_checkpoints(str(tmp_path))
    assert got == sorted(str(tmp_path / s) for s in ("run", "run/checkpoint-10",
                                                     "run/checkpoint-2"))


# ---------------------------------------------------------------------------
CORPUS = [f"unique doc {i} topic {i}" for i in range(20)]
QUERY_IDS = (3, 11, 0, 17, 8, 5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """models/tiny/checkpoint-{1,2} (two seeds) plus the query and corpus files."""
    root = tmp_path_factory.mktemp("eval_tree")
    cfg = tiny_llama_config(vocab_size=VOCAB)
    for step, seed in ((1, 0), (2, 1)):
        state = llama.init_params(cfg, torch.Generator().manual_seed(seed))
        save_pretrained(str(root / "models" / "tiny" / f"checkpoint-{step}"), cfg, state)
    qf, cf = root / "q.jsonl", root / "c.jsonl"
    qf.write_text("\n".join(
        json.dumps({"query": {"text": CORPUS[i]}, "positives": {"index": [i, (i + 1) % 20]}})
        for i in QUERY_IDS))
    cf.write_text("\n".join(json.dumps({"text": t}) for t in CORPUS))
    return root, str(qf), str(cf)


EVAL_KW = dict(batch_size=8, max_query_length=16, max_passage_length=16, k=10,
               cutoffs=[1, 5, 10])


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


@pytest.mark.parametrize("index", ["flat", "ivf", "refine", "SQ8", "SQbf16"])
def test_evaluate_path_matches_jax(tree, tmp_path, index):
    root, qf, cf = tree
    models = str(root / "models" / "tiny")
    kw = dict(EVAL_KW, evaluate_all_checkpoints=True, index_type=index)
    if index == "ivf":
        kw["index_kwargs"] = {"n_clusters": 4, "nprobe": 2, "kmeans_iters": 2}
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jevaluator.evaluate_path(models, qf, cf, jout, mesh=None,
                                    tokenizer=JaxHashTokenizer(VOCAB),
                                    compute_dtype=jnp.float32, **kw)
    pres = evaluator.evaluate_path(models, qf, cf, pout, device="cpu",
                                   tokenizer=HashTokenizer(VOCAB),
                                   compute_dtype=torch.float32, **kw)
    assert _files(pout) == _files(jout) == [
        "tiny/all_eval_results.json", "tiny/checkpoint-1-indices.npy",
        "tiny/checkpoint-1-scores.npy", "tiny/checkpoint-1.json",
        "tiny/checkpoint-2-indices.npy", "tiny/checkpoint-2-scores.npy",
        "tiny/checkpoint-2.json"]
    assert list(pres) == list(jres) == ["checkpoint-1", "checkpoint-2"]
    labels = [[i, (i + 1) % 20] for i in QUERY_IDS]
    for name in pres:
        stem = os.path.join("tiny", name)
        p_idx = np.load(os.path.join(pout, stem + "-indices.npy"))
        p_sc = np.load(os.path.join(pout, stem + "-scores.npy"))
        j_idx = np.load(os.path.join(jout, stem + "-indices.npy"))
        j_sc = np.load(os.path.join(jout, stem + "-scores.npy"))
        assert p_idx.dtype == np.int64 and p_sc.dtype == np.float32
        np.testing.assert_allclose(p_sc, j_sc, rtol=0, atol=TOL)
        with open(os.path.join(pout, stem + ".json")) as f:
            saved = json.load(f)
        assert saved == pres[name]
        assert saved == jmetrics.compute_metrics(p_idx, p_sc, labels, cutoffs=[1, 5, 10])
        # well-separated data: equal hits, hence equal rank metrics; AUC and
        # nDCG also read the scores, so the ulps of the fp32 round-off reach
        # their last bits (the sums over the ROC curve round differently)
        np.testing.assert_array_equal(p_idx, j_idx)
        assert list(saved) == list(jres[name])
        for key, value in saved.items():
            if key.startswith(("MRR", "Recall")):
                assert value == jres[name][key], key
            else:
                assert value == pytest.approx(jres[name][key], rel=1e-12, abs=0), key
    with open(os.path.join(pout, "tiny", "all_eval_results.json")) as f:
        assert json.load(f) == pres
    # a second run skips every evaluated checkpoint and keeps the aggregate
    again = evaluator.evaluate_path(models, qf, cf, pout, device="cpu",
                                    tokenizer=HashTokenizer(VOCAB),
                                    compute_dtype=torch.float32, **kw)
    assert again == {}
    with open(os.path.join(pout, "tiny", "all_eval_results.json")) as f:
        assert json.load(f) == pres


def test_evaluate_checkpoint_ivf_inf_padding(tree):
    """nprobe 1 over 8 clusters of a 20-row corpus: the probed clusters hold
    fewer than k 18 rows, so the search pads with -1 / -inf; the evaluator
    clamps the pad scores finite (sklearn rejects infinities), like JAX."""
    root, _, _ = tree
    ckpt = str(root / "models" / "tiny" / "checkpoint-1")
    kw = dict(batch_size=8, max_query_length=16, max_passage_length=16, k=18,
              cutoffs=(1, 5), index_type="ivf",
              index_kwargs={"n_clusters": 8, "nprobe": 1, "kmeans_iters": 2})
    queries, labels = [CORPUS[3], CORPUS[11]], [[3], [11]]
    pm, p_idx, p_sc = evaluator.evaluate_checkpoint(
        ckpt, queries, labels, CORPUS, tokenizer=HashTokenizer(VOCAB), device="cpu",
        compute_dtype=torch.float32, **kw)
    jm, j_idx, j_sc = jevaluator.evaluate_checkpoint(
        ckpt, queries, labels, CORPUS, tokenizer=JaxHashTokenizer(VOCAB), mesh=None,
        compute_dtype=jnp.float32, **kw)
    assert (p_idx < 0).any(), "test premise: padding must appear"
    assert np.isfinite(p_sc).all()
    np.testing.assert_array_equal(p_idx, j_idx)
    np.testing.assert_allclose(p_sc, j_sc, rtol=0, atol=TOL)
    assert pm == jmetrics.compute_metrics(p_idx, p_sc, labels, cutoffs=[1, 5])
    for key in ("MRR@1", "MRR@5", "Recall@1", "Recall@5"):
        assert pm[key] == jm[key]


def test_refine_raises_before_loading(tmp_path):
    # the spec is checked first: no checkpoint is needed to see the error
    with pytest.raises(ValueError, match="refine tier reranks on fp32/bf16"):
        evaluator.evaluate_checkpoint(str(tmp_path / "missing"), ["q"], [[0]], ["d"],
                                      device="cpu", index_type="PCA16,SQ8")
    # the flat tier's int8 rows are served (the parity is
    # test_evaluate_path_matches_jax[SQ8]): a missing checkpoint is the error
    with pytest.raises(FileNotFoundError):
        evaluator.evaluate_checkpoint(str(tmp_path / "missing"), ["q"], [[0]], ["d"],
                                      device="cpu", index_type="SQ8")
