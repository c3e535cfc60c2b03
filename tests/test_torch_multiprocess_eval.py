"""Multi-process evaluation of the PyTorch port: ``evaluate_path``,
``cli.evaluate``, the in-training retrieval hook and the mining and
prediction tools at W = 2 (two gloo processes, ``torch_serve_workers``),
against the port in one process and the JAX package on a 2-device mesh.

A tiny llama (2 layers, width 64) in fp32, its weights carried from a JAX
init, over 40 passages of mixed lengths (each rank's shard runs in batches
of its own). Tolerances: search indices identical and metrics within 1e-6
(JAX's in-training test's rtol) against one process and against JAX's
``evaluate_checkpoint`` on the mesh; the hook at W = 2 under ZeRO-1, fsdp
and ``--model_parallel 2`` within 1e-6 of ``cli.evaluate`` at W = 2 over a
checkpoint of the same weights, and of JAX's hook on the mesh. Rank 0's
file system decides the skip, rank 0 alone writes, and the tools' files
equal one process's.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.core.mesh import MeshConfig as JMeshConfig
from rankpo_tpu.core.mesh import make_mesh
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.eval.evaluator import evaluate_checkpoint as jevaluate
from rankpo_tpu.eval.in_training import RetrievalEvalHook as JHook
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.models.hf_io import load_pretrained as jload
from rankpo_tpu_torch.cli import get_hard_negatives, get_predictions
from rankpo_tpu_torch.data.tokenization import HashTokenizer
from rankpo_tpu_torch.eval.evaluator import evaluate_path
from rankpo_tpu_torch.models.config import EncoderConfig
from rankpo_tpu_torch.models.hf_io import params_from_jax, save_pretrained
from rankpo_tpu_torch.utils.jsonl import iter_jsonl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
import torch_serve_workers as sw  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-6
TOK = "hash:256"
N_DOCS = 40
K = 20
CUTOFFS = (1, 5, 10, 20)


def _docs():
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(80)]
    return [f"doc {i} " + " ".join(rng.choice(words, int(rng.integers(2, 30))))
            for i in range(N_DOCS)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_eval")
    jcfg = jtiny(vocab_size=256)
    params = jinit(jax.random.key(0), jcfg)
    pcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    ckpt = str(root / "model")
    save_pretrained(ckpt, pcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                pcfg))
    docs = _docs()
    (root / "q.jsonl").write_text("\n".join(json.dumps({
        "query": {"text": docs[i][:12]}, "positives": {"index": [i]}})
        for i in range(0, N_DOCS, 4)))
    (root / "c.jsonl").write_text("\n".join(json.dumps({"text": t}) for t in docs))
    (root / "train.jsonl").write_text("\n".join(
        json.dumps(r) for r in workers.contrastive_rows(16)))
    (root / "mining.jsonl").write_text("\n".join(json.dumps({
        "query": {"text": docs[i][:12]}, "positives": {"text": [docs[i]]},
        "negatives": {"text": [docs[(i + 5) % N_DOCS], docs[(i + 9) % N_DOCS]]}})
        for i in range(0, N_DOCS, 3)))
    return root, ckpt, jcfg


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])


def _one_process(root, ckpt, tier, out):
    return evaluate_path(ckpt, str(root / "q.jsonl"), str(root / "c.jsonl"), str(out),
                         device="cpu", batch_size=8, compute_dtype=torch.float32, k=K,
                         cutoffs=CUTOFFS, index_type=tier, tokenizer=HashTokenizer(256))


@pytest.fixture(scope="module")
def eval_run(workspace):
    root, ckpt, _ = workspace
    out = str(root / "eval_w2")
    os.makedirs(out)
    workers.save(out, "eval_cfg.pt", {"ckpt": ckpt, "queries": str(root / "q.jsonl"),
                                      "corpus": str(root / "c.jsonl"), "batch_size": 8})
    workers.spawn(sw.eval_worker, 2, out, timeout=150.0)
    return out, [workers.load(out, f"eval_{r}.pt") for r in range(2)]


def _arrays(d, tier):
    stem = os.path.join(d, "model", "main")
    return (np.load(stem + "-indices.npy"), np.load(stem + "-scores.npy"),
            json.load(open(stem + ".json")))


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=RTOL, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("tier", ["flat", "refine"])
def test_evaluate_path_matches_one_process_and_jax(workspace, eval_run, mesh2, tmp_path, tier):
    root, ckpt, jcfg = workspace
    out, ranks = eval_run
    one = _one_process(root, ckpt, tier, tmp_path)["main"]
    _close(ranks[0][tier]["main"], one)
    assert ranks[1][tier] == ranks[0][tier]  # the followers return the same metrics
    idx2, sc2, saved = _arrays(os.path.join(out, f"w2_{tier}_0"), tier)
    idx1, sc1, _ = _arrays(str(tmp_path), tier)
    np.testing.assert_array_equal(idx2, idx1)
    np.testing.assert_allclose(sc2, sc1, atol=1e-5, rtol=0)
    assert saved == ranks[0][tier]["main"]
    # JAX on a 2-device mesh, the same weights and files
    queries = [json.loads(line)["query"]["text"] for line in open(root / "q.jsonl")]
    labels = [json.loads(line)["positives"]["index"] for line in open(root / "q.jsonl")]
    corpus = [json.loads(line)["text"] for line in open(root / "c.jsonl")]
    jm, jidx, _ = jevaluate(ckpt, queries, labels, corpus, tokenizer=JHashTokenizer(256),
                            mesh=mesh2, batch_size=8, k=K, cutoffs=CUTOFFS,
                            compute_dtype=jnp.float32, index_type=tier)
    np.testing.assert_array_equal(idx2, np.asarray(jidx))
    _close(ranks[0][tier]["main"], jm)


def test_ivf_and_autotune_still_refused_at_two_ranks(eval_run):
    """What is left of item 8c raises on every rank, naming it: the IVF
    tier (the evaluator, the hook at construction) and cli.autotune."""
    _, ranks = eval_run
    for r in range(2):
        for key in ("ivf_error", "hook_error", "autotune_error"):
            assert "rest of item 8c" in ranks[r][key], key


def test_live_model_shards_run_as_many_batches(eval_run):
    """With a live model (the hook's encoder) every rank of the data group
    runs as many batches as the longest shard: rank 1's shorter shard pads
    with a filler batch; the rows are those of its texts encoded alone."""
    _, ranks = eval_run
    for r in range(2):
        f = ranks[r]["filler"]
        assert f["batches"] == 2 and f["n"] == 5 and f["rows"] == 3
        assert f["equal"] and f["pad_zero"]


def test_rank0_decides_the_skip_and_alone_writes(eval_run):
    out, ranks = eval_run
    for r in range(2):
        assert ranks[r]["skip"] == {}  # rank 0's file existed: both skipped
    for tier in ("flat", "refine"):
        assert not os.path.exists(os.path.join(out, f"w2_{tier}_1"))
        agg = json.load(open(os.path.join(out, f"w2_{tier}_0", "model",
                                          "all_eval_results.json")))
        assert agg == {"main": ranks[0][tier]["main"]}  # rebuilt from the files
    assert not os.path.exists(os.path.join(out, "fresh_1"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_evaluate_two_subprocesses(workspace, tmp_path):
    """``python -m rankpo_tpu_torch.cli.evaluate`` with the three flags, two
    processes under gloo: rank 0 writes what one process writes."""
    root, ckpt, _ = workspace
    port = _free_port()
    argv = ["--model_name_or_path", ckpt, "--tokenizer_name", TOK,
            "--query_data", str(root / "q.jsonl"), "--corpus_data", str(root / "c.jsonl"),
            "--batch_size", "8", "--k", str(K), "--cutoffs", "1,5,10,20", "--device", "cpu",
            "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "rankpo_tpu_torch.cli.evaluate", *argv,
                               "--output_dir", str(tmp_path / f"r{r}"), "--process_id", str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    one = tmp_path / "one"
    _one_process(root, ckpt, "flat", one)
    np.testing.assert_array_equal(np.load(tmp_path / "r0" / "model" / "main-indices.npy"),
                                  np.load(one / "model" / "main-indices.npy"))
    _close(json.load(open(tmp_path / "r0" / "model" / "main.json")),
           json.load(open(one / "model" / "main.json")))
    assert not (tmp_path / "r1").exists()


@pytest.fixture(scope="module")
def hook_run(workspace):
    root, ckpt, _ = workspace
    out = str(root / "hook_w2")
    os.makedirs(out)
    common = ["--tokenizer_name", TOK, "--max_query_length", "32",
              "--max_passage_length", "64", "--device", "cpu", "--bf16", "False"]
    workers.save(out, "hook_cfg.pt", {
        "argv": ["--model_name_or_path", ckpt, *common, "--train_data",
                 str(root / "train.jsonl"), "--num_negatives", "3",
                 "--per_device_train_batch_size", "2", "--max_steps", "2",
                 "--learning_rate", "1e-3", "--save_strategy", "steps", "--save_steps", "2",
                 "--eval_strategy", "steps", "--eval_steps", "2", "--seed", "0",
                 "--retrieval_eval_query_file", str(root / "q.jsonl"),
                 "--retrieval_eval_corpus_file", str(root / "c.jsonl"),
                 "--retrieval_eval_k", str(K)],
        "eval_argv": [*common, "--query_data", str(root / "q.jsonl"), "--corpus_data",
                      str(root / "c.jsonl"), "--k", str(K), "--cutoffs", "1,5,10,20",
                      "--batch_size", "256"]})
    workers.spawn(sw.hook_worker, 2, out, timeout=240.0)
    return out, [workers.load(out, f"hook_{r}.pt") for r in range(2)]


@pytest.mark.parametrize("mode", ["zero1", "fsdp", "mp"])
def test_hook_at_two_ranks_matches_cli_evaluate_and_jax(hook_run, mesh2, workspace, mode):
    root, _, jcfg = workspace
    out, ranks = hook_run
    for r in range(2):
        hook, offline = ranks[r][mode]["hook"], ranks[r][mode]["offline"]
        assert len(hook) == 1 and hook[0]["global_step"] == 2
        got = {k[len("retrieval_"):]: v for k, v in hook[0].items()
               if k.startswith("retrieval_") and k != "retrieval_eval_runtime"}
        _close(got, offline["checkpoint-2"])
    # JAX's hook on the mesh over the saved step-2 weights
    _, params = jload(os.path.join(out, f"run_{mode}", "checkpoint-2"))
    want = JHook(jcfg, JHashTokenizer(256), str(root / "q.jsonl"), str(root / "c.jsonl"),
                 mesh=mesh2, max_query_length=32, max_passage_length=64, k=K,
                 cutoffs=CUTOFFS, compute_dtype=jnp.float32)(params)
    _close({k: v for k, v in ranks[0][mode]["hook"][0].items() if k in want}, want)


@pytest.fixture(scope="module")
def tools_run(workspace):
    root, ckpt, _ = workspace
    out = str(root / "tools_w2")
    os.makedirs(out)
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", TOK, "--batch_size", "8",
              "--max_query_length", "16", "--max_passage_length", "32", "--device", "cpu"]
    cfg = {"mine_argv": [*common, "--input_file", str(root / "mining.jsonl"),
                         "--num_negatives", "3", "--search_range", "0-12",
                         "--method", "topk,cluster", "--lambda_", "0.5",
                         "--num_clusters", "2", "--seed", "0"],
           "pred_argv": [*common, "--query_data", str(root / "q.jsonl"), "--corpus_data",
                         str(root / "c.jsonl"), "--search_range", "0-8",
                         "--num_predictions", "3"]}
    workers.save(out, "tools_cfg.pt", cfg)
    workers.spawn(sw.tools_worker, 2, out, timeout=150.0)
    return out, cfg


def test_tools_at_two_ranks_write_one_process_files(tools_run, tmp_path):
    out, cfg = tools_run
    get_hard_negatives.main(cfg["mine_argv"] + ["--output_prefix", str(tmp_path / "mined")])
    get_predictions.main(cfg["pred_argv"] + ["--output_file", str(tmp_path / "pairs.jsonl")])
    assert sorted(os.listdir(os.path.join(out, "mined_0"))) == sorted(
        os.listdir(tmp_path / "mined"))
    for name in os.listdir(tmp_path / "mined"):
        got = open(os.path.join(out, "mined_0", name)).read()
        want = open(tmp_path / "mined" / name).read()
        if name == "config.json":  # the arguments, but for the output directory
            got, want = (dict(json.loads(t), output_prefix=None) for t in (got, want))
        assert got == want, name
    assert list(iter_jsonl(os.path.join(out, "pairs_0.jsonl"))) == list(
        iter_jsonl(str(tmp_path / "pairs.jsonl")))
    assert not os.path.exists(os.path.join(out, "mined_1"))
    assert not os.path.exists(os.path.join(out, "pairs_1.jsonl"))
