"""Multi-process serving of the PyTorch port (``serve/multihost.py``,
``RetrievalService(group=)``, ``cli.serve`` with the three process flags)
over two gloo processes, against one process's ``RetrievalService`` fed the
same calls.

A tiny llama (2 layers, width 64) in fp32 over 50 passages; the flat tier
and the refine tier (its candidate count past the corpus, so both reranks
are exhaustive). Hits equal one process's: the indices and passages bit
for bit, the scores within 1e-6 (each rank encodes its own shard of the
corpus in batches of its own, and a passage's fp32 embedding may move by an
ulp with its batch; the scores measured 3e-8 apart). A request that
fails validation raises on rank 0 and broadcasts nothing; a dispatch that
fails on every rank after its broadcast leaves the follower serving; an
over-limit payload raises; an idle follower outlives a wait longer than the
control group's timeout (3 s here) through rank 0's keep-alive. The saved
file loads in one process with the same hits. A follower that dies fails
rank 0's next request. ``cli.serve`` as two subprocesses answers
``/search`` as one process does and both exit 0 on SIGTERM to rank 0.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from rankpo_tpu_torch.cli import serve as cli
from rankpo_tpu_torch.models import llama
from rankpo_tpu_torch.models.config import tiny_llama_config
from rankpo_tpu_torch.models.hf_io import save_pretrained

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
import torch_serve_workers as sw  # noqa: E402
from test_torch_multiprocess_eval import _free_port  # noqa: E402

torch.set_num_threads(2)

CONTROL_TIMEOUT_S = 3.0
IDLE_S = 5.0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    cfg = tiny_llama_config(vocab_size=256)
    ckpt = str(root / "model")
    save_pretrained(ckpt, cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(11)
    docs = [f"doc {i} " + " ".join(f"w{j}" for j in rng.integers(0, 60, rng.integers(2, 25)))
            for i in range(50)]
    (root / "c.jsonl").write_text("\n".join(json.dumps({"text": t}) for t in docs))
    return root, {"ckpt": ckpt, "tokenizer": "hash:256", "corpus": str(root / "c.jsonl"),
                  "control_timeout": CONTROL_TIMEOUT_S, "idle_s": IDLE_S}


@pytest.fixture(scope="module")
def frontend_run(workspace):
    root, cfg = workspace
    out = str(root / "frontend")
    os.makedirs(out)
    workers.save(out, "serve_cfg.pt", cfg)
    workers.spawn(sw.multihost_worker, 2, out, timeout=150.0)
    return out, {tier: [workers.load(out, f"serve_{tier}_{r}.pt") for r in range(2)]
                 for tier in ("flat", "refine")}


SCORE_TOL = 1e-6


def _same_hits(got, want, tol=SCORE_TOL):
    """Results of the same calls: everything equal but the scores, which
    are held within ``tol``."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_hits(g, w, tol)
    elif isinstance(want, dict) and "hits" in want:
        assert got["query"] == want["query"]
        assert [(h["index"], h.get("passage")) for h in got["hits"]] == [
            (h["index"], h.get("passage")) for h in want["hits"]]
        np.testing.assert_allclose([h["score"] for h in got["hits"]],
                                   [h["score"] for h in want["hits"]], atol=tol, rtol=0)
    else:
        assert got == want


@pytest.mark.parametrize("tier", ["flat", "refine"])
def test_frontend_hits_equal_one_process(workspace, frontend_run, tier):
    _, cfg = workspace
    out, ranks = frontend_run
    one = sw.make_service(cfg, tier, None)
    _same_hits(ranks[tier][0]["calls"], sw.serve_ops(one))
    _same_hits(ranks[tier][0]["after"], one.query(["w1 w2 w3", "doc 4"], k=5))
    assert ranks[tier][1]["ntotal"] == one.ntotal
    # the W = 2 file restarts one process with the W = 2 server's hits, bit for bit
    loaded = sw.make_service(cfg, tier, None)
    loaded.load_index_file(os.path.join(out, f"saved_{tier}.npz"))
    assert loaded.query(["w1 w2 w3", "doc 4"], k=5) == ranks[tier][0]["after"]


@pytest.mark.parametrize("tier", ["flat", "refine"])
def test_failures_stay_on_rank0_and_the_follower_serves_on(frontend_run, tier):
    _, ranks = frontend_run
    lead, follower = ranks[tier][0], ranks[tier][1]
    checks = lead["checks"]
    assert checks["validation"] == ["ValueError", "IndexError", "ValueError", "ValueError",
                                    "ValueError"]
    assert checks["sent_by_failed_validation"] == 0
    assert "exceeds max_payload_bytes" in checks["payload"]
    assert "out of range" in checks["failed_dispatch"]
    # the follower replayed every dispatch rank 0 sent, the failed one too
    assert follower["n_dispatches"] == lead["n_dispatches"]
    assert lead["saved"]


def test_idle_follower_outlives_the_control_timeout(frontend_run):
    """The flat run sleeps ``IDLE_S`` on rank 0 with nothing to dispatch,
    longer than the control group's timeout: the follower still answers the
    next request (``after``) and stops with rank 0."""
    assert IDLE_S > CONTROL_TIMEOUT_S
    _, ranks = frontend_run
    assert ranks["flat"][0]["after"][0]["hits"]
    assert ranks["flat"][1]["n_dispatches"] == ranks["flat"][0]["n_dispatches"]


def test_a_dead_follower_fails_rank0(workspace):
    """A follower that dies: rank 0's next request raises, the frontend
    records the failure and calls ``on_failure`` (``cli.serve`` then shuts
    the server down and exits non-zero)."""
    root, cfg = workspace
    out = str(root / "dead")
    os.makedirs(out)
    workers.save(out, "serve_cfg.pt", cfg)
    workers.spawn(sw.dead_follower_worker, 2, out, timeout=120.0)
    got = workers.load(out, "dead_follower.pt")
    assert "a rank is gone" in got["error"]
    assert got["called"] == [True] and got["failure"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_cli_serve_two_subprocesses(workspace, tmp_path):
    _, cfg = workspace
    port, rdv = _free_port(), _free_port()
    argv = ["--model_name_or_path", cfg["ckpt"], "--tokenizer_name", cfg["tokenizer"],
            "--corpus_data", cfg["corpus"], "--device", "cpu", "--max_query_length", "32",
            "--max_passage_length", "64", "--batch_size", "16", "--log_level", "warning"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rankpo_tpu_torch.cli.serve", *argv, "--port", str(port),
         "--coordinator_address", f"127.0.0.1:{rdv}", "--num_processes", "2",
         "--process_id", str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    queries = ["w3 w7", "doc 12 w1", "w40 w41 w42"]
    try:
        t0 = time.time()
        while True:
            try:
                if _get(port, "/healthz")["ntotal"] == 50:
                    break
            except OSError:
                pass
            assert time.time() - t0 < 90 and all(p.poll() is None for p in procs)
            time.sleep(0.3)
        got = _post(port, "/search", {"queries": queries, "k": 5})["results"]
        single = _post(port, "/search", {"query": queries[1], "k": 5})["results"]
        procs[0].send_signal(signal.SIGTERM)
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    server = cli.make_server(argv + ["--port", "0"])
    try:
        want = server.service.query(queries, k=5)
    finally:
        server.batcher.close()
        server.server_close()
    _same_hits(got, want)
    _same_hits(single, [got[1]])  # one query alone: its own batch
