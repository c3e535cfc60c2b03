"""Worker processes for the multi-process evaluation and serving tests of
the PyTorch port (``test_torch_sharded_index.py``,
``test_torch_multiprocess_eval.py``, ``test_torch_multihost_serve.py``),
run by ``torch_dist_workers.spawn`` in two gloo processes.

Each worker lays the ranks out on one data group (``core/mesh.py``
``make_groups``) and saves what it computed beside the test's files. The
operations are plain functions of a data group, so the tests run the same
ones in one process (``group=None``) for the comparison. This module
imports torch and the port only: the workers never load jax.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from torch_dist_workers import load, save


def data_group():
    from rankpo_tpu_torch.core import mesh

    return mesh.make_groups(mesh.MeshConfig()).data


def shard_of(x: np.ndarray, group) -> torch.Tensor:
    """This rank's shard of ``x`` in the sharded layout (zero pad rows)."""
    from rankpo_tpu_torch.core import mesh

    dp, d = mesh.group_size(group), mesh.group_index(group)
    lo, hi = mesh.shard_bounds(mesh.padded_rows(len(x), dp), dp, d)
    out = np.zeros((hi - lo, x.shape[1]), np.float32)
    rows = x[lo:min(hi, len(x))]
    out[: len(rows)] = rows
    return torch.from_numpy(out)


# ---------------------------------------------------------------------------
# sharded index tiers

FLAT_CHAIN = [("append", (200, 250), 0.5), ("append", (250, 260), 0.0),
              ("remove", [0, 7, 100, 255]), ("append", (260, 300), 0.25),
              ("remove", list(range(0, 290, 3)))]
RADII = (0.4, 0.1, 2.0)


def filters(n: int) -> dict:
    ids = np.sort(np.random.default_rng(3).choice(n, 120, replace=False))
    mask = np.zeros(n, bool)
    mask[ids] = True
    return {"allowed": {"allowed_ids": ids}, "disallowed": {"disallowed_ids": ids},
            "selector": {"selector": mask}, "few": {"allowed_ids": ids[:4]}}


def flat_ops(data: dict, dtype: str, group) -> dict:
    """Every search of the flat tier the sharded test holds to JAX and to
    one process: built (constructor and from_sharded), ties, filters, the
    mutation chain and range searches."""
    from rankpo_tpu_torch.index.flat import FlatIPIndex

    dt = getattr(torch, dtype)
    x, q = data["x"], data["q"]
    out = {}
    index = FlatIPIndex(x, dtype=dt, group=group)
    out["search"] = index.search(q, k=10, batch_size=4)
    out["search_all"] = index.search(q, k=len(x) + 5)
    rows = shard_of(x, group) if group is not None else torch.from_numpy(x)
    out["from_sharded"] = FlatIPIndex.from_sharded(rows, len(x), dtype=dt,
                                                   group=group).search(q, k=10)
    out["ties"] = FlatIPIndex(data["ties"], dtype=dt, group=group).search(data["tq"], k=25)
    for form, kw in filters(len(x)).items():
        out[f"filter_{form}"] = index.search(q, k=10, **kw)
    rows = shard_of(x[:200], group) if group is not None else torch.from_numpy(x[:200])
    p = FlatIPIndex.from_sharded(rows, 200, dtype=dt, group=group)
    chain = []
    for op, arg, *headroom in FLAT_CHAIN:
        if op == "append":
            p = p.append_sharded(torch.from_numpy(x[arg[0]:arg[1]]), arg[1] - arg[0],
                                 headroom=headroom[0])
        else:
            p = p.remove_rows(arg)
        chain.append((p.ntotal, p.reconstruct(np.arange(p.ntotal)), p.search(q, k=10)))
    out["chain"] = chain
    out["range"] = [index.range_search(q, r, batch_size=4) for r in RADII]
    return out


def refine_ops(data: dict, state_path: str, group) -> dict:
    """The refine tier: a carried index (searches, filters, mutation,
    reconstruct) and both builds (tuned C and hits)."""
    from rankpo_tpu_torch.index import io
    from rankpo_tpu_torch.index.refined import RefineIPIndex

    q, xs, qs = data["q"], data["xs"], data["qs"]
    out = {}
    r = io.read_index(state_path, device="cpu", group=group)
    for c in (None, 40, 300):
        out[f"search_{c}"] = r.search(qs, k=10, candidates=c)
    for form, kw in filters(len(xs)).items():
        out[f"filter_{form}"] = r.search(qs, k=10, **kw)
    chain = []
    for step in range(3):
        if step == 1:
            r = r.remove_rows([0, 5, 999, 1500])
        else:
            lo = 1000 + 100 * step
            r = r.append_sharded(torch.from_numpy(data["extra"][lo - 1000:lo - 900]), 100,
                                 headroom=0.5)
        chain.append((r.ntotal, r.reconstruct(np.arange(r.ntotal)), r.search(qs, k=10)))
    out["chain"] = chain
    kw = dict(reduced_dim=12, recall_target=0.9, tune_sample=64, tune_k=10,
              store_dtype="bfloat16")
    built = RefineIPIndex(xs, group=group, **kw)
    rows = shard_of(xs, group) if group is not None else torch.from_numpy(xs)
    built_sh = RefineIPIndex.from_sharded(rows, len(xs), group=group, **kw)
    for name, b in (("built", built), ("built_sharded", built_sh)):
        out[name] = (b.candidates, b.proj.numpy(), b.search(qs, k=10))
    return out


def sharded_index_worker(rank, world, out):
    from rankpo_tpu_torch.index import io
    from rankpo_tpu_torch.index.flat import FlatIPIndex

    group = data_group()
    data = load(out, "index_data.pt")
    res = {dtype: flat_ops(data, dtype, group) for dtype in ("float32", "bfloat16", "int8")}
    res["refine"] = refine_ops(data, os.path.join(out, "refine_jax.npz"), group)
    # files across shard counts: the one-process file here, this one there
    w1 = io.read_index(os.path.join(out, "flat_w1.npz"), device="cpu", group=group)
    res["from_w1_file"] = w1.search(data["q"], k=10)
    index = FlatIPIndex(data["x"], dtype=torch.int8, group=group)
    io.write_index(index, os.path.join(out, "flat_w2.npz"))
    res["w2_file_source"] = index.search(data["q"], k=10)
    save(out, f"index_{rank}.pt", res)


# ---------------------------------------------------------------------------
# evaluation, the in-training hook and the tools

def eval_worker(rank, world, out):
    """``evaluate_path`` at W = 2 (each rank its own output directory, as on
    host-local disks), then again over a result file only rank 0 has."""
    from rankpo_tpu_torch.data.tokenization import HashTokenizer
    from rankpo_tpu_torch.eval.evaluator import evaluate_path

    group = data_group()
    cfg = load(out, "eval_cfg.pt")
    tok = HashTokenizer(256)
    res = {}
    for tier in ("flat", "refine"):
        res[tier] = evaluate_path(
            cfg["ckpt"], cfg["queries"], cfg["corpus"], os.path.join(out, f"w2_{tier}_{rank}"),
            device="cpu", batch_size=cfg["batch_size"], compute_dtype=torch.float32, k=20,
            cutoffs=(1, 5, 10, 20), index_type=tier, tokenizer=tok, group=group)
    # rank 0's directory holds the flat results, rank 1's a fresh directory:
    # both ranks must skip as rank 0's file system says
    res["skip"] = evaluate_path(
        cfg["ckpt"], cfg["queries"], cfg["corpus"],
        os.path.join(out, "w2_flat_0") if rank == 0 else os.path.join(out, "fresh_1"),
        device="cpu", batch_size=cfg["batch_size"], compute_dtype=torch.float32, k=20,
        cutoffs=(1, 5, 10, 20), tokenizer=tok, group=group)
    try:
        evaluate_path(cfg["ckpt"], cfg["queries"], cfg["corpus"], os.path.join(out, "ivf"),
                      device="cpu", index_type="ivf", tokenizer=tok, group=group)
    except NotImplementedError as e:
        res["ivf_error"] = str(e)
    res["filler"] = _filler_batches(group, tok)
    from rankpo_tpu_torch.cli import autotune
    from rankpo_tpu_torch.eval.in_training import RetrievalEvalHook

    for name, call in (
            ("autotune", lambda: autotune.main(["--synthetic_rows", "64", "--synthetic_dim",
                                                "8", "--device", "cpu"])),
            ("hook", lambda: RetrievalEvalHook(tok, cfg["queries"], cfg["corpus"],
                                               index_type="IVF16,Flat"))):
        try:
            call()
        except NotImplementedError as e:
            res[f"{name}_error"] = str(e)
    save(out, f"eval_{rank}.pt", res)


def _filler_batches(group, tok) -> dict:
    """``encode_shard`` of 5 texts at batch 2 with a live model: shard 0
    holds 3 texts (2 batches), shard 1 holds 2 (1 batch and 1 filler)."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.models.config import tiny_llama_config

    cfg = tiny_llama_config(vocab_size=256)
    model = llama.LlamaEncoder.for_training(
        cfg, llama.init_params(cfg, torch.Generator().manual_seed(0)), device="cpu",
        compute_dtype=torch.float32)
    encoder = InferenceEncoder(cfg, None, tok, model=model)
    calls = []
    embed = encoder.embed_batch
    encoder.embed_batch = lambda batch: calls.append(batch["input_ids"].shape) or embed(batch)
    texts = [f"text {i} " + "w " * i for i in range(5)]
    shard, n = encoder.encode_shard(texts, 2, mesh.group_index(group), batch_size=2,
                                    group=group)
    batches = len(calls)
    lo, hi = mesh.shard_bounds(mesh.padded_rows(5, 2), 2, mesh.group_index(group))
    alone = encoder.encode_device(texts[lo:min(hi, 5)], batch_size=2)[0]
    return {"batches": batches, "n": n, "rows": shard.shape[0],
            "equal": bool(torch.equal(shard[: alone.shape[0]], alone)),
            "pad_zero": bool((shard[alone.shape[0]:] == 0).all())}


def hook_worker(rank, world, out):
    """For each of ZeRO-1, fsdp and ``--model_parallel 2``: stage 1 through
    ``run_contrastive.main`` at W = 2 with the retrieval hook firing at step
    2 and a checkpoint saved there, then ``cli.evaluate`` at W = 2 over that
    checkpoint."""
    from rankpo_tpu_torch.cli import evaluate as cli_eval
    from rankpo_tpu_torch.cli import run_contrastive

    cfg = load(out, "hook_cfg.pt")
    res = {}
    for mode, extra in (("zero1", ["--zero1", "True"]), ("fsdp", ["--fsdp", "True"]),
                        ("mp", ["--model_parallel", "2"])):
        run_dir = os.path.join(out, f"run_{mode}")
        history = run_contrastive.main(cfg["argv"] + ["--output_dir", run_dir, *extra])
        offline = cli_eval.main(cfg["eval_argv"] + [
            "--model_name_or_path", os.path.join(run_dir, "checkpoint-2"),
            "--output_dir", os.path.join(out, f"offline_{mode}_{rank}")])
        res[mode] = {"hook": [h for h in history if "retrieval_MRR@1" in h],
                     "offline": offline}
    save(out, f"hook_{rank}.pt", res)


def tools_worker(rank, world, out):
    """``get_hard_negatives`` and ``get_predictions`` at W = 2, each rank
    naming its own output (only rank 0's may appear)."""
    from rankpo_tpu_torch.cli import get_hard_negatives, get_predictions

    cfg = load(out, "tools_cfg.pt")
    get_hard_negatives.main(cfg["mine_argv"] + ["--output_prefix",
                                                os.path.join(out, f"mined_{rank}")])
    get_predictions.main(cfg["pred_argv"] + ["--output_file",
                                             os.path.join(out, f"pairs_{rank}.jsonl")])


# ---------------------------------------------------------------------------
# serving

def serve_ops(service, frontend=None) -> list:
    """The calls the multihost test feeds a one-process service and the
    two-process frontend alike; returns each call's result."""
    f = frontend or service
    texts = [f"q w{i} w{i + 3} w{2 * i}" for i in range(6)]
    res = [f.query(texts[0], k=5), f.query(texts, k=8),
           f.query(texts[:3], k=5, allowed_ids=[1, 4, 9, 16, 25, 36]),
           f.query(texts[:3], k=5, disallowed_ids=list(range(0, 40, 2)))]
    f.add_passages([f"added w{i} w{i + 1} passage" for i in range(7)])
    res.append(f.query(texts, k=8))
    res.append(f.remove_passages([0, 3, 44, 45]))
    res.append(f.query(texts, k=8))
    res.append(f.query(texts[:2], k=6, candidates=64) if service.index_type == "refine"
               else f.query(texts[:2], k=6))
    return res


def multihost_worker(rank, world, out):
    """Each tier's service over the data group behind a frontend: rank 0
    feeds it ``serve_ops`` and the failure cases, the follower replays."""
    from rankpo_tpu_torch.core import mesh

    cfg = load(out, "serve_cfg.pt")
    mesh.control_group(timeout_s=cfg["control_timeout"])  # before anything else uses it
    group = data_group()
    for tier in ("flat", "refine"):
        _serve_tier(rank, out, cfg, tier, group, idle=tier == "flat")


def _serve_tier(rank, out, cfg, tier, group, idle: bool):
    from rankpo_tpu_torch.serve.multihost import MultihostFrontend

    service = make_service(cfg, tier, group)
    frontend = MultihostFrontend(service)
    if rank != 0:
        frontend.follower_loop()
        save(out, f"serve_{tier}_{rank}.pt", {"n_dispatches": frontend.n_dispatches,
                                               "ntotal": service.ntotal})
        return
    res = {"calls": serve_ops(service, frontend)}
    checks = {}
    sent = frontend.n_dispatches
    for bad in (lambda: frontend.query([1, 2], k=3),
                lambda: frontend.query("x", k=3, allowed_ids=[10 ** 6]),
                lambda: frontend.remove_passages([10 ** 6]),
                lambda: frontend.add_passages([]),
                lambda: frontend.query("x", k=3, nprobe=4)):
        try:
            bad()
            checks.setdefault("validation", []).append("no error")
        except (ValueError, IndexError) as e:
            checks.setdefault("validation", []).append(type(e).__name__)
    checks["sent_by_failed_validation"] = frontend.n_dispatches - sent
    frontend.max_payload = 4096
    try:
        frontend.query(["w" * 5000], k=3)
    except ValueError as e:
        checks["payload"] = str(e)
    frontend.max_payload = 1 << 24
    # a dispatch that fails on every rank after it was broadcast: the
    # follower logs it and serves on
    with frontend._lock:
        frontend._broadcast({"op": "remove", "ids": [10 ** 6]})
        try:
            service.remove_passages([10 ** 6])
        except ValueError as e:
            checks["failed_dispatch"] = str(e)
    if idle:  # past the control group's timeout: the keep-alive holds the follower
        time.sleep(cfg["idle_s"])
    res["after"] = frontend.query(["w1 w2 w3", "doc 4"], k=5)
    path = os.path.join(out, f"saved_{tier}.npz")
    frontend.save_index(path)
    res["saved"] = os.path.exists(path)
    frontend.stop()
    res["checks"] = checks
    res["n_dispatches"] = frontend.n_dispatches
    save(out, f"serve_{tier}_0.pt", res)


def dead_follower_worker(rank, world, out):
    """Rank 1 dies after the frontend is made; rank 0's next request must
    raise, record the failure and call ``on_failure``. Both leave with
    ``os._exit``: the group's closing barrier has one rank gone."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.serve.multihost import MultihostFrontend

    cfg = load(out, "serve_cfg.pt")
    mesh.control_group(timeout_s=cfg["control_timeout"])
    service = make_service(cfg, "flat", data_group())
    called = []
    frontend = MultihostFrontend(service, on_failure=lambda: called.append(True))
    if rank == 1:
        os._exit(0)
    time.sleep(1.0)
    try:
        frontend.query("w1 w2", k=3)
        error = None
    except RuntimeError as e:
        error = str(e)
    save(out, "dead_follower.pt", {"error": error, "called": called,
                                   "failure": frontend.failure is not None})
    os._exit(0)


def make_service(cfg: dict, tier: str, group):
    from rankpo_tpu_torch.data.datasets import load_eval_corpus
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.models.hf_io import load_pretrained
    from rankpo_tpu_torch.serve.service import RetrievalService

    config, state = load_pretrained(cfg["ckpt"])
    encoder = InferenceEncoder(config, state, resolve_tokenizer(cfg["tokenizer"], cfg["ckpt"]),
                               device="cpu", compute_dtype=torch.float32)
    # refine: C past the corpus, so the sharded and one-process reranks are exhaustive
    kwargs = {"reduced_dim": 16, "candidates": 64} if tier == "refine" else {}
    service = RetrievalService(encoder, max_query_length=32, index_type=tier,
                               index_kwargs=kwargs, group=group)
    service.build_index(load_eval_corpus(cfg["corpus"]), max_passage_length=64,
                        batch_size=16)
    return service
