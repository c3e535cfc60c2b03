"""Checkpoint-walking retrieval evaluator (port of
``rankpo_tpu.eval.evaluator``; reference src/evaluate.py).

Walk a model tree for checkpoints (a ``config.json`` marks one), skip those
already evaluated unless told to overwrite, then per checkpoint: encode the
queries (to the host) and the corpus (kept on the device), build the index
there from the corpus embeddings, search top-k, compute the metrics, and
write ``<checkpoint>.json`` (or ``main.json``), ``-indices.npy`` (int64) and
``-scores.npy`` (fp32), then the aggregate ``all_eval_results.json`` rebuilt
from the files on disk.

Several processes (``group=``, the data group): each rank encodes the
queries whole and only its own row shard of the corpus
(``InferenceEncoder.encode_shard``), the index is row-sharded over the
group (``index/flat.py``, ``index/refined.py``) and every rank gets the same
hits and metrics. As in the JAX version, rank 0's file system decides
whether a checkpoint is skipped (broadcast to every rank, so none runs a
collective encode the others skip) and rank 0 alone writes the metrics,
the arrays and the aggregate. An IVF index shards its whole clusters over
the group (``index/ivf.py`` ``from_sharded``, as the JAX evaluator builds
it), its PQ codes and the PCA hybrid too.
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.datasets import load_eval_corpus, load_eval_queries
from rankpo_tpu_torch.eval.metrics import compute_metrics
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import (
    build_offline_index,
    resolve_index_spec,
)

logger = logging.getLogger(__name__)


def get_save_path(
    model_path: str,
    output_dir: str,
    can_overwrite: bool = True,
    file_type: str = "json",
    create: bool = True,
) -> str:
    """Result-path convention (reference evaluate.py:42-80):
    ``models/run-x/checkpoint-N`` -> ``output_dir/run-x/checkpoint-N.json``;
    a bare model dir -> ``output_dir/<name>/main.json``."""
    segs = os.path.normpath(model_path).split(os.sep)
    if len(segs) >= 2 and segs[-1].startswith("checkpoint-"):
        out = os.path.join(output_dir, segs[-2])
        filename = f"{segs[-1]}.{file_type}"
    else:
        out = os.path.join(output_dir, segs[-1])
        filename = f"main.{file_type}"
    if create:
        os.makedirs(out, exist_ok=True)
    path = os.path.join(out, filename)
    if not can_overwrite and os.path.isfile(path):
        stem, ext = filename.rsplit(".", 1)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        path = os.path.join(out, f"{stem}_{stamp}.{ext}")
    return path


def find_checkpoints(model_path: str) -> List[str]:
    """Every directory under model_path containing a config.json
    (reference evaluate.py:86-94)."""
    found = []
    for dirpath, _dirnames, filenames in os.walk(model_path):
        if "config.json" in filenames:
            found.append(dirpath)
    return sorted(found)


def evaluate_checkpoint(
    model_path: str,
    query_texts: Sequence[str],
    labels: Sequence[Sequence[int]],
    corpus_texts: Sequence[str],
    *,
    tokenizer=None,
    device="cuda",
    batch_size: int = 256,
    max_query_length: int = 32,
    max_passage_length: int = 128,
    k: int = 100,
    cutoffs: Sequence[int] = (1, 5, 10, 20, 100),
    encoder: Optional[InferenceEncoder] = None,
    compute_dtype=None,
    index_type: str = "flat",
    index_recall_target: float = 0.95,
    index_kwargs: Optional[dict] = None,
    attn_impl: str = "auto",
    group=None,
):
    """Encode -> index -> search -> metrics for one checkpoint.

    Returns ``(metrics, indices, scores)``: the metric dict plus the raw
    [Q, k] search arrays the caller saves. ``index_type``: "flat" (exact,
    FAISS IndexFlatIP order), "refine" (PCA prefilter and exact rerank) or
    "ivf" (both approximate, tuned to ``index_recall_target``), or a
    factory spec such as "IVF4096,PQ64" or "PCA128,Flat". ``attn_impl``:
    the encoder's attention dispatch ("auto", "plain" or "flash") when it
    loads the checkpoint. ``group``: the data group the corpus is
    row-sharded over (a collective; every rank returns the same)."""
    # an invalid spec fails here, not after the corpus encode
    index_type, index_kwargs = resolve_index_spec(index_type, index_kwargs)
    if encoder is None:
        kwargs = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
        encoder = InferenceEncoder.from_pretrained(
            model_path, tokenizer=tokenizer, device=device, attn_impl=attn_impl, **kwargs)
    q_emb = encoder.encode(list(query_texts), batch_size=batch_size,
                           max_length=max_query_length)
    # the corpus embeddings feed only the index: they stay on the device
    if group is None:
        c_emb, n_corpus = encoder.encode_device(
            list(corpus_texts), batch_size=batch_size, max_length=max_passage_length)
    else:  # this rank's shard; a live model runs as many batches on every rank
        c_emb, n_corpus = encoder.encode_shard(
            list(corpus_texts), mesh.group_size(group), mesh.group_index(group),
            batch_size=batch_size, max_length=max_passage_length,
            group=group if encoder.live_model else None)
    index = build_offline_index(c_emb, n_corpus, index_type, index_kwargs,
                                index_recall_target, group=group)
    scores, indices = index.search(q_emb, k=k, batch_size=batch_size)
    invalid = indices < 0
    if invalid.any():
        # IVF pads unreachable tail slots with -1/-inf (FAISS IVF
        # semantics); sklearn's AUC/nDCG reject infinities, so clamp the
        # pad scores below every real score. The -1 ids never match a
        # label, so rank-based metrics already treat them as misses.
        finite_floor = float(scores[~invalid].min()) if (~invalid).any() else 0.0
        scores = np.where(invalid, finite_floor - 1.0, scores)
    metrics = compute_metrics(indices, scores, labels, cutoffs=list(cutoffs))
    return metrics, indices, scores


def evaluate_path(
    model_path: str,
    query_data: str,
    corpus_data: str,
    output_dir: str,
    *,
    evaluate_all_checkpoints: bool = False,
    overwrite_output_dir: bool = False,
    tokenizer=None,
    device="cuda",
    batch_size: int = 256,
    max_query_length: int = 32,
    max_passage_length: int = 128,
    k: int = 100,
    cutoffs: Sequence[int] = (1, 5, 10, 20, 100),
    save_arrays: bool = True,
    compute_dtype=None,
    index_type: str = "flat",
    index_recall_target: float = 0.95,
    index_kwargs: Optional[dict] = None,
    attn_impl: str = "auto",
    group=None,
) -> Dict[str, Dict[str, float]]:
    """Full harness over one model dir or all its checkpoints; returns the
    metrics of the checkpoints evaluated in this call, by result name.
    ``group``: the data group of a multi-process run (module docstring);
    every rank returns the same metrics, rank 0 alone writes."""
    queries, labels = load_eval_queries(query_data)
    corpus = load_eval_corpus(corpus_data)
    logger.info("eval: %d queries over %d corpus items", len(queries), len(corpus))

    if evaluate_all_checkpoints:
        models = find_checkpoints(model_path)
    else:
        models = (
            [model_path]
            if os.path.isfile(os.path.join(model_path, "config.json"))
            else []
        )
    if not models:
        logger.error("no checkpoint found under %s", model_path)
        return {}

    main = mesh.is_main_process()
    results: Dict[str, Dict[str, float]] = {}
    save_path = None
    for model in models:
        save_path = get_save_path(model, output_dir, can_overwrite=True, create=main)
        skip = os.path.isfile(save_path) and not overwrite_output_dir
        if group is not None:
            # rank 0's file system decides for every rank: only rank 0
            # writes results, and a rank that skipped would leave the
            # others' collective encode one rank short
            skip = mesh.broadcast_object(skip)
        if skip:
            logger.warning("skip %s: results exist at %s", model, save_path)
            continue
        logger.info("evaluating %s", model)
        metrics, indices, scores = evaluate_checkpoint(
            model, queries, labels, corpus,
            tokenizer=tokenizer, device=device, batch_size=batch_size,
            max_query_length=max_query_length,
            max_passage_length=max_passage_length, k=k, cutoffs=cutoffs,
            compute_dtype=compute_dtype, index_type=index_type,
            index_recall_target=index_recall_target, index_kwargs=index_kwargs,
            attn_impl=attn_impl, group=group,
        )
        if not main:  # rank 0 owns the files
            results[os.path.basename(save_path).split(".")[0]] = metrics
            continue
        with open(save_path, "w") as f:
            json.dump(metrics, f, indent=4)
        if save_arrays:
            stem = save_path.rsplit(".", 1)[0]
            # int64, the dtype FAISS search returns (npy drop-in compatible)
            np.save(stem + "-indices.npy", indices.astype(np.int64))
            np.save(stem + "-scores.npy", scores.astype(np.float32))
        results[os.path.basename(save_path).split(".")[0]] = metrics
        logger.info("results: %s", metrics)

    # aggregate (reference evaluate.py:281-287), rebuilt from the on-disk
    # per-checkpoint metrics so previously skipped checkpoints are included
    # and the file never goes stale after an incremental re-run
    if save_path is not None and main:
        agg_results: Dict[str, Dict[str, float]] = {}
        for model in models:
            sp = get_save_path(model, output_dir, can_overwrite=True)
            if os.path.isfile(sp):
                with open(sp) as f:
                    agg_results[os.path.basename(sp).split(".")[0]] = json.load(f)
        if agg_results:
            agg = os.path.join(os.path.dirname(save_path), "all_eval_results.json")
            with open(agg, "w") as f:
                json.dump(agg_results, f, indent=4)
    if group is not None:  # the files exist when any rank returns
        dist.barrier(group=mesh.control_group())
    return results
