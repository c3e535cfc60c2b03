"""Index auto-tune entry point, the FAISS ParameterSpace / autotune analog
(port of ``rankpo_tpu.cli.autotune``; ``tools/autotune.py``). Given corpus
embeddings (a .npy file, a jsonl corpus to encode, or a synthetic corpus),
benchmark the candidate factory-spec ladder on the card and print one JSON
report with the recommended spec.

    # a real corpus through a trained encoder
    python -m rankpo_tpu_torch.cli.autotune --model_name_or_path out/model \\
        --tokenizer_name hash:128256 --corpus_data corpus.jsonl --k 100

    # precomputed embeddings
    python -m rankpo_tpu_torch.cli.autotune --embeddings corpus_emb.npy

    # a synthetic sweep (power-law spectrum, the realistic regime)
    python -m rankpo_tpu_torch.cli.autotune --synthetic_rows 65536 \\
        --synthetic_dim 2048 --memory_budget_gb 2

``--device cuda`` (the default) fails without a card; ``--device cpu`` runs
the plain PyTorch paths. The exit code is 1 when no spec met the target and
the budget. One process: under a process group of more than one rank it
raises (ROADMAP.md Queue 1, the rest of item 8c: its ladder benchmarks the
IVF tiers, which are not ported over several shards).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

from rankpo_tpu_torch.cli.arguments import setup_logging
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.device import resolve_device

logger = logging.getLogger(__name__)


def _synthetic(n: int, dim: int, seed: int) -> np.ndarray:
    """Blobby power-law corpus (the spectrum real embedding matrices show):
    cluster centres plus scaled noise, unit rows; the JAX CLI's draws."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, int(4 * np.sqrt(n)))
    scale = (np.arange(1, dim + 1, dtype=np.float32)) ** -0.5
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * scale
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    noise = rng.standard_normal((n, dim)).astype(np.float32) * scale
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    rows = centers[assign] + 0.5 * noise
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rankpo_tpu_torch.cli.autotune",
                                     description=__doc__.split("\n")[0])
    src = parser.add_argument_group("embedding source (pick one)")
    src.add_argument("--embeddings", default=None, help=".npy [N, D] fp32 embedding matrix")
    src.add_argument("--corpus_data", default=None,
                     help="jsonl corpus to encode (needs --model_name_or_path)")
    src.add_argument("--synthetic_rows", type=int, default=0,
                     help="> 0: synthesize a power-law blob corpus")
    parser.add_argument("--synthetic_dim", type=int, default=1024)
    parser.add_argument("--model_name_or_path", default=None)
    parser.add_argument("--tokenizer_name", default=None)
    parser.add_argument("--max_passage_length", type=int, default=512)
    parser.add_argument("--encode_batch_size", type=int, default=256)
    parser.add_argument("--k", type=int, default=100)
    parser.add_argument("--recall_target", type=float, default=0.95)
    parser.add_argument("--memory_budget_gb", type=float, default=None)
    parser.add_argument("--specs", default=None,
                        help="';'-separated factory specs (specs contain commas), "
                             "e.g. 'Flat;IVF4096,SQ8;OPQ64,IVF4096,PQ64'")
    parser.add_argument("--n_queries", type=int, default=256)
    parser.add_argument("--search_batch_size", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_file", default=None, help="also write the JSON report here")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no card is visible")
    parser.add_argument("--log_level", default="info")
    args = parser.parse_args(argv)

    setup_logging(args.log_level)
    sources = [bool(args.embeddings), bool(args.corpus_data), args.synthetic_rows > 0]
    if sum(sources) != 1:
        parser.error("pick exactly one of --embeddings / --corpus_data / --synthetic_rows")
    if args.corpus_data and not args.model_name_or_path:
        parser.error("--corpus_data needs --model_name_or_path")
    device = resolve_device(args.device)  # before any loading: no CPU fallback
    if mesh.process_count() > 1:
        raise NotImplementedError(
            f"cli.autotune over {mesh.process_count()} processes is not ported to "
            "rankpo_tpu_torch yet (ROADMAP.md Queue 1, the rest of item 8c: multi-card IVF)")
    if args.embeddings:
        emb = np.asarray(np.load(args.embeddings), np.float32)
    elif args.synthetic_rows:
        emb = _synthetic(args.synthetic_rows, args.synthetic_dim, args.seed)
    else:
        from rankpo_tpu_torch.data.datasets import load_eval_corpus
        from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
        from rankpo_tpu_torch.index.encoding import InferenceEncoder
        from rankpo_tpu_torch.models.hf_io import load_pretrained

        config, state = load_pretrained(args.model_name_or_path)
        tokenizer = resolve_tokenizer(args.tokenizer_name, args.model_name_or_path)
        encoder = InferenceEncoder(config, state, tokenizer, device=device,
                                   compute_dtype=torch.bfloat16)
        del state
        emb = encoder.encode(load_eval_corpus(args.corpus_data),
                             batch_size=args.encode_batch_size,
                             max_length=args.max_passage_length)

    from rankpo_tpu_torch.tools.autotune import autotune_index

    specs = [s.strip() for s in args.specs.split(";") if s.strip()] if args.specs else None
    report = autotune_index(
        emb, k=args.k, recall_target=args.recall_target,
        memory_budget_gb=args.memory_budget_gb, specs=specs, n_queries=args.n_queries,
        batch_size=args.search_batch_size, seed=args.seed, device=device)
    for row in report["results"]:
        if "error" in row:
            logger.info("%-24s FAILED: %s", row["spec"], row["error"])
        else:
            logger.info("%-24s recall %.4f  %10.1f qps  %9.2f MB  build %6.2fs%s",
                        row["spec"], row["recall"], row["qps"], row["memory_mb"],
                        row["build_s"], "  <- feasible" if row["feasible"] else "")
    logger.info("recommended spec: %s", report["best"])
    line = json.dumps(report)
    print(line)
    if args.output_file:
        with open(args.output_file, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    # nonzero when no spec met the target and budget, so that
    # `autotune && deploy` cannot go on with a null recommendation
    sys.exit(0 if main()["best"] is not None else 1)
