"""Retrieval evaluation entry point (port of ``rankpo_tpu.cli.evaluate``;
reference src/evaluate.py CLI surface).

    python -m rankpo_tpu_torch.cli.evaluate \\
        --model_name_or_path outputs/stage1 --tokenizer_name hash:128256 \\
        --query_data queries.jsonl --corpus_data corpus.jsonl \\
        --output_dir results --bf16 --k 100 --device cuda

Writes ``<output_dir>/<model>/main.json`` (or ``checkpoint-N.json`` per
checkpoint with ``--evaluate_all_checkpoints``), its ``-indices.npy`` and
``-scores.npy``, and ``all_eval_results.json``. ``--device cuda`` (the
default) fails when no card is visible; ``--device cpu`` runs the plain
PyTorch path.

Over W processes add ``--coordinator_address host:port --num_processes W
--process_id r`` to each (one card per rank under NCCL, or gloo with
``--device cpu``): each rank encodes its own row shard of the corpus into
a sharded index, and rank 0 writes the files.
"""

from __future__ import annotations

import logging

import torch

from rankpo_tpu_torch.cli.arguments import (
    DistributedArguments,
    EvaluateArguments,
    attn_impl_of,
    parse_dataclasses,
    parse_index_kwargs,
    setup_logging,
)
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.eval.evaluator import evaluate_path
from rankpo_tpu_torch.utils.wandb_utils import log_metric_bar_chart, maybe_init_wandb

logger = logging.getLogger(__name__)


def main(argv=None):
    args, dist_args = parse_dataclasses([EvaluateArguments, DistributedArguments], argv)
    setup_logging(args.log_level)
    device, group = dist_args.join(args.device)  # before any loading: no CPU fallback
    logger.info("evaluation arguments:\n%s", args.to_json_string())

    tokenizer = resolve_tokenizer(args.tokenizer_name, args.model_name_or_path)
    cutoffs = [int(c.strip()) for c in args.cutoffs.split(",")]
    # optional wandb metric logging (reference evaluate.py:269-274)
    wandb_log = maybe_init_wandb(args.wandb_project, "auto")
    results = evaluate_path(
        args.model_name_or_path,
        args.query_data,
        args.corpus_data,
        args.output_dir,
        evaluate_all_checkpoints=args.evaluate_all_checkpoints,
        overwrite_output_dir=args.overwrite_output_dir,
        tokenizer=tokenizer,
        device=device,
        batch_size=args.batch_size,
        max_query_length=args.max_query_length,
        max_passage_length=args.max_passage_length,
        k=args.k,
        cutoffs=cutoffs,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        index_type=args.index_type,
        index_recall_target=args.index_recall_target,
        index_kwargs=parse_index_kwargs(args.index_kwargs),
        attn_impl=attn_impl_of(args.attn_implementation),
        group=group,
    )
    for name, metrics in results.items():
        print(f"== {name} ==")
        print("\n".join(f"    {k:15} {v}" for k, v in metrics.items()))
        if wandb_log is not None:
            wandb_log({f"{name}/{k}": v for k, v in metrics.items()})
            log_metric_bar_chart(metrics, name)
    return results


if __name__ == "__main__":
    main()
