"""Prediction-pair generation entry point (port of
``rankpo_tpu.cli.get_predictions``): the (query, passage1, passage2) rows an
AI judge annotates for stage 2.

    python -m rankpo_tpu_torch.cli.get_predictions \\
        --model_name_or_path outputs/stage1 --tokenizer_name hash:128256 \\
        --query_data queries.jsonl --corpus_data corpus.jsonl \\
        --output_file pairs.jsonl --num_predictions 5 --bf16 --device cuda

Over W processes add ``--coordinator_address host:port --num_processes W
--process_id r`` to each: the corpus is row-sharded over the ranks and
rank 0 writes the file.
"""

from __future__ import annotations

import logging

import torch

from rankpo_tpu_torch.cli.arguments import (
    DistributedArguments,
    PredictionArguments,
    parse_dataclasses,
    parse_index_kwargs,
    setup_logging,
)
from rankpo_tpu_torch.cli.run_contrastive import set_seed
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.tools.predictions import generate_predictions

logger = logging.getLogger(__name__)


def main(argv=None):
    args, dist_args = parse_dataclasses([PredictionArguments, DistributedArguments], argv)
    setup_logging(args.log_level)
    device, group = dist_args.join(args.device)  # before any loading: no CPU fallback
    logger.info("prediction arguments:\n%s", args.to_json_string())
    set_seed(args.seed)

    encoder = InferenceEncoder.from_pretrained(
        args.model_name_or_path,
        tokenizer=resolve_tokenizer(args.tokenizer_name, args.model_name_or_path),
        device=device, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    return generate_predictions(
        encoder,
        args.query_data,
        args.corpus_data,
        args.output_file,
        max_query_length=args.max_query_length,
        max_passage_length=args.max_passage_length,
        search_range=args.search_range,
        method=args.method,
        num_predictions=args.num_predictions,
        batch_size=args.batch_size,
        seed=args.seed,
        index_type=args.index_type,
        index_recall_target=args.index_recall_target,
        index_kwargs=parse_index_kwargs(args.index_kwargs),
        group=group,
    )


if __name__ == "__main__":
    main()
