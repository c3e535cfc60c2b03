"""Hard-negative mining entry point (port of
``rankpo_tpu.cli.get_hard_negatives``; reference src/get_hard_negatives.py).

    python -m rankpo_tpu_torch.cli.get_hard_negatives \\
        --model_name_or_path outputs/stage1 --tokenizer_name hash:128256 \\
        --input_file mining.jsonl --output_prefix mined \\
        --method topk,cluster --lambda_ 0.5 --num_negatives 10 \\
        --search_range 0-100 --bf16 --device cuda

Writes ``config.json`` (the arguments) and one jsonl per method into
``--output_prefix`` (``cluster<λ·10>.jsonl`` per λ for the cluster policy).
Over W processes add ``--coordinator_address host:port --num_processes W
--process_id r`` to each: the corpus is row-sharded over the ranks and
rank 0 writes the files.
"""

from __future__ import annotations

import logging
import os

import torch

from rankpo_tpu_torch.cli.arguments import (
    DistributedArguments,
    HardNegativeArguments,
    parse_dataclasses,
    parse_index_kwargs,
    setup_logging,
)
from rankpo_tpu_torch.cli.run_contrastive import set_seed
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.tools.hard_negatives import find_hard_negatives

logger = logging.getLogger(__name__)


def main(argv=None):
    args, dist_args = parse_dataclasses([HardNegativeArguments, DistributedArguments], argv)
    setup_logging(args.log_level)
    device, group = dist_args.join(args.device)  # before any loading: no CPU fallback
    logger.info("hard-negative arguments:\n%s", args.to_json_string())
    set_seed(args.seed)

    if mesh.is_main_process():  # rank 0 writes the run's files
        os.makedirs(args.output_prefix, exist_ok=True)
        with open(os.path.join(args.output_prefix, "config.json"), "w") as f:
            f.write(args.to_json_string())

    encoder = InferenceEncoder.from_pretrained(
        args.model_name_or_path,
        tokenizer=resolve_tokenizer(args.tokenizer_name, args.model_name_or_path),
        device=device, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    return find_hard_negatives(
        encoder,
        args.input_file,
        args.output_prefix,
        max_query_length=args.max_query_length,
        max_passage_length=args.max_passage_length,
        num_negatives=args.num_negatives,
        search_range=args.search_range,
        method=args.method,
        batch_size=args.batch_size,
        num_clusters=args.num_clusters,
        lambda_=args.lambda_,
        seed=args.seed,
        index_type=args.index_type,
        index_recall_target=args.index_recall_target,
        index_kwargs=parse_index_kwargs(args.index_kwargs),
        group=group,
    )


if __name__ == "__main__":
    main()
