"""End-to-end stage-1 iteration loop (port of ``rankpo_tpu.cli.run_pipeline``).

The reference's README pipeline ("Stage 1 iterated n times": rule-labeled
data -> contrastive learning -> hard-negative mining -> retrain) as one
command:

  iteration 0: random-negative bootstrap (get_random_negatives)
  each iteration: contrastive training -> hard-negative mining with the fresh
                  checkpoint -> the next iteration trains on the mined negatives
  finally: prediction pairs for AI annotation (stage-2 input)

    python -m rankpo_tpu_torch.cli.run_pipeline \\
        --model_name_or_path CKPT --tokenizer_name hash:128256 \\
        --raw_data mining.jsonl --output_dir pipeline --iterations 2 \\
        --query_data queries.jsonl --corpus_data corpus.jsonl --bf16 \\
        --device cuda

Input: mining-format jsonl ({"query": {"text"}, "positives": {"text": [...]}}).
"""

from __future__ import annotations

import argparse
import gc
import logging
import os

import torch

from rankpo_tpu_torch.cli.arguments import setup_logging
from rankpo_tpu_torch.core.device import resolve_device

logger = logging.getLogger(__name__)


def _release(device: torch.device) -> None:
    """Return the freed encoder's device memory before the next allocation."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", required=True)
    parser.add_argument("--tokenizer_name", default=None)
    parser.add_argument("--raw_data", required=True,
                        help="mining-format jsonl (query/positives text)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--num_negatives", type=int, default=8)
    parser.add_argument("--mining_method", default="topk")
    parser.add_argument("--search_range", default="0-50")
    parser.add_argument("--num_train_epochs", type=int, default=1)
    parser.add_argument("--per_device_train_batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-5)
    parser.add_argument("--temperature", type=float, default=0.02)
    parser.add_argument("--max_query_length", type=int, default=32)
    parser.add_argument("--max_passage_length", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=64,
                        help="inference batch size for mining")
    parser.add_argument("--query_data", default=None,
                        help="optional eval-format queries: generate stage-2 "
                             "prediction pairs with the final model")
    parser.add_argument("--corpus_data", default=None)
    parser.add_argument("--num_predictions", type=int, default=5)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--gradient_checkpointing", action="store_true",
                        help="recompute each layer's activations in the backward")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log_level", default="info")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no card is visible")
    args = parser.parse_args(argv)

    setup_logging(args.log_level)
    device = resolve_device(args.device)  # before any loading: no CPU fallback
    os.makedirs(args.output_dir, exist_ok=True)

    from rankpo_tpu_torch.cli.run_contrastive import main as run_contrastive
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.tools.hard_negatives import find_hard_negatives
    from rankpo_tpu_torch.tools.random_negatives import find_random_negatives

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    n_mined = max(args.num_negatives * 2, args.num_negatives + 2)

    def load_encoder(path: str) -> InferenceEncoder:
        return InferenceEncoder.from_pretrained(
            path, tokenizer=resolve_tokenizer(args.tokenizer_name, path),
            device=device, compute_dtype=compute_dtype)

    # iteration 0: random-negative bootstrap
    train_file = os.path.join(args.output_dir, "train_iter0.jsonl")
    find_random_negatives(args.raw_data, train_file, num_negatives=n_mined,
                          seed=args.seed)

    model_path = args.model_name_or_path
    for it in range(args.iterations):
        run_dir = os.path.join(args.output_dir, f"iter{it}")
        logger.info("=== iteration %d: training from %s ===", it, model_path)
        run_contrastive([
            "--model_name_or_path", model_path,
            *(["--tokenizer_name", args.tokenizer_name]
              if args.tokenizer_name else []),
            "--train_data", train_file,
            "--output_dir", run_dir,
            "--learning_rate", str(args.learning_rate),
            "--num_train_epochs", str(args.num_train_epochs),
            "--per_device_train_batch_size",
            str(args.per_device_train_batch_size),
            "--num_negatives", str(args.num_negatives),
            "--temperature", str(args.temperature),
            "--max_query_length", str(args.max_query_length),
            "--max_passage_length", str(args.max_passage_length),
            "--bf16", "True" if args.bf16 else "False",
            "--gradient_checkpointing",
            "True" if args.gradient_checkpointing else "False",
            "--seed", str(args.seed),
            "--save_strategy", "no",
            "--overwrite_output_dir",
            "--log_level", args.log_level,
            "--device", args.device,
        ])
        model_path = run_dir
        _release(device)  # the trainer's optimizer state is gone with it

        if it + 1 < args.iterations:
            logger.info("=== iteration %d: mining hard negatives ===", it)
            encoder = load_encoder(model_path)
            outputs = find_hard_negatives(
                encoder, args.raw_data,
                os.path.join(args.output_dir, f"mined_iter{it}"),
                max_query_length=args.max_query_length,
                max_passage_length=args.max_passage_length,
                num_negatives=n_mined,
                search_range=args.search_range,
                method=args.mining_method,
                batch_size=args.batch_size,
                lambda_=0.5,
                seed=args.seed,
            )
            train_file = next(iter(outputs.values()))
            # free the mining encoder's weights BEFORE the next iteration's
            # trainer allocates its own (model, fp32 master, AdamW state)
            del encoder
            _release(device)

    if args.query_data and args.corpus_data:
        from rankpo_tpu_torch.tools.predictions import generate_predictions

        encoder = load_encoder(model_path)
        preds_file = os.path.join(args.output_dir, "prediction_pairs.jsonl")
        generate_predictions(
            encoder, args.query_data, args.corpus_data, preds_file,
            max_query_length=args.max_query_length,
            max_passage_length=args.max_passage_length,
            search_range=args.search_range,
            num_predictions=args.num_predictions,
            batch_size=args.batch_size,
            seed=args.seed,
        )
        del encoder
        _release(device)
        logger.info("stage-2 prediction pairs at %s", preds_file)

    logger.info("pipeline finished; final model at %s", model_path)
    return model_path


if __name__ == "__main__":
    main()
