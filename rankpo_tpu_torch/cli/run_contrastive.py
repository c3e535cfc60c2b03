"""Contrastive-learning entry point, stage 1 (port of
``rankpo_tpu.cli.run_contrastive``; reference src/run_contrastive.py).

    python -m rankpo_tpu_torch.cli.run_contrastive \\
        --model_name_or_path CKPT --tokenizer_name hash:128256 \\
        --train_data train.jsonl --output_dir outputs/stage1 \\
        --temperature 0.02 --num_negatives 7 --bf16 True \\
        --gradient_checkpointing True --device cuda

Output-dir guard, seed, model and tokenizer, the jsonl dataset, the seeded
collator, then the single-card ``Trainer``; the final model is saved at the
output directory's root with train_results.json and trainer_history.json.
``--device cuda`` (the default) fails when no card is visible; ``--device
cpu`` runs the plain PyTorch path. Not ported yet, each rejected with its
ROADMAP.md item: HF tokenizers' special tokens and embedding resize,
streaming, packing, gradient caching, evaluation during training. wandb and
the model card are skipped with a log line.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time

import numpy as np
import torch

from rankpo_tpu_torch.cli.arguments import (
    UNPORTED_CONTRASTIVE,
    UNPORTED_DATA,
    ContrastiveArguments,
    ModelArguments,
    TrainDataArguments,
    check_unported,
    parse_dataclasses,
    setup_logging,
)
from rankpo_tpu_torch.core.precision import policy_from_flags
from rankpo_tpu_torch.data.collators import ContrastiveCollator
from rankpo_tpu_torch.data.datasets import ContrastiveDataset
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.index.encoding import resolve_device
from rankpo_tpu_torch.models.hf_io import load_pretrained, save_pretrained
from rankpo_tpu_torch.models.llama import LlamaEncoder
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer
from rankpo_tpu_torch.utils.flops import contrastive_sample_flops, contrastive_sample_tokens

logger = logging.getLogger(__name__)


def guard_output_dir(cfg: TrainConfig) -> None:
    """Refuse to clobber a non-empty output dir (reference :49-57)."""
    if (os.path.exists(cfg.output_dir) and os.listdir(cfg.output_dir)
            and not cfg.overwrite_output_dir):
        raise ValueError(
            f"Output directory ({cfg.output_dir}) already exists and is not "
            "empty. Use --overwrite_output_dir to overcome."
        )


def set_seed(seed: int) -> None:
    """Seed the host RNGs and torch (reference src/utils.py:14-31)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_model_and_tokenizer(model_args: ModelArguments):
    """(config, CPU state dict, tokenizer, pad id). HF tokenizers need the
    reference's special tokens and an embedding resize, not ported yet."""
    config, state = load_pretrained(model_args.model_name_or_path)
    tokenizer = resolve_tokenizer(model_args.tokenizer_name, model_args.model_name_or_path)
    if hasattr(tokenizer, "add_special_tokens"):
        raise NotImplementedError(
            "HF tokenizers (pad-token rule, domain special tokens, embedding "
            "resize) are not ported to rankpo_tpu_torch yet (ROADMAP.md "
            "Queue 1 item 6); use --tokenizer_name hash:<vocab>"
        )
    pad_id = getattr(tokenizer, "pad_token_id", None)
    if pad_id is None:
        pad_id = config.pad_token_id or 0
    return config, state, tokenizer, pad_id


def build_model(config, state, train_cfg: TrainConfig, device) -> LlamaEncoder:
    policy = policy_from_flags(train_cfg.bf16, train_cfg.pure_bf16)
    return LlamaEncoder.for_training(
        config, state, device=device, param_dtype=policy.param_dtype,
        compute_dtype=policy.compute_dtype,
        gradient_checkpointing=train_cfg.gradient_checkpointing,
        checkpoint_policy=train_cfg.gradient_checkpointing_policy,
    )


def make_save_fn(config, stage: str):
    def save_params_fn(directory: str, model: torch.nn.Module) -> None:
        # fp32 files: the JAX package's load_pretrained reads them too
        save_pretrained(directory, config, model.state_dict(), dtype=torch.float32)
        logger.info("%s: model card not written (ROADMAP.md Queue 1 item 3)", stage)

    return save_params_fn


def log_skipped(train_cfg: TrainConfig) -> None:
    if train_cfg.wandb_project:
        logger.info("wandb logging is not ported; skipped (ROADMAP.md Queue 1 item 3)")


def write_results(train_cfg: TrainConfig, trainer: Trainer, history, n_rows: int,
                  t0: float, save_fn) -> None:
    """Final save at the output root (reference trainer.save_model()) and the
    run's summary files."""
    save_fn(train_cfg.output_dir, trainer.model)
    metrics = {
        "train_samples": n_rows,
        "train_runtime": round(time.time() - t0, 2),
        "train_steps": trainer.step,
        "final_loss": next((h["loss"] for h in reversed(history) if "loss" in h), None),
    }
    with open(os.path.join(train_cfg.output_dir, "train_results.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    with open(os.path.join(train_cfg.output_dir, "trainer_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    logger.info("train metrics: %s", metrics)


def main(argv=None):
    model_args, data_args, c_args, train_cfg = parse_dataclasses(
        [ModelArguments, TrainDataArguments, ContrastiveArguments, TrainConfig], argv
    )
    setup_logging(train_cfg.log_level)
    check_unported(data_args, UNPORTED_DATA)
    check_unported(c_args, UNPORTED_CONTRASTIVE)
    train_cfg.check_supported()
    device = resolve_device(train_cfg.device)  # before any loading: no CPU fallback
    guard_output_dir(train_cfg)
    set_seed(train_cfg.seed)
    log_skipped(train_cfg)
    logger.info("model args:\n%s", model_args.to_json_string())
    logger.info("data args:\n%s", data_args.to_json_string())
    logger.info("train config:\n%s", train_cfg.to_json_string())

    config, state, tokenizer, pad_id = setup_model_and_tokenizer(model_args)
    config.normalize = c_args.normalize_embeddings
    dataset = ContrastiveDataset(
        data_args.train_data, tokenizer,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
    )
    collator = ContrastiveCollator(
        pad_token_id=pad_id, num_negatives=data_args.num_negatives,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
        pad_multiple=data_args.pad_multiple, seed=train_cfg.seed,
    )
    steps_per_epoch = len(dataset) // (
        train_cfg.per_device_train_batch_size * train_cfg.gradient_accumulation_steps
    )
    total_steps = (train_cfg.max_steps if train_cfg.max_steps > 0
                   else steps_per_epoch * train_cfg.num_train_epochs)

    model = build_model(config, state, train_cfg, device)
    del state
    loss_fn = make_contrastive_loss_fn(
        config, temperature=c_args.temperature,
        use_inbatch_neg=c_args.use_inbatch_neg,
        negatives_cross_device=c_args.negatives_cross_device,
        normalize_embeddings=c_args.normalize_embeddings,
        attn_impl=model_args.attn_impl,
    )
    group_size = 1 + data_args.num_negatives
    save_fn = make_save_fn(config, "contrastive")
    trainer = Trainer(
        loss_fn=loss_fn, model=model, config=train_cfg,
        total_steps=max(total_steps, 1), save_params_fn=save_fn,
        # analytic FLOPs and tokens at the static padded lengths
        sample_flops=contrastive_sample_flops(
            config, query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length, group_size=group_size,
        ),
        sample_tokens=contrastive_sample_tokens(
            query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length, group_size=group_size,
        ),
    )
    t0 = time.time()
    history = trainer.train(dataset, collator)
    write_results(train_cfg, trainer, history, len(dataset), t0, save_fn)
    return history


if __name__ == "__main__":
    main()
