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
Every saved model directory gets the model card (``README.md``) the JAX
package writes; ``--wandb_project`` logs the trainer's lines to wandb when
it is installed and warns otherwise. ``--device cuda`` (the default) fails
when no card is visible; ``--device cpu`` runs the plain PyTorch path. An
HF tokenizer gets the reference's pad-token rule and seven domain special
tokens, the embedding table is resized to match, and every saved model
directory holds the tokenizer beside the weights. ``--pack_sequences True``
packs each micro-batch's texts several to a row (``data/packing.py``,
block-diagonal attention). ``--resume_from_checkpoint`` (``latest``,
``true`` or a directory) loads the checkpoint's weights before the model is
built and then its optimizer state and counters (``Trainer.resume_from``);
``--grad_cache True`` trains on InfoNCE over the whole accumulation group
(``train/gradcache.py``); ``--eval_data`` is evaluated by
``--eval_strategy``, and so are ``--retrieval_eval_query_file`` /
``--retrieval_eval_corpus_file`` (retrieval metrics of the live model,
``eval/in_training.py``). ``--streaming True`` keeps the rows on disk
(``data/datasets.py`` ``StreamingContrastiveDataset``): the same items,
the same batches. ``--flash_bwd_impl`` picks the flash backward kernels
(default split).
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
    ContrastiveArguments,
    ModelArguments,
    TrainDataArguments,
    parse_dataclasses,
    setup_logging,
)
from rankpo_tpu_torch.core.precision import policy_from_flags
from rankpo_tpu_torch.data.collators import ContrastiveCollator
from rankpo_tpu_torch.data.datasets import ContrastiveDataset, StreamingContrastiveDataset
from rankpo_tpu_torch.data.packing import PackedContrastiveCollator
from rankpo_tpu_torch.data.tokenization import prepare_tokenizer, resolve_tokenizer
from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.eval.in_training import maybe_attach_retrieval_eval
from rankpo_tpu_torch.models.base import EncoderModule
from rankpo_tpu_torch.models.encoder import encoder_class, resize_token_embeddings
from rankpo_tpu_torch.models.hf_io import load_pretrained, save_pretrained
from rankpo_tpu_torch.train.checkpoint import latest_checkpoint
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.gradcache import make_contrastive_gradcache_grad_fn
from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, uses_dropout
from rankpo_tpu_torch.train.trainer import Trainer
from rankpo_tpu_torch.utils.flops import contrastive_sample_flops, contrastive_sample_tokens
from rankpo_tpu_torch.utils.model_card import write_model_card
from rankpo_tpu_torch.utils.wandb_utils import maybe_init_wandb

logger = logging.getLogger(__name__)


def guard_output_dir(cfg: TrainConfig) -> None:
    """Refuse to clobber a non-empty output dir (reference :49-57), unless
    the run resumes."""
    if (os.path.exists(cfg.output_dir) and os.listdir(cfg.output_dir)
            and not cfg.overwrite_output_dir and not cfg.resume_from_checkpoint):
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
    """(config, CPU state dict, tokenizer, pad id). An HF tokenizer gets the
    pad-token rule and the domain special tokens, and the embedding table is
    resized to its vocabulary (reference :101-148)."""
    config, state = load_pretrained(model_args.model_name_or_path)
    tokenizer = resolve_tokenizer(model_args.tokenizer_name, model_args.model_name_or_path)
    if hasattr(tokenizer, "add_special_tokens"):  # an HF tokenizer
        new_size = prepare_tokenizer(tokenizer)
        if new_size != config.vocab_size:
            state, config = resize_token_embeddings(state, config, new_size)
            logger.info("resized token embeddings to %d", new_size)
        if config.pad_token_id is None:
            config.pad_token_id = tokenizer.pad_token_id
    pad_id = getattr(tokenizer, "pad_token_id", None)
    if pad_id is None:
        pad_id = config.pad_token_id or 0
    return config, state, tokenizer, pad_id


def resolve_resume(train_cfg: TrainConfig):
    """The checkpoint directory to resume from: ``latest`` / ``true`` pick
    the newest ``checkpoint-N`` of the output directory (None when there is
    none: a fresh start), anything else is a directory (JAX
    ``run_contrastive.py:99-108``)."""
    resume = train_cfg.resume_from_checkpoint
    if resume in ("true", "True", "latest"):
        resume = latest_checkpoint(train_cfg.output_dir)
    return resume or None


def load_resume_weights(resume, config, state):
    """(config, state) from the resume checkpoint, or the given ones: the
    weights must come from the checkpoint before the model is built, or
    training would continue from the base weights at a mid-schedule LR."""
    if not resume:
        return config, state
    logger.info("resume: loading weights from %s", resume)
    return load_pretrained(resume)


def build_model(config, state, train_cfg: TrainConfig, device,
                bwd_impl: str = "auto") -> EncoderModule:
    """The config's body (Llama, Qwen2 or Mistral; Roberta/BERT), trainable."""
    policy = policy_from_flags(train_cfg.bf16, train_cfg.pure_bf16)
    return encoder_class(config).for_training(
        config, state, device=device, param_dtype=policy.param_dtype,
        compute_dtype=policy.compute_dtype,
        gradient_checkpointing=train_cfg.gradient_checkpointing,
        checkpoint_policy=train_cfg.gradient_checkpointing_policy, bwd_impl=bwd_impl,
    )


def make_save_fn(config, tokenizer=None, state_fn=None, **card):
    """The trainer's save function: the fp32 model files (the JAX package's
    load_pretrained reads them too) of ``state_fn(model)`` (by default the
    model's state dict), an HF ``tokenizer`` beside them (so a later stage,
    evaluation and serving load the added tokens) and the model card, whose
    arguments ``card`` (stage, tags, base_model, training_args) are the JAX
    CLI's."""
    state_fn = state_fn or (lambda model: model.state_dict())

    def save_params_fn(directory: str, model: torch.nn.Module) -> None:
        save_pretrained(directory, config, state_fn(model), dtype=torch.float32)
        if hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(directory)
        # push_to_hub tagging analog (reference rankpo_trainer.py:647-654)
        write_model_card(directory, **card)

    return save_params_fn


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
    train_cfg.check_supported()
    device = resolve_device(train_cfg.device)  # before any loading: no CPU fallback
    guard_output_dir(train_cfg)
    set_seed(train_cfg.seed)
    logger.info("model args:\n%s", model_args.to_json_string())
    logger.info("data args:\n%s", data_args.to_json_string())
    logger.info("train config:\n%s", train_cfg.to_json_string())

    config, state, tokenizer, pad_id = setup_model_and_tokenizer(model_args)
    resume = resolve_resume(train_cfg)
    config, state = load_resume_weights(resume, config, state)
    config.normalize = c_args.normalize_embeddings
    dataset_cls = StreamingContrastiveDataset if data_args.streaming else ContrastiveDataset
    dataset = dataset_cls(
        data_args.train_data, tokenizer,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
    )

    def make_collator():
        if data_args.pack_sequences:
            # JAX run_contrastive.py:121-135; one card, so rows_multiple 1
            return PackedContrastiveCollator(
                pad_token_id=pad_id, num_negatives=data_args.num_negatives,
                max_query_length=data_args.max_query_length,
                max_passage_length=data_args.max_passage_length,
                query_max_segments=data_args.pack_max_segments,
                passage_max_segments=data_args.pack_max_segments,
                rows_multiple=1, seed=train_cfg.seed,
            )
        return ContrastiveCollator(
            pad_token_id=pad_id, num_negatives=data_args.num_negatives,
            max_query_length=data_args.max_query_length,
            max_passage_length=data_args.max_passage_length,
            pad_multiple=data_args.pad_multiple, seed=train_cfg.seed,
        )

    collator = make_collator()
    steps_per_epoch = len(dataset) // (
        train_cfg.per_device_train_batch_size * train_cfg.gradient_accumulation_steps
    )
    total_steps = (train_cfg.max_steps if train_cfg.max_steps > 0
                   else steps_per_epoch * train_cfg.num_train_epochs)

    model = build_model(config, state, train_cfg, device, model_args.flash_bwd_impl)
    del state
    loss_fn = make_contrastive_loss_fn(
        config, temperature=c_args.temperature,
        use_inbatch_neg=c_args.use_inbatch_neg,
        negatives_cross_device=c_args.negatives_cross_device,
        normalize_embeddings=c_args.normalize_embeddings,
        attn_impl=model_args.attn_impl,
    )
    grad_fn = None
    if c_args.grad_cache:
        grad_fn = make_contrastive_gradcache_grad_fn(
            config, temperature=c_args.temperature,
            normalize_embeddings=c_args.normalize_embeddings,
            use_inbatch_neg=c_args.use_inbatch_neg, attn_impl=model_args.attn_impl,
        )
        logger.info("gradient caching: the negative pool spans all %d accumulation steps",
                    train_cfg.gradient_accumulation_steps)
    group_size = 1 + data_args.num_negatives
    save_fn = make_save_fn(
        config, tokenizer, stage="contrastive",
        tags=["rankpo_tpu", "contrastive", "dense-retrieval"],
        base_model=model_args.model_name_or_path,
        training_args={
            "temperature": c_args.temperature,
            "negatives_cross_device": c_args.negatives_cross_device,
            "learning_rate": train_cfg.learning_rate,
            "per_device_train_batch_size": train_cfg.per_device_train_batch_size,
        },
    )
    trainer = Trainer(
        loss_fn=loss_fn, grad_fn=grad_fn, model=model, config=train_cfg,
        total_steps=max(total_steps, 1), save_params_fn=save_fn,
        log_fn=maybe_init_wandb(train_cfg.wandb_project, train_cfg.run_name),
        # analytic FLOPs and tokens at the static padded lengths
        sample_flops=contrastive_sample_flops(
            config, query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length, group_size=group_size,
            causal=config.is_llama,
        ),
        sample_tokens=contrastive_sample_tokens(
            query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length, group_size=group_size,
        ),
        # the Roberta body's dropout at the config's rates on every step
        dropout_seed=train_cfg.seed if uses_dropout(config) else None,
    )
    if resume:
        logger.info("resuming trainer state from %s", resume)
        trainer.resume_from(resume)
    maybe_attach_retrieval_eval(trainer, data_args, tokenizer, attn_impl=model_args.attn_impl)
    eval_dataset = None
    if data_args.eval_data:
        eval_dataset = ContrastiveDataset(
            data_args.eval_data, tokenizer,
            max_query_length=data_args.max_query_length,
            max_passage_length=data_args.max_passage_length,
        )
    t0 = time.time()
    # the eval set gets a collator of its own: the training collator's
    # sampling stream stays that of a run without evaluation
    history = trainer.train(dataset, collator, eval_dataset=eval_dataset,
                            eval_collator=make_collator() if eval_dataset else None)
    write_results(train_cfg, trainer, history, len(dataset), t0, save_fn)
    return history


if __name__ == "__main__":
    main()
