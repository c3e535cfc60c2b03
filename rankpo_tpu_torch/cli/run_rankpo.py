"""RankPO preference-training entry point, stage 2 (port of
``rankpo_tpu.cli.run_rankpo``; reference src/run_rankpo.py).

    python -m rankpo_tpu_torch.cli.run_rankpo \\
        --model_name_or_path outputs/stage1 --tokenizer_name hash:128256 \\
        --train_data pairs.jsonl --output_dir outputs/stage2 \\
        --reference_free True --loss_type sigmoid --beta 2.0 \\
        --temperature 0.1 --bf16 True --device cuda

Loads the stage-1 checkpoint, optionally a frozen reference model (unless
``--reference_free``; kept in the compute dtype and run under
``torch.no_grad``), the annotated pair jsonl, and trains with the
sigmoid/hinge preference loss on the single-card ``Trainer``; the saved
directories get the JAX package's model card, and ``--wandb_project`` logs
to wandb when it is installed. ``--resume_from_checkpoint``,
``--eval_data`` and the in-training retrieval evaluation work as in stage 1
(``cli/run_contrastive.py``; JAX ``run_rankpo.py:52-61, 239-241,
243-273``).

``--use_lora True [--lora_r 8 --lora_alpha 16 --lora_target_modules
auto]`` trains adapters over the frozen model (``models/lora.py``; JAX
``run_rankpo.py:159-200, 249-260``): checkpoints and the output hold the
merged model (and ``lora_adapters.pt``), ``opt_state.pt`` the adapters'
optimizer state, and the retrieval evaluation encodes with the merged
weights. A resumed LoRA run takes the checkpoint's merged weights as its
base, draws fresh adapters from the seed and restores the adapters'
optimizer state, as the JAX package does.

Data parallel (``--coordinator_address``, ``--num_processes``,
``--process_id``, ``--zero1`` / ``--zero2``), ``--model_parallel`` and
``--fsdp`` as in stage 1 (``cli/run_contrastive.py``); the preference loss
needs no collective beyond the trainer's gradient exchange. With
``--use_lora`` under ``--model_parallel`` the adapters are whole on every
model rank over the split base; under ``--fsdp`` the adapters are sharded
over the data group and the base stays whole (``models/lora.py``,
``parallel/fsdp.py``).
"""

from __future__ import annotations

import logging
import os
import time

import torch

from rankpo_tpu_torch.cli.arguments import (
    DistributedArguments,
    ModelArguments,
    RankPOArguments,
    TrainDataArguments,
    parse_dataclasses,
    setup_logging,
)
from rankpo_tpu_torch.cli.run_contrastive import (
    agree_packing,
    build_model,
    guard_output_dir,
    load_resume_weights,
    make_save_fn,
    resolve_resume,
    set_seed,
    setup_model_and_tokenizer,
    start_processes,
    steps_per_epoch,
    write_results,
)
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.precision import policy_from_flags
from rankpo_tpu_torch.data.collators import RankPOCollator
from rankpo_tpu_torch.data.datasets import PairPreferenceDataset
from rankpo_tpu_torch.data.packing import PackedRankPOCollator
from rankpo_tpu_torch.eval.in_training import maybe_attach_retrieval_eval
from rankpo_tpu_torch.models import lora
from rankpo_tpu_torch.models.base import TensorParallel
from rankpo_tpu_torch.models.encoder import encoder_class
from rankpo_tpu_torch.models.hf_io import load_pretrained
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_rankpo_loss_fn, uses_dropout
from rankpo_tpu_torch.train.trainer import Trainer
from rankpo_tpu_torch.utils.flops import rankpo_sample_flops, rankpo_sample_tokens
from rankpo_tpu_torch.utils.wandb_utils import maybe_init_wandb

logger = logging.getLogger(__name__)


def main(argv=None):
    model_args, data_args, r_args, dist_args, train_cfg = parse_dataclasses(
        [ModelArguments, TrainDataArguments, RankPOArguments, DistributedArguments,
         TrainConfig], argv
    )
    setup_logging(train_cfg.log_level)
    train_cfg.check_supported()
    device = start_processes(dist_args, train_cfg)
    guard_output_dir(train_cfg)
    set_seed(train_cfg.seed)
    logger.info("model args:\n%s", model_args.to_json_string())
    logger.info("rankpo args:\n%s", r_args.to_json_string())

    config, state, tokenizer, pad_id = setup_model_and_tokenizer(model_args)
    resume = resolve_resume(train_cfg)
    config, state = load_resume_weights(resume, config, state)
    policy = policy_from_flags(train_cfg.bf16, train_cfg.pure_bf16)
    ref_model = None
    if not r_args.reference_free:
        ref_path = r_args.ref_model_name_or_path or model_args.model_name_or_path
        _, ref_state = load_pretrained(ref_path)
        # frozen, in the compute dtype: the forward casts to it anyway
        # sharded as the trained model is (JAX's frozen_specs, trainer.py:183-190)
        ref_model = encoder_class(config).from_state_dict(
            config, ref_state, device=device, dtype=policy.compute_dtype,
            tensor_parallel=TensorParallel.current(),
        )
        logger.info("loaded frozen reference model from %s", ref_path)

    dataset = PairPreferenceDataset(
        data_args.train_data, tokenizer,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
    )

    def make_collator():
        if data_args.pack_sequences:
            # JAX run_rankpo.py:75-90; each rank packs its own rows, so
            # rows_multiple 1
            return PackedRankPOCollator(
                pad_token_id=pad_id, max_query_length=data_args.max_query_length,
                max_passage_length=data_args.max_passage_length,
                query_max_segments=data_args.pack_max_segments,
                passage_max_segments=data_args.pack_max_segments, rows_multiple=1,
            )
        return RankPOCollator(
            pad_token_id=pad_id, max_query_length=data_args.max_query_length,
            max_passage_length=data_args.max_passage_length,
            pad_multiple=data_args.pad_multiple,
        )

    collator = make_collator()
    if data_args.pack_sequences:
        agree_packing(collator, dataset, train_cfg)
    total_steps = (train_cfg.max_steps if train_cfg.max_steps > 0
                   else steps_per_epoch(len(dataset), train_cfg) * train_cfg.num_train_epochs)

    model = build_model(config, state, train_cfg, device, model_args.flash_bwd_impl)
    del state
    if r_args.use_lora:
        targets = r_args.lora_target_modules
        if targets == "auto":
            targets = lora.auto_targets(config)
        lora_cfg = lora.LoraConfig(
            r=r_args.lora_r, alpha=r_args.lora_alpha,
            target_modules=tuple(m.strip() for m in targets.split(",") if m.strip()))
        lora.apply_lora(model, lora_cfg, torch.Generator().manual_seed(train_cfg.seed))
        logger.info(
            "LoRA: training %.2fM adapter params over a frozen %.2fM base",
            lora.count_params(p for p in model.parameters() if p.requires_grad) / 1e6,
            lora.count_params(p for p in model.parameters() if not p.requires_grad) / 1e6)
    loss_fn = make_rankpo_loss_fn(
        config, beta=r_args.beta, gamma_beta_ratio=r_args.gamma_beta_ratio,
        temperature=r_args.temperature, loss_type=r_args.loss_type,
        label_smoothing=r_args.label_smoothing,
        rankpo_weight=r_args.rankpo_weight, sft_weight=r_args.sft_weight,
        reference_free=r_args.reference_free, ref_model=ref_model,
        disable_dropout=r_args.disable_dropout, attn_impl=model_args.attn_impl,
    )
    save_model = make_save_fn(
        config, tokenizer, stage="rankpo",
        state_fn=lora.merged_state_dict if r_args.use_lora else None,
        tags=["rankpo_tpu", "rankpo", "preference-optimization", "dense-retrieval"]
             + (["lora"] if r_args.use_lora else []),
        base_model=model_args.model_name_or_path,
        training_args={
            "loss_type": r_args.loss_type,
            "beta": r_args.beta,
            "temperature": r_args.temperature,
            "reference_free": r_args.reference_free,
            "learning_rate": train_cfg.learning_rate,
        },
    )

    def save_fn(directory: str, model) -> None:
        save_model(directory, model)
        if r_args.use_lora:  # the merge's adapters, beside it (gathered under fsdp)
            adapters = lora.adapter_state_dict(model)
            if mesh.is_main_process():
                torch.save(adapters, os.path.join(directory, "lora_adapters.pt"))

    trainer = Trainer(
        loss_fn=loss_fn, model=model, config=train_cfg,
        total_steps=max(total_steps, 1), save_params_fn=save_fn,
        log_fn=(maybe_init_wandb(train_cfg.wandb_project, train_cfg.run_name)
                if mesh.is_main_process() else None),
        sample_flops=rankpo_sample_flops(
            config, query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length,
            reference_free=ref_model is None, causal=config.is_llama,
        ),
        sample_tokens=rankpo_sample_tokens(
            query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length,
        ),
        # the policy's dropout only when the run asks for it
        dropout_seed=(train_cfg.seed if uses_dropout(config) and not r_args.disable_dropout
                      else None),
    )
    if resume:
        logger.info("resuming trainer state from %s", resume)
        trainer.resume_from(resume)
    maybe_attach_retrieval_eval(trainer, data_args, tokenizer, attn_impl=model_args.attn_impl)
    eval_dataset = None
    if data_args.eval_data:
        eval_dataset = PairPreferenceDataset(
            data_args.eval_data, tokenizer,
            max_query_length=data_args.max_query_length,
            max_passage_length=data_args.max_passage_length,
        )
    t0 = time.time()
    history = trainer.train(dataset, collator, eval_dataset=eval_dataset,
                            eval_collator=make_collator() if eval_dataset else None)
    write_results(train_cfg, trainer, history, len(dataset), t0, save_fn)
    return history


if __name__ == "__main__":
    main()
