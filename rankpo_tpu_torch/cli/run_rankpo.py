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
sigmoid/hinge preference loss on the single-card ``Trainer``. LoRA is not
ported yet (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import logging
import time

from rankpo_tpu_torch.cli.arguments import (
    UNPORTED_DATA,
    UNPORTED_RANKPO,
    ModelArguments,
    RankPOArguments,
    TrainDataArguments,
    check_unported,
    parse_dataclasses,
    setup_logging,
)
from rankpo_tpu_torch.cli.run_contrastive import (
    build_model,
    guard_output_dir,
    log_skipped,
    make_save_fn,
    set_seed,
    setup_model_and_tokenizer,
    write_results,
)
from rankpo_tpu_torch.core.precision import policy_from_flags
from rankpo_tpu_torch.data.collators import RankPOCollator
from rankpo_tpu_torch.data.datasets import PairPreferenceDataset
from rankpo_tpu_torch.index.encoding import resolve_device
from rankpo_tpu_torch.models.hf_io import load_pretrained
from rankpo_tpu_torch.models.llama import LlamaEncoder
from rankpo_tpu_torch.train.config import TrainConfig
from rankpo_tpu_torch.train.steps import make_rankpo_loss_fn
from rankpo_tpu_torch.train.trainer import Trainer
from rankpo_tpu_torch.utils.flops import rankpo_sample_flops, rankpo_sample_tokens

logger = logging.getLogger(__name__)


def main(argv=None):
    model_args, data_args, r_args, train_cfg = parse_dataclasses(
        [ModelArguments, TrainDataArguments, RankPOArguments, TrainConfig], argv
    )
    setup_logging(train_cfg.log_level)
    check_unported(data_args, UNPORTED_DATA)
    check_unported(r_args, UNPORTED_RANKPO)
    train_cfg.check_supported()
    device = resolve_device(train_cfg.device)  # before any loading: no CPU fallback
    guard_output_dir(train_cfg)
    set_seed(train_cfg.seed)
    log_skipped(train_cfg)
    logger.info("model args:\n%s", model_args.to_json_string())
    logger.info("rankpo args:\n%s", r_args.to_json_string())

    config, state, tokenizer, pad_id = setup_model_and_tokenizer(model_args)
    policy = policy_from_flags(train_cfg.bf16, train_cfg.pure_bf16)
    ref_model = None
    if not r_args.reference_free:
        ref_path = r_args.ref_model_name_or_path or model_args.model_name_or_path
        _, ref_state = load_pretrained(ref_path)
        # frozen, in the compute dtype: the forward casts to it anyway
        ref_model = LlamaEncoder.from_state_dict(
            config, ref_state, device=device, dtype=policy.compute_dtype
        )
        logger.info("loaded frozen reference model from %s", ref_path)

    dataset = PairPreferenceDataset(
        data_args.train_data, tokenizer,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
    )
    collator = RankPOCollator(
        pad_token_id=pad_id, max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
        pad_multiple=data_args.pad_multiple,
    )
    steps_per_epoch = len(dataset) // (
        train_cfg.per_device_train_batch_size * train_cfg.gradient_accumulation_steps
    )
    total_steps = (train_cfg.max_steps if train_cfg.max_steps > 0
                   else steps_per_epoch * train_cfg.num_train_epochs)

    model = build_model(config, state, train_cfg, device)
    del state
    loss_fn = make_rankpo_loss_fn(
        config, beta=r_args.beta, gamma_beta_ratio=r_args.gamma_beta_ratio,
        temperature=r_args.temperature, loss_type=r_args.loss_type,
        label_smoothing=r_args.label_smoothing,
        rankpo_weight=r_args.rankpo_weight, sft_weight=r_args.sft_weight,
        reference_free=r_args.reference_free, ref_model=ref_model,
        disable_dropout=r_args.disable_dropout, attn_impl=model_args.attn_impl,
    )
    save_fn = make_save_fn(config, "rankpo")
    trainer = Trainer(
        loss_fn=loss_fn, model=model, config=train_cfg,
        total_steps=max(total_steps, 1), save_params_fn=save_fn,
        sample_flops=rankpo_sample_flops(
            config, query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length,
            reference_free=ref_model is None,
        ),
        sample_tokens=rankpo_sample_tokens(
            query_len=data_args.max_query_length,
            passage_len=data_args.max_passage_length,
        ),
    )
    t0 = time.time()
    history = trainer.train(dataset, collator)
    write_results(train_cfg, trainer, history, len(dataset), t0, save_fn)
    return history


if __name__ == "__main__":
    main()
