"""Where a packed training step's time goes, beside the unpacked step, on one card.

    python3 scripts/packed_step_profile.py [--seed 0] [--steps 5] [--stages stage1]

Llama-3.2-1B at full width and depth (random weights from the seed), each
stage at ``chip_smoke.py``'s phase-5 settings (stage 1: batch 8 x group 4,
accumulation 2, 128/512 tokens, checkpointing; stage 2: 8 pairs under
``torch.use_deterministic_algorithms``), on the batches the stage's CLI
loader gives (``chip_smoke._stage_groups``), unpacked and packed
(``--pack_sequences``, at most 16 texts a row), in turns: unpacked,
packed, packed, unpacked. Each turn builds the trainer, takes one warm
step, then times ``--steps`` steps on the host clock (each ending in a
device synchronisation) and traces one more with ``torch.profiler`` (CUDA
activity only): device busy time, the idle share of the traced step, and
the device time by kernel category (``chip_smoke._CATEGORIES``), and of
each flash-attention kernel (K1; K2, or K3a and K3b, by the backward
"auto" picks). The card's name and power limit open and close the output.
"""

import argparse
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def run(smoke, tmp, seed, state, config, stage: str, packed: bool, steps: int) -> str:
    from torch.profiler import ProfilerActivity, profile

    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.train.config import TrainConfig
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn
    from rankpo_tpu_torch.train.trainer import Trainer

    stage1 = stage == "stage1"
    groups = smoke._stage_groups(tmp, seed, stage, packed, steps + 2)
    model = llama.LlamaEncoder.for_training(config, state, device="cuda",
                                            gradient_checkpointing=stage1)
    loss_fn = (make_contrastive_loss_fn(config, temperature=0.02) if stage1 else
               make_rankpo_loss_fn(config, beta=2.0, temperature=0.1, reference_free=True))
    cfg = TrainConfig(learning_rate=1e-5, per_device_train_batch_size=8,
                      gradient_accumulation_steps=2 if stage1 else 1,
                      gradient_checkpointing=stage1, save_strategy="no",
                      save_on_preemption=False, device="cuda")
    trainer = Trainer(loss_fn=loss_fn, model=model, config=cfg, total_steps=steps + 2)
    torch.use_deterministic_algorithms(not stage1)
    try:
        trainer.train_step(groups[0])  # warm: the optimizer state, the kernels
        walls = []
        for group in groups[1:-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(group)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(groups[-1])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.use_deterministic_algorithms(False)
    kernels = {e.key: smoke._device_us(e) / 1e3 for e in prof.key_averages()
               if smoke._device_us(e) > 0}
    busy = sum(kernels.values())
    by_cat = {label: 0.0 for label, _ in smoke._CATEGORIES}
    for name, ms in kernels.items():
        by_cat[next(lab for lab, test in smoke._CATEGORIES if test(name.lower()))] += ms
    flash = {name: ms for name, ms in kernels.items() if "flash_" in name}
    shapes = {f: tuple(b["input_ids"].shape[1:]) for f, b in groups[-1].items()}
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{stage} {'packed' if packed else 'unpacked'} {shapes}: step median "
            f"{np.median(walls):.1f} ms over {len(walls)} (host clock; {np.round(walls, 1)}); "
            f"traced step {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
            f"{1 - busy / wall:.3f}; device ms by category: "
            + ", ".join(f"{label} {ms:.1f}" for label, ms in by_cat.items())
            + "; flash kernels: " + ", ".join(f"{name[:60]} {ms:.2f} ms"
                                              for name, ms in sorted(flash.items())))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--stages", default="stage1,stage2",
                        help="comma-joined: stage1, stage2")
    args = parser.parse_args()
    import chip_smoke as smoke
    from rankpo_tpu_torch.models.config import EncoderConfig

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = smoke.phase_environment()
    smoke.phase_build()
    with tempfile.TemporaryDirectory(prefix="packed_profile_") as tmp:
        ckpt, state = smoke.make_model_checkpoint(tmp, args.seed, "llama-3.2-1b")
        config = EncoderConfig.from_pretrained(ckpt)
        for stage in args.stages.split(","):
            for packed in (False, True, True, False):
                print(run(smoke, tmp, args.seed, state, config, stage, packed, args.steps),
                      flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
