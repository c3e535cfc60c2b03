"""How far bf16 rounding moves windowed attention and a windowed body, on one card.

    python3 scripts/window_rounding.py [--seed 0]

Two measurements, each with and without a sliding window of 4096 keys:

- K1 against the plain attention in bf16 (``chip_smoke.plain_attention``),
  both against the plain version in fp32 (``chip_smoke.plain_fwd``), at
  B 1, S 4608, 32 q / 8 kv heads, D 128, every key valid, q and k drawn at
  scales 1 and 3: the relative L2 error over the rows below 512, from 512
  to 4096 and past 4096, and its projection on the fp32 output (a bias);
- e5-mistral-7b-instruct's widths at 4 layers (``chip_smoke.MODELS``,
  random weights from the seed) on ``chip_smoke``'s phase 5w micro-batch
  of 1 and of 2 queries, each with one positive and one negative passage
  cut to 4608 tokens: the stage-1 loss at temperature 0.02 and each
  embedding's 1 - cosine with the fp32 result, through the kernels (bf16),
  the plain attention (bf16) and the plain attention in fp32.

The card's name and power limit open the output.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def attention_rounding(smoke, seed: int) -> None:
    import torch

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s, hq, hkv, d = 1, 4608, 32, 8, 128
    mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    for scale in (1.0, 3.0):
        q = (torch.randn(b, s, hq, d, generator=gen, device="cuda") * scale).bfloat16()
        k = (torch.randn(b, s, hkv, d, generator=gen, device="cuda") * scale).bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        for window in (4096, None):
            with torch.no_grad():
                out, _ = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True,
                                             window=window)
                plain = smoke.plain_attention(q, k, v, mask, True, window)
                ref, _ = smoke.plain_fwd(q, k, v, mask, True, window)
            for lo, hi in ((0, 512), (512, 4096), (4096, s)):
                r = ref[:, lo:hi]
                line = []
                for label, x in (("kernel", out), ("plain bf16", plain)):
                    err = x[:, lo:hi].float() - r
                    line.append(f"{label} relative L2 {(err.norm() / r.norm()).item():.3e} "
                                f"bias {((err * r).sum() / r.square().sum()).item():.3e}")
                print(f"attention, q/k scale {scale}, window {window}, rows {lo}-{hi}: "
                      + "; ".join(line), flush=True)


def micro_batch_rounding(smoke, seed: int) -> None:
    import torch

    from rankpo_tpu_torch.data.collators import ContrastiveCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, iter_jsonl
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.models.encoder import embed, encoder_class
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn

    length = smoke.MISTRAL_TRAIN["compare_passage"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, state = smoke.make_model_checkpoint(tmp, seed, smoke.MISTRAL,
                                                  layers=smoke.MISTRAL_TRAIN_LAYERS)
        config = EncoderConfig.from_pretrained(ckpt)
        train, _ = smoke.write_long_training_data(tmp, seed)
        rows = [r for _, r in zip(range(2), iter_jsonl(train))]
        tok = resolve_tokenizer(f"hash:{config.vocab_size}", ckpt)
        cos = torch.nn.functional.cosine_similarity
        for n_rows in (1, 2):
            ds = ContrastiveDataset(rows[:n_rows], tok, 64, length)
            collate = ContrastiveCollator(tok.pad_token_id, 1, 64, length, seed=seed)
            batch = smoke._device_batch(collate([ds[i] for i in range(n_rows)]))
            for window in (config.sliding_window, None):
                cfg = dataclasses.replace(config, sliding_window=window)
                model = encoder_class(cfg).for_training(cfg, state, device="cuda",
                                                        gradient_checkpointing=True)
                emb, loss = {}, {}
                with torch.no_grad():
                    for label, impl, dtype in (("kernels", "flash", torch.bfloat16),
                                               ("plain", "plain", torch.bfloat16),
                                               ("fp32", "plain", torch.float32)):
                        model.compute_dtype = dtype
                        emb[label] = torch.cat([embed(model, batch[f], attn_impl=impl)
                                                for f in ("query", "passage")])
                        loss[label] = make_contrastive_loss_fn(
                            cfg, temperature=0.02, attn_impl=impl)(model, batch)[0].item()
                dist = {label: [f"{x:.3e}" for x in (1 - cos(emb[label], emb["fp32"])).tolist()]
                        for label in ("kernels", "plain")}
                print(f"micro-batch of {n_rows} queries, window {window}: loss "
                      + ", ".join(f"{k} {v:.6f}" for k, v in loss.items())
                      + f"; 1 - cosine with fp32, kernels {dist['kernels']}, plain bf16 "
                      f"{dist['plain']}", flush=True)
                del model
                torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import chip_smoke

    chip_smoke.phase_environment()
    attention_rounding(chip_smoke, args.seed + 3)
    micro_batch_rounding(chip_smoke, args.seed)


if __name__ == "__main__":
    main()
