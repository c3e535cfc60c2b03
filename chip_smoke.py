"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths once through their normal entry points at
the full width of meta-llama/Llama-3.2-1B (served and trained at its full
depth; the features, the sharded runs, the cheaper tiers, evaluation and
mining at FEATURE_LAYERS), and the other bodies at the published widths of
BAAI/bge-m3 (XLM-Roberta; full depth), BAAI/bge-large-en-v1.5 (BERT),
Qwen/Qwen2-1.5B (these two at OTHER_LAYERS),
intfloat/e5-mistral-7b-instruct (sliding-window attention; served at
MISTRAL_SERVE_LAYERS, trained at MISTRAL_TRAIN_LAYERS) and google/gemma-2b
(head_dim 256; at GEMMA_LAYERS), with random weights made
from a seed, and checks every hand-written kernel against its plain PyTorch
version. Phases:

0. environment: versions, the card's name and power limit; a CUDA card of
   compute capability 9.0 is required;
1. build: nvcc compiles the kernels from rankpo_tpu_torch/ops/csrc, one
   process per source, all started together;
2. kernels against plain on the card at the encoder's shapes: K1 (flash
   forward; also one and eight query heads per kv head, Sq off the tile
   below Sk, every length 1, and two launches bit-equal), K2 (fused
   backward), K3a (dq) and K3b (dk/dv), each with its kernel time, the
   plain version's time, the time of the one PyTorch call that computes
   the same function (scaled_dot_product_attention, a yardstick the port
   never calls) and the least time the card could take; also at the two
   regimes the other bodies add (``REGIME_SHAPES``: non-causal with one
   query head per kv head at D 64, causal with 6 per kv head at D 128),
   checked and timed; and with a sliding window (``WINDOW_SHAPES``:
   Mistral's B 2, S 8192, window 4096 with every row longer than the
   window, checked and timed against its band's bound and SDPA with the
   band as a boolean mask; a window of 100 keys; long pad tails without
   skip_pad_q, so rows see no key), the plain versions run one (batch, kv
   head) at a time where the whole call would not fit; and at head_dim 256
   (``D256_SHAPES``: gemma-2b's 8 query heads over one kv head, timed with
   random and full lengths, gemma-7b's 16 / 16 and B 2, S 4096, both
   timed, a non-causal shape, a ragged Sq < Sk, a window); K3b's
   fp32-output build against plain at the ring's step shapes (B 1, S 8192,
   32 / 8 heads, D 64), timed beside the bf16 build at the same shape;
2p. the packed variants of K1, K2, K3a and K3b (``segment_ids``,
   ``PACKED_SHAPES``: BGE's 16 / 16 non-causal, Llama's 32 / 8, Qwen2's
   12 / 2 at D 128, gemma-2b's 8 / 1 at D 256, each over the smoke's
   passage mix packed 16 to a row, and Mistral's window over texts longer
   than it) against their plain versions, two launches of each bit-equal,
   fused and split dk/dv bit-equal; timed at Llama's shape against the
   segments' bound, plain, SDPA with the block-diagonal mask and the
   unpacked kernels on the same texts padded one per row;
3. exact search on data with exact ties;
4. serving path, seven times: a bf16 checkpoint written with the port's
   save_pretrained (the flat tier at full depth, the six others at 2 of
   16 layers, ``FEATURE_LAYERS``), a 4096-passage corpus, the HTTP server started by the
   CLI in a thread, single-query requests from 8 client threads and batched
   requests. The flat index (K1) and its bf16 and int8 rows
   (``--index_type SQbf16`` / ``SQ8``) are checked against an exact numpy
   search over the reconstructed rows, with the queries as the index scores
   them; the approximate flat tier (``--recall_target 0.95``) is held to
   recall@k >= 0.95 against it; the IVF index with bf16 rows (``--index_type ivf``,
   K1 and K4) and the IVF-PQ index (``--index_type IVF64,PQ64``, K1 and K5)
   also take a request with a per-call nprobe, the refine index
   (``--index_type refine``, K1) one with a per-call candidate pool, and are
   checked against the index's own search on the same query embeddings; K1
   is also timed over the corpus encode's own batches;
4p. packed query serving: ``cli.serve --pack_queries --pack_max_segments
   16`` flat over the same corpus and requests, the served hits equal to
   numpy_search with the packed query embeddings, those within cosine
   0.999 of the unpacked service's, K1 launched with segments; /search
   p50/p99 beside phase 4's;
4m. mutation and persistence over HTTP on flat fp32, ``SQ8``, ``ivf`` (K4)
   and ``IVF64,PQ64`` (K5), at FEATURE_LAYERS (2) of 16 layers, the server run with ``--stable_ids --autosave
   --index_file``: /add of 256 passages (each its own rank 1 as a query),
   /remove of 256 ids (none comes back), a request filtered to a seeded
   half of the ids (every hit allowed), K4/K5 against plain at the mutated
   probe set, then a restart from the file without the corpus encode that
   returns the same hits and scores;
5. training path: stage 1 (``run_contrastive.main``, 512 synthetic rows;
   "auto" picks the split backward, K3a and K3b) then stage 2
   (``run_rankpo.main`` on stage 1's output, 256 synthetic pairs, under
   ``torch.use_deterministic_algorithms``): finite losses, every parameter moved, the outputs load, the
   kernels' launch counters rose; one micro-batch through the kernels and
   through the plain attention, both held against the plain attention in
   fp32 compute; one profiled stage-1 step;
5p. packed training (after 5): stage 1 from the base checkpoint and stage 2
   from phase 5's stage-1 output with ``--pack_sequences True``, 4 steps
   each at phase 5's shapes: the first step's loss, against the exact
   (fp32) loss on the same sampled examples, no farther than the unpacked
   run's plus 2e-3 (relative; both printed, and packed against unpacked),
   packed stage 1
   repeating bit for bit from the seed, K1/K2 (stage 1 asks for the fused
   backward with ``--flash_bwd_impl fused``) and K1/K3a/K3b launched with
   segments; step time, real tokens/s, the pad share packed and unpacked,
   peak memory;
5f. the single-card training features (after 5p) at Llama-3.2-1B's full
   width and 2 of its 16 layers (``FEATURE_LAYERS``, the cut that pays
   for 5d and 5t), phase 5's settings, through the CLIs: stage 1 under
   gradient checkpointing "full", "dots" and "attn" (bit-equal losses
   and gradient norms; "attn" launches half of "full"'s K1, the same
   K3a and K3b);
   ``--optim adamw8bit`` and ``adafactor`` (first loss bit-equal to
   AdamW's); stage 2 for 2 steps with its optimizer state, resumed with
   ``--resume_from_checkpoint latest`` for 2 more, losses and final
   model.safetensors bit-equal to 4 straight steps (AdamW with a
   synchronous save; the 8-bit AdamW with ``--async_checkpointing``);
   SIGTERM to ``python -m
   rankpo_tpu_torch.cli.run_rankpo`` (2 of 16 layers) after its first
   step: exit 0 with a checkpoint, then resumed; stage 2 with
   ``--eval_data --eval_strategy steps --eval_steps 2`` (``eval_loss``
   bit-equal to a no-grad loss over the file outside the trainer, printed
   beside the plain attention's in bf16 and fp32);
   stage 1 at batch 8 x accumulation 4 with ``--grad_cache True`` (the
   first loss held to one fp32 InfoNCE over all 32 rows; one more K1 per
   layer, field and micro-batch) beside plain accumulation; a run with
   ``--profile_steps 2`` (its trace names the K1 kernel) and one with
   ``--debug_nans True``; step times, peak memory, checkpoint seconds and
   GB;
5l. the rest of the training extensions (beside 5t's ranks) at the same width,
   depth and settings: ``run_rankpo --use_lora True`` (r 8, alpha 16,
   deterministic) with the in-training retrieval evaluation over phase 7's
   queries and the 4096 passages at steps 2 and 4 (K1, K3a, K3b): the
   adapter count, the first loss bit-equal to 5f's plain stage-2 run from
   the same checkpoint, the untouched tensors of the saved model bit-equal
   to the checkpoint and the adapted ones to the merge recomputed from it
   and the saved adapters, the last eval point's metrics within rtol 1e-6
   of ``cli.evaluate --bf16`` over the saved model; ``run_contrastive
   --streaming True`` with the retrieval hook, losses and gradient norms
   bit-equal to 5f's "full" run; ``InferenceEncoder.encode_packed``
   against ``encode`` over the 4096 passages (K1 with segments; cosine
   >= 0.999; passages/s and pad share of each);
5d. data-parallel training (after 5f) through the CLIs' three multi-host
   flags: (a) (run while (b)'s ranks run) phase 5's stage 1 at world size
   1 under NCCL with
   cross-device negatives and ``--zero1``, then ``--zero2``: losses,
   gradient norms and the final model bit-equal to phase 5's, its K1 / K3a
   / K3b launches; (b) two ranks sharing the card under gloo (NCCL takes
   one rank per device) at FEATURE_LAYERS (2) of 16 layers: stage 1 at per-device batch 4
   (global 8 x group 4), accumulation 2, cross-device negatives,
   ``--zero1``, 4 steps and a checkpoint with the optimizer state, then
   stage 2 for 2 steps, held to one process on the same global batches
   (step 1's loss and gradient norm within rtol 2e-4, every step's within
   ``DP_HISTORY_RTOL``, each tensor's update within ``DP_UPDATE_GAP`` of
   one process's, identical on both ranks, K1, K3a and K3b on each rank);
   each rank's optimizer-state bytes, peak memory and step time; stage 1
   with the in-training retrieval hook over phase 7's files at its last
   step, its metrics bit-equal to ``cli.evaluate`` at W = 2 over the saved
   model; (c) the two ranks' checkpoint resumed in one process, its
   parameters and optimizer state bit-equal to the ranks';
5t. sharded models (after 5d): (a) ring attention
   (``context_parallel_attention(impl="flash")``) at Llama's attention
   shapes (32 / 8 heads, D 64, causal, B 1, S 16384, 8192 a rank) over two
   ranks sharing the card under gloo, out, dq, dk and dv within 2^-7 of
   each tensor's largest |value| of the one-process K1 + K3a + K3b, K1 /
   K3a / fp32 K3b launched once on rank 0 and twice on rank 1, a ring of
   one bit-equal to ``flash_attention``, the ring's time, the one
   process's and the hops' bytes and seconds; (b) ``--model_parallel 2``
   and (c) ``--fsdp True``, each a pair of ranks as 5d(b)'s ((a), (b) and
   (c) at once, six ranks on the card, while this process runs 5l, 7, 8,
   5b, 7b, 4b, 5q, 4w, 5w and 7w, whose times then share the card and the
   host with them),
   held to 5d(b)'s one-process runs by 5d(b)'s
   gates (the mp 2 pair's step-1 gate on its stage 2 in fp32, which it also
   runs), K1 at 16 / 4 heads under mp 2, fsdp's bytes a rank within half
   the model's plus the embedding's, each stage-1 checkpoint resumed in
   one process bit for bit;
6. the IVF and refine tiers at scale: 2^20 unit rows at D 2048 (a mixture
   around 8192 centres) and 1024 held-out queries, made on the card; three
   indexes built by the IVFIPIndex constructor (bf16 rows, PQ64 rows, PQ64
   columns), each searched at k 100 and held to recall@100 >= 0.90
   against its exact search; one search batch of each index traced by
   kernel; (b) a search filtered to a seeded half of the rows on the bf16
   and PQ64-rows indexes at an nprobe tuned for the filter (every id
   allowed, recall against the exact search over the allowed rows, K4/K5
   launched); (c) on the bf16 index 65,536
   rows appended and 65,536 removed (K4 launched, recall against the
   mutated index's exact search, 1024 appended rows reconstructed
   bit-equal); (a) a bf16 index built with kmeans_split 128, printed beside
   the one without (spill, fill, nprobe, batch p50, K4's share, recall);
   (e) the PCA hybrid (d' 256) and (f) the refine tier (d' 256, held
   against an exact fp32 search); (d) a streamed bf16 build
   (``from_chunk_fn``) from chunks of 262,144 rows each made on demand from
   its own generator, its peak device memory beside the constructor's; K4,
   K5 and K6 against their plain versions at the indexes' own probe sets
   and storage (and at m 256 and a capacity off the kernels' tiles), timed
   on cold data, K4 beside the corpus bytes its design reads, K5/K6 beside
   their lookup floor with the load route that ran; (g) first, the flat
   tier over the same rows: exact fp32 (the reference), bf16 rows, int8
   rows and fp32 at recall target 0.95, each with queries/s, batch p50,
   recall@100 and peak memory; (h) last, ``rankpo_tpu_torch.cli.autotune``
   (its ``main``, in this process) on a synthetic 65,536 x 2048 corpus
   (Flat's recall 1.0, the recommendation at its target);
7. evaluation path (beside 5t's ranks, on the FEATURE_LAYERS checkpoint):
   ``rankpo_tpu_torch.cli.evaluate`` with 256 queries, each a span cut from
   one of the 4096 passages and labelled with it, flat (K1), then
   ``--index_type ivf`` (K1, K4) and ``--index_type refine`` (K1): the
   saved metrics bit-equal to
   ``compute_metrics`` recomputed on the host over the saved arrays, the
   flat hits equal to numpy_search over the same embeddings outside
   near-ties; wall time, queries/s and passages/s per call, and which
   metric path (sklearn or numpy) ran; the flat call with the three
   process flags at world size 1 (NCCL), held by the same checks;
8. mining and pipeline paths (after 7, on the FEATURE_LAYERS checkpoint):
   ``get_hard_negatives --method
   topk,cluster --lambda_ 0.5`` over 512 rows (no negative is the query
   or a positive of its row, every row has its count), ``get_predictions``
   (Q x C(5, 2) pair rows), and ``run_pipeline --iterations 2`` over 64
   rows at full width and FEATURE_LAYERS (2) of 16 layers (K1, K3a, K3b): its final model, its prediction pairs and
   its peak device memory; which k-means path ran;
7d, 8's pair, 4d. two ranks sharing the card under gloo (one spawn), each
   on its own row shard of the corpus: (7d) ``cli.evaluate`` flat then
   refine on phase 7's checkpoint and files, each rank's shard embeddings
   bit-equal to a one-process encode of its texts, the flat hits equal to
   numpy_search over the ranks' embeddings outside near-ties, the saved
   metrics bit-equal to the host recompute, refine's recall (near-ties
   counted) >= 0.95, the differences from phase 7's one process printed;
   (8) ``get_hard_negatives`` writing phase 8's files; (4d) ``cli.serve``
   flat fp32 at full width and depth: 32 single requests from 8 clients,
   16-query requests and a filtered one held to numpy_search, p50 and
   p99, ``/add``, ``/remove`` and ``/save``, SIGTERM to rank 0 and both
   ranks exiting 0, one process restarted from the W = 2 file serving the
   W = 2 server's hits; each rank's device, shard rows, K1 launches and
   peak memory;
5b. bge-m3 (beside 5t's ranks, after 8): stage 1 through
   ``run_contrastive.main`` with the config's
   dropout live (attention takes the plain path with attention-probs
   dropout; no flash launch), then stage 2 through ``run_rankpo.main``
   with ``--disable_dropout`` under deterministic algorithms (K1, K3a,
   K3b): finite losses, every parameter moved, the outputs load; one
   stage-1 micro-batch with dropout off through the kernels and plain;
7b. ``cli.evaluate`` flat on bge-m3's stage-2 output (K1, CLS pooling):
   metrics bit-equal to the host recompute, hits equal to numpy_search;
4b. (beside 5t's ranks, after 7b, as are 5q, 4w, 5w and 7w) ``cli.serve``
   flat from a bge-large-en-v1.5 checkpoint at 4 of its 24
   layers (BERT
   positions, 2 token types) and from a Qwen2-1.5B one (q/k/v biases,
   GQA 6:1 at D 128; 4 of its 28 layers): the corpus encode, single and batched /search
   requests held to the numpy oracle as phase 4 holds them;
5q. Qwen2-1.5B: 4 stage-1 steps through ``run_contrastive.main`` (K1,
   K3a, K3b): finite losses, every parameter moved;
4w. intfloat/e5-mistral-7b-instruct (sliding window 4096) at full width and
   4 of its 32 layers: ``cli.serve`` flat over the first 1024 passages (cut from 4096
   for the time limit), held to the numpy oracle as phase 4 holds it,
   every encode batch's K1 launches windowed; two passages of 8192 and
   6001 tokens through the kernels held to the plain attention and shown
   to differ from the same model without the window;
5w. e5-mistral at full width and 4 of its 32 layers (AdamW's state of 7B
   parameters does not fit one card): stage 1 (K1, K2: ``--flash_bwd_impl
   fused``) then stage 2 under
   deterministic algorithms (K1, K3a, K3b), 3 steps each, every passage
   4200-6000 words, past the window; windowed launches on every layer; one
   stage-1 micro-batch through the kernels and through plain;
7w. ``cli.evaluate`` flat on phase 5w's stage-2 output: metrics bit-equal
   to the host recompute, hits equal to numpy_search;
4g. google/gemma-2b ((1 + w) norms drawn N(0, 0.1), GeGLU, scaled
   embeddings, 8 query heads over one kv head of 256) at full width and 4
   of its 18 layers: ``cli.serve`` flat over the 4096 passages, held to the numpy
   oracle and the kernels' encoder to the plain attention as phase 4 holds
   them, every encode layer's K1 launch at head_dim 256;
5g. gemma-2b at full width and 4 of 18 layers (GEMMA_LAYERS): stage 1 (K1, K2: ``--flash_bwd_impl
   fused``) then stage 2 under
   deterministic algorithms (K1, K3a, K3b), 4 steps each at phase 5's
   shapes, launches at head_dim 256 on every layer; one stage-1
   micro-batch through the kernels, plain and in fp32;
7g. ``cli.evaluate`` flat on phase 5g's stage-2 output: metrics bit-equal
   to the host recompute, hits equal to numpy_search;
9. numbers, and each phase's wall seconds.

The hash tokenizer takes each checkpoint's pad id (``hash_special_ids``:
XLM-Roberta pads with 1 and puts CLS at 0), so the Roberta position rule
sees the ids it would see from the model's own tokenizer. Each path's
launch counters are set to 0 just before it runs and read just after. Any failure raises, so the exit code is not 0 and no result line is
printed. The last line of standard output is a JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

from typing import Optional

import numpy as np
import torch

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}
# the published config.json widths of each body (random weights from the
# seed; dropout rates as published): Llama on the main paths, the others in
# phases 4b, 5b, 7b and 5q
MODELS = {
    # meta-llama/Llama-3.2-1B: the widths of the repo's EncoderConfig
    # defaults plus its llama3 RoPE scaling; tied embeddings
    "llama-3.2-1b": dict(rope_scaling=LLAMA3_SCALING, pad_token_id=0,
                         architectures=("LlamaForCausalLM",)),
    "bge-m3": dict(  # BAAI/bge-m3, XLMRobertaModel
        model_type="xlm-roberta", vocab_size=250002, hidden_size=1024,
        intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
        num_key_value_heads=16, max_position_embeddings=8194, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, hidden_act="gelu", hidden_dropout=0.1,
        attention_dropout=0.1, tie_word_embeddings=False, pooling="cls",
        architectures=("XLMRobertaModel",)),
    "bge-large-en-v1.5": dict(  # BAAI/bge-large-en-v1.5, BertModel
        model_type="bert", vocab_size=30522, hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
        pad_token_id=0, hidden_act="gelu", hidden_dropout=0.1, attention_dropout=0.1,
        tie_word_embeddings=False, pooling="cls", architectures=("BertModel",)),
    "qwen2-1.5b": dict(  # Qwen/Qwen2-1.5B, the Qwen2ForCausalLM body
        model_type="qwen2", vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2, head_dim=128,
        max_position_embeddings=131072, rope_theta=1e6, rms_norm_eps=1e-6,
        attention_qkv_bias=True, tie_word_embeddings=True, pooling="last_token",
        architectures=("Qwen2ForCausalLM",)),
    # intfloat/e5-mistral-7b-instruct, MistralModel: sliding-window attention
    # over 4096 keys, pad 2 (its eos), untied embeddings
    "e5-mistral-7b-instruct": dict(
        model_type="mistral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=32768, rope_theta=1e4, rms_norm_eps=1e-5,
        sliding_window=4096, pad_token_id=2, tie_word_embeddings=False,
        pooling="last_token", architectures=("MistralModel",)),
    # google/gemma-2b, GemmaForCausalLM: 8 query heads over one kv head of
    # 256, (1 + w) RMSNorm, the GeGLU gate (tanh form), embeddings scaled by
    # sqrt(hidden), pad 0, tied embeddings; norm weights drawn N(0, 0.1)
    # (make_model_checkpoint) so that (1 + w) bites
    "gemma-2b": dict(
        model_type="gemma", vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
        max_position_embeddings=8192, rope_theta=1e4, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh", pad_token_id=0, tie_word_embeddings=True,
        pooling="last_token", architectures=("GemmaForCausalLM",)),
}
GEMMA = "gemma-2b"
GEMMA_STEPS = 4  # phase 5g: optimizer steps of each stage
# cuts by depth that pay for phases 5t, 7d and 4d: bge-large-en-v1.5 and
# Qwen2-1.5B (4b, 5q) run at 4 of their 24 / 28 layers, gemma-2b (4g, 5g,
# 7g) at 4 of its 18, e5-mistral is served (4w) at 4 of its 32; Llama's
# evaluation and mining (7, 8) at FEATURE_LAYERS
OTHER_LAYERS = 4
GEMMA_LAYERS = 4
MISTRAL_SERVE_LAYERS = 4
GEMMA_NORM_STD = 0.1  # the norm offsets' draw
MISTRAL = "e5-mistral-7b-instruct"
MISTRAL_PASSAGES = 1024  # phase 4w: the serving corpus cut from 4096 for the time limit
MISTRAL_LONG_WORDS = (8191, 6000)  # phase 4w: passages past the window (tokens: + CLS)
MISTRAL_TRAIN_LAYERS = 4  # phase 5w: depth cut from 32 so AdamW's state fits one card
MISTRAL_STEPS = 3  # phase 5w: optimizer steps of each stage
MISTRAL_TRAIN = dict(rows=24, pairs=12, words=(4200, 6000), max_passage=6144,
                     compare_passage=4608)  # phase 5w: passages past the window
BGE_STEPS = 4  # phase 5b: optimizer steps of each bge-m3 stage
QWEN2_STEPS = 4  # phase 5q
N_PASSAGES = 4096
N_TRAIN_ROWS = 512
N_PAIRS = 256
N_EVAL_QUERIES = 256  # phase 7: spans cut from the serving corpus's passages
N_MINING_ROWS = 512  # phase 8: hard-negative mining input
N_PIPELINE_ROWS = 64  # phase 8: run_pipeline's input (its first rows)
EVAL_CUTOFFS = [1, 5, 10, 20, 100]
# an array: rng.choice converts a list to one on every call, 30000 strings
WORDS = np.array([f"w{i}" for i in range(30000)])
OUT_ATOL = 1.5e-2  # bf16 output rounding (values of order 1) and bf16 P
LSE_ATOL = 1e-5
# backward kernels (bf16 dq/dk/dv) against the plain backward in fp32 on the
# same inputs and stats: half a bf16 ulp is 2^-9 of the largest entry; 2^-7
# of max|plain| per tensor also covers one-ulp flips of the bf16 P and dS.
# One outlier sets max|plain| (dV of a length-1 row, where every query row
# puts P = 1 on key 0), so each tensor is also held to a relative L2 error:
# bf16 rounding alone gives about 1e-3, a dropped or doubled tile far more
BWD_TOL_OF_MAX = 2.0**-7
BWD_REL_L2 = 1e-2
# one stage-1 micro-batch at full width, the kernels' bf16 loss against the
# plain attention's fp32 loss: 2.265e-4 read on NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md); the limit is about 10x that
LOSS_REL_FP32 = 2e-3
# a windowed body's embeddings through the kernels against fp32: no farther
# than the plain attention's in bf16, plus phase 4's 0.999 limit's margin
ENCODE_MARGIN = 1e-3
SCORE_ATOL = 1e-5  # cuBLAS and numpy sum the 2048 fp32 products in other orders
# attention shapes (B, Sq, Sk, Hq, Hkv, D), all causal with skip_pad_q as the
# encoder calls them: every kernel is checked at these (random lengths), and
# timed at the first
ENCODER_SHAPES = [(8, 512, 512, 32, 8, 64), (64, 64, 64, 32, 8, 64), (8, 40, 40, 32, 8, 64),
                  (8, 64, 128, 32, 8, 64), (8, 256, 256, 16, 8, 128)]
# the regimes the BGE and Qwen2 bodies add, (shape, causal), skip_pad_q and
# random lengths: bge-m3 / bge-large (non-causal, one query head per kv
# head, D 64) and Qwen2-1.5B (causal, 6 query heads per kv head, D 128)
REGIME_SHAPES = [((8, 512, 512, 16, 16, 64), False), ((8, 512, 512, 12, 2, 128), True)]
# the sliding window (causal, random lengths in [lo, hi] or [1, Sk] for
# None): (shape, window, lengths, skip_pad_q). Mistral's own shape (window
# 4096, every row longer than the window), a window off the 64-key tile, and
# long pad tails without skip_pad_q, so that rows see no valid key. Every
# kernel is checked at each and timed at the first.
WINDOW_SHAPES = [((2, 8192, 8192, 32, 8, 128), 4096, (4097, 8192), True),
                 ((8, 512, 512, 32, 8, 64), 100, None, True),
                 ((4, 1024, 1024, 32, 8, 128), 128, (64, 384), False)]
# head_dim 256 (Gemma; random lengths): (shape, causal, window, skip_pad_q):
# gemma-2b's 8 query heads over one kv head
# (also timed, with random and full lengths), gemma-7b's 16 / 16 (timed),
# many key tiles (timed), non-causal, ragged Sq < Sk without skip_pad_q,
# and a window (the D 256 builds take it too)
D256_SHAPES = [((8, 512, 512, 8, 1, 256), True, None, True),
               ((8, 512, 512, 16, 16, 256), True, None, True),
               ((2, 4096, 4096, 8, 1, 256), True, None, True),
               ((8, 512, 512, 8, 1, 256), False, None, True),
               ((8, 200, 512, 8, 1, 256), True, None, False),
               ((4, 1024, 1024, 8, 1, 256), True, 300, True)]
D256_TIMED = 3  # the first shapes of D256_SHAPES are timed
# sequence packing (segment_ids; phases 2, 4p, 5p): (B, S, Hq, Hkv, D),
# causal, window, text lengths [lo, hi] in tokens, packed best-fit at most
# PACK_MAX_SEGMENTS a row (``data/packing.py``), the first B rows taken:
# BGE's non-causal 16 / 16 at D 64, Llama's causal 32 / 8 (timed), Qwen2's
# 12 / 2 at D 128 and gemma-2b's 8 / 1 at D 256 over the smoke's passage mix
# (16-480 words and a CLS), and Mistral's window of 4096 over texts of up
# to 6000 tokens, longer than the window
PACKED_SHAPES = [((8, 512, 16, 16, 64), False, None, (17, 481)),
                 ((8, 512, 32, 8, 64), True, None, (17, 481)),
                 ((8, 512, 12, 2, 128), True, None, (17, 481)),
                 ((8, 512, 8, 1, 256), True, None, (17, 481)),
                 ((2, 8192, 32, 8, 128), True, 4096, (1024, 6000))]
PACKED_TIMED = 1  # Llama's shape
PACK_MAX_SEGMENTS = 16
PACKED_STEPS = 4  # phase 5p: optimizer steps of each packed stage
# the plain versions run one (batch, kv head) at a time where one call's
# fp32 logits would pass this
PLAIN_CHUNK_BYTES = 2**31
K1_SHAPES = [  # K1 alone: (shape, every key length or None for random)
    ((8, 128, 128, 8, 8, 64), None),  # Hq = Hkv: one query head per block
    ((8, 100, 100, 64, 8, 64), None),  # 8 query heads per kv head
    ((8, 65, 200, 32, 8, 64), None),  # Sq off the 64-row tile, Sk > Sq
    ((8, 64, 64, 32, 8, 64), 1),  # every row of length 1
]
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (K4's FMAs, K5/K6's adds)
PQ_LOOKUPS_PER_CLOCK = 132 * 32  # K5/K6: shared-memory reads, 32 banks on each of 132 SMs
# IVF kernels against their plain versions: fp32 sums of the same exact
# products (K4) or table entries (K5/K6) in another order differ by a few
# fp32 ulps of the largest partial sum, about 1e-6 of the largest score; the
# limit is 1e-5 of it
IVF_RTOL_OF_MAX = 1e-5
IVF_RECALL_MIN = 0.90
SCALE_N, SCALE_D, SCALE_CENTRES, SCALE_Q = 1 << 20, 2048, 8192, 1024
SCALE_NOISE = 1.0  # |noise| / |centre|: rows of one centre at cosine ~0.5
SCALE_SPLIT = 128  # phase 6a: kmeans_split, K / 32 at K 4096
SCALE_MUTATE = 65536  # phase 6c: rows appended, then rows removed
SCALE_CHUNK = 262144  # phase 6d: rows per chunk of the streamed build
SCALE_REDUCED = 256  # phase 6e/6f: the PCA dimension of the hybrid and refine
AUTOTUNE_ROWS = 65536  # phase 6h: the synthetic corpus of cli.autotune
SERVE_TIERS = {  # tier -> (extra CLI flags, the kernel its search runs)
    "flat": ([], None),
    "sqbf16": (["--index_type", "SQbf16"], None),
    "sq8": (["--index_type", "SQ8"], None),
    "approx": (["--recall_target", "0.95"], None),
    "ivf": (["--index_type", "ivf", "--index_dtype", "bfloat16",
             "--recall_target", "0.95"], "ivf_probe_scores"),
    "pq": (["--index_type", "IVF64,PQ64"], "pq_probe_scores"),
    "refine": (["--index_type", "refine", "--index_dtype", "bfloat16",
                "--recall_target", "0.95"], None),
}
N_MUTATE = 256  # phase 4m: passages added, then ids removed
MUTATE_TIERS = {  # tier -> (extra CLI flags, the kernel counter, _probe_kernels kind)
    "flat": ([], None, None),
    "sq8": (["--index_type", "SQ8"], None, None),
    "ivf": (["--index_type", "ivf", "--index_dtype", "bfloat16", "--recall_target", "0.95"],
            "ivf_probe_scores", "bf16"),
    "pq": (["--index_type", "IVF64,PQ64"], "pq_adc_rows", "pq_rows"),
}
KERNELS = {  # name -> (TPU kernel it replaces, source, profiler name test)
    "flash_fwd": ("rankpo_tpu/ops/flash_attention.py:55", "flash_fwd.cu",
                  lambda n: "flash_fwd_kernel" in n),
    "flash_bwd_fused": ("rankpo_tpu/ops/flash_attention.py:341", "flash_bwd.cu",
                        lambda n: "flash_bwd_kv" in n and "true" in n),
    "flash_dq": ("rankpo_tpu/ops/flash_attention.py:161", "flash_bwd.cu",
                 lambda n: "flash_bwd_dq" in n),
    "flash_dkv": ("rankpo_tpu/ops/flash_attention.py:240", "flash_bwd.cu",
                  lambda n: "flash_bwd_kv" in n and "false" in n),
}
IVF_KERNELS = {  # name -> (TPU kernel it replaces, source, launch counter)
    "ivf_probe_scores": ("rankpo_tpu/ops/ivf_gather_pallas.py:43", "ivf_gather.cu",
                         "ivf_probe_scores"),
    "pq_probe_scores": ("rankpo_tpu/ops/pq_adc_pallas.py:126", "pq_adc.cu", "pq_adc_rows"),
    "pq_probe_scores_t": ("rankpo_tpu/ops/pq_adc_pallas.py:186", "pq_adc.cu",
                          "pq_adc_cols"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0])


def cuda_ms(fn, n: int = 20, warmup: int = 3, before=None) -> float:
    """Median of n CUDA-event timings of fn() (after warmup calls);
    ``before()`` runs ahead of each call, outside the timed region."""
    times = []
    for i in range(warmup + n):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("profiler events carry no device time")


PROFILE_TRIES = 3


def profile_device_ms(fn, n: int = 20) -> dict:
    """Device time per kernel name, in ms per call of fn(), over n calls
    traced by torch.profiler (after one warm call). A trace that holds no
    device event at all (CUPTI now and then records nothing for a whole
    trace on these machines) is taken again, up to PROFILE_TRIES times;
    the caller's kernel lookup raises if none held one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = {e.key: _device_us(e) / 1e3 / n for e in prof.key_averages()
                 if _device_us(e) > 0}
        if times:
            return times
        log(f"profiler: no device event in trace {attempt + 1} of {PROFILE_TRIES}")
    return {}


def kernel_ms(times: dict, name: str) -> float:
    match = KERNELS[name][2]
    found = [t for k, t in times.items() if match(k)]
    if not found:
        raise AssertionError(f"{name}: no such kernel in the trace: {sorted(times)}")
    return float(sum(found))


# ---------------------------------------------------------------------------
def phase_environment() -> str:
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card visible: torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"needs compute capability 9.0 (sm_90a), found {cap}")
    card = card_line()
    log(f"card: {card}")
    return card


def phase_build() -> None:
    from rankpo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    for line in _build.build_log().splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling entry",
                                       "Performance Loss")):
            log(f"  ptxas: {line.strip()}")


def _attention_inputs(b, sq, sk, hq, hkv, d, gen, length=None, lens_range=None):
    """Random q/k/v/do and right-padded key lengths: random in [1, Sk] with
    a length-1 and a full-length row, or in ``lens_range`` [lo, hi] with a
    row of hi, or all ``length``."""
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, sq, hq, d, generator=gen, device="cuda").bfloat16()
    if lens_range is None:
        lens = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda")
        lens[0], lens[-1] = 1, sk  # include a length-1 and a full-length row
    else:
        lens = torch.randint(lens_range[0], lens_range[1] + 1, (b,), generator=gen,
                             device="cuda")
        lens[-1] = lens_range[1]
    if length is not None:
        lens[:] = length
    mask = (torch.arange(sk, device="cuda")[None] < lens[:, None]).int()
    return q, k, v, do, mask, lens


def _first_key_tile(q0, shift, causal, window) -> int:
    """The first key tile K1 and K3a run for the query tile at q0: the band
    of its first row with a window, else 0."""
    return max(0, q0 + shift - window + 1) // 64 if causal and window else 0


def _fwd_design_bytes(lens, sq, sk, hq, hkv, d, causal: bool = True, window=None,
                      skip: bool = True) -> int:
    """The bytes K1's design moves: per block of (batch, kv head, 2 query
    heads, or 1 when the group size is odd or D is 256, 64-row query tile)
    that runs key tiles, its Q tiles once and each K/V tile inside its
    bounds (the valid length, the diagonal, the window's band) once for all
    its heads, its mask row scan and the key bits of each tile; out and lse
    written in full."""
    heads = 2 if d != 256 and (hq // hkv) % 2 == 0 else 1
    total = 0
    for n in lens:
        for q0 in range(0, sq, 64):
            n_tiles = -(-n // 64)
            if causal:
                n_tiles = min(n_tiles, (q0 + 63 + sk - sq) // 64 + 1)
            kt0 = _first_key_tile(q0, sk - sq, causal, window)
            if (skip and q0 + sk - sq >= n) or n_tiles <= kt0:
                total += hq // heads * sk * 4  # the mask row scan only
                continue
            kv_rows = min(n_tiles * 64, sk) - kt0 * 64
            total += hq // heads * (heads * min(64, sq - q0) * d * 2
                                    + 2 * kv_rows * d * 2 + sk * 4
                                    + (n_tiles - kt0) * 64 * 4)
    return int(total) + len(lens) * sq * hq * (d * 2 + 4)


def _bwd_design_bytes(lens, sq, sk, hq, hkv, d, kind: str, causal: bool = True,
                      window=None, skip: bool = True) -> int:
    """The bytes the backward kernels' designs move (skip_pad_q),
    outside the wrapper's zero-fills and casts:

    - K2 and K3b: per block of (batch, kv head, 64-key tile; at D 256 two,
      one per column half), its mask row scan, K and V once, and for each
      (query head of the group, query tile) it runs, the Q and dO tiles and
      their lse/delta rows, plus (K2) its columns of the fp32 dQ tile read
      and written once; dK/dV written once as bf16 per kv head;
    - K3a: per block of (batch, query head, 64-row query tile), its mask
      row scan and lse/delta rows; if it runs key tiles, its Q and dO tiles
      once and each key tile's K, V and mask entries; dQ written as bf16."""
    shift = sk - sq
    nq, nk = -(-sq // 64), -(-sk // 64)
    fused = kind == "flash_bwd_fused"
    split = 2 if d == 256 else 1  # kv blocks per key tile
    total = 0
    for n in lens:
        n = int(n)
        if kind == "flash_dq":
            for q0 in range(0, sq, 64):
                rows = min(64, sq - q0)
                n_tiles = -(-n // 64)
                if causal:
                    n_tiles = min(n_tiles, (q0 + 63 + shift) // 64 + 1)
                kt0 = _first_key_tile(q0, shift, causal, window)
                total += hq * (sk * 4 + rows * (d * 2 + 2 * 4))
                if (skip and q0 + shift >= n) or n_tiles <= kt0:
                    continue
                kv_rows = min(n_tiles * 64, sk) - kt0 * 64
                total += hq * (2 * rows * d * 2 + 2 * kv_rows * d * 2
                               + (n_tiles - kt0) * 64 * 4)
            continue
        lim = n - shift
        q_skip = min(nq, 0 if lim <= 0 else -(-lim // 64)) if skip else nq
        for kt in range(nk):
            key0 = kt * 64
            keys = min(64, sk - key0)
            total += split * hkv * (sk * 4 + 2 * keys * d * 2)  # blocks per key tile
            q_begin = max(0, key0 - shift) // 64 if causal else 0
            q_end = q_skip
            if causal and window:  # the last row whose band reaches these keys
                last_row = key0 + 62 + window - shift
                q_end = min(q_end, 0 if last_row < 0 else last_row // 64 + 1)
            if key0 >= n or q_end <= q_begin:
                continue
            step = 0
            for qt in range(q_begin, q_end):
                rows = min(64, sq - qt * 64)
                step += (split * (2 * rows * d * 2 + 2 * rows * 4)
                         + (2 * rows * d * 4 if fused else 0))
            total += hkv * 2 * keys * d * 2 + hq * step
    return int(total)


def attention_cost(lens, sq, sk, hq, hkv, d, kind: str, design: bool = False,
                   causal: bool = True, window=None, skip: bool = True):
    """(bytes, FLOPs) the function of kernel ``kind`` must move and compute
    for these key lengths (skip_pad_q by default, as the encoders call it;
    causal for the llama body, bidirectional for the Roberta body; with a
    ``window``, the band's pairs only): query rows at or past the valid
    length (with skip_pad_q) and masked (query, key) pairs are
    not needed; the outputs are written in full, at the dtype and shape
    ``flash_attention_bwd`` returns (bf16; dk/dv summed over each GQA
    group). With ``design``, the bytes are the kernel's own traffic instead,
    not a bound, as ``_fwd_design_bytes`` and ``_bwd_design_bytes`` count
    them."""
    lens = np.asarray(lens.cpu(), dtype=np.int64)
    b = len(lens)
    shift = sk - sq
    rows = np.arange(sq)
    pairs = q_rows = 0
    for n in lens:
        valid_rows = rows[rows + shift < n] if skip else rows
        keys = np.minimum(n, valid_rows + shift + 1) if causal else np.full(len(valid_rows), n)
        if causal and window:  # keys below the band of each row are not seen
            keys = keys - np.clip(valid_rows + shift - window + 1, 0, None)
        pairs += int(np.clip(keys, 0, None).sum())
        q_rows += len(valid_rows)
    k_rows = int(lens.sum())
    pairs *= hq
    read_q = q_rows * hq * d * 2
    read_kv = 2 * k_rows * hkv * d * 2
    mask = b * sk * 4
    if kind == "flash_fwd":
        nbytes = (_fwd_design_bytes(lens, sq, sk, hq, hkv, d, causal, window, skip)
                  if design else
                  read_q + read_kv + mask + b * sq * hq * d * 2 + b * hq * sq * 4)
        return nbytes, pairs * 2 * 2 * d
    reads = 2 * read_q + read_kv + mask + 2 * q_rows * hq * 4  # q, do, k, v, lse, delta
    dq_out = b * sq * hq * d * 2
    dkv_out = 2 * b * sk * d * hkv * 2
    writes, products = {"flash_bwd_fused": (dq_out + dkv_out, 5),
                        "flash_dq": (dq_out, 3), "flash_dkv": (dkv_out, 4),
                        "flash_dkv_f32": (2 * dkv_out, 4)}[kind]
    nbytes = (_bwd_design_bytes(lens, sq, sk, hq, hkv, d, kind, causal, window, skip)
              if design else reads + writes)
    return nbytes, pairs * products * 2 * d


def bound(cost, peak_ops: float = PEAK_BF16_FLOPS) -> tuple:
    nbytes, flops = cost
    t_bytes, t_flops = nbytes / PEAK_HBM_BYTES, flops / peak_ops
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def _sdpa_mask(mask, sq, sk, causal: bool = True, window=None):
    """SDPA's boolean mask [B, 1, Sq, Sk]: the key mask, the causal triangle
    and, with a window, its band (SDPA has no window argument)."""
    keys = mask.bool()[:, None, None, :]
    if not causal:
        return keys.expand(-1, 1, sq, sk)  # [B, 1, Sq, Sk]
    ones = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    allowed = ones.tril(sk - sq)
    if window:
        allowed &= ones.triu(sk - sq - window + 1)
    return keys & allowed


def _plain_slices(q, k):
    """(batch, query heads, kv head) index slices for the plain versions: the
    whole call, or one (batch, kv head) with its GQA group at a time where
    the call's fp32 logits would pass PLAIN_CHUNK_BYTES."""
    b, sq, hq, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if b * hq * sq * sk * 4 <= PLAIN_CHUNK_BYTES:
        return [(slice(None), slice(None), slice(None))]
    g = hq // hkv
    return [(slice(i, i + 1), slice(h * g, (h + 1) * g), slice(h, h + 1))
            for i in range(b) for h in range(hkv)]


def _rows_of(x, bs):
    """The batch slice ``bs`` of a [B, S] mask or segment tensor (None stays
    None)."""
    return None if x is None else x[bs]


def plain_fwd(q, k, v, mask, causal: bool, window=None, segment_ids=None):
    """``flash_attention_fwd_reference`` in fp32 (out fp32, lse), sliced by
    ``_plain_slices``."""
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_fwd_reference

    slices = _plain_slices(q, k)
    if len(slices) == 1:
        return flash_attention_fwd_reference(q.float(), k.float(), v.float(), mask,
                                             causal=causal, window=window,
                                             segment_ids=segment_ids)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32,
                      device=q.device)
    for bs, qh, kh in slices:
        out[bs, :, qh], lse[bs, qh] = flash_attention_fwd_reference(
            q[bs, :, qh].float(), k[bs, :, kh].float(), v[bs, :, kh].float(),
            _rows_of(mask, bs), causal=causal, window=window,
            segment_ids=_rows_of(segment_ids, bs))
    return out, lse


def plain_attention(q, k, v, mask, causal: bool, window=None, segment_ids=None):
    """The plain attention (``attention_reference``, the port's
    ``impl="plain"``) in the inputs' dtype, sliced by ``_plain_slices``."""
    from rankpo_tpu_torch.ops.attention import attention_reference

    slices = _plain_slices(q, k)
    if len(slices) == 1:
        return attention_reference(q, k, v, mask, causal, window=window,
                                   segment_ids=segment_ids)
    out = torch.empty_like(q)
    for bs, qh, kh in slices:
        out[bs, :, qh] = attention_reference(q[bs, :, qh], k[bs, :, kh], v[bs, :, kh],
                                             _rows_of(mask, bs), causal, window=window,
                                             segment_ids=_rows_of(segment_ids, bs))
    return out


def plain_bwd(q, k, v, mask, do, lse, delta, causal: bool, window=None, segment_ids=None):
    """``flash_attention_bwd_reference`` (fp32 dq, dk, dv), sliced by
    ``_plain_slices``: each slice holds a kv head's whole GQA group, so its
    dk/dv sum is the group's."""
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

    slices = _plain_slices(q, k)
    if len(slices) == 1:
        return flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=causal,
                                             window=window, segment_ids=segment_ids)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for bs, qh, kh in slices:
        dq[bs, :, qh], dk[bs, :, kh], dv[bs, :, kh] = flash_attention_bwd_reference(
            q[bs, :, qh], k[bs, :, kh], v[bs, :, kh], _rows_of(mask, bs), do[bs, :, qh],
            lse[bs, qh].contiguous(), delta[bs, qh].contiguous(), causal=causal,
            window=window, segment_ids=_rows_of(segment_ids, bs))
    return dq, dk, dv


def phase_kernels(seed: int, tmp: str) -> dict:
    """Every kernel against its plain version at the five encoder shapes,
    four more for K1 (one and eight query heads per kv head, a ragged Sq
    below Sk, every key length 1; the backward at all but the last) and the
    two regimes of the BGE and Qwen2 bodies (REGIME_SHAPES), the three
    sliding windows (WINDOW_SHAPES, Mistral's among them) and the six head_dim
    256 shapes (D256_SHAPES), two launches of each on the same inputs bit
    for bit, then times (``time_shape``) at B 8, S 512 (random lengths and
    all full), at the two regimes (random lengths), at Mistral's windowed
    shape, at the backward's one stage-1 micro-batch's shapes and at the
    first three D 256 shapes (gemma-2b's with random and full lengths)."""
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    # the encoder shapes and the timed inputs draw from one generator, the
    # K1-only shapes and the regimes from others, so the timed inputs stay
    # those of earlier versions of this script and times compare across
    # versions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    regime_gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    window_gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    d256_gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    # (shape, every length, generator, causal, window, lengths range, skip_pad_q)
    shapes = ([(shape, None, gen, True, None, None, True) for shape in ENCODER_SHAPES]
              + [(shape, length, k1_gen, True, None, None, True)
                 for shape, length in K1_SHAPES]
              + [(shape, None, regime_gen, causal, None, None, True)
                 for shape, causal in REGIME_SHAPES]
              + [(shape, None, window_gen, True, window, lens_range, skip)
                 for shape, window, lens_range, skip in WINDOW_SHAPES]
              + [(shape, None, d256_gen, causal, window, None, skip)
                 for shape, causal, window, skip in D256_SHAPES])
    err = {name: 0.0 for name in KERNELS}
    worst_lse = 0.0
    flash.reset_launches()
    for shape, length, shape_gen, causal, window, lens_range, skip in shapes:
        b, sq, sk = shape[:3]
        q, k, v, do, mask, lens = _attention_inputs(*shape, shape_gen, length=length,
                                                    lens_range=lens_range)
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip,
                                           window=window)
            again = flash_attention_fwd(q, k, v, mask, causal=causal, skip_pad_q=skip,
                                        window=window)
            ref, rlse = plain_fwd(q, k, v, mask, causal, window)
        torch.cuda.synchronize()
        repeats = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        # skip_pad_q zeroes whole query tiles past the valid length:
        # only rows below it are compared
        rows = (torch.arange(sq, device="cuda")[None] + sk - sq) < lens[:, None]
        if not skip:
            rows = torch.ones_like(rows)
        out_err = (out.float() - ref).abs().amax(dim=(2, 3))[rows].max().item()
        has_key = rlse > -1e29
        keep = rows[:, None, :] & has_key
        lse_err = (lse - rlse).abs()[keep].max().item()
        nokey = ~has_key.permute(0, 2, 1)
        zeros = bool(torch.all(out.abs().amax(-1)[nokey] == 0))
        if out_err > OUT_ATOL or lse_err > LSE_ATOL or not zeros:
            raise AssertionError(f"K1 disagrees with plain at {shape}")
        if not repeats:
            raise AssertionError(f"K1's two launches differ at {shape}")
        err["flash_fwd"] = max(err["flash_fwd"], out_err)
        worst_lse = max(worst_lse, lse_err)
        k1_line = (f"kernels {shape}{'' if causal else ' non-causal'}"
                   f"{'' if length is None else f', every length {length}'}"
                   f"{'' if window is None else f', window {window}'}"
                   f"{'' if lens_range is None else f', lengths in {list(lens_range)}'}"
                   f"{'' if skip else ', no skip_pad_q'}: "
                   f"K1 max|out-plain| {out_err:.3e} max|lse-plain| {lse_err:.3e} no-key "
                   f"rows zero {zeros}, two launches bit-equal {repeats}")
        if length == 1:
            # every valid row puts P = 1 on key 0: dq and dk are rounding
            # noise around 0, so the backward's relative errors say nothing
            log(k1_line + "; backward not compared (dq, dk are 0 up to rounding)")
            continue

        # the backward kernels on the kernel's own stats, against the plain
        # backward on the same stats
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        plain = plain_bwd(q, k, v, mask, do, lse, delta, causal, window)
        got = {}
        for impl in ("fused", "split"):
            got[impl] = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal,
                                            skip_pad_q=skip, window=window, bwd_impl=impl)
        for impl, grads in got.items():  # both give dq, dk, dv bit for bit again
            again = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal,
                                        skip_pad_q=skip, window=window, bwd_impl=impl)
            if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                raise AssertionError(f"{impl} backward: two launches differ at {shape}")
        torch.cuda.synchronize()
        line = []
        typical = [r.abs()[r != 0].median().item() for r in plain]  # masked keys give 0
        for impl, grads in got.items():
            for i, (a, r) in enumerate(zip(grads, plain)):
                diff = a.float() - r
                e = diff.abs().max().item()
                tol = BWD_TOL_OF_MAX * r.abs().max().item()
                rel = (diff.norm() / r.norm()).item()
                if not (e <= tol and rel <= BWD_REL_L2):
                    raise AssertionError(
                        f"{impl} d{'qkv'[i]} disagrees with plain at {shape}: max|err| "
                        f"{e:.3e} (limit {tol:.3e}), relative L2 {rel:.3e} (limit "
                        f"{BWD_REL_L2:.0e})")
                name = ("flash_bwd_fused" if impl == "fused"
                        else ("flash_dq" if i == 0 else "flash_dkv"))
                err[name] = max(err[name], e)
                line.append(f"{impl} d{'qkv'[i]} {e:.2e}/{tol:.2e} rel {rel:.2e}")
        log(k1_line + f"; backward two launches bit-equal (fused, split), max|err|/limit and "
            f"relative L2 (limit {BWD_REL_L2:.0e}): " + ", ".join(line)
            + "; median non-zero |plain| dq {:.2e} dk {:.2e} dv {:.2e}".format(*typical))
        del q, k, v, do, out, lse, ref, rlse, plain, got, again
        torch.cuda.empty_cache()
    windowed, d256 = dict(flash.window_launches), dict(flash.d256_launches)
    log(f"kernels: windowed launches over the {len(WINDOW_SHAPES)} window shapes and the "
        f"D 256 one (checks and repeats) {windowed}; launches at head_dim 256 over the "
        f"{len(D256_SHAPES)} D 256 shapes {d256}")
    if not all(windowed.values()) or not all(d256.values()):
        raise AssertionError(f"a kernel ran no windowed or no D 256 launch: {windowed}, {d256}")

    # ---- times at the encoder's training shape, then at the two regimes ----
    res = {name: {} for name in KERNELS}
    for label in ("random", "full"):
        length = ENCODER_SHAPES[0][2] if label == "full" else None
        for name, row in time_shape(ENCODER_SHAPES[0], True, gen, length, label).items():
            res[name][label] = row
    regimes = {name: {} for name in KERNELS}
    for shape, causal in REGIME_SHAPES:
        for name, row in time_shape(shape, causal, regime_gen, None, "random").items():
            regimes[name][shape] = row
    torch.cuda.empty_cache()
    shape, window, lens_range, skip = WINDOW_SHAPES[0]
    mistral = time_shape(shape, True, window_gen, None, f"in {list(lens_range)}",
                         window=window, lens_range=lens_range, skip=skip, n=5)
    torch.cuda.empty_cache()
    # head_dim 256: gemma-2b's shape with random and full lengths, then the
    # other timed shapes with random lengths
    gemma = {name: {} for name in KERNELS}
    timed = [(D256_SHAPES[0], "random"), (D256_SHAPES[0], "full")] + [
        (shape, "random") for shape in D256_SHAPES[1:D256_TIMED]]
    for (shape, causal, _, _), label in timed:
        length = shape[2] if label == "full" else None
        for name, row in time_shape(shape, causal, d256_gen, length, label).items():
            gemma[name][(shape, label)] = row
        torch.cuda.empty_cache()
    stage1 = time_stage1_bwd(stage1_bwd_inputs(seed, tmp))
    torch.cuda.empty_cache()
    log(f"kernels: max|err| K1 {err['flash_fwd']:.3e} (lse {worst_lse:.3e}) over the "
        f"{len(shapes)} shapes, K2 {err['flash_bwd_fused']:.3e}, K3a {err['flash_dq']:.3e}, "
        f"K3b {err['flash_dkv']:.3e} over the {len(shapes) - 1} with random lengths")
    return {name: dict(res[name]["random"], max_abs_err=err[name], full=res[name]["full"],
                       stage1=stage1.get(name), regimes=regimes[name],
                       mistral=mistral[name], gemma=gemma[name]) for name in KERNELS}


def time_shape(shape, causal: bool, gen, length, label: str, window=None, lens_range=None,
               skip: bool = True, n: int = 20) -> dict:
    """Each kernel's device time at one attention shape (skip_pad_q; random
    key lengths, in ``lens_range``, or all ``length``; with a ``window``,
    its band) beside the plain version's, the one PyTorch call that
    computes the same function (SDPA with the boolean mask; its backward
    alone for the backward kernels) and the bound, each over ``n`` calls.
    Returns {kernel: numbers}."""
    import torch.nn.functional as F

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    b, sq, sk, hq, hkv, d = shape
    tag = (f"{shape} {'causal' if causal else 'non-causal'}"
           f"{'' if window is None else f', window {window}'}")
    res = {}
    q, k, v, do, mask, lens = _attention_inputs(*shape, gen, length=length,
                                                lens_range=lens_range)
    kw = dict(causal=causal, skip_pad_q=skip, window=window)
    with torch.no_grad():
        out, lse = flash_attention_fwd(q, k, v, mask, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    calls = {
        "flash_fwd": lambda: flash_attention_fwd(q, k, v, mask, **kw),
        "fused": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta, **kw,
                                             bwd_impl="fused"),
        "split": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta, **kw,
                                             bwd_impl="split"),
    }
    with torch.no_grad():
        traced = {key: profile_device_ms(fn, n) for key, fn in calls.items()}
        wrapper = {key: cuda_ms(fn, n) for key, fn in calls.items()}
        plain_fwd_ms = cuda_ms(lambda: plain_attention(q, k, v, mask, causal, window), n)
        plain_bwd_ms = cuda_ms(lambda: plain_bwd(q, k, v, mask, do, lse, delta, causal,
                                                 window), n)
        # the yardstick: one PyTorch call on the same inputs (K/V expanded
        # to the query heads outside the timed region) and boolean mask
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt = kt.repeat_interleave(hq // hkv, dim=1)
        vt = vt.repeat_interleave(hq // hkv, dim=1)
        bmask = _sdpa_mask(mask, sq, sk, causal, window)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                 attn_mask=bmask), n)
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    dot = do.transpose(1, 2)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=bmask)
        torch.autograd.grad(o, leaves, dot)

    lib_fwd_bwd_ms = cuda_ms(lib_fwd_bwd, n)
    # the fair yardstick for a backward: SDPA's backward alone, its
    # forward run once outside the timed region
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=bmask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, dot, retain_graph=True), n)
    del o_lib
    kernel_times = {
        "flash_fwd": kernel_ms(traced["flash_fwd"], "flash_fwd"),
        "flash_bwd_fused": kernel_ms(traced["fused"], "flash_bwd_fused"),
        "flash_dq": kernel_ms(traced["split"], "flash_dq"),
        "flash_dkv": kernel_ms(traced["split"], "flash_dkv"),
    }
    for name, ms in kernel_times.items():
        fwd = name == "flash_fwd"
        cost_kw = dict(causal=causal, window=window, skip=skip)
        b_ms, b_by = bound(attention_cost(lens, sq, sk, hq, hkv, d, name, **cost_kw))
        design_mb = attention_cost(lens, sq, sk, hq, hkv, d, name, design=True,
                                   **cost_kw)[0] / 1e6
        res[name] = {
            "ms": ms, "plain_ms": plain_fwd_ms if fwd else plain_bwd_ms,
            "library_ms": lib_fwd if fwd else lib_bwd,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        lib = ("library (SDPA forward)" if fwd else
               f"library (SDPA backward alone) {lib_bwd:.4f} ms, SDPA forward + backward "
               f"{lib_fwd_bwd_ms:.4f}")
        if fwd:
            lib += f" {lib_fwd:.4f} ms"
        log(f"time {name} at {tag}, {label} lengths: kernel {ms:.4f} ms "
            f"(device time, profiler); plain {res[name]['plain_ms']:.4f} ms; "
            f"{lib}; bound {b_ms:.4f} ms ({b_by}); the design's own traffic "
            f"{design_mb:.1f} MB")
    log(f"time wrappers at {tag} ({label} lengths, CUDA events, median of {n}): K1 "
        f"{wrapper['flash_fwd']:.4f} ms, fused backward {wrapper['fused']:.4f} ms, "
        f"split backward {wrapper['split']:.4f} ms (backward wrappers include "
        f"the dq zero-fill and cast); SDPA backward alone {lib_bwd:.4f} ms")
    return res


def packed_layout(b: int, s: int, lens_range, seed: int):
    """A packed batch of the texts of the lengths in ``lens_range`` (tokens,
    drawn from the seed until they fill 1.25 B rows): best-fit packed into
    rows of ``s`` tokens, at most PACK_MAX_SEGMENTS a row
    (``data/packing.py``), the first ``b`` rows kept. Segments start
    mid-tile, cross tiles and leave pad tails. Returns (segment ids [B, S]
    int32 on the card, the kept texts' lengths)."""
    from rankpo_tpu_torch.data.packing import pack_lengths

    rng = np.random.default_rng(seed)
    lengths = []
    while sum(lengths) < 1.25 * b * s:
        lengths.append(int(rng.integers(lens_range[0], lens_range[1] + 1)))
    bins = pack_lengths(lengths, s, PACK_MAX_SEGMENTS)[:b]
    seg = np.zeros((b, s), np.int32)
    kept = []
    for r, items in enumerate(bins):
        pos = 0
        for i, idx in enumerate(items):
            seg[r, pos : pos + lengths[idx]] = i + 1
            pos += lengths[idx]
            kept.append(lengths[idx])
    return torch.from_numpy(seg).cuda(), kept


def packed_attention_cost(seg, hq, hkv, d, kind: str, causal: bool, window=None):
    """(bytes, FLOPs) the function of kernel ``kind`` must move and compute
    on a packed batch: the pairs inside each segment (with ``causal`` the
    triangle, with a ``window`` its band), the segments' query and key rows
    read once (pad rows are not needed), the segment row read, the outputs
    written in full (as ``attention_cost``)."""
    seg = seg.cpu().numpy()
    b, s = seg.shape
    pairs = 0
    for row in seg:
        for n in np.unique(row[row != 0], return_counts=True)[1].astype(np.int64):
            if not causal:
                pairs += n * n
            else:
                pairs += n * (n + 1) // 2
                if window and n > window:
                    pairs -= (n - window) * (n - window + 1) // 2
    rows = int((seg != 0).sum())
    pairs *= hq
    read_q = rows * hq * d * 2
    read_kv = 2 * rows * hkv * d * 2
    if kind == "flash_fwd":
        return read_q + read_kv + b * s * 4 + b * s * hq * (d * 2 + 4), pairs * 2 * 2 * d
    reads = 2 * read_q + read_kv + b * s * 4 + 2 * rows * hq * 4
    dq_out = b * s * hq * d * 2
    dkv_out = 2 * b * s * d * hkv * 2
    writes, products = {"flash_bwd_fused": (dq_out + dkv_out, 5),
                        "flash_dq": (dq_out, 3), "flash_dkv": (dkv_out, 4)}[kind]
    return reads + writes, pairs * products * 2 * d


def _packed_sdpa_mask(seg, causal: bool, window=None):
    """SDPA's boolean mask [B, 1, S, S] of a packed batch: block-diagonal by
    segment, the causal triangle and the window's band; a pad row sees
    itself only, so SDPA's softmax stays finite (a pad row's output is not
    used)."""
    b, s = seg.shape
    keys = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
    ones = torch.ones(s, s, dtype=torch.bool, device=seg.device)
    if causal:
        keys &= ones.tril()
        if window:
            keys &= ones.triu(1 - window)
    keys |= (seg == 0)[:, :, None] & torch.eye(s, dtype=torch.bool, device=seg.device)
    return keys[:, None]


def phase_kernels_packed(seed: int) -> dict:
    """Phase 2, packed: K1, K2, K3a and K3b with segment_ids at every
    PACKED_SHAPES shape against their plain versions (out and lse on every
    row, pad rows zeros with lse NEG_INF; dq, dk, dv with phase 2's limits),
    two launches of each bit-equal, the fused and split backwards' dk and
    dv bit-equal (their dq is printed), each launch counted as packed; then
    times at Llama's shape against the bound of the segments' pairs, the
    plain versions, SDPA with the block-diagonal boolean mask and the
    unpacked kernels on the same texts padded one per row to S."""
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    err = {name: 0.0 for name in KERNELS}
    flash.reset_launches()
    for i, ((b, s, hq, hkv, d), causal, window, lens_range) in enumerate(PACKED_SHAPES):
        seg, texts = packed_layout(b, s, lens_range, seed + 100 + i)
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window, segment_ids=seg)
        before = dict(flash.packed_launches)
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, None, skip_pad_q=True, **kw)
            again = flash_attention_fwd(q, k, v, None, skip_pad_q=True, **kw)
            ref, rlse = plain_fwd(q, k, v, None, **kw)
        torch.cuda.synchronize()
        has_key = rlse > -1e29
        out_err = (out.float() - ref).abs().max().item()
        lse_err = (lse - rlse).abs()[has_key].max().item()
        pad_zero = bool(torch.all(out.abs().amax(-1)[~has_key.permute(0, 2, 1)] == 0)
                        and torch.all(lse[~has_key] == rlse[~has_key]))
        repeats = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        tag = (f"packed {(b, s, hq, hkv, d)} {'causal' if causal else 'non-causal'}"
               f"{'' if window is None else f', window {window}'}, {len(texts)} texts of "
               f"{min(texts)}-{max(texts)} tokens, {int((seg != 0).sum())} of {b * s} "
               "positions in segments")
        if out_err > OUT_ATOL or lse_err > LSE_ATOL or not pad_zero or not repeats:
            raise AssertionError(f"K1 with segments at {tag}: max|out-plain| {out_err:.3e}, "
                                 f"max|lse-plain| {lse_err:.3e}, pad rows zero {pad_zero}, "
                                 f"two launches bit-equal {repeats}")
        err["flash_fwd"] = max(err["flash_fwd"], out_err)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        plain = plain_bwd(q, k, v, None, do, lse, delta, **kw)
        got, line = {}, []
        for impl in ("fused", "split"):
            got[impl] = flash_attention_bwd(q, k, v, None, do, lse, delta, skip_pad_q=True,
                                            bwd_impl=impl, **kw)
            again = flash_attention_bwd(q, k, v, None, do, lse, delta, skip_pad_q=True,
                                        bwd_impl=impl, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got[impl], again)):
                raise AssertionError(f"{impl} backward with segments: two launches differ "
                                     f"at {tag}")
            for j, (a, r) in enumerate(zip(got[impl], plain)):
                diff = a.float() - r
                e = diff.abs().max().item()
                tol = BWD_TOL_OF_MAX * r.abs().max().item()
                rel = (diff.norm() / r.norm()).item()
                if not (e <= tol and rel <= BWD_REL_L2):
                    raise AssertionError(
                        f"{impl} d{'qkv'[j]} with segments disagrees with plain at {tag}: "
                        f"max|err| {e:.3e} (limit {tol:.3e}), relative L2 {rel:.3e}")
                name = ("flash_bwd_fused" if impl == "fused"
                        else ("flash_dq" if j == 0 else "flash_dkv"))
                err[name] = max(err[name], e)
                line.append(f"{impl} d{'qkv'[j]} {e:.2e}/{tol:.2e} rel {rel:.2e}")
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(got["fused"], got["split"])]
        if not (same[1] and same[2]):
            raise AssertionError(f"fused and split dk/dv differ with segments at {tag}")
        dq_gap = (got["fused"][0].float() - got["split"][0].float()).abs().max().item()
        counted = {n: flash.packed_launches[n] - before[n] for n in before}
        if counted != {"flash_fwd": 2, "flash_bwd_fused": 2, "flash_dq": 2, "flash_dkv": 2}:
            raise AssertionError(f"packed launches at {tag}: {counted}")
        log(f"kernels {tag}: K1 max|out-plain| {out_err:.3e} max|lse-plain| {lse_err:.3e}, "
            f"pad rows zero {pad_zero}; two launches of each kernel bit-equal; backward "
            "max|err|/limit and relative L2: " + ", ".join(line)
            + f"; fused vs split bit-equal dq {same[0]} (max gap {dq_gap:.2e}), dk "
            f"{same[1]}, dv {same[2]}")
        del q, k, v, do, out, lse, ref, rlse, plain, got, again
        torch.cuda.empty_cache()
    log(f"kernels with segments: max|err| K1 {err['flash_fwd']:.3e}, K2 "
        f"{err['flash_bwd_fused']:.3e}, K3a {err['flash_dq']:.3e}, K3b {err['flash_dkv']:.3e} "
        f"over the {len(PACKED_SHAPES)} packed shapes")
    res = time_packed(seed, gen)
    for name in KERNELS:
        res[name]["max_abs_err"] = err[name]
    return res


def time_packed(seed: int, gen) -> dict:
    """Each kernel's device time with segments at Llama's packed shape
    (PACKED_SHAPES[PACKED_TIMED]) beside the bound of the segments' pairs,
    the plain version, SDPA with the block-diagonal boolean mask (its
    backward alone for the backward kernels) and the same kernel unpacked on
    the same texts, one per row padded to S."""
    import torch.nn.functional as F

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    (b, s, hq, hkv, d), causal, window, lens_range = PACKED_SHAPES[PACKED_TIMED]
    seg, texts = packed_layout(b, s, lens_range, seed + 100 + PACKED_TIMED)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
    kw = dict(causal=causal, skip_pad_q=True, window=window, segment_ids=seg)
    with torch.no_grad():
        out, lse = flash_attention_fwd(q, k, v, None, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    # the same texts unpacked: one per row, padded to S, their own key mask
    n = len(texts)
    lens = torch.tensor(texts, device="cuda")
    mask = (torch.arange(s, device="cuda")[None] < lens[:, None]).int()
    uq = torch.randn(n, s, hq, d, generator=gen, device="cuda").bfloat16()
    uk = torch.randn(n, s, hkv, d, generator=gen, device="cuda").bfloat16()
    uv = torch.randn(n, s, hkv, d, generator=gen, device="cuda").bfloat16()
    udo = torch.randn(n, s, hq, d, generator=gen, device="cuda").bfloat16()
    ukw = dict(causal=causal, skip_pad_q=True, window=window)
    with torch.no_grad():
        uout, ulse = flash_attention_fwd(uq, uk, uv, mask, **ukw)
    udelta = (udo.float() * uout.float()).sum(-1).permute(0, 2, 1).contiguous()
    ugrads = [flash_attention_bwd(uq, uk, uv, mask, udo, ulse, udelta, **ukw, bwd_impl=impl)
              for impl in ("fused", "split")]
    log("unpacked kernels on the same texts: fused vs split bit-equal dq "
        f"{torch.equal(ugrads[0][0], ugrads[1][0])} (max gap "
        f"{(ugrads[0][0].float() - ugrads[1][0].float()).abs().max().item():.2e}), dk "
        f"{torch.equal(ugrads[0][1], ugrads[1][1])}, dv {torch.equal(ugrads[0][2], ugrads[1][2])}")
    del ugrads
    calls = {
        "flash_fwd": lambda: flash_attention_fwd(q, k, v, None, **kw),
        "fused": lambda: flash_attention_bwd(q, k, v, None, do, lse, delta, **kw,
                                             bwd_impl="fused"),
        "split": lambda: flash_attention_bwd(q, k, v, None, do, lse, delta, **kw,
                                             bwd_impl="split"),
        "u_fwd": lambda: flash_attention_fwd(uq, uk, uv, mask, **ukw),
        "u_fused": lambda: flash_attention_bwd(uq, uk, uv, mask, udo, ulse, udelta, **ukw,
                                               bwd_impl="fused"),
        "u_split": lambda: flash_attention_bwd(uq, uk, uv, mask, udo, ulse, udelta, **ukw,
                                               bwd_impl="split"),
    }
    with torch.no_grad():
        traced = {key: profile_device_ms(fn) for key, fn in calls.items()}
        plain_fwd_ms = cuda_ms(lambda: plain_attention(q, k, v, None, causal, window, seg))
        plain_bwd_ms = cuda_ms(lambda: plain_bwd(q, k, v, None, do, lse, delta, causal,
                                                 window, seg))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt = kt.repeat_interleave(hq // hkv, dim=1)
        vt = vt.repeat_interleave(hq // hkv, dim=1)
        bmask = _packed_sdpa_mask(seg, causal, window)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask))
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=bmask)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, dot, retain_graph=True))
    del o_lib
    res = {}
    for name, key in (("flash_fwd", "flash_fwd"), ("flash_bwd_fused", "fused"),
                      ("flash_dq", "split"), ("flash_dkv", "split")):
        fwd = name == "flash_fwd"
        ms = kernel_ms(traced[key], name)
        unpacked_ms = kernel_ms(traced["u_" + key.replace("flash_", "")], name)
        b_ms, b_by = bound(packed_attention_cost(seg, hq, hkv, d, name, causal, window))
        res[name] = {"ms": ms, "plain_ms": plain_fwd_ms if fwd else plain_bwd_ms,
                     "library_ms": lib_fwd if fwd else lib_bwd, "bound_ms": b_ms,
                     "bound_by": b_by, "unpacked_ms": unpacked_ms}
        log(f"time {name} with segments at {(b, s, hq, hkv, d)} "
            f"{'causal' if causal else 'non-causal'}, {n} texts of {min(texts)}-{max(texts)} "
            f"tokens in {b} rows: kernel {ms:.4f} ms (device time, profiler); plain "
            f"{res[name]['plain_ms']:.4f} ms; library (SDPA with the block-diagonal mask"
            f"{', forward' if fwd else ', backward alone'}) {res[name]['library_ms']:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}); the unpacked kernel on the same texts, {n} rows "
            f"padded to {s}: {unpacked_ms:.4f} ms")
    return res


def phase_search_ties() -> None:
    from rankpo_tpu_torch.index.flat import FlatIPIndex, numpy_search

    rng = np.random.default_rng(0)
    corpus = (rng.integers(-8, 9, (N_PASSAGES, 2048)) / 16.0).astype(np.float32)
    corpus[[11, 17, 3000]] = corpus[5]
    queries = (rng.integers(-8, 9, (8, 2048)) / 16.0).astype(np.float32)
    queries[0] = corpus[5]
    got = FlatIPIndex(torch.from_numpy(corpus).cuda()).search(queries, k=100)
    ref = numpy_search(corpus, queries, 100)
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError("exact search differs from numpy_search on exact ties")
    log("search: tie order and scores bit-equal to numpy_search on exact data")


# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


# |score| bound of unit queries and rows as a tier stores and scores them:
# bf16 rounding puts each vector's norm within 2^-8 of 1; int8 rows (and on
# the card the queries) hold max|x| / 127 per entry, a dequantized unit
# vector's norm within a few percent of 1; PQ's ADC score adds the codec's
# residual error
SCORE_BOUNDS = {"fp32": 1 + 1e-3, "bf16": 1 + 2**-7, "int8": 1.05, "pq": 1.5}
TIER_STORAGE = {"flat": "fp32", "approx": "fp32", "sqbf16": "bf16", "ivf": "bf16",
                "refine": "bf16", "sq8": "int8", "pq": "pq"}


def _check_reply(status, body, n_queries, k, exact_k=True, score_bound=1 + 1e-3):
    """An IVF reply may hold fewer than k hits: probed slots that hold no
    row are never served."""
    if status != 200 or len(body["results"]) != n_queries:
        raise AssertionError(f"bad reply {status}: {str(body)[:200]}")
    for res in body["results"]:
        scores = [h["score"] for h in res["hits"]]
        if len(scores) != k if exact_k else not 0 < len(scores) <= k:
            raise AssertionError(f"{len(scores)} hits, expected {k}")
        if any(a < b for a, b in zip(scores, scores[1:])):
            raise AssertionError("scores not non-increasing")
        if max(abs(s) for s in scores) > score_bound:
            raise AssertionError(f"|score| > {score_bound} for normalised embeddings")


def _check_against_oracle(served_idx, served_scores, oracle_scores, oracle_idx):
    """Identical indices wherever neighbouring oracle scores differ by more
    than SCORE_ATOL; scores within SCORE_ATOL. The oracle carries one rank
    more than was served, so a near-tie across the k boundary is seen."""
    k = served_idx.shape[1]
    if np.abs(served_scores - oracle_scores[:, :k]).max() > SCORE_ATOL:
        raise AssertionError("served scores differ from the oracle's")
    gap = np.abs(np.diff(oracle_scores, axis=1)) > SCORE_ATOL  # [Q, k]
    clear = gap.copy()
    clear[:, 1:] &= gap[:, :-1]
    if not np.array_equal(served_idx[clear], oracle_idx[:, :k][clear]):
        raise AssertionError("served indices differ from the oracle's")
    return int((~clear).sum())


@functools.lru_cache(maxsize=None)
def _serving_data(seed: int, tmp: str, n_passages: int = N_PASSAGES):
    """The corpus file (the first ``n_passages`` of 4096 passages of 16-480
    words) and 64 queries, made once per seed and directory (every serving
    phase reads the same)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 481, N_PASSAGES)
    corpus = [" ".join(rng.choice(WORDS, size=n)) for n in lengths][:n_passages]
    corpus_file = os.path.join(
        tmp, "corpus.jsonl" if n_passages == N_PASSAGES else f"corpus_{n_passages}.jsonl")
    _write_lines(corpus_file, (json.dumps({"text": text}) + "\n" for text in corpus))
    queries = [" ".join(rng.choice(WORDS, size=n))
               for n in rng.integers(4, 33, 64)]
    return corpus, corpus_file, queries


FLAT_EXACT_TIERS = ("flat", "sqbf16", "sq8")


def scored_queries(index, q_emb: np.ndarray) -> np.ndarray:
    """The queries as a flat index scores them, for an oracle over its
    decoded rows: fp32 rows take them as they are, bf16 and int8 (dequant)
    rows rounded to bf16, int8 rows on the card quantized per row (the int8
    product's codec) and dequantized."""
    from rankpo_tpu_torch.ops.topk import int8_product_available, quantize_queries_int8

    if index.dtype == torch.float32:
        return q_emb
    qb = torch.from_numpy(q_emb).bfloat16()
    if index.quantized and int8_product_available(index.corpus):
        q8, q_scale = quantize_queries_int8(qb)
        return (q8.float() * q_scale[:, None]).numpy()
    return qb.float().numpy()


def _served(body):
    idx = [[h["index"] for h in r["hits"]] for r in body["results"]]
    sc = [[h["score"] for h in r["hits"]] for r in body["results"]]
    return idx, sc


def encode_k1_inputs(encoder, corpus):
    """The inputs K1 gets over one layer of the corpus encode: the encode's
    own batches of 64 (sorted by length, each padded to its 64-token bucket,
    its own key mask), q/k/v random at the model's heads (views of one
    tensor of the longest bucket). Returns (q, k, v, masks); K1 runs on
    q[:b, :s], k[:b, :s], v[:b, :s] for each [b, s] mask."""
    order = np.argsort([len(text) for text in corpus], kind="stable")
    texts = [corpus[i] for i in order]
    chunks = [texts[lo : lo + 64] for lo in range(0, len(texts), 64)]
    masks = [torch.from_numpy(encoder.prepare_batch(chunk, len(chunk), 512)
                              ["attention_mask"]).cuda() for chunk in chunks]
    cfg = encoder.config
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    s_max = max(m.shape[1] for m in masks)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(64, s_max, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(64, s_max, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(64, s_max, hkv, d, generator=gen, device="cuda").bfloat16()
    return q, k, v, masks


def run_encode_k1(q, k, v, masks, causal: bool = True, window=None) -> None:
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_fwd

    for m in masks:
        b, s = m.shape
        flash_attention_fwd(q[:b, :s], k[:b, :s], v[:b, :s], m, causal=causal,
                            skip_pad_q=True, window=window)


def time_encode_k1(encoder, corpus) -> dict:
    """K1 at the shapes the corpus encode launches (``encode_k1_inputs``), no
    grad: device time of one layer's launches over the whole corpus, against
    the summed bound and the design's traffic."""
    q, k, v, masks = encode_k1_inputs(encoder, corpus)
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    causal, window = encoder.config.is_llama, encoder.config.sliding_window
    with torch.no_grad():
        ms = kernel_ms(profile_device_ms(
            lambda: run_encode_k1(q, k, v, masks, causal, window), n=5), "flash_fwd")
    bound_ms = design = 0.0
    for m in masks:
        s = m.shape[1]
        lens = m.sum(1)
        bound_ms += bound(attention_cost(lens, s, s, hq, hkv, d, "flash_fwd",
                                         causal=causal, window=window))[0]
        design += attention_cost(lens, s, s, hq, hkv, d, "flash_fwd", design=True,
                                 causal=causal, window=window)[0]
    widths = sorted({m.shape[1] for m in masks})
    log(f"time flash_fwd at the corpus encode's shapes ({len(masks)} batches of 64, padded "
        f"to {widths[0]}-{widths[-1]}, {'causal' if causal else 'non-causal'}, Hq {hq}, Hkv "
        f"{hkv}, D {d}, skip_pad_q, no grad): kernel {ms:.4f} ms per "
        f"layer over the corpus (device time, profiler; {ms / len(masks):.4f} ms per batch); "
        f"bound {bound_ms:.4f} ms (summed over the batches); the design's own traffic "
        f"{design / 1e6:.1f} MB")
    return {"ms": ms, "bound_ms": bound_ms, "batches": len(masks)}


def stage1_bwd_inputs(seed: int, tmp: str) -> dict:
    """The attention inputs of one stage-1 micro-batch: the key masks of the
    first micro-batch of the profiled step's loader (``phase_profile``: 8
    queries padded to 128 tokens, 32 passages padded to 512), q/k/v/do
    random at Llama-3.2-1B's heads. Returns {field: (q, k, v, do, mask)}."""
    from rankpo_tpu_torch.data.collators import ContrastiveCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, iter_jsonl
    from rankpo_tpu_torch.data.loader import DataLoader
    from rankpo_tpu_torch.data.tokenization import HashTokenizer
    from rankpo_tpu_torch.models.config import EncoderConfig

    train, _ = write_training_data(tmp, seed)
    rows = [r for _, r in zip(range(32), iter_jsonl(train))]
    ds = ContrastiveDataset(rows, HashTokenizer(vocab_size=128256), 128, 512)
    loader = DataLoader(ds, ContrastiveCollator(0, 3, 128, 512, seed=seed), 8, seed=seed)
    group = next(loader.epoch(0, stack=2))
    cfg = EncoderConfig()
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    out = {}
    for field in ("query", "passage"):
        mask = torch.from_numpy(group[field]["attention_mask"][0]).cuda().int()
        b, s = mask.shape
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        out[field] = (q, k, v, do, mask)
    return out


def time_stage1_bwd(inputs: dict) -> dict:
    """K2, K3a and K3b at one stage-1 micro-batch's shapes
    (``stage1_bwd_inputs``): device time of one layer's backward over both
    fields, against the summed bound and the designs' traffic; the
    wrappers' times (CUDA events)."""
    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    prepared = []
    for q, k, v, do, mask in inputs.values():
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        prepared.append((q, k, v, mask, do, lse, delta))

    def run(impl):
        for args in prepared:
            flash_attention_bwd(*args, causal=True, skip_pad_q=True, bwd_impl=impl)

    traced = {impl: profile_device_ms(lambda impl=impl: run(impl)) for impl in ("fused", "split")}
    wrapper = {impl: cuda_ms(lambda impl=impl: run(impl)) for impl in ("fused", "split")}
    res = {}
    for name, impl in (("flash_bwd_fused", "fused"), ("flash_dq", "split"),
                       ("flash_dkv", "split")):
        ms = kernel_ms(traced[impl], name)
        b_ms = design = 0.0
        for q, k, _, mask, *_ in prepared:
            shape = (q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
            b_ms += bound(attention_cost(mask.sum(1), *shape, name))[0]
            design += attention_cost(mask.sum(1), *shape, name, design=True)[0]
        res[name] = {"ms": ms, "bound_ms": b_ms, "design_mb": design / 1e6}
        log(f"time {name} at the stage-1 micro-batch's shapes (queries "
            f"{tuple(inputs['query'][4].shape)}, passages {tuple(inputs['passage'][4].shape)}, "
            f"causal, skip_pad_q): kernel {ms:.4f} ms per layer (device time, profiler); bound "
            f"{b_ms:.4f} ms (summed); the design's own traffic {design / 1e6:.1f} MB")
    log(f"time backward wrappers at the stage-1 micro-batch's shapes (CUDA events, median of "
        f"20, both fields): fused {wrapper['fused']:.4f} ms, split {wrapper['split']:.4f} ms")
    res["wrapper_ms"] = wrapper
    return res


def phase_serving(seed: int, tmp: str, ckpt: str, tier: str = "flat", model: str = "",
                  n_passages: int = N_PASSAGES) -> dict:
    """The serving path: the CLI's server over a corpus (the first
    ``n_passages`` of the 4096), queried by HTTP, with the index tier
    ``tier`` (SERVE_TIERS), from the checkpoint ``ckpt`` of any ported body
    (``model`` names it in the log). A windowed body must launch K1 with its
    window on every layer of every encode batch, and (flat) encode passages
    longer than the window (``window_bites``)."""
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    config = EncoderConfig.from_pretrained(ckpt)
    layers = config.num_hidden_layers
    label = f"{model}, {tier}" if model else tier
    corpus, corpus_file, queries = _serving_data(seed, tmp, n_passages)
    extra, ivf_kernel = SERVE_TIERS[tier]
    flat = tier in FLAT_EXACT_TIERS
    port = _free_port()
    argv = ["--model_name_or_path", ckpt, "--tokenizer_name", f"hash:{config.vocab_size}",
            "--corpus_data", corpus_file, "--max_query_length", "512",
            "--max_passage_length", "512", "--batch_size", "64",
            "--device", "cuda", "--port", str(port), "--log_level", "warning", *extra]
    # ---- the serving path: counters from 0, server start, requests ----
    flash.reset_launches()
    ivf_gather.reset_launches()
    pq_adc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    server, thread, startup_s = start_server(argv, port, n_passages)
    service = server.service
    index = service.index
    t_requests = time.perf_counter()
    try:
        with ThreadPoolExecutor(8) as pool:
            singles = list(pool.map(
                lambda i: (_http(port, "/search", {"query": queries[i],
                                                   "k": (10, 100)[i % 2]}), i),
                range(32)))
        batched = []
        for j, k in enumerate((10, 100, 10, 100)):
            group = queries[16 * j : 16 * (j + 1)]
            batched.append((_http(port, "/search", {"queries": group, "k": k}),
                            group, k, {}))
        # a per-call nprobe (IVF) or candidate pool (refine); such requests
        # bypass the batcher
        per_call = ({"nprobe": max(1, index.nprobe // 2)} if ivf_kernel is not None
                    else {"candidates": 2 * index.candidates} if tier == "refine" else None)
        if per_call is not None:
            group = queries[:16]
            batched.append((_http(port, "/search", {"queries": group, "k": 100, **per_call}),
                            group, 100, per_call))
        launches = {"flash_fwd": flash.launches["flash_fwd"],
                    **{name: ivf_gather.launches.get(name, 0) + pq_adc.launches.get(name, 0)
                       for name in ("ivf_probe_scores", "pq_adc_rows", "pq_adc_cols")}}
        windowed = flash.window_launches["flash_fwd"]
        d256 = flash.d256_launches["flash_fwd"]
        # ---- end of the serving path ----
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        exact_k = ivf_kernel is None  # the flat tiers and refine fill every k
        bound = SCORE_BOUNDS[TIER_STORAGE[tier]]
        for (status, body, _), i in singles:
            _check_reply(status, body, 1, (10, 100)[i % 2], exact_k, bound)
        for (status, body, _), group, k, _ in batched:
            _check_reply(status, body, len(group), k, exact_k, bound)
        stats = _http(port, "/statsz")[1]
        log(f"served ({label}): 32 single queries from 8 clients in "
            f"{stats['microbatch_dispatches']} micro-batches, "
            f"{len(batched)} batched requests of 16; start {startup_s:.2f} s, requests "
            f"{time.perf_counter() - t_requests:.2f} s")

        n_batches = -(-n_passages // 64)
        if launches["flash_fwd"] < layers * n_batches:
            raise AssertionError(
                f"flash kernel launched {launches['flash_fwd']} times on the main "
                f"path; expected >= {layers * n_batches} ({layers} layers x {n_batches} "
                "encode batches)")
        if config.sliding_window is not None and windowed < layers * n_batches:
            raise AssertionError(f"K1 ran {windowed} windowed launches on the {label} path")
        if config.head_dim == 256 and d256 < layers * n_batches:
            raise AssertionError(f"K1 ran {d256} launches at head_dim 256 on the {label} path")
        counter = ivf_kernel and IVF_KERNELS[ivf_kernel][2]
        if counter is not None and launches[counter] <= 0:
            raise AssertionError(f"{ivf_kernel} was not launched on the {label} path")
        log(f"kernel launches on the {label} serving path: {launches}"
            + ("" if config.sliding_window is None else
               f"; K1 with the window of {config.sliding_window} keys: {windowed}")
            + ("" if config.head_dim != 256 else f"; K1 at head_dim 256: {d256}"))

        # each batched request embedded again exactly as the service embedded
        # it: the flat tier against the exact numpy oracle over the index
        # rows; the IVF and refine tiers against the index's own search (same
        # kernel, same inputs: a consistency check) and, for recall, the
        # exact search over the stored rows
        n_near, recalls = 0, []
        if flat or tier in ("approx", "refine"):  # the stored rows, decoded
            rows = index.reconstruct(np.arange(index.ntotal))
        for (_, body, _), group, k, search_kw in batched:
            batch = service.encoder.prepare_batch(group, len(group), 512)
            q_emb = service.encoder.embed_batch(batch).cpu().numpy()
            s_idx, s_sc = _served(body)
            if flat:
                # one extra oracle rank: a near-tie across the k boundary;
                # the queries as the search scores them
                o_scores, o_idx = numpy_search(rows, scored_queries(index, q_emb), k + 1)
                n_near += _check_against_oracle(np.array(s_idx), np.array(s_sc),
                                                o_scores, o_idx)
                continue
            if tier == "approx":
                e_idx = numpy_search(rows, q_emb, k)[1]
                recalls += [len(set(a) & set(b.tolist())) / k for a, b in zip(s_idx, e_idx)]
                continue
            # the server searched at k_max 100 and sliced to k
            r_sc, r_idx = index.search(q_emb, k=100, **search_kw)
            if tier == "refine":
                q_b = torch.from_numpy(q_emb).bfloat16().float().numpy()
                e_idx = numpy_search(rows, q_b, k)[1]
            else:
                _, e_idx = index.exact_search(q_emb, k=k)
            for r in range(len(group)):
                keep = r_idx[r] >= 0
                o_sc, o_idx = r_sc[r][keep][: k + 1], r_idx[r][keep][: k + 1]
                n = len(s_idx[r])
                if n != min(k, keep.sum()):
                    raise AssertionError(f"{n} served hits, the index found {keep.sum()}")
                o_sc = np.concatenate([o_sc, np.full(n + 1 - len(o_sc), -np.inf)])
                o_idx = np.concatenate([o_idx, np.full(n + 1 - len(o_idx), -1)])
                n_near += _check_against_oracle(
                    np.array([s_idx[r]]), np.array([s_sc[r]]), o_sc[None], o_idx[None])
                recalls.append(len(set(s_idx[r]) & set(e_idx[r].tolist())) / k)
        numbers = {}
        if tier == "approx":
            numbers["recall"] = float(np.mean(recalls))
            log(f"index (approx, recall_target 0.95): recall@k of the served hits against "
                f"the exact numpy_search {numbers['recall']:.4f} (limit 0.95)")
            if not numbers["recall"] >= 0.95:
                raise AssertionError(f"approximate flat recall {numbers['recall']:.4f} < 0.95")
        else:
            oracle = ("numpy_search over the reconstructed rows, the queries as scored"
                      if flat else "the index's own search on the same embeddings")
            log(f"index ({label}): served top-k equal to {oracle} ({n_near} hits inside "
                f"{SCORE_ATOL} near-ties not compared)")
        if tier == "refine":
            numbers.update(recall=float(np.mean(recalls)), candidates=index.candidates,
                           reduced_dim=index.reduced_dim, per_call=per_call)
            log(f"index (refine): d' {index.reduced_dim}, tuned candidates "
                f"{index.candidates}, per-call {per_call}; recall@k of the served hits "
                f"against the exact search over the stored rows {numbers['recall']:.4f} "
                "(random weights: printed, not held)")
        elif ivf_kernel is not None:
            numbers.update(
                recall=float(np.mean(recalls)), nprobe=index.nprobe,
                n_clusters=index.n_clusters, capacity=index.capacity,
                build_s=dict(index.build_seconds))
            log(f"index ({label}): K {index.n_clusters}, capacity {index.capacity}, "
                f"tuned nprobe {index.nprobe}, build {index.build_seconds}; recall@k of "
                f"the served hits against the index's exact search "
                f"{numbers['recall']:.4f} (random weights: printed, not held)")
        if tier == "flat":
            # the kernel inside the encoder against the plain attention
            batch = service.encoder.prepare_batch(corpus[:64], 64, 512)
            a = service.encoder.embed_batch(batch, attn_impl="auto")
            p = service.encoder.embed_batch(batch, attn_impl="plain")
            cos = torch.nn.functional.cosine_similarity(a, p).min().item()
            log(f"encoder: min cosine kernel vs plain over 64 passages {cos:.6f}")
            if config.sliding_window is None and cos < 0.999:
                raise AssertionError("encoder embeddings through the kernel disagree")
            if config.sliding_window is not None:
                # 32 random layers of 4096 carry bf16 rounding past that
                # limit on any two bf16 paths: both are held to fp32
                hold_to_fp32(a, p, fp32_embed(service.encoder, batch), "64 passages")
                numbers["window_bites"] = window_bites(service.encoder, seed)
            numbers["k1_encode"] = time_encode_k1(service.encoder, corpus)

            # numbers: a timed re-encode of the corpus
            tok = service.encoder.tokenizer
            n_tokens = sum(len(x) for x in tok(corpus, max_length=512,
                                               truncation=True)["input_ids"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb, _ = service.encoder.encode_device(corpus, batch_size=64,
                                                   max_length=512)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            if not torch.isfinite(emb).all():
                raise AssertionError("non-finite corpus embeddings")
            numbers.update(encode_s=enc_s, passages_per_s=n_passages / enc_s,
                           tokens_per_s=n_tokens / enc_s, corpus_tokens=n_tokens)
        lat = np.array([r[0][2] for r in singles]) * 1e3
        lat_b = np.array([r[0][2] for r in batched[:4]]) * 1e3
        numbers.update({
            "startup_s": startup_s,
            "search_single_p50_ms": float(np.percentile(lat, 50)),
            "search_single_p99_ms": float(np.percentile(lat, 99)),
            "search_batch16_p50_ms": float(np.percentile(lat_b, 50)),
            "peak_mem_gib": peak_gib,
            "launches": launches,
            "window_launches": windowed,
            "d256_launches": d256,
        })
    finally:
        t_stop = time.perf_counter()
        stop_server(server, thread)
    log(f"served ({label}): server stopped in {time.perf_counter() - t_stop:.2f} s")
    return numbers


def phase_serving_packed(seed: int, tmp: str, ckpt: str, unpacked: dict) -> dict:
    """Phase 4p, packed query serving: ``cli.serve --pack_queries
    --pack_max_segments 16`` over phase 4's corpus, flat, the same 32 single
    queries from 8 clients and 4 requests of 16. Every reply is checked, the
    query encodes launch K1 with segments, each batched request's served hits
    equal numpy_search over the index rows with its packed embeddings (the
    queries as the service embeds them), and those embeddings are within
    cosine 0.999 of the unpacked service's (``unpacked`` is phase 4's flat
    numbers, whose latencies are printed beside these)."""
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.ops import flash_attention as flash

    config = EncoderConfig.from_pretrained(ckpt)
    corpus, corpus_file, queries = _serving_data(seed, tmp)
    port = _free_port()
    argv = ["--model_name_or_path", ckpt, "--tokenizer_name", f"hash:{config.vocab_size}",
            "--corpus_data", corpus_file, "--max_query_length", "512",
            "--max_passage_length", "512", "--batch_size", "64", "--device", "cuda",
            "--port", str(port), "--log_level", "warning", "--pack_queries",
            "--pack_max_segments", str(PACK_MAX_SEGMENTS)]
    # ---- the packed serving path: counters from 0, server start, requests ----
    flash.reset_launches()
    server, thread, startup_s = start_server(argv, port)
    try:
        with ThreadPoolExecutor(8) as pool:
            singles = list(pool.map(
                lambda i: (_http(port, "/search", {"query": queries[i],
                                                   "k": (10, 100)[i % 2]}), i),
                range(32)))
        batched = []
        for j, k in enumerate((10, 100, 10, 100)):
            group = queries[16 * j : 16 * (j + 1)]
            batched.append((_http(port, "/search", {"queries": group, "k": k}), group, k))
        packed = dict(flash.packed_launches)
        # ---- end of the packed serving path ----
        for (status, body, _), i in singles:
            _check_reply(status, body, 1, (10, 100)[i % 2])
        for (status, body, _), group, k in batched:
            _check_reply(status, body, len(group), k)
        if packed["flash_fwd"] < config.num_hidden_layers:
            raise AssertionError(f"packed serving: K1 ran {packed['flash_fwd']} launches with "
                                 "segments")
        service = server.service
        rows = service.index.reconstruct(np.arange(service.index.ntotal))
        n_near, cosines, same_hits, total_hits = 0, [], 0, 0
        for (_, body, _), group, k in batched:
            ids, segs, slot_idx, slots = service._prepare_packed_queries(group)
            q_packed = service.encoder.embed_packed_batch(ids, segs, slot_idx, len(slots))
            q_packed = q_packed[: len(group)].cpu().numpy()
            batch = service.encoder.prepare_batch(group, len(group), 512)
            q_plain = service.encoder.embed_batch(batch).cpu().numpy()
            cosines += (np.sum(q_packed * q_plain, 1) / np.linalg.norm(q_packed, axis=1)
                        / np.linalg.norm(q_plain, axis=1)).tolist()
            s_idx, s_sc = _served(body)
            o_scores, o_idx = numpy_search(rows, q_packed, k + 1)
            n_near += _check_against_oracle(np.array(s_idx), np.array(s_sc), o_scores, o_idx)
            plain_idx = numpy_search(rows, q_plain, k)[1]
            for a, b_ in zip(s_idx, plain_idx):
                same_hits += len(set(a) & set(b_.tolist()))
                total_hits += k
        if min(cosines) < 0.999:
            raise AssertionError(f"packed query embeddings: min cosine {min(cosines):.6f} "
                                 "against the unpacked service's (limit 0.999)")
        lat = np.array([r[0][2] for r in singles]) * 1e3
        lat_b = np.array([r[0][2] for r in batched]) * 1e3
        numbers = {
            "startup_s": startup_s, "packed_launches": packed,
            "search_single_p50_ms": float(np.percentile(lat, 50)),
            "search_single_p99_ms": float(np.percentile(lat, 99)),
            "search_batch16_p50_ms": float(np.percentile(lat_b, 50)),
            "min_cosine": min(cosines), "hit_overlap": same_hits / total_hits,
        }
        log(f"served (flat, --pack_queries): the served hits equal numpy_search over the "
            f"index rows with the packed query embeddings ({n_near} hits inside "
            f"{SCORE_ATOL} near-ties not compared); packed query embeddings against the "
            f"unpacked service's: min cosine {numbers['min_cosine']:.6f} (limit 0.999), "
            f"top-k overlap {numbers['hit_overlap']:.4f}; K1 launches with segments "
            f"{packed['flash_fwd']}; /search single p50 "
            f"{numbers['search_single_p50_ms']:.2f} ms p99 "
            f"{numbers['search_single_p99_ms']:.2f} ms (unpacked, phase 4: "
            f"{unpacked['search_single_p50_ms']:.2f} / {unpacked['search_single_p99_ms']:.2f}); "
            f"batch of 16 p50 {numbers['search_batch16_p50_ms']:.2f} ms (unpacked "
            f"{unpacked['search_batch16_p50_ms']:.2f})")
    finally:
        stop_server(server, thread)
    return numbers


def fp32_embed(encoder, batch) -> torch.Tensor:
    """The encoder's embeddings with fp32 activations over its bf16 weights
    (each cast up exactly where it is used) and the plain attention: the
    exact result that the bf16 paths round."""
    model = encoder.model
    dtype = model.compute_dtype
    model.compute_dtype = torch.float32
    try:
        with torch.inference_mode():
            return encoder.embed_batch(batch, attn_impl="plain")
    finally:
        model.compute_dtype = dtype


def hold_to_fp32(kernels, plain, exact, label: str) -> torch.Tensor:
    """Each row's embedding through the kernels (bf16) as close to the fp32
    result as the plain attention's in bf16, within ENCODE_MARGIN of
    1 - cosine. Returns each row's limit."""
    cos = torch.nn.functional.cosine_similarity
    d_kernels, d_plain = 1 - cos(kernels, exact), 1 - cos(plain, exact)
    limit = d_plain + ENCODE_MARGIN
    log(f"encoder ({label}): 1 - cosine with the fp32 result, kernels "
        f"{d_kernels.max().item():.3e} (worst row), plain bf16 {d_plain.max().item():.3e}; "
        f"each row's kernels held within its plain distance + {ENCODE_MARGIN:.0e}; kernels "
        f"vs plain min cosine {cos(kernels, plain).min().item():.6f}")
    if bool((d_kernels > limit).any()):
        raise AssertionError(f"encoder ({label}): the kernels are farther from fp32 than "
                             "the plain attention")
    return limit


def window_bites(encoder, seed: int) -> dict:
    """Passages longer than the served model's window (MISTRAL_LONG_WORDS
    words, one per batch, up to 8192 tokens): through the kernels, held to
    fp32 as the plain attention in bf16 is (``hold_to_fp32``), and farther
    than that limit from the same model's encode without the window (the
    model's config is shared by its layers; it is restored)."""
    config = encoder.model.config
    if encoder.model.layers[0].config is not config:
        raise AssertionError("the layers do not read the model's config")
    window = config.sliding_window
    rng = np.random.default_rng(seed + 7)
    texts = [" ".join(rng.choice(WORDS, size=n)) for n in MISTRAL_LONG_WORDS]
    batches = [encoder.prepare_batch([text], 1, 8192) for text in texts]
    tokens = [int(b["attention_mask"].sum()) for b in batches]
    emb = {}
    try:
        for label, win, impl in (("kernels", window, "auto"), ("plain", window, "plain"),
                                 ("fp32", window, None), ("no window", None, "auto")):
            config.sliding_window = win
            emb[label] = torch.cat([
                fp32_embed(encoder, b) if impl is None else encoder.embed_batch(b, attn_impl=impl)
                for b in batches])
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        config.sliding_window = window
    limit = hold_to_fp32(emb["kernels"], emb["plain"], emb["fp32"],
                         f"{len(texts)} passages of {tokens} tokens, window {window}")
    moved = 1 - torch.nn.functional.cosine_similarity(emb["kernels"], emb["no window"])
    log(f"window bites: 1 - cosine between the kernels' embeddings with and without the "
        f"window {[f'{x:.3e}' for x in moved.tolist()]}, each above its row's limit "
        f"{[f'{x:.3e}' for x in limit.tolist()]}")
    if bool((moved <= limit).any()):
        raise AssertionError("long passages: the window changed the embeddings by no more "
                             "than the rounding limit")
    return {"tokens": tokens, "moved": moved.tolist(), "limit": limit.tolist()}


def start_server(argv, port: int, n_passages: int = N_PASSAGES):
    """The CLI's server (``cli.serve.make_server``) serving in a thread:
    (server, thread, seconds until /healthz answered with ``n_passages``)."""
    from rankpo_tpu_torch.cli import serve as cli

    holder: dict = {}

    def run_server():
        try:
            holder["server"] = cli.make_server(argv)
            holder["server"].serve_forever()
        except BaseException as e:  # reported by the polling loop below
            holder["error"] = e
            raise

    t_start = time.perf_counter()
    thread = threading.Thread(target=run_server, name="serve", daemon=True)
    thread.start()
    while True:
        if "error" in holder:
            raise RuntimeError("server failed to start") from holder["error"]
        if not thread.is_alive():
            raise RuntimeError("server thread ended")
        if "server" in holder:
            _, health, _ = _http(port, "/healthz")
            if health["ntotal"] == n_passages:
                break
        if time.perf_counter() - t_start > 900:
            raise TimeoutError("server did not come up")
        time.sleep(0.5)
    return holder["server"], thread, time.perf_counter() - t_start


def stop_server(server, thread) -> None:
    server.shutdown()
    if server.batcher is not None:
        server.batcher.close()
    server.server_close()
    thread.join(timeout=60)


def _hits(body):
    """(ids, scores) of a reply under --stable_ids: the external ids."""
    return ([[h["id"] for h in r["hits"]] for r in body["results"]],
            [[h["score"] for h in r["hits"]] for r in body["results"]])


def phase_mutation(seed: int, tmp: str, ckpt: str, tier: str) -> dict:
    """Phase 4m, mutation and persistence over HTTP on the tier ``tier``
    (MUTATE_TIERS): the server runs with ``--stable_ids --autosave
    --index_file``; /add of N_MUTATE new passages (each, sent as a query,
    returns its own id at rank 1), /remove of N_MUTATE seeded ids (none
    comes back), one request filtered to a seeded half of the live ids
    (every hit allowed); the path's kernels held against plain at the
    mutated index's probe set; then a restart from the autosaved file, with
    no corpus encode, returning the same hits and scores as before."""
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    corpus, corpus_file, queries = _serving_data(seed, tmp)
    extra, kernel, kind = MUTATE_TIERS[tier]
    rng = np.random.default_rng(seed + 20)
    added = [" ".join(rng.choice(WORDS, size=n)) for n in rng.integers(16, 481, N_MUTATE)]
    index_file = os.path.join(tmp, f"index_{tier}.npz")
    port = _free_port()
    argv = ["--model_name_or_path", ckpt, "--tokenizer_name", "hash:128256",
            "--corpus_data", corpus_file, "--max_query_length", "512",
            "--max_passage_length", "512", "--batch_size", "64", "--device", "cuda",
            "--port", str(port), "--log_level", "warning", "--stable_ids", "--autosave",
            "--index_file", index_file, *extra]
    res = {}
    uncounted = {}

    def launch_counts():
        return {"flash_fwd": flash.launches["flash_fwd"],
                **{name: ivf_gather.launches.get(name, 0) + pq_adc.launches.get(name, 0)
                   for name in ("ivf_probe_scores", "pq_adc_rows", "pq_adc_cols")}}

    # ---- the mutation path: counters from 0, start, add, remove, filter ----
    flash.reset_launches()
    ivf_gather.reset_launches()
    pq_adc.reset_launches()
    server, thread, res["startup_s"] = start_server(argv, port)
    try:
        status, body, res["add_s"] = _http(port, "/add", {"passages": added})
        if (status, body) != (200, {"status": "ok", "ntotal": N_PASSAGES + N_MUTATE,
                                     "saved": index_file}):
            raise AssertionError(f"/add answered {status} {body}")
        new_ids = list(range(N_PASSAGES, N_PASSAGES + N_MUTATE))
        status, body, res["self_s"] = _http(port, "/search", {"queries": added, "k": 10})
        res["self_rank1"] = sum(ids[0] == i for ids, i in zip(_hits(body)[0], new_ids))
        # PQ's ADC scores carry the codec's error (64 bytes for 2048 dims):
        # its own row is held within the served k_max, its rank printed
        allowed_rank = 99 if kind == "pq_rows" else 0
        if kernel is not None:
            # an added row takes a free slot of its nearest cluster, else of
            # its second, else any: the tuned probes reach it only where they
            # probe its cluster (held in-process, its launches not counted),
            # and every cluster's probes always do (held over HTTP)
            before = launch_counts()
            res.update(_check_ivf_append(server.service, added, new_ids, allowed_rank))
            uncounted = {name: n - before[name] for name, n in launch_counts().items()}
            n_clusters = server.service.index.n_clusters
            status, body, _ = _http(port, "/search", {"queries": added, "k": 100,
                                                      "nprobe": n_clusters})
        ranks = [ids.index(i) if i in ids else None for ids, i in zip(_hits(body)[0], new_ids)]
        res["self_ranks"] = {r: ranks.count(r) for r in sorted(set(ranks), key=str)}
        if any(r is None or r > allowed_rank for r in ranks):
            raise AssertionError(f"added passages not found at rank <= {allowed_rank + 1}: "
                                 f"ranks {res['self_ranks']}")
        removed = np.sort(rng.choice(N_PASSAGES + N_MUTATE, N_MUTATE, replace=False))
        status, body, res["remove_s"] = _http(port, "/remove", {"ids": removed.tolist()})
        if (status, body["removed"], body["ntotal"]) != (200, N_MUTATE, N_PASSAGES):
            raise AssertionError(f"/remove answered {status} {body}")
        live = np.setdiff1d(np.arange(N_PASSAGES + N_MUTATE), removed)
        requests = [{"queries": queries[:16], "k": 100}, {"queries": added[:16], "k": 100}]
        allowed = np.sort(rng.choice(live, live.size // 2, replace=False))
        requests.append({"queries": queries[16:32], "k": 100, "allowed_ids": allowed.tolist()})
        before = [_http(port, "/search", r)[1] for r in requests]
        bound = SCORE_BOUNDS[TIER_STORAGE[tier]]
        for r, body in zip(requests, before):
            _check_reply(200, body, len(r["queries"]), 100, kernel is None, bound)
        hit_ids = np.array([i for b in before for ids in _hits(b)[0] for i in ids])
        if np.isin(hit_ids, removed).any():
            raise AssertionError("a removed id came back")
        if not np.isin(np.array([i for ids in _hits(before[2])[0] for i in ids]),
                       allowed).all():
            raise AssertionError("a filtered request returned an id it does not allow")
        launches = {name: n - uncounted.get(name, 0) for name, n in launch_counts().items()}
        # ---- end of the mutation path ----
        if launches["flash_fwd"] <= 0 or (kernel and launches[kernel] <= 0):
            raise AssertionError(f"a kernel of the {tier} mutation path did not launch: "
                                 f"{launches}")
        index = server.service.index
        if kind is not None:
            log(f"mutated served {tier} kernel at its probe set:")
            batch = server.service.encoder.prepare_batch(queries, 64, 512)
            q = server.service.encoder.embed_batch(batch)
            check = _probe_kernels(index, q, kind, timed=False)
            res["kernel_err"] = check["bfloat16" if kind == "bf16" else kind]["max_abs_err"]
    finally:
        t_stop = time.perf_counter()
        stop_server(server, thread)
        res["stop_s"] = time.perf_counter() - t_stop
    del server, index
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the restart: counters from 0, start from the file, requests ----
    flash.reset_launches()
    ivf_gather.reset_launches()
    pq_adc.reset_launches()
    server, thread, res["restart_s"] = start_server(argv, port)
    try:
        after = [_http(port, "/search", r)[1] for r in requests]
        restart = launch_counts()
    finally:
        stop_server(server, thread)
    if [_hits(b) for b in after] != [_hits(b) for b in before]:
        raise AssertionError(f"{tier}: hits or scores after the restart differ")
    encode_launches = 16 * -(-N_PASSAGES // 64)
    if restart["flash_fwd"] >= encode_launches:
        raise AssertionError(f"the restart encoded the corpus ({restart['flash_fwd']} K1 "
                             "launches)")
    res["launches"] = {name: launches[name] + restart[name] for name in launches}
    placed = (f"placed {res['append_first']} in their nearest cluster, "
              f"{res['append_second']} in their second, {res['append_spilled']} spilled (the "
              f"append rule held); at the tuned nprobe {res['tuned_nprobe']} {res['tuned_probed']} "
              f"lie in a probed cluster, each found at rank <= {allowed_rank + 1}, the rest "
              f"not found; " if kernel else "")
    log(f"mutated {tier} ({' '.join(extra) or 'flat fp32'}): start {res['startup_s']:.2f} s; "
        f"/add {N_MUTATE} passages {res['add_s']:.2f} s (autosave included), {placed}each "
        f"found by its own text {'probing every cluster ' if kernel else ''}at ranks "
        f"{res['self_ranks']} ({res['self_rank1']} at rank 1 as served); "
        f"/remove {N_MUTATE} ids {res['remove_s']:.2f} s, none came back; a request "
        f"filtered to {allowed.size} of {live.size} ids, every hit allowed; restart from "
        f"{os.path.basename(index_file)} ({os.path.getsize(index_file) / 2**20:.1f} MiB) "
        f"{res['restart_s']:.2f} s with {restart['flash_fwd']} K1 launches (a corpus encode "
        f"takes {encode_launches}): hits and scores equal to before; launches {launches} "
        f"then {restart}; self queries {res['self_s']:.2f} s, server stop {res['stop_s']:.2f} s")
    return res


def _check_ivf_append(service, texts, new_ids, allowed_rank: int) -> dict:
    """An IVF tier just after /add of ``texts`` (corpus positions
    ``new_ids``). Each added row must sit where the append rule
    (``IVFIPIndex._place_free``, the JAX package's) puts it: in its nearest
    cluster, else in its second with the nearest left with no free slot,
    else anywhere with both left with none. The nearest two come from the
    /add encode run again (the same call on the same card). At the served
    nprobe for k 100, the index's own search over the texts' query
    embeddings must return each added row whose cluster its query probes at
    rank <= ``allowed_rank`` + 1, and none whose cluster it does not probe.
    Returns the counts."""
    from rankpo_tpu_torch.index.ivf import _assign_top2_body

    index, encoder = service.index, service.encoder
    new_ids = np.asarray(new_ids)
    with torch.inference_mode():
        rows, n = encoder.encode_device(list(texts), batch_size=256, max_length=512)
        cand = _assign_top2_body(rows[:n], index.centroids, chunk=n,
                                 bias=index.assign_bias).cpu().numpy()
        q = torch.cat([encoder.embed_batch(encoder.prepare_batch(texts[lo : lo + 64],
                                                                 len(texts[lo : lo + 64]), 512))
                       for lo in range(0, len(texts), 64)]).float()
        p, _ = index._effective_probe(100, None)
        probe, _ = index._probe_clusters(q, p)
        hits = index.search_tensor(q, 100)[1].cpu().numpy()
    cluster = index._cluster_of_row[new_ids]
    free = (index._row_ids_host.reshape(index.n_clusters, index.capacity) < 0).sum(1)
    full0, full1 = free[cand[:, 0]] == 0, free[cand[:, 1]] == 0
    first = cluster == cand[:, 0]
    second = ~first & (cluster == cand[:, 1]) & full0
    spilled = ~first & (cluster != cand[:, 1]) & full0 & full1
    if not (first | second | spilled).all():
        bad = np.nonzero(~(first | second | spilled))[0][:8]
        raise AssertionError(f"added rows {new_ids[bad].tolist()} sit in clusters "
                             f"{cluster[bad].tolist()}, not where the append rule puts them "
                             f"(nearest two {cand[bad].tolist()}, free slots left "
                             f"{free[cand[bad]].tolist()})")
    probed = (probe.cpu().numpy() == cluster[:, None]).any(1)
    ranks = np.array([int(np.argmax(h == i)) if (h == i).any() else -1
                      for h, i in zip(hits, new_ids)])
    if ((ranks[probed] < 0) | (ranks[probed] > allowed_rank)).any():
        raise AssertionError(f"added rows in a probed cluster not found at rank <= "
                             f"{allowed_rank + 1}: ranks {ranks[probed].tolist()}")
    if (ranks[~probed] >= 0).any():
        raise AssertionError("the search returned an added row whose cluster it did not probe")
    return {"append_first": int(first.sum()), "append_second": int(second.sum()),
            "append_spilled": int(spilled.sum()), "tuned_nprobe": p,
            "tuned_probed": int(probed.sum())}


# ---------------------------------------------------------------------------
def _write_lines(path: str, lines) -> None:
    """Write ``lines`` to ``path`` through a temporary file and a rename:
    the ranks of 5d and 5t read files of ``tmp`` while the phases beside
    them write the same seeded files again, and a reader must see the old
    file or the new one whole, never one cut short."""
    part = f"{path}.{os.getpid()}.part"
    with open(part, "w") as f:
        f.writelines(lines)
    os.replace(part, path)


def _text(rng, lo, hi) -> str:
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def write_training_data(tmp: str, seed: int):
    """512 contrastive rows (a query of 4-32 words, 1 positive and 7
    negatives of 16-480 words) and 256 preference pairs, from the seed."""
    rng = np.random.default_rng(seed + 1)
    train = os.path.join(tmp, "train.jsonl")
    _write_lines(train, [json.dumps({
        "query": _text(rng, 4, 33), "positives": [_text(rng, 16, 481)],
        "negatives": [_text(rng, 16, 481) for _ in range(7)]}) + "\n"
        for _ in range(N_TRAIN_ROWS)])
    pairs = os.path.join(tmp, "pairs.jsonl")
    _write_lines(pairs, [json.dumps({
        "query": _text(rng, 4, 33), "passage1": _text(rng, 16, 481),
        "passage2": _text(rng, 16, 481),
        "preferred": "AB"[int(rng.integers(2))]}) + "\n" for _ in range(N_PAIRS)])
    return train, pairs


def _median(history, key):
    values = [h[key] for h in history[1:] if key in h]  # the first step left out
    return float(np.median(values)) if values else None


def run_stage(name: str, main, argv, out_dir: str, state_before: dict,
              deterministic: bool = False, steps: int = 8):
    """One training stage through its CLI, under
    ``torch.use_deterministic_algorithms(deterministic)``; checks and
    numbers."""
    from rankpo_tpu_torch.models.hf_io import load_pretrained
    from rankpo_tpu_torch.ops import flash_attention as flash

    gc.collect()
    torch.cuda.empty_cache()
    # ---- the stage's path: counters from 0, the CLI, counters read ----
    flash.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(deterministic)
    try:
        history = main(argv)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash.launches)
    window_launches = dict(flash.window_launches)
    d256_launches = dict(flash.d256_launches)
    packed_launches = dict(flash.packed_launches)
    # ---- end of the stage's path ----
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in history]
    if len(history) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: expected {steps} finite losses, got {losses}")
    if not all(np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"{name}: non-finite gradient norm")
    _, state = load_pretrained(out_dir)
    still = [n for n in state if torch.equal(state[n], state_before[n].float())]
    if still:
        raise AssertionError(f"{name}: {len(still)} parameter tensors did not move, "
                             f"e.g. {still[:3]}")
    log(f"{name}: {steps} steps, losses {[round(x, 4) for x in losses]}; all "
        f"{len(state)} parameter tensors moved; {out_dir} loads with load_pretrained")
    return {
        "losses": losses, "grad_norms": [h["grad_norm"] for h in history],
        "first_loss": losses[0], "last_loss": losses[-1],
        "step_time_s": _median(history, "step_time"),
        "samples_per_sec": _median(history, "samples_per_sec"),
        "tokens_per_sec": _median(history, "tokens_per_sec"),
        "mfu": _median(history, "mfu"),
        "peak_mem_gib": peak_gib, "wall_s": wall, "launches": launches,
        "window_launches": window_launches, "d256_launches": d256_launches,
        "packed_launches": packed_launches,
    }, state


def rerun_stage1(main, argv, out_dir: str, first: dict) -> None:
    """Stage 1 again from the same checkpoint, seed and settings, for 2 steps
    (no warmup at 8 or 2 steps, so both runs take the same first update):
    its losses and gradient norms must equal the first run's bit for bit,
    as the JAX package promises (docs/DETERMINISM.md): both backwards
    repeat (K2 sums dq in key-tile order, K3a holds it in registers)."""
    gc.collect()
    torch.cuda.empty_cache()
    history = main([*argv, "--output_dir", out_dir, "--max_steps", "2"])
    got = ([h["loss"] for h in history], [h["grad_norm"] for h in history])
    want = (first["losses"][:2], first["grad_norms"][:2])
    log(f"stage 1 rerun, 2 steps from the same seed and state: losses {got[0]}, gradient "
        f"norms {got[1]}; first run {want[0]}, {want[1]}; bit-equal {got == want}")
    if got != want:
        raise AssertionError("stage 1 does not repeat bit for bit from the same seed and state")
    gc.collect()
    torch.cuda.empty_cache()


def _device_batch(collated: dict) -> dict:
    return {field: {"input_ids": torch.from_numpy(block["input_ids"]).long().cuda(),
                    "attention_mask": torch.from_numpy(block["attention_mask"]).cuda()}
            for field, block in collated.items()}


def phase_flash_vs_plain(config, state, train_file: str, seed: int, ckpt: str,
                         n_rows: int = 2, negatives: int = 3, lengths=(128, 512),
                         checkpointing: bool = False):
    """One stage-1 micro-batch (``n_rows`` queries x group ``negatives`` + 1,
    truncated to ``lengths``; by default 2 x 4 at 128 / 512 tokens) at full
    width through the kernels (bf16) and through the plain attention (bf16),
    each held against the plain path in fp32 compute, the reference; with
    ``checkpointing`` the layers are recomputed in the backward pass (the
    plain attention's fp32 logits of long passages do not fit otherwise).

    For a windowed body (e5-mistral, its passages past the window) the
    loss is printed, not held: at temperature 0.02 one query's loss moves by
    1e-2 to 5e-2 between any two roundings of these embeddings, the plain
    bf16 path's and the unwindowed kernels' included (PERF.md;
    ``scripts/window_rounding.py``). So for Gemma, whose plain bf16 path
    alone moves the loss 7.6e-3 from fp32 at 18 random layers (read on
    NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), past the limit.
    Instead each embedding of the micro-batch through the kernels is held to
    fp32 as the plain attention's in bf16 is (``hold_to_fp32``); the
    gradients are held as for the other llama bodies.

    At temperature 0.02 the logits are cosines x 50, so the plain bf16
    path's own rounding (bf16 softmax) moves its loss by about 2e-2 from
    fp32: the kernels' loss (fp32 softmax statistics) is held to the fp32
    loss within LOSS_REL_FP32, and every gradient tensor within cosine 0.99
    of the plain bf16 one. The micro-batch takes no dropout generator, so
    the Roberta body runs it with dropout off, through the kernels.

    The Roberta body also runs it through the kernels' contract on plain
    ops (``ContractAttention``: dS rounded to bf16 before the dQ and dK
    products, as JAX's kernels and every flash backward round it), where
    autograd through the plain attention keeps dS in fp32. Bidirectional
    rows put P ~ 1/512 on every key and the keys share a large common part
    (the token-type row, the residual stream), so the rounded dS's nonzero
    row sum leaves a q/k gradient error the fp32 dS does not. So each
    gradient tensor of the kernels is held to fp32 as the contract on plain
    ops stands to it: a cosine with the fp32 gradient no more than 0.01
    below the contract's (the 0.99 limit's margin)."""
    from rankpo_tpu_torch.data.collators import ContrastiveCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, iter_jsonl
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.models.encoder import embed, encoder_class
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn

    rows = [r for _, r in zip(range(n_rows), iter_jsonl(train_file))]
    tok = resolve_tokenizer(f"hash:{config.vocab_size}", ckpt)
    ds = ContrastiveDataset(rows, tok, *lengths)
    batch = _device_batch(ContrastiveCollator(tok.pad_token_id, negatives, *lengths,
                                              seed=seed)([ds[i] for i in range(n_rows)]))
    model = encoder_class(config).for_training(config, state, device="cuda",
                                               gradient_checkpointing=checkpointing)
    params = list(model.named_parameters())
    results = {}
    runs = [("flash", "flash", torch.bfloat16), ("plain", "plain", torch.bfloat16),
            ("fp32", "plain", torch.float32)]
    if not config.is_llama:
        runs.append(("contract", "contract", torch.bfloat16))
    embeddings_to_fp32 = config.sliding_window is not None or config.is_gemma
    embeddings = {}
    for label, impl, dtype in runs:
        model.compute_dtype = dtype
        with contract_attention(config) if impl == "contract" else contextlib.nullcontext():
            loss, _ = make_contrastive_loss_fn(
                config, temperature=0.02, attn_impl="plain" if impl == "contract" else impl)(
                    model, batch)
            loss.backward()
        results[label] = (loss.item(), [p.grad for _, p in params])
        if embeddings_to_fp32:
            with torch.no_grad():
                embeddings[label] = torch.cat([embed(model, batch[field], attn_impl=impl)
                                               for field in ("query", "passage")])
        for _, p in params:
            p.grad = None
    model.compute_dtype = torch.bfloat16
    (lf, gf), (lp, gp), (l32, g32) = results["flash"], results["plain"], results["fp32"]

    def cosines(a, b):
        return [torch.nn.functional.cosine_similarity(x.flatten(), y.flatten(), dim=0).item()
                for x, y in zip(a, b)]

    cos, cos32, cos_p32 = cosines(gf, gp), cosines(gf, g32), cosines(gp, g32)
    rel, rel_f32, rel_p32 = abs(lf - lp) / abs(lp), abs(lf - l32) / abs(l32), abs(lp - l32) / abs(l32)
    # a key bias adds q.b to every logit of a row, which the softmax cancels:
    # its gradient is 0 in exact arithmetic, so its direction is rounding
    # noise (printed with its size against the query bias's, not held)
    noise = [i for i, (n, _) in enumerate(params) if n.endswith("attention.self.key.bias")]
    held = [i for i in range(len(params)) if i not in noise]
    worst = min(held, key=lambda i: cos[i])
    lowest = sorted(held, key=lambda i: cos[i])[:4]
    shapes = {field: tuple(block["input_ids"].shape) for field, block in batch.items()}
    log(f"flash vs plain ({config.model_type}), one micro-batch at full width {shapes}: loss flash "
        f"{lf:.6f}, plain {lp:.6f}, plain fp32 {l32:.6f}; relative difference flash-plain "
        f"{rel:.3e}, flash-fp32 {rel_f32:.3e}, plain-fp32 {rel_p32:.3e} ("
        + ("printed, not held" if embeddings_to_fp32 else f"limit {LOSS_REL_FP32:.0e}")
        + f"); gradient cosine flash-plain min {cos[worst]:.6f} "
        f"({params[worst][0]}), median {np.median([cos[i] for i in held]):.6f} over "
        f"{len(held)} tensors (limit 0.99), lowest "
        + ", ".join(f"{params[i][0]} {cos[i]:.4f}" for i in lowest)
        + f"; flash-fp32 min {min(cos32[i] for i in held):.6f}, plain-fp32 min "
        f"{min(cos_p32[i] for i in held):.6f}")
    if noise:
        ratio = max(gp[i].norm().item() / gp[i - 2].norm().item() for i in noise)
        log(f"  key biases (gradient 0 in exact arithmetic, not held): {len(noise)} tensors, "
            f"largest |grad| / |query-bias grad| {ratio:.2e}, cosines "
            f"{min(cos[i] for i in noise):.3f}..{max(cos[i] for i in noise):.3f}")
    if config.is_llama and embeddings_to_fp32:
        hold_to_fp32(embeddings["flash"], embeddings["plain"], embeddings["fp32"],
                     f"the micro-batch's {len(embeddings['flash'])} embeddings")  # raises
        loss_ok = True
        grads_ok = cos[worst] >= 0.99
    elif config.is_llama:
        loss_ok = rel_f32 <= LOSS_REL_FP32
        grads_ok = cos[worst] >= 0.99
    else:
        # the Roberta body's own bf16 rounding outside attention (post-LN
        # residuals and LayerNorms in bf16) moves the plain bf16 path from
        # fp32 by more than the limit: the kernels are held to the plain
        # attention at the same rounding elsewhere, and may add no more than
        # the limit to the plain path's distance from fp32; every gradient
        # tensor as close to fp32 as the kernels' contract on plain ops,
        # within 0.01 of cosine
        lc, gc_ = results["contract"]
        cos_c = cosines(gf, gc_)
        cos_c32 = cosines(gc_, g32)
        rel_c = abs(lf - lc) / abs(lc)
        loss_ok = (rel <= LOSS_REL_FP32 and rel_c <= LOSS_REL_FP32
                   and rel_f32 <= rel_p32 + LOSS_REL_FP32)
        worst_c = min(held, key=lambda i: cos32[i] - cos_c32[i])
        grads_ok = cos32[worst_c] >= cos_c32[worst_c] - 0.01
        below = [i for i in held if cos[i] < 0.99]
        log(f"  against the kernels' contract on plain ops (bf16 dS): loss {lc:.6f}, "
            f"relative difference flash-contract {rel_c:.3e} (limit {LOSS_REL_FP32:.0e}); "
            f"cosine with fp32, flash minus contract, min "
            f"{cos32[worst_c] - cos_c32[worst_c]:+.4f} ({params[worst_c][0]}; limit -0.01); "
            f"gradient cosine flash-contract min {min(cos_c[i] for i in held):.6f}, "
            f"contract-fp32 min {min(cos_c32[i] for i in held):.6f}; "
            f"{len(below)} tensors below cosine 0.99 of plain bf16, against fp32 (flash / "
            "contract / plain bf16): " + ", ".join(
                f"{params[i][0]} {cos32[i]:.4f} / {cos_c32[i]:.4f} / {cos_p32[i]:.4f}"
                for i in sorted(below, key=lambda i: cos[i])[:6]))
        del gc_
    if not loss_ok or not grads_ok:
        raise AssertionError("training gradients through the kernels disagree with plain")
    del results, gf, gp, g32
    return model, {"loss_rel_flash_plain": rel, "loss_rel_flash_fp32": rel_f32,
                   "loss_rel_plain_fp32": rel_p32, "min_grad_cosine": cos[worst],
                   "min_grad_cosine_fp32": min(cos32)}


class ContractAttention(torch.autograd.Function):
    """The flash kernels' contract on plain PyTorch ops: the forward of
    ``flash_attention_fwd_reference`` (bf16 P) and the backward of
    ``flash_attention_bwd_reference`` (dS rounded to bf16), so a model
    can run with the kernels' rounding but none of their code."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        from rankpo_tpu_torch.ops.flash_attention import flash_attention_fwd_reference

        out, lse = flash_attention_fwd_reference(q, k, v, mask, causal=causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

        q, k, v, mask, out, lse = ctx.saved_tensors
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        grads = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta,
                                              causal=ctx.causal)
        return (*(g.to(q.dtype) for g in grads), None, None)


@contextlib.contextmanager
def contract_attention(config):
    """Within the block, the config's body calls ``ContractAttention`` for
    attention without dropout."""
    from rankpo_tpu_torch.models import llama, roberta

    body = llama if config.is_llama else roberta
    original = body.multi_head_attention

    def attention(q, k, v, *, mask=None, causal=False, dropout_rate=0.0, generator=None,
                  **_):
        if dropout_rate > 0.0 and generator is not None:
            return original(q, k, v, mask=mask, causal=causal, impl="plain",
                            dropout_rate=dropout_rate, generator=generator)
        return ContractAttention.apply(q, k, v, mask, causal)

    body.multi_head_attention = attention
    try:
        yield
    finally:
        body.multi_head_attention = original


_CATEGORIES = (  # (label, test on the lower-cased kernel name), first match wins
    ("matrix products (cuBLAS)", lambda n: any(s in n for s in ("gemm", "nvjet", "cutlass",
                                                                "xmma"))),
    ("flash forward K1", lambda n: "flash_fwd_kernel" in n),
    ("flash backward K2/K3", lambda n: "flash_bwd" in n),
    ("AdamW", lambda n: "adam" in n or "multi_tensor" in n),
    ("other (elementwise, reductions, copies)", lambda n: True),
)


def phase_profile(model, config, train_file: str, seed: int) -> dict:
    """One stage-1 optimizer step (batch 8, accumulation 2, checkpointing)
    traced with torch.profiler: device time by kernel category, idle share."""
    from torch.profiler import ProfilerActivity, profile

    from rankpo_tpu_torch.data.collators import ContrastiveCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, iter_jsonl
    from rankpo_tpu_torch.data.loader import DataLoader
    from rankpo_tpu_torch.data.tokenization import HashTokenizer
    from rankpo_tpu_torch.train.config import TrainConfig
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn
    from rankpo_tpu_torch.train.trainer import Trainer

    rows = [r for _, r in zip(range(32), iter_jsonl(train_file))]
    ds = ContrastiveDataset(rows, HashTokenizer(vocab_size=128256), 128, 512)
    loader = DataLoader(ds, ContrastiveCollator(0, 3, 128, 512, seed=seed), 8, seed=seed)
    groups = loader.epoch(0, stack=2)
    model.gradient_checkpointing = True
    cfg = TrainConfig(learning_rate=1e-5, per_device_train_batch_size=8,
                      gradient_accumulation_steps=2, gradient_checkpointing=True,
                      save_strategy="no", save_on_preemption=False, device="cuda")
    trainer = Trainer(loss_fn=make_contrastive_loss_fn(config, temperature=0.02),
                      model=model, config=cfg, total_steps=8)
    trainer.train_step(next(groups))  # warm: allocates the optimizer state
    group = next(groups)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(group)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: _device_us(e) / 1e3 for e in prof.key_averages() if _device_us(e) > 0}
    busy = sum(kernels.values())
    by_cat = {label: 0.0 for label, _ in _CATEGORIES}
    for name, ms in kernels.items():
        label = next(lab for lab, test in _CATEGORIES if test(name.lower()))
        by_cat[label] += ms
    log(f"profile of one stage-1 step (batch 8 x accumulation 2, checkpointing): wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}")
    for label, ms in by_cat.items():
        log(f"  {label}: {ms:.1f} ms ({ms / busy:.1%} of device time)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  top kernel {ms:8.2f} ms  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "by_category_ms": by_cat}


def phase_training(ckpt: str, tmp: str, seed: int, base_state: dict) -> dict:
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.models.config import EncoderConfig

    train, pairs = write_training_data(tmp, seed)
    s1, s2 = os.path.join(tmp, "stage1"), os.path.join(tmp, "stage2")
    log("training lengths cut from the reference's 1280 / 4096 (BASELINE.md, "
        "run_contrastive.sh) to max_query_length 128 / max_passage_length 512 "
        "for the smoke's time limit")
    common = ["--tokenizer_name", "hash:128256", "--bf16", "True", "--max_steps", "8",
              "--per_device_train_batch_size", "8", "--learning_rate", "1e-5",
              "--max_query_length", "128", "--max_passage_length", "512",
              "--save_strategy", "no", "--seed", str(seed), "--device", "cuda",
              "--log_level", "warning"]
    stage1_argv = [
        "--model_name_or_path", ckpt, "--train_data", train,
        "--num_negatives", "3", "--gradient_accumulation_steps", "2",
        "--temperature", "0.02", "--lr_scheduler_type", "cosine",
        "--warmup_ratio", "0.1", "--gradient_checkpointing", "True", *common]
    stage1, s1_state = run_stage("stage 1 (contrastive, split backward)", run_contrastive.main,
                                 [*stage1_argv, "--output_dir", s1], s1, base_state)
    # phase 5d's W = 1 runs are held to this file bit for bit
    stage1["model_crc"] = _file_crc(os.path.join(s1, "model.safetensors"))
    rerun_stage1(run_contrastive.main, stage1_argv, os.path.join(tmp, "stage1_rerun"), stage1)
    stage2, _ = run_stage("stage 2 (RankPO, deterministic: split backward)", run_rankpo.main, [
        "--model_name_or_path", s1, "--train_data", pairs, "--output_dir", s2,
        "--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
        "--reference_free", "True", *common], s2, s1_state, deterministic=True)
    del s1_state
    config = EncoderConfig.from_pretrained(ckpt)
    layers = config.num_hidden_layers
    # layers x 2 fields (query, passage) x micro-steps; stage 1 also runs
    # each forward again in the checkpointed backward
    need = {"stage1": {"flash_fwd": 2 * layers * 2 * 16, "flash_dq": layers * 2 * 16,
                       "flash_dkv": layers * 2 * 16},
            "stage2": {"flash_fwd": layers * 2 * 8, "flash_dq": layers * 2 * 8,
                       "flash_dkv": layers * 2 * 8}}
    for stage, nums in (("stage1", stage1), ("stage2", stage2)):
        for kernel, least in need[stage].items():
            if nums["launches"][kernel] < least:
                raise AssertionError(f"{stage}: {kernel} launched "
                                     f"{nums['launches'][kernel]} times, expected >= {least}")
        log(f"{stage} kernel launches: {nums['launches']}")
    model, compare = phase_flash_vs_plain(config, base_state, train, seed, ckpt)
    profile_nums = phase_profile(model, config, train, seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage1": stage1, "stage2": stage2, "compare": compare,
            "profile": profile_nums}


def _stage_groups(tmp: str, seed: int, stage: str, packed: bool, steps: int):
    """The first ``steps`` accumulation groups of a Llama stage at phase 5's
    settings, from the loader and collator its CLI builds (the same seed:
    the same batches)."""
    from rankpo_tpu_torch.data.collators import ContrastiveCollator, RankPOCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, PairPreferenceDataset
    from rankpo_tpu_torch.data.loader import DataLoader
    from rankpo_tpu_torch.data.packing import PackedContrastiveCollator, PackedRankPOCollator
    from rankpo_tpu_torch.data.tokenization import HashTokenizer

    train, pairs = write_training_data(tmp, seed)
    tok = HashTokenizer(vocab_size=128256)
    lengths = dict(max_query_length=128, max_passage_length=512)
    seg = dict(query_max_segments=PACK_MAX_SEGMENTS, passage_max_segments=PACK_MAX_SEGMENTS)
    if stage == "stage1":
        dataset = ContrastiveDataset(train, tok, 128, 512)
        collator = (PackedContrastiveCollator(0, 3, **lengths, **seg, seed=seed) if packed
                    else ContrastiveCollator(0, 3, **lengths, seed=seed))
        accum = 2
    else:
        dataset = PairPreferenceDataset(pairs, tok, 128, 512)
        collator = (PackedRankPOCollator(0, **lengths, **seg) if packed
                    else RankPOCollator(0, **lengths))
        accum = 1
    loader = DataLoader(dataset, collator, 8, seed=seed)
    return [group for _, group in zip(range(steps), loader.epoch(0, stack=accum))]


def _real_tokens(tmp: str, seed: int, stage: str, packed: bool, steps: int) -> tuple:
    """(real tokens, token slots) over the first ``steps`` optimizer steps of
    a Llama stage at phase 5's settings: the tokens of the texts against
    the positions the batches hold."""
    real = slots = 0
    for group in _stage_groups(tmp, seed, stage, packed, steps):
        for block in group.values():
            filled = block["segment_ids"] if packed else block["attention_mask"]
            real += int((filled != 0).sum())
            slots += filled.size
    return real, slots


def first_loss_fp32(tmp: str, seed: int, stage: str, start: str) -> float:
    """The first optimizer step's loss of a Llama stage at phase 5's settings
    computed exactly: fp32 activations over the weights at ``start`` (the
    stage's starting checkpoint), the plain attention, the same unpacked
    micro-batches, the mean over the accumulation group as the trainer
    takes it."""
    from rankpo_tpu_torch.models.encoder import encoder_class
    from rankpo_tpu_torch.models.hf_io import load_pretrained
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn

    config, state = load_pretrained(start)
    model = encoder_class(config).from_state_dict(config, state, device="cuda",
                                                  dtype=torch.float32)
    del state
    if stage == "stage1":
        loss_fn = make_contrastive_loss_fn(config, temperature=0.02, attn_impl="plain")
    else:
        loss_fn = make_rankpo_loss_fn(config, beta=2.0, temperature=0.1, loss_type="sigmoid",
                                      reference_free=True, attn_impl="plain")
    group = _stage_groups(tmp, seed, stage, False, 1)[0]
    accum = group["query"]["input_ids"].shape[0]
    with torch.no_grad():
        losses = [loss_fn(model, _device_batch({f: {k: v[i] for k, v in block.items()}
                                                for f, block in group.items()}))[0].item()
                  for i in range(accum)]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return float(np.mean(losses))


def phase_training_packed(ckpt: str, tmp: str, seed: int, base_state: dict,
                          unpacked: dict) -> dict:
    """Phase 5p, packed training at Llama-3.2-1B's full width and depth:
    stage 1 with ``--pack_sequences True`` from the base checkpoint and stage
    2 with it from phase 5's stage-1 output (so each starts where its
    unpacked run started), PACKED_STEPS steps each at phase 5's shapes. The
    first step's loss is held to the unpacked run's on the same sampled
    examples (LOSS_REL_FP32), packed stage 1 rerun for 2 steps repeats bit
    for bit, K1/K2 (stage 1) and K1/K3a/K3b (stage 2) launch with segments;
    step time, real tokens/s, the pad share packed and unpacked and peak
    memory are printed. The first step's loss of each stage is also
    computed in fp32 (``first_loss_fp32``): two bf16 paths may differ by
    more than the limit, so the packed loss is held to the exact loss no
    farther than the unpacked run's distance to it plus LOSS_REL_FP32."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.models.hf_io import load_pretrained

    train, pairs = write_training_data(tmp, seed)
    s1 = os.path.join(tmp, "stage1_packed")
    common = ["--tokenizer_name", "hash:128256", "--bf16", "True",
              "--max_steps", str(PACKED_STEPS), "--per_device_train_batch_size", "8",
              "--learning_rate", "1e-5", "--max_query_length", "128",
              "--max_passage_length", "512", "--save_strategy", "no", "--seed", str(seed),
              "--device", "cuda", "--log_level", "warning", "--pack_sequences", "True",
              "--pack_max_segments", str(PACK_MAX_SEGMENTS)]
    # stage 1 asks for K2 (the fused backward), so its packed build stays on
    # a main path now that "auto" is split
    stage1_argv = [
        "--model_name_or_path", ckpt, "--train_data", train, "--num_negatives", "3",
        "--gradient_accumulation_steps", "2", "--temperature", "0.02",
        "--lr_scheduler_type", "cosine", "--warmup_ratio", "0.1",
        "--gradient_checkpointing", "True", "--flash_bwd_impl", "fused", *common]
    stage1, _ = run_stage("stage 1 packed (contrastive, fused backward)", run_contrastive.main,
                          [*stage1_argv, "--output_dir", s1], s1, base_state,
                          steps=PACKED_STEPS)
    rerun_stage1(run_contrastive.main, stage1_argv, os.path.join(tmp, "stage1_packed_rerun"),
                 stage1)
    shutil.rmtree(s1)
    shutil.rmtree(os.path.join(tmp, "stage1_packed_rerun"))
    s1_unpacked = os.path.join(tmp, "stage1")
    exact = {"stage1": first_loss_fp32(tmp, seed, "stage1", ckpt),
             "stage2": first_loss_fp32(tmp, seed, "stage2", s1_unpacked)}
    _, s1_state = load_pretrained(s1_unpacked)
    s2 = os.path.join(tmp, "stage2_packed")
    stage2, _ = run_stage("stage 2 packed (RankPO, deterministic: split backward)",
                          run_rankpo.main, [
                              "--model_name_or_path", s1_unpacked, "--train_data", pairs,
                              "--output_dir", s2, "--beta", "2.0", "--temperature", "0.1",
                              "--loss_type", "sigmoid", "--reference_free", "True", *common],
                          s2, s1_state, deterministic=True, steps=PACKED_STEPS)
    del s1_state
    shutil.rmtree(s2)
    need = {"stage1": ("flash_fwd", "flash_bwd_fused"),
            "stage2": ("flash_fwd", "flash_dq", "flash_dkv")}
    out = {}
    for stage, nums in (("stage1", stage1), ("stage2", stage2)):
        packed = nums["packed_launches"]
        if any(packed[name] <= 0 for name in need[stage]):
            raise AssertionError(f"packed {stage}: launches with segments {packed}")
        first, want, fp32 = nums["first_loss"], unpacked[stage]["first_loss"], exact[stage]
        rel = abs(first - want) / abs(want)
        rel_fp32, u_rel_fp32 = abs(first - fp32) / abs(fp32), abs(want - fp32) / abs(fp32)
        real, slots = _real_tokens(tmp, seed, stage, True, PACKED_STEPS)
        u_real, u_slots = _real_tokens(tmp, seed, stage, False, PACKED_STEPS)
        if real != u_real:
            raise AssertionError(f"{stage}: packed batches hold {real} tokens, unpacked {u_real}")
        per_step = real / PACKED_STEPS
        nums.update(first_loss_rel=rel, first_loss_rel_fp32=rel_fp32,
                    unpacked_first_loss_rel_fp32=u_rel_fp32, real_tokens_per_step=per_step,
                    real_tokens_per_s=per_step / nums["step_time_s"],
                    unpacked_real_tokens_per_s=per_step / unpacked[stage]["step_time_s"],
                    pad_share=1 - real / slots, unpacked_pad_share=1 - u_real / u_slots)
        log(f"{stage} packed: first loss {first:.6f} against the unpacked run's {want:.6f} "
            f"on the same examples, relative {rel:.3e}; the exact (fp32, plain attention) "
            f"loss {fp32:.6f}: packed {rel_fp32:.3e} from it, unpacked {u_rel_fp32:.3e} "
            f"(limit: the unpacked distance + {LOSS_REL_FP32:.0e}); median "
            f"step {nums['step_time_s']:.4f} s (unpacked {unpacked[stage]['step_time_s']:.4f}); "
            f"real tokens/s {nums['real_tokens_per_s']:.1f} (unpacked "
            f"{nums['unpacked_real_tokens_per_s']:.1f}; {per_step:.0f} real tokens a step); "
            f"pad share {nums['pad_share']:.4f} (unpacked {nums['unpacked_pad_share']:.4f}); "
            f"peak device memory {nums['peak_mem_gib']:.2f} GiB (unpacked "
            f"{unpacked[stage]['peak_mem_gib']:.2f}); launches {nums['launches']}, with "
            f"segments {packed}")
        if not rel_fp32 <= u_rel_fp32 + LOSS_REL_FP32:
            raise AssertionError(f"{stage} packed: first loss {first}, unpacked {want}, "
                                 f"exact {fp32}")
        out[stage] = nums
    return out


FEATURE_STEPS = 4  # steps of each 5f run
FEATURE_SHORT_STEPS = 3  # the profiled and debug_nans runs
GRADCACHE_STEPS = 2  # the gradient-cache run and plain accumulation beside it
# 5f, 5l, 4m, the serving tiers but flat, phase 8's pipeline, 5d(b) and 5t's
# pairs: the body cut to 2 of 16 layers (from 4, to pay for 5t)
FEATURE_LAYERS = 2
N_EVAL_PAIRS = 32  # 5f's held-out pairs


def _feature_argv(ckpt: str, data: str, out: str, seed: int, stage: str, steps: int,
                  *extra) -> list:
    """Phase 5's settings for ``stage`` (batch 8, 128 / 512 tokens; stage 1
    with group 4, accumulation 2 and checkpointing), ``steps`` steps."""
    argv = ["--model_name_or_path", ckpt, "--train_data", data, "--output_dir", out,
            "--tokenizer_name", "hash:128256", "--bf16", "True", "--max_steps", str(steps),
            "--per_device_train_batch_size", "8", "--learning_rate", "1e-5",
            "--max_query_length", "128", "--max_passage_length", "512",
            "--save_strategy", "no", "--seed", str(seed), "--device", "cuda",
            "--log_level", "warning"]
    if stage == "stage1":
        argv += ["--num_negatives", "3", "--gradient_accumulation_steps", "2",
                 "--temperature", "0.02", "--lr_scheduler_type", "cosine",
                 "--warmup_ratio", "0.1", "--gradient_checkpointing", "True"]
    else:
        argv += ["--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
                 "--reference_free", "True"]
    return [*argv, *extra]


def run_feature(name: str, main, argv, deterministic: bool = False, keep: bool = False) -> dict:
    """One 5f run through its CLI: the launch counters from 0 just before,
    read just after; losses, gradient norms, median step time (steps 2 on),
    peak device memory and wall seconds. The output directory (a 5 GB fp32
    model) is removed unless ``keep``."""
    from rankpo_tpu_torch.ops import flash_attention as flash

    gc.collect()
    torch.cuda.empty_cache()
    flash.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(deterministic)
    try:
        history = main(argv)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    steps = [h for h in history if "loss" in h]
    losses = [h["loss"] for h in steps]
    if not steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    if not keep:
        shutil.rmtree(argv[argv.index("--output_dir") + 1])
    return {"history": history, "losses": losses, "grad_norms": [h["grad_norm"] for h in steps],
            "step_time_s": _median(steps, "step_time"), "peak_mem_gib": peak_gib,
            "wall_s": wall, "launches": launches}


def _feature_line(label: str, n: dict) -> str:
    return (f"{label}: losses {[round(x, 6) for x in n['losses']]}, median step "
            f"{n['step_time_s']:.4f} s, peak device memory {n['peak_mem_gib']:.2f} GiB, wall "
            f"{n['wall_s']:.1f} s, K1 {n['launches']['flash_fwd']}, K2 "
            f"{n['launches']['flash_bwd_fused']}, K3a {n['launches']['flash_dq']}, K3b "
            f"{n['launches']['flash_dkv']}")


class _SaveClock:
    """Wall seconds of ``Trainer.save_checkpoint``, ``Trainer.resume_from``
    and the waits for the background writer while the context is open
    (5f's resume runs)."""

    def __enter__(self):
        from rankpo_tpu_torch.train import trainer

        self.save_s = self.wait_s = self.resume_s = 0.0
        cls = trainer.Trainer
        self._saved = (cls.save_checkpoint, cls.resume_from, trainer.ckpt.wait_for_saves)
        save, resume, wait = self._saved

        def clocked(fn, field):
            def run(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    setattr(self, field, getattr(self, field) + time.perf_counter() - t)
            return run

        cls.save_checkpoint = clocked(save, "save_s")
        cls.resume_from = clocked(resume, "resume_s")
        trainer.ckpt.wait_for_saves = clocked(wait, "wait_s")
        return self

    def __exit__(self, *exc):
        from rankpo_tpu_torch.train import trainer

        cls = trainer.Trainer
        cls.save_checkpoint, cls.resume_from, trainer.ckpt.wait_for_saves = self._saved
        return False


def _file_crc(path: str) -> tuple:
    """(size, CRC-32) of a file: the equality check of two model files one
    of which is already removed."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            crc = zlib.crc32(chunk, crc)
    return os.path.getsize(path), crc


def _resume_pair(tmp: str, ckpt: str, pairs: str, seed: int, optim: str,
                 asynchronous: bool) -> dict:
    """Stage 2 under deterministic algorithms, constant LR (so a 2-step
    run's schedule is a 4-step run's), ``--optim optim``: 4 straight steps;
    then 2 steps that end in a checkpoint with the optimizer state
    (``--save_only_model False``, synchronous or ``--async_checkpointing``),
    then ``--resume_from_checkpoint latest`` for 2 more. The losses and the
    final model.safetensors must be the straight run's bit for bit (size and
    CRC-32). Each model file is checked and removed as soon as it is
    written, so the disk holds one checkpoint and one model at a time (the
    run's disk writes stay small)."""
    from rankpo_tpu_torch.cli import run_rankpo

    label = f"{optim}, {'async' if asynchronous else 'sync'}"
    common = ["--lr_scheduler_type", "constant", "--optim", optim]
    straight_dir = os.path.join(tmp, "stage2_straight")
    straight = run_feature(f"5f stage 2 straight ({label})", run_rankpo.main,
                           _feature_argv(ckpt, pairs, straight_dir, seed, "stage2",
                                         FEATURE_STEPS, *common),
                           deterministic=True, keep=True)
    want = _file_crc(os.path.join(straight_dir, "model.safetensors"))
    shutil.rmtree(straight_dir)
    out = os.path.join(tmp, "stage2_resume")
    saves = [*common, "--save_strategy", "steps", "--save_steps", "1000",
             "--save_only_model", "False", "--async_checkpointing", str(asynchronous)]
    torch.use_deterministic_algorithms(True)
    try:
        with _SaveClock() as first_clock:
            first = run_rankpo.main(_feature_argv(ckpt, pairs, out, seed, "stage2", 2, *saves))
        os.remove(os.path.join(out, "model.safetensors"))  # the 2-step model: not read
        directory = os.path.join(out, "checkpoint-2")
        model_gb = os.path.getsize(os.path.join(directory, "model.safetensors")) / 1e9
        opt_gb = os.path.getsize(os.path.join(directory, "opt_state.pt")) / 1e9
        with _SaveClock() as clock:
            resumed = run_rankpo.main(_feature_argv(
                ckpt, pairs, out, seed, "stage2", FEATURE_STEPS, *saves,
                "--resume_from_checkpoint", "latest"))
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [h["loss"] for h in first] + [h["loss"] for h in resumed]
    same_model = _file_crc(os.path.join(out, "model.safetensors")) == want
    shutil.rmtree(out)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"5f resume ({label}): checkpoint-2 (model {model_gb:.3f} GB, optimizer state "
        f"{opt_gb:.3f} GB) saved in {first_clock.save_s:.2f} s, waits for the writer "
        f"{first_clock.wait_s:.2f} s; restored in {clock.resume_s:.2f} s; 2 + 2 steps: losses "
        f"{[round(x, 6) for x in losses]} against 4 straight steps' "
        f"{[round(x, 6) for x in straight['losses']]}: bit-equal "
        f"{losses == straight['losses']}; final model.safetensors bit-equal {same_model}")
    if losses != straight["losses"] or not same_model:
        raise AssertionError(f"5f resume ({label}) is not the straight run bit for bit")
    return {"straight": straight, "save_s": first_clock.save_s,
            "wait_s": first_clock.wait_s, "resume_s": clock.resume_s, "model_gb": model_gb,
            "opt_gb": opt_gb}


def _sigterm_start(ckpt: str, tmp: str, seed: int, pairs: str) -> dict:
    """Start :func:`_sigterm_finish`'s subprocess: ``python -m
    rankpo_tpu_torch.cli.run_rankpo`` on the card from ``ckpt`` (5f's,
    FEATURE_LAYERS layers at full width: what this tests is host logic),
    watched by a thread that sends SIGTERM after its first logged step and
    waits for it to exit, while this process goes on."""
    out = os.path.join(tmp, "stage2_sigterm")
    argv = _feature_argv(ckpt, pairs, out, seed, "stage2", 100000, "--log_level", "info",
                         "--num_train_epochs", "1000", "--save_strategy", "steps",
                         "--save_steps", "1000000", "--save_only_model", "False")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = {"out": out, "argv": argv, "t0": time.perf_counter(), "lines": [],
           "signalled": None, "rest": ""}
    proc = run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "rankpo_tpu_torch.cli.run_rankpo", *argv], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def watch():
        try:
            deadline = time.time() + 300
            while time.time() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                run["lines"].append(line)
                if "'global_step': 1," in line:  # the first logged step
                    run["signalled"] = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
                    break
            run["rest"], _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    run["thread"] = threading.Thread(target=watch, name="sigterm-watch", daemon=True)
    run["thread"].start()
    return run


def _sigterm_finish(run: dict) -> dict:
    """The subprocess of :func:`_sigterm_start`, SIGTERM after its first
    logged step: exit 0, "preempted: checkpoint", a checkpoint with
    opt_state.pt; then the run resumed in this process to 2 steps past it."""
    from rankpo_tpu_torch.cli import run_rankpo
    from rankpo_tpu_torch.train.checkpoint import latest_checkpoint

    run["thread"].join(700)
    proc, out, argv, t0, signalled = (run[k] for k in ("proc", "out", "argv", "t0",
                                                        "signalled"))
    output = "".join(run["lines"]) + (run["rest"] or "")
    found = latest_checkpoint(out)
    step = None
    if found is not None and os.path.isfile(os.path.join(found, "opt_state.pt")):
        with open(os.path.join(found, "trainer_state.json")) as f:
            step = json.load(f)["global_step"]
    if not (signalled is not None and proc.returncode == 0
            and "preempted: checkpoint" in output and step is not None and step >= 1):
        raise AssertionError(f"5f SIGTERM: exit {proc.returncode}, checkpoint {found}, "
                             f"output tail:\n{output[-3000:]}")
    after = time.perf_counter() - signalled
    resumed = run_rankpo.main([*argv, "--max_steps", str(step + 2), "--save_strategy", "no",
                               "--resume_from_checkpoint", "latest", "--log_level", "warning"])
    steps = [h["global_step"] for h in resumed]
    log(f"5f SIGTERM ({FEATURE_LAYERS} of 16 layers, full width): the subprocess exited 0 "
        f"{after:.1f} s after the signal with checkpoint-{step} (opt_state.pt) and "
        f"'preempted: checkpoint' in its log ({time.perf_counter() - t0:.1f} s in all); "
        f"resumed to steps {steps}")
    if steps != [step + 1, step + 2]:
        raise AssertionError(f"5f SIGTERM: the resumed run logged steps {steps}")
    shutil.rmtree(out)
    gc.collect()
    torch.cuda.empty_cache()
    return {"exit_after_s": after, "checkpoint_step": step}


def _no_grad_losses(start: str, batches, loss_for, runs) -> dict:
    """The no-grad loss over ``batches`` (a mean weighted by rows, as
    ``Trainer.evaluate`` combines them) from the weights at ``start``, for
    each (label, attn_impl, compute dtype) of ``runs``."""
    from rankpo_tpu_torch.models.encoder import encoder_class
    from rankpo_tpu_torch.models.hf_io import load_pretrained

    config, state = load_pretrained(start)
    out = {}
    for label, impl, dtype in runs:
        model = encoder_class(config).from_state_dict(config, state, device="cuda", dtype=dtype)
        loss_fn = loss_for(config, impl)
        total = rows = 0
        with torch.no_grad():
            for b in batches:
                n = b["query"]["input_ids"].shape[0]
                total += loss_fn(model, _device_batch(b))[0].item() * n
                rows += n
        out[label] = total / rows
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rankpo_loss_for(config, impl):
    from rankpo_tpu_torch.train.steps import make_rankpo_loss_fn

    return make_rankpo_loss_fn(config, beta=2.0, temperature=0.1, loss_type="sigmoid",
                               reference_free=True, attn_impl=impl)


def _contrastive_loss_for(config, impl):
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn

    return make_contrastive_loss_fn(config, temperature=0.02, attn_impl=impl)


def phase_training_features(ckpt: str, tmp: str, seed: int) -> dict:
    """Phase 5f, the single-card training features at Llama-3.2-1B's full
    width, the body of ``ckpt`` cut to FEATURE_LAYERS of 16 layers (what
    these runs test is host logic and the kernels' composition; the cut
    pays for phase 5d), phase 5's settings (``_feature_argv``), each run
    through its CLI with the launch counters from 0:

    1. stage 1 under gradient checkpointing "full", "dots" and "attn":
       losses and gradient norms bit-equal to "full"'s; K1 launches 2 x
       layers x 2 fields x micro-batches ("attn": half), K3a and K3b layers
       x 2 x micro-batches under each;
    2. stage 1 with ``--optim adamw8bit`` and ``adafactor``: the first loss
       bit-equal to AdamW's (no update has happened yet);
    3. stage 2 under deterministic algorithms with ``--save_only_model
       False``: 2 steps, then ``--resume_from_checkpoint
       latest`` for 2 more, losses and model.safetensors bit-equal to 4
       straight steps; with AdamW and a synchronous save, then with the
       8-bit AdamW and ``--async_checkpointing True``;
    4. SIGTERM to ``python -m rankpo_tpu_torch.cli.run_rankpo`` (2 of 16
       layers) after its first step: exit 0 with a checkpoint, then resumed
       (the subprocess runs beside steps 5-7; the resume after them);
    5. stage 2 with ``--eval_data`` and ``--eval_strategy steps
       --eval_steps 2``: ``eval_loss`` in the history; the last one held
       bit-equal to the no-grad loss over the same batches computed outside
       the trainer from the saved weights through the kernels, and printed
       beside the plain attention's in bf16 and in fp32 (stage 2's bf16
       margins put any two bf16 paths ~3e-3 apart and 1e-2 to 2e-2 from
       fp32, past LOSS_REL_FP32);
    6. stage 1 at batch 8 x accumulation 4 with ``--grad_cache True``: the
       first loss within LOSS_REL_FP32 of one no-grad InfoNCE over all 32
       rows in fp32; pass 1 adds one K1 per layer, field and micro-batch;
       step time and memory beside plain accumulation at the same batch;
    7. ``--profile_steps 2`` writes a trace naming the K1 kernel;
       ``--debug_nans True`` trains, its step time beside the plain run's.
    """
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.data.collators import ContrastiveCollator, RankPOCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, PairPreferenceDataset
    from rankpo_tpu_torch.data.loader import DataLoader
    from rankpo_tpu_torch.data.tokenization import HashTokenizer
    from rankpo_tpu_torch.models.config import EncoderConfig

    train, pairs = write_training_data(tmp, seed)
    layers = EncoderConfig.from_pretrained(ckpt).num_hidden_layers
    out = {}

    def s1(label, steps, *extra, keep=False):
        path = os.path.join(tmp, f"stage1_{label}")
        return run_feature(f"5f stage 1 {label}", run_contrastive.main,
                           _feature_argv(ckpt, train, path, seed, "stage1", steps, *extra),
                           keep=keep)

    def timed_step(label):
        t = time.perf_counter()
        return lambda: log(f"5f step {label}: {time.perf_counter() - t:.1f} s")

    # ---- 1. checkpointing policies ----
    done = timed_step("1 remat")
    micro = FEATURE_STEPS * 2
    for policy in ("full", "dots", "attn"):
        n = out[policy] = s1(policy, FEATURE_STEPS, "--gradient_checkpointing_policy", policy)
        log(_feature_line(f"5f stage 1 remat {policy!r}", n))
        k1 = (1 if policy == "attn" else 2) * layers * 2 * micro
        got = tuple(n["launches"][name] for name in KERNELS)
        if got != (k1, 0, layers * 2 * micro, layers * 2 * micro):
            raise AssertionError(f"remat {policy}: K1, K2, K3a, K3b launched {got}, expected "
                                 f"{(k1, 0, layers * 2 * micro, layers * 2 * micro)}")
        same = (n["losses"], n["grad_norms"]) == (out["full"]["losses"], out["full"]["grad_norms"])
        log(f"5f remat {policy!r}: losses and gradient norms bit-equal to 'full': {same}")
        if not same:
            raise AssertionError(f"remat {policy}: not bit-equal to 'full'")
    done()
    # ---- 2. optimizers ----
    done = timed_step("2 optimizers")
    adamw = out["full"]
    for optim in ("adamw8bit", "adafactor"):
        n = out[optim] = s1(optim, FEATURE_STEPS, "--optim", optim)
        log(_feature_line(f"5f stage 1 --optim {optim}", n)
            + f"; AdamW: losses {[round(x, 6) for x in adamw['losses']]}, median step "
            f"{adamw['step_time_s']:.4f} s, peak {adamw['peak_mem_gib']:.2f} GiB")
        if n["losses"][0] != adamw["losses"][0]:
            raise AssertionError(f"{optim}: first loss {n['losses'][0]} is not AdamW's "
                                 f"{adamw['losses'][0]}")
    done()
    # ---- 3. resume: AdamW with a synchronous save, the 8-bit AdamW async ----
    done = timed_step("3 resume")
    out["resume"] = {"sync": _resume_pair(tmp, ckpt, pairs, seed, "adamw", False),
                     "async": _resume_pair(tmp, ckpt, pairs, seed, "adamw8bit", True)}
    out["straight"] = out["resume"]["sync"]["straight"]
    out["straight8"] = out["resume"]["async"]["straight"]
    done()
    # ---- 4. SIGTERM: its subprocess runs beside steps 5-7 (their step times
    # then share the card and the host with it) ----
    sigterm = _sigterm_start(ckpt, tmp, seed, pairs)
    # ---- 5. evaluate ----
    done = timed_step("5 evaluate")
    eval_pairs = os.path.join(tmp, "eval_pairs.jsonl")
    rng = np.random.default_rng(seed + 11)
    with open(eval_pairs, "w") as f:
        for _ in range(N_EVAL_PAIRS):
            f.write(json.dumps({"query": _text(rng, 4, 33), "passage1": _text(rng, 16, 481),
                                "passage2": _text(rng, 16, 481),
                                "preferred": "AB"[int(rng.integers(2))]}) + "\n")
    eval_dir = os.path.join(tmp, "stage2_eval")
    n = out["eval"] = run_feature("5f stage 2 eval", run_rankpo.main, _feature_argv(
        ckpt, pairs, eval_dir, seed, "stage2", FEATURE_STEPS, "--eval_data", eval_pairs,
        "--eval_strategy", "steps", "--eval_steps", "2"), keep=True)
    evals = [(h["global_step"], h["eval_loss"]) for h in n["history"] if "eval_loss" in h]
    if [s for s, _ in evals] != [2, 4]:
        raise AssertionError(f"5f evaluate: eval rows at steps {evals}")
    ds = PairPreferenceDataset(eval_pairs, HashTokenizer(vocab_size=128256), 128, 512)
    batches = list(DataLoader(ds, RankPOCollator(0, 128, 512), 8, shuffle=False,
                              drop_last=False).epoch(0))
    ref = _no_grad_losses(eval_dir, batches, _rankpo_loss_for,
                          (("kernels", "auto", torch.bfloat16),
                           ("plain", "plain", torch.bfloat16),
                           ("fp32", "plain", torch.float32)))
    shutil.rmtree(eval_dir)
    last = evals[-1][1]
    rel = {k: abs(last - v) / abs(v) for k, v in ref.items()}
    out["eval"].update(eval_losses=evals, reference=ref, rel=rel)
    log(f"5f evaluate: eval_loss at steps {[s for s, _ in evals]}: "
        f"{[round(v, 6) for _, v in evals]}; the last against the no-grad loss over the "
        f"{N_EVAL_PAIRS} held-out pairs from the final weights, outside the trainer: kernels "
        f"bf16 {ref['kernels']:.6f} ({rel['kernels']:.3e}, held bit-equal), plain bf16 "
        f"{ref['plain']:.6f} ({rel['plain']:.3e}), plain fp32 {ref['fp32']:.6f} "
        f"({rel['fp32']:.3e}; plain bf16 is {abs(ref['plain'] - ref['fp32']) / ref['fp32']:.3e} "
        f"from it)")
    if last != ref["kernels"]:
        raise AssertionError(f"5f evaluate: eval_loss {last} is not the no-grad loss "
                             f"{ref['kernels']} over the same batches")
    done()
    # ---- 6. gradient caching ----
    done = timed_step("6 gradient caching")
    group4 = ["--gradient_accumulation_steps", "4"]
    out["gradcache"] = n = s1("grad_cache", GRADCACHE_STEPS, *group4, "--grad_cache", "True")
    out["accum4"] = plain = s1("accum4", GRADCACHE_STEPS, *group4)
    loader = DataLoader(ContrastiveDataset(train, HashTokenizer(vocab_size=128256), 128, 512),
                        ContrastiveCollator(0, 3, 128, 512, seed=seed), 8, seed=seed)
    group = next(iter(loader.epoch(0, stack=4)))
    flat = {f: {k: v.reshape((-1,) + v.shape[2:]) for k, v in block.items()}
            for f, block in group.items()}
    ref = _no_grad_losses(ckpt, [flat], _contrastive_loss_for,
                          (("kernels", "auto", torch.bfloat16),
                           ("fp32", "plain", torch.float32)))
    first = n["losses"][0]
    rel = abs(first - ref["fp32"]) / abs(ref["fp32"])
    micro = GRADCACHE_STEPS * 4
    want = {"gradcache": (3 * layers * 2 * micro, 0, layers * 2 * micro, layers * 2 * micro),
            "accum4": (2 * layers * 2 * micro, 0, layers * 2 * micro, layers * 2 * micro)}
    for label, nums in (("gradcache", n), ("accum4", plain)):
        got = tuple(nums["launches"][name] for name in KERNELS)
        if got != want[label]:
            raise AssertionError(f"5f {label}: K1, K2, K3a, K3b launched {got}, expected "
                                 f"{want[label]}")
    n.update(reference=ref, first_loss_rel_fp32=rel)
    log(_feature_line("5f stage 1 batch 8 x accumulation 4 --grad_cache True", n))
    log(_feature_line("5f stage 1 batch 8 x accumulation 4, plain accumulation", plain))
    log(f"5f gradient caching: first loss {first:.6f} against one no-grad InfoNCE over all "
        f"32 rows: fp32 plain {ref['fp32']:.6f} ({rel:.3e}; limit {LOSS_REL_FP32:.0e}), "
        f"kernels bf16 {ref['kernels']:.6f}; plain accumulation's first loss (the mean of 4 "
        f"micro-batch losses) {plain['losses'][0]:.6f}")
    if not rel <= LOSS_REL_FP32:
        raise AssertionError(f"5f gradient caching: first loss {first} against {ref['fp32']}")
    done()
    # ---- 7. profiler and debug_nans ----
    done = timed_step("7 profiler and debug_nans")
    n = out["profile"] = s1("profile", FEATURE_SHORT_STEPS, "--profile_steps", "2",
                            "--profile_start_step", "1", keep=True)
    trace = os.path.join(tmp, "stage1_profile", "profile", "trace.json")
    size = os.path.getsize(trace)
    with open(trace) as f:
        names_k1 = "flash_fwd" in f.read()
    shutil.rmtree(os.path.join(tmp, "stage1_profile"))
    log(f"5f --profile_steps 2: {trace} {size / 1e6:.1f} MB, names flash_fwd {names_k1}; "
        f"wall {n['wall_s']:.1f} s")
    if not size or not names_k1:
        raise AssertionError("5f profile: the trace is empty or does not name flash_fwd")
    n = out["debug_nans"] = s1("debug_nans", FEATURE_SHORT_STEPS, "--debug_nans", "True")
    # its 3-step schedule is the 4-step one's until the second update
    same = (n["losses"][:2], n["grad_norms"][:2]) == (adamw["losses"][:2],
                                                     adamw["grad_norms"][:2])
    log(_feature_line("5f stage 1 --debug_nans True", n)
        + f"; the plain run's median step {adamw['step_time_s']:.4f} s; the first two losses "
        f"and gradient norms bit-equal to the plain run's: {same}")
    if not same:
        raise AssertionError("5f debug_nans changed the losses")
    done()
    done = timed_step("4 SIGTERM (the rest after 7)")
    out["sigterm"] = _sigterm_finish(sigterm)
    done()
    return out


LORA_R, LORA_ALPHA = 8, 16  # 5l's adapters
LORA_LR = "1e-4"  # 5l's LoRA run (the adapters start at B = 0; the first loss is unchanged)


def _retrieval_rows(history) -> list:
    return [h for h in history if "retrieval_MRR@1" in h]


def _count_tokens(calls: list):
    """Wrap ``InferenceEncoder.embed_batch`` and ``embed_packed_batch`` so
    each call appends (real tokens, token slots) of the rows it was given:
    the pad share of an encode as the card saw it. Returns the restore."""
    from rankpo_tpu_torch.index.encoding import InferenceEncoder

    plain, packed = InferenceEncoder.embed_batch, InferenceEncoder.embed_packed_batch

    def embed_batch(self, batch, *args, **kwargs):
        mask = batch["attention_mask"]
        calls.append((int(mask.sum()), mask.size))
        return plain(self, batch, *args, **kwargs)

    def embed_packed_batch(self, input_ids, segment_ids, *args, **kwargs):
        calls.append((int((segment_ids != 0).sum()), segment_ids.size))
        return packed(self, input_ids, segment_ids, *args, **kwargs)

    InferenceEncoder.embed_batch = embed_batch
    InferenceEncoder.embed_packed_batch = embed_packed_batch

    def restore():
        InferenceEncoder.embed_batch, InferenceEncoder.embed_packed_batch = plain, packed
    return restore


def phase_training_item7(ckpt: str, tmp: str, seed: int, features: dict,
                         stage2: dict) -> dict:
    """Phase 5l, the rest of the training extensions at Llama-3.2-1B's full
    width, 5f's checkpoint (FEATURE_LAYERS of 16 layers), phase 5's lengths
    and batches, through the CLIs, after 5f (``features``, whose runs it is
    held to) and beside phase 5's full stage 2 (``stage2``):

    1. ``run_rankpo --use_lora True --lora_r 8 --lora_alpha 16`` under
       deterministic algorithms, 4 steps, with ``--retrieval_eval_query_file
       / --retrieval_eval_corpus_file`` over phase 7's 256 span queries and
       the 4096 passages at ``--eval_steps 2``, k 100: the adapter count
       (layers x (2048·8 + 8·2048 + 2048·8 + 8·512)); the first loss bit-equal
       to 5f step 5's (the same argv without LoRA from the same checkpoint:
       B = 0 leaves the base); every tensor of the saved model that no
       adapter touches bit-equal to the checkpoint, and every adapted one
       bit-equal to the merge recomputed here from the checkpoint and the
       saved adapters (so the base did not move); the last eval point's
       ``retrieval_*`` within rtol 1e-6 of ``cli.evaluate --bf16`` over the
       saved model at the hook's batch, lengths and k (bit-equality
       printed); K1, K3a and K3b launched, K2 not; step time and peak
       memory beside phase 5's stage 2 (16 layers); ``retrieval_eval_runtime``;
    2. ``run_contrastive --streaming True`` with the retrieval hook at step
       4 and no eval set, 5f's "full" argv otherwise: losses and gradient
       norms bit-equal to 5f "full"'s, step for step; its metrics printed;
    3. ``InferenceEncoder.encode_packed`` against ``encode`` (batch 64) over
       phase 4's 4096 passages at max length 512, each warmed on the first
       512 passages: every embedding within cosine 0.999 of the unpacked
       one (phase 4p's limit); passages/s, the pad share of the batches the
       card ran and K1's launches (with segments) of each; ``encode_packed``
       also at ``pack_chunk`` 1024, where the next chunk's tokenization
       runs while the card works on the last one's rows."""
    from rankpo_tpu_torch.cli import evaluate, run_contrastive, run_rankpo
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.models import lora
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.models.hf_io import load_pretrained
    from rankpo_tpu_torch.ops import flash_attention as flash

    train, pairs = write_training_data(tmp, seed)
    layers = EncoderConfig.from_pretrained(ckpt).num_hidden_layers
    corpus, corpus_file, _ = _serving_data(seed, tmp)
    query_file, _, _ = write_eval_queries(tmp, seed, corpus)
    retrieval = ["--retrieval_eval_query_file", query_file, "--retrieval_eval_corpus_file",
                 corpus_file, "--retrieval_eval_k", "100", "--eval_strategy", "steps"]
    out = {}

    def timed_step(label):
        t = time.perf_counter()
        return lambda: log(f"5l step {label}: {time.perf_counter() - t:.1f} s")

    # ---- 1. LoRA stage 2 with the in-training retrieval evaluation ----
    done = timed_step("1 LoRA")
    lora_dir = os.path.join(tmp, "stage2_lora")
    n = out["lora"] = run_feature("5l stage 2 LoRA", run_rankpo.main, _feature_argv(
        ckpt, pairs, lora_dir, seed, "stage2", FEATURE_STEPS, "--use_lora", "True",
        "--lora_r", str(LORA_R), "--lora_alpha", str(LORA_ALPHA), "--learning_rate", LORA_LR,
        *retrieval, "--eval_steps", "2"), deterministic=True, keep=True)
    evals = _retrieval_rows(n["history"])
    if [h["global_step"] for h in evals] != [2, 4]:
        raise AssertionError(f"5l LoRA: retrieval eval rows at {evals}")
    plain_first = features["eval"]["losses"][0]
    adapters = torch.load(os.path.join(lora_dir, "lora_adapters.pt"), map_location="cuda")
    n_adapter = sum(t.numel() for t in adapters.values())
    want_adapter = layers * (2048 * LORA_R + LORA_R * 2048 + 2048 * LORA_R + LORA_R * 512)
    _, base = load_pretrained(ckpt)
    _, saved = load_pretrained(lora_dir)
    targets = {k[: -len(".lora_a")] + ".weight" for k in adapters if k.endswith(".lora_a")}
    torch.use_deterministic_algorithms(True)  # as in the run that merged them
    try:
        merged = lora.merge_lora({name: base[name].to("cuda", torch.float32) for name in targets},
                                 adapters, LORA_ALPHA / LORA_R)
    finally:
        torch.use_deterministic_algorithms(False)
    untouched = [name for name in saved if name not in targets]
    base_same = all(torch.equal(saved[name], base[name].float()) for name in untouched)
    merge_same = all(torch.equal(saved[name], merged[name].cpu()) for name in targets)
    moved = sum(not torch.equal(saved[name], base[name].float()) for name in targets)
    del base, saved, merged, adapters
    eval_dir = os.path.join(tmp, "eval_lora")
    t = time.perf_counter()
    offline = evaluate.main([
        "--model_name_or_path", lora_dir, "--tokenizer_name", "hash:128256",
        "--query_data", query_file, "--corpus_data", corpus_file, "--bf16", "--k", "100",
        "--batch_size", "256", "--max_query_length", "128", "--max_passage_length", "512",
        "--device", "cuda", "--output_dir", eval_dir, "--log_level", "warning"])["main"]
    offline_s = time.perf_counter() - t
    shutil.rmtree(lora_dir)
    shutil.rmtree(eval_dir)
    live = {k[len("retrieval_"):]: v for k, v in evals[-1].items()
            if k.startswith("retrieval_") and k != "retrieval_eval_runtime"}
    close = set(live) == set(offline) and all(
        abs(live[k] - offline[k]) <= 1e-6 * abs(offline[k]) for k in offline)
    bit_equal = live == offline
    log(_feature_line("5l stage 2 LoRA (r 8, alpha 16, q_proj and v_proj)", n)
        + f"; adapter parameters {n_adapter} ({want_adapter} expected), phase 5's full stage "
        f"2 (16 layers): median step {stage2['step_time_s']:.4f} s, peak "
        f"{stage2['peak_mem_gib']:.2f} GiB")
    log(f"5l LoRA: first loss {n['losses'][0]!r} against the plain stage-2 run's (5f step 5, "
        f"the same argv and checkpoint) {plain_first!r}: bit-equal "
        f"{n['losses'][0] == plain_first}; the {len(untouched)} tensors no adapter touches "
        f"bit-equal to the checkpoint {base_same}; the {len(targets)} adapted ones "
        f"bit-equal to the merge of the checkpoint and the saved adapters {merge_same} "
        f"({moved} moved)")
    log(f"5l LoRA retrieval eval at steps {[h['global_step'] for h in evals]}: runtime "
        f"{[h['retrieval_eval_runtime'] for h in evals]} s; the last "
        f"{ {k: round(v, 6) for k, v in live.items() if '@10' in k or '@100' in k} }; "
        f"cli.evaluate --bf16 over the saved model ({offline_s:.1f} s): within rtol 1e-6 "
        f"{close}, bit-equal {bit_equal}")
    kernels = (n["launches"]["flash_fwd"], n["launches"]["flash_bwd_fused"],
               n["launches"]["flash_dq"], n["launches"]["flash_dkv"])
    need_bwd = layers * 2 * FEATURE_STEPS
    if not (n_adapter == want_adapter and n["losses"][0] == plain_first and base_same
            and merge_same and moved == len(targets) and close
            and kernels[1:] == (0, need_bwd, need_bwd) and kernels[0] > 2 * need_bwd):
        raise AssertionError(f"5l LoRA: adapters {n_adapter}, first loss {n['losses'][0]} vs "
                             f"{plain_first}, base {base_same}, merge {merge_same}, moved "
                             f"{moved}, metrics {live} vs {offline}, K1-K3b {kernels}")
    n.update(adapter_params=n_adapter, retrieval=live, offline_s=offline_s,
             retrieval_runtime=[h["retrieval_eval_runtime"] for h in evals],
             bit_equal_metrics=bit_equal)
    done()
    # ---- 2. streaming stage 1, the retrieval hook and no eval set ----
    done = timed_step("2 streaming")
    n = out["streaming"] = run_feature("5l stage 1 streaming", run_contrastive.main,
                                       _feature_argv(ckpt, train, os.path.join(tmp, "stage1_stream"),
                                                     seed, "stage1", FEATURE_STEPS,
                                                     "--gradient_checkpointing_policy", "full",
                                                     "--streaming", "True", *retrieval,
                                                     "--eval_steps", str(FEATURE_STEPS)))
    full = features["full"]
    same = (n["losses"], n["grad_norms"]) == (full["losses"], full["grad_norms"])
    evals = _retrieval_rows(n["history"])
    log(_feature_line("5l stage 1 --streaming True", n)
        + f"; losses and gradient norms bit-equal to 5f 'full' step for step: {same}; "
        f"retrieval at step {[h['global_step'] for h in evals]}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in evals[-1].items() if k.startswith("retrieval_")))
    if not same or [h["global_step"] for h in evals] != [FEATURE_STEPS]:
        raise AssertionError(f"5l streaming: losses {n['losses']} / {full['losses']}, gradient "
                             f"norms {n['grad_norms']} / {full['grad_norms']}, evals {evals}")
    n["retrieval"] = evals[-1]
    done()
    # ---- 3. the packed corpus encode ----
    done = timed_step("3 packed encode")
    encoder = InferenceEncoder.from_pretrained(
        ckpt, tokenizer=resolve_tokenizer("hash:128256", ckpt), device="cuda")
    # both paths warmed on the first 512 passages (the packed one reaches
    # its full batch of 128 rows there), so neither pays first-shape costs
    encoder.encode(corpus[:512], batch_size=64, max_length=512)
    encoder.encode_packed(corpus[:512], max_length=512)
    runs = {  # key -> (label, the call)
        "encode": ("encode (batch 64)",
                   lambda: encoder.encode(corpus, batch_size=64, max_length=512)),
        "encode_packed": ("encode_packed (pack_chunk 8192, the default)",
                          lambda: encoder.encode_packed(corpus, max_length=512)),
        "encode_packed_1024": ("encode_packed (pack_chunk 1024)",
                               lambda: encoder.encode_packed(corpus, max_length=512,
                                                             pack_chunk=1024)),
    }
    enc = {}
    for key, (label, call) in runs.items():
        calls = []
        restore = _count_tokens(calls)
        flash.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            emb = call()
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t
        real, slots = map(sum, zip(*calls))
        enc[key] = {"emb": emb, "wall_s": wall, "passages_per_s": N_PASSAGES / wall,
                    "pad_share": 1 - real / slots, "batches": len(calls),
                    "launches": flash.launches["flash_fwd"],
                    "packed_launches": flash.packed_launches["flash_fwd"]}
        log(f"5l {label} of {N_PASSAGES} passages (max length 512): {wall:.3f} s = "
            f"{N_PASSAGES / wall:.1f} passages/s, {len(calls)} batches, pad share "
            f"{1 - real / slots:.4f}, K1 launches {enc[key]['launches']} "
            f"({enc[key]['packed_launches']} with segments)")
    del encoder
    gc.collect()
    torch.cuda.empty_cache()
    a = enc["encode"].pop("emb")
    cos = {}
    for key in ("encode_packed", "encode_packed_1024"):
        b = enc[key].pop("emb")
        cos[key] = float(((a * b).sum(1) / np.linalg.norm(a, axis=1)
                          / np.linalg.norm(b, axis=1)).min())
    log(f"5l encode_packed against encode: min cosine {cos['encode_packed']:.6f}, at "
        f"pack_chunk 1024 {cos['encode_packed_1024']:.6f} (limit 0.999)")
    if min(cos.values()) < 0.999 or min(enc[k]["packed_launches"] for k in cos) < 16:
        raise AssertionError(f"5l encode_packed: min cosines {cos}, {enc}")
    out["encode"] = {**enc, "min_cosine": min(cos.values())}
    done()
    return out

DP_STEPS = (4, 2)  # 5d's two ranks: stage-1 and stage-2 steps
DP_PER_RANK = 4  # 5d: per-device batch of each of the two ranks (global 8, phase 5's)
# 5d(b): the two ranks against one process in bf16 (the kernels' dtype).
# Step 1 (the same weights and global batch) holds to JAX's multi-process
# rtol 2e-4. From step 2 each rank's weight gradients, bf16 products over
# half the rows, and AdamW's near-sign first steps put the runs apart; the
# same pair in fp32 holds 2e-4 over every step (``--dp_witness``). So every
# step's loss and gradient norm is held to DP_HISTORY_RTOL, and every
# tensor's update to DP_UPDATE_GAP: ||w_W2 - w_1|| / ||w_1 - w_start||, the
# two runs' gap over one process's own move. Both limits lie between the
# sound pair and a control that trains on other data (``--dp_witness``,
# PERF.md section 6, PR 18): the history gap 2.3e-3 sound, 3.8e-2 and
# 1.8e-1 in the control; the update gap 0.056 at the sound pair's worst
# tensor, 0.65 and 1.40 at the control's median one.
DP_HISTORY_RTOL = 1e-2
DP_UPDATE_GAP = 0.2
FP32_FLAGS = ("--bf16", "False", "--attn_impl", "plain")
FP32_STAGE1_STEPS = 2  # 5t(b)'s fp32 stage 1 (its gaps are rounding-free at any step)


def _digests(tensors: dict) -> dict:
    """{name: CRC-32 of the tensor's bytes} (the bit-for-bit comparison of
    states held in different processes)."""
    out = {}
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor):
            host = t.detach().cpu().contiguous().reshape(-1)
            out[name] = zlib.crc32(host.view(torch.uint8).numpy().tobytes())
        else:
            out[name] = repr(t)
    return out


def _state_digests(trainer) -> dict:
    """CRC-32 of every trainable parameter and of every optimizer-state
    tensor the trainer holds (global parameter indices)."""
    opt = trainer.optimizer.state_dict()["state"]
    return {"params": _digests(dict(zip(trainer.param_names, trainer.params))),
            "optimizer": {str(i): _digests(entry) for i, entry in opt.items()}}


def _state_bytes(trainer) -> int:
    return sum(t.numel() * t.element_size() for entry in trainer.optimizer.state.values()
               for t in entry.values() if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def _capture_trainers(digest_on_start: bool = False):
    """The Trainers whose ``train`` runs while the context is open (and,
    with ``digest_on_start``, their state digests as ``train`` starts)."""
    from rankpo_tpu_torch.train import trainer as trainer_mod

    seen = []
    original = trainer_mod.Trainer.train

    def train(self, *args, **kwargs):
        seen.append({"trainer": self,
                     "start": _state_digests(self) if digest_on_start else None})
        return original(self, *args, **kwargs)

    trainer_mod.Trainer.train = train
    try:
        yield seen
    finally:
        trainer_mod.Trainer.train = original


def _dp_rank(rank: int, port: int, tag: str, stages: list, result_path: str) -> None:
    """One of 5d's two ranks (started by ``multiprocessing`` with spawn):
    join the gloo group on cuda:0, run each (stage, argv) of ``stages``
    (stage 1, stage 2, and for 5t(b) stage 2 in fp32) through its CLI with
    the launch counters from 0 around each, and write the histories,
    launches, peak memory, optimizer-state bytes and the digests of the
    final parameters and of this rank's optimizer state."""
    import torch.distributed as dist

    from rankpo_tpu_torch.cli import evaluate, run_contrastive, run_rankpo
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.parallel.sharding import full_state_dict

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    # the (query, kv) head counts K1 ran with on this rank
    heads, launch_fwd = set(), flash.flash_attention_fwd

    def counted_fwd(q, k, *args, **kwargs):
        heads.add((q.shape[2], k.shape[2]))
        return launch_fwd(q, k, *args, **kwargs)

    flash.flash_attention_fwd = counted_fwd
    out = {}
    try:
        mains = {"stage1": run_contrastive.main, "stage2": run_rankpo.main}
        for stage, argv in stages:
            main = mains[stage.split("_")[0]]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            flash.reset_launches()
            heads.clear()
            t0 = time.perf_counter()
            with _capture_trainers() as seen:
                history = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trainer = seen[-1]["trainer"]
            out[stage] = {"history": history, "launches": dict(flash.launches),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "wall_s": wall, "state_bytes": _state_bytes(trainer),
                          "param_bytes": sum(p.numel() * p.element_size()
                                             for p in trainer.params),
                          "largest_bytes": 4 * max(math.prod(shape) for shape in (
                              trainer.fsdp.shapes if trainer.fsdp is not None
                              else [p.shape for p in trainer.params])),
                          "heads": sorted(heads),
                          "owned": len(trainer.optimizer.state),
                          "step_time_s": _median(history, "step_time")}
            if "--retrieval_eval_query_file" in argv:
                # the hook's numbers against cli.evaluate at W = 2 over the
                # model saved at its step, with the hook's own settings
                value = lambda flag: argv[argv.index(flag) + 1]  # noqa: E731
                flash.reset_launches()
                offline = evaluate.main([
                    "--model_name_or_path", value("--output_dir"),
                    "--tokenizer_name", value("--tokenizer_name"),
                    "--query_data", value("--retrieval_eval_query_file"),
                    "--corpus_data", value("--retrieval_eval_corpus_file"), "--bf16",
                    "--k", value("--retrieval_eval_k"), "--batch_size", "256",
                    "--max_query_length", value("--max_query_length"),
                    "--max_passage_length", value("--max_passage_length"), "--device", "cuda",
                    "--output_dir", value("--output_dir") + f"_eval{rank}",
                    "--log_level", "warning"])["main"]
                out[stage]["retrieval"] = {
                    "hook": [h for h in history if "retrieval_MRR@1" in h],
                    "offline": offline, "offline_k1": flash.launches["flash_fwd"]}
            if stage == "stage1":
                out[stage]["digests"] = _state_digests(trainer)
                if trainer.gathers_model():  # the one-process layout, on rank 0
                    full = full_state_dict(trainer.model)
                    opt = trainer.gather_optimizer_state()
                    if rank == 0:
                        out[stage]["full_digests"] = {
                            "params": _digests(full),
                            "optimizer": {str(i): _digests(e)
                                          for i, e in opt["state"].items()}}
                    del full, opt
            del seen, trainer
            log(f"{tag} rank {rank} {stage}: losses "
                f"{[round(h['loss'], 6) for h in history if 'loss' in h]}, median step "
                f"{out[stage]['step_time_s']:.4f} s, wall {wall:.1f} s")
    finally:
        flash.flash_attention_fwd = launch_fwd
        dist.destroy_process_group()
    with open(result_path, "w") as f:
        json.dump(out, f)


def _dp_rows(train: str, tmp: str, negatives: slice, name: str) -> str:
    """``train``'s rows, each cut to ``negatives`` (3 of its 7): then a
    rank's collator draws the same passages for a row as one process's
    does (only their order differs, which the pooled loss does not see);
    with 7 to draw from, each rank's sampling stream would pick others."""
    path = os.path.join(tmp, name)
    with open(train) as src, open(path, "w") as dst:
        for line in src:
            row = json.loads(line)
            dst.write(json.dumps({**row, "negatives": row["negatives"][negatives]}) + "\n")
    return path


def _pair_stages(ckpt_cut: str, train: str, pairs: str, tmp: str, seed: int, tag: str,
                 start2: str, extra, fp32: bool = False, retrieval=()) -> list:
    """The (stage, argv) list of a pair's ranks: stage 1 on ``train`` from
    ``ckpt_cut`` for DP_STEPS[0] steps ending in a checkpoint with the
    optimizer state, stage 2 on ``pairs`` from ``start2`` for DP_STEPS[1]
    steps (per-device batch DP_PER_RANK, so a global batch of 8 as JAX
    counts every device; cross-device negatives, ``--zero1``; ``extra`` on
    each), and with ``fp32`` stage 1 for FP32_STAGE1_STEPS steps and stage 2
    again with FP32_FLAGS. ``retrieval``: flags of the in-training retrieval
    evaluation on stage 1 (the ranks then evaluate its model with
    ``cli.evaluate`` as well, :func:`_dp_rank`)."""
    s1_steps, s2_steps = DP_STEPS
    per_rank = ["--per_device_train_batch_size", str(DP_PER_RANK)]
    out1, out2 = (os.path.join(tmp, f"{tag}_{name}") for name in ("stage1_w2", "stage2_w2"))
    stages = [
        ("stage1", _feature_argv(ckpt_cut, train, out1, seed, "stage1", s1_steps, *per_rank,
                                 "--negatives_cross_device", "True", "--zero1", "True",
                                 "--save_strategy", "steps", "--save_steps", "1000",
                                 "--save_only_model", "False", *retrieval, *extra)),
        ("stage2", _feature_argv(start2, pairs, out2, seed, "stage2", s2_steps, *per_rank,
                                 "--zero1", "True", *extra))]
    if fp32:
        stages += [
            ("stage1_fp32", _feature_argv(
                ckpt_cut, train, out1 + "_fp32", seed, "stage1", FP32_STAGE1_STEPS, *per_rank,
                "--negatives_cross_device", "True", "--zero1", "True", *FP32_FLAGS, *extra)),
            ("stage2_fp32", _feature_argv(
                start2, pairs, out2 + "_fp32", seed, "stage2", s2_steps, *per_rank, "--zero1",
                "True", *FP32_FLAGS, *extra))]
    return stages


def _launch_ranks(tag: str, tmp: str, target, *args) -> tuple:
    """Two ranks ``target(rank, port, *args, result_path)`` started (spawn)
    to join a gloo group of their own; returns what :func:`_join_ranks`
    takes."""
    import multiprocessing

    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    paths = [os.path.join(tmp, f"{tag.replace(' ', '_')}_rank{r}.json") for r in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    procs = [ctx.Process(target=target, args=(r, port, *args, paths[r])) for r in range(2)]
    for p in procs:
        p.start()
    return tag, procs, paths, time.perf_counter()


def _kill_ranks(launched: tuple) -> None:
    """Stop the ranks of :func:`_launch_ranks` (a phase beside them failed)."""
    for p in launched[1]:
        if p.is_alive():
            p.kill()
        p.join(10)


def _join_ranks(launched: tuple) -> tuple:
    """(the two ranks' results, their wall seconds): each rank joined with a
    timeout of its own and killed after it."""
    tag, procs, paths, t0 = launched
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    wall = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{tag}: the two ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, wall


def _shared_pair(ckpt_cut: str, stages: list, ranks: list, wall: float, one: dict) -> dict:
    """A pair's ranks beside an earlier pair's one-process runs ``one``
    ({"runs", "dirs": {stage: directory}, "stage2_start"}): each stage's
    (start, one process, two ranks) model directories."""
    dirs = {stage: (ckpt_cut if stage.startswith("stage1") else one["stage2_start"],
                    one["dirs"][stage], argv[argv.index("--output_dir") + 1])
            for stage, argv in stages}
    return {"ranks": ranks, "one": one["runs"], "wall_s": wall, "dirs": dirs}


def _dp_pair(ckpt_cut: str, train: str, pairs: str, tmp: str, seed: int, tag: str,
             *extra, retrieval=(), beside=None) -> dict:
    """5d(b)'s pair, ``extra`` flags on both sides: two ranks sharing the
    card under gloo over :func:`_pair_stages` (stage 2 from their stage-1
    output), and one process on the same global batches from the same
    weights (stage 2 from the ranks' stage-1 model). ``beside``, if given,
    runs in this process after stage 1's reference, while the ranks still
    run. Returns the ranks' results, the one-process runs, the two ranks'
    wall seconds and each stage's (start, one process, two ranks) model
    directories."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo

    s1_steps, s2_steps = DP_STEPS
    dp1, dp2, ref1, ref2 = (os.path.join(tmp, f"{tag}_{name}") for name in (
        "stage1_w2", "stage2_w2", "stage1_w1", "stage2_w1"))
    stages = _pair_stages(ckpt_cut, train, pairs, tmp, seed, tag, dp1, extra,
                          retrieval=retrieval)
    launched = _launch_ranks(f"5d {tag}", tmp, _dp_rank, f"5d {tag}", stages)
    one = {}

    def reference(stage, main, argv):
        with _capture_trainers() as seen:
            n = one[stage] = run_feature(f"5d {tag} W=1 {stage} reference", main, argv,
                                         keep=True)
            n["state_bytes"] = _state_bytes(seen[-1]["trainer"])
            n["param_bytes"] = sum(p.numel() * p.element_size()
                                   for p in seen[-1]["trainer"].params)
            del seen

    # stage 1's reference while the ranks run (its step time then shares
    # the card and the host with them); stage 2's starts from their stage 1
    reference("stage1", run_contrastive.main,
              _feature_argv(ckpt_cut, train, ref1, seed, "stage1", s1_steps, *extra))
    if beside is not None:
        try:
            beside()
        except BaseException:
            _kill_ranks(launched)
            raise
    ranks, wall = _join_ranks(launched)
    reference("stage2", run_rankpo.main,
              _feature_argv(dp1, pairs, ref2, seed, "stage2", s2_steps, *extra))
    return {"ranks": ranks, "one": one, "wall_s": wall,
            "dirs": {"stage1": (ckpt_cut, ref1, dp1), "stage2": (dp1, ref2, dp2)}}


def _history_gaps(got: list, ref: list) -> dict:
    """|got - ref| / |ref| of the loss and the gradient norm, step by step
    (over ``got``'s steps, the first of ``ref``'s)."""
    out = {}
    for key in ("loss", "grad_norm"):
        a = np.array([h[key] for h in got if "loss" in h])
        b = np.array([h[key] for h in ref if "loss" in h])[:len(a)]
        out[key] = (np.abs(a - b) / np.abs(b)).tolist()
    return out


def _update_gaps(start: str, ref: str, got: str) -> dict:
    """How far ``got``'s update of each tensor from ``start`` lies from
    ``ref``'s: ||w_got - w_ref|| / ||w_ref - w_start|| (on the card, fp32;
    infinite where ``ref`` left a tensor that ``got`` moved). The worst
    tensor, the median over tensors, the whole model's ratio, the largest
    |w_got - w_ref| and the share of weights that differ."""
    from rankpo_tpu_torch.models.hf_io import load_pretrained

    _, w0 = load_pretrained(start)
    _, w1 = load_pretrained(ref)
    _, w2 = load_pretrained(got)
    gaps, apart, moved = {}, 0.0, 0.0
    largest, differ, count = 0.0, 0, 0
    for name in w1:
        a, b = w1[name].cuda().float(), w2[name].cuda().float()
        step = float(torch.linalg.vector_norm(a - w0[name].cuda().float()))
        diff = b - a
        gap = float(torch.linalg.vector_norm(diff))
        gaps[name] = gap / step if step > 0 else (0.0 if gap == 0 else float("inf"))
        apart, moved = apart + gap ** 2, moved + step ** 2
        largest = max(largest, float(diff.abs().max()))
        differ += int((diff != 0).sum())
        count += diff.numel()
    del w0, w1, w2
    torch.cuda.empty_cache()
    worst = max(gaps, key=gaps.get)
    return {"worst": gaps[worst], "worst_tensor": worst,
            "median": float(np.median(list(gaps.values()))),
            "model": (apart / moved) ** 0.5, "max_abs": largest, "share_differ": differ / count}


def _dp_compare(pair: dict) -> dict:
    """Each stage of a :func:`_dp_pair` held against its one process: the
    ranks' logs identical, the history gaps, the update gaps, the K1 / K3a /
    K3b launches of each rank; stage 1's replicas bit-equal (two shards of
    one model under ``--model_parallel`` are not replicas)."""
    ranks, checks = pair["ranks"], {}
    for stage in ranks[0]:
        h0, h1 = ranks[0][stage]["history"], ranks[1][stage]["history"]
        checks[stage] = {
            "ranks_equal": [(h["loss"], h["grad_norm"]) for h in h0 if "loss" in h]
            == [(h["loss"], h["grad_norm"]) for h in h1 if "loss" in h],
            "rel": _history_gaps(h0, pair["one"][stage]["history"]),
            "update": _update_gaps(*pair["dirs"][stage]),
            "launched": [tuple(r[stage]["launches"][k] for k in ("flash_fwd", "flash_dq",
                                                                 "flash_dkv")) for r in ranks]}
    checks["replicas"] = (ranks[0]["stage1"]["digests"]["params"]
                          == ranks[1]["stage1"]["digests"]["params"])
    return checks


def _resume_in_one_process(label: str, ckpt_cut: str, train: str, run_dir: str, tmp: str,
                           seed: int, params: dict, optimizer: dict,
                           s1_steps: int = DP_STEPS[0]) -> dict:
    """``run_dir``'s checkpoint-``s1_steps`` resumed in one process
    (``run_contrastive --resume_from_checkpoint``, one more step, into a
    directory of its own, removed after): its parameters and optimizer state as ``train``
    starts held bit for bit to the digests ``params`` and ``optimizer``
    (the one-process layout). Returns the resumed run."""
    from rankpo_tpu_torch.cli import run_contrastive

    directory = os.path.join(run_dir, f"checkpoint-{s1_steps}")
    out = os.path.join(tmp, f"{label}_resumed")
    with _capture_trainers(digest_on_start=True) as seen:
        resumed = run_feature(f"{label} resume -> W=1", run_contrastive.main, _feature_argv(
            ckpt_cut, train, out, seed, "stage1", s1_steps + 1, "--resume_from_checkpoint",
            directory))
        start = seen[-1]["start"]
        del seen
    same_params = start["params"] == params
    same_state = start["optimizer"] == optimizer
    log(f"{label} resume: checkpoint-{s1_steps} in one process: parameters bit-equal "
        f"{same_params}, optimizer state of all {len(optimizer)} tensors bit-equal "
        f"{same_state}; then step {s1_steps + 1}: loss {resumed['losses']}")
    if not (same_params and same_state and len(resumed["losses"]) == 1):
        raise AssertionError(f"{label}: the checkpoint does not resume bit for bit")
    return resumed


def _dp_line(label: str, c: dict) -> str:
    u = c["update"]
    return (f"{label}: relative difference to one process by step: loss "
            f"{[f'{x:.3e}' for x in c['rel']['loss']]}, gradient norm "
            f"{[f'{x:.3e}' for x in c['rel']['grad_norm']]}; update gap (||w_W2 - w_1|| / "
            f"||w_1 - w_start||) worst tensor {u['worst']:.4e} ({u['worst_tensor']}), median "
            f"{u['median']:.4e}, whole model {u['model']:.4e}; max |w_W2 - w_1| "
            f"{u['max_abs']:.3e}, share of weights that differ {u['share_differ']:.4f}")


def _world_size_1(ckpt: str, train: str, tmp: str, seed: int, stage1: dict,
                  out: dict) -> None:
    """5d(a): phase 5's stage 1 through the CLI at world size 1 under NCCL,
    with ``--zero1`` and then ``--zero2``, each held bit for bit to
    ``stage1``; the runs go into ``out`` under "zero1" and "zero2"."""
    import torch.distributed as dist

    from rankpo_tpu_torch.cli import run_contrastive

    flags = ["--coordinator_address", f"127.0.0.1:{_free_port()}", "--num_processes", "1",
             "--process_id", "0", "--negatives_cross_device", "True", "--zero1", "True"]
    try:
        for label, extra in (("zero1", []), ("zero2", ["--zero2", "True"])):
            path = os.path.join(tmp, f"stage1_dp_{label}")
            n = out[label] = run_feature(
                f"5d W=1 {label}", run_contrastive.main,
                _feature_argv(ckpt, train, path, seed, "stage1", 8, *flags, *extra), keep=True)
            if label == "zero1" and (dist.get_backend() != "nccl" or dist.get_world_size() != 1):
                raise AssertionError(f"5d: the CLI made a {dist.get_backend()} group of "
                                     f"{dist.get_world_size()}, not NCCL of 1")
            crc = _file_crc(os.path.join(path, "model.safetensors"))
            shutil.rmtree(path)
            got = tuple(n["launches"][k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            want = tuple(stage1["launches"][k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            same = (n["losses"], n["grad_norms"]) == (stage1["losses"], stage1["grad_norms"])
            log(_feature_line(f"5d W=1 NCCL --{label}", n) + f"; losses and gradient norms "
                f"bit-equal to phase 5's stage 1: {same}; model.safetensors bit-equal: "
                f"{crc == stage1['model_crc']}; K1/K3a/K3b {got} (phase 5: {want})")
            if not same or crc != stage1["model_crc"] or got != want:
                raise AssertionError(f"5d W=1 {label}: not phase 5's stage 1 bit for bit")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_data_parallel(ckpt: str, ckpt_cut: str, tmp: str, seed: int, stage1: dict) -> dict:
    """Phase 5d, data-parallel training (``core/mesh.py``,
    ``parallel/sharding.py``, cross-device negatives) through the CLIs:

    (a) world size 1 under NCCL: phase 5's stage 1 (full width and depth,
        8 steps) with ``--coordinator_address 127.0.0.1:<port>
        --num_processes 1 --process_id 0 --negatives_cross_device True
        --zero1 True``, then again with ``--zero2 True``: losses, gradient
        norms and the final model.safetensors bit-equal to phase 5's stage 1
        (``stage1``), K1/K3a/K3b launches equal to its;
    (b) :func:`_dp_pair` on ``ckpt_cut`` (FEATURE_LAYERS of 16 layers) and
        phase 5's rows with the 3 negatives the collator draws: two ranks
        sharing the one card under gloo (NCCL refuses two ranks on one
        device) against one process on the same global batches, each
        stage held by :func:`_dp_compare`: the ranks' logs identical, step
        1's loss and gradient norm (the same weights and batch; stage 2's
        reference starts from the two ranks' stage-1 model) within rtol
        2e-4, every step's within DP_HISTORY_RTOL, every tensor's update
        gap within DP_UPDATE_GAP, K1, K3a and K3b launched on each rank;
        the stage-1 replicas bit-equal; each rank's optimizer-state bytes,
        peak memory and step time beside the one process's;
    (c) the W = 2 checkpoint resumed in one process (``run_contrastive
        --resume_from_checkpoint``, one more step): its parameters and
        optimizer state as ``train`` starts bit-equal to what the ranks
        held.

    (a) runs in this process while (b)'s two ranks run (they wait on gloo
    through host memory and leave the card mostly idle), after (b)'s
    stage-1 reference: its step times then share the card and the host
    with them."""
    train, pairs = write_training_data(tmp, seed)
    out = {}

    def timed_step(label):
        t = time.perf_counter()
        return lambda: log(f"5d step {label}: {time.perf_counter() - t:.1f} s")

    def world_size_1():
        done = timed_step("a NCCL world size 1, beside (b)'s ranks")
        _world_size_1(ckpt, train, tmp, seed, stage1, out)
        done()

    # ---- (b) two ranks on the one card under gloo, (a) beside them ----
    done = timed_step("b two ranks under gloo, (a) included")
    train_dp = _dp_rows(train, tmp, slice(0, 3), "train_dp.jsonl")
    corpus, corpus_file, _ = _serving_data(seed, tmp)
    query_file, _, _ = write_eval_queries(tmp, seed, corpus)
    retrieval = ("--retrieval_eval_query_file", query_file, "--retrieval_eval_corpus_file",
                 corpus_file, "--retrieval_eval_k", "100", "--eval_strategy", "steps",
                 "--eval_steps", str(DP_STEPS[0]))
    pair = _dp_pair(ckpt_cut, train_dp, pairs, tmp, seed, "dp", retrieval=retrieval,
                    beside=world_size_1)
    ranks, one = pair["ranks"], pair["one"]
    checks = _dp_compare(pair)
    # the retrieval hook at W = 2 against cli.evaluate at W = 2 over the
    # stage-1 model saved at its step: the same shard batches, the same bf16
    # weights, so the same bits
    hook_equal = True
    for r, rank in enumerate(ranks):
        ret = rank["stage1"]["retrieval"]
        if [h["global_step"] for h in ret["hook"]] != [DP_STEPS[0]]:
            raise AssertionError(f"5d W=2 hook: eval rows {ret['hook']}")
        live = {k[len("retrieval_"):]: v for k, v in ret["hook"][0].items()
                if k.startswith("retrieval_") and k != "retrieval_eval_runtime"}
        hook_equal &= live == ret["offline"] and ret["offline_k1"] > 0
        log(f"5d W=2 retrieval hook at step {DP_STEPS[0]}, rank {r} (two ranks on one card, "
            f"gloo): runtime {ret['hook'][0]['retrieval_eval_runtime']} s; MRR@10 "
            f"{live.get('MRR@10')}, nDCG@10 {live.get('nDCG@10')}; cli.evaluate at W = 2 "
            f"over the saved model: bit-equal {live == ret['offline']}; its K1 launches "
            f"{ret['offline_k1']}")
    if not hook_equal:
        raise AssertionError("5d W=2: the retrieval hook disagrees with cli.evaluate at W = 2")
    _, ref1, dp1 = pair["dirs"]["stage1"]
    _, ref2, dp2 = pair["dirs"]["stage2"]
    shutil.rmtree(dp2)  # the one-process runs stay for phase 5t
    for stage in ("stage1", "stage2"):
        c, r0, r1 = checks[stage], ranks[0][stage], ranks[1][stage]
        log(_dp_line(f"5d W=2 {stage}", c) + f" (limits: step 1 2e-4, every step "
            f"{DP_HISTORY_RTOL:.0e}, update gap {DP_UPDATE_GAP}); losses "
            f"{[round(h['loss'], 6) for h in r0['history'] if 'loss' in h]} (one process "
            f"{[round(x, 6) for x in one[stage]['losses']]}); the ranks' logs identical: "
            f"{c['ranks_equal']}; K1/K3a/K3b per rank {c['launched']}; median step "
            f"{r0['step_time_s']:.4f} / {r1['step_time_s']:.4f} s (one process "
            f"{one[stage]['step_time_s']:.4f} s); peak device memory "
            f"{r0['peak_mem_gib']:.2f} / {r1['peak_mem_gib']:.2f} GiB (one process "
            f"{one[stage]['peak_mem_gib']:.2f}); optimizer state {r0['state_bytes'] / 1e9:.3f} / "
            f"{r1['state_bytes'] / 1e9:.3f} GB over {r0['owned']} / {r1['owned']} tensors (one "
            f"process {one[stage]['state_bytes'] / 1e9:.3f} GB); wall {r0['wall_s']:.1f} s")
    log(f"5d W=2 stage 1: the two replicas bit-equal: {checks['replicas']}")
    for stage in ("stage1", "stage2"):
        c = checks[stage]
        if not (c["ranks_equal"] and c["rel"]["loss"][0] <= 2e-4
                and c["rel"]["grad_norm"][0] <= 2e-4
                and max(c["rel"]["loss"] + c["rel"]["grad_norm"]) <= DP_HISTORY_RTOL
                and c["update"]["worst"] <= DP_UPDATE_GAP
                and all(min(x) > 0 for x in c["launched"])):
            raise AssertionError(f"5d W=2 {stage}: {c}")
    if not checks["replicas"]:
        raise AssertionError("5d W=2: the two replicas' parameters differ")
    done()
    # ---- (c) the W = 2 checkpoint resumed in one process ----
    done = timed_step("c resume on one process")
    held = {}
    for r in ranks:
        held.update(r["stage1"]["digests"]["optimizer"])
    resumed = _resume_in_one_process("5d", ckpt_cut, train_dp, dp1, tmp, seed,
                                     ranks[0]["stage1"]["digests"]["params"], held)
    done()
    launches = {name: sum(r[stage]["launches"][name] for r in ranks for stage in r)
                + sum(one[s]["launches"][name] for s in one)
                + out["zero1"]["launches"][name] + out["zero2"]["launches"][name]
                + resumed["launches"][name] for name in KERNELS}
    return {"w1": {k: out[k] for k in ("zero1", "zero2")}, "ranks": ranks, "one": one,
            "checks": checks, "dp_wall_s": pair["wall_s"],
            "launches": launches, "train_dp": train_dp, "pairs": pairs,
            "shared": {"runs": one, "dirs": {"stage1": ref1, "stage2": ref2},
                       "stage2_start": dp1}}


# ---------------------------------------------------------------------------
# phase 5t: sharded models (ring attention, tensor parallelism)
# ---------------------------------------------------------------------------

# 5t(a): Llama-3.2-1B's attention (32 query / 8 kv heads, D 64), causal,
# B 1, S 16384 over two ranks (8192 a rank)
RING_SHAPE = (1, 16384, 32, 8, 64)
RING_TOL_OF_MAX = 2.0**-7  # the kernels' contract (PERF.md section 6)
RING_TIMED = 3  # timed ring and one-process runs (median)


def _ring_inputs(seed: int):
    b, s, hq, hkv, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
    return q, k, v, do


def _fwd_bwd(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn(q, k, v)`` under ``do``."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    out.backward(do)
    return (out.detach(), *(x.grad for x in leaves))


def _ring_rank(rank: int, port: int, seed: int, result_path: str) -> None:
    """One of 5t(a)'s two ranks (``multiprocessing`` spawn): join the gloo
    group on cuda:0, run ``context_parallel_attention(impl="flash")`` over
    the ring of both ranks (one warm run, then the counted run with the
    launch counters and hop statistics from 0, then RING_TIMED timed runs),
    and on rank 0 the one-process K1 + K3a + K3b on the whole sequence (the
    reference and its time) and the ring of one rank against
    ``flash_attention`` bit for bit. Writes the errors, digests, launches,
    hops and times."""
    import torch.distributed as dist

    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.parallel import ring_attention as ring

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    out = {}
    try:
        solo = [dist.new_group([r]) for r in range(2)][rank]
        world = dist.group.WORLD
        q, k, v, do = _ring_inputs(seed)

        def ring_fn(group):
            return lambda *x: ring.context_parallel_attention(*x, group=group, causal=True,
                                                              impl="flash")

        _fwd_bwd(ring_fn(world), q, k, v, do)  # warm
        torch.cuda.synchronize()
        dist.barrier()
        flash.reset_launches()
        ring.reset_hop_stats()
        got = _fwd_bwd(ring_fn(world), q, k, v, do)
        torch.cuda.synchronize()
        out["launches"] = dict(flash.launches)
        out["f32_launches"] = dict(flash.f32_launches)
        out["hops"] = dict(ring.hop_stats)
        out["digests"] = _digests(dict(zip(("out", "dq", "dk", "dv"), got)))
        times = []
        for _ in range(RING_TIMED):
            dist.barrier()
            t0 = time.perf_counter()
            _fwd_bwd(ring_fn(world), q, k, v, do)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["ring_s"] = float(np.median(times))
        dist.barrier()
        if rank == 0:
            ref = _fwd_bwd(lambda *x: flash.flash_attention(*x, causal=True), q, k, v, do)
            out["errors"] = {}
            for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
                out["errors"][name] = ((a.float() - r.float()).abs().max().item(),
                                       RING_TOL_OF_MAX * r.float().abs().max().item())
            times = []
            for _ in range(RING_TIMED):
                t0 = time.perf_counter()
                _fwd_bwd(lambda *x: flash.flash_attention(*x, causal=True), q, k, v, do)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out["one_s"] = float(np.median(times))
            alone = _fwd_bwd(ring_fn(solo), q, k, v, do)
            out["solo_bit_equal"] = all(torch.equal(a, r) for a, r in zip(alone, ref))
            del ref, alone
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(result_path, "w") as f:
        json.dump(out, f)


def check_dkv_f32(seed: int) -> dict:
    """K3b's fp32-output build (``flash_dkv``, counted in ``f32_launches``) at
    the ring's step shapes (B 1, S 8192 a rank, 32 / 8 heads, D 64, every
    key valid): the diagonal step (causal) and an earlier shard's step
    (non-causal), each against its plain version (within 2^-7 of the
    largest |plain| and relative L2 1e-2, as the bf16 build), two launches
    bit for bit, and its output rounded to bf16 bit-equal to the bf16
    build's; the off-diagonal step timed beside plain, SDPA's backward
    alone and its bound (fp32 dk/dv written)."""
    import torch.nn.functional as F

    from rankpo_tpu_torch.ops import flash_attention as flash

    b, s, hq, hkv, d = RING_SHAPE
    s_loc = s // 2
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    q, k, v, do, mask, lens = _attention_inputs(b, s_loc, s_loc, hq, hkv, d, gen,
                                                length=s_loc)
    res = {"max_abs_err": 0.0}
    for causal in (True, False):
        with torch.no_grad():
            out, lse = flash.flash_attention_fwd(q, k, v, mask, causal=causal)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        dk, dv = flash.flash_dkv(q, k, v, mask, do, lse, delta, causal=causal)
        again = flash.flash_dkv(q, k, v, mask, do, lse, delta, causal=causal)
        _, dk16, dv16 = flash.flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=causal)
        _, pk, pv = plain_bwd(q, k, v, mask, do, lse, delta, causal)
        torch.cuda.synchronize()
        if not (torch.equal(dk, again[0]) and torch.equal(dv, again[1])):
            raise AssertionError(f"K3b fp32: two launches differ (causal {causal})")
        if not (torch.equal(dk.bfloat16(), dk16) and torch.equal(dv.bfloat16(), dv16)):
            raise AssertionError(f"K3b fp32 rounded to bf16 is not the bf16 build's "
                                 f"(causal {causal})")
        for name, a, r in (("dk", dk, pk), ("dv", dv, pv)):
            e = (a - r).abs().max().item()
            tol = BWD_TOL_OF_MAX * r.abs().max().item()
            rel = ((a - r).norm() / r.norm()).item()
            log(f"5t K3b fp32 at {(b, s_loc, s_loc, hq, hkv, d)} "
                f"{'causal' if causal else 'non-causal'}: {name} max|err| {e:.3e} (limit "
                f"{tol:.3e}), relative L2 {rel:.3e}; two launches bit-equal, bf16 of it = "
                "the bf16 build's")
            if not (e <= tol and rel <= BWD_REL_L2):
                raise AssertionError(f"K3b fp32 {name} disagrees with plain")
            res["max_abs_err"] = max(res["max_abs_err"], e)
        if causal:
            continue
        call = lambda: flash.flash_dkv(q, k, v, mask, do, lse, delta)  # noqa: E731
        traced = profile_device_ms(call, 10)
        ms = float(sum(t for n, t in traced.items() if "flash_bwd_kv" in n))
        plain_ms = cuda_ms(lambda: plain_bwd(q, k, v, mask, do, lse, delta, False), 3, 1)
        leaves = [x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v)]
        leaves[1:] = [x.detach().repeat_interleave(hq // hkv, dim=1).requires_grad_()
                      for x in leaves[1:]]
        o_lib = F.scaled_dot_product_attention(*leaves)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do.transpose(1, 2),
                                                     retain_graph=True), 10)
        del o_lib, leaves
        b_ms, b_by = bound(attention_cost(lens, s_loc, s_loc, hq, hkv, d, "flash_dkv_f32",
                                          causal=False, skip=False))
        # the bf16 build at the same shape (the split backward's K3b, its
        # kernels told apart by name): whether the fp32 stores or the shape
        # cost the time over the bound
        traced = profile_device_ms(
            lambda: flash.flash_attention_bwd(q, k, v, mask, do, lse, delta), 10)
        bf16_ms = float(sum(t for n, t in traced.items() if "flash_bwd_kv" in n))
        bf16_bound, _ = bound(attention_cost(lens, s_loc, s_loc, hq, hkv, d, "flash_dkv",
                                             causal=False, skip=False))
        res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound)
        log(f"time flash_dkv_f32 at {(b, s_loc, s_loc, hq, hkv, d)} non-causal (a ring "
            f"step): kernel {ms:.4f} ms (device time, profiler); plain {plain_ms:.4f} ms; "
            f"library (SDPA backward alone) {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"the bf16 K3b at the same shape {bf16_ms:.4f} ms (bound {bf16_bound:.4f} ms)")
    del q, k, v, do
    torch.cuda.empty_cache()
    return res


def _check_sharded_pair(ckpt_cut: str, tmp: str, seed: int, dp: dict, tag: str, label: str,
                        heads, pair: dict) -> dict:
    """5t(b) or (c): a pair on 5d(b)'s rows (the same global batches), stage
    2 from 5d(b)'s stage-2 start, held to 5d(b)'s one-process runs by
    :func:`_dp_compare`'s gates unchanged, K1 on each rank at ``heads``
    (query, kv); each rank's parameter and optimizer-state bytes and peak
    memory beside one process's (fsdp: each within half of one process's
    plus the embedding's); the stage-1 checkpoint resumed in one process
    bit for bit against rank 0's gathered digests.

    Under ``--model_parallel`` the row-parallel products sum their
    contraction in two halves, so a bf16 forward rounds otherwise than one
    process's: step 1 carries that rounding as 5d(b)'s second step carries
    its own (stage 1 5.1e-5 at 4 layers and 2.4e-4 at 2, stage 2 ~2e-3:
    margins of cosines times beta / T = 20; PERF.md section 6). So
    the mp 2 pair also runs both stages in fp32 with plain attention
    (``stage1_fp32`` for FP32_STAGE1_STEPS steps, ``stage2_fp32``), held
    by every gate, step 1's 2e-4 included, to one process in fp32; its bf16
    stages are held by every gate but step 1's, whose gaps are logged."""
    checks = _dp_compare(pair)
    run1 = pair["dirs"]["stage1"][2]
    for stage in pair["dirs"]:
        if stage != "stage1":
            shutil.rmtree(pair["dirs"][stage][2])
    one = pair["one"]
    for stage in pair["ranks"][0]:
        c, a, b_ = checks[stage], pair["ranks"][0][stage], pair["ranks"][1][stage]
        embedding = a["largest_bytes"]  # the embedding's fp32 master weights
        total_state = one[stage]["state_bytes"]
        total = one[stage]["param_bytes"]
        bytes_ok = tag != "fsdp" or all(
            r["param_bytes"] <= total / 2 + embedding
            and r["state_bytes"] <= total_state / 2 + 2 * embedding for r in (a, b_))
        log(_dp_line(f"5t {label} {stage}", c) + f" (limits: step 1 2e-4, every step "
            f"{DP_HISTORY_RTOL:.0e}, update gap {DP_UPDATE_GAP}); the ranks' logs identical: "
            f"{c['ranks_equal']}; K1/K3a/K3b per rank {c['launched']} at (query, kv) heads "
            f"{a['heads']} / {b_['heads']}; parameters {a['param_bytes'] / 1e9:.3f} / "
            f"{b_['param_bytes'] / 1e9:.3f} GB and optimizer state "
            f"{a['state_bytes'] / 1e9:.3f} / {b_['state_bytes'] / 1e9:.3f} GB a rank (one "
            f"process {total / 1e9:.3f} and {total_state / 1e9:.3f} GB; half plus the "
            f"embedding {(total / 2 + embedding) / 1e9:.3f} and "
            f"{(total_state / 2 + 2 * embedding) / 1e9:.3f}); peak device memory "
            f"{a['peak_mem_gib']:.2f} / {b_['peak_mem_gib']:.2f} GiB (one process "
            f"{one[stage]['peak_mem_gib']:.2f}); median step {a['step_time_s']:.4f} / "
            f"{b_['step_time_s']:.4f} s (one process {one[stage]['step_time_s']:.4f})")
        step1 = (tag == "tp" and not stage.endswith("fp32")) or (
            c["rel"]["loss"][0] <= 2e-4 and c["rel"]["grad_norm"][0] <= 2e-4)
        kernels = stage.endswith("fp32") or (all(min(x) > 0 for x in c["launched"])
                                             and a["heads"] == b_["heads"] == heads)
        if not (c["ranks_equal"] and step1
                and max(c["rel"]["loss"] + c["rel"]["grad_norm"]) <= DP_HISTORY_RTOL
                and c["update"]["worst"] <= DP_UPDATE_GAP and kernels and bytes_ok):
            raise AssertionError(f"5t {label} {stage}: {c}, heads {a['heads']} "
                                 f"{b_['heads']}, bytes within the bound {bytes_ok}")
    full = pair["ranks"][0]["stage1"]["full_digests"]
    resumed = _resume_in_one_process(f"5t {label}", ckpt_cut, dp["train_dp"], run1, tmp, seed,
                                     full["params"], full["optimizer"])
    shutil.rmtree(run1)
    return {"ranks": pair["ranks"], "checks": checks, "resumed": resumed,
            "wall_s": pair["wall_s"]}


def phase_sharded(ckpt_cut: str, tmp: str, seed: int, dp: dict, beside=None) -> dict:
    """Phase 5t, sharded models (at FEATURE_LAYERS of 16 layers):

    (a) ring attention (``parallel/ring_attention.py``; K3b's fp32 build
        is checked and timed in phase 2, :func:`check_dkv_f32`): two ranks
        sharing the card under gloo run ``context_parallel_attention(impl="flash")``
        at RING_SHAPE (:func:`_ring_rank`): out, dq, dk and dv within 2^-7
        of each tensor's largest |value| of the one-process K1 + K3a + K3b
        on the whole sequence, both ranks' results bit-equal, rank 0 one K1,
        K3a and fp32 K3b launch and rank 1 two of each, the ring of one
        rank bit-equal to ``flash_attention``; the ring's and the one
        process's times and the hops' bytes and seconds logged;
    (b) tensor parallelism: a pair with ``--model_parallel 2`` (dp 1;
        per-device batch DP_PER_RANK, so 5d(b)'s global batches), K1 on
        each rank at 16 query / 4 kv heads, stage 2 also in fp32;
    (c) fsdp: a pair with ``--fsdp True`` (dp 2), each rank's parameters
        and optimizer state within half of one process's plus the
        embedding's;

    (a), (b) and (c) run at once (six ranks on the card), with the
    one-process fp32 references beside them and then ``beside`` (the
    phases of this process that need none of 5t's results; the ranks wait
    on gloo through host memory and leave the card mostly idle, so those
    phases' times share the card and the host with them); the ring is held
    next, then each pair by :func:`_check_sharded_pair` as soon as it
    ends."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo

    out = {}

    def timed_step(label):
        t = time.perf_counter()
        return lambda: log(f"5t step {label}: {time.perf_counter() - t:.1f} s")

    done = timed_step("a, b and c, the ring and the two pairs at once")
    ring = _launch_ranks("5t ring", tmp, _ring_rank, seed)
    # (b) and (c): the two pairs
    shared = dp["shared"]
    pairs = {"tp": ("mp=2", ("--model_parallel", "2"), [[16, 4]]),
             "fsdp": ("fsdp", ("--fsdp", "True"), [[32, 8]])}
    stages, launched = {}, {"ring": ring}
    try:
        for key, (_, flags, _) in pairs.items():
            stages[key] = _pair_stages(ckpt_cut, dp["train_dp"], dp["pairs"], tmp, seed, key,
                                       shared["stage2_start"], flags, fp32=key == "tp")
            launched[key] = _launch_ranks(f"5t {key}", tmp, _dp_rank, f"5t {key}", stages[key])
        # while they run: one process's stages in fp32 with plain attention,
        # for (b)'s fp32 stages, then the phases beside
        for stage, main, argv in (
                ("stage1_fp32", run_contrastive.main,
                 _feature_argv(ckpt_cut, dp["train_dp"],
                               os.path.join(tmp, "dp_stage1_w1_fp32"), seed, "stage1",
                               FP32_STAGE1_STEPS, *FP32_FLAGS)),
                ("stage2_fp32", run_rankpo.main,
                 _feature_argv(shared["stage2_start"], dp["pairs"],
                               os.path.join(tmp, "dp_stage2_w1_fp32"), seed, "stage2",
                               DP_STEPS[1], *FP32_FLAGS))):
            with _capture_trainers() as seen:
                n = shared["runs"][stage] = run_feature(f"5t W=1 {stage} reference", main,
                                                        argv, keep=True)
                n["state_bytes"] = _state_bytes(seen[-1]["trainer"])
                n["param_bytes"] = sum(p.numel() * p.element_size()
                                       for p in seen[-1]["trainer"].params)
                del seen
            shared["dirs"][stage] = argv[argv.index("--output_dir") + 1]
        if beside is not None:
            beside()
        ranks, _ = _join_ranks(ring)
    except BaseException:
        for one in launched.values():
            _kill_ranks(one)
        raise
    # ---- (a) the ring ----
    r0, r1 = ranks
    counts = [(r["launches"]["flash_fwd"], r["launches"]["flash_dq"],
               r["f32_launches"]["flash_dkv"]) for r in ranks]
    # every K3b launch of the ring is the fp32 build's
    launched_dkv = [r["launches"]["flash_dkv"] for r in ranks]
    for name, (e, tol) in r0["errors"].items():
        log(f"5t ring {RING_SHAPE} causal over 2 ranks: {name} max|ring - one process| "
            f"{e:.3e} (limit {tol:.3e})")
    hops = r0["hops"]
    log(f"5t ring: K1/K3a/K3b fp32 launches per rank {counts} (want (1, 1, 1), (2, 2, 2)); "
        f"both ranks bit-equal {r0['digests'] == r1['digests']}; ring of one bit-equal to "
        f"flash_attention {r0['solo_bit_equal']}; ring forward + backward "
        f"{r0['ring_s']:.4f} / {r1['ring_s']:.4f} s per rank (two ranks sharing one card), "
        f"one process {r0['one_s']:.4f} s (median of {RING_TIMED}, host clock); rank 0's "
        f"hops in the counted run: {hops['hops']}, {hops['bytes'] / 1e6:.1f} MB sent, "
        f"{hops['seconds']:.4f} s (gloo: through the host); these times beside (b)'s and "
        f"(c)'s ranks")
    if not (all(e <= tol for e, tol in r0["errors"].values())
            and r0["digests"] == r1["digests"] and r0["solo_bit_equal"]
            and counts == [(1, 1, 1), (2, 2, 2)] and launched_dkv == [1, 2]):
        for key in pairs:
            _kill_ranks(launched[key])
        raise AssertionError(f"5t ring: {r0['errors']}, launches {counts}")
    out["ring"] = ranks
    # ---- (b) tensor parallelism, (c) fsdp: mp 2's checks while fsdp still runs ----
    for key, (label, _, heads) in pairs.items():
        try:
            pair = _shared_pair(ckpt_cut, stages[key], *_join_ranks(launched[key]), shared)
            out[key] = _check_sharded_pair(ckpt_cut, tmp, seed, dp, key, label, heads, pair)
        except BaseException:
            for other in pairs:
                _kill_ranks(launched[other])
            raise
    done()
    for path in (*shared["dirs"].values(), shared["stage2_start"]):
        shutil.rmtree(path)
    launches = {name: sum(r[stage]["launches"][name] for key in ("tp", "fsdp")
                          for r in out[key]["ranks"] for stage in r)
                + sum(out[key]["resumed"]["launches"][name] for key in ("tp", "fsdp"))
                for name in KERNELS}
    for name in ("flash_fwd", "flash_dq"):
        launches[name] += sum(r["launches"][name] for r in ranks)
    out["launches"] = launches
    out["dkv_f32_launches"] = sum(r["f32_launches"]["flash_dkv"] for r in ranks)
    return out


def phase_dp_witness(tmp: str, seed: int) -> dict:
    """The evidence behind 5d(b)'s limits, run alone by ``python3
    chip_smoke.py --dp_witness`` (about 6 minutes on one card), on the
    FEATURE_LAYERS checkpoint:

    - the sound pair: 5d(b)'s :func:`_dp_pair` in bf16, as the smoke runs it;
    - a control, one process on data that differ as a wrong exchange or
      sampling would make them: stage 1 on the same rows with the other 3
      of their 7 negatives (the call-12 fault), stage 2 on the preference
      pairs in another order (``--seed`` + 1), each held to the sound
      pair's one-process run as the ranks are (history and update gaps);
    - the witness: the same pair with ``--bf16 False --attn_impl plain``
      (fp32 products, the plain attention: no kernel runs), which must
      hold JAX's rtol 2e-4 over every step of both stages.

    Fails unless the witness holds and, for each stage, the sound pair's
    largest history gap and worst update gap lie at or under
    DP_HISTORY_RTOL and DP_UPDATE_GAP and the control's above them."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo

    ckpt_cut, _ = make_model_checkpoint(tmp, seed, "llama-3.2-1b", FEATURE_LAYERS, False)
    train, pairs = write_training_data(tmp, seed)
    train_dp = _dp_rows(train, tmp, slice(0, 3), "train_dp.jsonl")
    train_other = _dp_rows(train, tmp, slice(3, 6), "train_other.jsonl")
    out = {}
    pair = _dp_pair(ckpt_cut, train_dp, pairs, tmp, seed, "bf16")
    out["bf16"] = _dp_compare(pair)
    losses = {"bf16": pair["ranks"][0]}
    _, ref1, dp1 = pair["dirs"]["stage1"]
    _, ref2, dp2 = pair["dirs"]["stage2"]
    control = {}
    for stage, main, argv, start, ref in (
            ("stage1", run_contrastive.main, _feature_argv(
                ckpt_cut, train_other, os.path.join(tmp, "control1"), seed, "stage1",
                DP_STEPS[0]), ckpt_cut, ref1),
            ("stage2", run_rankpo.main, _feature_argv(
                dp1, pairs, os.path.join(tmp, "control2"), seed + 1, "stage2", DP_STEPS[1]),
             dp1, ref2)):
        n = run_feature(f"5d control {stage}", main, argv, keep=True)
        got = argv[argv.index("--output_dir") + 1]
        control[stage] = {"rel": _history_gaps(n["history"], pair["one"][stage]["history"]),
                          "update": _update_gaps(start, ref, got)}
        shutil.rmtree(got)
    out["control"] = control
    for path in (ref1, dp1, ref2, dp2):
        shutil.rmtree(path)
    pair = _dp_pair(ckpt_cut, train_dp, pairs, tmp, seed, "fp32", "--bf16", "False",
                    "--attn_impl", "plain")
    out["fp32"] = _dp_compare(pair)
    losses["fp32"] = pair["ranks"][0]
    for path in (*pair["dirs"]["stage1"][1:], *pair["dirs"]["stage2"][1:]):
        shutil.rmtree(path)
    for stage in ("stage1", "stage2"):
        for label in ("bf16", "fp32"):
            c = out[label][stage]
            log(_dp_line(f"5d witness {label} pair {stage}", c) + f"; the ranks' logs "
                f"identical: {c['ranks_equal']}; losses "
                f"{[round(h['loss'], 6) for h in losses[label][stage]['history']]}")
        log(_dp_line(f"5d witness control {stage} (one process on other data)",
                     control[stage]))
    log(f"5d witness: the fp32 pair's replicas bit-equal: {out['fp32']['replicas']}")
    failed = []
    if not (out["fp32"]["replicas"] and all(
            out["fp32"][s]["ranks_equal"] and max(out["fp32"][s]["rel"]["loss"]
                                                  + out["fp32"][s]["rel"]["grad_norm"]) <= 2e-4
            for s in ("stage1", "stage2"))):
        failed.append("the fp32 pair does not hold rtol 2e-4 over every step")
    for stage in ("stage1", "stage2"):
        for key, limit, stat in (
                ("history", DP_HISTORY_RTOL, lambda c: max(c["rel"]["loss"]
                                                           + c["rel"]["grad_norm"])),
                ("update", DP_UPDATE_GAP, lambda c: c["update"]["worst"])):
            sound, wrong = stat(out["bf16"][stage]), stat(control[stage])
            log(f"5d witness {stage} {key}: sound pair {sound:.4e} <= limit {limit} < "
                f"control {wrong:.4e}: {sound <= limit < wrong}")
            if not sound <= limit < wrong:
                failed.append(f"{stage} {key}: sound {sound}, limit {limit}, control {wrong}")
    if failed:
        raise AssertionError(f"5d witness: {failed}")
    return out


def phase_training_bge(tmp: str, seed: int) -> dict:
    """Phase 5b, bge-m3 at full width and depth: stage 1 through
    ``run_contrastive.main`` with the config's dropout live (so attention
    runs the plain path with attention-probs dropout, as the JAX dispatcher
    sends it to XLA, and no flash kernel launches), then stage 2 through
    ``run_rankpo.main`` on stage 1's output with ``--disable_dropout`` under
    ``torch.use_deterministic_algorithms`` (K1, K3a, K3b); finite losses,
    every parameter moved, the outputs load; one stage-1 micro-batch with
    dropout off through the kernels and through plain
    (``phase_flash_vs_plain``)."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.models.config import EncoderConfig

    ckpt, base_state = make_model_checkpoint(tmp, seed, "bge-m3")
    config = EncoderConfig.from_pretrained(ckpt)
    train, pairs = write_training_data(tmp, seed)
    s1, s2 = os.path.join(tmp, "bge_stage1"), os.path.join(tmp, "bge_stage2")
    common = ["--tokenizer_name", f"hash:{config.vocab_size}", "--bf16", "True",
              "--max_steps", str(BGE_STEPS), "--per_device_train_batch_size", "8",
              "--learning_rate", "1e-5", "--max_query_length", "128",
              "--max_passage_length", "512", "--save_strategy", "no", "--seed", str(seed),
              "--device", "cuda", "--log_level", "warning"]
    stage1, s1_state = run_stage(
        "bge-m3 stage 1 (contrastive, dropout live: plain attention)", run_contrastive.main,
        ["--model_name_or_path", ckpt, "--train_data", train, "--output_dir", s1,
         "--num_negatives", "3", "--gradient_accumulation_steps", "2",
         "--temperature", "0.02", "--gradient_checkpointing", "True", *common],
        s1, base_state, steps=BGE_STEPS)
    log(f"bge-m3 stage 1: hidden dropout {config.hidden_dropout}, attention-probs dropout "
        f"{config.attention_dropout}, live on every step: attention ran the plain path "
        f"with dropout (the JAX dispatch), flash launches {stage1['launches']}")
    if any(stage1["launches"].values()):
        raise AssertionError("bge-m3 stage 1 launched a flash kernel with dropout live")
    stage2, _ = run_stage(
        "bge-m3 stage 2 (RankPO, disable_dropout, deterministic: split backward)",
        run_rankpo.main,
        ["--model_name_or_path", s1, "--train_data", pairs, "--output_dir", s2,
         "--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
         "--reference_free", "True", "--disable_dropout", "True", *common],
        s2, s1_state, deterministic=True, steps=BGE_STEPS)
    del s1_state
    layers = config.num_hidden_layers
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        if stage2["launches"][kernel] < layers * 2 * BGE_STEPS:
            raise AssertionError(f"bge-m3 stage 2: {kernel} launched "
                                 f"{stage2['launches'][kernel]} times")
    log(f"bge-m3 stage 2 kernel launches: {stage2['launches']}")
    model, compare = phase_flash_vs_plain(config, base_state, train, seed, ckpt)
    del model, base_state
    shutil.rmtree(s1)
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage1": stage1, "stage2": stage2, "compare": compare, "stage2_dir": s2}


def write_long_training_data(tmp: str, seed: int):
    """Phase 5w's data: MISTRAL_TRAIN["rows"] contrastive rows (a query of 4-32
    words, 1 positive and 1 negative) and MISTRAL_TRAIN["pairs"] preference
    pairs, every passage MISTRAL_TRAIN["words"] words long (past the 4096-key
    window; one token a word, plus CLS)."""
    rng = np.random.default_rng(seed + 9)
    lo, hi = MISTRAL_TRAIN["words"]
    train = os.path.join(tmp, "long_train.jsonl")
    with open(train, "w") as f:
        for _ in range(MISTRAL_TRAIN["rows"]):
            f.write(json.dumps({"query": _text(rng, 4, 33), "positives": [_text(rng, lo, hi)],
                                "negatives": [_text(rng, lo, hi)]}) + "\n")
    pairs = os.path.join(tmp, "long_pairs.jsonl")
    with open(pairs, "w") as f:
        for _ in range(MISTRAL_TRAIN["pairs"]):
            f.write(json.dumps({
                "query": _text(rng, 4, 33), "passage1": _text(rng, lo, hi),
                "passage2": _text(rng, lo, hi),
                "preferred": "AB"[int(rng.integers(2))]}) + "\n")
    return train, pairs


def phase_training_mistral(tmp: str, seed: int) -> dict:
    """Phase 5w, e5-mistral-7b-instruct at full width and MISTRAL_TRAIN_LAYERS
    layers (a full fine-tune of 7B with AdamW does not fit one card):
    MISTRAL_STEPS steps of stage 1 through ``run_contrastive.main`` (K1, K2
    with the window) then of stage 2 through ``run_rankpo.main`` on stage
    1's output under ``torch.use_deterministic_algorithms`` (K1, K3a, K3b
    with the window), every passage past the window; finite losses, every
    parameter moved, the outputs load, windowed launches on every layer;
    one stage-1 micro-batch through the kernels and through plain
    (``phase_flash_vs_plain``, checkpointed)."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.models.config import EncoderConfig

    ckpt, base_state = make_model_checkpoint(tmp, seed, MISTRAL, layers=MISTRAL_TRAIN_LAYERS)
    config = EncoderConfig.from_pretrained(ckpt)
    train, pairs = write_long_training_data(tmp, seed)
    s1, s2 = os.path.join(tmp, "mistral_stage1"), os.path.join(tmp, "mistral_stage2")
    log(f"e5-mistral training: depth cut from {MODELS[MISTRAL]['num_hidden_layers']} to "
        f"{config.num_hidden_layers} layers (AdamW's fp32 state of 7B parameters does not fit "
        f"one card); passages of {MISTRAL_TRAIN['words']} words, max_passage_length "
        f"{MISTRAL_TRAIN['max_passage']}, past the window of {config.sliding_window}")
    common = ["--tokenizer_name", f"hash:{config.vocab_size}", "--bf16", "True",
              "--max_steps", str(MISTRAL_STEPS), "--per_device_train_batch_size", "2",
              "--learning_rate", "1e-5", "--max_query_length", "64",
              "--max_passage_length", str(MISTRAL_TRAIN["max_passage"]),
              "--gradient_checkpointing", "True", "--save_strategy", "no",
              "--seed", str(seed), "--device", "cuda", "--log_level", "warning"]
    stage1, s1_state = run_stage(
        "e5-mistral stage 1 (contrastive, window, fused backward)", run_contrastive.main,
        ["--model_name_or_path", ckpt, "--train_data", train, "--output_dir", s1,
         "--num_negatives", "1", "--temperature", "0.02", "--flash_bwd_impl", "fused",
         *common],
        s1, base_state, steps=MISTRAL_STEPS)
    stage2, _ = run_stage(
        "e5-mistral stage 2 (RankPO, window, deterministic: split backward)",
        run_rankpo.main,
        ["--model_name_or_path", s1, "--train_data", pairs, "--output_dir", s2,
         "--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
         "--reference_free", "True", *common],
        s2, s1_state, deterministic=True, steps=MISTRAL_STEPS)
    del s1_state
    shutil.rmtree(s1)
    layers = config.num_hidden_layers
    # 2 fields (query, passage) x steps; stage 1 also runs each forward
    # again in the checkpointed backward
    need = {"stage1": {"flash_fwd": 2 * layers * 2 * MISTRAL_STEPS,
                       "flash_bwd_fused": layers * 2 * MISTRAL_STEPS},
            "stage2": {"flash_fwd": 2 * layers * 2 * MISTRAL_STEPS,
                       "flash_dq": layers * 2 * MISTRAL_STEPS,
                       "flash_dkv": layers * 2 * MISTRAL_STEPS}}
    for stage, nums in (("stage1", stage1), ("stage2", stage2)):
        for kernel, least in need[stage].items():
            if nums["window_launches"][kernel] < least:
                raise AssertionError(
                    f"e5-mistral {stage}: {kernel} ran {nums['window_launches'][kernel]} "
                    f"windowed launches, expected >= {least}")
        log(f"e5-mistral {stage} kernel launches: {nums['launches']}; with the window "
            f"{nums['window_launches']}")
    model, compare = phase_flash_vs_plain(
        config, base_state, train, seed, ckpt, n_rows=1, negatives=1,
        lengths=(64, MISTRAL_TRAIN["compare_passage"]), checkpointing=True)
    del model, base_state
    shutil.rmtree(ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage1": stage1, "stage2": stage2, "compare": compare, "stage2_dir": s2}


def phase_training_qwen2(tmp: str, seed: int, ckpt: str, base_state: dict) -> dict:
    """Phase 5q, Qwen2-1.5B at full width and OTHER_LAYERS of its 28 layers:
    QWEN2_STEPS stage-1
    steps through ``run_contrastive.main`` (K1, K3a and K3b at D 128, 6
    query heads per kv head); finite losses, every parameter moved."""
    from rankpo_tpu_torch.cli import run_contrastive
    from rankpo_tpu_torch.models.config import EncoderConfig

    config = EncoderConfig.from_pretrained(ckpt)
    train, _ = write_training_data(tmp, seed)
    out = os.path.join(tmp, "qwen2_stage1")
    stage1, _ = run_stage(
        "qwen2-1.5b stage 1 (contrastive, split backward)", run_contrastive.main,
        ["--model_name_or_path", ckpt, "--train_data", train, "--output_dir", out,
         "--tokenizer_name", f"hash:{config.vocab_size}", "--bf16", "True",
         "--max_steps", str(QWEN2_STEPS), "--per_device_train_batch_size", "8",
         "--gradient_accumulation_steps", "2", "--num_negatives", "3",
         "--learning_rate", "1e-5", "--temperature", "0.02",
         "--max_query_length", "128", "--max_passage_length", "512",
         "--gradient_checkpointing", "True", "--save_strategy", "no", "--seed", str(seed),
         "--device", "cuda", "--log_level", "warning"],
        out, base_state, steps=QWEN2_STEPS)
    layers = config.num_hidden_layers
    need = {"flash_fwd": 2 * layers * 2 * 2 * QWEN2_STEPS,
            "flash_dq": layers * 2 * 2 * QWEN2_STEPS,
            "flash_dkv": layers * 2 * 2 * QWEN2_STEPS}
    for kernel, least in need.items():
        if stage1["launches"][kernel] < least:
            raise AssertionError(f"qwen2-1.5b stage 1: {kernel} launched "
                                 f"{stage1['launches'][kernel]} times, expected >= {least}")
    log(f"qwen2-1.5b stage 1 kernel launches: {stage1['launches']}")
    shutil.rmtree(out)
    return {"stage1": stage1}


def phase_training_gemma(tmp: str, seed: int, ckpt: str, base_state: dict) -> dict:
    """Phase 5g, google/gemma-2b at full width (head_dim 256) and
    GEMMA_LAYERS of its 18 layers:
    GEMMA_STEPS steps of stage 1 through ``run_contrastive.main`` (K1, K2)
    then of stage 2 through ``run_rankpo.main`` on stage 1's output under
    ``torch.use_deterministic_algorithms`` (K1, K3a, K3b), at the Llama
    stage shapes (phase 5); finite losses, every parameter moved, the
    outputs load, launches at head_dim 256 on every layer; one stage-1
    micro-batch through the kernels, through plain and in fp32
    (``phase_flash_vs_plain``)."""
    from rankpo_tpu_torch.cli import run_contrastive, run_rankpo
    from rankpo_tpu_torch.models.config import EncoderConfig

    config = EncoderConfig.from_pretrained(ckpt)
    train, pairs = write_training_data(tmp, seed)
    s1, s2 = os.path.join(tmp, "gemma_stage1"), os.path.join(tmp, "gemma_stage2")
    common = ["--tokenizer_name", f"hash:{config.vocab_size}", "--bf16", "True",
              "--max_steps", str(GEMMA_STEPS), "--per_device_train_batch_size", "8",
              "--learning_rate", "1e-5", "--max_query_length", "128",
              "--max_passage_length", "512", "--save_strategy", "no", "--seed", str(seed),
              "--device", "cuda", "--log_level", "warning"]
    stage1, s1_state = run_stage(
        "gemma-2b stage 1 (contrastive, fused backward)", run_contrastive.main,
        ["--model_name_or_path", ckpt, "--train_data", train, "--output_dir", s1,
         "--num_negatives", "3", "--gradient_accumulation_steps", "2",
         "--temperature", "0.02", "--gradient_checkpointing", "True",
         "--flash_bwd_impl", "fused", *common],
        s1, base_state, steps=GEMMA_STEPS)
    stage2, _ = run_stage(
        "gemma-2b stage 2 (RankPO, deterministic: split backward)", run_rankpo.main,
        ["--model_name_or_path", s1, "--train_data", pairs, "--output_dir", s2,
         "--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
         "--reference_free", "True", *common],
        s2, s1_state, deterministic=True, steps=GEMMA_STEPS)
    del s1_state
    shutil.rmtree(s1)
    layers = config.num_hidden_layers
    # 2 fields (query, passage) x micro-steps; stage 1 (accumulation 2) also
    # runs each forward again in the checkpointed backward
    need = {"stage1": {"flash_fwd": 2 * layers * 2 * 2 * GEMMA_STEPS,
                       "flash_bwd_fused": layers * 2 * 2 * GEMMA_STEPS},
            "stage2": {"flash_fwd": 2 * layers * GEMMA_STEPS,
                       "flash_dq": 2 * layers * GEMMA_STEPS,
                       "flash_dkv": 2 * layers * GEMMA_STEPS}}
    for stage, nums in (("stage1", stage1), ("stage2", stage2)):
        for kernel, least in need[stage].items():
            if nums["d256_launches"][kernel] < least:
                raise AssertionError(
                    f"gemma-2b {stage}: {kernel} ran {nums['d256_launches'][kernel]} "
                    f"launches at head_dim 256, expected >= {least}")
        log(f"gemma-2b {stage} kernel launches: {nums['launches']}; at head_dim 256 "
            f"{nums['d256_launches']}")
    model, compare = phase_flash_vs_plain(config, base_state, train, seed, ckpt,
                                          checkpointing=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage1": stage1, "stage2": stage2, "compare": compare, "stage2_dir": s2}


def make_model_checkpoint(tmp: str, seed: int, name: str, layers=None,
                          host_state: bool = True):
    """Random weights of MODELS[name] from the seed (``layers`` cuts the
    depth; Gemma's norm offsets drawn N(0, GEMMA_NORM_STD)), written in bf16
    with the port's save_pretrained. Returns (path, the state on the host,
    or None without ``host_state``)."""
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.models.encoder import init_params, n_params
    from rankpo_tpu_torch.models.hf_io import save_pretrained

    config = EncoderConfig(**MODELS[name])
    if layers is not None:
        config = dataclasses.replace(config, num_hidden_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_params(config, gen, dtype=torch.bfloat16)
    if config.is_gemma:  # the (1 + w) offsets away from their zero init
        for n, t in state.items():
            if n.endswith("norm.weight"):
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * GEMMA_NORM_STD)
    ckpt = os.path.join(tmp, name if layers is None else f"{name}-{layers}-layers")
    save_pretrained(ckpt, config, state, dtype=torch.bfloat16)
    state = {n: t.cpu() for n, t in state.items()} if host_state else None
    torch.cuda.empty_cache()
    log(f"checkpoint {name}: {config.num_hidden_layers} layers, "
        f"{n_params(config) / 1e9:.3f}B parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s to make and write")
    return ckpt, state


# ---------------------------------------------------------------------------
def write_eval_queries(tmp: str, seed: int, corpus):
    """N_EVAL_QUERIES queries, each a span of 4-32 words cut from one
    passage of ``corpus`` and labelled with that passage's index."""
    rng = np.random.default_rng(seed + 3)
    path = os.path.join(tmp, "eval_queries.jsonl")
    queries, labels, lines = [], [], []
    for _ in range(N_EVAL_QUERIES):
        i = int(rng.integers(len(corpus)))
        words = corpus[i].split()
        n = min(len(words), int(rng.integers(4, 33)))
        lo = int(rng.integers(len(words) - n + 1))
        queries.append(" ".join(words[lo : lo + n]))
        labels.append([i])
        lines.append(json.dumps({"query": {"text": queries[-1]},
                                 "positives": {"index": labels[-1]}}) + "\n")
    _write_lines(path, lines)
    return path, queries, labels


def _sklearn_paths() -> str:
    """Which metric and k-means paths the port takes on this machine."""
    from rankpo_tpu_torch.eval import metrics

    try:
        import sklearn.cluster  # noqa: F401
        kmeans = "sklearn KMeans"
    except ImportError:
        kmeans = "the numpy Lloyd fallback"
    metric = "sklearn" if metrics._HAS_SKLEARN else "the numpy fallbacks"
    return f"metrics through {metric}, k-means through {kmeans}"


EVAL_TIERS = {"flat": [], "ivf": ["--index_type", "ivf"],
              "refine": ["--index_type", "refine"]}


def phase_evaluate(seed: int, tmp: str, ckpt: str, tiers=tuple(EVAL_TIERS),
                   nccl_flat: bool = False) -> dict:
    """The evaluation path: ``rankpo_tpu_torch.cli.evaluate`` over the
    serving corpus and N_EVAL_QUERIES span queries, flat (K1), then
    ``--index_type ivf`` (K1, K4) and ``--index_type refine`` (K1), or the
    ``tiers`` asked for, from a checkpoint of any ported body. The saved metrics must be bit-equal to
    ``compute_metrics`` recomputed on the host over the saved arrays, and
    the flat hits equal to numpy_search over the embeddings the CLI made
    (read from its encoder as it returns them) outside SCORE_ATOL
    near-ties. Each encode is timed in the run (a sync on either side).
    ``nccl_flat``: the flat call runs with the three process flags at
    world size 1 (an NCCL group of one, the sharded index over it, the
    group destroyed after), held by the same checks."""
    from rankpo_tpu_torch.cli import evaluate
    from rankpo_tpu_torch.eval.metrics import compute_metrics
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.ops import ivf_gather

    config = EncoderConfig.from_pretrained(ckpt)
    layers = config.num_hidden_layers
    corpus, corpus_file, _ = _serving_data(seed, tmp)
    query_file, _, labels = write_eval_queries(tmp, seed, corpus)
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", f"hash:{config.vocab_size}",
              "--query_data", query_file, "--corpus_data", corpus_file, "--bf16",
              "--k", "100", "--batch_size", "64", "--max_query_length", "64",
              "--max_passage_length", "512", "--device", "cuda", "--log_level", "warning"]
    encode_device = InferenceEncoder.encode_device
    encodes = []  # (embeddings on the card, rows, seconds) per encode of the run

    def timed_encode(self, sentences, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        emb, n = encode_device(self, sentences, **kwargs)
        torch.cuda.synchronize()
        encodes.append((emb, n, time.perf_counter() - t))
        return emb, n

    out = {}
    for tier in tiers:
        extra = EVAL_TIERS[tier]
        out_dir = os.path.join(tmp, f"eval_{config.model_type}_{tier}")
        encodes.clear()
        gc.collect()
        torch.cuda.empty_cache()
        # ---- the evaluate path: counters from 0, the CLI, counters read ----
        flash.reset_launches()
        ivf_gather.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        InferenceEncoder.encode_device = timed_encode
        if nccl_flat and tier == "flat":
            extra = [*extra, "--coordinator_address", f"127.0.0.1:{_free_port()}",
                     "--num_processes", "1", "--process_id", "0"]
        t0 = time.perf_counter()
        try:
            results = evaluate.main([*common, "--output_dir", out_dir, *extra])
            torch.cuda.synchronize()
            if "--num_processes" in extra:
                import torch.distributed as dist

                if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                    raise AssertionError(f"evaluate: the CLI made a {dist.get_backend()} "
                                         f"group of {dist.get_world_size()}, not NCCL of 1")
        finally:
            InferenceEncoder.encode_device = encode_device
            if "--num_processes" in extra:
                import torch.distributed as dist

                if dist.is_initialized():
                    dist.destroy_process_group()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash.launches["flash_fwd"],
                    "ivf_probe_scores": ivf_gather.launches["ivf_probe_scores"]}
        windowed = flash.window_launches["flash_fwd"]
        d256 = flash.d256_launches["flash_fwd"]
        # ---- end of the evaluate path ----
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stem = os.path.join(out_dir, os.path.basename(ckpt), "main")
        with open(stem + ".json") as f:
            saved = json.load(f)
        idx, scores = np.load(stem + "-indices.npy"), np.load(stem + "-scores.npy")
        if idx.shape != (N_EVAL_QUERIES, 100) or idx.dtype != np.int64 \
                or scores.dtype != np.float32 or not np.isfinite(scores).all():
            raise AssertionError(f"evaluate ({tier}): bad arrays {idx.shape} {idx.dtype} "
                                 f"{scores.dtype}")
        t_metrics = time.perf_counter()
        host = compute_metrics(idx, scores, labels, cutoffs=EVAL_CUTOFFS)
        t_metrics = time.perf_counter() - t_metrics
        if saved != host or results["main"] != host:
            raise AssertionError(f"evaluate ({tier}): saved metrics differ from the "
                                 "host recompute over the saved arrays")
        n_batches = -(-N_PASSAGES // 64) + -(-N_EVAL_QUERIES // 64)
        if launches["flash_fwd"] < layers * n_batches:
            raise AssertionError(f"evaluate ({tier}): flash_fwd launched "
                                 f"{launches['flash_fwd']} times, expected >= "
                                 f"{layers * n_batches}")
        if config.sliding_window is not None and windowed < layers * n_batches:
            raise AssertionError(f"evaluate ({tier}): K1 ran {windowed} windowed launches")
        if config.head_dim == 256 and d256 < layers * n_batches:
            raise AssertionError(f"evaluate ({tier}): K1 ran {d256} launches at head_dim 256")
        if tier == "ivf" and launches["ivf_probe_scores"] <= 0:
            raise AssertionError("evaluate (ivf): ivf_probe_scores was not launched")
        if [n for _, n, _ in encodes] != [N_EVAL_QUERIES, N_PASSAGES]:
            raise AssertionError(f"evaluate ({tier}): encodes of {[n for _, n, _ in encodes]}")
        (q_emb, _, q_s), (c_emb, _, c_s) = encodes
        log(f"evaluate ({config.model_type}, {tier}"
            + (", NCCL world size 1" if "--num_processes" in extra else "")
            + f"): {N_EVAL_QUERIES} queries over {N_PASSAGES} passages in "
            f"{wall:.2f} s wall = {N_EVAL_QUERIES / wall:.1f} queries/s, "
            f"{N_PASSAGES / wall:.1f} passages/s (query encode {q_s:.3f} s, corpus encode "
            f"{c_s:.3f} s, the rest checkpoint load, index, search, metrics and files); "
            f"peak {peak_gib:.2f} GiB; launches {launches}"
            + ("" if config.sliding_window is None else f" ({windowed} windowed)")
            + ("" if config.head_dim != 256 else f" ({d256} at head_dim 256)")
            + "; metrics bit-equal to the host "
            f"recompute ({t_metrics:.3f} s): MRR@10 {host['MRR@10']:.4f}, Recall@100 "
            f"{host['Recall@100']:.4f}, AUC@100 {host['AUC@100']:.4f}, nDCG@10 "
            f"{host['nDCG@10']:.4f}")
        out[tier] = {"wall_s": wall, "queries_per_s": N_EVAL_QUERIES / wall,
                     "passages_per_s": N_PASSAGES / wall, "peak_mem_gib": peak_gib,
                     "launches": launches, "window_launches": windowed, "d256_launches": d256,
                     "idx": idx, "scores": scores,
                     "metrics_s": t_metrics, "encode_s": {"queries": q_s, "corpus": c_s}}
        if tier == "flat":
            q_host, c_host = q_emb.cpu().numpy(), c_emb.cpu().numpy()
        encodes.clear()

    # the flat hits against the exact numpy search over the CLI's embeddings
    o_scores, o_idx = numpy_search(c_host, q_host, 101)
    n_near = _check_against_oracle(out["flat"]["idx"], out["flat"]["scores"], o_scores, o_idx)
    overlap = ", ".join(
        f"{tier} hits share " + "{:.4f}".format(np.mean([
            len(set(a) & set(b)) / 100 for a, b in
            zip(out[tier]["idx"].tolist(), out["flat"]["idx"].tolist())]))
        for tier in tiers if tier != "flat")
    log(f"evaluate ({config.model_type}, flat): hits equal to numpy_search over the same "
        f"embeddings ({n_near} hits inside {SCORE_ATOL} near-ties not compared); "
        + (f"{overlap} of the flat top-100 (random weights: printed, not held); "
           if overlap else "") + _sklearn_paths())
    for tier in out:
        del out[tier]["idx"], out[tier]["scores"]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_mining_data(tmp: str, seed: int):
    """N_MINING_ROWS mining rows (a query of 4-32 words, 1-2 positives and one
    old negative of 16-256 words); the first N_PIPELINE_ROWS of them as
    run_pipeline's input, with an eval-format query and corpus file over
    their deduplicated passages for its prediction pairs."""
    from rankpo_tpu_torch.data.datasets import load_mining_rows

    rng = np.random.default_rng(seed + 4)
    rows = [{"query": {"text": _text(rng, 4, 33)},
             "positives": {"text": [_text(rng, 16, 257)
                                    for _ in range(int(rng.integers(1, 3)))]},
             "negatives": {"text": [_text(rng, 16, 257)]}}
            for _ in range(N_MINING_ROWS)]
    mining, raw = os.path.join(tmp, "mining.jsonl"), os.path.join(tmp, "pipeline_raw.jsonl")
    for path, part in ((mining, rows), (raw, rows[:N_PIPELINE_ROWS])):
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in part)
    _, _, corpus = load_mining_rows(raw)
    where = {text: i for i, text in enumerate(corpus)}
    queries, corpus_file = (os.path.join(tmp, f"pipeline_{n}.jsonl")
                            for n in ("queries", "corpus"))
    with open(queries, "w") as f:
        f.writelines(json.dumps({"query": r["query"], "positives": {
            "index": [where[t] for t in r["positives"]["text"]]}}) + "\n"
            for r in rows[:N_PIPELINE_ROWS])
    with open(corpus_file, "w") as f:
        f.writelines(json.dumps({"text": t}) + "\n" for t in corpus)
    return mining, raw, queries, corpus_file, rows


def phase_mining(seed: int, tmp: str, ckpt: str, eval_queries: str,
                 pipeline_ckpt: str, kept: Optional[dict] = None) -> dict:
    """The mining and prediction paths: ``get_hard_negatives`` (topk and
    cluster, λ 0.5) over N_MINING_ROWS rows, ``get_predictions`` over the
    eval queries and the serving corpus, then ``run_pipeline --iterations
    2`` over N_PIPELINE_ROWS rows at full width from ``pipeline_ckpt`` (4
    of 16 layers in the smoke; random bootstrap, stage-1 training, mining
    with the fresh model, training again, prediction pairs). Every mined negative is neither the query nor a positive of its
    row, and every row has its count. ``kept`` receives the mining argv
    (without ``--output_prefix``) and the mined files' text, for 8's pair
    of ranks."""
    from rankpo_tpu_torch.cli import get_hard_negatives, get_predictions, run_pipeline
    from rankpo_tpu_torch.data.datasets import iter_jsonl
    from rankpo_tpu_torch.ops import flash_attention as flash

    mining, raw, p_queries, p_corpus, rows = write_mining_data(tmp, seed)
    n_neg, n_pred = 8, 5
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", "hash:128256", "--bf16",
              "--batch_size", "64", "--max_query_length", "64", "--device", "cuda",
              "--seed", str(seed), "--log_level", "warning"]
    out = {}

    def run(name, main, argv):
        gc.collect()
        torch.cuda.empty_cache()
        # ---- one path: counters from 0, the CLI, counters read ----
        flash.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(flash.launches)
        # ---- end of the path ----
        out[name] = {"wall_s": wall, "launches": launches,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if launches["flash_fwd"] <= 0:
            raise AssertionError(f"{name}: flash_fwd was not launched")
        return result

    mined_dir = os.path.join(tmp, "mined")
    mine_argv = [*common, "--input_file", mining, "--max_passage_length", "256",
                 "--method", "topk,cluster", "--lambda_", "0.5", "--num_negatives",
                 str(n_neg), "--search_range", "0-100", "--num_clusters", "10"]
    outputs = run("mining", get_hard_negatives.main,
                  [*mine_argv, "--output_prefix", mined_dir])
    if kept is not None:
        kept["argv"] = mine_argv
        kept["files"] = {name: open(path).read() for name, path in outputs.items()}
    if sorted(outputs) != ["cluster5.jsonl", "topk.jsonl"]:
        raise AssertionError(f"mining wrote {sorted(outputs)}")
    for name, path in outputs.items():
        mined = list(iter_jsonl(path))
        if len(mined) != N_MINING_ROWS:
            raise AssertionError(f"{name}: {len(mined)} rows")
        for row, src in zip(mined, rows):
            negs = row["negatives"]
            if len(negs) != n_neg or len(set(negs)) != n_neg:
                raise AssertionError(f"{name}: a row has {len(negs)} negatives")
            if row["query"] != src["query"]["text"] or any(
                    t == row["query"] or t in src["positives"]["text"] for t in negs):
                raise AssertionError(f"{name}: a mined negative is the query or a positive")
    m = out["mining"]
    log(f"mining: {N_MINING_ROWS} rows, topk and cluster (λ 0.5) files of {n_neg} "
        f"filtered negatives each, in {m['wall_s']:.2f} s wall = "
        f"{N_MINING_ROWS / m['wall_s']:.1f} rows/s; peak {m['peak_mem_gib']:.2f} GiB; "
        f"launches {m['launches']}; {_sklearn_paths()}")

    _, corpus_file, _ = _serving_data(seed, tmp)
    preds_file = os.path.join(tmp, "prediction_pairs.jsonl")
    pairs = run("predictions", get_predictions.main, [
        *common, "--query_data", eval_queries, "--corpus_data", corpus_file,
        "--output_file", preds_file, "--max_passage_length", "512",
        "--num_predictions", str(n_pred), "--search_range", "0-100"])
    want = N_EVAL_QUERIES * n_pred * (n_pred - 1) // 2
    if len(pairs) != want or sum(1 for _ in iter_jsonl(preds_file)) != want:
        raise AssertionError(f"predictions: {len(pairs)} pair rows, expected {want}")
    if any(r["passage_rank1"] >= r["passage_rank2"] for r in pairs):
        raise AssertionError("predictions: pair ranks out of order")
    p = out["predictions"]
    log(f"predictions: {want} pair rows (Q {N_EVAL_QUERIES} x C({n_pred}, 2)) in "
        f"{p['wall_s']:.2f} s wall; launches {p['launches']}")

    pipe_dir = os.path.join(tmp, "pipeline")
    final = run("pipeline", run_pipeline.main, [
        "--model_name_or_path", pipeline_ckpt, "--tokenizer_name", "hash:128256",
        "--raw_data", raw, "--output_dir", pipe_dir, "--iterations", "2",
        "--num_negatives", "3", "--search_range", "0-50",
        "--per_device_train_batch_size", "8", "--learning_rate", "1e-5",
        "--max_query_length", "64", "--max_passage_length", "256",
        "--batch_size", "64", "--query_data", p_queries, "--corpus_data", p_corpus,
        "--num_predictions", "3", "--bf16", "--gradient_checkpointing",
        "--seed", str(seed), "--device", "cuda", "--log_level", "warning"])
    if final != os.path.join(pipe_dir, "iter1"):
        raise AssertionError(f"pipeline ended at {final}")
    for path in ("iter0/model.safetensors", "iter1/model.safetensors", "iter1/README.md",
                 "mined_iter0/topk.jsonl", "train_iter0.jsonl"):
        if not os.path.isfile(os.path.join(pipe_dir, path)):
            raise AssertionError(f"pipeline: no {path}")
    history = []
    for it in (0, 1):
        with open(os.path.join(pipe_dir, f"iter{it}", "trainer_history.json")) as f:
            history += [h["loss"] for h in json.load(f)]
    n_pairs = sum(1 for _ in iter_jsonl(os.path.join(pipe_dir, "prediction_pairs.jsonl")))
    if n_pairs != N_PIPELINE_ROWS * 3 or not history or not np.all(np.isfinite(history)):
        raise AssertionError(f"pipeline: {n_pairs} pairs, losses {history}")
    pl = out["pipeline"]
    if pl["launches"]["flash_dq"] <= 0 or pl["launches"]["flash_dkv"] <= 0:
        raise AssertionError(f"pipeline: the split backward was not launched: {pl['launches']}")
    layers = json.load(open(os.path.join(pipeline_ckpt, "config.json")))["num_hidden_layers"]
    log(f"pipeline: 2 iterations over {N_PIPELINE_ROWS} rows at full width, {layers} layers, in "
        f"{pl['wall_s']:.2f} s wall; {len(history)} finite losses "
        f"{[round(x, 4) for x in history]}; {n_pairs} prediction pairs; peak device "
        f"memory {pl['peak_mem_gib']:.2f} GiB; launches {pl['launches']}")
    for path in (pipe_dir, mined_dir):
        shutil.rmtree(path)
    return out


# ---------------------------------------------------------------------------
# phases 7d, 8 (its pair) and 4d: evaluation, mining and serving over two
# ranks sharing the card under gloo (NCCL takes one rank per device)
# ---------------------------------------------------------------------------

MP_ADD = 64  # 4d: passages added over HTTP, then ids removed
MP_ALLOWED = 512  # 4d: the filtered request's allowed ids


def _mp_rank(rank: int, port: int, plan: dict, result_path: str) -> None:
    """One of the two ranks of 7d, 8's pair and 4d (started by
    ``multiprocessing`` with spawn): join the gloo group on cuda:0, then run
    ``cli.evaluate`` flat and refine on the FEATURE_LAYERS checkpoint (7d),
    one ``get_hard_negatives`` (8) and ``cli.serve`` flat at full depth
    until rank 0 takes SIGTERM (4d), each with the launch counters from 0
    just before and read just after. Kept for the parent's checks: each
    rank's shard of the corpus embeddings (``encode_shard``) and the query
    embeddings (7d), rank 0's searches (the query embeddings, the merged
    hits, the filter, whether a mutation had come first; 4d)."""
    import torch.distributed as dist

    from rankpo_tpu_torch.cli import evaluate, get_hard_negatives, serve
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.index.flat import FlatIPIndex
    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.serve.service import RetrievalService

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    originals = (InferenceEncoder.encode_shard, InferenceEncoder.encode,
                 FlatIPIndex.search_tensor, RetrievalService.add_passages)
    shards, queries, searches, state = [], [], [], {"mutated": False, "search_s": 0.0}

    def kept_shard(self, *args, **kwargs):
        emb, n = originals[0](self, *args, **kwargs)
        shards.append(emb.cpu())
        return emb, n

    def kept_encode(self, *args, **kwargs):
        out = originals[1](self, *args, **kwargs)
        queries.append(out)
        return out

    def kept_search(self, q, k, **kwargs):
        t0 = time.perf_counter()
        s_, i_ = originals[2](self, q, k, **kwargs)
        state["search_s"] += time.perf_counter() - t0  # the gather copies to the host
        sel = kwargs.get("sel")
        searches.append((q.float().cpu().numpy(), s_.cpu().numpy(), i_.cpu().numpy(),
                         None if sel is None else sel.cpu().numpy(), state["mutated"]))
        return s_, i_

    def kept_add(self, *args, **kwargs):
        state["mutated"] = True
        return originals[3](self, *args, **kwargs)

    InferenceEncoder.encode_shard, InferenceEncoder.encode = kept_shard, kept_encode
    FlatIPIndex.search_tensor, RetrievalService.add_passages = kept_search, kept_add
    out = {"device": f"{torch.cuda.current_device()} {torch.cuda.get_device_name()}",
           "steps": {}}

    def step(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        shards.clear()
        queries.clear()
        searches.clear()
        flash.reset_launches()
        mesh.reset_gather_stats()
        state["search_s"] = 0.0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["steps"][name] = {"wall_s": time.perf_counter() - t0,
                              "launches": flash.launches["flash_fwd"],
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "shard_rows": [int(x.shape[0]) for x in shards],
                              "gathers": dict(mesh.gather_stats),
                              "search_s": state["search_s"], "result": result}
        log(f"{name} rank {rank} (two ranks on one card, gloo): device {out['device']}, "
            f"shard rows {out['steps'][name]['shard_rows']}, K1 launches "
            f"{flash.launches['flash_fwd']}, peak {out['steps'][name]['peak_mem_gib']:.2f} "
            f"GiB, {out['steps'][name]['wall_s']:.1f} s")

    try:
        for tier in ("flat", "refine"):
            step(f"7d {tier}", lambda: evaluate.main(
                plan["eval_argv"] + ["--output_dir", plan["eval_dirs"][tier][rank],
                                     *EVAL_TIERS[tier]]))
            if tier == "flat":
                torch.save({"shard": shards[0], "queries": queries[0]}, plan["eval_emb"][rank])
        step("8 mining", lambda: sorted(get_hard_negatives.main(
            plan["mine_argv"] + ["--output_prefix", plan["mined"][rank]])))
        step("4d serving", lambda: serve.main(plan["serve_argv"]))
        torch.save({"shard": shards[0], "searches": searches}, plan["serve_emb"][rank])
    finally:
        (InferenceEncoder.encode_shard, InferenceEncoder.encode, FlatIPIndex.search_tensor,
         RetrievalService.add_passages) = originals
        dist.destroy_process_group()
    with open(result_path, "w") as f:
        json.dump(out, f)


def _tie_aware_recall(idx: np.ndarray, exact_scores_of, exact_kth: np.ndarray) -> float:
    """The share of returned ids whose exact score clears the exact k-th
    score less SCORE_ATOL (a hit inside a near-tie at the boundary counts)."""
    hits = [exact_scores_of(r, row) >= exact_kth[r] - SCORE_ATOL for r, row in enumerate(idx)]
    return float(np.mean(np.concatenate(hits)))


def phase_multiprocess(seed: int, tmp: str, ckpt: str, ckpt_cut: str, mining: dict) -> dict:
    """Phases 7d, 8's pair and 4d: two ranks sharing the card under gloo
    (:func:`_mp_rank`, one spawn for the three), each rank on its own row
    shard of the corpus.

    7d: ``cli.evaluate`` flat, then refine, on phase 7's FEATURE_LAYERS
        checkpoint and files: (i) each rank's shard embeddings bit-equal to
        a one-process ``encode_device`` of the shard's texts on the card;
        (ii) the flat hits equal to numpy_search over the ranks' embeddings
        outside SCORE_ATOL near-ties; (iii) the saved metrics bit-equal to
        ``compute_metrics`` recomputed on the host (and to what both ranks
        returned; rank 1 writes nothing); refine's recall against the exact
        search at storage precision (near-ties at the k-th score counted)
        at least its target 0.95; against phase 7's one-process results the
        metrics' differences and the differing top-100 ids printed (batch
        composition only: not gated).
    8:  one ``get_hard_negatives`` at W = 2 writes phase 8's files.
    4d: ``cli.serve`` flat fp32 at full width and depth (``ckpt``): /search
        from 8 clients (32 single requests), 16-query requests and one
        filtered request, hits equal to numpy_search over the ranks'
        embeddings outside near-ties, p50 and p99; /add, /remove and /save,
        SIGTERM to rank 0, both ranks exit 0; then one process restarts from
        the W = 2 file and serves the W = 2 server's hits."""
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.eval.metrics import compute_metrics
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.ops import flash_attention as flash

    corpus, corpus_file, queries = _serving_data(seed, tmp)
    query_file, _, labels = write_eval_queries(tmp, seed, corpus)
    tok = "hash:128256"
    http_port = _free_port()
    serve_argv = ["--model_name_or_path", ckpt, "--tokenizer_name", tok,
                  "--corpus_data", corpus_file, "--max_query_length", "512",
                  "--max_passage_length", "512", "--batch_size", "64", "--device", "cuda",
                  "--log_level", "warning"]
    paths = lambda name: [os.path.join(tmp, f"{name}_r{r}") for r in range(2)]  # noqa: E731
    plan = {"eval_argv": ["--model_name_or_path", ckpt_cut, "--tokenizer_name", tok,
                          "--query_data", query_file, "--corpus_data", corpus_file, "--bf16",
                          "--k", "100", "--batch_size", "64", "--max_query_length", "64",
                          "--max_passage_length", "512", "--device", "cuda",
                          "--log_level", "warning"],
            "eval_dirs": {tier: paths(f"7d_{tier}") for tier in ("flat", "refine")},
            "eval_emb": paths("7d_emb"), "mine_argv": mining["argv"], "mined": paths("8d"),
            "serve_argv": [*serve_argv, "--port", str(http_port)],
            "serve_emb": paths("4d_emb")}
    out = {}
    launched = _launch_ranks("7d 8 4d", tmp, _mp_rank, plan)
    procs = launched[1]
    # ---- 4d: the server's requests (the ranks run 7d and 8 first) ----
    t_wait = time.perf_counter()
    while True:
        if any(not p.is_alive() for p in procs):
            raise AssertionError(f"4d: a rank ended before serving: "
                                 f"{[p.exitcode for p in procs]}")
        try:
            if _http(http_port, "/healthz")[1]["ntotal"] == N_PASSAGES:
                break
        except OSError:
            pass
        if time.perf_counter() - t_wait > 900:
            raise TimeoutError("4d: the server did not come up")
        time.sleep(0.5)
    with ThreadPoolExecutor(8) as pool:
        singles = list(pool.map(lambda i: _http(http_port, "/search", {
            "query": queries[i], "k": (10, 100)[i % 2]}), range(32)))
    batched = [(_http(http_port, "/search", {"queries": queries[16 * j:16 * (j + 1)],
                                             "k": k}), k)
               for j, k in enumerate((10, 100, 10, 100))]
    rng = np.random.default_rng(seed + 40)
    allowed = np.sort(rng.choice(N_PASSAGES, MP_ALLOWED, replace=False)).tolist()
    batched.append((_http(http_port, "/search", {"queries": queries[:16], "k": 100,
                                                 "allowed_ids": allowed}), 100))
    for (status, body, _), i in zip(singles, range(32)):
        _check_reply(status, body, 1, (10, 100)[i % 2])
    for (status, body, _), k in batched:
        _check_reply(status, body, 16, k)
    added = [" ".join(rng.choice(WORDS, size=int(n))) for n in rng.integers(16, 481, MP_ADD)]
    removed = list(range(0, N_PASSAGES, N_PASSAGES // MP_ADD))
    t_mut = time.perf_counter()
    for path, payload in (("/add", {"passages": added}), ("/remove", {"ids": removed})):
        status, body, _ = _http(http_port, path, payload)
        if status != 200 or body["ntotal"] != N_PASSAGES + (MP_ADD if path == "/add" else 0):
            raise AssertionError(f"4d {path}: {status} {body}")
    final = _http(http_port, "/search", {"queries": queries[:16], "k": 100})
    _check_reply(final[0], final[1], 16, 100)
    index_file = os.path.join(tmp, "4d_index.npz")
    status, body, _ = _http(http_port, "/save", {"path": index_file})
    mutate_s = time.perf_counter() - t_mut
    if status != 200 or not os.path.isfile(index_file):
        raise AssertionError(f"4d /save: {status} {body}")
    procs[0].terminate()  # SIGTERM: rank 0 stops serving and releases rank 1
    ranks, wall = _join_ranks(launched)
    lat = np.array([r[2] for r in singles]) * 1e3
    g4 = ranks[0]["steps"]["4d serving"]
    out["serving"] = {"gather_s": g4["gathers"]["seconds"], "search_s": g4["search_s"],
                      "gathers": g4["gathers"]["calls"], "gather_bytes": g4["gathers"]["bytes"],
                      "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)),
                      "batch16_p50_ms": float(np.percentile([b[0][2] for b in batched[:4]],
                                                            50) * 1e3),
                      "mutate_s": mutate_s}
    for name in ranks[0]["steps"]:
        for r, rank in enumerate(ranks):
            if rank["steps"][name]["launches"] <= 0:
                raise AssertionError(f"{name} rank {r}: K1 was not launched")

    # ---- 7d's checks ----
    half = N_PASSAGES // 2
    embs = [torch.load(path, weights_only=False) for path in plan["eval_emb"]]
    rows = torch.cat([e["shard"] for e in embs]).numpy()[:N_PASSAGES]
    q7 = embs[0]["queries"]
    encoder = InferenceEncoder.from_pretrained(
        ckpt_cut, tokenizer=resolve_tokenizer(tok, ckpt_cut), device="cuda",
        compute_dtype=torch.bfloat16)
    for r, e in enumerate(embs):
        one = encoder.encode_device(corpus[r * half:(r + 1) * half], batch_size=64,
                                    max_length=512)[0].cpu()
        if not torch.equal(one, e["shard"][:half]):
            raise AssertionError(f"7d rank {r}: shard embeddings differ from a one-process "
                                 "encode of the shard's texts")
    del encoder
    if not np.array_equal(embs[1]["queries"], q7):
        raise AssertionError("7d: the ranks' query embeddings differ")
    base = os.path.basename(ckpt_cut)
    got = {}
    for tier in ("flat", "refine"):
        stem = os.path.join(plan["eval_dirs"][tier][0], base, "main")
        with open(stem + ".json") as f:
            saved = json.load(f)
        idx, scores = np.load(stem + "-indices.npy"), np.load(stem + "-scores.npy")
        host = compute_metrics(idx, scores, labels, cutoffs=EVAL_CUTOFFS)
        returned = [rank["steps"][f"7d {tier}"]["result"]["main"] for rank in ranks]
        if saved != host or returned != [host, host]:
            raise AssertionError(f"7d {tier}: saved metrics differ from the host recompute "
                                 "or from what the ranks returned")
        if os.path.exists(plan["eval_dirs"][tier][1]):
            raise AssertionError(f"7d {tier}: rank 1 wrote files")
        one_stem = os.path.join(tmp, f"eval_llama_{tier}", base, "main")
        one_idx = np.load(one_stem + "-indices.npy")
        with open(one_stem + ".json") as f:
            one_metrics = json.load(f)
        differing = int(sum(len(set(a) - set(b)) for a, b in zip(idx.tolist(),
                                                                 one_idx.tolist())))
        got[tier] = {"idx": idx, "scores": scores, "metrics": host, "differing": differing,
                     "metric_gaps": {k: host[k] - one_metrics[k] for k in
                                     ("MRR@10", "Recall@100", "AUC@100", "nDCG@10")}}
    o_scores, o_idx = numpy_search(rows, q7, 101)
    n_near = _check_against_oracle(got["flat"]["idx"], got["flat"]["scores"], o_scores, o_idx)
    rows_b = torch.from_numpy(rows).bfloat16().float().numpy()
    q_b = torch.from_numpy(q7).bfloat16().float().numpy()
    e_scores, _ = numpy_search(rows_b, q_b, 100)
    recall = _tie_aware_recall(got["refine"]["idx"], lambda r, ids: rows_b[ids] @ q_b[r],
                               e_scores[:, -1])
    for tier in ("flat", "refine"):
        g = got[tier]
        log(f"7d evaluate {tier} at W = 2 (two ranks on one card, gloo): metrics bit-equal to "
            f"the host recompute; MRR@10 {g['metrics']['MRR@10']:.4f}, nDCG@10 "
            f"{g['metrics']['nDCG@10']:.4f}; against phase 7's one process (batch "
            f"composition only, not gated): metric differences "
            f"{ {k: round(v, 6) for k, v in g['metric_gaps'].items()} }, {g['differing']} "
            f"of {N_EVAL_QUERIES * 100} top-100 ids differ; ranks' walls "
            f"{[round(rk['steps'][f'7d {tier}']['wall_s'], 1) for rk in ranks]} s")
    log(f"7d: each rank's {half} shard rows bit-equal to a one-process encode of its texts; "
        f"flat hits equal to numpy_search over the ranks' embeddings ({n_near} hits inside "
        f"{SCORE_ATOL} near-ties not compared); refine recall@100 against the exact search "
        f"at storage precision (near-ties at the 100th score counted) {recall:.4f} "
        "(limit 0.95)")
    if recall < 0.95:
        raise AssertionError(f"7d refine: recall {recall:.4f} < 0.95")

    # ---- 8's pair ----
    for name, text in mining["files"].items():
        with open(os.path.join(plan["mined"][0], name)) as f:
            if f.read() != text:
                raise AssertionError(f"8 at W = 2: {name} differs from phase 8's file")
    if os.path.exists(plan["mined"][1]):
        raise AssertionError("8 at W = 2: rank 1 wrote files")
    log(f"8 get_hard_negatives at W = 2 (two ranks on one card, gloo): "
        f"{sorted(mining['files'])} equal to phase 8's one-process files; walls "
        f"{[round(rk['steps']['8 mining']['wall_s'], 1) for rk in ranks]} s")

    # ---- 4d's checks: the hits before /add against numpy_search ----
    served = [torch.load(path, weights_only=False) for path in plan["serve_emb"]]
    rows4 = torch.cat([e["shard"] for e in served]).numpy()[:N_PASSAGES]
    n_near4, checked = 0, 0
    for q, s_, i_, sel, mutated in served[0]["searches"]:
        if mutated:
            continue
        pool = np.arange(N_PASSAGES) if sel is None else np.nonzero(sel)[0]
        o_s, o_i = numpy_search(rows4[pool], q, i_.shape[1] + 1)
        n_near4 += _check_against_oracle(i_, s_, o_s, pool[o_i])
        checked += len(q)
    if checked < 32 + 4 * 16 + 16:
        raise AssertionError(f"4d: {checked} queries checked against numpy_search")
    # one process restarts from the W = 2 file: the W = 2 server's hits
    port1 = _free_port()
    flash.reset_launches()
    server, thread, restart_s = start_server(
        [*serve_argv, "--port", str(port1), "--index_file", index_file], port1, N_PASSAGES)
    try:
        again = _http(port1, "/search", {"queries": queries[:16], "k": 100})
        restart_k1 = flash.launches["flash_fwd"]
    finally:
        stop_server(server, thread)
    w2_idx, w2_sc = (np.array(x) for x in _served(final[1]))
    w1_idx, w1_sc = (np.array(x) for x in _served(again[1]))
    n_near_r = _check_against_oracle(w2_idx[:, :99], w2_sc[:, :99], w1_sc, w1_idx)
    s4 = out["serving"]
    log(f"4d serving flat at full depth, W = 2 (two ranks on one card, gloo): {checked} "
        f"queries' hits equal to numpy_search over the ranks' embeddings ({n_near4} inside "
        f"{SCORE_ATOL} near-ties not compared); /search single p50 {s4['p50_ms']:.2f} ms "
        f"p99 {s4['p99_ms']:.2f} ms (8 clients), batch of 16 p50 {s4['batch16_p50_ms']:.2f} "
        f"ms; /add {MP_ADD}, /remove {MP_ADD}, /search and /save {mutate_s:.2f} s; both "
        f"ranks exited 0 after SIGTERM; one process restarted from the W = 2 file in "
        f"{restart_s:.2f} s with the W = 2 server's hits ({n_near_r} inside near-ties); rank "
        f"0's searches {ranks[0]['steps']['4d serving']['search_s']:.3f} s, of which the "
        f"{ranks[0]['steps']['4d serving']['gathers']['calls']} all-gathers of the "
        f"candidates {ranks[0]['steps']['4d serving']['gathers']['seconds']:.3f} s "
        f"({ranks[0]['steps']['4d serving']['gathers']['bytes'] / 1e6:.2f} MB sent, "
        "through host memory); "
        f"ranks' serving walls {[round(rk['steps']['4d serving']['wall_s'], 1) for rk in ranks]} s")
    out.update(wall_s=wall, ranks=ranks, refine_recall=recall,
               launches=sum(rk["steps"][n]["launches"] for rk in ranks for n in rk["steps"])
               + restart_k1)
    for path in (*plan["eval_dirs"]["flat"], *plan["eval_dirs"]["refine"], *plan["mined"]):
        if os.path.exists(path):
            shutil.rmtree(path)
    for path in (*plan["eval_emb"], *plan["serve_emb"], index_file):
        os.remove(path)
    return out


# ---------------------------------------------------------------------------
def scale_centres(seed: int):
    """(generator, SCALE_CENTRES random unit centres at SCALE_D) on the card;
    the generator goes on to make the scale rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    centres = torch.nn.functional.normalize(
        torch.randn(SCALE_CENTRES, SCALE_D, generator=gen, device="cuda"), dim=1)
    return gen, centres


def mixture_rows(gen, centres, n: int):
    """n unit rows on the card, each a random centre plus Gaussian noise of
    relative size SCALE_NOISE, made in slabs of 2^17 rows."""
    d = centres.shape[1]
    x = torch.empty(n, d, device="cuda")
    for lo in range(0, n, 1 << 17):
        hi = min(lo + (1 << 17), n)
        pick = torch.randint(0, centres.shape[0], (hi - lo,), generator=gen, device="cuda")
        noise = torch.randn(hi - lo, d, generator=gen, device="cuda")
        x[lo:hi] = torch.nn.functional.normalize(
            centres[pick] + noise * (SCALE_NOISE / d**0.5), dim=1)
    return x


def make_scale_data(seed: int):
    """SCALE_N + SCALE_Q unit rows at SCALE_D on the card, around
    SCALE_CENTRES random unit centres (the last SCALE_Q rows are the
    held-out queries)."""
    gen, centres = scale_centres(seed)
    x = mixture_rows(gen, centres, SCALE_N + SCALE_Q)
    # the queries get their own storage, so that dropping the corpus frees it
    return x[:SCALE_N], x[SCALE_N:].clone()


def _l2_flush():
    """Evict the 50 MB L2 between timed launches (the probed data is cold,
    as a caller finds it), then keep the card busy for ~1 ms so that the
    host enqueues the timed call before its start event fires: the events
    then time the device work, not the wrapper's Python."""
    if getattr(_l2_flush, "buf", None) is None:
        _l2_flush.buf = torch.empty(1 << 27, dtype=torch.uint8, device="cuda")
    _l2_flush.buf.zero_()
    torch.cuda._sleep(1 << 21)


def _kernel_check(name: str, fn, plain, compose, nbytes: int, ops: int, label: str):
    """One IVF kernel against its plain version on the same inputs: error,
    then CUDA-event times (cold L2) of the kernel, the plain version and the
    shortest torch composition, and the bound."""
    got, ref = fn(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    limit = IVF_RTOL_OF_MAX * ref.abs().max().item()
    if not err <= limit:
        raise AssertionError(f"{name} disagrees with plain at {label}: max|err| {err:.3e} "
                             f"(limit {limit:.3e})")
    out = {"max_abs_err": err, "limit": limit}
    if compose is not None:
        out["ms"] = cuda_ms(fn, before=_l2_flush)
        out["plain_ms"] = cuda_ms(plain, n=5, warmup=1, before=_l2_flush)
        out["compose_ms"] = cuda_ms(compose, n=5, warmup=1, before=_l2_flush)
        out["bound_ms"], out["bound_by"] = bound((nbytes, ops), PEAK_FP32_FLOPS)
        out["library_ms"] = None  # no single PyTorch call computes a gathered block score
        log(f"time {name} at {label}: kernel {out['ms']:.4f} ms (CUDA events, cold L2, "
            "median of 20); "
            f"plain {out['plain_ms']:.4f} ms; torch composition {out['compose_ms']:.4f} ms; "
            f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, {nbytes / 1e6:.1f} MB); "
            f"max|err| {err:.3e} (limit {limit:.3e})")
    else:
        log(f"check {name} at {label}: max|err| {err:.3e} (limit {limit:.3e})")
    return out


def _probe_kernels(index, queries, kind: str, probe=None, timed: bool = True) -> dict:
    """The path's kernel against its plain version at the index's own probe
    set (Q 64, the tuned nprobe; or the given ``probe`` [64, P] cluster ids)
    and storage; with ``timed`` also timed (bf16 rows: at fp32 too) beside
    the plain version, the torch composition and the bound."""
    from rankpo_tpu_torch.index.ivf import PQ_K, _bf16
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    q = queries[:64]
    if probe is None:
        p, _ = index._effective_probe(100, None)
        probe, _ = index._probe_clusters(q, p)
    p = probe.shape[1]
    probe32 = probe.to(torch.int32)
    cap, q_n = index.capacity, q.shape[0]
    blocks, tile_reads = probe_block_reads(probe, index.n_clusters)
    out_bytes, probe_bytes = q_n * p * cap * 4, probe32.numel() * 4
    label = f"Q {q_n}, P {p} ({blocks} distinct blocks), cap {cap}"
    res = {}
    if kind == "bf16":
        for dtype in (torch.bfloat16, torch.float32) if timed else (torch.bfloat16,):
            corpus = index.corpus if dtype == torch.bfloat16 else index.corpus.float()
            d = corpus.shape[1]
            qv = q.to(dtype)

            def compose(corpus=corpus, qv=qv):
                rows = corpus.view(-1, cap, d).index_select(0, probe.flatten())
                return torch.bmm(rows.view(q_n, p * cap, d), qv[:, :, None])

            def plain(c=corpus):
                if timed:
                    return ivf_gather.probe_scores_plain(c, probe32, q, cap=cap)
                # the check alone: the plain version's gather (and its fp32
                # copy) a few queries at a time, at most ~16 GiB each
                n = max(1, (16 << 30) // (p * cap * d * (c.element_size() + 4)))
                return torch.cat([ivf_gather.probe_scores_plain(c, probe32[lo : lo + n],
                                                                q[lo : lo + n], cap=cap)
                                  for lo in range(0, q_n, n)])

            row_bytes = cap * d * corpus.element_size()
            nbytes = blocks * row_bytes + q.numel() * 4 + probe_bytes
            out = _kernel_check(
                "ivf_probe_scores", lambda c=corpus: ivf_gather.probe_scores(c, probe32, q, cap=cap),
                plain,
                compose if timed else None, nbytes + out_bytes, q_n * p * cap * d * 2,
                f"{label}, D {d}, {dtype}")
            # the design's own reads of the corpus: each probed block once
            # per chunk of 8 of the queries that probe it
            out["design_mb"] = tile_reads * row_bytes / 1e6
            if timed:
                log(f"  ivf_probe_scores design: corpus read {out['design_mb']:.1f} MB "
                    f"({tile_reads} block reads: {blocks} distinct + {tile_reads - blocks} "
                    f"chunk re-reads) against the bound's {blocks * row_bytes / 1e6:.1f} MB")
            res[str(dtype).split(".")[1]] = out
            del corpus
        return res
    m, ds = index.pq_m, index.dim // index.pq_m
    q_sub = _bf16(q).reshape(q_n, m, ds).transpose(0, 1)
    cbm = index.codebooks.to(torch.float32).view(m, PQ_K, ds)
    lut = torch.bmm(q_sub, cbm.transpose(1, 2)).transpose(0, 1).contiguous()
    codes = index.corpus
    if kind == "pq_rows":
        fn, plain, name = pq_adc.pq_probe_scores, pq_adc.pq_probe_scores_plain, "pq_probe_scores"
        blocks_of = lambda: codes.view(-1, cap, m).index_select(0, probe.flatten())
    else:
        fn, plain, name = (pq_adc.pq_probe_scores_t, pq_adc.pq_probe_scores_t_plain,
                           "pq_probe_scores_t")
        blocks_of = lambda: codes.view(m, -1, cap).index_select(1, probe.flatten())

    def compose():
        b = blocks_of().long()  # the table gather and sum over the gathered codes
        if kind == "pq_cols":
            b = b.permute(1, 2, 0)
        idx = (b + torch.arange(m, device=b.device) * PQ_K).reshape(q_n, -1)
        return torch.gather(lut.view(q_n, -1), 1, idx).view(q_n, p * cap, m).sum(-1)

    nbytes = blocks * cap * m + lut.numel() * 4 + probe_bytes + out_bytes
    routes = dict(pq_adc.route_launches)
    res[kind] = out = _kernel_check(
        name, lambda: fn(codes, probe32, lut, cap=cap), lambda: plain(codes, probe32, lut, cap=cap),
        compose if timed else None, nbytes, q_n * p * cap * m, f"{label}, m {m}")
    if not timed:
        return res
    out["route"] = [r for r, n in pq_adc.route_launches.items() if n > routes[r]]
    out["plan"] = pq_adc.plan_for(codes, probe32, cap, m)
    # the other floor: every lookup is a shared-memory read, 32 a clock on
    # each SM at best (random codes ask one bank for about 3 words at once)
    mhz = sm_clock_mhz()
    out["lookup_floor_ms"] = q_n * p * cap * m / (PQ_LOOKUPS_PER_CLOCK * mhz * 1e6) * 1e3
    log(f"  {name} route {', '.join(out['route'])}, {out['plan']}; lookup floor "
        f"{out['lookup_floor_ms']:.4f} ms ({q_n * p * cap * m / 1e6:.1f} M lookups at "
        f"{PQ_LOOKUPS_PER_CLOCK} a clock, {mhz:.0f} MHz) beside the byte bound "
        f"{out['bound_ms']:.4f} ms")
    return res


def probe_block_reads(probe, n_clusters: int, chunk: int = 8):
    """(distinct probed blocks, block reads of K4's design) for ``probe``
    [Q, P]: the kernel reads each probed block once per chunk of ``chunk``
    of the (query, probe) pairs that name it."""
    ids = probe.flatten().long()
    counts = torch.bincount(ids[(ids >= 0) & (ids < n_clusters)], minlength=n_clusters)
    return int((counts > 0).sum()), int(((counts + chunk - 1) // chunk).sum())


def _odd_shape_checks(seed: int) -> dict:
    """K4, K5 and K6 at a capacity off every tile of the kernels (333 rows),
    and K5/K6 at m 256 (the table streamed through the kernel's ring; cap 333
    takes the load route "ldg")."""
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    k_c, cap, q_n, p = 512, 333, 64, 8
    probe = torch.randint(0, k_c, (q_n, p), generator=gen, device="cuda", dtype=torch.int32)
    q = torch.nn.functional.normalize(torch.randn(q_n, SCALE_D, generator=gen, device="cuda"))
    corpus = torch.nn.functional.normalize(
        torch.randn(k_c * cap, SCALE_D, generator=gen, device="cuda")).bfloat16()
    label = f"Q {q_n}, P {p}, cap {cap}"
    errs = {"ivf_probe_scores": _kernel_check(
        "ivf_probe_scores", lambda: ivf_gather.probe_scores(corpus, probe, q, cap=cap),
        lambda: ivf_gather.probe_scores_plain(corpus, probe, q, cap=cap), None, 0, 0,
        f"{label}, D {SCALE_D}, bf16")["max_abs_err"]}
    del corpus
    codes = torch.randint(0, 256, (k_c * cap, 256), generator=gen, device="cuda",
                          dtype=torch.uint8)
    lut = torch.randn(q_n, 256, 256, generator=gen, device="cuda") / 16
    codes_t = codes.T.contiguous()
    errs["pq_probe_scores"] = _kernel_check(
        "pq_probe_scores", lambda: pq_adc.pq_probe_scores(codes, probe, lut, cap=cap),
        lambda: pq_adc.pq_probe_scores_plain(codes, probe, lut, cap=cap), None, 0, 0,
        f"{label}, m 256")["max_abs_err"]
    errs["pq_probe_scores_t"] = _kernel_check(
        "pq_probe_scores_t", lambda: pq_adc.pq_probe_scores_t(codes_t, probe, lut, cap=cap),
        lambda: pq_adc.pq_probe_scores_t_plain(codes_t, probe, lut, cap=cap), None, 0, 0,
        f"{label}, m 256")["max_abs_err"]
    return errs


def _ivf_counts() -> dict:
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    return {**ivf_gather.launches, **pq_adc.launches}


def _reset_ivf_counts() -> None:
    from rankpo_tpu_torch.ops import ivf_gather, pq_adc

    ivf_gather.reset_launches()
    pq_adc.reset_launches()


def _search_batches(index, queries):
    """search_tensor over the queries in batches of 64 at k 100: (host hits
    [Q, 100], per-batch host ms, seconds)."""
    batch_ms, hits = [], []
    t0 = time.perf_counter()
    for lo in range(0, queries.shape[0], 64):
        t_b = time.perf_counter()
        _, idx = index.search_tensor(queries[lo : lo + 64], 100)
        hits.append(idx.cpu().numpy())
        batch_ms.append((time.perf_counter() - t_b) * 1e3)
    return np.concatenate(hits), batch_ms, time.perf_counter() - t0


def _recall(hits, exact) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 100
                          for a, b in zip(hits, exact)]))


def _hold_recall(label: str, recall: float) -> None:
    if not recall >= IVF_RECALL_MIN:
        raise AssertionError(f"{label}: recall@100 {recall:.4f} < {IVF_RECALL_MIN}")


def _trace_batch(index, queries, label: str, kernel: str, short: str) -> dict:
    """Where one search batch of 64 at k 100 spends its device time: busy ms
    and the share of the kernels whose names hold ``kernel``."""
    times = profile_device_ms(lambda: index.search_tensor(queries[:64], 100), n=5)
    busy = sum(times.values())
    own = sum(t for name, t in times.items() if kernel in name)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    log(f"{label} one batch of 64 at k 100 (device time, profiler, mean of 5): busy "
        f"{busy:.4f} ms, {short} {own:.4f} ms ({own / busy:.1%}); largest: "
        + "; ".join(f"{t:.4f} ms {name[:70]}" for name, t in top))
    return {"batch_busy_ms": busy, "batch_kernel_ms": own, "kernel_share": own / busy}


def _layout(index, corpus, label: str) -> dict:
    """Rows stored outside their nearest cluster (capacity overflow spills
    them to the 2nd..8th) and the skew of the nearest-cluster fills."""
    from rankpo_tpu_torch.index.ivf import _bf16_mm

    nearest = torch.cat([torch.argmax(_bf16_mm(corpus[lo : lo + 65536], index.centroids.T),
                                      dim=1) for lo in range(0, SCALE_N, 65536)])
    stored = torch.from_numpy(index._cluster_of_row).to(nearest.device)
    fills = torch.bincount(nearest, minlength=index.n_clusters)
    out = {"moved_share": (stored != nearest).float().mean().item(),
           "fill_max": int(fills.max()), "over_capacity": int((fills > index.capacity).sum())}
    log(f"{label} layout: {out['moved_share']:.4f} of rows stored outside their nearest "
        f"cluster; nearest-cluster fill max {out['fill_max']}, mean "
        f"{SCALE_N / index.n_clusters:.1f}, capacity {index.capacity}, "
        f"{out['over_capacity']} clusters over capacity")
    return out


def _build_and_search(label: str, build, corpus_queries, counter) -> tuple:
    """One IVF-style path at scale: counters from 0, ``build()``, the held
    out queries searched in batches of 64, counters read; then recall@100
    against the index's exact search at storage precision (held). Returns
    (index, result dict)."""
    queries, q_host = corpus_queries
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    # ---- the path: counters from 0, build, search, counters read ----
    _reset_ivf_counts()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    index = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    hits, batch_ms, search_s = _search_batches(index, queries)
    launches = _ivf_counts()[counter] if counter else 0
    # ---- end of the path ----
    if counter and launches <= 0:
        raise AssertionError(f"{counter} was not launched on the {label} path")
    t_exact = time.perf_counter()
    _, exact = index.exact_search(q_host, k=100)
    exact_s = time.perf_counter() - t_exact
    recall = _recall(hits, exact)
    res = {
        "n_clusters": index.n_clusters, "capacity": index.capacity, "nprobe": index.nprobe,
        "build_s": build_s, "build_steps_s": dict(index.build_seconds),
        "peak_mem_gib": build_peak, "resident_gib": resident, "qps": SCALE_Q / search_s,
        "batch_p50_ms": float(np.percentile(batch_ms, 50)), "recall": recall,
        "launches": launches, "counter": counter, "exact_s": exact_s,
    }
    log(f"{label}: K {index.n_clusters}, capacity {index.capacity}, slots "
        f"{index.n_clusters * index.capacity}, tuned nprobe {index.nprobe}; build "
        f"{build_s:.2f} s by step {({k: round(v, 3) for k, v in index.build_seconds.items()})}; "
        f"peak memory {build_peak:.2f} GiB ({resident:.2f} GiB resident before); search "
        f"{SCALE_Q} queries at k 100 in batches of 64: {res['qps']:.1f} queries/s, batch p50 "
        f"{res['batch_p50_ms']:.3f} ms; recall@100 against exact_search {recall:.4f} (limit "
        f"{IVF_RECALL_MIN}); {counter or 'no kernel'} launches {launches}; exact search "
        f"{exact_s:.2f} s")
    _hold_recall(label, recall)
    return index, res


def _filtered_path(index, queries, q_host, kind: str, counter: str, seed: int) -> tuple:
    """Phase 6b: searches restricted to a seeded half of the rows. A filter
    leaves the probed clusters as they are (FAISS IVF semantics), so the
    eligible rows a probe reaches halve; the index tunes the nprobe for the
    filter (``tune_filtered_nprobe``, the build's tuner under the filter),
    and the held-out queries are searched with ``nprobe="filtered"``. Every
    returned id must be allowed, the kernel must launch, and recall@100
    against the index's exact search over the allowed rows at storage
    precision is held; the recall at the build's nprobe is printed. Returns
    (result, the kernel against plain at the filtered probe set)."""
    rng = np.random.default_rng(seed + 10)
    allowed = np.sort(rng.choice(SCALE_N, SCALE_N // 2, replace=False))
    mask = np.zeros(SCALE_N, bool)
    mask[allowed] = True
    t0 = time.perf_counter()
    nprobe = index.tune_filtered_nprobe(100, allowed_ids=allowed)
    tune_s = time.perf_counter() - t0
    # ---- the filtered path: counters from 0, search, counters read ----
    _reset_ivf_counts()
    t0 = time.perf_counter()
    _, idx = index.search(q_host, k=100, nprobe="filtered", allowed_ids=allowed)
    search_s = time.perf_counter() - t0
    launches = _ivf_counts()[counter]
    # ---- end of the filtered path ----
    if launches <= 0:
        raise AssertionError(f"{counter} was not launched on the filtered {kind} path")
    if not mask[idx[idx >= 0]].all():
        raise AssertionError(f"filtered {kind}: a returned id is not allowed")
    ref = index.exact_search(q_host, k=100, allowed_ids=allowed)[1]
    recall = _recall(idx, ref)
    at_build = _recall(index.search(q_host, k=100, allowed_ids=allowed)[1], ref)
    log(f"filtered {kind}: allowed {len(allowed)} of {SCALE_N} rows; the index's filtered "
        f"nprobe {nprobe} (tune_filtered_nprobe, {tune_s:.2f} s; the build's {index.nprobe}); "
        f"{SCALE_Q} queries at k 100: {SCALE_Q / search_s:.1f} queries/s, every id allowed, "
        f"recall@100 against the exact search over the allowed rows {recall:.4f} (at the "
        f"build's nprobe {at_build:.4f}); {counter} launches {launches}")
    _hold_recall(f"filtered {kind}", recall)
    log(f"filtered {kind} kernel at its probe set:")
    probe = index._probe_clusters(queries[:64], index._effective_probe(100, nprobe)[0])[0]
    check = _probe_kernels(index, queries, kind, probe, timed=False)
    return ({"nprobe": nprobe, "tune_s": tune_s, "recall": recall,
             "recall_at_build_nprobe": at_build, "qps": SCALE_Q / search_s,
             "launches": launches, "counter": counter},
            check["bfloat16" if kind == "bf16" else kind])


def _mutation_path(index, queries, q_host, centres, seed: int) -> tuple:
    """Phase 6c: append SCALE_MUTATE new rows of the same mixture, then
    remove SCALE_MUTATE seeded rows; the mutated index searched (K4 must
    launch) and held to recall@100 >= IVF_RECALL_MIN against its own exact
    search; 1024 appended rows reconstructed bit-equal to their bf16
    values. Returns (result, K4 against plain on the mutated storage)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    new = mixture_rows(gen, centres, SCALE_MUTATE)
    removed = np.random.default_rng(seed + 11).choice(SCALE_N + SCALE_MUTATE, SCALE_MUTATE,
                                                      replace=False)
    torch.cuda.synchronize()
    # ---- the mutation path: counters from 0, append, remove, search ----
    _reset_ivf_counts()
    t0 = time.perf_counter()
    appended = index.append_sharded(new, SCALE_MUTATE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mutated = appended.remove_rows(removed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    hits, batch_ms, search_s = _search_batches(mutated, queries)
    launches = _ivf_counts()["ivf_probe_scores"]
    # ---- end of the mutation path ----
    if launches <= 0:
        raise AssertionError("ivf_probe_scores was not launched on the mutated path")
    got = appended.reconstruct(np.arange(SCALE_N, SCALE_N + 1024))
    if not np.array_equal(got, new[:1024].bfloat16().float().cpu().numpy()):
        raise AssertionError("reconstruct of appended rows differs from their bf16 values")
    _, exact = mutated.exact_search(q_host, k=100)
    recall = _recall(hits, exact)
    res = {"append_s": t1 - t0, "remove_s": t2 - t1, "capacity": appended.capacity,
           "n_total": mutated.n_total, "qps": SCALE_Q / search_s,
           "batch_p50_ms": float(np.percentile(batch_ms, 50)), "recall": recall,
           "launches": launches, "counter": "ivf_probe_scores"}
    log(f"mutated bf16: append {SCALE_MUTATE} rows {res['append_s']:.2f} s (capacity "
        f"{index.capacity} -> {appended.capacity}), remove {SCALE_MUTATE} rows "
        f"{res['remove_s']:.3f} s, {mutated.n_total} rows; search {res['qps']:.1f} "
        f"queries/s, batch p50 {res['batch_p50_ms']:.3f} ms; recall@100 against the "
        f"mutated index's exact_search {recall:.4f}; reconstruct of 1024 appended rows "
        f"bit-equal to bf16; ivf_probe_scores launches {launches}")
    _hold_recall("mutated bf16", recall)
    log("mutated bf16 kernel at its probe set:")
    return res, _probe_kernels(mutated, queries, "bf16", timed=False)["bfloat16"]


def _flat_tiers_at_scale(corpus, queries) -> dict:
    """Phase 6g: the flat tier over the scale rows, exact fp32 (the
    reference), bf16 rows (``SQbf16``), int8 rows (``SQ8``, the int8
    product) and fp32 rows at recall target 0.95 (one pass of bf16
    operands, ``torch.topk``): queries/s and batch p50 (batches of 64 at k
    100, host clock), recall@100 against the exact fp32 search, peak device
    memory. SQbf16 and SQ8 are held to IVF_RECALL_MIN, the approximate mode
    to its target."""
    from rankpo_tpu_torch.index.flat import FlatIPIndex

    configs = {"fp32": {}, "sqbf16": {"dtype": torch.bfloat16},
               "sq8": {"dtype": torch.int8},
               "fp32_approx": {"recall_target": 0.95}}
    res, exact = {}, None
    for label, kw in configs.items():
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = FlatIPIndex.from_sharded(corpus, SCALE_N, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        hits, batch_ms, search_s = _search_batches(index, queries)
        exact = hits if exact is None else exact
        storage = index.corpus.numel() * index.corpus.element_size() + (
            0 if index.row_scale is None else index.row_scale.numel() * 4)
        res[label] = {"qps": SCALE_Q / search_s,
                      "batch_p50_ms": float(np.percentile(batch_ms, 50)),
                      "recall": _recall(hits, exact), "build_s": build_s,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "resident_gib": resident, "storage_gib": storage / 2**30,
                      "launches": 0, "counter": None}
        log(f"flat {label} at {SCALE_N} x {SCALE_D}: storage {storage / 2**30:.3f} GiB, "
            f"build {build_s:.2f} s; {SCALE_Q} queries at k 100 in batches of 64: "
            f"{res[label]['qps']:.1f} queries/s, batch p50 {res[label]['batch_p50_ms']:.3f} "
            f"ms; recall@100 against the exact fp32 search {res[label]['recall']:.4f}; peak "
            f"memory {res[label]['peak_mem_gib']:.2f} GiB ({resident:.2f} GiB resident before)")
        del index
    _hold_recall("flat sqbf16", res["sqbf16"]["recall"])
    _hold_recall("flat sq8", res["sq8"]["recall"])
    if not res["fp32_approx"]["recall"] >= 0.95:
        raise AssertionError(f"flat approximate recall {res['fp32_approx']['recall']:.4f} "
                             "< its target 0.95")
    return res


def phase_autotune() -> dict:
    """Phase 6h: ``rankpo_tpu_torch.cli.autotune``'s ``main`` in synthetic
    mode at 65,536 x 2048 (its default ladder, k 100, target 0.95; in this
    process, its JSON line kept off the smoke's output), its table printed;
    every spec of the ladder must build and search (the tuner reports a
    spec that raised as a row with an ``error``), Flat's recall must be 1.0
    and the recommended spec must meet the target (the CLI exits 1 when
    none does)."""
    import io

    from rankpo_tpu_torch.cli import autotune

    with tempfile.TemporaryDirectory(prefix="rankpo_autotune_") as tmp:
        out = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = autotune.main([
                "--synthetic_rows", str(AUTOTUNE_ROWS), "--synthetic_dim", str(SCALE_D),
                "--k", "100", "--recall_target", "0.95", "--device", "cuda",
                "--output_file", out, "--log_level", "warning"])
        wall = time.perf_counter() - t0
        with open(out) as f:
            if json.load(f) != json.loads(json.dumps(report)):
                raise AssertionError("autotune: the report file differs from the report")
    for row in report["results"]:
        log(f"autotune | {row['spec']:<24} FAILED: {row['error']}" if "error" in row else
            f"autotune | {row['spec']:<24} recall {row['recall']:.4f}  {row['qps']:10.1f} qps  "
            f"{row['memory_mb']:9.2f} MB  build {row['build_s']:6.2f}s"
            + ("  <- feasible" if row["feasible"] else ""))
    log(f"autotune | recommended spec: {report['best']}")
    if report["best"] is None:
        raise RuntimeError("cli.autotune recommended no spec (its exit code 1)")
    failed = {r["spec"]: r["error"] for r in report["results"] if "error" in r}
    if failed:
        raise AssertionError(f"autotune: specs failed on the card: {failed}")
    by_spec = {r["spec"]: r for r in report["results"]}
    best = by_spec[report["best"]]
    if by_spec["Flat"].get("recall") != 1.0:
        raise AssertionError(f"autotune: Flat recall {by_spec['Flat'].get('recall')} != 1.0")
    if not (best["feasible"] and best["recall"] >= 0.95):
        raise AssertionError(f"autotune recommended {report['best']} below its target")
    log(f"autotune at {AUTOTUNE_ROWS} x {SCALE_D}: {len(report['results'])} specs in "
        f"{wall:.1f} s; recommended {report['best']} (recall "
        f"{best['recall']}, {best['qps']} queries/s, {best['memory_mb']} MB)")
    return {"wall_s": wall, "report": report}


def phase_index_scale(seed: int) -> dict:
    """The IVF and refine tiers at scale over 2^20 rows at D 2048, built and
    searched on the card; each path's kernel counter from 0 to its read,
    then the kernels against plain at its shapes. Each index is freed
    before the next."""
    from rankpo_tpu_torch.index.flat import FlatIPIndex
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.index.refined import RefineIPIndex

    t0 = time.perf_counter()
    corpus, queries = make_scale_data(seed)
    _, centres = scale_centres(seed)
    torch.cuda.synchronize()
    q_host = queries.cpu().numpy()
    cq = (queries, q_host)
    log(f"scale data: {SCALE_N} rows + {SCALE_Q} queries at D {SCALE_D} around "
        f"{SCALE_CENTRES} centres (noise {SCALE_NOISE}), {time.perf_counter() - t0:.2f} s")
    t_flat = time.perf_counter()
    flat_tiers = _flat_tiers_at_scale(corpus, queries)
    flat_s = time.perf_counter() - t_flat
    log(f"6g flat tiers at scale: {flat_s:.1f} s")
    configs = {"bf16": ({}, "ivf_probe_scores"),
               "pq_rows": ({"pq_m": 64, "pq_layout": "rows"}, "pq_adc_rows"),
               "pq_cols": ({"pq_m": 64, "pq_layout": "cols"}, "pq_adc_cols")}
    results, kernels = {}, {}
    for kind, (kw, counter) in configs.items():
        index, results[kind] = _build_and_search(
            f"IVF {kind}", lambda kw=kw: IVFIPIndex(corpus, recall_target=0.95, **kw),
            cq, counter)
        if kind == "bf16":
            # why nprobe is what it is, then where one batch's device time goes
            results[kind].update(_layout(index, corpus, "IVF bf16"))
            results[kind].update(_trace_batch(index, queries, "IVF bf16", "ivf_probe_scores",
                                              "K4"))
            results["bf16_filtered"], kernels["bf16_filtered"] = _filtered_path(
                index, queries, q_host, "bf16", "ivf_probe_scores", seed)
            results["bf16_mutated"], kernels["bf16_mutated"] = _mutation_path(
                index, queries, q_host, centres, seed)
        else:
            results[kind].update(_trace_batch(index, queries, f"IVF {kind}", "pq_adc_",
                                              "K5" if kind == "pq_rows" else "K6"))
            if kind == "pq_rows":
                results["pq_rows_filtered"], kernels["pq_rows_filtered"] = _filtered_path(
                    index, queries, q_host, "pq_rows", "pq_adc_rows", seed)
        kernels.update(_probe_kernels(index, queries, kind))
        if kind == "bf16":  # the bf16 index's (wider) probe set, for the PQ kernels too
            p, _ = index._effective_probe(100, None)
            wide_probe = index._probe_clusters(queries[:64], p)[0]
        else:  # the same K 4096 clusters: the PQ kernels at the bf16 index's width
            log(f"{kind} at the bf16 index's probe set (not the path's shape):")
            kernels[f"{kind}_wide"] = _probe_kernels(index, queries, kind, wide_probe)[kind]
        del index

    # 6a: the bf16 index built with kmeans_split, beside the one without
    index, split = _build_and_search(
        f"IVF bf16 kmeans_split {SCALE_SPLIT}",
        lambda: IVFIPIndex(corpus, recall_target=0.95, kmeans_split=SCALE_SPLIT),
        cq, "ivf_probe_scores")
    split.update(_layout(index, corpus, "IVF bf16 split"))
    split.update(_trace_batch(index, queries, "IVF bf16 split", "ivf_probe_scores", "K4"))
    log("IVF bf16 split kernel at its probe set:")
    kernels["bf16_split"] = _probe_kernels(index, queries, "bf16", timed=False)["bfloat16"]
    results["bf16_split"] = split
    base = results["bf16"]
    log("kmeans_split beside no split (bf16 rows): " + "; ".join(
        f"{key} {base[key]:.4g} -> {split[key]:.4g}" for key in
        ("moved_share", "fill_max", "nprobe", "batch_p50_ms", "kernel_share", "recall",
         "qps")))
    del index

    # 6e: the PCA hybrid (bf16 rows, d' SCALE_REDUCED); no kernel on its path
    index, hybrid = _build_and_search(
        f"IVF bf16 hybrid d' {SCALE_REDUCED}",
        lambda: IVFIPIndex(corpus, recall_target=0.95, reduced_dim=SCALE_REDUCED),
        cq, None)
    hybrid["candidates"] = index.candidates
    log(f"IVF hybrid: tuned nprobe {index.nprobe}, candidates {index.candidates}")
    results["hybrid"] = hybrid
    del index

    # 6f: the refine tier, held against an exact fp32 search
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    index = RefineIPIndex.from_sharded(corpus, SCALE_N, reduced_dim=SCALE_REDUCED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    peak = torch.cuda.max_memory_allocated() / 2**30
    hits, batch_ms, search_s = _search_batches(index, queries)
    _, exact = FlatIPIndex(corpus).search(q_host, k=100)
    recall = _recall(hits, exact)
    results["refine"] = {"candidates": index.candidates, "build_s": build_s,
                         "peak_mem_gib": peak, "resident_gib": resident,
                         "qps": SCALE_Q / search_s,
                         "batch_p50_ms": float(np.percentile(batch_ms, 50)),
                         "recall": recall, "launches": 0, "counter": None}
    log(f"refine d' {SCALE_REDUCED}: tuned C {index.candidates}; build {build_s:.2f} s, peak "
        f"memory {peak:.2f} GiB ({resident:.2f} GiB resident before); search {SCALE_Q} "
        f"queries at k 100 in batches of 64: {SCALE_Q / search_s:.1f} queries/s, batch p50 "
        f"{results['refine']['batch_p50_ms']:.3f} ms; recall@100 against the exact fp32 "
        f"search {recall:.4f} (limit {IVF_RECALL_MIN})")
    _hold_recall("refine", recall)
    del index, corpus

    # 6d: the streamed build; each chunk made on demand from its own
    # generator, so the fp32 corpus never exists whole
    def get_chunk(lo, hi):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + 100 + lo // SCALE_CHUNK)
        return mixture_rows(gen, centres, hi - lo)

    index, streamed = _build_and_search(
        "IVF bf16 streamed (from_chunk_fn)",
        lambda: IVFIPIndex.from_chunk_fn(get_chunk, SCALE_N, SCALE_D, chunk_rows=SCALE_CHUNK,
                                         recall_target=0.95),
        cq, "ivf_probe_scores")
    results["bf16_streamed"] = streamed
    log("IVF bf16 streamed kernel at its probe set:")
    kernels["bf16_streamed"] = _probe_kernels(index, queries, "bf16", timed=False)["bfloat16"]
    log(f"peak device memory of the builds: constructor {base['peak_mem_gib']:.2f} GiB (the "
        f"{SCALE_N * SCALE_D * 4 / 2**30:.0f} GiB fp32 corpus resident), streamed "
        f"{streamed['peak_mem_gib']:.2f} GiB (chunks of {SCALE_CHUNK} rows)")
    del index, queries, centres
    gc.collect()
    torch.cuda.empty_cache()
    odd = _odd_shape_checks(seed)
    return {"indexes": results, "kernels": kernels, "odd": odd, "flat": flat_tiers,
            "flat_s": flat_s}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dp_witness", action="store_true",
                        help="run only the evidence behind phase 5d(b)'s limits "
                             "(phase_dp_witness)")
    args = parser.parse_args(argv)

    t_all = time.perf_counter()
    # cuBLAS repeats its results only with a fixed workspace, read at its
    # first call; stage 2 runs under torch.use_deterministic_algorithms,
    # which refuses cuBLAS without it. ":4096:8" is the size PyTorch
    # already picks on Hopper.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = phase_environment()
    wall = {}

    nested = [0.0]  # seconds of the phases run inside the open ones

    def timed(name, fn, *args):
        # a phase's wall leaves out the phases run beside its ranks
        t = time.perf_counter()
        nested.append(0.0)
        try:
            out = fn(*args)
        finally:
            inner = nested.pop()
            spent = time.perf_counter() - t
            nested[-1] += spent
        wall[name] = wall.get(name, 0.0) + spent - inner
        return out

    timed("1 build", phase_build)
    if args.dp_witness:
        with tempfile.TemporaryDirectory(prefix="rankpo_smoke_") as tmp:
            phase_dp_witness(tmp, args.seed)
        log(f"5d witness: {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="rankpo_smoke_") as tmp:
        kern = timed("2 kernels", phase_kernels, args.seed, tmp)
        # K3b's fp32 build at a ring step, beside the bf16 build (5t's ring runs it)
        kern["flash_dkv_f32"] = timed("2 kernels", check_dkv_f32, args.seed)
        kern_packed = timed("2p packed kernels", phase_kernels_packed, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        timed("3 search ties", phase_search_ties)
        ckpt, base_state = timed("checkpoint", make_model_checkpoint, tmp, args.seed,
                                 "llama-3.2-1b")
        # serving's tiers but flat, 4m, 5f, 5l, 5d's two ranks and phase 8's
        # pipeline run at FEATURE_LAYERS of 16 layers (the cut that pays for 5d and 5t)
        ckpt_cut, _ = timed("checkpoint", make_model_checkpoint, tmp, args.seed, "llama-3.2-1b",
                         FEATURE_LAYERS, False)
        serving, mutation = {}, {}
        for tier in SERVE_TIERS:
            serving[tier] = timed("4 serving", phase_serving, args.seed, tmp,
                                  ckpt if tier == "flat" else ckpt_cut, tier)
            gc.collect()
            torch.cuda.empty_cache()
        serving_packed = timed("4p packed serving", phase_serving_packed, args.seed, tmp, ckpt,
                               serving["flat"])
        gc.collect()
        torch.cuda.empty_cache()
        for tier in MUTATE_TIERS:
            mutation[tier] = timed("4m mutation", phase_mutation, args.seed, tmp, ckpt_cut, tier)
            gc.collect()
            torch.cuda.empty_cache()
        train = timed("5 training", phase_training, ckpt, tmp, args.seed, base_state)
        train_packed = timed("5p packed training", phase_training_packed, ckpt, tmp, args.seed,
                             base_state, train)
        del base_state
        for stage_dir in ("stage1", "stage1_rerun", "stage2"):  # ~15 GB of fp32 files
            shutil.rmtree(os.path.join(tmp, stage_dir))
        features = timed("5f training features", phase_training_features, ckpt_cut, tmp,
                         args.seed)
        dp = timed("5d data parallel", phase_data_parallel, ckpt, ckpt_cut, tmp, args.seed,
                   train["stage1"])
        kept, beside = {}, {}

        def beside_5t():
            # phases that need nothing of 5t, run while its six ranks wait on
            # gloo: 5l; evaluation and mining of the Llama model at
            # FEATURE_LAYERS (a cut that pays for 5t); the other bodies at the
            # published widths but gemma-2b: bge-m3 trained and evaluated,
            # bge-large-en-v1.5 and Qwen2-1.5B served, Qwen2 trained,
            # e5-mistral-7b-instruct served, trained and evaluated
            beside["item7"] = timed("5l item 7", phase_training_item7, ckpt_cut, tmp,
                                    args.seed, features, train["stage2"])
            beside["evaluation"] = timed("7 evaluate", phase_evaluate, args.seed, tmp,
                                         ckpt_cut, tuple(EVAL_TIERS), True)
            beside["mining"] = timed("8 mining and pipeline", phase_mining, args.seed, tmp,
                                     ckpt_cut, os.path.join(tmp, "eval_queries.jsonl"),
                                     ckpt_cut, kept)
            bge = beside["bge"] = timed("5b bge-m3 training", phase_training_bge, tmp,
                                        args.seed)
            beside["evaluation_bge"] = timed("7b bge-m3 evaluate", phase_evaluate, args.seed,
                                             tmp, bge["stage2_dir"], ("flat",))
            shutil.rmtree(bge["stage2_dir"])
            shutil.rmtree(os.path.join(tmp, "bge-m3"))
            # bge-large-en-v1.5 and Qwen2-1.5B served, Qwen2 trained
            serving_models = beside["serving_models"] = {}
            for name in ("bge-large-en-v1.5", "qwen2-1.5b"):
                ckpt_m, state_m = timed("checkpoint", make_model_checkpoint, tmp, args.seed,
                                        name, OTHER_LAYERS)
                serving_models[name] = timed("4b serving", phase_serving, args.seed, tmp,
                                             ckpt_m, "flat", name)
                gc.collect()
                torch.cuda.empty_cache()
                if name == "qwen2-1.5b":
                    beside["qwen2"] = timed("5q qwen2-1.5b training", phase_training_qwen2,
                                            tmp, args.seed, ckpt_m, state_m)
                del state_m
                shutil.rmtree(ckpt_m)
            # e5-mistral-7b-instruct (sliding window 4096): served at
            # MISTRAL_SERVE_LAYERS, trained at cut depth, the trained model evaluated
            ckpt_m, _ = timed("checkpoint", make_model_checkpoint, tmp, args.seed, MISTRAL,
                              MISTRAL_SERVE_LAYERS, False)
            serving_models[MISTRAL] = timed("4w e5-mistral serving", phase_serving,
                                            args.seed, tmp, ckpt_m, "flat", MISTRAL,
                                            MISTRAL_PASSAGES)
            shutil.rmtree(ckpt_m)
            gc.collect()
            torch.cuda.empty_cache()
            mistral = beside["mistral"] = timed("5w e5-mistral training",
                                                phase_training_mistral, tmp, args.seed)
            beside["evaluation_mistral"] = timed("7w e5-mistral evaluate", phase_evaluate,
                                                 args.seed, tmp, mistral["stage2_dir"],
                                                 ("flat",))
            shutil.rmtree(mistral["stage2_dir"])

        sharded = timed("5t sharded models", phase_sharded, ckpt_cut, tmp, args.seed, dp,
                        beside_5t)
        (item7, evaluation, mining, bge, evaluation_bge, qwen2, mistral,
         evaluation_mistral) = (beside[k] for k in (
            "item7", "evaluation", "mining", "bge", "evaluation_bge", "qwen2", "mistral",
            "evaluation_mistral"))
        multi = timed("7d 8 4d two ranks", phase_multiprocess, args.seed, tmp, ckpt,
                      ckpt_cut, kept)
        shutil.rmtree(ckpt_cut)
        serving_models = beside["serving_models"]
        # google/gemma-2b (head_dim 256) at full width and GEMMA_LAYERS:
        # served, trained, the trained model evaluated
        ckpt_g, state_g = timed("checkpoint", make_model_checkpoint, tmp, args.seed, GEMMA,
                                GEMMA_LAYERS)
        serving_models[GEMMA] = timed("4g gemma-2b serving", phase_serving, args.seed, tmp,
                                      ckpt_g, "flat", GEMMA)
        gc.collect()
        torch.cuda.empty_cache()
        gemma = timed("5g gemma-2b training", phase_training_gemma, tmp, args.seed, ckpt_g,
                      state_g)
        del state_g
        shutil.rmtree(ckpt_g)
        evaluation_gemma = timed("7g gemma-2b evaluate", phase_evaluate, args.seed, tmp,
                                 gemma["stage2_dir"], ("flat",))
        shutil.rmtree(gemma["stage2_dir"])
    scale = timed("6 index scale", phase_index_scale, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    autotune = timed("6h autotune", phase_autotune)
    nums = serving["flat"]
    log(f"numbers ({card}): serving startup (load + encode + index) "
        f"{nums['startup_s']:.2f} s; corpus encode {nums['encode_s']:.3f} s = "
        f"{nums['passages_per_s']:.1f} passages/s, {nums['tokens_per_s']:.0f} "
        f"tokens/s ({nums['corpus_tokens']} tokens); /search single p50 "
        f"{nums['search_single_p50_ms']:.2f} ms p99 "
        f"{nums['search_single_p99_ms']:.2f} ms (8 clients); batch of 16 p50 "
        f"{nums['search_batch16_p50_ms']:.2f} ms; peak device memory "
        f"{nums['peak_mem_gib']:.2f} GiB; K1 at the encode's shapes "
        f"{nums['k1_encode']['ms']:.4f} ms per layer ({nums['k1_encode']['batches']} batches)")
    for tier in ("ivf", "pq", "refine"):
        n = serving[tier]
        knobs = (f"candidates {n['candidates']} (d' {n['reduced_dim']})" if tier == "refine"
                 else f"index build {n['build_s']}; K {n['n_clusters']}, capacity "
                      f"{n['capacity']}, nprobe {n['nprobe']}")
        log(f"numbers ({card}): serving {' '.join(SERVE_TIERS[tier][0])}: startup "
            f"{n['startup_s']:.2f} s ({knobs}); /search single p50 "
            f"{n['search_single_p50_ms']:.2f} ms p99 {n['search_single_p99_ms']:.2f} ms "
            f"(8 clients); batch of 16 p50 {n['search_batch16_p50_ms']:.2f} ms; recall@k "
            f"{n['recall']:.4f}; peak device memory {n['peak_mem_gib']:.2f} GiB; "
            f"launches {n['launches']}")
    for tier in ("sqbf16", "sq8", "approx"):
        n = serving[tier]
        log(f"numbers ({card}): serving {' '.join(SERVE_TIERS[tier][0])}: startup "
            f"{n['startup_s']:.2f} s; /search single p50 {n['search_single_p50_ms']:.2f} ms "
            f"p99 {n['search_single_p99_ms']:.2f} ms (8 clients); batch of 16 p50 "
            f"{n['search_batch16_p50_ms']:.2f} ms; "
            + (f"recall@k {n['recall']:.4f}; " if "recall" in n else "")
            + f"peak device memory {n['peak_mem_gib']:.2f} GiB; launches {n['launches']}")
    for tier, n in mutation.items():
        log(f"numbers ({card}): mutation {tier}: start {n['startup_s']:.2f} s, /add "
            f"{N_MUTATE} {n['add_s']:.2f} s, /remove {N_MUTATE} {n['remove_s']:.2f} s, "
            f"restart {n['restart_s']:.2f} s; launches {n['launches']}")
    for label, n in scale["flat"].items():
        log(f"numbers ({card}): scale flat {label} at {SCALE_N} x {SCALE_D}: " + ", ".join(
            f"{key} {value:.4f}" for key, value in n.items() if isinstance(value, float)))
    best = {r["spec"]: r for r in autotune["report"]["results"]}[autotune["report"]["best"]]
    log(f"numbers ({card}): autotune at {AUTOTUNE_ROWS} x {SCALE_D}: "
        f"{autotune['wall_s']:.1f} s, recommended {autotune['report']['best']} "
        f"({best['qps']} queries/s, recall {best['recall']}, {best['memory_mb']} MB)")
    for kind, n in scale["indexes"].items():
        log(f"numbers ({card}): scale {kind} at {SCALE_N} x {SCALE_D}: " + ", ".join(
            f"{key} {value:.4f}" if isinstance(value, float) else f"{key} {value}"
            for key, value in n.items() if key not in ("counter",)))
    stages = [("stage1", train["stage1"], 8), ("stage2", train["stage2"], 8),
              ("bge-m3 stage1 (dropout, plain attention)", bge["stage1"], BGE_STEPS),
              ("bge-m3 stage2", bge["stage2"], BGE_STEPS),
              ("qwen2-1.5b stage1", qwen2["stage1"], QWEN2_STEPS),
              (f"e5-mistral stage1 ({MISTRAL_TRAIN_LAYERS} layers, window; MFU counts the "
               "whole causal triangle, as the JAX formula does)", mistral["stage1"],
               MISTRAL_STEPS),
              (f"e5-mistral stage2 ({MISTRAL_TRAIN_LAYERS} layers, window)", mistral["stage2"],
               MISTRAL_STEPS),
              ("gemma-2b stage1 (head_dim 256)", gemma["stage1"], GEMMA_STEPS),
              ("gemma-2b stage2 (head_dim 256)", gemma["stage2"], GEMMA_STEPS)]
    for stage, s, steps in stages:
        mfu = "not known for this card" if s["mfu"] is None else f"{s['mfu']:.4f}"
        log(f"numbers ({card}): {stage}: median step {s['step_time_s']:.4f} s "
            f"(steps 2-{steps}); {s['samples_per_sec']:.2f} samples/s, "
            f"{s['tokens_per_sec']:.1f} tokens/s (padded, as the trainer logs them); "
            f"MFU {mfu} (trainer's log, 989 TFLOP/s peak); peak device memory "
            f"{s['peak_mem_gib']:.2f} GiB; loss {s['first_loss']:.4f} -> "
            f"{s['last_loss']:.4f}; wall {s['wall_s']:.1f} s; K1 launches "
            f"{s['launches']['flash_fwd']}, K2 {s['launches']['flash_bwd_fused']}, "
            f"K3a {s['launches']['flash_dq']}, K3b {s['launches']['flash_dkv']}")
    for name, n in serving_models.items():
        log(f"numbers ({card}): serving {name} (flat): startup (load + encode + index) "
            f"{n['startup_s']:.2f} s; corpus encode {n['encode_s']:.3f} s = "
            f"{n['passages_per_s']:.1f} passages/s, {n['tokens_per_s']:.0f} tokens/s; "
            f"/search single p50 {n['search_single_p50_ms']:.2f} ms p99 "
            f"{n['search_single_p99_ms']:.2f} ms (8 clients); batch of 16 p50 "
            f"{n['search_batch16_p50_ms']:.2f} ms; peak device memory "
            f"{n['peak_mem_gib']:.2f} GiB; K1 at the encode's shapes "
            f"{n['k1_encode']['ms']:.4f} ms per layer; launches {n['launches']}")
    for shape, causal in REGIME_SHAPES:
        log(f"numbers ({card}): kernels at {shape} {'causal' if causal else 'non-causal'}, "
            "random lengths: " + "; ".join(
                f"{name} {kern[name]['regimes'][shape]['ms']:.4f} ms (plain "
                f"{kern[name]['regimes'][shape]['plain_ms']:.4f}, SDPA "
                f"{kern[name]['regimes'][shape]['library_ms']:.4f}, bound "
                f"{kern[name]['regimes'][shape]['bound_ms']:.4f} "
                f"{kern[name]['regimes'][shape]['bound_by']})" for name in KERNELS))
    log(f"numbers ({card}): kernels at Mistral's shape {WINDOW_SHAPES[0][0]}, window "
        f"{WINDOW_SHAPES[0][1]}, lengths in {list(WINDOW_SHAPES[0][2])}: " + "; ".join(
            f"{name} {kern[name]['mistral']['ms']:.4f} ms (plain "
            f"{kern[name]['mistral']['plain_ms']:.4f}, SDPA with the band mask "
            f"{kern[name]['mistral']['library_ms']:.4f}, band bound "
            f"{kern[name]['mistral']['bound_ms']:.4f} {kern[name]['mistral']['bound_by']})"
            for name in KERNELS))
    for shape, label in kern["flash_fwd"]["gemma"]:
        rows = {name: kern[name]["gemma"][(shape, label)] for name in KERNELS}
        log(f"numbers ({card}): kernels at head_dim 256 {shape}, {label} lengths: " + "; ".join(
            f"{name} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']})" for name, r in rows.items()))
    log(f"numbers ({card}): gemma-2b flash vs plain (stage-1 micro-batch) {gemma['compare']}")
    (pb, ps, phq, phkv, pd), pcausal, _, _ = PACKED_SHAPES[PACKED_TIMED]
    log(f"numbers ({card}): kernels with segments at {(pb, ps, phq, phkv, pd)} "
        f"{'causal' if pcausal else 'non-causal'}: " + "; ".join(
            f"{name} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, SDPA with the "
            f"block-diagonal mask {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}, unpacked on the same texts {r['unpacked_ms']:.4f})"
            for name, r in kern_packed.items()))
    sp = serving_packed
    log(f"numbers ({card}): packed serving (--pack_queries): startup {sp['startup_s']:.2f} s; "
        f"/search single p50 {sp['search_single_p50_ms']:.2f} ms p99 "
        f"{sp['search_single_p99_ms']:.2f} ms (8 clients; unpacked "
        f"{serving['flat']['search_single_p50_ms']:.2f} / "
        f"{serving['flat']['search_single_p99_ms']:.2f}); batch of 16 p50 "
        f"{sp['search_batch16_p50_ms']:.2f} ms (unpacked "
        f"{serving['flat']['search_batch16_p50_ms']:.2f}); min cosine to unpacked "
        f"{sp['min_cosine']:.6f}; launches with segments {sp['packed_launches']}")
    for stage, s_ in train_packed.items():
        log(f"numbers ({card}): {stage} packed: median step {s_['step_time_s']:.4f} s "
            f"(unpacked {train[stage]['step_time_s']:.4f}); real tokens/s "
            f"{s_['real_tokens_per_s']:.1f} (unpacked {s_['unpacked_real_tokens_per_s']:.1f}); "
            f"pad share {s_['pad_share']:.4f} (unpacked {s_['unpacked_pad_share']:.4f}); "
            f"peak device memory {s_['peak_mem_gib']:.2f} GiB (unpacked "
            f"{train[stage]['peak_mem_gib']:.2f}); first loss relative to unpacked "
            f"{s_['first_loss_rel']:.3e}, to fp32 {s_['first_loss_rel_fp32']:.3e} (unpacked "
            f"{s_['unpacked_first_loss_rel_fp32']:.3e}); launches with segments "
            f"{s_['packed_launches']}")
    wb = serving_models[MISTRAL]["window_bites"]
    log(f"numbers ({card}): e5-mistral window bites on {wb['tokens']} tokens: 1 - cosine with "
        f"and without the window {wb['moved']}, limits {wb['limit']}; flash vs plain "
        f"(stage-1 micro-batch) {mistral['compare']}")
    for tier, n in (*evaluation.items(), *(("bge-m3 " + t, n) for t, n in
                                            evaluation_bge.items()),
                    *(("e5-mistral " + t, n) for t, n in evaluation_mistral.items()),
                    *(("gemma-2b " + t, n) for t, n in evaluation_gemma.items())):
        log(f"numbers ({card}): evaluate {tier}: {n['wall_s']:.2f} s wall, "
            f"{n['queries_per_s']:.1f} queries/s, {n['passages_per_s']:.1f} passages/s, "
            f"encodes {n['encode_s']}, metrics on the host {n['metrics_s']:.3f} s, peak "
            f"{n['peak_mem_gib']:.2f} GiB, launches {n['launches']}")
    for name, n in mining.items():
        log(f"numbers ({card}): {name}: {n['wall_s']:.2f} s wall, peak device memory "
            f"{n['peak_mem_gib']:.2f} GiB, launches {n['launches']}")
    feature_keys = ("full", "dots", "attn", "adamw8bit", "adafactor", "straight", "straight8",
                    "eval", "gradcache", "accum4", "profile", "debug_nans")
    feature_runs = [features[k] for k in feature_keys]
    log(f"numbers ({card}): 5f launches (K1, K2, K3a, K3b): " + "; ".join(
        f"{k} {tuple(features[k]['launches'][name] for name in KERNELS)}"
        for k in feature_keys))
    lo, st, en = item7["lora"], item7["streaming"], item7["encode"]
    log(f"numbers ({card}): 5l LoRA stage 2 (r {LORA_R}): {lo['adapter_params']} adapter "
        f"parameters; median step {lo['step_time_s']:.4f} s, peak {lo['peak_mem_gib']:.2f} GiB "
        f"(phase 5's full stage 2 {train['stage2']['step_time_s']:.4f} s, "
        f"{train['stage2']['peak_mem_gib']:.2f} GiB); retrieval_eval_runtime "
        f"{lo['retrieval_runtime']} s; cli.evaluate over the saved model {lo['offline_s']:.1f} "
        f"s; metrics bit-equal to it {lo['bit_equal_metrics']}; launches {lo['launches']}")
    log(f"numbers ({card}): 5l streaming stage 1: median step {st['step_time_s']:.4f} s (5f "
        f"'full' {features['full']['step_time_s']:.4f}); wall {st['wall_s']:.1f} s; "
        f"retrieval_eval_runtime {st['retrieval']['retrieval_eval_runtime']} s")
    log(f"numbers ({card}): 5l corpus encode of {N_PASSAGES} passages: encode "
        f"{en['encode']['passages_per_s']:.1f} passages/s, pad share "
        f"{en['encode']['pad_share']:.4f}, K1 {en['encode']['launches']}; encode_packed "
        f"{en['encode_packed']['passages_per_s']:.1f} passages/s, pad share "
        f"{en['encode_packed']['pad_share']:.4f}, K1 {en['encode_packed']['launches']}; at "
        f"pack_chunk 1024 {en['encode_packed_1024']['passages_per_s']:.1f} passages/s, pad "
        f"share {en['encode_packed_1024']['pad_share']:.4f}; min cosine {en['min_cosine']:.6f}")
    for label, n in dp["w1"].items():
        log(f"numbers ({card}): 5d stage 1 at world size 1 under NCCL --{label} (full depth): "
            f"median step {n['step_time_s']:.4f} s (phase 5 "
            f"{train['stage1']['step_time_s']:.4f}); peak device memory "
            f"{n['peak_mem_gib']:.2f} GiB (phase 5 {train['stage1']['peak_mem_gib']:.2f}); "
            f"bit-equal to phase 5's stage 1")
    for stage in ("stage1", "stage2"):
        r0, r1, one = dp["ranks"][0][stage], dp["ranks"][1][stage], dp["one"][stage]
        log(f"numbers ({card}): 5d {stage}, two ranks on one card under gloo "
            f"({FEATURE_LAYERS} of 16 layers, global batch 8): median step "
            f"{r0['step_time_s']:.4f} / {r1['step_time_s']:.4f} s (one process "
            f"{one['step_time_s']:.4f}); peak device memory {r0['peak_mem_gib']:.2f} / "
            f"{r1['peak_mem_gib']:.2f} GiB (one process {one['peak_mem_gib']:.2f}); optimizer "
            f"state {r0['state_bytes'] / 1e9:.3f} / {r1['state_bytes'] / 1e9:.3f} GB (one "
            f"process {one['state_bytes'] / 1e9:.3f}); relative difference to one process, "
            f"step 1: loss {dp['checks'][stage]['rel']['loss'][0]:.3e}, gradient norm "
            f"{dp['checks'][stage]['rel']['grad_norm'][0]:.3e}; later steps at most "
            f"{max(dp['checks'][stage]['rel']['loss'][1:]):.3e} / "
            f"{max(dp['checks'][stage]['rel']['grad_norm'][1:]):.3e} (limit "
            f"{DP_HISTORY_RTOL:.0e}); update gap, worst tensor "
            f"{dp['checks'][stage]['update']['worst']:.4e} (limit {DP_UPDATE_GAP}), whole "
            f"model {dp['checks'][stage]['update']['model']:.4e}")
    s4 = multi["serving"]
    log(f"numbers ({card}): 4d serving flat at full depth over two ranks on one card (gloo): "
        f"/search single p50 {s4['p50_ms']:.2f} ms p99 {s4['p99_ms']:.2f} ms (8 clients; "
        f"phase 4 at W = 1 {serving['flat']['search_single_p50_ms']:.2f} / "
        f"{serving['flat']['search_single_p99_ms']:.2f}); batch of 16 p50 "
        f"{s4['batch16_p50_ms']:.2f} ms (W = 1 {serving['flat']['search_batch16_p50_ms']:.2f}); "
        f"rank 0's searches {s4['search_s']:.3f} s, its {s4['gathers']} all-gathers "
        f"{s4['gather_s']:.3f} s ({s4['gather_bytes'] / 1e6:.2f} MB); "
        f"7d refine recall {multi['refine_recall']:.4f}; the two ranks' wall "
        f"{multi['wall_s']:.1f} s")
    log(f"numbers ({card}): 5d launches (K1, K2, K3a, K3b): "
        f"{tuple(dp['launches'][k] for k in KERNELS)}")
    ring0, ring1 = sharded["ring"]
    log(f"numbers ({card}): 5t ring attention {RING_SHAPE} causal over two ranks sharing "
        f"one card (gloo): forward + backward {ring0['ring_s']:.4f} / {ring1['ring_s']:.4f} s "
        f"per rank, one process on the whole sequence {ring0['one_s']:.4f} s; rank 0's "
        f"hops {ring0['hops']['hops']}, {ring0['hops']['bytes'] / 1e6:.1f} MB, "
        f"{ring0['hops']['seconds']:.4f} s; rank 1's {ring1['hops']['hops']}, "
        f"{ring1['hops']['bytes'] / 1e6:.1f} MB, {ring1['hops']['seconds']:.4f} s")
    for stage in ("stage1", "stage2"):
        a, b_ = (r[stage] for r in sharded["tp"]["ranks"])
        c, one = sharded["tp"]["checks"][stage], dp["one"][stage]
        log(f"numbers ({card}): 5t {stage} --model_parallel 2 ({FEATURE_LAYERS} of 16 layers, "
            f"global batch 8): median step {a['step_time_s']:.4f} / {b_['step_time_s']:.4f} s "
            f"(one process {one['step_time_s']:.4f}); parameters {a['param_bytes'] / 1e9:.3f} "
            f"GB a rank; peak device memory {a['peak_mem_gib']:.2f} / "
            f"{b_['peak_mem_gib']:.2f} GiB (one process {one['peak_mem_gib']:.2f}); step 1 "
            f"relative difference loss {c['rel']['loss'][0]:.3e}, gradient norm "
            f"{c['rel']['grad_norm'][0]:.3e}; update gap worst {c['update']['worst']:.4e}")
    log(f"numbers ({card}): 5t launches (K1, K2, K3a, K3b; K3b fp32 "
        f"{sharded['dkv_f32_launches']}): {tuple(sharded['launches'][k] for k in KERNELS)}")
    trained = (train["stage1"], train["stage2"], bge["stage1"], bge["stage2"], qwen2["stage1"],
               mistral["stage1"], mistral["stage2"], gemma["stage1"], gemma["stage2"],
               *mining.values(), *feature_runs, lo, st, dp, sharded)
    launches = {name: sum(n["launches"][name] for n in trained) for name in KERNELS}
    launches["flash_fwd"] += sum(n["launches"]["flash_fwd"] for n in (
        *serving.values(), *mutation.values(), *evaluation.values(),
        *evaluation_bge.values(), *evaluation_mistral.values(), *evaluation_gemma.values(),
        *serving_models.values()))
    launches["flash_fwd"] += sum(en[k]["launches"]
                                 for k in ("encode", "encode_packed", "encode_packed_1024"))
    launches["flash_fwd"] += multi["launches"] + sum(
        r["stage1"]["retrieval"]["offline_k1"] for r in dp["ranks"])
    windowed = {name: mistral["stage1"]["window_launches"][name]
                + mistral["stage2"]["window_launches"][name] for name in KERNELS}
    windowed["flash_fwd"] += (serving_models[MISTRAL]["window_launches"]
                              + evaluation_mistral["flat"]["window_launches"])
    log(f"numbers ({card}): windowed launches on the e5-mistral paths (serving, both "
        f"stages, evaluate): {windowed}")
    for name, n in windowed.items():
        if n <= 0:
            raise AssertionError(f"{name} ran no windowed launch on the e5-mistral paths")
    d256 = {name: gemma["stage1"]["d256_launches"][name]
            + gemma["stage2"]["d256_launches"][name] for name in KERNELS}
    d256["flash_fwd"] += (serving_models[GEMMA]["d256_launches"]
                          + evaluation_gemma["flat"]["d256_launches"])
    log(f"numbers ({card}): launches at head_dim 256 on the gemma-2b paths (serving, both "
        f"stages, evaluate): {d256}")
    for name, n in d256.items():
        if n <= 0:
            raise AssertionError(f"{name} ran no launch at head_dim 256 on the gemma-2b paths")
    packed = {name: sum(n["packed_launches"][name] for n in train_packed.values())
              for name in KERNELS}
    packed["flash_fwd"] += (serving_packed["packed_launches"]["flash_fwd"]
                            + en["encode_packed"]["packed_launches"]
                            + en["encode_packed_1024"]["packed_launches"])
    log(f"numbers ({card}): launches with segments on the packed paths (4p serving, 5p both "
        f"stages, 5l encode_packed): {packed}")
    for name, n in packed.items():
        if n <= 0:
            raise AssertionError(f"{name} ran no launch with segments on the packed paths")
    for name, (_, _, counter) in IVF_KERNELS.items():
        launches[name] = (sum(n["launches"][counter]
                              for n in (*serving.values(), *mutation.values()))
                          + sum(n["launches"] for n in scale["indexes"].values()
                                if n["counter"] == counter)
                          + sum(n["launches"].get(counter, 0) for n in evaluation.values()))
    launches["flash_dkv_f32"] = sharded["dkv_f32_launches"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")
    k = scale["kernels"]
    ivf_rows = {"ivf_probe_scores": k["bfloat16"], "pq_probe_scores": k["pq_rows"],
                "pq_probe_scores_t": k["pq_cols"]}
    # every shape a path ran, held against plain: the timed probe sets, the
    # PQ kernels at the bf16 probe set, the filtered, mutated, split-built
    # and streamed indexes' probe sets, and the odd shapes
    checked = {"ivf_probe_scores": ("bfloat16", "float32", "bf16_filtered", "bf16_mutated",
                                    "bf16_split", "bf16_streamed"),
               "pq_probe_scores": ("pq_rows", "pq_rows_wide", "pq_rows_filtered"),
               "pq_probe_scores_t": ("pq_cols", "pq_cols_wide")}
    served = {"ivf_probe_scores": [mutation["ivf"]["kernel_err"]],
              "pq_probe_scores": [mutation["pq"]["kernel_err"]], "pq_probe_scores_t": []}
    errs = {name: max([k[key]["max_abs_err"] for key in keys] + [scale["odd"][name]]
                      + served[name])
            for name, keys in checked.items()}
    log("phase wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(wall.items())))
    log(f"total run {time.perf_counter() - t_all:.1f} s")
    names = {"flash_fwd": "flash_attention_fwd",
             "flash_bwd_fused": "flash_attention_bwd_fused",
             "flash_dq": "flash_attention_bwd_dq", "flash_dkv": "flash_attention_bwd_dkv"}
    rows = [{
        "name": names[name],
        "route": "cuda",
        "source": f"rankpo_tpu_torch/ops/csrc/{KERNELS[name][1]}",
        "replaces": KERNELS[name][0],
        "launches": launches[name],
        "max_abs_err": kern[name]["max_abs_err"],
        "ms": kern[name]["ms"],
        "plain_ms": kern[name]["plain_ms"],
        "bound_ms": kern[name]["bound_ms"],
        "bound_by": kern[name]["bound_by"],
        "library_ms": kern[name]["library_ms"],
    } for name in KERNELS]
    f32 = kern["flash_dkv_f32"]
    rows.append({
        "name": "flash_attention_bwd_dkv_f32",
        "route": "cuda",
        "source": "rankpo_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": KERNELS["flash_dkv"][0],
        "launches": launches["flash_dkv_f32"],
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    })
    rows += [{
        "name": names[name] + "_packed",
        "route": "cuda",
        "source": f"rankpo_tpu_torch/ops/csrc/{KERNELS[name][1]}",
        "replaces": KERNELS[name][0],
        "launches": packed[name],
        "max_abs_err": kern_packed[name]["max_abs_err"],
        "ms": kern_packed[name]["ms"],
        "plain_ms": kern_packed[name]["plain_ms"],
        "bound_ms": kern_packed[name]["bound_ms"],
        "bound_by": kern_packed[name]["bound_by"],
        "library_ms": kern_packed[name]["library_ms"],
    } for name in KERNELS]
    rows += [{
        "name": name,
        "route": "cuda",
        "source": f"rankpo_tpu_torch/ops/csrc/{IVF_KERNELS[name][1]}",
        "replaces": IVF_KERNELS[name][0],
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": ivf_rows[name]["ms"],
        "plain_ms": ivf_rows[name]["plain_ms"],
        "bound_ms": ivf_rows[name]["bound_ms"],
        "bound_by": ivf_rows[name]["bound_by"],
        "library_ms": ivf_rows[name]["library_ms"],
    } for name in IVF_KERNELS]
    print(json.dumps({"kernels": rows}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
