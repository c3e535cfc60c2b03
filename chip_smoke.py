"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's serving path once through its normal entry point
(``rankpo_tpu_torch.cli.serve``) at the full width of meta-llama/Llama-3.2-1B
with random weights made from a seed, and checks the hand-written kernel
against its plain PyTorch version. Phases:

0. environment: versions, the card's name and power limit; a CUDA card of
   compute capability 9.0 is required;
1. build: nvcc compiles the kernels from rankpo_tpu_torch/ops/csrc;
2. kernel against plain on the card, at the shapes the encoder gives it;
3. main path: a bf16 checkpoint written with the port's save_pretrained, a
   4096-passage corpus, the HTTP server started by the CLI in a thread,
   single-query requests from 8 client threads (micro-batched) and batched
   requests; replies are checked against an exact numpy search over the
   index rows, and the kernel's launch counter must have risen;
4. numbers: corpus encode rate, /search latency, peak device memory.

Any failure raises, so the exit code is not 0 and no result line is printed.
The last line of standard output is a JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Llama-3.2-1B (public config.json): the widths of the repo's EncoderConfig
# defaults plus its llama3 RoPE scaling; tied embeddings
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}
N_PASSAGES = 4096
WORDS = [f"w{i}" for i in range(30000)]
OUT_ATOL = 1.5e-2  # bf16 output rounding (values of order 1) and bf16 P
LSE_ATOL = 1e-5
SCORE_ATOL = 1e-5  # cuBLAS and numpy sum the 2048 fp32 products in other orders


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn() (after warmup calls)."""
    times = []
    for i in range(warmup + n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


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
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _attention_inputs(b, sq, sk, hq, hkv, d, gen):
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    lens = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[-1] = 1, sk  # include a length-1 and a full-length row
    mask = (torch.arange(sk, device="cuda")[None] < lens[:, None]).int()
    return q, k, v, mask, lens


def phase_kernel(seed: int) -> dict:
    from rankpo_tpu_torch.ops.attention import multi_head_attention
    from rankpo_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [  # (B, Sq, Sk, Hq, Hkv, D), all causal with skip_pad_q as the encoder
        (8, 512, 512, 32, 8, 64),
        (64, 64, 64, 32, 8, 64),
        (8, 40, 40, 32, 8, 64),
        (8, 64, 128, 32, 8, 64),
        (8, 256, 256, 16, 8, 128),
    ]
    worst_out = worst_lse = 0.0
    with torch.inference_mode():
        for shape in shapes:
            b, sq, sk = shape[:3]
            q, k, v, mask, lens = _attention_inputs(*shape, gen)
            out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
            ref, rlse = flash_attention_fwd_reference(
                q.float(), k.float(), v.float(), mask, causal=True)
            torch.cuda.synchronize()
            # skip_pad_q zeroes whole query tiles past the valid length:
            # only rows below it are compared
            rows = (torch.arange(sq, device="cuda")[None] + sk - sq) < lens[:, None]
            out_err = (out.float() - ref).abs().amax(dim=(2, 3))[rows].max().item()
            has_key = rlse > -1e29
            keep = rows[:, None, :] & has_key
            lse_err = (lse - rlse).abs()[keep].max().item()
            nokey = ~has_key.permute(0, 2, 1)
            zeros = bool(torch.all(out.abs().amax(-1)[nokey] == 0))
            log(f"kernel {shape}: max|out-plain| {out_err:.3e} "
                f"max|lse-plain| {lse_err:.3e} no-key rows zero {zeros}")
            if out_err > OUT_ATOL or lse_err > LSE_ATOL or not zeros:
                raise AssertionError(f"kernel disagrees with plain at {shape}")
            worst_out, worst_lse = max(worst_out, out_err), max(worst_lse, lse_err)

        q, k, v, mask, _ = _attention_inputs(*shapes[0], gen)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, causal=True,
                                                 skip_pad_q=True))
        plain_ms = cuda_ms(lambda: multi_head_attention(
            q, k, v, mask=mask, causal=True, impl="plain"))
    log(f"kernel time at {shapes[0]}: {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(median of 20)")
    return {"max_abs_err": worst_out, "max_lse_err": worst_lse, "ms": ms,
            "plain_ms": plain_ms}


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


def _check_reply(status, body, n_queries, k):
    if status != 200 or len(body["results"]) != n_queries:
        raise AssertionError(f"bad reply {status}: {str(body)[:200]}")
    for res in body["results"]:
        scores = [h["score"] for h in res["hits"]]
        if len(scores) != k:
            raise AssertionError(f"{len(scores)} hits, expected {k}")
        if any(a < b for a, b in zip(scores, scores[1:])):
            raise AssertionError("scores not non-increasing")
        if max(abs(s) for s in scores) > 1 + 1e-3:
            raise AssertionError("|score| > 1 for normalised embeddings")


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
        raise AssertionError("served indices differ from numpy_search")
    return int((~clear).sum())


def phase_main_path(card: str, seed: int) -> dict:
    from rankpo_tpu_torch.cli import serve as cli
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.models.hf_io import save_pretrained
    from rankpo_tpu_torch.models.llama import init_params, n_params
    from rankpo_tpu_torch.ops import flash_attention as flash

    config = EncoderConfig(rope_scaling=LLAMA3_SCALING, pad_token_id=0,
                           architectures=("LlamaForCausalLM",))
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="rankpo_smoke_") as tmp:
        t0 = time.perf_counter()
        state = init_params(config, torch.Generator(device="cuda").manual_seed(seed),
                            dtype=torch.bfloat16)
        ckpt = os.path.join(tmp, "ckpt")
        save_pretrained(ckpt, config, state, dtype=torch.bfloat16)
        del state
        torch.cuda.empty_cache()
        log(f"checkpoint: {n_params(config) / 1e9:.3f}B parameters, bf16, "
            f"{time.perf_counter() - t0:.1f} s to make and write")

        lengths = rng.integers(16, 481, N_PASSAGES)
        corpus = [" ".join(rng.choice(WORDS, size=n)) for n in lengths]
        corpus_file = os.path.join(tmp, "corpus.jsonl")
        with open(corpus_file, "w") as f:
            for text in corpus:
                f.write(json.dumps({"text": text}) + "\n")
        queries = [" ".join(rng.choice(WORDS, size=n))
                   for n in rng.integers(4, 33, 64)]

        port = _free_port()
        argv = ["--model_name_or_path", ckpt, "--tokenizer_name", "hash:128256",
                "--corpus_data", corpus_file, "--max_query_length", "512",
                "--max_passage_length", "512", "--batch_size", "64",
                "--device", "cuda", "--port", str(port), "--log_level", "warning"]
        holder: dict = {}

        def run_server():
            try:
                holder["server"] = cli.make_server(argv)
                holder["server"].serve_forever()
            except BaseException as e:  # reported by the polling loop below
                holder["error"] = e
                raise

        # ---- the main path: counters from 0, server start, requests ----
        flash.launches = 0
        torch.cuda.reset_peak_memory_stats()
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
                if health["ntotal"] == N_PASSAGES:
                    break
            if time.perf_counter() - t_start > 900:
                raise TimeoutError("server did not come up")
            time.sleep(0.5)
        startup_s = time.perf_counter() - t_start
        server = holder["server"]
        service = server.service
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
                                group, k))
            launches = flash.launches
            # ---- end of the main path ----
            peak_gib = torch.cuda.max_memory_allocated() / 2**30

            for (status, body, _), i in singles:
                _check_reply(status, body, 1, (10, 100)[i % 2])
            for (status, body, _), group, k in batched:
                _check_reply(status, body, len(group), k)
            stats = _http(port, "/statsz")[1]
            log(f"served: 32 single queries from 8 clients in "
                f"{stats['microbatch_dispatches']} micro-batches, "
                f"4 batched requests of 16")

            n_batches = -(-N_PASSAGES // 64)
            if launches < 16 * n_batches:
                raise AssertionError(
                    f"flash kernel launched {launches} times on the main path; "
                    f"expected >= {16 * n_batches} (16 layers x {n_batches} "
                    "encode batches)")
            log(f"flash kernel launches on the main path: {launches}")

            # the index against the exact numpy oracle: each batched request
            # embedded again exactly as the service embedded it
            rows = service.index.rows()
            n_near = 0
            for (_, body, _), group, k in batched:
                batch = service.encoder.prepare_batch(group, len(group), 512)
                q_emb = service.encoder.embed_batch(batch).cpu().numpy()
                # one extra oracle rank: a near-tie across the k boundary
                o_scores, o_idx = numpy_search(rows, q_emb, k + 1)
                s_idx = np.array([[h["index"] for h in r["hits"]] for r in body["results"]])
                s_sc = np.array([[h["score"] for h in r["hits"]] for r in body["results"]])
                n_near += _check_against_oracle(s_idx, s_sc, o_scores, o_idx)
            log(f"index: served top-k equal to numpy_search over the index rows "
                f"({n_near} hits inside {SCORE_ATOL} near-ties not compared)")

            # the kernel inside the encoder against the plain attention
            batch = service.encoder.prepare_batch(corpus[:64], 64, 512)
            a = service.encoder.embed_batch(batch, attn_impl="auto")
            p = service.encoder.embed_batch(batch, attn_impl="plain")
            cos = torch.nn.functional.cosine_similarity(a, p).min().item()
            log(f"encoder: min cosine kernel vs plain over 64 passages {cos:.6f}")
            if cos < 0.999:
                raise AssertionError("encoder embeddings through the kernel disagree")

            # numbers: a timed re-encode of the corpus, request latencies
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
            lat = np.array([r[0][2] for r in singles]) * 1e3
            lat_b = np.array([r[0][2] for r in batched]) * 1e3
            numbers = {
                "card": card,
                "startup_s": startup_s,
                "encode_s": enc_s,
                "passages_per_s": N_PASSAGES / enc_s,
                "tokens_per_s": n_tokens / enc_s,
                "corpus_tokens": n_tokens,
                "search_single_p50_ms": float(np.percentile(lat, 50)),
                "search_single_p99_ms": float(np.percentile(lat, 99)),
                "search_batch16_p50_ms": float(np.percentile(lat_b, 50)),
                "peak_mem_gib": peak_gib,
                "launches": launches,
            }
        finally:
            server.shutdown()
            if server.batcher is not None:
                server.batcher.close()
            server.server_close()
            thread.join(timeout=60)
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    card = phase_environment()
    phase_build()
    kern = phase_kernel(args.seed)
    phase_search_ties()
    nums = phase_main_path(card, args.seed)
    log(f"numbers ({card}): startup (load + encode + index) "
        f"{nums['startup_s']:.2f} s; corpus encode {nums['encode_s']:.3f} s = "
        f"{nums['passages_per_s']:.1f} passages/s, {nums['tokens_per_s']:.0f} "
        f"tokens/s ({nums['corpus_tokens']} tokens); /search single p50 "
        f"{nums['search_single_p50_ms']:.2f} ms p99 "
        f"{nums['search_single_p99_ms']:.2f} ms (8 clients); batch of 16 p50 "
        f"{nums['search_batch16_p50_ms']:.2f} ms; peak device memory "
        f"{nums['peak_mem_gib']:.2f} GiB")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "rankpo_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "rankpo_tpu/ops/flash_attention.py:55",
        "launches": nums["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
