"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths once through their normal entry points at
the full width and depth of meta-llama/Llama-3.2-1B, with random weights
made from a seed, and checks every hand-written kernel against its plain
PyTorch version. Phases:

0. environment: versions, the card's name and power limit; a CUDA card of
   compute capability 9.0 is required;
1. build: nvcc compiles the kernels from rankpo_tpu_torch/ops/csrc, one
   process per source, all started together;
2. kernels against plain on the card at the encoder's shapes: K1 (flash
   forward), K2 (fused backward), K3a (dq) and K3b (dk/dv), each with its
   kernel time, the plain version's time, the time of the one PyTorch call
   that computes the same function (scaled_dot_product_attention, a
   yardstick the port never calls) and the least time the card could take;
3. exact search on data with exact ties;
4. serving path: a bf16 checkpoint written with the port's save_pretrained,
   a 4096-passage corpus, the HTTP server started by the CLI in a thread,
   single-query requests from 8 client threads and batched requests,
   checked against an exact numpy search over the index rows;
5. training path: stage 1 (``run_contrastive.main``, 512 synthetic rows;
   "auto" picks the fused backward) then stage 2 (``run_rankpo.main`` on
   stage 1's output, 256 synthetic pairs, under
   ``torch.use_deterministic_algorithms``, so "auto" picks the split
   backward): finite losses, every parameter moved, the outputs load, the
   kernels' launch counters rose; one micro-batch through the kernels and
   through the plain attention, both held against the plain attention in
   fp32 compute; one profiled stage-1 step;
6. numbers.

Each path's launch counters are set to 0 just before it runs and read just
after. Any failure raises, so the exit code is not 0 and no result line is
printed. The last line of standard output is a JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import gc
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
N_TRAIN_ROWS = 512
N_PAIRS = 256
WORDS = [f"w{i}" for i in range(30000)]
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
SCORE_ATOL = 1e-5  # cuBLAS and numpy sum the 2048 fp32 products in other orders
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
KERNELS = {  # name -> (TPU kernel it replaces, source, profiler name test)
    "flash_fwd": ("rankpo_tpu/ops/flash_attention.py:55", "flash_fwd.cu",
                  lambda n: "flash_fwd_kernel" in n),
    "flash_bwd_fused": ("rankpo_tpu/ops/flash_attention.py:341", "flash_bwd.cu",
                        lambda n: "flash_bwd_kv_kernel" in n and "true" in n),
    "flash_dq": ("rankpo_tpu/ops/flash_attention.py:161", "flash_bwd.cu",
                 lambda n: "flash_bwd_dq_kernel" in n),
    "flash_dkv": ("rankpo_tpu/ops/flash_attention.py:240", "flash_bwd.cu",
                  lambda n: "flash_bwd_kv_kernel" in n and "false" in n),
}


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


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("profiler events carry no device time")


def profile_device_ms(fn, n: int = 20) -> dict:
    """Device time per kernel name, in ms per call of fn(), over n calls
    traced by torch.profiler (after one warm call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: _device_us(e) / 1e3 / n for e in prof.key_averages()
            if _device_us(e) > 0}


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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def _attention_inputs(b, sq, sk, hq, hkv, d, gen, full=False):
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, sq, hq, d, generator=gen, device="cuda").bfloat16()
    lens = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[-1] = 1, sk  # include a length-1 and a full-length row
    if full:
        lens[:] = sk
    mask = (torch.arange(sk, device="cuda")[None] < lens[:, None]).int()
    return q, k, v, do, mask, lens


def attention_cost(lens, sq, sk, hq, hkv, d, kind: str, design: bool = False):
    """(bytes, FLOPs) the function of kernel ``kind`` must move and compute
    for these key lengths (causal, skip_pad_q, as the encoder calls it):
    query rows at or past the valid length and masked (query, key) pairs are
    not needed; the outputs are written in full, at the dtype and shape
    ``flash_attention_bwd`` returns (bf16; dk/dv summed over each GQA
    group). With ``design``, the backward outputs are counted as the
    kernels write them instead (fp32 dq for K2, fp32 dk/dv per query head):
    the design's own traffic, not a bound."""
    lens = np.asarray(lens.cpu(), dtype=np.int64)
    b = len(lens)
    shift = sk - sq
    rows = np.arange(sq)
    pairs = q_rows = 0
    for n in lens:
        valid_rows = rows[rows + shift < n]
        pairs += int(np.clip(np.minimum(n, valid_rows + shift + 1), 0, None).sum())
        q_rows += len(valid_rows)
    k_rows = int(lens.sum())
    pairs *= hq
    read_q = q_rows * hq * d * 2
    read_kv = 2 * k_rows * hkv * d * 2
    mask = b * sk * 4
    if kind == "flash_fwd":
        return (read_q + read_kv + mask + b * sq * hq * d * 2 + b * hq * sq * 4,
                pairs * 2 * 2 * d)
    reads = 2 * read_q + read_kv + mask + 2 * q_rows * hq * 4  # q, do, k, v, lse, delta
    dq_out = b * sq * hq * d * (4 if design and kind == "flash_bwd_fused" else 2)
    dkv_out = 2 * b * sk * d * (hq * 4 if design else hkv * 2)
    writes, products = {"flash_bwd_fused": (dq_out + dkv_out, 5),
                        "flash_dq": (dq_out, 3), "flash_dkv": (dkv_out, 4)}[kind]
    return reads + writes, pairs * products * 2 * d


def bound(cost) -> tuple:
    nbytes, flops = cost
    t_bytes, t_flops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def _sdpa_mask(mask, sq, sk):
    causal = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq)
    return mask.bool()[:, None, None, :] & causal  # [B, 1, Sq, Sk]


def phase_kernels(seed: int) -> dict:
    """Every kernel against its plain version at the five encoder shapes,
    then times at B 8, S 512 (random lengths and all full)."""
    import torch.nn.functional as F

    from rankpo_tpu_torch.ops.attention import multi_head_attention
    from rankpo_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
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
    err = {name: 0.0 for name in KERNELS}
    worst_lse = 0.0
    for shape in shapes:
        b, sq, sk = shape[:3]
        q, k, v, do, mask, lens = _attention_inputs(*shape, gen)
        with torch.no_grad():
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
        if out_err > OUT_ATOL or lse_err > LSE_ATOL or not zeros:
            raise AssertionError(f"K1 disagrees with plain at {shape}")
        err["flash_fwd"] = max(err["flash_fwd"], out_err)
        worst_lse = max(worst_lse, lse_err)

        # the backward kernels on the kernel's own stats, against the plain
        # backward on the same stats
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        plain = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=True)
        got = {}
        got["fused"] = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                           skip_pad_q=True, bwd_impl="fused")
        got["split"] = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                           skip_pad_q=True, bwd_impl="split")
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
        log(f"kernels {shape}: K1 max|out-plain| {out_err:.3e} max|lse-plain| "
            f"{lse_err:.3e} no-key rows zero {zeros}; backward max|err|/limit and "
            f"relative L2 (limit {BWD_REL_L2:.0e}): " + ", ".join(line)
            + "; median non-zero |plain| dq {:.2e} dk {:.2e} dv {:.2e}".format(*typical))
        del q, k, v, do, out, lse, ref, rlse, plain, got

    # ---- times at the encoder's training shape ----
    shape = shapes[0]
    b, sq, sk, hq, hkv, d = shape
    res = {name: {} for name in KERNELS}
    for label in ("random", "full"):
        q, k, v, do, mask, lens = _attention_inputs(*shape, gen, full=label == "full")
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        calls = {
            "flash_fwd": lambda: flash_attention_fwd(q, k, v, mask, causal=True,
                                                     skip_pad_q=True),
            "fused": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                                 skip_pad_q=True, bwd_impl="fused"),
            "split": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                                 skip_pad_q=True, bwd_impl="split"),
        }
        with torch.no_grad():
            traced = {key: profile_device_ms(fn) for key, fn in calls.items()}
            wrapper = {key: cuda_ms(fn) for key, fn in calls.items()}
            plain_fwd = cuda_ms(lambda: multi_head_attention(q, k, v, mask=mask, causal=True,
                                                             impl="plain"))
            plain_bwd = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, mask, do, lse, delta, causal=True))
            # the yardstick: one PyTorch call on the same inputs (K/V expanded
            # to the query heads outside the timed region) and boolean mask
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kt = kt.repeat_interleave(hq // hkv, dim=1)
            vt = vt.repeat_interleave(hq // hkv, dim=1)
            bmask = _sdpa_mask(mask, sq, sk)
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                     attn_mask=bmask))
        leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        dot = do.transpose(1, 2)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves, attn_mask=bmask)
            torch.autograd.grad(o, leaves, dot)

        lib_bwd = cuda_ms(lib_fwd_bwd)
        kernel_times = {
            "flash_fwd": kernel_ms(traced["flash_fwd"], "flash_fwd"),
            "flash_bwd_fused": kernel_ms(traced["fused"], "flash_bwd_fused"),
            "flash_dq": kernel_ms(traced["split"], "flash_dq"),
            "flash_dkv": kernel_ms(traced["split"], "flash_dkv"),
        }
        for name, ms in kernel_times.items():
            fwd = name == "flash_fwd"
            b_ms, b_by = bound(attention_cost(lens, sq, sk, hq, hkv, d, name))
            design_mb = attention_cost(lens, sq, sk, hq, hkv, d, name, design=True)[0] / 1e6
            res[name][label] = {
                "ms": ms, "plain_ms": plain_fwd if fwd else plain_bwd,
                "library_ms": lib_fwd if fwd else lib_bwd,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            log(f"time {name} at {shape} causal, {label} lengths: kernel {ms:.4f} ms "
                f"(device time, profiler); plain {res[name][label]['plain_ms']:.4f} ms; "
                f"library {res[name][label]['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}; the design's own traffic {design_mb:.1f} MB)")
        log(f"time wrappers ({label} lengths, CUDA events, median of 20): K1 "
            f"{wrapper['flash_fwd']:.4f} ms, fused backward {wrapper['fused']:.4f} ms, "
            f"split backward {wrapper['split']:.4f} ms (backward wrappers include "
            "the dq zero-fill, GQA sums and casts)")
        del q, k, v, do, out, lse, delta, leaves
    torch.cuda.empty_cache()
    log(f"kernels: max|err| K1 {err['flash_fwd']:.3e} (lse {worst_lse:.3e}), K2 "
        f"{err['flash_bwd_fused']:.3e}, K3a {err['flash_dq']:.3e}, K3b "
        f"{err['flash_dkv']:.3e} over the five shapes")
    return {name: dict(res[name]["random"], max_abs_err=err[name],
                       full=res[name]["full"]) for name in KERNELS}


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


def phase_serving(seed: int, tmp: str, ckpt: str) -> dict:
    """The serving path: the CLI's server over a corpus, queried by HTTP."""
    from rankpo_tpu_torch.cli import serve as cli
    from rankpo_tpu_torch.index.flat import numpy_search
    from rankpo_tpu_torch.ops import flash_attention as flash

    rng = np.random.default_rng(seed)
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

    # ---- the serving path: counters from 0, server start, requests ----
    flash.reset_launches()
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
        launches = flash.launches["flash_fwd"]
        # ---- end of the serving path ----
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
        log(f"flash kernel launches on the serving path: {launches}")

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


# ---------------------------------------------------------------------------
def _text(rng, lo, hi) -> str:
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def write_training_data(tmp: str, seed: int):
    """512 contrastive rows (a query of 4-32 words, 1 positive and 7
    negatives of 16-480 words) and 256 preference pairs, from the seed."""
    rng = np.random.default_rng(seed + 1)
    train = os.path.join(tmp, "train.jsonl")
    with open(train, "w") as f:
        for _ in range(N_TRAIN_ROWS):
            f.write(json.dumps({
                "query": _text(rng, 4, 33), "positives": [_text(rng, 16, 481)],
                "negatives": [_text(rng, 16, 481) for _ in range(7)]}) + "\n")
    pairs = os.path.join(tmp, "pairs.jsonl")
    with open(pairs, "w") as f:
        for _ in range(N_PAIRS):
            f.write(json.dumps({
                "query": _text(rng, 4, 33), "passage1": _text(rng, 16, 481),
                "passage2": _text(rng, 16, 481),
                "preferred": "AB"[int(rng.integers(2))]}) + "\n")
    return train, pairs


def _median(history, key):
    values = [h[key] for h in history[1:] if key in h]  # the first step left out
    return float(np.median(values)) if values else None


def run_stage(name: str, main, argv, out_dir: str, state_before: dict,
              deterministic: bool = False):
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
    # ---- end of the stage's path ----
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in history]
    if len(history) != 8 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: expected 8 finite losses, got {losses}")
    if not all(np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"{name}: non-finite gradient norm")
    _, state = load_pretrained(out_dir)
    still = [n for n in state if torch.equal(state[n], state_before[n].float())]
    if still:
        raise AssertionError(f"{name}: {len(still)} parameter tensors did not move, "
                             f"e.g. {still[:3]}")
    log(f"{name}: 8 steps, losses {[round(x, 4) for x in losses]}; all "
        f"{len(state)} parameter tensors moved; {out_dir} loads with load_pretrained")
    return {
        "first_loss": losses[0], "last_loss": losses[-1],
        "step_time_s": _median(history, "step_time"),
        "samples_per_sec": _median(history, "samples_per_sec"),
        "tokens_per_sec": _median(history, "tokens_per_sec"),
        "mfu": _median(history, "mfu"),
        "peak_mem_gib": peak_gib, "wall_s": wall, "launches": launches,
    }, state


def _device_batch(collated: dict) -> dict:
    return {field: {"input_ids": torch.from_numpy(block["input_ids"]).long().cuda(),
                    "attention_mask": torch.from_numpy(block["attention_mask"]).cuda()}
            for field, block in collated.items()}


def phase_flash_vs_plain(config, state, train_file: str, seed: int):
    """One stage-1 micro-batch (2 queries x group 4) at full width through
    the kernels (bf16) and through the plain attention (bf16), each held
    against the plain path in fp32 compute, the reference.

    At temperature 0.02 the logits are cosines x 50, so the plain bf16
    path's own rounding (bf16 softmax) moves its loss by about 2e-2 from
    fp32: the kernels' loss (fp32 softmax statistics) is held to the fp32
    loss within LOSS_REL_FP32, and every gradient tensor within cosine 0.99
    of the plain bf16 one."""
    from rankpo_tpu_torch.data.collators import ContrastiveCollator
    from rankpo_tpu_torch.data.datasets import ContrastiveDataset, iter_jsonl
    from rankpo_tpu_torch.data.tokenization import HashTokenizer
    from rankpo_tpu_torch.models.llama import LlamaEncoder
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn

    rows = [r for _, r in zip(range(2), iter_jsonl(train_file))]
    ds = ContrastiveDataset(rows, HashTokenizer(vocab_size=128256), 128, 512)
    batch = _device_batch(ContrastiveCollator(0, 3, 128, 512, seed=seed)([ds[0], ds[1]]))
    model = LlamaEncoder.for_training(config, state, device="cuda")
    params = list(model.named_parameters())
    results = {}
    for label, impl, dtype in (("flash", "flash", torch.bfloat16),
                               ("plain", "plain", torch.bfloat16),
                               ("fp32", "plain", torch.float32)):
        model.compute_dtype = dtype
        loss, _ = make_contrastive_loss_fn(config, temperature=0.02, attn_impl=impl)(
            model, batch)
        loss.backward()
        results[label] = (loss.item(), [p.grad for _, p in params])
        for _, p in params:
            p.grad = None
    model.compute_dtype = torch.bfloat16
    (lf, gf), (lp, gp), (l32, g32) = results["flash"], results["plain"], results["fp32"]

    def cosines(a, b):
        return [torch.nn.functional.cosine_similarity(x.flatten(), y.flatten(), dim=0).item()
                for x, y in zip(a, b)]

    cos, cos32 = cosines(gf, gp), cosines(gf, g32)
    rel, rel_f32, rel_p32 = abs(lf - lp) / abs(lp), abs(lf - l32) / abs(l32), abs(lp - l32) / abs(l32)
    worst = int(np.argmin(cos))
    log(f"flash vs plain, one micro-batch at full width: loss flash {lf:.6f}, plain "
        f"{lp:.6f}, plain fp32 {l32:.6f}; relative difference flash-plain {rel:.3e}, "
        f"flash-fp32 {rel_f32:.3e} (limit {LOSS_REL_FP32:.0e}), plain-fp32 {rel_p32:.3e}; "
        f"gradient cosine flash-plain min {cos[worst]:.6f} ({params[worst][0]}), median "
        f"{np.median(cos):.6f} over {len(cos)} tensors (limit 0.99); flash-fp32 min "
        f"{min(cos32):.6f}")
    if rel_f32 > LOSS_REL_FP32 or min(cos) < 0.99:
        raise AssertionError("training gradients through the kernels disagree with plain")
    del results, gf, gp, g32
    return model, {"loss_rel_flash_plain": rel, "loss_rel_flash_fp32": rel_f32,
                   "loss_rel_plain_fp32": rel_p32, "min_grad_cosine": cos[worst],
                   "min_grad_cosine_fp32": min(cos32)}


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
    stage1, s1_state = run_stage("stage 1 (contrastive, fused backward)",
                                 run_contrastive.main, [
        "--model_name_or_path", ckpt, "--train_data", train, "--output_dir", s1,
        "--num_negatives", "3", "--gradient_accumulation_steps", "2",
        "--temperature", "0.02", "--lr_scheduler_type", "cosine",
        "--warmup_ratio", "0.1", "--gradient_checkpointing", "True", *common], s1, base_state)
    stage2, _ = run_stage("stage 2 (RankPO, deterministic: split backward)", run_rankpo.main, [
        "--model_name_or_path", s1, "--train_data", pairs, "--output_dir", s2,
        "--beta", "2.0", "--temperature", "0.1", "--loss_type", "sigmoid",
        "--reference_free", "True", *common], s2, s1_state, deterministic=True)
    del s1_state
    # 16 layers x 2 fields (query, passage) x micro-steps; stage 1 also runs
    # each forward again in the checkpointed backward
    need = {"stage1": {"flash_fwd": 2 * 16 * 2 * 16, "flash_bwd_fused": 16 * 2 * 16},
            "stage2": {"flash_fwd": 16 * 2 * 8, "flash_dq": 16 * 2 * 8,
                       "flash_dkv": 16 * 2 * 8}}
    for stage, nums in (("stage1", stage1), ("stage2", stage2)):
        for kernel, least in need[stage].items():
            if nums["launches"][kernel] < least:
                raise AssertionError(f"{stage}: {kernel} launched "
                                     f"{nums['launches'][kernel]} times, expected >= {least}")
        log(f"{stage} kernel launches: {nums['launches']}")
    config = EncoderConfig.from_pretrained(ckpt)
    model, compare = phase_flash_vs_plain(config, base_state, train, seed)
    profile_nums = phase_profile(model, config, train, seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"stage1": stage1, "stage2": stage2, "compare": compare,
            "profile": profile_nums}


# ---------------------------------------------------------------------------
def make_checkpoint(tmp: str, seed: int):
    """Random Llama-3.2-1B weights from the seed, written in bf16 with the
    port's save_pretrained. Returns (path, the state on the host)."""
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.models.hf_io import save_pretrained
    from rankpo_tpu_torch.models.llama import init_params, n_params

    config = EncoderConfig(rope_scaling=LLAMA3_SCALING, pad_token_id=0,
                           architectures=("LlamaForCausalLM",))
    t0 = time.perf_counter()
    state = init_params(config, torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.bfloat16)
    ckpt = os.path.join(tmp, "ckpt")
    save_pretrained(ckpt, config, state, dtype=torch.bfloat16)
    state = {n: t.cpu() for n, t in state.items()}
    torch.cuda.empty_cache()
    log(f"checkpoint: {n_params(config) / 1e9:.3f}B parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s to make and write")
    return ckpt, state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    t_all = time.perf_counter()
    # cuBLAS repeats its results only with a fixed workspace, read at its
    # first call; stage 2 runs under torch.use_deterministic_algorithms,
    # which refuses cuBLAS without it. ":4096:8" is the size PyTorch
    # already picks on Hopper.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = phase_environment()
    phase_build()
    kern = phase_kernels(args.seed)
    phase_search_ties()
    with tempfile.TemporaryDirectory(prefix="rankpo_smoke_") as tmp:
        ckpt, base_state = make_checkpoint(tmp, args.seed)
        nums = phase_serving(args.seed, tmp, ckpt)
        gc.collect()
        torch.cuda.empty_cache()
        train = phase_training(ckpt, tmp, args.seed, base_state)
    log(f"numbers ({card}): serving startup (load + encode + index) "
        f"{nums['startup_s']:.2f} s; corpus encode {nums['encode_s']:.3f} s = "
        f"{nums['passages_per_s']:.1f} passages/s, {nums['tokens_per_s']:.0f} "
        f"tokens/s ({nums['corpus_tokens']} tokens); /search single p50 "
        f"{nums['search_single_p50_ms']:.2f} ms p99 "
        f"{nums['search_single_p99_ms']:.2f} ms (8 clients); batch of 16 p50 "
        f"{nums['search_batch16_p50_ms']:.2f} ms; peak device memory "
        f"{nums['peak_mem_gib']:.2f} GiB")
    for stage in ("stage1", "stage2"):
        s = train[stage]
        mfu = "not known for this card" if s["mfu"] is None else f"{s['mfu']:.4f}"
        log(f"numbers ({card}): {stage}: median step {s['step_time_s']:.4f} s "
            f"(steps 2-8); {s['samples_per_sec']:.2f} samples/s, "
            f"{s['tokens_per_sec']:.1f} tokens/s (padded, as the trainer logs them); "
            f"MFU {mfu} (trainer's log, 989 TFLOP/s peak); peak device memory "
            f"{s['peak_mem_gib']:.2f} GiB; loss {s['first_loss']:.4f} -> "
            f"{s['last_loss']:.4f}; wall {s['wall_s']:.1f} s; K1 launches "
            f"{s['launches']['flash_fwd']}, K2 {s['launches']['flash_bwd_fused']}, "
            f"K3a {s['launches']['flash_dq']}, K3b {s['launches']['flash_dkv']}")
    launches = {name: train["stage1"]["launches"][name] + train["stage2"]["launches"][name]
                for name in KERNELS}
    launches["flash_fwd"] += nums["launches"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")
    log(f"total run {time.perf_counter() - t_all:.1f} s")
    names = {"flash_fwd": "flash_attention_fwd",
             "flash_bwd_fused": "flash_attention_bwd_fused",
             "flash_dq": "flash_attention_bwd_dq", "flash_dkv": "flash_attention_bwd_dkv"}
    print(json.dumps({"kernels": [{
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
    } for name in KERNELS]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
