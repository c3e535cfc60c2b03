"""K4 (IVF probed-block scores) of this checkout and of another, on the same
inputs, in turns on one card.

    python3 scripts/ivf_gather_compare.py [--parent DIR] [--seed 0]

Builds the scale phase's data and bf16 index from the seed through
``chip_smoke``'s helpers (2^20 unit rows at D 2048 around 8192 centres,
``IVFIPIndex(recall_target=0.95)``) and takes the probe sets of its first 64
queries at P 8, 32, 64 and the tuned nprobe. For bf16 rows and fp32 rows
(the same index's rows as fp32) at each P it prints: the distinct probed
blocks, the mean and largest number of (query, probe) pairs per block, the
bytes each version reads from the corpus (the parent's kernel one block per
pair, this checkout's one block per chunk of 8 pairs), each version's time,
the bound, and whether the two outputs are bit-equal.

Times: CUDA events around one call of each version's ``probe_scores`` (this
checkout's with its grouping of the pairs) on cold L2, median of 20, in the
order parent, change, change, parent (change twice alone without
``--parent``). The parent's library is built from its own sources and
loaded through a ctypes handle of its own, beside this checkout's, in this
process; its C entry point takes ``probe`` itself. The card's name and
power limit open and close the output.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

P_SWEEP = (8, 32, 64)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parent_fn(parent: str):
    """The parent checkout's K4 entry point (probe-indexed signature), built
    from its sources into its own build directory."""
    build = _module("parent_build", os.path.join(parent, "rankpo_tpu_torch", "ops", "_build.py"))
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"build parent: {time.perf_counter() - t0:.1f} s", flush=True)
    fn = lib.rankpo_ivf_probe_scores
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def probe_scores(corpus, probe32, queries, cap):
        q_n, p_n = probe32.shape
        out = torch.empty((q_n, p_n, cap), dtype=torch.float32, device=corpus.device)
        rc = fn(corpus.data_ptr(), probe32.data_ptr(), queries.data_ptr(), out.data_ptr(),
                corpus.shape[0] // cap, q_n, p_n, cap, corpus.shape[1],
                int(corpus.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent K4 launch failed: cudaError {rc}")
        return out

    return probe_scores


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None, help="another checkout's root")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    smoke = _module("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    from rankpo_tpu_torch.index.ivf import IVFIPIndex
    from rankpo_tpu_torch.ops import _build, ivf_gather

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build change: {time.perf_counter() - t0:.1f} s", flush=True)
    ours = False
    for line in _build.build_log().splitlines():  # nvcc's register and spill report
        if "Compiling entry" in line:
            ours = "ivf_probe" in line
        if ours and any(key in line for key in ("Compiling entry", "registers", "spill")):
            print(f"ptxas: {line.strip()}", flush=True)
    versions = {"change": lambda c, p, q, cap: ivf_gather.probe_scores(c, p, q, cap=cap)}
    order = ["change", "change"]
    if args.parent:
        versions["parent"] = _parent_fn(os.path.abspath(args.parent))
        order = ["parent", "change", "change", "parent"]

    t0 = time.perf_counter()
    corpus, queries = smoke.make_scale_data(args.seed)
    index = IVFIPIndex(corpus, recall_target=0.95)
    torch.cuda.synchronize()
    del corpus
    print(f"index: K {index.n_clusters}, capacity {index.capacity}, tuned nprobe "
          f"{index.nprobe}, data and build {time.perf_counter() - t0:.1f} s", flush=True)
    q = queries[:64].contiguous()
    tuned, _ = index._effective_probe(100, None)
    cap, k_n = index.capacity, index.n_clusters
    for dtype in (torch.bfloat16, torch.float32):
        rows = index.corpus if dtype == torch.bfloat16 else index.corpus.float()
        d = rows.shape[1]
        block_bytes = cap * d * rows.element_size()
        for p in (*P_SWEEP, tuned):
            probe32 = index._probe_clusters(q, p)[0].to(torch.int32).contiguous()
            counts = torch.bincount(probe32.flatten().long(), minlength=k_n)
            blocks, reads = smoke.probe_block_reads(probe32, k_n)
            per_block = counts[counts > 0].float()
            outs, times = {}, {v: [] for v in versions}
            for v in order:
                fn = versions[v]
                outs[v] = fn(rows, probe32, q, cap)
                times[v].append(smoke.cuda_ms(lambda fn=fn: fn(rows, probe32, q, cap),
                                              before=smoke._l2_flush))
            group_ms = smoke.cuda_ms(lambda: ivf_gather.group_probes(probe32, k_n),
                                     before=smoke._l2_flush)
            out_bytes = q.shape[0] * p * cap * 4
            bound_ms = smoke.bound((blocks * block_bytes + q.numel() * 4 + probe32.numel() * 4
                                    + out_bytes, q.shape[0] * p * cap * d * 2),
                                   smoke.PEAK_FP32_FLOPS)[0]
            equal = ("parent" not in outs) or torch.equal(outs["parent"], outs["change"])
            read = {"change": reads * block_bytes, "parent": probe32.numel() * block_bytes}
            line = ", ".join(f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms (reads "
                             f"{read[v] / 1e9:.3f} GB)" for v, ts in times.items())
            print(f"K4 {str(dtype).split('.')[1]} rows, Q {q.shape[0]}, P {p}, cap {cap}, D {d}: "
                  f"{blocks} distinct blocks, pairs per block mean {per_block.mean().item():.2f} "
                  f"max {int(per_block.max().item())}, {reads - blocks} chunk re-reads; {line}; "
                  f"grouping alone {group_ms:.4f} ms; bound {bound_ms:.4f} ms; parent and "
                  f"change bit-equal {equal}", flush=True)
            if not equal:
                raise SystemExit("the two versions' scores differ")
        del rows
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
