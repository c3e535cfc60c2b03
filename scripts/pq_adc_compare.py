"""K5/K6 (PQ ADC scores) of this checkout and of another, on the same inputs,
in turns on one card.

    python3 scripts/pq_adc_compare.py [--parent DIR] [--seed 0] [--split]

Builds the scale phase's data and PQ64 index from the seed through
``chip_smoke``'s helpers (2^20 unit rows at D 2048 around 8192 centres,
``IVFIPIndex(recall_target=0.95, pq_m=64)``: K 4096, cap 384, m 64); the
same codes serve as rows ``[K * cap, m]`` (K5) and, transposed, as columns
``[m, K * cap]`` (K6). Shapes: the index's first 64 queries at P 1 (the
tuned path), 8, 32, 64 and 179 (the bf16 index's probe set), and the served
``IVF64,PQ64`` tier's shape (K 64, cap 128, m 64, P 18 of 64 clusters) at
Q 1 and Q 16 on random codes and tables. For each shape and layout it prints
this checkout's launch plan and route, each version's time, whether the
two outputs are bit-equal, the byte bound (distinct probed blocks, tables,
probe ids and scores at 3.35 TB/s) and the lookup floor: Q·P·cap·m table
reads at 32 per clock on each of 132 SMs at the SM clock ``nvidia-smi``
reads as the card's maximum. It also times this checkout's kernel on
route "ldg" (the plan for unaligned codes) at every shape and, at P 1 and
the served shapes, with boxes of half the width on twice the blocks.

With ``--split`` it also builds two altered copies of this checkout's
kernel and times them at P 1 and 179 (route "tma"): one without the table
reads (each code adds its own value, so only the code boxes and the
pipeline remain) and one without the code boxes (the ring's barriers are
released at once and the lookups read whatever the ring holds). Their
outputs are not scores; they show which side bounds the kernel. It also
prints the mean bank conflict of the lookups: over warps of 32 consecutive
probed slots (8 queries at P 179) and each subspace, the most distinct
table words that one of the 32 banks is asked for (1 is conflict-free),
beside the same for uniform random codes.

Times: CUDA events around one call of each version on cold L2, median of
20, in the order parent, change, change, parent (change twice alone without
``--parent``). The parent's library is built from its own sources and
loaded through a ctypes handle of its own, beside this checkout's, in this
process; its C entry point takes no plan. The card's name and power limit
open and close the output; the script stops if two outputs differ.
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

P_SWEEP = (1, 8, 32, 64, 179)
SERVED = (64, 128, 18)  # K, cap, P of the served IVF64,PQ64 tier


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parent_fn(parent: str):
    """The parent checkout's K5/K6 entry point (no plan arguments), built
    from its sources into its own build directory."""
    build = _module("parent_build", os.path.join(parent, "rankpo_tpu_torch", "ops", "_build.py"))
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"build parent: {time.perf_counter() - t0:.1f} s", flush=True)
    fn = lib.rankpo_pq_adc_scores
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def scores(codes, probe32, lut, cap, layout):
        q_n, p_n = probe32.shape
        m = codes.shape[layout == 0]
        n_slots = codes.numel() // m
        out = torch.empty((q_n, p_n, cap), dtype=torch.float32, device=codes.device)
        rc = fn(codes.data_ptr(), probe32.data_ptr(), lut.data_ptr(), out.data_ptr(),
                n_slots // cap, q_n, p_n, cap, m, layout,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent K5/K6 launch failed: cudaError {rc}")
        return out

    return scores


# --split: the altered copies of ops/csrc/pq_adc.cu, as (old text, new text)
SPLIT_EDITS = {
    "no table reads": [
        ("  a += t[w & 255u];\n  a += t[kPqK + ((w >> 8) & 255u)];\n"
         "  a += t[2 * kPqK + ((w >> 16) & 255u)];\n  a += t[3 * kPqK + (w >> 24)];",
         "  a += (float)(w & 255u);"),
        ("    acc[0] += tj[w & 255u];\n    acc[1] += tj[(w >> 8) & 255u];\n"
         "    acc[2] += tj[(w >> 16) & 255u];\n    acc[3] += tj[w >> 24];",
         "    acc[0] += (float)(w & 255u);"),
    ],
    "no code boxes": [
        ("mbar_arrive_expect_tx(bar, (uint32_t)(n_valid * box));", "mbar_arrive(bar);"),
        ("tma_load_2d(dst + u * box, codes_map, bar, s0, c * kMChunk);", "(void)s0;"),
        ("tma_load_2d(dst + u * box, codes_map, bar, c * rb, s0);", "(void)s0;"),
    ],
}


def _split_fns(build_dir: str):
    """ctypes entry points of the --split copies, built with nvcc."""
    from rankpo_tpu_torch.ops import _build

    os.makedirs(build_dir, exist_ok=True)
    src = (_build.CSRC / "pq_adc.cu").read_text()
    fns = {}
    for name, edits in SPLIT_EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"--split: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        tag = name.replace(" ", "_")
        cu, so = os.path.join(build_dir, f"{tag}.cu"), os.path.join(build_dir, f"{tag}.so")
        with open(cu, "w") as f:
            f.write(text)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-shared", "-o", so, cu], check=True, capture_output=True)
        fn = ctypes.CDLL(so).rankpo_pq_adc_scores
        fn.argtypes = _build._SIGNATURES["rankpo_pq_adc_scores"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None, help="another checkout's root")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--split", action="store_true",
                        help="also time the kernel without table reads and without code boxes")
    args = parser.parse_args()
    smoke = _module("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    card, clock_mhz = smoke.card_line(), smoke.sm_clock_mhz()
    print(f"card: {card}; SM clock (max) {clock_mhz:.0f} MHz", flush=True)
    from rankpo_tpu_torch.index.ivf import PQ_K, IVFIPIndex, _bf16
    from rankpo_tpu_torch.ops import _build, pq_adc

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build change: {time.perf_counter() - t0:.1f} s", flush=True)
    ours = False
    for line in _build.build_log().splitlines():  # nvcc's register and spill report
        if "Compiling entry" in line:
            ours = "pq_adc" in line
        if ours and any(key in line for key in ("Compiling entry", "registers", "spill")):
            print(f"ptxas: {line.strip()}", flush=True)

    def change(codes, probe32, lut, cap, layout, plan=None):
        m = codes.shape[layout == 0]
        return pq_adc._launch(codes, probe32, lut, cap, m, codes.numel() // m, layout, plan)

    versions = {"change": change}
    order = ["change", "change"]
    if args.parent:
        versions["parent"] = _parent_fn(os.path.abspath(args.parent))
        order = ["parent", "change", "change", "parent"]

    def compare(label, codes, probe32, lut, cap, layout, variants=()):
        q_n, p_n = probe32.shape
        m = codes.shape[layout == 0]
        k_n = codes.numel() // m // cap
        ids = probe32.flatten().long()
        blocks = int(torch.unique(ids[(ids >= 0) & (ids < k_n)]).numel())
        nbytes = (blocks * cap * m + lut.numel() * 4 + probe32.numel() * 4
                  + q_n * p_n * cap * 4)
        bound_ms = nbytes / smoke.PEAK_HBM_BYTES * 1e3
        lookups = q_n * p_n * cap * m
        floor_ms = lookups / (smoke.PQ_LOOKUPS_PER_CLOCK * clock_mhz * 1e6) * 1e3
        plan = pq_adc.plan_for(codes, probe32, cap, m)
        outs, times = {}, {v: [] for v in versions}
        for v in order:
            fn = versions[v]
            outs[v] = fn(codes, probe32, lut, cap, layout)
            times[v].append(smoke.cuda_ms(lambda fn=fn: fn(codes, probe32, lut, cap, layout),
                                          before=smoke._l2_flush))
        equal = ("parent" not in outs) or torch.equal(outs["parent"], outs["change"])
        line = ", ".join(f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                         for v, ts in times.items())
        print(f"{label} {('rows', 'cols')[layout]}, Q {q_n}, P {p_n}, cap {cap}, m {m}: "
              f"{blocks} distinct blocks; plan {plan}; {line}; bound {bound_ms:.4f} ms "
              f"(bytes, {nbytes / 1e6:.2f} MB); lookup floor {floor_ms:.4f} ms "
              f"({lookups / 1e6:.1f} M lookups); parent and change bit-equal {equal}",
              flush=True)
        if not equal:
            raise SystemExit("the two versions' scores differ")
        for other in variants:
            got = change(codes, probe32, lut, cap, layout, other)
            if not torch.equal(got, outs["change"]):
                raise SystemExit(f"plan {other} changes the scores")
            ms = smoke.cuda_ms(lambda o=other: change(codes, probe32, lut, cap, layout, o),
                               before=smoke._l2_flush)
            print(f"  plan {other}: {ms:.4f} ms (bit-equal to the default plan)", flush=True)

    def variants_of(q_n, p_n, cap, wide):
        plan = pq_adc.adc_plan(q_n, p_n, cap, m, aligned=True)
        out = [pq_adc.adc_plan(q_n, p_n, cap, m, aligned=False)]
        half = plan.tile // 2 // 16 * 16
        if wide and half >= 16:
            tiles = p_n * -(-cap // half)
            out.append(pq_adc.AdcPlan("tma", half, min(tiles, plan.blocks * 2)))
        return out

    t0 = time.perf_counter()
    corpus, queries = smoke.make_scale_data(args.seed)
    index = IVFIPIndex(corpus, recall_target=0.95, pq_m=64, pq_layout="rows")
    torch.cuda.synchronize()
    del corpus
    print(f"index: K {index.n_clusters}, capacity {index.capacity}, tuned nprobe "
          f"{index.nprobe}, m {index.pq_m}, data and build {time.perf_counter() - t0:.1f} s",
          flush=True)
    q = queries[:64].contiguous()
    cap, m = index.capacity, index.pq_m
    ds = index.dim // m
    q_sub = _bf16(q).reshape(q.shape[0], m, ds).transpose(0, 1)
    cbm = index.codebooks.to(torch.float32).view(m, PQ_K, ds)
    lut = torch.bmm(q_sub, cbm.transpose(1, 2)).transpose(0, 1).contiguous()
    rows = index.corpus
    cols = rows.T.contiguous()
    split = _split_fns(os.path.join(HERE, "rankpo_tpu_torch", "ops", "_build", "split")) \
        if args.split else {}
    for p in P_SWEEP:
        probe32 = index._probe_clusters(q, p)[0].to(torch.int32).contiguous()
        for layout, codes in ((0, rows), (1, cols)):
            compare("scale", codes, probe32, lut, cap, layout, variants_of(64, p, cap, p == 1))
            if p not in (1, 179):
                continue
            plan = pq_adc.adc_plan(64, p, cap, m, aligned=True)
            for name, fn in split.items():
                out = torch.empty((64, p, cap), dtype=torch.float32, device="cuda")

                def call(fn=fn, codes=codes, out=out, layout=layout):
                    rc = fn(codes.data_ptr(), probe32.data_ptr(), lut.data_ptr(),
                            out.data_ptr(), index.n_clusters, 64, p, cap, m, layout, 1,
                            plan.tile, plan.blocks, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"--split copy launch failed: cudaError {rc}")

                ms = smoke.cuda_ms(call, before=smoke._l2_flush)
                print(f"  split {('rows', 'cols')[layout]} P {p}, {name}: {ms:.4f} ms",
                      flush=True)
    if args.split:
        def worst_bank(codes32):  # [W, 32 slots, m] -> mean of the busiest bank's words
            total = 0.0
            for lo in range(0, codes32.shape[0], 4096):
                b = codes32[lo:lo + 4096].long()
                words = torch.zeros(b.shape[0], m, PQ_K, dtype=torch.bool, device="cuda")
                words.scatter_(2, b.permute(0, 2, 1), True)
                total += words.view(b.shape[0], m, 8, 32).sum(2).amax(-1).float().sum().item()
            return total / (codes32.shape[0] * m)

        probe8 = index._probe_clusters(q[:8], 179)[0]
        warps = rows.view(-1, cap, m)[probe8.long()].reshape(-1, 32, m)
        rand = torch.randint(0, 256, warps.shape, device="cuda", dtype=torch.uint8)
        print(f"  split: busiest bank, distinct words per warp lookup: index codes "
              f"{worst_bank(warps):.3f}, uniform random codes {worst_bank(rand):.3f}",
              flush=True)
    del rows, cols, index

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    k_n, cap, p = SERVED
    codes = torch.randint(0, 256, (k_n * cap, m), generator=gen, device="cuda",
                          dtype=torch.uint8)
    for q_n in (1, 16):
        probe32 = torch.stack([torch.randperm(k_n, generator=gen, device="cuda")[:p]
                               for _ in range(q_n)]).to(torch.int32)
        lut = torch.randn(q_n, m, PQ_K, generator=gen, device="cuda") / 8
        for layout, c in ((0, codes), (1, codes.T.contiguous())):
            compare("served", c, probe32, lut, cap, layout, variants_of(q_n, p, cap, True))
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
