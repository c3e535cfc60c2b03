"""The generic build's four kernels, this checkout's against another's, timed in turns on one card.

    python3 scripts/flash_generic_compare.py [--parent DIR] [--seed 0]

Versions: this checkout's ``ops/csrc/flash_generic.cu`` and, with
``--parent``, another checkout's (e.g. the parent commit unpacked with
``git archive``), each from its own build in a child process of its own, in
the order parent, new, new, parent, on the same inputs: the first three
shapes of ``chip_smoke.py``'s phase 2f that are not packed and have no
window (fp32 at B 2, S 4096, 32 / 8 heads, D 64; bf16 at B 4, S 1024, D 80;
fp16 at D 96), causal with skip_pad_q, random key lengths with a length-1
and a full row, drawn from one generator seeded ``--seed``.

Each child holds its K1 (out, lse), its split backward's dq, dk and dv
(K3a + K3b) and its fused backward's (K2, ``bwd_impl="fused"``) to the
plain versions in the inputs' dtype, within ``chip_smoke.py``'s
GENERIC_TOL_OF_MAX and GENERIC_REL_L2, and prints the device time
(torch.profiler, GENERIC_TIMED calls) of K1, K3a, K3b and K2 beside the
bound (in fp32 at both fp32 rates; ``chip_smoke.py`` ``generic_bounds``).
The card's name and power limit open and close the output.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((0, "fp32 D 64"), (3, "bf16 D 80"), (4, "fp16 D 96"))  # 2f's GENERIC_SHAPES
LABELS = {"flash_fwd": "K1", "flash_dq": "K3a", "flash_dkv": "K3b", "flash_bwd_fused": "K2"}


def _smoke(root: str, name: str):
    """A checkout's chip_smoke.py as a module (its helpers import the port
    lazily, so they run the version first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load() -> float:
    from rankpo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    return time.perf_counter() - t0


def _inputs(dtype, shape, gen):
    import torch

    b, s, hq, hkv, d = shape
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                   for h in (hq, hkv, hkv, hq))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[-1] = 1, s
    mask = (torch.arange(s, device="cuda")[None] < lens[:, None]).int()
    return q, k, v, do, mask, lens


def measure(version: str, seed: int) -> None:
    """Check and time this process's build (the checkout in the working
    directory) at SHAPES; prints one TIME line per shape."""
    sys.path.insert(0, os.getcwd())
    import torch

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    smoke = _smoke(HERE, "chip_smoke")  # inputs, plain versions, limits, bounds
    names = _smoke(os.getcwd(), "version_smoke").GENERIC_KERNELS  # the version's kernel names
    _load()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(causal=True, skip_pad_q=True)
    for index, label in SHAPES:
        dtype, (b, s, hq, hkv, d), _, _ = smoke.GENERIC_SHAPES[index]
        q, k, v, do, mask, lens = _inputs(dtype, (b, s, hq, hkv, d), gen)
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, mask, **kw)
            ref, rlse = smoke.plain_fwd(q, k, v, mask, True, upcast=False)
            rows = torch.arange(s, device="cuda")[None] < lens[:, None]
            err = {"out": smoke._generic_err(out[rows], ref[rows], dtype, "K1 out", label)}
            err["lse"] = (lse - rlse).abs()[rows[:, None, :] & (rlse > -1e29)].max().item()
            if err["lse"] > smoke.LSE_ATOL:
                raise SystemExit(f"{version}: K1 lse disagrees with plain at {label}: "
                                 f"{err['lse']:.3e}")
            delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
            plain = smoke.plain_bwd(q, k, v, mask, do, lse, delta, True)
            for impl, kernel in (("split", "K3a + K3b"), ("fused", "K2")):
                grads = flash_attention_bwd(q, k, v, mask, do, lse, delta, bwd_impl=impl, **kw)
                for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
                    err[f"{impl} {name}"] = smoke._generic_err(got, want, dtype,
                                                               f"{kernel} {name}", label)
                del grads
            del ref, rlse, plain
            calls = {"flash_fwd": lambda: flash_attention_fwd(q, k, v, mask, **kw),
                     "split": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta,
                                                          bwd_impl="split", **kw),
                     "fused": lambda: flash_attention_bwd(q, k, v, mask, do, lse, delta,
                                                          bwd_impl="fused", **kw)}
            traced = {key: smoke.profile_device_ms(fn, smoke.GENERIC_TIMED)
                      for key, fn in calls.items()}
            times = {}
            for name, trace in (("flash_fwd", "flash_fwd"), ("flash_dq", "split"),
                                ("flash_dkv", "split"), ("flash_bwd_fused", "fused")):
                found = [t for key, t in traced[trace].items() if names[name](key)]
                if not found:
                    raise SystemExit(f"{version}: no {name} kernel in the trace: "
                                     f"{sorted(traced[trace])}")
                times[name] = sum(found)
        bounds = {name: smoke.attention_cost(lens, s, s, hq, hkv, d, name,
                                             itemsize=q.element_size())
                  for name in times}
        line = ", ".join(
            f"{LABELS[name]} {ms:.4f} ms (bound "
            + " / ".join(f"{b_ms:.4f}" for b_ms, _ in smoke.generic_bounds(bounds[name],
                                                                           dtype)) + ")"
            for name, ms in times.items())
        print(f"TIME {version} {label}: {line}; max|err| "
              + ", ".join(f"{key} {e:.2e}" for key, e in err.items()), flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None, help="another checkout's root")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        measure(args.child, args.seed)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = [("new", HERE), ("new", HERE)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [("parent", parent)] + runs + [("parent", parent)]
    # build every version first, side by side (each build runs nvcc per source)
    builds = {(v, cwd): subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {cwd!r}); "
         f"sys.path.insert(0, {os.path.join(HERE, 'scripts')!r}); import flash_generic_compare "
         f"as m; print('build {v}: %.1f s' % m._load())"], cwd=cwd)
        for v, cwd in dict.fromkeys(runs)}
    if any(p.wait() != 0 for p in builds.values()):
        raise SystemExit("a build failed")
    failed = 0
    for version, cwd in runs:
        r = subprocess.run(["timeout", "-s", "KILL", "300", sys.executable,
                            os.path.abspath(__file__), "--child", version,
                            "--seed", str(args.seed)], cwd=cwd, capture_output=True, text=True)
        print(r.stdout, end="", flush=True)
        if r.returncode != 0:
            failed += 1
            print(f"{version} failed (rc {r.returncode}):\n{r.stderr[-3000:]}", flush=True)
    print(f"card: {card}", flush=True)
    if failed:
        raise SystemExit(f"{failed} runs failed")


if __name__ == "__main__":
    main()
