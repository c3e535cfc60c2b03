"""The flash-attention backward kernels (K2, K3a, K3b) of this checkout and
of another, timed in turns on one card.

    python3 scripts/flash_bwd_compare.py [--parent DIR] [--seed 0]

Versions, each from its own build and in a child process of its own:
``parent``, the kernels of the checkout at ``--parent`` (e.g. the parent
commit unpacked with ``git archive``), and ``change``, this checkout's.
They run in the order parent, change, change, parent (change twice alone
without ``--parent``), on the same inputs:

- B 8, S 512, 32 q / 8 kv heads, D 64, causal, skip_pad_q, with the random
  and then the full lengths that ``chip_smoke.py`` times (drawn, as there,
  after its encoder shapes' inputs from one generator seeded ``--seed``);
- one stage-1 micro-batch's shapes (``chip_smoke.stage1_bwd_inputs``: 8
  queries of 128 tokens and 32 passages of 512, their own key masks);
- B 8, S 256, 16 q / 8 kv heads, D 128 (random lengths).

Each child checks the fused and split backward against the plain version on
the B 8 and D 128 inputs (``chip_smoke``'s limits) and prints the device time
(torch.profiler) of each kernel and the wrappers' times (CUDA events) at
each input set. The card's name and power limit open and close the output.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D128_SHAPE = (8, 256, 256, 16, 8, 128)


def _smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the port
    lazily, so they run the version first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load():
    from rankpo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    return time.perf_counter() - t0


def _ptxas(version):
    """nvcc's register and spill report of the backward kernels."""
    from rankpo_tpu_torch.ops import _build

    ours = False
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            ours = "flash_bwd" in line
        if ours and any(key in line for key in ("Compiling entry", "registers", "spill")):
            print(f"ptxas {version}: {line.strip()}", flush=True)


def _check(smoke, label, q, k, v, mask, do, lse, delta):
    from rankpo_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_bwd_reference)

    plain = flash_attention_bwd_reference(q, k, v, mask, do, lse, delta, causal=True)
    for impl in ("fused", "split"):
        got = flash_attention_bwd(q, k, v, mask, do, lse, delta, causal=True,
                                  skip_pad_q=True, bwd_impl=impl)
        for name, a, r in zip(("dq", "dk", "dv"), got, plain):
            err = (a.float() - r).abs().max().item()
            rel = ((a.float() - r).norm() / r.norm()).item()
            if err > smoke.BWD_TOL_OF_MAX * r.abs().max().item() or rel > smoke.BWD_REL_L2:
                raise SystemExit(f"{impl} {name} disagrees with plain ({label}): max|err| "
                                 f"{err:.3e}, relative L2 {rel:.3e}")


def _time(smoke, version, label, sets, bound_of):
    """Device time per kernel and wrapper time over the input ``sets``."""
    import torch

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_bwd

    def run(impl):
        for args in sets:
            flash_attention_bwd(*args, causal=True, skip_pad_q=True, bwd_impl=impl)

    with torch.no_grad():
        traced = {impl: smoke.profile_device_ms(lambda impl=impl: run(impl))
                  for impl in ("fused", "split")}
        wrapper = {impl: smoke.cuda_ms(lambda impl=impl: run(impl)) for impl in ("fused", "split")}
    parts = []
    for name, impl, short in (("flash_bwd_fused", "fused", "K2"), ("flash_dq", "split", "K3a"),
                              ("flash_dkv", "split", "K3b")):
        parts.append(f"{short} {smoke.kernel_ms(traced[impl], name):.4f} "
                     f"(bound {bound_of(name):.4f})")
    print(f"TIME {version} {label}: " + ", ".join(parts) + f" ms device time (profiler, 20 "
          f"calls); wrappers fused {wrapper['fused']:.4f}, split {wrapper['split']:.4f} ms "
          "(CUDA events, median of 20)", flush=True)


def _prepare(q, k, v, do, mask):
    import torch

    from rankpo_tpu_torch.ops.flash_attention import flash_attention_fwd

    with torch.no_grad():
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, mask, do, lse, delta


def child(version: str, seed: int) -> None:
    sys.path.insert(0, os.getcwd())  # the version's checkout
    import torch

    smoke = _smoke()
    _load()
    _ptxas(version)

    def bound_of_sets(sets):
        def f(name):
            return sum(smoke.bound(smoke.attention_cost(
                a[3].sum(1), a[0].shape[1], a[1].shape[1], a[0].shape[2], a[1].shape[2],
                a[0].shape[3], name))[0] for a in sets)
        return f

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in smoke.ENCODER_SHAPES:
        smoke._attention_inputs(*shape, gen)
    shape = smoke.ENCODER_SHAPES[0]
    for label in ("random", "full"):
        q, k, v, do, mask, _ = smoke._attention_inputs(
            *shape, gen, length=shape[2] if label == "full" else None)
        args = _prepare(q, k, v, do, mask)
        _check(smoke, f"B 8 {label}", *args)
        _time(smoke, version, f"B 8 {label}", [args], bound_of_sets([args]))
        del q, k, v, do, mask, args
    with tempfile.TemporaryDirectory() as tmp:
        inputs = smoke.stage1_bwd_inputs(seed, tmp)
    sets = [_prepare(*x) for x in inputs.values()]
    _time(smoke, version, "stage-1 micro-batch", sets, bound_of_sets(sets))
    del sets, inputs
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    q, k, v, do, mask, _ = smoke._attention_inputs(*D128_SHAPE, gen)
    args = _prepare(q, k, v, do, mask)
    _check(smoke, "D 128", *args)
    _time(smoke, version, "D 128", [args], bound_of_sets([args]))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None, help="another checkout's root")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        child(args.child, args.seed)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = [("change", HERE), ("change", HERE)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [("parent", parent)] + runs + [("parent", parent)]
    # build every version first, all at once (each build runs nvcc per source)
    builds = {(v, cwd): subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {cwd!r}); "
         f"sys.path.insert(0, {os.path.join(HERE, 'scripts')!r}); import flash_bwd_compare "
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
