"""K1 (the flash-attention forward) of several builds, timed in turns on one card.

    python3 scripts/flash_fwd_compare.py [--parent DIR] [--seed 0]

Versions: this checkout's kernel with two query heads per block (its
default) and with one (built with ``-DRANKPO_FWD_HEADS=1``), and with
``--parent`` the kernel of another checkout (e.g. the parent commit unpacked
with ``git archive``), each from its own build. Each version runs in a child
process of its own, in the order parent, 2 heads, 1 head, 1 head, 2 heads,
parent, on the same inputs:

- B 8, S 512, 32 q / 8 kv heads, D 64, causal, skip_pad_q, with the random
  and then the full lengths that ``chip_smoke.py`` times (drawn, as there,
  after its encoder shapes' inputs from one generator seeded ``--seed``);
- one layer of the corpus encode: the smoke's 4096 passages in its 64
  length-sorted batches of 64 (``chip_smoke.encode_k1_inputs``).

Each child checks its K1 against the plain version on the B 8 inputs (out
within 1.5e-2, lse within 1e-5, rows below the valid length) and prints the
device time (torch.profiler) of each input set. The card's name and power
limit open and close the output.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_HEAD_FLAG = "-DRANKPO_FWD_HEADS=1"


def _smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the port
    lazily, so they run the version first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(one_head: bool):
    from rankpo_tpu_torch.ops import _build

    if one_head:
        _build.NVCC_FLAGS.append(ONE_HEAD_FLAG)
    t0 = time.perf_counter()
    _build.load_library()
    return time.perf_counter() - t0


def child(version: str, seed: int) -> None:
    sys.path.insert(0, os.getcwd())  # the version's checkout
    import torch

    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.index.encoding import InferenceEncoder
    from rankpo_tpu_torch.models.config import EncoderConfig
    from rankpo_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                      flash_attention_fwd_reference)

    smoke = _smoke()
    _load(version == "1head")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in smoke.ENCODER_SHAPES:
        smoke._attention_inputs(*shape, gen)
    shape = smoke.ENCODER_SHAPES[0]
    sk = shape[2]
    timed = {label: smoke._attention_inputs(*shape, gen,
                                            length=sk if label == "full" else None)
             for label in ("random", "full")}

    with torch.no_grad():
        for label, (q, k, v, _, mask, lens) in timed.items():
            out, lse = flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)
            ref, rlse = flash_attention_fwd_reference(q.float(), k.float(), v.float(), mask,
                                                      causal=True)
            rows = torch.arange(shape[1], device="cuda")[None] < lens[:, None]
            out_err = (out.float() - ref).abs().amax(dim=(2, 3))[rows].max().item()
            keep = rows[:, None, :] & (rlse > -1e29)
            lse_err = (lse - rlse).abs()[keep].max().item()
            if out_err > smoke.OUT_ATOL or lse_err > smoke.LSE_ATOL:
                raise SystemExit(f"{version}: K1 disagrees with plain ({label} lengths): "
                                 f"out {out_err:.3e}, lse {lse_err:.3e}")
            ms = smoke.kernel_ms(smoke.profile_device_ms(
                lambda: flash_attention_fwd(q, k, v, mask, causal=True, skip_pad_q=True)),
                "flash_fwd")
            b_ms = smoke.bound(smoke.attention_cost(lens, *shape[1:], "flash_fwd"))[0]
            print(f"TIME {version} B 8 {label}: {ms:.4f} ms (device time, profiler, 20 "
                  f"calls; bound {b_ms:.4f} ms; max|out-plain| {out_err:.3e} max|lse-plain| "
                  f"{lse_err:.3e})", flush=True)
        del timed

        with tempfile.TemporaryDirectory() as tmp:
            corpus = smoke._serving_data(seed, tmp)[0]
        encoder = object.__new__(InferenceEncoder)  # prepare_batch needs no model
        encoder.config = EncoderConfig()
        encoder.tokenizer = resolve_tokenizer("hash:128256", "")
        encoder.length_multiple = 64
        q, k, v, masks = smoke.encode_k1_inputs(encoder, corpus)
        ms = smoke.kernel_ms(smoke.profile_device_ms(
            lambda: smoke.run_encode_k1(q, k, v, masks), n=5), "flash_fwd")
        print(f"TIME {version} encode: {ms:.4f} ms per layer over {len(masks)} batches "
              f"(device time, profiler, 5 passes)", flush=True)


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
    runs = [("2head", HERE), ("1head", HERE), ("1head", HERE), ("2head", HERE)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [("parent", parent)] + runs + [("parent", parent)]
    # build every version first, all at once (each build runs nvcc per source)
    builds = {(v, cwd): subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {cwd!r}); "
         f"sys.path.insert(0, {os.path.join(HERE, 'scripts')!r}); import flash_fwd_compare "
         f"as m; print('build {v}: %.1f s' % m._load({v == '1head'}))"], cwd=cwd)
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
