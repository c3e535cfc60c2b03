"""How fast gloo moves a CUDA tensor between two ranks sharing one card, by
the form the tensor is handed to it.

Two ranks share the one card under gloo (NCCL refuses two ranks on one
device), as the smoke's phases 5d, 5t, 7d and 4d run them. On a fp32
tensor the size of Llama-3.2-1B's embedding (128256 x 2048, 1.05 GB), and
on one of 64 MB, each of ``broadcast``, ``all_reduce`` and ``reduce`` is
timed (median of a few calls, a card sync on either side) in three forms:

- ``cuda``: the CUDA tensor itself (gloo stages it through the host);
- ``pageable``: ``.cpu()`` first and ``.to(device)`` after;
- ``pinned``: a copy into page-locked host memory made once, then back.

Every form must give the same bits as the ``cuda`` form. Run on the card:

    python3 scripts/gloo_staging_probe.py
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time

import torch
import torch.distributed as dist

SIZES = {"embedding": (128256, 2048), "64MB": (4096, 4096)}
TIMED = 3
FORMS = ("cuda", "pageable", "pinned")


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(op: str, x: torch.Tensor, form: str, pinned) -> torch.Tensor:
    if form == "cuda":
        buf = x.clone()
    elif form == "pageable":
        buf = x.cpu()
    else:
        pinned.copy_(x)
        buf = pinned
    if op == "broadcast":
        dist.broadcast(buf, src=0)
    elif op == "all_reduce":
        dist.all_reduce(buf)
    else:
        dist.reduce(buf, dst=0)
    return buf if form == "cuda" else buf.to(x.device)


def _rank(rank: int, port: int, path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    out = {}
    for name, shape in SIZES.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        pinned = torch.empty(shape, pin_memory=True)
        for op in ("broadcast", "all_reduce", "reduce"):
            ref = None
            for form in FORMS:
                times = []
                for _ in range(TIMED):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = _run(op, x, form, pinned)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                if ref is None:
                    ref = got
                same = bool(torch.equal(got, ref)) if (op != "reduce" or rank == 0) else True
                out[f"{name} {op} {form}"] = {"s": sorted(times)[TIMED // 2], "same": same}
        del x, pinned
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def main() -> int:
    ctx = multiprocessing.get_context("spawn")
    port = _port()
    paths = [os.path.join(tempfile.gettempdir(), f"gloo_staging_{os.getpid()}_{r}.json")
             for r in range(2)]
    procs = [ctx.Process(target=_rank, args=(r, port, paths[r])) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    if any(p.exitcode != 0 for p in procs):
        print(f"ranks exited {[p.exitcode for p in procs]}", flush=True)
        return 1
    res = [json.load(open(p)) for p in paths]
    for key in res[0]:
        size = SIZES[key.split()[0]]
        mb = size[0] * size[1] * 4 / 1e6
        print(f"{key}: {res[0][key]['s']:.4f} / {res[1][key]['s']:.4f} s (ranks 0 / 1), "
              f"{mb:.1f} MB, same bits as the cuda form {res[0][key]['same']} / "
              f"{res[1][key]['same']}", flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
          .strip(), flush=True)
    ok = all(r[k]["same"] for r in res for k in r)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
