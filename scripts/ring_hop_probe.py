"""Which point-to-point forms the ring attention's hop can take on a card.

Two ranks share the one card under gloo (NCCL refuses two ranks on one
device), as the smoke's phases 5d and 5t run them, and try, on CUDA
tensors of the ring's K/V shard size (Llama-3.2-1B's 8 kv heads, D 64,
8192 rows a rank, bf16):

- ``batch_isend_irecv`` with host copies (``parallel/ring_attention.py``'s
  gloo form), checked and timed;
- ``batch_isend_irecv`` with the CUDA tensors themselves, in a pair of its
  own (gloo aborts the process when it fails, so the form is judged by the
  ranks' exit codes and the values received);
- NCCL at world size 1: ``batch_isend_irecv`` of a rank to itself, the
  device form ``ring_hop`` takes under NCCL.

Each form prints what it received (``ok``), the exception it raised or the
exit codes of its processes; the host form its seconds per hop and bytes.
Run on the card:

    python3 scripts/ring_hop_probe.py
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

SHARD = (1, 8192, 8, 64)  # one K or V shard: B, S / W, Hkv, D
TIMED = 5


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hop(tensors, host: bool):
    me, w = dist.get_rank(), dist.get_world_size()
    sends = [t.cpu() if host else t for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, (me + 1) % w) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, (me - 1) % w) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def _gloo_rank(rank: int, port: int, host: bool, path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    out = {}
    k = torch.full(SHARD, float(rank), dtype=torch.bfloat16, device="cuda")
    v = torch.full(SHARD, float(rank) + 10, dtype=torch.bfloat16, device="cuda")
    got = _hop([k, v], host)
    torch.cuda.synchronize()
    want = 1 - rank
    ok = bool((got[0] == want).all()) and bool((got[1] == want + 10).all())
    out["received"] = "ok" if ok else "wrong values"
    if host:
        times = []
        for _ in range(TIMED):
            dist.barrier()
            t0 = time.perf_counter()
            _hop([k, v], True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["hop seconds"] = sorted(times)[len(times) // 2]
        out["hop bytes"] = 2 * k.numel() * k.element_size()
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def _nccl_self(path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_port()}", world_size=1,
                            rank=0)
    out = {}
    try:
        k = torch.full(SHARD, 3.0, dtype=torch.bfloat16, device="cuda")
        got = _hop([k], False)
        torch.cuda.synchronize()
        out["nccl world 1, self hop"] = "ok" if bool((got[0] == 3.0).all()) else "wrong values"
    except Exception as e:  # the probe reports every form's outcome
        out["nccl world 1, self hop"] = f"{type(e).__name__}: {e}".splitlines()[0][:200]
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 1
    ctx = multiprocessing.get_context("spawn")
    tmp = os.environ.get("TMPDIR", "/tmp")
    results = {}

    def run(form, procs, paths):
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
            if p.is_alive():
                p.kill()
                p.join(10)
        got = {"exit codes": [p.exitcode for p in procs]}
        for r, path in enumerate(paths):
            if os.path.exists(path):
                with open(path) as f:
                    got[f"rank {r}"] = json.load(f)
                os.remove(path)
        results[form] = got

    for form, host in (("gloo, host copies", True), ("gloo, CUDA tensors", False)):
        port = _port()
        paths = [os.path.join(tmp, f"ring_hop_probe_{r}.json") for r in range(2)]
        run(form, [ctx.Process(target=_gloo_rank, args=(r, port, host, paths[r]))
                   for r in range(2)], paths)
    path = os.path.join(tmp, "ring_hop_probe_nccl.json")
    run("nccl world 1", [ctx.Process(target=_nccl_self, args=(path,))], [path])
    print(json.dumps(results, indent=1))
    # the forms the ring uses must work: gloo through the host, NCCL on the device
    used = (results["gloo, host copies"]["exit codes"] == [0, 0]
            and results["nccl world 1"]["exit codes"] == [0])
    return 0 if used else 1


if __name__ == "__main__":
    sys.exit(main())
