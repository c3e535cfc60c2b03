"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds): one ``nvcc -c``
per source, all started together, then one link. The library goes
into ``ops/_build/`` (ignored by git) under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing file. A failed build raises with nvcc's output; nothing falls
back to the plain PyTorch versions. nvcc's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of every C entry point: pointers and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to an int
_SIGNATURES = {
    "rankpo_flash_fwd_bf16": [_P, _P, _P, _P, _P, _P]  # q k v mask out lse
    + [_I] * 6  # B Sq Sk Hq Hkv D
    + [_LL] * 10  # q/k/v (batch, seq, head) strides, mask batch stride
    + [_I, _I, _P],  # causal skip_pad_q stream
}
_BWD_ARGTYPES = (
    [_P] * 10  # q k v mask do lse delta dq dk dv
    + [_I] * 6  # B Sq Sk Hq Hkv D
    + [_LL] * 13  # q/k/v/do (batch, seq, head) strides, mask batch stride
    + [_I, _I, _P]  # causal skip_pad_q stream
)
for _name in ("fused", "dkv", "dq"):
    _SIGNATURES[f"rankpo_flash_bwd_{_name}_bf16"] = _BWD_ARGTYPES


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from rankpo_tpu_torch/ops/csrc at first use"
    )


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librankpo_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objects = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(sources, objects)]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objects)]
    log = ""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"link failed ({proc.returncode}): {' '.join(link)}")
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(failed) + "\n" + log)
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)  # atomic: a concurrent process sees all or nothing


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's report for the current sources ('' if built elsewhere)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
