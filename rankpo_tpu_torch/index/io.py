"""Structural index persistence (port of ``rankpo_tpu.index.io``, the FAISS
``write_index`` / ``read_index`` analog) for the ``flat``, ``refine`` and
``ivf`` kinds.

The format is the JAX package's ``rankpo-index-v1``: one ``.npz`` holding the
index's arrays (bf16 stored as a uint16 view, since npy has no bfloat16, with
per-array dtype names recorded) plus a ``__index_config__`` JSON string (kind,
shapes, tuned knobs and the shard count the knobs were tuned at). A file
written by either package loads in the other and searches alike: a load is
pure placement (no k-means, no PCA, no tuning). IVF files carry every option
(balanced, split-built, the PCA hybrid, PQ) and mutated layouts (grown
capacity, freed slots); flat files carry fp32, bf16 or int8 rows (codes and
their per-row scales, restored bit-equal, never requantized) and the
approximate mode's knobs.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.index.flat import FlatIPIndex
from rankpo_tpu_torch.index.ivf import IVFIPIndex, _as_dtype
from rankpo_tpu_torch.index.refined import RefineIPIndex
from rankpo_tpu_torch.ops.topk import require_fp32_matmul

CONFIG_KEY = "__index_config__"
FORMAT = "rankpo-index-v1"

_DTYPE_NAMES = ("float32", "bfloat16", "int8", "int32", "uint8")
_STORE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}


def _pack(out: Dict[str, np.ndarray], meta: Dict[str, str], name: str, arr,
          trim: Optional[int] = None) -> None:
    """Record one array (tensor or numpy) on the host; bf16 as a uint16
    view."""
    if arr is None:
        return
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        if trim is not None:
            arr = arr[:trim]
        if arr.dtype == torch.bfloat16:
            out[name] = arr.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
            meta[name] = "bfloat16"
            return
        arr = arr.cpu().numpy()
    elif trim is not None:
        arr = arr[:trim]
    dname = arr.dtype.name
    if dname not in _DTYPE_NAMES:
        raise ValueError(f"unsupported index array dtype {arr.dtype}")
    out[name] = np.ascontiguousarray(arr)
    meta[name] = dname


def _unpack(data: Mapping, meta: Dict[str, str], name: str, device
            ) -> Optional[torch.Tensor]:
    if name not in meta:
        return None
    arr = np.array(data[name])  # a writable copy: torch shares its memory
    if meta[name] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def index_state(index) -> Dict[str, np.ndarray]:
    """Flat dict of host arrays plus a JSON config capturing everything
    needed to rebuild ``index`` without training or tuning."""
    if not isinstance(index, (FlatIPIndex, RefineIPIndex, IVFIPIndex)):
        raise TypeError(f"unsupported index type {type(index).__name__}")
    out: Dict[str, np.ndarray] = {}
    meta: Dict[str, str] = {}
    cfg: Dict = {"format": FORMAT, "n_total": index.n_total, "dim": index.dim,
                 "tuned_shards": 1}
    if isinstance(index, FlatIPIndex):
        cfg["kind"] = "flat"
        cfg["dtype"] = _STORE_NAMES[index.dtype]
        cfg["recall_target"] = index.recall_target
        cfg["precision"] = index.precision
        _pack(out, meta, "corpus", index.corpus, trim=index.n_total)
        if index.quantized:
            _pack(out, meta, "row_scale", index.row_scale, trim=index.n_total)
    elif isinstance(index, RefineIPIndex):
        cfg["kind"] = "refine"
        cfg["store_dtype"] = _STORE_NAMES[index.store_dtype]
        cfg["recall_target"] = index.recall_target
        cfg["reduced_dim"] = index.reduced_dim
        cfg["candidates"] = int(index.candidates)
        _pack(out, meta, "corpus", index.corpus, trim=index.n_total)
        _pack(out, meta, "corpus_low", index.corpus_low, trim=index.n_total)
        _pack(out, meta, "proj", index.proj)
    else:
        cfg["kind"] = "ivf"
        cfg["store_dtype"] = _STORE_NAMES[index.store_dtype]
        cfg["recall_target"] = index.recall_target
        cfg["n_clusters"] = index.n_clusters
        cfg["capacity"] = index.capacity
        cfg["nprobe"] = int(min(index.nprobe, index.local_clusters))
        cfg["spherical"] = index.spherical
        cfg["reduced_dim"] = index.reduced_dim
        cfg["pq_m"] = index.pq_m
        cfg["pq_rotate"] = index.pq_rotate
        cfg["pq_layout"] = index.pq_layout
        cfg["balance_eta"] = index.balance_eta
        cfg["kmeans_split"] = index.kmeans_split
        if index._assign_bias_host is not None:
            # appends to a loaded index place rows by the build's biased scores
            _pack(out, meta, "assign_bias", index._assign_bias_host)
        cfg["candidates"] = index.candidates
        _pack(out, meta, "corpus", index.corpus)
        _pack(out, meta, "row_ids", index.row_ids)
        _pack(out, meta, "centroids", index.centroids)
        if index.quantized:
            _pack(out, meta, "slot_scale", index.slot_scale)
        if index.pq_m is not None:
            # fp32 host codebooks [m, 256, ds]; the device bf16 search copy
            # is derived again at load (the same rounding)
            _pack(out, meta, "pq_codebooks", index._codebooks_host)
            if index._rotation_host is not None:
                _pack(out, meta, "pq_rotation", index._rotation_host)
        if index.reduced_dim is not None:
            _pack(out, meta, "proj", index.proj)
            _pack(out, meta, "corpus_low", index.corpus_low)
    cfg["arrays"] = meta
    out[CONFIG_KEY] = np.asarray(json.dumps(cfg))
    return out


def is_index_state(data: Mapping) -> bool:
    """Whether ``data`` (a loaded npz or an ``index_state`` dict) is a
    structural index file rather than the serving layer's legacy format."""
    return CONFIG_KEY in getattr(data, "files", data)


def state_kind(data: Mapping) -> str:
    return json.loads(str(np.asarray(data[CONFIG_KEY])))["kind"]


def _load_flat(cfg, data, meta, device):
    require_fp32_matmul()
    self = FlatIPIndex.__new__(FlatIPIndex)
    self.dtype = _as_dtype(cfg["dtype"])
    self.quantized = self.dtype == torch.int8
    self.recall_target = float(cfg["recall_target"])
    self.precision = cfg["precision"]
    self.n_total = n = int(cfg["n_total"])
    self.dim = int(cfg["dim"])
    self.corpus, self.row_scale = self._empty_storage(self._storage_rows(n), device)
    self.corpus[:n] = _unpack(data, meta, "corpus", device)
    if self.quantized:
        self.row_scale[:n] = _unpack(data, meta, "row_scale", device)
    self.n_padded = int(self.corpus.shape[0])
    self._fill = [self.n_total]
    return self


def _load_refine(cfg, data, meta, device):
    require_fp32_matmul()
    self = RefineIPIndex.__new__(RefineIPIndex)
    self.device = device
    self.n_total = self.n_padded = int(cfg["n_total"])
    self.dim = int(cfg["dim"])
    self.reduced_dim = int(cfg["reduced_dim"])
    self.recall_target = cfg["recall_target"]
    self.store_dtype = _as_dtype(cfg["store_dtype"])
    self.candidates = int(cfg["candidates"])
    self.corpus = _unpack(data, meta, "corpus", device)
    self.corpus_low = _unpack(data, meta, "corpus_low", device)
    self.proj = _unpack(data, meta, "proj", device)
    return self


def _load_ivf(cfg, data, meta, device):
    require_fp32_matmul()
    self = IVFIPIndex.__new__(IVFIPIndex)
    self.device = device
    self.n_total = int(cfg["n_total"])
    self.dim = int(cfg["dim"])
    self._set_store(cfg["store_dtype"])
    self.recall_target = cfg["recall_target"]
    self.spherical = bool(cfg["spherical"])
    self._set_hybrid(cfg.get("reduced_dim"), cfg["candidates"])
    # the layout is a physical property of the saved codes: restore it
    # verbatim (files older than pq_layout are rows)
    self._set_pq(cfg.get("pq_m"), 1, cfg.get("pq_rotate", "none"),
                 cfg.get("pq_layout") or "rows")
    self.balance_eta = float(cfg.get("balance_eta", 0.0))
    self.kmeans_split = int(cfg.get("kmeans_split", 0))
    self._set_assign_bias(
        np.array(data["assign_bias"], np.float32) if "assign_bias" in meta else None)
    self.n_clusters = int(cfg["n_clusters"])
    self.capacity = int(cfg["capacity"])
    self.local_clusters = self.n_clusters
    # nprobe is per shard: keep the total probed-cluster count of the mesh
    # the file was tuned on
    total_probed = int(cfg["nprobe"]) * max(int(cfg["tuned_shards"]), 1)
    self.nprobe = max(1, min(total_probed, self.local_clusters))
    self.build_seconds = {}

    self.row_ids = _unpack(data, meta, "row_ids", device)
    self._set_layout_maps(self.row_ids.cpu().numpy())
    self._set_centroids(_unpack(data, meta, "centroids", device).to(torch.float32))
    self.corpus = _unpack(data, meta, "corpus", device)
    self.slot_scale = (_unpack(data, meta, "slot_scale", device)
                       if self.quantized else None)
    if self.pq_m is not None:
        self._codebooks_host = np.array(data["pq_codebooks"], np.float32)
        if self.pq_rotate != "none":
            self._rotation_host = np.array(data["pq_rotation"], np.float32)
        self._place_codebooks()
    if self.reduced_dim is not None:
        self.proj = _unpack(data, meta, "proj", device).to(torch.float32)
        self.corpus_low = _unpack(data, meta, "corpus_low", device)
    else:
        self.proj = self.corpus_low = None
    return self


_LOADERS = {"flat": _load_flat, "refine": _load_refine, "ivf": _load_ivf}


def index_from_state(data: Mapping, device="cuda"):
    """Rebuild an index from ``index_state`` output (or a loaded npz) on
    ``device`` (the card unless the caller asks for the CPU). Pure
    placement: no k-means, no tuning."""
    cfg = json.loads(str(np.asarray(data[CONFIG_KEY])))
    if cfg.get("format") != FORMAT:
        raise ValueError(f"unknown index file format {cfg.get('format')!r}")
    kind = cfg["kind"]
    if kind not in _LOADERS:
        raise ValueError(f"unknown index kind {kind!r}")
    return _LOADERS[kind](cfg, data, cfg["arrays"], resolve_device(device))


def save_state(state: Dict[str, np.ndarray], path: str) -> None:
    """npz write through a temp file and an atomic rename."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **state)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_index(index, path: str) -> None:
    """Persist a built index structurally (``.npz`` appended if missing)."""
    save_state(index_state(index), path)


def read_index(path: str, device="cuda"):
    """Load a structurally saved index onto ``device``."""
    with np.load(path, allow_pickle=False) as data:
        return index_from_state(data, device)
