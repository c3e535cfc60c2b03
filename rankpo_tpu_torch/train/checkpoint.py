"""Checkpoint directories (port of ``rankpo_tpu.train.checkpoint``).

``output_dir/checkpoint-{global_step}/`` holds config.json +
model.safetensors (``models/hf_io.save_pretrained``), trainer_state.json and
training_args.json, and with ``save_only_model=False`` the file
``opt_state.pt``: the optimizer's ``state_dict()`` and the trainer's
counters, written by ``torch.save``. Rotation keeps at most
``save_total_limit`` checkpoints.

The JAX package writes an orbax tree in a directory ``opt_state/`` and
reads one back only where that directory exists
(``rankpo_tpu/train/checkpoint.py:84-85``). The port's file has another
name, so a JAX run resuming from a port checkpoint resumes model-only (its
weights, its step) instead of failing inside orbax, and the reverse holds
too: the port finds no ``opt_state.pt`` in a JAX checkpoint.

Asynchronous saves (:func:`save_opt_state` with ``async_save=True``): the
caller copies the state to the host first (:func:`host_copy`), then one
background thread writes it; :func:`wait_for_saves` waits for that writer
and raises its error, if it had one.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import torch

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
OPT_STATE_FILE = "opt_state.pt"


def save_trainer_state(directory: str, state: dict, config) -> None:
    with open(os.path.join(directory, "trainer_state.json"), "w") as f:
        json.dump(state, f, indent=2)
    with open(os.path.join(directory, "training_args.json"), "w") as f:
        f.write(config.to_json_string())


def load_trainer_state(directory: str) -> dict:
    path = os.path.join(directory, "trainer_state.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def host_copy(obj):
    """``obj`` (nested dicts, lists and tuples of tensors and plain values)
    with every tensor copied to the host: the optimizer updates its state
    in place, so a save must not hold the live tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


_writer: Optional[threading.Thread] = None
_writer_error: Optional[BaseException] = None


def _write(path: str, payload: dict) -> None:
    # a partial file never carries the final name: a save cut short leaves
    # no opt_state.pt for a resume to read
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_in_background(path: str, payload: dict) -> None:
    global _writer_error
    try:
        _write(path, payload)
    except BaseException as e:  # raised again by wait_for_saves
        _writer_error = e


def save_opt_state(directory: str, payload: dict, async_save: bool = False) -> None:
    """Write ``payload`` (host tensors, :func:`host_copy`) as
    ``directory/opt_state.pt``. With ``async_save`` the write runs on a
    background thread after the previous one has finished; call
    :func:`wait_for_saves` before rotating, resuming or exiting."""
    global _writer
    path = os.path.join(directory, OPT_STATE_FILE)
    wait_for_saves()
    if not async_save:
        _write(path, payload)
        return
    _writer = threading.Thread(target=_write_in_background, args=(path, payload),
                               name="opt-state-writer", daemon=False)
    _writer.start()


def wait_for_saves() -> None:
    """Wait for the background writer; raise the error it ended with."""
    global _writer, _writer_error
    if _writer is not None:
        _writer.join()
        _writer = None
    if _writer_error is not None:
        error, _writer_error = _writer_error, None
        raise RuntimeError(f"asynchronous optimizer-state save failed: {error!r}") from error


def load_opt_state(directory: str) -> Optional[dict]:
    """The payload of ``directory/opt_state.pt``, or None where the
    checkpoint is model-only (or was written by the JAX package)."""
    path = os.path.join(directory, OPT_STATE_FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def list_checkpoints(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    found = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            found.append((int(m.group(1)), os.path.join(output_dir, name)))
    return [p for _, p in sorted(found)]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


def rotate_checkpoints(output_dir: str, save_total_limit: Optional[int]) -> None:
    if not save_total_limit or save_total_limit <= 0:
        return
    ckpts = list_checkpoints(output_dir)
    for stale in ckpts[: max(0, len(ckpts) - save_total_limit)]:
        shutil.rmtree(stale, ignore_errors=True)
