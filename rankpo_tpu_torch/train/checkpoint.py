"""Checkpoint directories (port of ``rankpo_tpu.train.checkpoint``, the
model-only half).

``output_dir/checkpoint-{global_step}/`` holds config.json +
model.safetensors (``models/hf_io.save_pretrained``), trainer_state.json and
training_args.json; rotation keeps at most ``save_total_limit`` of them.
Optimizer-state checkpoints and resume are not ported yet (ROADMAP.md
Queue 1 item 2).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


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
