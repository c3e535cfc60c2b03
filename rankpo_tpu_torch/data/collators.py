"""Right padding for token blocks (``rankpo_tpu.data.collators._pad_block``).

Right padding only: last-token pooling (``models/pooling.py``) reads the
position before the first pad, so a left-padded row would pool a pad token.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _pad_block(
    seqs: Sequence[Sequence[int]],
    pad_token_id: int,
    fixed_length: Optional[int],
    pad_multiple: Optional[int],
) -> Dict[str, np.ndarray]:
    longest = max(len(s) for s in seqs)
    if fixed_length is not None and pad_multiple is None:
        target = fixed_length
    else:
        m = pad_multiple or 1
        target = -(-longest // m) * m
        if fixed_length is not None:
            target = min(target, fixed_length)
    target = max(target, 1)
    ids = np.full((len(seqs), target), pad_token_id, dtype=np.int32)
    mask = np.zeros((len(seqs), target), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:target]
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return {"input_ids": ids, "attention_mask": mask}
