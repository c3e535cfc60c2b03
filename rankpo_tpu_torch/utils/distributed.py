"""Multi-process work splitting (port of ``rankpo_tpu.utils.distributed``;
reference src/utils.py:165-285 ``split_between_processes``, with its
``evenly_split`` mode and padding).

Pure Python over lists, tuples and dicts of equal-length lists: a
contiguous (ceil) split by default, ``evenly_split=True`` balances the
sizes divmod-style. The process index and count come from the
``torch.distributed`` group when one exists (``core/mesh.py``), and are 0
and 1 otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from rankpo_tpu_torch.core import mesh


def _bounds(
    length: int, process_index: int, process_count: int, evenly_split: bool
) -> Tuple[int, int, int]:
    """(start, end, target size) of a process's slice."""
    if evenly_split:
        per, extra = divmod(length, process_count)
        start = process_index * per + min(process_index, extra)
        end = start + per + (1 if process_index < extra else 0)
        target = per + int(extra > 0)
    else:
        per = -(-length // process_count)
        start = process_index * per
        end = start + per
        target = per
    return start, end, target


def split_between_processes(
    inputs: Any,
    *,
    apply_padding: bool = False,
    evenly_split: bool = False,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Any:
    """This process's slice of ``inputs`` (a list or tuple, or a dict of
    equal-length lists). With ``apply_padding`` every process gets the same
    number of elements by repeating the global last element (drop them
    after gathering)."""
    pi = mesh.process_index() if process_index is None else process_index
    pc = mesh.process_count() if process_count is None else process_count
    if pc == 1:
        return inputs

    if isinstance(inputs, dict):
        lengths = {k: len(v) for k, v in inputs.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError("All dict values must have the same length")
        return {
            k: split_between_processes(
                v, apply_padding=apply_padding, evenly_split=evenly_split,
                process_index=pi, process_count=pc,
            )
            for k, v in inputs.items()
        }

    length = len(inputs)
    start, end, target = _bounds(length, pi, pc, evenly_split)
    if start >= length:
        result = list(inputs[-1:])
    else:
        result = list(inputs[start:end])
    if apply_padding and len(result) < target:
        result = result + [inputs[-1]] * (target - len(result))
    return type(inputs)(result) if isinstance(inputs, tuple) else result
