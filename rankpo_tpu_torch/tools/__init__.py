"""tools layer of the PyTorch port (see the matching rankpo_tpu.tools).

The public names load their module on first access, so importing the
package imports nothing else."""

import importlib

_EXPORTS = {
    "find_random_negatives": "rankpo_tpu_torch.tools.random_negatives",
    "find_hard_negatives": "rankpo_tpu_torch.tools.hard_negatives",
    "select_negative_ids": "rankpo_tpu_torch.tools.hard_negatives",
    "generate_predictions": "rankpo_tpu_torch.tools.predictions",
    "autotune_index": "rankpo_tpu_torch.tools.autotune",
    "default_specs": "rankpo_tpu_torch.tools.autotune",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
