"""eval layer of the PyTorch port (see the matching rankpo_tpu.eval).

The public names load their module on first access, so importing the
package imports nothing else."""

import importlib

_EXPORTS = {
    "compute_metrics": "rankpo_tpu_torch.eval.metrics",
    "evaluate_checkpoint": "rankpo_tpu_torch.eval.evaluator",
    "evaluate_path": "rankpo_tpu_torch.eval.evaluator",
    "find_checkpoints": "rankpo_tpu_torch.eval.evaluator",
    "get_save_path": "rankpo_tpu_torch.eval.evaluator",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
