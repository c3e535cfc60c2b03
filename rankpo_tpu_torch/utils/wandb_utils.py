"""Optional Weights & Biases integration (port of
``rankpo_tpu.utils.wandb_utils``; wandb may be absent, and then nothing is
logged).

Reference behavior: manual ``wandb.init`` with the project from
``--wandb_project``, an empty string disables it (contrastive_trainer.py:71-89,
arguments.py:193-201); evaluation logs metric tables (evaluate.py:269-274).
The port runs one process, so there is no rank check.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def maybe_init_wandb(project: str, run_name: str = "auto") -> Optional[Callable]:
    """Returns a log_fn(dict), or None when no project is set or wandb is
    not installed (then the run carries on without it)."""
    if not project:
        return None
    try:
        import wandb
    except ImportError:
        logger.warning("wandb_project=%s set but wandb is not installed", project)
        return None
    wandb.init(project=project, name=None if run_name == "auto" else run_name)
    return wandb.log


def log_metric_bar_chart(metrics: dict, title: str) -> None:
    """Per-checkpoint metric bar chart (reference evaluate.py:269-274:
    wandb.Table over (metric, value) pairs + wandb.plot.bar). No-op when
    wandb is absent or no run is active."""
    try:
        import wandb
    except ImportError:
        return
    if wandb.run is None:
        return
    table = wandb.Table(
        data=[[k, float(v)] for k, v in metrics.items()],
        columns=["metric", "value"],
    )
    wandb.log({f"{title}/chart": wandb.plot.bar(table, "metric", "value",
                                                title=title)})
