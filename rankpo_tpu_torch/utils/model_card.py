"""Model-card writer (a copy of ``rankpo_tpu.utils.model_card``: the same
arguments give a byte-equal ``README.md``) — the analog of the reference's
``push_to_hub`` tagging.

The reference adds library tags to the model card before pushing
(src/rankpo_trainer.py:647-654, via trl's ``create_model_card``). This
environment has no hub, so the card itself (``README.md`` with YAML
front-matter tags, the format the hub indexes) is written into every saved
model directory; a later ``huggingface-cli upload`` of the directory carries
identical metadata to a reference push.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

_CARD_TEMPLATE = """---
library_name: rankpo_tpu
tags:
{tag_lines}
{base_model_line}pipeline_tag: sentence-similarity
---

# {name}

Dense-retrieval encoder trained with **rankpo_tpu** ({stage} stage).

{args_section}"""


def write_model_card(
    directory: str,
    *,
    stage: str,
    tags: Sequence[str],
    base_model: Optional[str] = None,
    training_args: Optional[Dict] = None,
) -> None:
    """Write ``README.md`` into a saved model directory (idempotent)."""
    tag_lines = "\n".join(f"- {t}" for t in dict.fromkeys(tags))
    base_model_line = (
        f"base_model: {base_model}\n" if base_model and not os.path.isdir(
            base_model
        ) else ""
    )
    args_section = ""
    if training_args:
        rows = "\n".join(f"| {k} | {v} |" for k, v in training_args.items())
        args_section = (
            "## Training configuration\n\n| arg | value |\n|---|---|\n"
            f"{rows}\n"
        )
    card = _CARD_TEMPLATE.format(
        tag_lines=tag_lines,
        base_model_line=base_model_line,
        name=os.path.basename(os.path.abspath(directory)),
        stage=stage,
        args_section=args_section,
    )
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "README.md"), "w") as f:
        f.write(card)
