"""Dataclass-driven CLI parsing for the training entry points (port of
``rankpo_tpu.cli.arguments``).

The flag surface is the JAX package's (itself the reference's
``src/arguments.py``), so the published shell recipes translate unchanged:
a small argparse generator reads dataclass fields. Fields of features this
slice does not port stay parseable and are rejected by
:func:`check_unported` with the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from typing import Optional, Sequence, Type, Union, get_args, get_origin

_ROADMAP = "ROADMAP.md Queue 1 item {}"


def _add_field(parser: argparse.ArgumentParser, f: dataclasses.Field) -> None:
    name = "--" + f.name
    ftype = f.type
    origin = get_origin(ftype)
    if origin is Union:  # Optional[T]
        args = [a for a in get_args(ftype) if a is not type(None)]
        ftype = args[0] if args else str
    if isinstance(ftype, str):  # from __future__ annotations
        ftype = {"str": str, "int": int, "float": float, "bool": bool}.get(
            ftype.replace("Optional[", "").replace("]", ""), str
        )
    default = (
        f.default
        if f.default is not dataclasses.MISSING
        else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
    )
    help_text = (f.metadata or {}).get("help", "")
    if ftype is bool:
        # HF-style: both `--flag` and `--flag False` are accepted
        parser.add_argument(
            name, nargs="?", const=True, default=default, help=help_text,
            type=lambda s: s if isinstance(s, bool) else s.lower() in ("1", "true", "yes"),
        )
    else:
        parser.add_argument(name, type=ftype, default=default, help=help_text)


def parse_dataclasses(classes: Sequence[Type], argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    seen = set()
    for cls in classes:
        for f in dataclasses.fields(cls):
            if f.name in seen or not f.init:
                continue
            seen.add(f.name)
            _add_field(parser, f)
    ns = parser.parse_args(argv)
    out = []
    for cls in classes:
        kwargs = {
            f.name: getattr(ns, f.name)
            for f in dataclasses.fields(cls)
            if f.init and hasattr(ns, f.name)
        }
        out.append(cls(**kwargs))
    return tuple(out)


def _json_str(obj) -> str:
    return json.dumps(dataclasses.asdict(obj), indent=2, default=str)


def check_unported(args, unported: dict) -> None:
    """Raise for a field of ``args`` set away from its default when the
    feature is not ported: ``unported`` maps field -> (default, (what,
    ROADMAP Queue 1 item))."""
    for name, (default, (what, item)) in unported.items():
        value = getattr(args, name)
        if value != default:
            raise NotImplementedError(
                f"--{name} {value}: {what} is not ported to rankpo_tpu_torch "
                f"yet ({_ROADMAP.format(item)})"
            )


def setup_logging(log_level: str = "info") -> None:
    logging.basicConfig(
        level=getattr(logging, log_level.upper(), logging.INFO),
        format="[%(asctime)s] [%(levelname)s]  %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        stream=sys.stdout,
    )


# ---------------------------------------------------------------------------
# Argument groups (reference src/arguments.py analogs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelArguments:
    model_name_or_path: str = dataclasses.field(
        default=None,
        metadata={"help": "HF-format checkpoint directory for the encoder."},
    )
    tokenizer_name: Optional[str] = dataclasses.field(
        default=None,
        metadata={"help": "Tokenizer path if different from the model; "
                          "'hash:<vocab>' selects the hermetic tokenizer."},
    )
    attn_implementation: str = dataclasses.field(
        default="auto",
        metadata={"help": "Attention impl: auto|plain|flash; the reference's "
                          "'flash_attention_2' maps to the CUDA flash kernels, "
                          "'eager'/'sdpa' (and the JAX package's 'xla') to the "
                          "plain PyTorch attention."},
    )

    @property
    def attn_impl(self) -> str:
        return {
            "flash_attention_2": "flash",
            "eager": "plain",
            "sdpa": "plain",
            "xla": "plain",
        }.get(self.attn_implementation, self.attn_implementation)

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class TrainDataArguments:
    train_data: str = dataclasses.field(
        default=None, metadata={"help": "Path to the training jsonl."}
    )
    eval_data: Optional[str] = dataclasses.field(
        default=None, metadata={"help": "not ported (evaluation during training)"}
    )
    num_negatives: int = dataclasses.field(
        default=5, metadata={"help": "Negatives sampled per query."}
    )
    max_query_length: int = dataclasses.field(default=32)
    max_passage_length: int = dataclasses.field(default=128)
    pad_multiple: Optional[int] = dataclasses.field(
        default=None,
        metadata={"help": "Bucketed padding multiple (None = fixed max length)."},
    )
    streaming: bool = dataclasses.field(default=False, metadata={"help": "not ported"})
    pack_sequences: bool = dataclasses.field(default=False, metadata={"help": "not ported"})
    pack_max_segments: int = dataclasses.field(default=16)
    retrieval_eval_query_file: Optional[str] = dataclasses.field(
        default=None, metadata={"help": "not ported (in-training retrieval eval)"}
    )
    retrieval_eval_corpus_file: Optional[str] = dataclasses.field(default=None)
    retrieval_eval_k: int = dataclasses.field(default=100)
    retrieval_eval_index: str = dataclasses.field(default="flat")

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class ContrastiveArguments:
    use_inbatch_neg: bool = dataclasses.field(default=True)
    negatives_cross_device: bool = dataclasses.field(default=True)
    temperature: float = dataclasses.field(default=0.02)
    normalize_embeddings: bool = dataclasses.field(default=True)
    grad_cache: bool = dataclasses.field(default=False, metadata={"help": "not ported"})

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class RankPOArguments:
    reference_free: bool = dataclasses.field(default=False)
    ref_model_name_or_path: Optional[str] = dataclasses.field(default=None)
    temperature: float = dataclasses.field(default=0.02)
    beta: float = dataclasses.field(default=1.0)
    gamma_beta_ratio: float = dataclasses.field(default=0.0)
    sft_weight: float = dataclasses.field(default=0.0)
    rankpo_weight: float = dataclasses.field(default=1.0)
    loss_type: str = dataclasses.field(default="sigmoid")
    label_smoothing: float = dataclasses.field(default=0.0)
    disable_dropout: bool = dataclasses.field(default=True)
    use_lora: bool = dataclasses.field(default=False, metadata={"help": "not ported"})
    lora_r: int = dataclasses.field(default=8)
    lora_alpha: float = dataclasses.field(default=16.0)
    lora_target_modules: str = dataclasses.field(default="auto")

    def to_json_string(self):
        return _json_str(self)


# fields of the groups above whose features this slice does not port
UNPORTED_DATA = {
    "eval_data": (None, ("evaluation during training", 2)),
    "streaming": (False, ("the streaming dataset", 7)),
    "pack_sequences": (False, ("sequence packing", 7)),
    "retrieval_eval_query_file": (None, ("in-training retrieval eval", 7)),
}
UNPORTED_CONTRASTIVE = {"grad_cache": (False, ("gradient caching", 7))}
UNPORTED_RANKPO = {"use_lora": (False, ("LoRA", 7))}
