"""Dataclass-driven CLI parsing for the training, evaluation, mining and
prediction entry points (port of ``rankpo_tpu.cli.arguments``).

The flag surface is the JAX package's (itself the reference's
``src/arguments.py``), so the published shell recipes translate unchanged:
a small argparse generator reads dataclass fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from typing import Optional, Sequence, Type, Union, get_args, get_origin

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


def parse_index_kwargs(raw: str) -> Optional[dict]:
    """Parse the ``index_kwargs`` JSON field (extra ivf constructor knobs on
    the offline CLIs: the ``index_kwargs`` dict the evaluator and the tools
    accept, as one flag)."""
    if not raw:
        return None
    try:
        out = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(f"--index_kwargs is not valid JSON: {e}") from e
    if not isinstance(out, dict):
        raise ValueError(
            f"--index_kwargs must be a JSON object, got {type(out).__name__}"
        )
    return out


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
class DistributedArguments:
    """Data-parallel bring-up, one process per card (the torchrun-env
    analog; ``core/mesh.py`` ``initialize_distributed``). All None = one
    process."""

    coordinator_address: Optional[str] = dataclasses.field(
        default=None, metadata={"help": "host:port of rank 0's rendezvous"})
    num_processes: Optional[int] = dataclasses.field(
        default=None, metadata={"help": "processes of the run (one per card)"})
    process_id: Optional[int] = dataclasses.field(
        default=None, metadata={"help": "this process's rank, 0..num_processes-1"})

    def initialize(self, device="cuda") -> None:
        """Join the process group (NCCL for a CUDA ``device``, gloo for the
        CPU); a no-op without a coordinator or when a group exists."""
        from rankpo_tpu_torch.core.mesh import initialize_distributed

        initialize_distributed(self.coordinator_address, self.num_processes,
                               self.process_id, device=device)

    def join(self, device="cuda"):
        """For evaluation, the tools and serving: join the process group
        (before any loading; no CPU fallback), lay every rank out on one
        data group (``core/mesh.py`` ``make_groups``) and return (this
        rank's device, ``cuda:<rank % cards>`` for a card, and the data
        group, None in one process without a group)."""
        import torch

        from rankpo_tpu_torch.core import mesh
        from rankpo_tpu_torch.core.device import resolve_device

        device = resolve_device(device)
        self.initialize(device)
        if not mesh.is_distributed():
            return device, None
        mesh.make_groups(mesh.MeshConfig())
        device = mesh.rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return device, mesh.data_group()


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

    flash_bwd_impl: str = dataclasses.field(
        default="auto",
        metadata={"help": "Backward kernels of the flash attention on the card: "
                          "auto (= split) | split (K3a + K3b) | fused (K2)."},
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
        default=None,
        metadata={"help": "Held-out jsonl of the stage's format, evaluated by "
                          "--eval_strategy / --eval_steps (Trainer.evaluate)."},
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
    streaming: bool = dataclasses.field(
        default=False,
        metadata={"help": "Keep the training rows on disk and tokenize each on "
                          "access (data/datasets.py StreamingContrastiveDataset)."},
    )
    pack_sequences: bool = dataclasses.field(
        default=False,
        metadata={"help": "Sequence packing: several texts per row with "
                          "block-diagonal attention; the same sampled examples "
                          "and loss as unpacked (data/packing.py)."},
    )
    pack_max_segments: int = dataclasses.field(
        default=16, metadata={"help": "Packing: max texts per packed row."}
    )
    retrieval_eval_query_file: Optional[str] = dataclasses.field(
        default=None,
        metadata={"help": "In-training retrieval eval: query jsonl (the "
                          "cli.evaluate schema). At each eval point (per "
                          "--eval_strategy) the live model encodes it and the "
                          "retrieval_* metrics join the training log "
                          "(eval/in_training.py)."},
    )
    retrieval_eval_corpus_file: Optional[str] = dataclasses.field(
        default=None,
        metadata={"help": "In-training retrieval eval: corpus jsonl (required with "
                          "--retrieval_eval_query_file)."},
    )
    retrieval_eval_k: int = dataclasses.field(
        default=100,
        metadata={"help": "In-training retrieval eval: search depth (also caps the "
                          "metric cutoffs 1,5,10,20,100)."},
    )
    retrieval_eval_index: str = dataclasses.field(
        default="flat",
        metadata={"help": "In-training retrieval eval: index tier or factory spec "
                          "('flat', 'refine', 'ivf', 'PCA128,Flat', ...)."},
    )

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class ContrastiveArguments:
    use_inbatch_neg: bool = dataclasses.field(default=True)
    negatives_cross_device: bool = dataclasses.field(default=True)
    temperature: float = dataclasses.field(default=0.02)
    normalize_embeddings: bool = dataclasses.field(default=True)
    grad_cache: bool = dataclasses.field(
        default=False,
        metadata={"help": "Gradient caching: InfoNCE over the whole accumulation "
                          "group's reps (train/gradcache.py)."},
    )

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
    use_lora: bool = dataclasses.field(
        default=False,
        metadata={"help": "Train LoRA adapters over a frozen base; the saved "
                          "models hold the merge (models/lora.py)."},
    )
    lora_r: int = dataclasses.field(default=8)
    lora_alpha: float = dataclasses.field(default=16.0)
    lora_target_modules: str = dataclasses.field(
        default="auto",
        metadata={"help": "comma-joined projections to adapt; 'auto' = q_proj,v_proj "
                          "(llama body) or query,value (Roberta/BERT body)"},
    )

    def to_json_string(self):
        return _json_str(self)


_INDEX_TYPE_HELP = ("flat = exact FAISS-parity search; refine = PCA "
                    "prefilter + exact rerank; ivf = clustered inverted-file "
                    "probing (both approximate); or a FAISS "
                    "index_factory-style spec, e.g. 'IVF4096,PQ64' or "
                    "'PCA128,Flat'")
_INDEX_KWARGS_HELP = ("JSON dict of extra refine/ivf index-constructor knobs, "
                      "e.g. '{\"pq_m\": 64, \"n_clusters\": 4096}'")
_DEVICE_HELP = "torch device; 'cuda' fails when no card is visible"


@dataclasses.dataclass
class EvaluateArguments:
    model_name_or_path: str = dataclasses.field(default=None)
    tokenizer_name: Optional[str] = dataclasses.field(default=None)
    query_data: str = dataclasses.field(default=None)
    corpus_data: str = dataclasses.field(default=None)
    output_dir: str = dataclasses.field(default="")
    overwrite_output_dir: bool = dataclasses.field(default=False)
    evaluate_all_checkpoints: bool = dataclasses.field(default=False)
    batch_size: int = dataclasses.field(default=256)
    max_query_length: int = dataclasses.field(default=32)
    max_passage_length: int = dataclasses.field(default=128)
    k: int = dataclasses.field(default=100)
    cutoffs: str = dataclasses.field(default="1,5,10,20,100")
    bf16: bool = dataclasses.field(default=False)
    index_type: str = dataclasses.field(default="flat", metadata={"help": _INDEX_TYPE_HELP})
    index_recall_target: float = dataclasses.field(
        default=0.95, metadata={"help": "refine/ivf index build-time recall-tune target"})
    index_kwargs: str = dataclasses.field(default="", metadata={"help": _INDEX_KWARGS_HELP})
    wandb_project: str = dataclasses.field(default="")
    log_level: str = dataclasses.field(default="info")
    device: str = dataclasses.field(default="cuda", metadata={"help": _DEVICE_HELP})

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class HardNegativeArguments:
    model_name_or_path: str = dataclasses.field(default=None)
    tokenizer_name: Optional[str] = dataclasses.field(default=None)
    input_file: str = dataclasses.field(default=None)
    output_prefix: str = dataclasses.field(default=None)
    batch_size: int = dataclasses.field(default=32)
    max_query_length: int = dataclasses.field(default=32)
    max_passage_length: int = dataclasses.field(default=128)
    search_range: str = dataclasses.field(default="0-100")
    method: Optional[str] = dataclasses.field(
        default=None, metadata={"help": "topk | sample | cluster (comma-joined)"}
    )
    num_negatives: int = dataclasses.field(default=10)
    num_clusters: int = dataclasses.field(default=10)
    lambda_: Optional[float] = dataclasses.field(default=None)
    bf16: bool = dataclasses.field(default=False)
    index_type: str = dataclasses.field(default="flat", metadata={"help": _INDEX_TYPE_HELP})
    index_recall_target: float = dataclasses.field(
        default=0.95, metadata={"help": "refine/ivf index build-time recall-tune target"})
    index_kwargs: str = dataclasses.field(default="", metadata={"help": _INDEX_KWARGS_HELP})
    seed: int = dataclasses.field(default=42)
    log_level: str = dataclasses.field(default="info")
    device: str = dataclasses.field(default="cuda", metadata={"help": _DEVICE_HELP})

    def to_json_string(self):
        return _json_str(self)


@dataclasses.dataclass
class PredictionArguments:
    model_name_or_path: str = dataclasses.field(default=None)
    tokenizer_name: Optional[str] = dataclasses.field(default=None)
    query_data: str = dataclasses.field(default=None)
    corpus_data: str = dataclasses.field(default=None)
    output_file: str = dataclasses.field(default=None)
    batch_size: int = dataclasses.field(default=32)
    max_query_length: int = dataclasses.field(default=32)
    max_passage_length: int = dataclasses.field(default=128)
    search_range: str = dataclasses.field(default="0-100")
    method: str = dataclasses.field(default="topk")
    num_predictions: int = dataclasses.field(default=10)
    bf16: bool = dataclasses.field(default=False)
    index_type: str = dataclasses.field(default="flat", metadata={"help": _INDEX_TYPE_HELP})
    index_recall_target: float = dataclasses.field(
        default=0.95, metadata={"help": "refine/ivf index build-time recall-tune target"})
    index_kwargs: str = dataclasses.field(default="", metadata={"help": _INDEX_KWARGS_HELP})
    seed: int = dataclasses.field(default=42)
    log_level: str = dataclasses.field(default="info")
    device: str = dataclasses.field(default="cuda", metadata={"help": _DEVICE_HELP})

    def to_json_string(self):
        return _json_str(self)

