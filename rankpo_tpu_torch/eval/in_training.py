"""In-training retrieval evaluation (port of ``rankpo_tpu.eval.in_training``).

At each eval point the trainer's live model encodes the eval queries and
corpus, the index searches, and MRR / Recall / AUC / nDCG join the training
log beside the loss: no checkpoint write, no separate evaluate job, no
model reload. The encode -> index -> search -> metrics path is the offline
harness (``eval/evaluator.py`` ``evaluate_checkpoint``), so the numbers are
those of ``cli.evaluate`` over a checkpoint of the same weights in the same
compute dtype.

One ``InferenceEncoder`` lives for the whole run. It shares the live
module's tensors: each call hands it the module and runs it under
``torch.inference_mode()`` (the forward casts each master weight to the
compute dtype as it goes, one layer at a time), then takes the module back,
so the encoder holds no weights between eval points and no second full copy
of the model is ever made. A LoRA model encodes with its merged weights
(``models/lora.py``), which are computed once per call.

Several processes: every rank calls the hook at the same eval point. Each
rank of the data group encodes the queries whole and its own row shard of
the corpus (``InferenceEncoder.encode_shard``, every rank of the group
running as many batches), the index is row-sharded over the data group,
and every rank returns the same metrics. Under data parallelism (ZeRO-1)
each rank holds the whole model. Under fsdp the full parameters are
gathered once at the start of the eval point, in the one-process order,
and dropped after it (JAX's ``_replicate``), so the encode makes no
per-access broadcasts. Under tensor parallelism the ranks of a model group
share a data index, so they encode the same rows in the same batches
through the split module. An IVF index over several shards is not ported
(ROADMAP.md Queue 1, the rest of item 8c).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import torch
from torch.nn.utils import parametrize

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.precision import policy_from_flags
from rankpo_tpu_torch.data.datasets import load_eval_corpus, load_eval_queries
from rankpo_tpu_torch.eval.evaluator import evaluate_checkpoint
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.factory import check_sharded_tier, resolve_index_spec

logger = logging.getLogger(__name__)


class RetrievalEvalHook:
    """Callable ``(model) -> {"retrieval_<metric>": value}`` for
    ``Trainer.retrieval_eval_fn`` (JAX ``in_training.py:42``). The query and
    corpus jsonl files (the ``cli.evaluate`` schemas) are loaded once here;
    an index spec is resolved here too, so a bad one fails before training
    starts. Each call encodes them with the given model in
    ``compute_dtype``."""

    def __init__(
        self,
        tokenizer,
        query_file: str,
        corpus_file: str,
        *,
        max_query_length: int = 32,
        max_passage_length: int = 128,
        k: int = 100,
        cutoffs: Sequence[int] = (1, 5, 10, 20, 100),
        batch_size: int = 256,
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "auto",
        index_type: str = "flat",
        index_kwargs: Optional[dict] = None,
    ):
        self.queries, self.labels = load_eval_queries(query_file)
        self.corpus = load_eval_corpus(corpus_file)
        if not self.queries or not self.corpus:
            raise ValueError(
                f"retrieval eval needs non-empty query and corpus files; got "
                f"{len(self.queries)} queries / {len(self.corpus)} corpus rows")
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_passage_length = max_passage_length
        self.k = min(k, len(self.corpus))
        # filtered again against the clamped k: a cutoff past the corpus
        # size would label a metric over fewer slots than it names
        self.cutoffs = [c for c in cutoffs if c <= self.k] or [self.k]
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.index_type, self.index_kwargs = resolve_index_spec(index_type, index_kwargs)
        check_sharded_tier(self.index_type, mesh.data_count())  # before training starts
        self._encoder: Optional[InferenceEncoder] = None
        logger.info("in-training retrieval eval: %d queries over %d corpus rows (k=%d, "
                    "index=%s)", len(self.queries), len(self.corpus), self.k, index_type)

    def __call__(self, model) -> Dict[str, float]:
        if self._encoder is None:
            self._encoder = InferenceEncoder(model.config, None, self.tokenizer,
                                             attn_impl=self.attn_impl, model=model)
        else:
            self._encoder.model = model
        saved_dtype = model.compute_dtype
        model.compute_dtype = self.compute_dtype
        group = mesh.data_group() if mesh.is_distributed() else None
        try:
            # a parametrized weight (LoRA's merge, fsdp's gather) is computed
            # once for the whole call and dropped after it
            with parametrize.cached():
                fsdp = getattr(model, "fsdp", None)
                if fsdp is not None:  # every gather now, in one order on every rank
                    for name in fsdp.names:
                        path, _, attr = name.rpartition(".")
                        getattr(model.get_submodule(path), attr)
                metrics, _, _ = evaluate_checkpoint(
                    "<live-model>",  # unused: the encoder is supplied
                    self.queries, self.labels, self.corpus, encoder=self._encoder,
                    batch_size=self.batch_size, max_query_length=self.max_query_length,
                    max_passage_length=self.max_passage_length, k=self.k,
                    cutoffs=self.cutoffs, index_type=self.index_type,
                    index_kwargs=self.index_kwargs, group=group)
        finally:
            model.compute_dtype = saved_dtype
            self._encoder.model = None  # no weights held between eval points
        return {f"retrieval_{name}": float(v) for name, v in metrics.items()}


def maybe_attach_retrieval_eval(trainer, data_args, tokenizer, *,
                                attn_impl: str = "auto") -> bool:
    """Wire ``--retrieval_eval_query_file`` / ``--retrieval_eval_corpus_file``
    (``TrainDataArguments``) onto a Trainer, for both training CLIs (JAX
    ``in_training.py:163``). The compute dtype is bf16 under ``--bf16`` or
    ``--pure_bf16`` and fp32 otherwise, the training forward's, so the
    numbers compare with ``cli.evaluate`` run with the same ``--bf16``.
    Returns True when a hook was attached."""
    qf = data_args.retrieval_eval_query_file
    cf = data_args.retrieval_eval_corpus_file
    if not qf:
        if cf:
            raise ValueError("--retrieval_eval_corpus_file requires "
                             "--retrieval_eval_query_file")
        return False
    if not cf:
        raise ValueError("--retrieval_eval_query_file requires --retrieval_eval_corpus_file")
    cfg = trainer.config
    k = int(data_args.retrieval_eval_k)
    trainer.retrieval_eval_fn = RetrievalEvalHook(
        tokenizer, qf, cf,
        max_query_length=data_args.max_query_length,
        max_passage_length=data_args.max_passage_length,
        k=k, cutoffs=[c for c in (1, 5, 10, 20, 100) if c <= k] or [k],
        compute_dtype=policy_from_flags(cfg.bf16, cfg.pure_bf16).compute_dtype,
        attn_impl=attn_impl, index_type=data_args.retrieval_eval_index,
    )
    if cfg.eval_strategy == "no":
        logger.warning("retrieval eval files given but --eval_strategy is 'no': the hook "
                       "will never fire; set --eval_strategy epoch|steps")
    return True
