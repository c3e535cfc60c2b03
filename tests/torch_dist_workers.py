"""Worker processes for the data-parallel tests of the PyTorch port
(``test_torch_distributed.py``, ``test_torch_zero.py``).

:func:`spawn` starts ``world`` processes with the ``spawn`` start method;
each joins a gloo group through a file store in the test's directory (no
port to pick), caps its threads, runs one of the workers below and leaves
the group. A worker that raises writes its traceback beside the results;
a run that outlives ``timeout`` is killed and fails its test only.

This module imports torch and the port only: the workers never load jax.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def spawn(worker, world: int, out: str, *args, timeout: float = 240.0) -> None:
    """Run ``worker(rank, world, out, *args)`` in ``world`` processes of one
    gloo group; raise with the workers' tracebacks if any failed or hung."""
    if TESTS_DIR not in sys.path:
        sys.path.insert(0, TESTS_DIR)
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out, f"store_{worker.__name__}")
    procs = [ctx.Process(target=_entry, args=(worker.__name__, rank, world, out, store, args),
                         daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    hung = []
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            hung.append(p)
            p.kill()
            p.join(10)
    errors = []
    for rank in range(world):
        path = os.path.join(out, f"error_{worker.__name__}_{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"{worker.__name__}: exit codes {[p.exitcode for p in procs]}"
            + (f", {len(hung)} killed after {timeout} s" if hung else "")
            + "\n" + "\n".join(errors))


def _entry(name, rank, world, out, store, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        globals()[name](rank, world, out, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error_{name}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def save(out: str, name: str, obj) -> None:
    torch.save(obj, os.path.join(out, name))


def load(out: str, name: str):
    return torch.load(os.path.join(out, name), weights_only=False)


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def tiny_config():
    from rankpo_tpu_torch.models.config import EncoderConfig

    return EncoderConfig(
        model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rope_theta=10000.0, rope_scaling=None,
        pad_token_id=0, architectures=("LlamaModel",), pooling="last_token")


def model_from(state: dict):
    from rankpo_tpu_torch.models import llama

    return llama.LlamaEncoder.for_training(tiny_config(), state, device="cpu",
                                           compute_dtype=torch.float32)


def contrastive_rows(n: int, n_neg: int = 3, seed: int = 0) -> list:
    """Rows with one positive and exactly ``n_neg`` negatives: a collator
    with ``num_negatives = n_neg`` then draws the same passage set for a
    row whichever rank collates it (only their order varies, which the
    InfoNCE pool does not see)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [{"query": text(2, 9), "positives": [text(4, 20)],
             "negatives": [text(3, 24) for _ in range(n_neg)]} for _ in range(n)]


def pair_rows(n: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [{"query": text(2, 9), "passage1": text(4, 20), "passage2": text(4, 20),
             "preferred": "AB"[i % 2]} for i in range(n)]


def stage_parts(stage: str, packed: bool = False, rows_n: int = 32):
    """(dataset, collator factory, loss kwargs) of a stage on the tiny
    model, the port's side of the cross-package runs."""
    from rankpo_tpu_torch.data import collators as pcoll
    from rankpo_tpu_torch.data import datasets as pdata
    from rankpo_tpu_torch.data import packing as ppack
    from rankpo_tpu_torch.data.tokenization import HashTokenizer

    tok = HashTokenizer(vocab_size=256)
    if stage == "stage1":
        ds = pdata.ContrastiveDataset(contrastive_rows(rows_n), tok, 12, 16)
        if packed:
            make = lambda: ppack.PackedContrastiveCollator(  # noqa: E731
                pad_token_id=0, num_negatives=3, max_query_length=12, max_passage_length=16,
                query_max_segments=4, passage_max_segments=4, seed=3)
        else:
            make = lambda: pcoll.ContrastiveCollator(0, 3, 12, 16, seed=3)  # noqa: E731
    else:
        ds = pdata.PairPreferenceDataset(pair_rows(rows_n), tok, 12, 16)
        make = lambda: pcoll.RankPOCollator(0, 12, 16)  # noqa: E731
    return ds, make


STAGE1_LOSS = dict(temperature=0.05)
STAGE2_LOSS = dict(beta=2.0, temperature=0.1, loss_type="sigmoid", sft_weight=0.3)


def train_config(out: str, per_device: int, **extra):
    from rankpo_tpu_torch.train.config import TrainConfig

    kw = dict(device="cpu", output_dir=out, learning_rate=1e-3, lr_scheduler_type="cosine",
              warmup_steps=1, per_device_train_batch_size=per_device,
              gradient_accumulation_steps=2, max_steps=4, save_strategy="no",
              weight_decay=0.01, seed=3)
    kw.update(extra)
    return TrainConfig(**kw)


def loss_fn_for(stage: str, axis_name=None, **kw):
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn

    cfg = tiny_config()
    if stage == "stage1":
        return make_contrastive_loss_fn(cfg, axis_name=axis_name, **STAGE1_LOSS, **kw)
    return make_rankpo_loss_fn(cfg, **STAGE2_LOSS)


def save_model(directory: str, model) -> None:
    from rankpo_tpu_torch.models.hf_io import save_pretrained

    save_pretrained(directory, tiny_config(), model.state_dict(), dtype=torch.float32)


def run_stage(stage: str, state: dict, out: str, per_device: int, packed: bool = False,
              eval_rows: int = 0, **extra):
    """One stage through the port's Trainer: (history, final state,
    trainer, eval metrics or None). With a process group the loss pools the
    passages of every rank and packed budgets are agreed first."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.data.packing import configure_multiprocess_packing
    from rankpo_tpu_torch.train.trainer import Trainer

    axis = mesh.DATA_AXIS if mesh.is_distributed() else None
    ds, make = stage_parts(stage, packed)
    collator = make()
    if packed and mesh.process_count() > 1:
        configure_multiprocess_packing(collator, ds, per_device)
    model = model_from(state)
    trainer = Trainer(loss_fn=loss_fn_for(stage, axis), model=model,
                      config=train_config(out, per_device, **extra), total_steps=4,
                      save_params_fn=save_model)
    history = trainer.train(ds, collator)
    metrics = None
    if eval_rows:
        eval_ds, _ = stage_parts(stage, rows_n=eval_rows)
        metrics = trainer.evaluate(eval_ds, make(), batch_size=4)
    return history, {k: v.detach().clone() for k, v in model.state_dict().items()}, trainer, \
        metrics


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def loss_worker(rank, world, out):
    """Cross-device InfoNCE on this rank's contiguous block (the block a
    2-device data mesh gives the device): on reps, and through the model's
    loss function with and without cross-device negatives."""
    from rankpo_tpu_torch.losses.contrastive import info_nce_loss

    data = load(out, "loss_inputs.pt")
    b = data["q"].shape[0] // world
    g = data["p"].shape[0] // data["q"].shape[0]
    q = data["q"][rank * b:(rank + 1) * b].clone().requires_grad_(True)
    p = data["p"][rank * b * g:(rank + 1) * b * g].clone().requires_grad_(True)
    loss, _ = info_nce_loss(q, p, temperature=0.1, axis_name="data")
    loss.backward()
    result = {"loss": loss.detach(), "gq": q.grad, "gp": p.grad}
    batch = data["batch"]
    bm = batch["query"]["input_ids"].shape[0] // world
    gm = batch["passage"]["input_ids"].shape[0] // (bm * world)
    local = {"query": {k: v[rank * bm:(rank + 1) * bm] for k, v in batch["query"].items()},
             "passage": {k: v[rank * bm * gm:(rank + 1) * bm * gm]
                         for k, v in batch["passage"].items()}}
    for cross in (True, False):
        model = model_from(data["state"])
        fn = loss_fn_for("stage1", "data", negatives_cross_device=cross)
        loss, metrics = fn(model, local)
        loss.backward()
        result[f"model_cross{int(cross)}"] = {
            "loss": loss.detach(), "accuracy": metrics["accuracy"],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    save(out, f"loss_{rank}.pt", result)


def trainer_worker(rank, world, out):
    """Both stages at W ranks through the port's Trainer: stage 1 padded
    (checkpoints with the optimizer state at steps 2 and 4, and
    ``evaluate`` over 7 held-out rows), stage 1 packed, stage 2 (and its
    ``evaluate``)."""
    state = load(out, "state.pt")
    result = {}
    for case, stage, packed, extra in (
            ("stage1", "stage1", False,
             dict(save_strategy="steps", save_steps=2, save_only_model=False)),
            ("stage1_packed", "stage1", True, {}),
            ("stage2", "stage2", False, {})):
        case_out = os.path.join(out, case)
        history, final, trainer, metrics = run_stage(
            stage, state, case_out, 2, packed, eval_rows=0 if packed else 7, **extra)
        result[case] = {"history": history, "state": final, "eval": metrics,
                        "optimizer": trainer.optimizer.state_dict(),
                        "step": trainer.step, "updates": trainer.updates}
    save(out, f"trainer_{rank}.pt", result)


def zero_worker(rank, world, out):
    """ZeRO-1 and ZeRO-2 against each other and against one process, for
    each optimizer: on identical data on every rank (the mean of equal
    gradients is the gradient, so W ranks must give one process's bits),
    and on each rank's own rows through ``train`` (ZeRO-1 against ZeRO-2
    and the unsharded optimizer)."""
    from rankpo_tpu_torch.data.loader import DataLoader
    from rankpo_tpu_torch.parallel import sharding
    from rankpo_tpu_torch.train.trainer import Trainer

    # buckets of 16 KiB: the tiny model's exchanges then run many buckets,
    # the larger tensors alone and in place
    sharding.BUCKET_BYTES = 16 * 1024
    state = load(out, "state.pt")
    result = {}
    ds, make = stage_parts("stage1")
    groups = list(DataLoader(ds, make(), batch_size=4, seed=0).epoch(0, stack=2))[:3]
    for optim in ("adamw", "adamw8bit", "adafactor"):
        for mode, flags in (("zero1", dict(zero1=True)), ("zero2", dict(zero2=True)),
                            ("replicated", dict(zero1=False))):
            extra = dict(optim=optim, max_grad_norm=0.05, **flags)
            # identical data on every rank, no cross-device pool
            model = model_from(state)
            trainer = Trainer(loss_fn=loss_fn_for("stage1"), model=model,
                              config=train_config(out, 4, **extra), total_steps=4)
            logs = [trainer.train_step(gr) for gr in groups]
            same = {"logs": logs, "state": {k: v.clone() for k, v in model.state_dict().items()},
                    "state_bytes": sum(t.numel() * t.element_size()
                                       for s in trainer.optimizer.state.values()
                                       for t in s.values() if isinstance(t, torch.Tensor)),
                    "param_bytes": [p.numel() * p.element_size() for p in trainer.params],
                    "optimizer": trainer.optimizer.state_dict()}
            # each rank's own rows, cross-device negatives
            history, final, trainer, _ = run_stage("stage1", state, out, 2, **extra)
            result[(optim, mode)] = {"same": same, "split": {
                "history": history, "state": final, "optimizer": trainer.optimizer.state_dict()}}
    save(out, f"zero_{rank}.pt", result)
