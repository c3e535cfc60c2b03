"""Worker processes for the multi-process tests of the PyTorch port
(``test_torch_distributed.py``, ``test_torch_zero.py``,
``test_torch_ring_attention.py``, ``test_torch_tensor_parallel.py``), and
:func:`spawn`, which also runs workers of other modules
(``torch_serve_workers.py``).

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
    target = f"{worker.__module__}:{worker.__name__}"
    procs = [ctx.Process(target=_entry, args=(target, rank, world, out, store, args),
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


def _entry(target, rank, world, out, store, args):
    import importlib

    torch.set_num_threads(1)
    module, name = target.split(":")
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        getattr(importlib.import_module(module), name)(rank, world, out, *args)
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
    """The tiny llama for training on the CPU from a full state dict, split
    over the grid's model axis when it has one."""
    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.models.base import TensorParallel

    return llama.LlamaEncoder.for_training(tiny_config(), state, device="cpu",
                                           compute_dtype=torch.float32,
                                           tensor_parallel=TensorParallel.current())


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


def loss_fn_for(stage: str, axis_name=None, ref_state=None, **kw):
    """The stage's loss on the tiny llama; stage 2 with ``ref_state`` scores
    against a frozen reference built from it (split like the trained model
    under tensor parallelism)."""
    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.models.base import TensorParallel
    from rankpo_tpu_torch.train.steps import make_contrastive_loss_fn, make_rankpo_loss_fn

    cfg = tiny_config()
    if stage == "stage1":
        return make_contrastive_loss_fn(cfg, axis_name=axis_name, **STAGE1_LOSS, **kw)
    if ref_state is None:
        return make_rankpo_loss_fn(cfg, **STAGE2_LOSS)
    ref = llama.LlamaEncoder.from_state_dict(cfg, ref_state, device="cpu",
                                             tensor_parallel=TensorParallel.current())
    return make_rankpo_loss_fn(cfg, reference_free=False, ref_model=ref, **STAGE2_LOSS)


def save_model(directory: str, model) -> None:
    """The model in the one-process layout (gathered over the model group:
    every rank of rank 0's model group calls this), written by rank 0."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.models.hf_io import save_pretrained
    from rankpo_tpu_torch.parallel.sharding import full_state_dict

    state = full_state_dict(model)
    if mesh.is_main_process():
        save_pretrained(directory, tiny_config(), state, dtype=torch.float32)


def run_stage(stage: str, state: dict, out: str, per_device: int, packed: bool = False,
              eval_rows: int = 0, ref_state=None, **extra):
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
    trainer = Trainer(loss_fn=loss_fn_for(stage, axis, ref_state=ref_state), model=model,
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


# ---------------------------------------------------------------------------
# ring attention (test_torch_ring_attention.py)
# ---------------------------------------------------------------------------

RING_GRID = [(False, 0, 4), (True, 0, 4), (False, 17, 4), (True, 9, 4), (True, 0, 2),
             (True, 13, 2)]
RING_GRADS = [("xla", True), ("flash", True), ("flash", False)]


def ring_data(seed, b=2, s=64, hq=4, hkv=4, d=16, pad=0):
    """The JAX test's inputs (``tests/test_ring_attention.py`` ``_data``):
    q/k/v float32 from ``RandomState(seed)``, the last ``pad`` keys masked."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    if pad:
        mask[:, -pad:] = 0
    return q, k, v, mask


def ring_worker(rank, world, out):
    """Every ring case on this rank: values over the grid for both impls,
    gradients of sum(out^2), the indivisible sequence, the shapes every op
    made (no [S, S] tensor), and a ring of one against the plain kernel
    version."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from rankpo_tpu_torch.ops import flash_attention as flash
    from rankpo_tpu_torch.parallel import ring_attention as ring

    group = dist.group.WORLD
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    result = {"values": {}, "grads": {}}
    for causal, pad, hkv in RING_GRID:
        q, k, v, mask = map(t, ring_data(0 if pad != 13 else 4, hkv=hkv, pad=pad))
        for impl in ring.IMPLS:
            got = ring.context_parallel_attention(q, k, v, group=group, mask=mask,
                                                  causal=causal, impl=impl)
            result["values"][(causal, pad, hkv, impl)] = got
    for impl, causal in RING_GRADS:
        q, k, v, mask = map(t, ring_data(5, pad=7, hkv=2))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = ring.context_parallel_attention(q, k, v, group=group, mask=mask, causal=causal,
                                            impl=impl)
        (o.float() ** 2).sum().backward()
        result["grads"][(impl, causal)] = (q.grad, k.grad, v.grad)
    q, k, v, mask = map(t, ring_data(3, s=63))
    try:
        ring.context_parallel_attention(q, k, v, group=group, mask=mask)
        result["indivisible"] = None
    except ValueError as e:
        result["indivisible"] = str(e)

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            for x in (res if isinstance(res, (tuple, list)) else (res,)):
                if isinstance(x, torch.Tensor):
                    self.seen.add(tuple(x.shape))
            return res

    result["shapes"] = {}
    for impl in ring.IMPLS:
        q, k, v, mask = map(t, ring_data(2, s=128))
        q.requires_grad_(True)
        with Shapes() as mode:
            o = ring.context_parallel_attention(q, k, v, group=group, mask=mask, impl=impl)
            o.sum().backward()
        result["shapes"][impl] = sorted(mode.seen)
    # a ring of one: the plain kernel version (forward) bit for bit
    solo = [dist.new_group([r]) for r in range(world)][rank]
    q, k, v, mask = map(t, ring_data(6, pad=3, hkv=2))
    got = ring.context_parallel_attention(q, k, v, group=solo, mask=mask, causal=True,
                                          impl="flash")
    want, _ = flash.flash_attention_fwd_reference(q, k, v, mask, causal=True)
    result["solo_equal"] = bool(torch.equal(got, want))
    save(out, f"ring_{rank}.pt", result)


# ---------------------------------------------------------------------------
# tensor parallelism (test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

TP_BODIES = ("llama", "qwen2", "xlm-roberta", "xlm-roberta-dropout")
TP_POLICIES = ("full", "dots", "attn")


def tp_embed_loss(model, qb, pb, generator_seed=None):
    """InfoNCE over the queries' and passages' embeddings (every query's
    positive at column 2i), as ``tests/test_torch_roberta.py``'s; with a
    seed, dropout drawn from one generator for both fields."""
    from rankpo_tpu_torch.models import encoder as penc

    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    q, p = penc.embed(model, qb, generator=gen), penc.embed(model, pb, generator=gen)
    logits = q @ p.T / 0.05
    return torch.nn.functional.cross_entropy(logits, torch.arange(q.shape[0]) * 2)


def _gather_heads(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def tp_worker(rank, world, out):
    """At (dp 1, mp ``world``): the attention on this rank's heads (output
    and q/k/v gradients gathered over the heads), each body's embedding loss
    and gathered parameter gradients (with and without checkpointing under
    each policy), and both stages through the Trainer (stage 2 against a
    frozen reference split like the model), with the full final weights and
    the gathered optimizer state."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.models.base import TensorParallel
    from rankpo_tpu_torch.models.encoder import encoder_class
    from rankpo_tpu_torch.ops.attention import multi_head_attention
    from rankpo_tpu_torch.parallel.sharding import gather_state

    grid = mesh.make_groups(mesh.MeshConfig(model_parallel=world))
    group, m = grid.model, grid.model_index
    data = load(out, "tp_inputs.pt")
    result = {"grid": (grid.dp, grid.mp, grid.data_index, grid.model_index)}
    # the attention on this rank's heads
    q, k, v, mask = data["attention"]
    hq, hkv = q.shape[2] // world, k.shape[2] // world
    ql, kl, vl = (x[:, :, m * h:(m + 1) * h].clone().requires_grad_(True)
                  for x, h in ((q, hq), (k, hkv), (v, hkv)))
    o = multi_head_attention(ql, kl, vl, mask=mask, causal=True)
    (o ** 2).sum().backward()
    result["attention"] = [_gather_heads(x, group) for x in (o.detach(), ql.grad, kl.grad,
                                                              vl.grad)]
    # each body's loss and gradients
    for body in TP_BODIES:
        cfg, state, qb, pb, seed = data[body]
        for policy in (None, *TP_POLICIES):
            model = encoder_class(cfg).for_training(
                cfg, state, device="cpu", compute_dtype=torch.float32,
                gradient_checkpointing=policy is not None,
                checkpoint_policy=policy or "full", tensor_parallel=TensorParallel.current())
            loss = tp_embed_loss(model, qb, pb, seed)
            loss.backward()
            grads = gather_state({n: p.grad for n, p in model.named_parameters()}, group)
            result[(body, policy)] = {"loss": loss.detach(), "grads": grads}
    # both stages through the Trainer
    state = data["state"]
    for case, stage, ref, extra in (
            ("stage1", "stage1", None,
             dict(save_strategy="steps", save_steps=2, save_only_model=False)),
            ("stage2", "stage2", state, {})):
        history, final, trainer, _ = run_stage(stage, state, os.path.join(out, "tp", case), 2,
                                               ref_state=ref, **extra)
        result[case] = {"history": history, "state": gather_state(final, group),
                        "optimizer": trainer.gather_optimizer_state()}
    save(out, f"tp_{rank}.pt", result)


def grid_worker(rank, world, out):
    """At (dp 2, mp 2) over 4 ranks: the group layout (each rank's indices
    and the sums of the global ranks over its two groups), then stage 1
    through the Trainer with cross-device negatives and ZeRO-1 over the data
    group, checkpointing the optimizer state at step 4."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.parallel.sharding import gather_state

    grid = mesh.make_groups(mesh.MeshConfig(model_parallel=2))
    sums = []
    for group in (grid.model, grid.data):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        sums.append(t.item())
    result = {"grid": (grid.dp, grid.mp, grid.data_index, grid.model_index), "sums": sums}
    state = load(out, "grid_state.pt")
    history, final, trainer, _ = run_stage(
        "stage1", state, os.path.join(out, "grid", "stage1"), 1, save_strategy="steps",
        save_steps=4, save_only_model=False)
    result["history"] = history
    result["state"] = gather_state(final, grid.model)
    result["optimizer"] = trainer.gather_optimizer_state()
    save(out, f"grid_{rank}.pt", result)


# ---------------------------------------------------------------------------
# fsdp (test_torch_fsdp.py)
# ---------------------------------------------------------------------------

def fsdp_worker(rank, world, out):
    """Both stages at W ranks with ``fsdp`` (stage 1 checkpointing the
    optimizer state at steps 2 and 4), stage 1 again under ZeRO-1, and
    stage 1 with gradient checkpointing under the "attn" policy (the
    recompute gathers again); each with the gathered final weights, the
    bytes this rank stores (parameters, optimizer state) and, for the first,
    the gathered optimizer state."""
    from rankpo_tpu_torch.models import llama
    from rankpo_tpu_torch.parallel.sharding import full_state_dict
    from rankpo_tpu_torch.train.trainer import Trainer

    state = load(out, "state.pt")
    result = {}

    def held(trainer):
        params = sum(p.numel() * p.element_size() for p in trainer.params)
        opt = sum(t.numel() * t.element_size() for s in trainer.optimizer.state.values()
                  for t in s.values() if isinstance(t, torch.Tensor))
        return params, opt

    for case, stage, extra in (
            ("stage1", "stage1", dict(fsdp=True, save_strategy="steps", save_steps=2,
                                      save_only_model=False)),
            ("stage2", "stage2", dict(fsdp=True)),
            ("stage1_zero1", "stage1", dict(zero1=True))):
        history, _, trainer, _ = run_stage(stage, state, os.path.join(out, "fsdp", case), 2,
                                           **extra)
        result[case] = {"history": history, "state": full_state_dict(trainer.model),
                        "held": held(trainer), "optimizer": trainer.gather_optimizer_state(),
                        "owners": trainer._owners}
    from rankpo_tpu_torch.core import mesh

    ds, make = stage_parts("stage1")
    model = llama.LlamaEncoder.for_training(tiny_config(), state, device="cpu",
                                            compute_dtype=torch.float32,
                                            gradient_checkpointing=True,
                                            checkpoint_policy="attn")
    trainer = Trainer(loss_fn=loss_fn_for("stage1", mesh.DATA_AXIS), model=model,
                      config=train_config(out, 2, fsdp=True), total_steps=4)
    history = trainer.train(ds, make())
    result["stage1_remat"] = {"history": history, "state": full_state_dict(model)}
    save(out, f"fsdp_{rank}.pt", result)


# ---------------------------------------------------------------------------
# LoRA under a model axis and under fsdp, fsdp with a model axis
# (test_torch_sharded_lora.py)
# ---------------------------------------------------------------------------

LORA_OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
LORA = dict(r=4, alpha=8.0)


def lora_model_from(state: dict, adapters: dict, targets):
    """:func:`model_from` with LoRA on ``targets``, the adapters
    ``adapters`` (``lora.adapters_from_jax``'s, whole)."""
    from rankpo_tpu_torch.models import lora

    return lora.apply_lora(model_from(state), lora.LoraConfig(target_modules=tuple(targets),
                                                              **LORA), adapters=adapters)


def save_lora_model(directory: str, model) -> None:
    """The merged model in the one-process layout and the whole adapters
    (every rank that gathers calls this), written by rank 0."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.models import lora
    from rankpo_tpu_torch.models.hf_io import save_pretrained

    state, adapters = lora.merged_state_dict(model), lora.adapter_state_dict(model)
    if mesh.is_main_process():
        save_pretrained(directory, tiny_config(), state, dtype=torch.float32)
        torch.save(adapters, os.path.join(directory, "lora_adapters.pt"))


def held_bytes(trainer) -> tuple:
    """(trainable parameter bytes, optimizer-state bytes) this rank stores."""
    params = sum(p.numel() * p.element_size() for p in trainer.params)
    opt = sum(t.numel() * t.element_size() for s in trainer.optimizer.state.values()
              for t in s.values() if isinstance(t, torch.Tensor))
    return params, opt


def run_lora_stage(stage: str, state: dict, adapters: dict, targets, out: str,
                   per_device: int, **extra):
    """One stage with LoRA through the port's Trainer: (history, trainer)."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.train.trainer import Trainer

    axis = mesh.DATA_AXIS if mesh.is_distributed() else None
    ds, make = stage_parts(stage)
    model = lora_model_from(state, adapters, targets)
    trainer = Trainer(loss_fn=loss_fn_for(stage, axis), model=model,
                      config=train_config(out, per_device, **extra), total_steps=4,
                      save_params_fn=save_lora_model)
    return trainer.train(ds, make()), trainer


def _lora_result(history, trainer) -> dict:
    from rankpo_tpu_torch.models import lora

    return {"history": history, "adapters": lora.adapter_state_dict(trainer.model),
            "merged": lora.merged_state_dict(trainer.model), "held": held_bytes(trainer),
            "optimizer": trainer.gather_optimizer_state()}


def adapter_grads(model) -> dict:
    """``{path}.lora_a`` / ``.lora_b`` -> the adapter's gradient."""
    from torch.nn.utils import parametrize

    out = {}
    for path, module in model.named_modules():
        if parametrize.is_parametrized(module, "weight"):
            merge = module.parametrizations.weight[0]
            out[f"{path}.lora_a"], out[f"{path}.lora_b"] = merge.lora_a.grad, merge.lora_b.grad
    return out


def sharded_lora_worker(rank, world, out):
    """Two ranks: at (dp 1, mp 2) each body's embedding loss and adapter
    gradients with LoRA on every target of the body, and LoRA on stage 2
    with each optimizer (the AdamW run checkpointing the optimizer state at
    step 4); then LoRA under fsdp at (dp 2, mp 1) on both stages (stage 2
    checkpointing). Each run with the history, the whole adapters, the
    merged model in the one-process layout, the bytes stored and the
    gathered optimizer state."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.models import lora
    from rankpo_tpu_torch.models.base import TensorParallel
    from rankpo_tpu_torch.models.encoder import encoder_class

    data = load(out, "lora_inputs.pt")
    state, adapters, targets = data["state"], data["adapters"], data["targets"]
    result = {}
    mesh.make_groups(mesh.MeshConfig(model_parallel=2))
    for body, (cfg, body_state, qb, pb, body_adapters, body_targets) in data["bodies"].items():
        model = encoder_class(cfg).for_training(cfg, body_state, device="cpu",
                                                compute_dtype=torch.float32,
                                                tensor_parallel=TensorParallel.current())
        lora.apply_lora(model, lora.LoraConfig(target_modules=body_targets, **LORA),
                        adapters=body_adapters)
        loss = tp_embed_loss(model, qb, pb)
        loss.backward()
        result[("body", body)] = {"loss": loss.detach(), "grads": adapter_grads(model),
                                  "merged": lora.merged_state_dict(model)}
    for optim in LORA_OPTIMIZERS:
        extra = dict(optim=optim)
        if optim == "adamw":
            extra.update(save_strategy="steps", save_steps=4, save_only_model=False)
        history, trainer = run_lora_stage("stage2", state, adapters, targets,
                                          os.path.join(out, "lora_mp2", optim), 2, **extra)
        result[("mp2", optim)] = _lora_result(history, trainer)
    mesh.make_groups(mesh.MeshConfig(model_parallel=1))
    for stage in ("stage1", "stage2"):
        extra = dict(fsdp=True)
        if stage == "stage2":
            extra.update(save_strategy="steps", save_steps=4, save_only_model=False)
        history, trainer = run_lora_stage(stage, state, adapters, targets,
                                          os.path.join(out, "lora_fsdp", stage), 2, **extra)
        result[("fsdp", stage)] = _lora_result(history, trainer)
    save(out, f"sharded_lora_{rank}.pt", result)


def fsdp_grid_worker(rank, world, out):
    """Four ranks at (dp 2, mp 2) with ``fsdp``: both stages (stage 1
    checkpointing the optimizer state at step 4), each with the history, the
    model in the one-process layout, the bytes stored, this rank's shard
    shapes and the gathered optimizer state."""
    from rankpo_tpu_torch.core import mesh
    from rankpo_tpu_torch.parallel.sharding import full_state_dict

    grid = mesh.make_groups(mesh.MeshConfig(model_parallel=2))
    state = load(out, "grid_state.pt")
    result = {"grid": (grid.dp, grid.mp, grid.data_index, grid.model_index)}
    for stage, extra in (("stage1", dict(save_strategy="steps", save_steps=4,
                                         save_only_model=False)),
                         ("stage2", {})):
        history, _, trainer, _ = run_stage(stage, state, os.path.join(out, "fsdp_grid", stage),
                                           1, fsdp=True, **extra)
        result[stage] = {"history": history, "state": full_state_dict(trainer.model),
                         "held": held_bytes(trainer), "shapes": trainer.fsdp.shapes,
                         "owners": trainer.fsdp.owners,
                         "optimizer": trainer.gather_optimizer_state()}
    save(out, f"fsdp_grid_{rank}.pt", result)
