"""Data-parallel training of the PyTorch port (``core/mesh.py``,
``utils/distributed.py``, cross-device negatives, the trainer's gradient
exchange, checkpoints, ``evaluate`` and the CLIs) against the JAX package
and against the port in one process.

The spawned cases run two CPU processes under gloo
(``torch_dist_workers.py``), each joined with a timeout of its own, on the
tiny llama (2 layers, width 64). Tolerances:

- cross-device InfoNCE gradients against the full-batch gradient (the
  port's and ``jax.grad``'s) and JAX's ``shard_map`` gradient: atol 1e-5,
  ``tests/test_losses.py::test_cross_device_gradient_exact``'s; through the
  model, the mean of the ranks' parameter gradients against JAX's
  full-batch (or per-block) loss on the same weights: atol 1e-5 as well;
- the trainer at W = 2 against JAX's Trainer on a 2-device data mesh and
  against the port at W = 1 on the same global batches: loss and gradient
  norm within rtol 2e-4 (JAX's own bound for a multi-process run,
  ``tests/test_multihost_train.py``; the largest differences seen on the
  CPU were 4e-6 against JAX and 2.2e-7 against W = 1), the ranks' logs
  identical; the parameters after 4 AdamW steps of lr 1e-3 within atol
  1e-6 of W = 1 (fp32; the pooled passages and the two halves' gradients
  are summed in other orders; the largest difference seen was 1.5e-7);
- ``evaluate`` at W = 2 against W = 1: rtol 1e-5 (fp32 sums in other
  orders; 6.7e-7 seen);
- a W = 2 checkpoint holds the optimizer state of one process bit for bit,
  and one process resumes from it.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from rankpo_tpu.core.mesh import MeshConfig as JMeshConfig
from rankpo_tpu.core.mesh import make_mesh
from rankpo_tpu.data import collators as jcoll
from rankpo_tpu.data import datasets as jdata
from rankpo_tpu.data import packing as jpack
from rankpo_tpu.data.tokenization import HashTokenizer as JHashTokenizer
from rankpo_tpu.losses.contrastive import info_nce_loss as jinfo_nce
from rankpo_tpu.models import init_params as jinit
from rankpo_tpu.models.config import tiny_llama_config as jtiny
from rankpo_tpu.train import TrainConfig as JTrainConfig
from rankpo_tpu.train import Trainer as JTrainer
from rankpo_tpu.train import make_contrastive_loss_fn as jcontrastive
from rankpo_tpu.train import make_rankpo_loss_fn as jrankpo
from rankpo_tpu.utils.distributed import split_between_processes as jsplit
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.losses.contrastive import info_nce_loss
from rankpo_tpu_torch.models.hf_io import load_pretrained, params_from_jax, save_pretrained
from rankpo_tpu_torch.parallel.sharding import _buckets, partition_params
from rankpo_tpu_torch.train import checkpoint as ckpt
from rankpo_tpu_torch.utils.distributed import split_between_processes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# without processes: splitting, the mesh arithmetic, bring-up refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("evenly", [False, True])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [1, 5, 8, 13])
def test_split_between_processes_matches_jax(length, count, evenly, padding):
    items = list(range(length))
    for index in range(count):
        kw = dict(apply_padding=padding, evenly_split=evenly, process_index=index,
                  process_count=count)
        assert split_between_processes(items, **kw) == jsplit(items, **kw)
        assert split_between_processes(tuple(items), **kw) == jsplit(tuple(items), **kw)
        table = {"a": items, "b": [str(i) for i in items]}
        assert split_between_processes(table, **kw) == jsplit(table, **kw)


def test_split_between_processes_defaults_to_this_process():
    """Without a process group: index 0 of 1, the input unchanged; unequal
    dict values raise as in JAX."""
    assert not dist.is_initialized()
    assert split_between_processes([1, 2, 3]) == [1, 2, 3]
    with pytest.raises(ValueError, match="same length"):
        split_between_processes({"a": [1], "b": [1, 2]}, process_index=0, process_count=2)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("dp,mp", [(-1, 1), (-1, 2), (-1, 3), (2, 1), (2, 2), (4, 2), (1, 4)])
def test_mesh_config_resolve_matches_jax(dp, mp, n):
    ours, theirs = mesh.MeshConfig(dp, mp), JMeshConfig(dp, mp)
    try:
        want = theirs.resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours.resolve(n)
        assert str(got.value) == str(e)
        return
    assert ours.resolve(n) == want


def test_model_parallel_and_fsdp_raise_naming_item_8b():
    """Item 8b is ported: ``model_parallel`` (tensor parallelism,
    ``test_torch_tensor_parallel.py``) takes any size from 1 and a size
    below 1 raises; ``fsdp`` (``test_torch_fsdp.py``) is accepted, and so
    are the two together (``test_torch_fsdp_grid.py``)."""
    from rankpo_tpu_torch.train.config import TrainConfig

    for mp in (1, 2, 4):
        mesh.MeshConfig(model_parallel=mp).check_supported()
        TrainConfig(model_parallel=mp).check_supported()
    mesh.MeshConfig(data_parallel=4).check_supported()
    TrainConfig(fsdp=True).check_supported()
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh.MeshConfig(model_parallel=0).check_supported()
    for mp in (2, 4):
        TrainConfig(fsdp=True, model_parallel=mp).check_supported()
    with pytest.raises(ValueError, match="must be >= 1"):
        TrainConfig(fsdp=True, model_parallel=0).check_supported()


def test_initialize_distributed_refusals():
    """No coordinator: a no-op. A CUDA run without a card raises before any
    group exists, and NCCL that cannot come up raises: no gloo, no CPU."""
    mesh.initialize_distributed()
    mesh.initialize_distributed(None, 2, 0)
    assert not dist.is_initialized() and mesh.process_count() == 1
    assert mesh.process_index() == 0 and mesh.is_main_process()
    mesh.barrier()  # no group: returns
    with pytest.raises(ValueError, match="num_processes"):
        mesh.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        mesh.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mesh.initialize_distributed("127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mesh.rank_device("cuda")
    if not dist.is_nccl_available():
        with pytest.raises((RuntimeError, ValueError)):
            mesh.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl",
                                        device="cpu")
    assert not dist.is_initialized()
    assert mesh.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_partition_params_balances_bytes(world):
    """Whole tensors, largest first: each rank holds at most total / W plus
    the largest tensor, and every tensor has one owner."""
    rng = np.random.default_rng(world)
    tensors = [torch.zeros(int(n)) for n in rng.integers(1, 5000, 40)] + [torch.zeros(9000)]
    owners = partition_params(tensors, world)
    assert sorted(set(owners)) == list(range(min(world, len(tensors))))
    loads = [sum(t.numel() for t, o in zip(tensors, owners) if o == r) for r in range(world)]
    total, largest = sum(t.numel() for t in tensors), max(t.numel() for t in tensors)
    assert max(loads) <= total / world + largest
    assert owners == partition_params(tensors, world)  # deterministic


def test_buckets_keep_order_dtype_and_cap():
    tensors = [torch.zeros(10), torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.bfloat16),
               torch.zeros(5, dtype=torch.bfloat16), torch.zeros(2)]
    runs = list(_buckets(tensors, range(len(tensors)), cap=100))
    assert runs == [[0, 1], [2], [3, 4], [5]]
    assert list(_buckets(tensors, [5, 0], cap=10**6)) == [[5, 0]]


# ---------------------------------------------------------------------------
# two processes: the loss
# ---------------------------------------------------------------------------

def _jax_model():
    jcfg = jtiny(vocab_size=256)
    params = jinit(jax.random.key(0), jcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), workers.tiny_config())
    return jcfg, params, state


def _stage1_batch():
    """A global stage-1 batch of 4 rows x group 4 from the port's collator
    (the JAX collator gives the same arrays for the same seed)."""
    ds, make = workers.stage_parts("stage1")
    collated = make()([ds[i] for i in range(4)])
    return {f: {k: torch.from_numpy(np.asarray(v)).long() if k == "input_ids"
                else torch.from_numpy(np.asarray(v)) for k, v in block.items()}
            for f, block in collated.items()}, collated


@pytest.fixture(scope="module")
def loss_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("loss"))
    rng = np.random.RandomState(4)
    q = rng.randn(8, 4).astype(np.float32)
    p = rng.randn(16, 4).astype(np.float32)
    jcfg, params, state = _jax_model()
    batch, collated = _stage1_batch()
    workers.save(out, "loss_inputs.pt", {"q": torch.from_numpy(q), "p": torch.from_numpy(p),
                                         "state": state, "batch": batch})
    workers.spawn(workers.loss_worker, 2, out)
    ranks = [workers.load(out, f"loss_{r}.pt") for r in range(2)]
    return dict(q=q, p=p, jcfg=jcfg, params=params, state=state, collated=collated,
                ranks=ranks)


def test_cross_device_gradient_matches_full_batch_and_jax(loss_run):
    """Each rank's loss over its rows against every rank's passages; the
    trainer's mean over ranks of the gradients (each rank's block of q and
    p, divided by W) is the full-batch gradient: the port's, ``jax.grad``'s
    and JAX's ``shard_map`` one."""
    q, p, ranks = loss_run["q"], loss_run["p"], loss_run["ranks"]
    tq, tp = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(p).requires_grad_(True)
    full, _ = info_nce_loss(tq, tp, temperature=0.1)
    full.backward()
    got_q = torch.cat([r["gq"] for r in ranks]) / 2
    got_p = torch.cat([r["gp"] for r in ranks]) / 2
    got_loss = (ranks[0]["loss"] + ranks[1]["loss"]) / 2
    np.testing.assert_allclose(got_loss.item(), full.item(), rtol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), tq.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), tp.grad.numpy(), atol=1e-5)

    jq, jp = jax.grad(lambda a, b: jinfo_nce(a, b, temperature=0.1)[0], argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(p))
    mesh2 = make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])

    def sharded(a, b):
        return shard_map(lambda x, y: jinfo_nce(x, y, temperature=0.1, axis_name="data")[0],
                         mesh=mesh2, in_specs=(P("data"), P("data")), out_specs=P())(a, b)

    sq, sp = jax.jit(jax.grad(sharded, argnums=(0, 1)))(jnp.asarray(q), jnp.asarray(p))
    for ref in ((jq, jp), (sq, sp)):
        np.testing.assert_allclose(got_q.numpy(), np.asarray(ref[0]), atol=1e-5)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref[1]), atol=1e-5)


@pytest.mark.parametrize("cross", [True, False])
def test_model_loss_and_gradients_match_jax(loss_run, cross):
    """Through the model: with cross-device negatives the ranks' mean loss
    and mean parameter gradient are JAX's full-batch ones; without, they are
    JAX's ``info_nce_block_loss`` over the two contiguous blocks (each rank
    its own in-batch pool, no collective)."""
    jcfg, params, ranks = loss_run["jcfg"], loss_run["params"], loss_run["ranks"]
    jloss_fn = jcontrastive(jcfg, temperature=0.05, compute_dtype=jnp.float32,
                            negatives_cross_device=cross, num_data_shards=2)
    batch = jax.tree_util.tree_map(jnp.asarray, loss_run["collated"])
    (jl, jm), jg = jax.value_and_grad(lambda pr: jloss_fn(pr, batch, None), has_aux=True)(
        params)
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), workers.tiny_config())
    got = [r[f"model_cross{int(cross)}"] for r in ranks]
    np.testing.assert_allclose((got[0]["loss"] + got[1]["loss"]).item() / 2, float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose((got[0]["accuracy"] + got[1]["accuracy"]).item() / 2,
                               float(jm["accuracy"]), atol=1e-6)
    for name, ref in jg.items():
        mean = (got[0]["grads"][name] + got[1]["grads"][name]) / 2
        np.testing.assert_allclose(mean.numpy(), ref.numpy(), atol=1e-5, err_msg=name)


def test_cross_device_axis_needs_a_group():
    q = torch.zeros(2, 4)
    with pytest.raises(RuntimeError, match="process group"):
        info_nce_loss(q, torch.zeros(4, 4), axis_name="data")


# ---------------------------------------------------------------------------
# two processes: the trainer (both stages, packed, checkpoint, evaluate)
# ---------------------------------------------------------------------------

def _jax_stage(stage, params, jcfg, packed=False):
    """JAX's Trainer on a 2-device data mesh, per-device batch 2, on the
    workers' rows and settings."""
    tok = JHashTokenizer(vocab_size=256)
    if stage == "stage1":
        ds = jdata.ContrastiveDataset(workers.contrastive_rows(32), tok, 12, 16)
        coll = (jpack.PackedContrastiveCollator(
            pad_token_id=0, num_negatives=3, max_query_length=12, max_passage_length=16,
            query_max_segments=4, passage_max_segments=4, rows_multiple=2, seed=3)
            if packed else jcoll.ContrastiveCollator(0, 3, 12, 16, seed=3))
        loss = jcontrastive(jcfg, compute_dtype=jnp.float32, **workers.STAGE1_LOSS)
    else:
        ds = jdata.PairPreferenceDataset(workers.pair_rows(32), tok, 12, 16)
        coll = jcoll.RankPOCollator(0, 12, 16)
        loss = jrankpo(jcfg, compute_dtype=jnp.float32, **workers.STAGE2_LOSS)
    cfg = JTrainConfig(learning_rate=1e-3, lr_scheduler_type="cosine", warmup_steps=1,
                       per_device_train_batch_size=2, gradient_accumulation_steps=2,
                       max_steps=4, save_strategy="no", weight_decay=0.01, seed=3)
    mesh2 = make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])
    return JTrainer(loss_fn=loss, params=params, mesh=mesh2, config=cfg,
                    total_steps=4).train(ds, coll)


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("trainer"))
    jcfg, params, state = _jax_model()
    workers.save(out, "state.pt", state)
    workers.spawn(workers.trainer_worker, 2, out)
    ranks = [workers.load(out, f"trainer_{r}.pt") for r in range(2)]
    one = {}
    for case, stage, packed in (("stage1", "stage1", False), ("stage1_packed", "stage1", True),
                                ("stage2", "stage2", False)):
        history, final, _, metrics = workers.run_stage(
            stage, state, os.path.join(out, "one", case), 4, packed,
            eval_rows=0 if packed else 7)
        one[case] = {"history": history, "state": final, "eval": metrics}
    return dict(out=out, jcfg=jcfg, params=params, state=state, ranks=ranks, one=one)


def _losses(history, key="loss"):
    return [h[key] for h in history if key in h]


@pytest.mark.parametrize("case", ["stage1", "stage1_packed", "stage2"])
def test_two_ranks_match_one_process_and_jax_mesh(trainer_run, case):
    ranks, one = trainer_run["ranks"], trainer_run["one"][case]
    h0, h1 = ranks[0][case]["history"], ranks[1][case]["history"]
    assert len(h0) == 4
    for key in ("loss", "grad_norm", "learning_rate"):
        assert _losses(h0, key) == _losses(h1, key), f"ranks logged different {key}"
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(h0, key), _losses(one["history"], key), rtol=2e-4)
    stage = "stage1" if case.startswith("stage1") else "stage2"
    jhist = _jax_stage(stage, trainer_run["params"], trainer_run["jcfg"],
                       packed=case == "stage1_packed")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(h0, key), _losses(jhist, key), rtol=2e-4)
    for name, ref in one["state"].items():
        assert torch.equal(ranks[0][case]["state"][name], ranks[1][case]["state"][name]), name
        np.testing.assert_allclose(ranks[0][case]["state"][name].numpy(), ref.numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    # the global batch: both ranks' rows, per-device batch x 2
    assert h0[-1]["samples_per_sec"] > 0


@pytest.mark.parametrize("case", ["stage1", "stage2"])
def test_evaluate_two_ranks_matches_one(trainer_run, case):
    """7 held-out rows in global batches of 4: the ranks take 2 + 2, then
    2 + (1 and a masked pad row); their row-weighted sums give W = 1's."""
    got = [r[case]["eval"] for r in trainer_run["ranks"]]
    want = trainer_run["one"][case]["eval"]
    assert got[0] == got[1] and set(got[0]) == set(want) and "eval_loss" in want
    for key, value in want.items():
        np.testing.assert_allclose(got[0][key], value, rtol=1e-5, atol=1e-7, err_msg=key)


def test_two_rank_checkpoint_resumes_in_one_process(trainer_run):
    """Rank 0 wrote checkpoint-2 and -4 of the W = 2 stage 1; the gathered
    optimizer state is every rank's own state, merged, bit for bit; one
    process resumes it (and its model) and trains on."""
    from rankpo_tpu_torch.train.trainer import Trainer

    out = os.path.join(trainer_run["out"], "stage1")
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4"]
    payload = ckpt.load_opt_state(os.path.join(out, "checkpoint-4"))
    ranks = [r["stage1"] for r in trainer_run["ranks"]]
    assert payload["step"] == payload["updates"] == 4
    merged = {}
    for r in ranks:
        merged.update(r["optimizer"]["state"])
    assert sorted(payload["optimizer"]["state"]) == sorted(merged) == list(range(len(merged)))
    for i, state in merged.items():
        for key, value in state.items():
            assert torch.equal(payload["optimizer"]["state"][i][key], value), (i, key)
    (group,) = payload["optimizer"]["param_groups"]
    assert group["params"] == list(range(len(merged)))

    _, weights = load_pretrained(os.path.join(out, "checkpoint-4"))
    for name, value in ranks[0]["state"].items():
        assert torch.equal(weights[name], value), name
    model = workers.model_from(weights)
    trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                      config=workers.train_config(os.path.join(out, "resumed"), 4,
                                                  max_steps=6), total_steps=4)
    trainer.resume_from(os.path.join(out, "checkpoint-4"))
    assert trainer.step == trainer.updates == 4
    state = trainer.optimizer.state_dict()["state"]
    for i, entry in merged.items():
        for key, value in entry.items():
            assert torch.equal(state[i][key], value), (i, key)
    ds, make = workers.stage_parts("stage1")
    history = trainer.train(ds, make())
    assert [h["global_step"] for h in history] == [5, 6]
    assert np.all(np.isfinite(_losses(history)))


# ---------------------------------------------------------------------------
# the CLI as two processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_run_contrastive_two_processes_rank0_writes(tmp_path):
    """``run_contrastive`` started twice with the three flags (gloo on the
    CPU): both ranks train, rank 0 alone writes (rank 1's own output
    directory is never made), and the checkpoint holds the optimizer
    state."""
    ckpt_dir = tmp_path / "base"
    save_pretrained(str(ckpt_dir), workers.tiny_config(), _jax_model()[2])
    data = tmp_path / "train.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in workers.contrastive_rows(16)))
    port = _free_port()
    outs = [tmp_path / "rank0", tmp_path / "rank1"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rankpo_tpu_torch.cli.run_contrastive",
         "--model_name_or_path", str(ckpt_dir), "--tokenizer_name", "hash:256",
         "--train_data", str(data), "--output_dir", str(outs[rank]), "--device", "cpu",
         "--bf16", "False", "--max_query_length", "12", "--max_passage_length", "16",
         "--num_negatives", "3", "--per_device_train_batch_size", "2", "--max_steps", "2",
         "--learning_rate", "1e-3", "--save_strategy", "steps", "--save_steps", "2",
         "--save_only_model", "False", "--negatives_cross_device", "True", "--zero1", "True",
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(rank), "--log_level", "warning"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    assert not outs[1].exists()
    history = json.loads((outs[0] / "trainer_history.json").read_text())
    assert [h["global_step"] for h in history] == [1, 2]
    assert np.all(np.isfinite([h["loss"] for h in history]))
    assert (outs[0] / "checkpoint-2" / ckpt.OPT_STATE_FILE).is_file()
    _, final = load_pretrained(str(outs[0]))
    _, saved = load_pretrained(str(outs[0] / "checkpoint-2"))
    assert all(torch.equal(final[k], saved[k]) for k in final)
