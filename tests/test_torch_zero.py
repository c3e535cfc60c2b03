"""ZeRO-1 and ZeRO-2 optimizer sharding of the PyTorch port
(``parallel/sharding.py``, the trainer's gradient exchange), two CPU
processes under gloo (``torch_dist_workers.py``), for each of ``adamw``,
``adamw8bit`` and ``adafactor``, with clipping on (max_grad_norm 0.05):

- on identical data on both ranks (the mean of two equal gradients is the
  gradient), ZeRO-1, ZeRO-2 and the unsharded optimizer at W = 2 give the
  parameters, losses and gradient norms of one process bit for bit: each
  rank's optimizer holds whole tensors, so every update is the one-process
  update of that tensor;
- on each rank's own rows with cross-device negatives, ZeRO-1 and ZeRO-2
  (which takes ZeRO-1's path) and the unsharded optimizer give the same
  bits: the same sums and the same gradient norm;
- each rank's optimizer state is at most total / W plus the largest
  tensor's state.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402

from rankpo_tpu_torch.data.loader import DataLoader  # noqa: E402
from rankpo_tpu_torch.models import llama  # noqa: E402
from rankpo_tpu_torch.parallel.sharding import ShardedOptimizer, partition_params  # noqa: E402
from rankpo_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(2)
OPTIMIZERS = ["adamw", "adamw8bit", "adafactor"]
MODES = ["zero1", "zero2", "replicated"]


@pytest.fixture(scope="module")
def zero_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("zero"))
    state = llama.init_params(workers.tiny_config(), torch.Generator().manual_seed(0))
    workers.save(out, "state.pt", state)
    workers.spawn(workers.zero_worker, 2, out, timeout=300)
    ranks = [workers.load(out, f"zero_{r}.pt") for r in range(2)]
    one = {}
    ds, make = workers.stage_parts("stage1")
    groups = list(DataLoader(ds, make(), batch_size=4, seed=0).epoch(0, stack=2))[:3]
    for optim in OPTIMIZERS:
        model = workers.model_from(state)
        trainer = Trainer(loss_fn=workers.loss_fn_for("stage1"), model=model,
                          config=workers.train_config(out, 4, optim=optim, max_grad_norm=0.05),
                          total_steps=4)
        logs = [trainer.train_step(g) for g in groups]
        per_tensor = [sum(t.numel() * t.element_size() for t in trainer.optimizer.state[p].values()
                          if isinstance(t, torch.Tensor)) for p in trainer.params]
        one[optim] = {"logs": logs, "state": model.state_dict(), "per_tensor": per_tensor}
    return {"ranks": ranks, "one": one}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("optim", OPTIMIZERS)
def test_identical_data_gives_one_process_bits(zero_run, optim, mode):
    one = zero_run["one"][optim]
    for rank in zero_run["ranks"]:
        got = rank[(optim, mode)]["same"]
        assert [(g["loss"], g["grad_norm"]) for g in got["logs"]] == [
            (g["loss"], g["grad_norm"]) for g in one["logs"]]
        assert any(g["grad_norm"] > 0.05 for g in got["logs"])  # clipping ran
        for name, value in one["state"].items():
            assert torch.equal(got["state"][name], value), name


@pytest.mark.parametrize("optim", OPTIMIZERS)
def test_zero2_equals_zero1_bit_for_bit(zero_run, optim):
    """Each rank's own rows: ZeRO-2 and the unsharded optimizer give
    ZeRO-1's logs, parameters and optimizer state, on both ranks."""
    ranks = zero_run["ranks"]
    ref = ranks[0][(optim, "zero1")]["split"]
    for rank in ranks:
        for mode in MODES:
            got = rank[(optim, mode)]["split"]
            for key in ("loss", "grad_norm"):
                assert [h[key] for h in got["history"]] == [h[key] for h in ref["history"]]
            for name, value in ref["state"].items():
                assert torch.equal(got["state"][name], value), (mode, name)
        z1, z2 = rank[(optim, "zero1")]["split"], rank[(optim, "zero2")]["split"]
        assert z1["optimizer"]["state"].keys() == z2["optimizer"]["state"].keys()
        for i, entry in z1["optimizer"]["state"].items():
            for key, value in entry.items():
                if isinstance(value, torch.Tensor):
                    assert torch.equal(z2["optimizer"]["state"][i][key], value), (i, key)
                else:
                    assert z2["optimizer"]["state"][i][key] == value


@pytest.mark.parametrize("optim", OPTIMIZERS)
def test_sharded_state_is_at_most_half_plus_largest(zero_run, optim):
    per_tensor = zero_run["one"][optim]["per_tensor"]
    total, largest = sum(per_tensor), max(per_tensor)
    owned = []
    for rank in zero_run["ranks"]:
        for mode in ("zero1", "zero2"):
            got = rank[(optim, mode)]["same"]["state_bytes"]
            assert 0 < got <= total / 2 + largest, (mode, got, total)
        owned.append(set(rank[(optim, "zero1")]["same"]["optimizer"]["state"]))
        replicated = rank[(optim, "replicated")]["same"]["state_bytes"]
        assert replicated == total
    assert not owned[0] & owned[1] and owned[0] | owned[1] == set(range(len(per_tensor)))


def test_sharded_optimizer_state_dict_round_trip():
    """Without a process group: a ShardedOptimizer owning every tensor is the
    plain optimizer (same state dict), and one owning a subset takes its
    tensors' entries from a whole state dict, under global indices."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(n)) for n in (5, 3, 8, 2)]
    for p in params:
        p.grad = torch.randn_like(p)
    plain = torch.optim.AdamW(params, lr=1e-2)
    plain.step()
    full = plain.state_dict()
    owners = partition_params(params, 2)
    assert owners == [1, 1, 0, 0]  # 8 -> 0, 5 -> 1, 3 -> 1, 2 -> 0 (tie: the lower rank)
    for rank in (0, 1):
        shard = ShardedOptimizer(params, owners, rank,
                                 lambda ps: torch.optim.AdamW(ps, lr=1e-2))
        shard.load_state_dict(full)
        sd = shard.state_dict()
        mine = [i for i, o in enumerate(owners) if o == rank]
        assert sorted(sd["state"]) == mine
        for i in mine:
            for key, value in full["state"][i].items():
                assert torch.equal(sd["state"][i][key], value)
        assert sd["param_groups"][0]["params"] == mine
    whole = ShardedOptimizer(params, [0] * 4, 0, lambda ps: torch.optim.AdamW(ps, lr=1e-2))
    whole.load_state_dict(full)
    assert whole.state_dict()["param_groups"] == full["param_groups"]
    with pytest.raises(ValueError, match="tensors"):
        whole.load_state_dict({"state": {}, "param_groups": [{**full["param_groups"][0],
                                                              "params": [0, 1]}]})
    empty = ShardedOptimizer(params, [0] * 4, 1, lambda ps: torch.optim.AdamW(ps, lr=1e-2))
    assert empty.optimizer is None and empty.param_groups == [] and empty.state == {}
    empty.step()
    np.testing.assert_equal(empty.state_dict(), {"state": {}, "param_groups": []})


@pytest.mark.parametrize("flags", [dict(zero1=True), dict(zero2=True), dict(zero1=False)])
def test_one_rank_group_is_one_process_bit_for_bit(tmp_path, flags):
    """A process group of one (the smoke's NCCL world size 1): stage 1 with
    cross-device negatives and the gradient exchange gives the losses,
    gradient norms and parameters of a run without a group bit for bit (an
    all-gather over one rank is the tensor itself)."""
    import torch.distributed as dist

    state = llama.init_params(workers.tiny_config(), torch.Generator().manual_seed(0))
    runs = []
    for grouped in (False, True):
        if grouped:
            dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                    world_size=1, rank=0)
        try:
            history, final, trainer, _ = workers.run_stage(
                "stage1", state, str(tmp_path / "out"), 4, **flags)
            assert isinstance(trainer.optimizer, ShardedOptimizer) == (
                grouped and flags.get("zero1", True))
        finally:
            if grouped:
                dist.destroy_process_group()
        runs.append(([(h["loss"], h["grad_norm"]) for h in history], final))
    assert runs[0][0] == runs[1][0]
    for name, value in runs[0][1].items():
        assert torch.equal(runs[1][1][name], value), name
