"""The port's losses (rankpo_tpu_torch.losses) against the JAX package.

Every loss, its metrics and its gradient, on the same fp32 inputs made with
numpy. Tolerances: values within 1e-5 relative (fp32 log-sum-exp and
log-sigmoid in two frameworks), gradients within 1e-5 absolute (inputs of
order 1, temperatures >= 0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu.losses import contrastive as jc
from rankpo_tpu.losses import rankpo as jr
from rankpo_tpu_torch.losses import contrastive as pc
from rankpo_tpu_torch.losses import rankpo as pr

torch.set_num_threads(2)

RTOL = 1e-5
GRAD_ATOL = 1e-5


def _reps(b=4, g=3, h=16, seed=0, normalize=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h), dtype=np.float32)
    p = rng.standard_normal((b * g, h), dtype=np.float32)
    if normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        p /= np.linalg.norm(p, axis=1, keepdims=True)
    return q, p


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_similarity_scores():
    q, p = _reps()
    _close(pc.similarity_scores(torch.from_numpy(q), torch.from_numpy(p)).numpy(),
           jc.similarity_scores(jnp.asarray(q), jnp.asarray(p)), atol=1e-6)


@pytest.mark.parametrize("inbatch", [True, False])
@pytest.mark.parametrize("row_valid", [None, [1, 1, 0, 1]])
def test_info_nce_loss_and_grad(inbatch, row_valid):
    q, p = _reps()
    rv_j = None if row_valid is None else jnp.asarray(row_valid, jnp.float32)
    rv_t = None if row_valid is None else torch.tensor(row_valid, dtype=torch.float32)

    def jloss(q_, p_):
        return jc.info_nce_loss(q_, p_, temperature=0.05, use_inbatch_neg=inbatch,
                                row_valid=rv_j)[0]

    (jl, jscores) = jc.info_nce_loss(jnp.asarray(q), jnp.asarray(p), temperature=0.05,
                                     use_inbatch_neg=inbatch, row_valid=rv_j)
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    qt = torch.from_numpy(q).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    tl, tscores = pc.info_nce_loss(qt, pt, temperature=0.05, use_inbatch_neg=inbatch,
                                   row_valid=rv_t)
    tl.backward()
    _close(tl.item(), float(jl))
    np.testing.assert_array_equal(np.isinf(tscores.detach().numpy()), np.isinf(np.asarray(jscores)))
    finite = np.isfinite(np.asarray(jscores))
    _close(tscores.detach().numpy()[finite], np.asarray(jscores)[finite], atol=1e-4)
    _close(qt.grad.numpy(), jg[0], rtol=0, atol=GRAD_ATOL)
    _close(pt.grad.numpy(), jg[1], rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("row_valid", [None, [1, 0, 1, 1]])
def test_info_nce_block_loss_and_grad(row_valid):
    q, p = _reps()
    rv_j = None if row_valid is None else jnp.asarray(row_valid, jnp.float32)
    rv_t = None if row_valid is None else torch.tensor(row_valid, dtype=torch.float32)

    def jloss(q_, p_):
        return jc.info_nce_block_loss(q_, p_, num_blocks=2, temperature=0.05,
                                      row_valid=rv_j)[0]

    jl = jloss(jnp.asarray(q), jnp.asarray(p))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    qt = torch.from_numpy(q).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    tl, scores = pc.info_nce_block_loss(qt, pt, num_blocks=2, temperature=0.05,
                                        row_valid=rv_t)
    tl.backward()
    assert scores.shape == (4, 6)
    _close(tl.item(), float(jl))
    _close(qt.grad.numpy(), jg[0], rtol=0, atol=GRAD_ATOL)
    _close(pt.grad.numpy(), jg[1], rtol=0, atol=GRAD_ATOL)


def test_one_block_equals_global_loss():
    q, p = _reps()
    a, _ = pc.info_nce_loss(torch.from_numpy(q), torch.from_numpy(p), temperature=0.1)
    b, _ = pc.info_nce_block_loss(torch.from_numpy(q), torch.from_numpy(p),
                                  num_blocks=1, temperature=0.1)
    _close(a.item(), b.item(), rtol=1e-6)


def test_cross_device_axis_raises_on_one_card(tmp_path):
    """Cross-device negatives are ported (two ranks:
    ``test_torch_distributed.py``). On one card without a process group
    ``axis_name`` raises, naming the bring-up; in a one-process gloo group
    it pools the one rank's passages: the global loss and gradients bit for
    bit, and JAX's within the module's tolerances."""
    import torch.distributed as dist

    q, p = _reps()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pc.info_nce_loss(torch.from_numpy(q), torch.from_numpy(p), axis_name="data")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        got = []
        for axis in (None, "data"):
            tq = torch.from_numpy(q).requires_grad_(True)
            tp = torch.from_numpy(p).requires_grad_(True)
            loss, scores = pc.info_nce_loss(tq, tp, temperature=0.05, axis_name=axis)
            loss.backward()
            got.append((loss.detach(), scores.detach(), tq.grad, tp.grad))
        with pytest.raises(ValueError, match="only axis"):
            pc.info_nce_loss(torch.from_numpy(q), torch.from_numpy(p), axis_name="model")
    finally:
        dist.destroy_process_group()
    for a, b in zip(*got):
        assert torch.equal(a, b)
    jl, jg = jax.value_and_grad(lambda a, b: jc.info_nce_loss(a, b, temperature=0.05)[0],
                                argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    _close(got[1][0], jl)
    _close(got[1][2], jg[0], rtol=0, atol=GRAD_ATOL)
    _close(got[1][3], jg[1], rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("normalize,temperature", [(True, 0.02), (False, 0.02),
                                                   (True, 0.5), (False, 0.9)])
def test_validate_temperature(normalize, temperature):
    assert pc.validate_temperature(normalize, temperature) == jc.validate_temperature(
        normalize, temperature)


def test_validate_temperature_rejects_hot_cosine():
    for fn in (pc.validate_temperature, jc.validate_temperature):
        with pytest.raises(ValueError, match="temperature"):
            fn(True, 0.7)


def _scores(b=6, seed=3):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (b, 2)).astype(np.float32)
    ref = rng.uniform(-1, 1, (b, 2)).astype(np.float32)
    return s, ref


@pytest.mark.parametrize("loss_type,ls,gamma,with_ref", [
    ("sigmoid", 0.0, 0.0, False), ("sigmoid", 0.1, 0.5, True),
    ("hinge", 0.0, 0.3, False), ("hinge", 0.0, 0.0, True),
])
def test_rankpo_loss_and_grad(loss_type, ls, gamma, with_ref):
    s, ref = _scores()
    kw = dict(beta=2.0, gamma_beta_ratio=gamma, temperature=0.1, loss_type=loss_type,
              label_smoothing=ls)

    def jfn(s_):
        args = (s_[:, 0], s_[:, 1]) + ((jnp.asarray(ref[:, 0]), jnp.asarray(ref[:, 1]))
                                       if with_ref else (None, None))
        return jr.rankpo_loss(*args, **kw)

    jl = jfn(jnp.asarray(s))
    jg = jax.grad(lambda s_: jnp.sum(jfn(s_)))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    args = (st[:, 0], st[:, 1]) + ((torch.from_numpy(ref[:, 0]), torch.from_numpy(ref[:, 1]))
                                   if with_ref else (None, None))
    tl = pr.rankpo_loss(*args, **kw)
    tl.sum().backward()
    _close(tl.detach().numpy(), jl, atol=1e-6)
    _close(st.grad.numpy(), jg, rtol=0, atol=GRAD_ATOL)


def test_rankpo_loss_unknown_type():
    s, _ = _scores()
    with pytest.raises(ValueError, match="loss_type"):
        pr.rankpo_loss(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]), loss_type="ipo")


@pytest.mark.parametrize("row_valid", [None, [1, 1, 0, 1, 0, 1]])
def test_sft_loss_and_masked_mean(row_valid):
    s, _ = _scores()
    rv_j = None if row_valid is None else jnp.asarray(row_valid, jnp.float32)
    rv_t = None if row_valid is None else torch.tensor(row_valid, dtype=torch.float32)
    _close(pr.sft_loss(torch.from_numpy(s), 0.05, rv_t).item(),
           float(jr.sft_loss(jnp.asarray(s), 0.05, rv_j)))
    _close(pr._masked_mean(torch.from_numpy(s[:, 0]), rv_t).item(),
           float(jr._masked_mean(jnp.asarray(s[:, 0]), rv_j)), atol=1e-7)


@pytest.mark.parametrize("with_ref,sft_weight,row_valid", [
    (False, 0.0, None), (True, 0.5, None), (True, 0.5, [1, 0, 1, 1, 1, 0]),
])
def test_rankpo_batch_loss_metrics_and_grad(with_ref, sft_weight, row_valid):
    s, ref = _scores()
    rv_j = None if row_valid is None else jnp.asarray(row_valid, jnp.float32)
    rv_t = None if row_valid is None else torch.tensor(row_valid, dtype=torch.float32)
    kw = dict(beta=2.0, gamma_beta_ratio=0.2, temperature=0.1, loss_type="sigmoid",
              label_smoothing=0.05, rankpo_weight=1.0, sft_weight=sft_weight)

    def jfn(s_):
        return jr.rankpo_batch_loss(s_, jnp.asarray(ref) if with_ref else None,
                                    row_valid=rv_j, **kw)

    jl, jm = jfn(jnp.asarray(s))
    jg = jax.grad(lambda s_: jfn(s_)[0])(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    tl, tm = pr.rankpo_batch_loss(st, torch.from_numpy(ref) if with_ref else None,
                                  row_valid=rv_t, **kw)
    tl.backward()
    _close(tl.item(), float(jl))
    assert list(tm) == list(jm)
    for key in jm:
        _close(tm[key].item(), float(jm[key]), atol=1e-6)
    _close(st.grad.numpy(), jg, rtol=0, atol=GRAD_ATOL)
