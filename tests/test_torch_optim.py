"""The port's 8-bit AdamW and Adafactor against the JAX package's
optimizers on the same gradients (numpy, from a seed).

- ``AdamW8bit`` against ``rankpo_tpu.train.optim8bit.adamw8bit`` over 5
  steps, on a leaf smaller than one block and one whose size is not a
  multiple of 256: the int8/uint8 codes bit-equal in at least 99.9% of the
  entries and every other code within +-1, the block scales within two
  fp32 ulps (rtol 2.4e-7), the parameters within atol 5e-6. The port
  dequantizes through a table of 2^level rounded once and codes through
  fp32 thresholds (the same bits on any device); XLA's CPU ``exp2`` and
  ``log2`` round differently (107 of the 128 first-moment factors differ in
  the last bit), so a moment, and its block's largest magnitude, can
  differ by an ulp, and a value on a code boundary can take the
  neighbouring code (all codes matched on the seeds tried; 3 in a million
  on random values);
- ``Adafactor`` against ``optax.adafactor`` with the JAX package's
  arguments (``rankpo_tpu/train/state.py:135-144``) on factored (>= 128 x
  >= 128) and unfactored shapes, weight decay on and off: parameters atol
  5e-6 at lr 1e-3 (the trainer trace's), second-moment statistics rtol
  1e-5, the bf16 momentum within one bf16 ulp (the fp32 update it rounds
  may differ in its last bits: XLA's and PyTorch's means sum in other
  orders, and a flipped rounding moves a parameter by lr x 2^-8 of its
  update);
- ``tests/test_torch_train.py``'s 4-step trainer trace for each optimizer
  (the 8-bit one at its tolerances for two steps; see the test);
- the state's dtypes through ``state_dict`` / ``load_state_dict`` and the
  8-bit state's size.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rankpo_tpu.train.optim8bit import adamw8bit
from rankpo_tpu_torch.train.adafactor import Adafactor
from rankpo_tpu_torch.train.optim8bit import AdamW8bit
from test_torch_train import _trace, assert_trace_matches

torch.set_num_threads(2)

STEPS = 5


def _grads(shapes, seed):
    rng = np.random.default_rng(seed)
    # magnitudes spread over octaves, so the log codes use their range
    return [{k: (rng.standard_normal(s) * np.exp(rng.uniform(-6, 2, s))).astype(np.float32)
             for k, s in shapes.items()} for _ in range(STEPS)]


def _run_jax(tx, params, grads):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    states = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        states.append(state)
    return {k: np.asarray(v) for k, v in jp.items()}, states


def _run_port(opt_cls, params, grads, **kw):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = opt_cls(list(tp.values()), **kw)
    states = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        states.append({k: {n: (v.clone() if torch.is_tensor(v) else v)
                           for n, v in opt.state[p].items()} for k, p in tp.items()})
    return {k: p.detach().numpy() for k, p in tp.items()}, states, opt


SHAPES_8BIT = {"w": (10, 300), "b": (7,)}  # 3000 = 11 blocks + 184; 7 < one block


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw8bit_matches_jax(weight_decay):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES_8BIT.items()}
    grads = _grads(SHAPES_8BIT, 1)
    jp, jstates = _run_jax(adamw8bit(1e-3, weight_decay=weight_decay), params, grads)
    pp, pstates, _ = _run_port(AdamW8bit, params, grads, lr=1e-3, weight_decay=weight_decay)
    n_codes = n_equal = 0
    for js, ps in zip(jstates, pstates):
        inner = js[0]  # chain(scale_by_adam8bit, add_decayed_weights, scale)
        assert int(inner.count) == ps["w"]["step"]
        for k in SHAPES_8BIT:
            for field in ("mu_q", "nu_q"):
                want = np.asarray(getattr(inner, field)[k])
                got = ps[k][field].numpy()
                assert got.dtype == want.dtype and got.shape == want.shape
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (k, field)
                n_codes += diff.size
                n_equal += int((diff == 0).sum())
            for field in ("mu_scale", "nu_scale"):
                np.testing.assert_allclose(ps[k][field].numpy(),
                                           np.asarray(getattr(inner, field)[k]),
                                           rtol=2.4e-7, atol=0, err_msg=f"{k} {field}")
    assert n_equal / n_codes >= 0.999, n_equal / n_codes
    for k in SHAPES_8BIT:
        np.testing.assert_allclose(pp[k], jp[k], atol=5e-6, rtol=0, err_msg=k)


def test_adamw8bit_state_is_a_quarter_and_keeps_its_dtypes():
    p = torch.nn.Parameter(torch.zeros(1024, 1024))
    opt = AdamW8bit([p], lr=1e-3)
    p.grad = torch.randn_like(p)
    opt.step()
    state = opt.state[p]
    assert state["mu_q"].shape == (4096, 256) and state["mu_q"].dtype == torch.int8
    assert state["nu_q"].dtype == torch.uint8 and state["mu_scale"].shape == (4096,)
    moment_bytes = sum(t.numel() * t.element_size() for t in state.values() if torch.is_tensor(t))
    assert moment_bytes < 2 * p.numel() * 4 * 0.27
    again = AdamW8bit([p], lr=1e-3)
    again.load_state_dict(opt.state_dict())
    for key, value in opt.state[p].items():
        if torch.is_tensor(value):
            assert again.state[p][key].dtype == value.dtype
            assert torch.equal(again.state[p][key], value), key


SHAPES_ADAFACTOR = {"factored": (130, 256), "wide": (3, 200), "vector": (7,)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adafactor_matches_optax(weight_decay):
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES_ADAFACTOR.items()}
    grads = _grads(SHAPES_ADAFACTOR, 3)
    tx = optax.adafactor(learning_rate=1e-3, momentum=0.9, dtype_momentum=jnp.bfloat16,
                         weight_decay_rate=weight_decay or None,
                         multiply_by_parameter_scale=False, clipping_threshold=None)
    jp, jstates = _run_jax(tx, params, grads)
    pp, pstates, _ = _run_port(Adafactor, params, grads, lr=1e-3, momentum=0.9,
                               weight_decay=weight_decay or None)
    assert "v_row" in pstates[0]["factored"] and "v" in pstates[0]["wide"]
    for js, ps in zip(jstates, pstates):
        factored, ema = js[0], js[2]  # factored rms, lr, ema, [decay], sign
        for k in SHAPES_ADAFACTOR:
            for field in ("v_row", "v_col", "v"):
                if field in ps[k]:
                    np.testing.assert_allclose(ps[k][field].numpy(),
                                               np.asarray(getattr(factored, field)[k]),
                                               rtol=1e-5, err_msg=f"{k} {field}")
            want = np.asarray(ema.ema[k]).astype(np.float32)
            got = ps[k]["momentum"].float().numpy()
            ulp = np.abs(want) * 2.0 ** -7
            assert np.all(np.abs(got - want) <= ulp), k
    for k in SHAPES_ADAFACTOR:
        np.testing.assert_allclose(pp[k], jp[k], atol=5e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("optim", ["adamw8bit", "adafactor"])
@pytest.mark.parametrize("stage", ["contrastive", "rankpo"])
def test_trainer_trace_matches_jax_per_optimizer(stage, optim):
    jhist, phist, jstate, pstate = _trace(stage, 2, optim=optim)
    if optim == "adafactor":
        assert_trace_matches(jhist, phist, jstate, pstate)
        return
    # 8-bit: the first update uses the unquantized moments, so steps 1-2
    # hold the trace's tolerances. The two trainers' gradients differ by
    # fp32 rounding (~1e-7), and a moment that sits on a code boundary
    # rounds to the neighbouring code under such a difference: its
    # dequantized value moves by 2^(20/126) - 1 = 11.6% (first moment), and
    # that coordinate's later updates by as much of lr. Measured on these
    # inputs: losses 8e-5 to 1.5e-3 apart at steps 3-4, parameters 2.3e-4
    # (a quarter of one lr step).
    assert_trace_matches(jhist[:2], phist[:2], {}, {}, steps=2)
    for j, p in zip(jhist[2:], phist[2:]):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=3e-3)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-3)
    for name, ref in jstate.items():
        np.testing.assert_allclose(pstate[name].numpy(), ref.numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)
