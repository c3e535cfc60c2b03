"""Ring attention of the PyTorch port (``parallel/ring_attention.py``)
against the JAX package's ``context_parallel_attention`` on a 2-device
mesh of the test run's virtual CPU devices, and against the single-device
oracle (``tests/test_ring_attention.py``'s), with two CPU processes under
gloo as the ring (``torch_dist_workers.ring_worker``, joined with a
timeout of its own).

Tolerances are the JAX tests': values atol 2e-5, gradients atol 5e-4. The
flash ring runs the kernels' plain versions on CPU tensors, as the JAX
test runs the Pallas kernels in interpret mode.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rankpo_tpu.core.mesh import MeshConfig as JMeshConfig
from rankpo_tpu.core.mesh import make_mesh
from rankpo_tpu.parallel.ring_attention import context_parallel_attention as jcp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402


def _oracle(q, k, v, mask, causal):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hkv != hq:
        k = jnp.repeat(k, hq // hkv, axis=2)
        v = jnp.repeat(v, hq // hkv, axis=2)
    s_mat = jnp.einsum("bqhd,bkhd->bhqk", q, k) / (d**0.5)
    valid = (mask != 0)[:, None, None, :]
    if causal:
        pos = jnp.arange(s)
        valid = jnp.logical_and(valid, (pos[None, :] <= pos[:, None])[None, None])
    p = jax.nn.softmax(jnp.where(valid, s_mat, -1e30), axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v)


@functools.lru_cache(maxsize=None)
def _mesh2():
    return make_mesh(JMeshConfig(data_parallel=2), devices=jax.devices()[:2])


@functools.lru_cache(maxsize=None)
def _jring(causal, impl):
    """JAX's ring on the 2-device mesh, jitted once per (causal, impl)."""
    return jax.jit(lambda q, k, v, mask: jcp(q, k, v, mesh=_mesh2(), axis="data", mask=mask,
                                             causal=causal, impl=impl))


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    workers.spawn(workers.ring_worker, 2, out, timeout=180.0)
    return [workers.load(out, f"ring_{r}.pt") for r in range(2)]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,pad,hkv", workers.RING_GRID)
def test_ring_matches_jax_and_oracle(ring_run, causal, pad, hkv, impl):
    """Both ranks hold the whole output; it matches JAX's ring (same impl)
    and the oracle."""
    data = workers.ring_data(0 if pad != 13 else 4, hkv=hkv, pad=pad)
    q, k, v, mask = map(jnp.asarray, data)
    got = [r["values"][(causal, pad, hkv, impl)].numpy() for r in ring_run]
    np.testing.assert_array_equal(got[0], got[1])
    want = _jring(causal, impl)(q, k, v, mask)
    np.testing.assert_allclose(got[0], np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[0], np.asarray(_oracle(q, k, v, mask, causal)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl,causal", workers.RING_GRADS)
def test_ring_gradients_match_jax(ring_run, impl, causal):
    """Gradients of sum(out^2) against ``jax.grad`` of JAX's ring and of the
    oracle; (flash, non-causal) is the diagonal-step regression of the JAX
    test (its backward once masked the own shard causally)."""
    q, k, v, mask = map(jnp.asarray, workers.ring_data(5, pad=7, hkv=2))

    def loss_ring(q, k, v):
        o = _jring(causal, impl)(q, k, v, mask)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    def loss_full(q, k, v):
        return jnp.sum(_oracle(q, k, v, mask, causal) ** 2)

    g_ring = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
    g_full = jax.jit(jax.grad(loss_full, argnums=(0, 1, 2)))(q, k, v)
    for r in ring_run:
        for name, got, a, b in zip("qkv", r["grads"][(impl, causal)], g_ring, g_full):
            np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=5e-4, rtol=5e-4,
                                       err_msg=f"d{name} against JAX's ring")
            np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4,
                                       err_msg=f"d{name} against the oracle")


def test_ring_rejects_indivisible_sequence(ring_run):
    for r in ring_run:
        assert r["indivisible"] is not None and "not divisible" in r["indivisible"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_ring_never_makes_a_full_score_matrix(ring_run, impl):
    """At S 128 over two ranks no op, forward or backward, outputs a tensor
    with two dims of 128 (the [S, S] scores); the [64, 64] blocks exist."""
    for r in ring_run:
        shapes = r["shapes"][impl]
        assert not [s for s in shapes if list(s).count(128) >= 2], shapes
        assert any(list(s[-2:]) == [64, 64] for s in shapes)


def test_ring_of_one_is_the_kernel_bit_for_bit(ring_run):
    """A group of one rank runs the flash ring's merge over one step: the
    plain K1's output exactly."""
    assert all(r["solo_equal"] for r in ring_run)
