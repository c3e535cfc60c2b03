"""The plain versions of the IVF kernels against the JAX package's Pallas
kernels in interpret mode (the JAX package's own way to run them on the
CPU), on numpy inputs from a seed.

- K4 ``probe_scores``: the port's contract rounds the query to bf16 for bf16
  rows (the TPU kernel's DEFAULT precision); the interpret kernel does not.
  So bf16 rows are compared with bf16-valued queries, fp32 rows with fp32
  queries. Rows and queries are unit-norm, as the index stores them, so
  scores lie in [-1, 1]; tolerance 1e-5 absolute covers two fp32 summation
  orders over D <= 256 products.
- ``group_probes``, the index bookkeeping in front of the K4 kernel (pairs
  ordered by cluster, group starts, each group's cluster), against a numpy
  construction: exact integers.
- K5 / K6 ``pq_probe_scores`` / ``pq_probe_scores_t``: sums of m fp32 table
  entries of order 1, tolerance 1e-5 absolute (fp32 summation order). K6
  runs only at cap 128: its JAX tiling needs a multiple of 128.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankpo_tpu.ops.ivf_gather_pallas import probe_scores as jax_probe_scores
from rankpo_tpu.ops.pq_adc_pallas import pq_probe_scores as jax_pq
from rankpo_tpu.ops.pq_adc_pallas import pq_probe_scores_t as jax_pq_t
from rankpo_tpu_torch.ops import ivf_gather, pq_adc

torch.set_num_threads(2)

Q, P, K = 3, 4, 6
TOL = 1e-5


def _probe(rng):
    probe = rng.integers(0, K, (Q, P)).astype(np.int32)
    probe[0] = [0, 0, K - 1, K - 1]  # repeated and boundary cluster ids
    return probe


@pytest.mark.parametrize("cap", [16, 128])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_scores_plain_matches_jax_interpret(cap, d, dtype):
    rng = np.random.default_rng(cap * 1000 + d)
    corpus = rng.standard_normal((K * cap, d)).astype(np.float32)
    queries = rng.standard_normal((Q, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    probe = _probe(rng)
    jdt = getattr(jnp, dtype)
    jc = jnp.asarray(corpus).astype(jdt)
    jq = jnp.asarray(queries)
    if dtype == "bfloat16":  # bf16-valued queries: both contracts agree
        jq = jq.astype(jnp.bfloat16).astype(jnp.float32)
    jq_host = np.array(jq)
    ref = np.asarray(jax_probe_scores(jc, jnp.asarray(probe), jq, cap=cap,
                                      interpret=True))
    tc = torch.from_numpy(corpus).to(getattr(torch, dtype))
    got = ivf_gather.probe_scores(tc, torch.from_numpy(probe),
                                  torch.from_numpy(jq_host), cap=cap)
    assert got.dtype == torch.float32 and got.shape == (Q, P, cap)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # the plain version itself rounds an fp32 query for bf16 rows
    rounded = ivf_gather.probe_scores_plain(tc, torch.from_numpy(probe),
                                            torch.from_numpy(queries), cap=cap)
    np.testing.assert_allclose(rounded.numpy(), ref if dtype == "bfloat16" else got.numpy(),
                               atol=TOL, rtol=0)
    assert ivf_gather.launches["ivf_probe_scores"] == 0  # the CPU path


def _pq_inputs(cap, m, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (K * cap, m)).astype(np.uint8)
    codes[:cap // 2] = 255  # codes >= 128 exercise the unsigned read
    codes[cap // 2 : cap] = 128
    lut = rng.standard_normal((Q, m, 256)).astype(np.float32)
    return codes, _probe(rng), lut


@pytest.mark.parametrize("cap", [16, 128])
@pytest.mark.parametrize("m", [8, 32])
def test_pq_probe_scores_plain_matches_jax_interpret(cap, m):
    codes, probe, lut = _pq_inputs(cap, m, seed=cap + m)
    ref = np.asarray(jax_pq(jnp.asarray(codes), jnp.asarray(probe), jnp.asarray(lut),
                            cap=cap, interpret=True))
    got = pq_adc.pq_probe_scores(torch.from_numpy(codes), torch.from_numpy(probe),
                                 torch.from_numpy(lut), cap=cap)
    assert got.dtype == torch.float32 and got.shape == (Q, P, cap)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # int8 bits of the same codes read as unsigned (the JAX `& 255`)
    as_int8 = pq_adc.pq_probe_scores(torch.from_numpy(codes.view(np.int8)),
                                     torch.from_numpy(probe), torch.from_numpy(lut), cap=cap)
    assert torch.equal(as_int8, got)


@pytest.mark.parametrize("m", [8, 32])
def test_pq_probe_scores_t_plain_matches_jax_interpret(m):
    cap = 128
    codes, probe, lut = _pq_inputs(cap, m, seed=7 + m)
    codes_t = np.ascontiguousarray(codes.T)
    ref = np.asarray(jax_pq_t(jnp.asarray(codes_t), jnp.asarray(probe), jnp.asarray(lut),
                              cap=cap, interpret=True))
    got = pq_adc.pq_probe_scores_t(torch.from_numpy(codes_t), torch.from_numpy(probe),
                                   torch.from_numpy(lut), cap=cap)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    rows = pq_adc.pq_probe_scores(torch.from_numpy(codes), torch.from_numpy(probe),
                                  torch.from_numpy(lut), cap=cap)
    assert torch.equal(got, rows)  # one contract over both layouts
    assert pq_adc.launches == {"pq_adc_rows": 0, "pq_adc_cols": 0}


def test_wrappers_reject_bad_shapes():
    corpus = torch.zeros(6 * 16, 128)
    with pytest.raises(ValueError, match="cap"):
        ivf_gather.probe_scores(corpus, torch.zeros(3, 4, dtype=torch.int32),
                                torch.zeros(3, 128), cap=10)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ivf_gather.probe_scores(corpus.half(), torch.zeros(3, 4, dtype=torch.int32),
                                torch.zeros(3, 128), cap=16)
    codes = torch.zeros(6 * 16, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="lut"):
        pq_adc.pq_probe_scores(codes, torch.zeros(3, 4, dtype=torch.int32),
                               torch.zeros(3, 16, 256), cap=16)
    with pytest.raises(ValueError, match="uint8"):
        pq_adc.pq_probe_scores(codes.float(), torch.zeros(3, 4, dtype=torch.int32),
                               torch.zeros(3, 8, 256), cap=16)


# (Q, P, K, ids): Q * P above and below K, duplicate ids in one row, ids
# outside [0, K) (negative and >= K), Q 1 and P 1
GROUP_CASES = [(6, 5, 4, "valid"), (2, 3, 50, "valid"), (4, 6, 10, "duplicates"),
               (5, 4, 8, "outside"), (1, 7, 5, "outside"), (9, 1, 3, "valid"),
               (1, 1, 2, "outside"), (3, 4, 2, "duplicates")]


def _group_probe(q_n, p_n, k, ids, seed):
    rng = np.random.default_rng(seed)
    probe = rng.integers(0, k, (q_n, p_n))
    if ids == "duplicates":
        probe[0, :] = probe[0, 0]  # one query lists one cluster P times
    if ids == "outside":
        probe.flat[:: 2] = rng.choice([-7, -1, k, k + 5], size=probe.flat[:: 2].shape)
    return probe.astype(np.int32)


@pytest.mark.parametrize("q_n,p_n,k,ids", GROUP_CASES)
def test_group_probes_matches_numpy(q_n, p_n, k, ids):
    probe = _group_probe(q_n, p_n, k, ids, seed=q_n * 100 + p_n * 10 + k)
    pairs, start, cluster = ivf_gather.group_probes(torch.from_numpy(probe), k)
    n = probe.size
    key = np.where((probe >= 0) & (probe < k), probe, k).ravel()
    order = np.argsort(key, kind="stable")
    ids_sorted, first = np.unique(key[order], return_index=True)
    g_max = min(n, k + 1)
    want_start = np.full(g_max + 1, n)
    want_start[: len(first)] = first
    assert pairs.dtype == start.dtype == cluster.dtype == torch.int32
    assert cluster.shape == (g_max,)
    np.testing.assert_array_equal(pairs.numpy(), order)
    np.testing.assert_array_equal(start.numpy(), want_start)
    np.testing.assert_array_equal(cluster.numpy()[: len(first)], ids_sorted)


@pytest.mark.parametrize("q_n,p_n,k,ids", GROUP_CASES)
def test_group_probes_scattered_back_rebuild_probe(q_n, p_n, k, ids):
    """Every pair appears once; each pair's group cluster, written back at
    its (query, probe) place, rebuilds ``probe`` exactly, with every id
    outside [0, K) read as K."""
    probe = _group_probe(q_n, p_n, k, ids, seed=q_n + p_n + k)
    pairs, start, cluster = (x.numpy() for x in ivf_gather.group_probes(
        torch.from_numpy(probe), k))
    n = probe.size
    assert np.array_equal(np.sort(pairs), np.arange(n))
    assert start[0] == 0 and np.all(np.diff(start) >= 0) and start[-1] == n
    rebuilt = np.full(n, -100, dtype=np.int64)
    for g in range(len(cluster)):
        rebuilt[pairs[start[g] : start[g + 1]]] = cluster[g]
    want = np.where((probe >= 0) & (probe < k), probe, k).ravel()
    np.testing.assert_array_equal(rebuilt, want)
    # one group per distinct id, in ascending id order
    sizes = np.diff(start)
    assert np.all(np.diff(cluster[sizes > 0]) > 0)
    assert (sizes > 0).sum() == len(np.unique(want))
