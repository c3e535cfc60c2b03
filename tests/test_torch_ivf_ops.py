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


# ---- K5/K6 launch plan (ops/pq_adc.py adc_plan): pure integer arithmetic ----
# (Q, P, cap, m): the scale path (P 1) and the bf16 index's probe set (P
# 179) at cap 384, the served IVF64,PQ64 tier (Q 1 and 16, P 18, cap 128), m
# 8/24/120/256, caps off every tile (37, 333, 2049), Q above the SM count
PLAN_SHAPES = [(64, 1, 384, 64), (64, 179, 384, 64), (1, 18, 128, 64), (16, 18, 128, 64),
               (64, 8, 384, 64), (5, 3, 37, 8), (7, 4, 333, 256), (200, 1, 2049, 32),
               (9, 5, 37, 24), (3, 2, 64, 120), (1, 1, 16, 8), (300, 40, 128, 128)]


def _tiles(plan, p_n, cap):
    """Each tile's probed slots [v0, v1) of one query, as the kernel cuts
    them: route "tma" in boxes of ``tile`` slots of one cluster, route "ldg"
    in runs of ``tile`` consecutive probed slots."""
    if plan.route == "tma":
        return [(p * cap + lo, p * cap + min(cap, lo + plan.tile))
                for p in range(p_n) for lo in range(0, cap, plan.tile)]
    n = p_n * cap
    return [(lo, min(n, lo + plan.tile)) for lo in range(0, n, plan.tile)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("q_n,p_n,cap,m", PLAN_SHAPES)
def test_adc_plan_is_a_launch_the_kernel_takes(q_n, p_n, cap, m, aligned):
    """Route "tma" exactly where the codes are aligned and the table is
    resident; tiles that are multiples of 16 within the route's limit (a
    TMA box of at most 256 slots, a round of four boxes and more in 16 KB);
    1 to the tile count of blocks per query, at most two blocks per SM in
    all unless one per query; the shared memory of the kernel's launch
    check; tiles that cover every probed slot of a query once."""
    plan = pq_adc.adc_plan(q_n, p_n, cap, m, aligned=aligned)
    assert plan.route == ("tma" if aligned and m <= pq_adc.RESIDENT_M else "ldg")
    tiles = _tiles(plan, p_n, cap)
    assert plan.tile % 16 == 0 and 16 <= plan.tile
    if plan.route == "tma":
        assert plan.tile <= pq_adc.MAX_BOX and plan.tile >= cap / -(-cap // pq_adc.MAX_BOX)
        assert (pq_adc.MAX_TILE // plan.tile) * plan.tile * 16 <= pq_adc.CHUNK
        smem = 128 + (-(-m // 16) + (3 if m <= 64 else 4)) * pq_adc.CHUNK
    else:
        assert plan.tile <= pq_adc.MAX_TILE
        smem = 128 + (-(-m // 16) if m <= pq_adc.RESIDENT_M else pq_adc.RING) * pq_adc.CHUNK
    assert smem <= 232448
    assert 1 <= plan.blocks <= len(tiles)
    assert plan.blocks == 1 or q_n * plan.blocks <= 2 * pq_adc.SMS
    slots = [v for lo, hi in tiles for v in range(lo, hi)]
    assert slots == list(range(p_n * cap))


def test_adc_plan_fills_the_card_at_small_nprobe():
    """The scale path (Q 64, P 1: two 192-slot boxes per query, so 128
    blocks) and one served query (Q 1, P 18: a block per probe) spread over
    the SMs; the bf16 index's probe set (P 179) walks 90 tiles per block."""
    assert pq_adc.adc_plan(64, 1, 384, 64, aligned=True) == pq_adc.AdcPlan("tma", 192, 2)
    assert pq_adc.adc_plan(1, 18, 128, 64, aligned=True) == pq_adc.AdcPlan("tma", 128, 18)
    assert pq_adc.adc_plan(64, 179, 384, 64, aligned=True) == pq_adc.AdcPlan("tma", 192, 4)
    assert pq_adc.adc_plan(64, 179, 384, 64, aligned=False).route == "ldg"


@pytest.mark.parametrize("layout,m,cap,route", [("rows", 64, 384, "tma"), ("rows", 24, 384, "ldg"),
                                                ("cols", 24, 384, "tma"), ("cols", 64, 37, "ldg")])
def test_plan_for_reads_the_codes_pitch(layout, m, cap, route):
    """The route follows the codes' row pitch: m bytes for rows, K * cap for
    cols (K 6 here, so cap 37 gives an odd pitch)."""
    n_slots = K * cap
    codes = torch.zeros((n_slots, m) if layout == "rows" else (m, n_slots), dtype=torch.uint8)
    assert codes.data_ptr() % 16 == 0
    plan = pq_adc.plan_for(codes, torch.zeros(Q, P, dtype=torch.int32), cap, m)
    assert plan == pq_adc.adc_plan(Q, P, cap, m, aligned=route == "tma")
    assert plan.route == route
