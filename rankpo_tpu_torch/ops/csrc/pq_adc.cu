// Fused PQ asymmetric-distance scores (ADC) for the IVF-PQ search path on
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of rankpo_tpu/ops/pq_adc_pallas.py:
//   _kernel   (pq_probe_scores,   codes in rows    [K * cap, m]) -> layout 0
//   _kernel_t (pq_probe_scores_t, codes transposed [m, K * cap]) -> layout 1
// Their mxu=True and via_transpose switches only choose how Mosaic orients
// the one-hot mask and reduce on the TPU; they have no counterpart here.
//
// Contract (the same for both layouts):
//   probe [Q, P] int32 cluster ids; lut [Q, m, 256] fp32 per-query tables;
//   out [Q, P, cap] fp32 with
//     out[q, p, c] = sum_{j < m} lut[q, j, code(probe[q, p] * cap + c, j)]
//   summed in fp32 in order j = 0, 1, ..., m - 1, where code(s, j) is
//   codes[s, j] (rows) or codes_t[j, s] (cols), read as unsigned bytes (the
//   JAX kernels' `& 255`). m is any multiple of 8, cap any positive size. A
//   probe id outside [0, K) writes NaN over its [cap] scores instead of
//   reading out of bounds.
//
// What bounds it on this card. Each probed slot costs m table lookups in
// shared memory and m adds, and each (query, probe) pair reads its cluster's
// codes: at the bf16 index's probe set (Q 64, P 179, cap 384, m 64) that is
// 282 M lookups and 282 MB of code reads, of which 116 MB are distinct (the
// byte bound, 0.035 ms). On an H100 the lookups alone take 0.10-0.14 ms (a
// warp's 32 lookups of one subspace hit random banks: ~2 distinct words on
// the busiest bank for the index's codes, ~3 for uniform random ones) and
// the code reads alone 0.11-0.13 ms (scripts/pq_adc_compare.py --split), so
// the design's aim is to keep both going at once. At small P (P 1: 1.6 M
// lookups) the query tables (64 KB each) and the launch are the cost. The
// design:
//   - the query's table arrives by TMA: 1-D bulk copies of 16 subspaces
//     (16 KB), each on its own mbarrier, so lookups on a chunk overlap the
//     arrival of the next. For m <= 128 the whole table stays resident and is
//     loaded once per block however many tiles the block walks; for m > 128
//     (route "ldg" only) the chunks stream through a ring of 4 stages, once
//     per tile;
//   - the wrapper sizes the work per block from Q, P, cap and m (ops/pq_adc.py
//     adc_plan): a query's tiles are split among `blocks` blocks, so that P 1
//     and a single served query still cover the 132 SMs and a large P walks
//     many tiles per block with the table loaded once;
//   - route "tma" (codes 16-byte aligned; rows with m % 16 == 0, cols with
//     K * cap % 16 == 0; m <= 128): a tile is `tile` (<= 256) slots of one
//     probed cluster, and a block takes several tiles at a time (a round of
//     up to 1024 slots, up to 4 per thread). One producer warp issues, for
//     each step of a round, one 2-D TMA box per tile into a 3-stage ring
//     (two blocks share an SM at m 64): cols, 16 subspace rows of the tile's
//     slots ([16][tile] bytes, 4 slots' codes per 4-byte load); rows, 32 code
//     bytes of each slot (whole 32-byte L2 sectors; 16 where m % 32 != 0),
//     read 16 codes per 16-byte load. The 8 consumer warps score a stage and
//     release it on its own mbarrier, so the producer refills it while they
//     score the next: no block-wide barrier per step;
//   - route "ldg" (any other shape the contract admits: unaligned codes, m
//     not a multiple of 16 in rows, K * cap not a multiple of 16 in cols,
//     m > 128) reads the codes from global memory as the first design did:
//     tiles of up to 1024 consecutive probed slots, 8 bytes per load in rows,
//     one byte per lookup in cols;
//   - every slot's sum starts at 0 and adds its m entries in order
//     j = 0 .. m - 1 on both routes, so scores are bit-equal to the first
//     design's on any launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kAdcThreads = 256;
constexpr int kMaxSlots = 4;                       // slots per thread
constexpr int kMaxTile = kAdcThreads * kMaxSlots;  // 1024 slots: a round (tma), a tile (ldg)
constexpr int kMaxBox = 256;                       // route "tma": slots per tile (TMA box)
constexpr int kPqK = 256;                          // entries per subspace table (8-bit codes)
constexpr int kMChunk = 16;                        // subspaces per table chunk and code box
constexpr int kChunkFloats = kMChunk * kPqK;       // 16 KB
constexpr int kResidentM = 128;                    // m <= 128: the table stays resident
constexpr int kResidentChunks = kResidentM / kMChunk;
constexpr int kRing = 4;                           // ldg, m > 128: table chunks in flight
constexpr int kStageBytes = kMaxTile * kMChunk;    // tma: one round's codes of one step
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 128;                     // barriers at the front of shared memory
static_assert((kResidentChunks + 2 * kMaxStages) * 8 <= kBarBytes, "barriers");

struct AdcArgs {
  const uint8_t* codes;
  const int* probe;
  const float* lut;
  float* out;
  long long n_slots;  // K * cap
  int n_clusters, P, cap, m;
  int tile;     // slots per tile
  int n_tiles;  // tiles of one query
  int stages;   // tma: ring stages of codes
};

__device__ __forceinline__ uint32_t chunk_bytes(int c, int m) {
  return (uint32_t)min(kMChunk, m - c * kMChunk) * kPqK * 4;
}

// a + the table entries of four consecutive subspaces (t: the first one's
// table) at the four code bytes of w, in subspace order
__device__ __forceinline__ float add4(float a, const float* t, uint32_t w) {
  a += t[w & 255u];
  a += t[kPqK + ((w >> 8) & 255u)];
  a += t[2 * kPqK + ((w >> 16) & 255u)];
  a += t[3 * kPqK + (w >> 24)];
  return a;
}

// acc[i] + the entries of N subspaces (t: the first one's table) at the
// codes of four consecutive slots: byte i of the 4-byte word at
// codes + jj * pitch for subspace jj
template <int N>
__device__ __forceinline__ void cols_chunk(float (&acc)[kMaxSlots], const uint8_t* codes,
                                           int pitch, const float* t) {
#pragma unroll
  for (int jj = 0; jj < N; ++jj) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + jj * pitch);
    const float* tj = t + jj * kPqK;
    acc[0] += tj[w & 255u];
    acc[1] += tj[(w >> 8) & 255u];
    acc[2] += tj[(w >> 16) & 255u];
    acc[3] += tj[w >> 24];
  }
}

// route "tma", rows: code bytes of a slot per step. 32 (two table chunks)
// where m allows, so that a box row is a whole 32-byte sector of L2; 16
// otherwise.
__host__ __device__ __forceinline__ int row_step(int m) { return m % 32 == 0 ? 32 : 16; }

// this block's share [t_begin, t_begin + n_my) of the query's n_tiles tiles
__device__ __forceinline__ void block_tiles(int n_tiles, int& t_begin, int& n_my) {
  t_begin = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  n_my = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x) - t_begin;
}

// ---- route "tma" ----
// One block per (query, share of its tiles): blockIdx.y is the query; 8
// consumer warps and one producer warp. map:
// rows, [K * cap] x [m] bytes with boxes of row_step(m) x tile; cols,
// [m] x [K * cap] with boxes of tile x 16.
template <bool kCols>
__global__ void __launch_bounds__(kAdcThreads + 32, 2)
pq_adc_tma_kernel(const __grid_constant__ CUtensorMap map, const AdcArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* tab_bar = reinterpret_cast<uint64_t*>(smem);  // [kResidentChunks]
  uint64_t* full = tab_bar + kResidentChunks;             // [kMaxStages] codes arrived
  uint64_t* empty = full + kMaxStages;                    // [kMaxStages] codes read
  const int n_ch = (a.m + kMChunk - 1) / kMChunk;
  float* tab = reinterpret_cast<float*>(smem + kBarBytes);
  uint8_t* ring = smem + kBarBytes + n_ch * kChunkFloats * 4;
  const int bw = a.tile, tp = (a.cap + bw - 1) / bw;  // tiles per probe
  // a step brings, for each tile of a round, 16 subspaces (cols) or rb code
  // bytes of every slot (rows); a stage holds a round's step
  const int rb = kCols ? kMChunk : row_step(a.m), n_st = kCols ? n_ch : a.m / rb;
  const int per_round = min(kMaxTile, kStageBytes / rb) / bw, box = bw * rb, S = a.stages;
  const int q = blockIdx.y, tid = threadIdx.x;
  const int* probe_q = a.probe + (long long)q * a.P;
  int t_begin, n_my;
  block_tiles(a.n_tiles, t_begin, n_my);
  const int rounds = (n_my + per_round - 1) / per_round;
  const int steps = rounds * n_st;  // (round, step of the round) pairs

  if (tid == 0) {
    for (int i = 0; i < kResidentChunks + kMaxStages; ++i) mbar_init(&tab_bar[i], 1);
    for (int i = 0; i < kMaxStages; ++i) mbar_init(&empty[i], kAdcThreads / 32);
    fence_barrier_init();
  }
  __syncthreads();
  if (n_my == 0) return;

  // the producer: the last warp's lane 0 loads the table, then keeps the
  // ring full, refilling a stage once the 8 consumer warps have read it
  const CUtensorMap* codes_map = &map;
  auto issue = [&](int k) {  // the boxes of step k (step k % n_st of round
                             // k / n_st) into stage k % S; tiles under an id
                             // outside [0, K) are skipped
    const int rr = k / n_st, c = k % n_st;
    const int u_n = min(per_round, n_my - rr * per_round);
    uint64_t* bar = &full[k % S];
    uint8_t* dst = ring + (k % S) * kStageBytes;
    int n_valid = 0;
    for (int u = 0; u < u_n; ++u) {
      const int cl = probe_q[(t_begin + rr * per_round + u) / tp];
      n_valid += cl >= 0 && cl < a.n_clusters;
    }
    mbar_arrive_expect_tx(bar, (uint32_t)(n_valid * box));
    for (int u = 0; u < u_n; ++u) {
      const int t = t_begin + rr * per_round + u, p = t / tp;
      const int cl = probe_q[p];
      if (cl < 0 || cl >= a.n_clusters) continue;
      const int s0 = cl * a.cap + (t - p * tp) * bw;
      if (kCols) {
        tma_load_2d(dst + u * box, codes_map, bar, s0, c * kMChunk);
      } else {
        tma_load_2d(dst + u * box, codes_map, bar, c * rb, s0);
      }
    }
  };
  if (tid >= kAdcThreads) {
    if (tid == kAdcThreads) {
      const float* lut_q = a.lut + (long long)q * a.m * kPqK;
      for (int c = 0; c < n_ch; ++c) {
        mbar_arrive_expect_tx(&tab_bar[c], chunk_bytes(c, a.m));
        bulk_load(tab + c * kChunkFloats, lut_q + c * kChunkFloats, chunk_bytes(c, a.m),
                  &tab_bar[c]);
      }
      for (int k = 0; k < steps; ++k) {
        if (k >= S) mbar_wait(&empty[k % S], (k / S - 1) & 1);
        issue(k);
      }
    }
    return;
  }

  for (int rr = 0; rr < rounds; ++rr) {
    const int u_n = min(per_round, n_my - rr * per_round);
    // this thread's slots of the round: rows, round slots tid + 256 i
    // (rb bytes each in a stage); cols, round slots 4 tid .. 4 tid + 3 (one
    // 4-byte word of each of a stage's 16 rows of the tile)
    long long dst[kMaxSlots];
    bool live[kMaxSlots], valid[kMaxSlots];
    int off[kMaxSlots];
    float acc[kMaxSlots];
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      const int s = kCols ? 4 * tid + i : tid + i * kAdcThreads;
      const int u = s / bw, col = s - u * bw;
      const int t = t_begin + rr * per_round + u, p = t / tp, sub = t - p * tp;
      live[i] = u < u_n && sub * bw + col < a.cap;
      const int cl = live[i] ? probe_q[p] : 0;
      valid[i] = cl >= 0 && cl < a.n_clusters;
      dst[i] = ((long long)q * a.P + p) * a.cap + sub * bw + col;
      off[i] = kCols ? u * box + col : s * rb;
      acc[i] = 0.f;
    }
    for (int c = 0; c < n_st; ++c) {
      const int k = rr * n_st + c;
      mbar_wait(&full[k % S], (k / S) & 1);
      const uint8_t* st = ring + (k % S) * kStageBytes;
      if (kCols) {
        const float* t = tab + c * kChunkFloats;
        if (rr == 0) mbar_wait(&tab_bar[c], 0);
        if (live[0] && a.m - c * kMChunk >= kMChunk) {
          cols_chunk<kMChunk>(acc, st + off[0], bw, t);
        } else if (live[0]) {  // the last 8 subspaces of an m % 16 == 8
          cols_chunk<kMChunk / 2>(acc, st + off[0], bw, t);
        }
      } else {  // m % 16 == 0: 16 codes per 16-byte load, one table chunk each
        for (int h = 0; h < rb / kMChunk; ++h) {
          const int ch = c * (rb / kMChunk) + h;
          if (rr == 0) mbar_wait(&tab_bar[ch], 0);
          const float* t = tab + ch * kChunkFloats;
          uint4 raw[kMaxSlots];
#pragma unroll
          for (int i = 0; i < kMaxSlots; ++i) {
            if (live[i]) raw[i] = *reinterpret_cast<const uint4*>(st + off[i] + h * kMChunk);
          }
#pragma unroll
          for (int i = 0; i < kMaxSlots; ++i) {
            if (!live[i]) continue;
            float s = acc[i];
            s = add4(s, t, raw[i].x);
            s = add4(s, t + 4 * kPqK, raw[i].y);
            s = add4(s, t + 8 * kPqK, raw[i].z);
            s = add4(s, t + 12 * kPqK, raw[i].w);
            acc[i] = s;
          }
        }
      }
      __syncwarp();  // the warp is done with this stage
      if ((tid & 31) == 0) mbar_arrive(&empty[k % S]);
    }
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      if (live[i]) a.out[dst[i]] = valid[i] ? acc[i] : nanf("");
    }
  }
}

// ---- route "ldg" ----
// One block per (query, share of its tiles); a tile is `tile` (<= 1024)
// consecutive slots of the query's P * cap probed slots, slot tid + 256 i
// per thread. The codes are read from global memory.
template <bool kCols>
__global__ void __launch_bounds__(kAdcThreads, 2)
pq_adc_ldg_kernel(const AdcArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* tab_bar = reinterpret_cast<uint64_t*>(smem);  // [kResidentChunks]
  float* tab = reinterpret_cast<float*>(smem + kBarBytes);
  const int n_ch = (a.m + kMChunk - 1) / kMChunk;
  const bool resident = a.m <= kResidentM;
  const int q = blockIdx.y, tid = threadIdx.x;
  const float* lut_q = a.lut + (long long)q * a.m * kPqK;
  const long long n_rows = (long long)a.P * a.cap;  // this query's probed slots
  int t_begin, n_my;
  block_tiles(a.n_tiles, t_begin, n_my);
  const int steps = n_my * n_ch;  // ring steps (m > 128)

  if (tid == 0) {
    for (int i = 0; i < kResidentChunks; ++i) mbar_init(&tab_bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (n_my == 0) return;
  if (tid == 0) {
    for (int k = 0; k < (resident ? n_ch : min(kRing, steps)); ++k) {
      const int c = k % n_ch;
      mbar_arrive_expect_tx(&tab_bar[k], chunk_bytes(c, a.m));
      bulk_load(tab + k * kChunkFloats, lut_q + c * kChunkFloats, chunk_bytes(c, a.m),
                &tab_bar[k]);
    }
  }

  for (int i = 0; i < n_my; ++i) {
    const long long v0 = (long long)(t_begin + i) * a.tile;
    const int w = (int)min((long long)a.tile, n_rows - v0);
    // each slot's codes in global memory (an id outside [0, K) reads
    // cluster 0 and writes NaN)
    const uint8_t* src[kMaxSlots];
    bool live[kMaxSlots], valid[kMaxSlots];
    float acc[kMaxSlots];
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k) {
      const int r = tid + k * kAdcThreads;
      live[k] = r < w;
      acc[k] = 0.f;
      valid[k] = false;
      src[k] = a.codes;
      if (live[k]) {
        const long long v = v0 + r;
        const int p = (int)(v / a.cap);
        const int cl = a.probe[(long long)q * a.P + p];
        valid[k] = cl >= 0 && cl < a.n_clusters;
        const long long slot = (long long)(valid[k] ? cl : 0) * a.cap + (v - (long long)p * a.cap);
        src[k] = a.codes + (kCols ? slot : slot * a.m);
      }
    }

    for (int c = 0; c < n_ch; ++c) {
      const int k_step = i * n_ch + c;
      const float* t;
      if (resident) {
        mbar_wait(&tab_bar[c], 0);
        t = tab + c * kChunkFloats;
      } else {
        mbar_wait(&tab_bar[k_step % kRing], (k_step / kRing) & 1);
        t = tab + (k_step % kRing) * kChunkFloats;
      }
      const int j0 = c * kMChunk;
      const int mc = min(kMChunk, a.m - j0);
      if (kCols) {
        for (int jj = 0; jj < mc; ++jj) {
#pragma unroll
          for (int k = 0; k < kMaxSlots; ++k) {
            if (live[k]) acc[k] += t[jj * kPqK + __ldg(src[k] + (j0 + jj) * a.n_slots)];
          }
        }
      } else {  // 8 codes per load
        for (int jj = 0; jj < mc; jj += 8) {
          uint2 raw[kMaxSlots];
#pragma unroll
          for (int k = 0; k < kMaxSlots; ++k) {
            if (live[k]) raw[k] = __ldg(reinterpret_cast<const uint2*>(src[k] + j0 + jj));
          }
#pragma unroll
          for (int k = 0; k < kMaxSlots; ++k) {
            if (!live[k]) continue;
            acc[k] = add4(add4(acc[k], t + jj * kPqK, raw[k].x), t + (jj + 4) * kPqK,
                          raw[k].y);
          }
        }
      }
      if (!resident) {  // every thread is done with this stage: refill it
        __syncthreads();
        if (tid == 0 && k_step + kRing < steps) {
          const int k = k_step + kRing, cn = k % n_ch;
          mbar_arrive_expect_tx(&tab_bar[k % kRing], chunk_bytes(cn, a.m));
          bulk_load(tab + (k % kRing) * kChunkFloats, lut_q + cn * kChunkFloats,
                    chunk_bytes(cn, a.m), &tab_bar[k % kRing]);
        }
      }
    }

    float* out_q = a.out + (long long)q * n_rows + v0;
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k) {
      if (live[k]) out_q[tid + k * kAdcThreads] = valid[k] ? acc[k] : nanf("");
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int Q, int blocks, int threads, long long smem,
                   cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks, (unsigned)Q), threads, (size_t)smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// layout: 0 = rows [K * cap, m], 1 = cols [m, K * cap]. route: 1 = "tma"
// (codes 16-byte aligned, m <= 128, rows with m % 16 == 0, cols with
// K * cap % 16 == 0; tile: slots per TMA box, a multiple of 16 up to 256;
// tiles of one query P * ceil(cap / tile)), 0 = "ldg" (codes 8-byte aligned;
// tile: a multiple of 16 up to 1024; tiles of one query ceil(P * cap / tile)).
// blocks: blocks per query, 1 .. the query's tile count. lut 16-byte
// aligned. Anything else returns cudaErrorInvalidValue without a launch.
extern "C" int rankpo_pq_adc_scores(const void* codes, const int* probe,
                                    const float* lut, float* out,
                                    int n_clusters, int Q, int P, int cap,
                                    int m, int layout, int route, int tile,
                                    int blocks, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool tma = route == 1;
  const long long n_slots = (long long)n_clusters * cap;
  if (m <= 0 || m % 8 != 0 || cap <= 0 || P <= 0 || Q <= 0 || Q > 65535 ||
      n_clusters <= 0 || (layout != 0 && layout != 1) || (route != 0 && route != 1) ||
      tile < 16 || tile % 16 != 0 || tile > (tma ? kMaxBox : kMaxTile) ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles =
      tma ? (long long)P * ((cap + tile - 1) / tile) : ((long long)P * cap + tile - 1) / tile;
  if (blocks < 1 || blocks > n_tiles || n_tiles > (1ll << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_ch = (m + kMChunk - 1) / kMChunk;
  AdcArgs a;
  a.codes = static_cast<const uint8_t*>(codes);
  a.probe = probe;
  a.lut = lut;
  a.out = out;
  a.n_slots = n_slots;
  a.n_clusters = n_clusters;
  a.P = P;
  a.cap = cap;
  a.m = m;
  a.tile = tile;
  a.n_tiles = (int)n_tiles;
  a.stages = m <= 64 ? 3 : kMaxStages;  // m <= 64: two blocks share an SM
  cudaError_t err;
  if (tma) {
    const bool aligned = reinterpret_cast<uintptr_t>(codes) % 16 == 0 && m <= kResidentM &&
                         (layout == 1 ? n_slots % 16 == 0 : m % 16 == 0) &&
                         n_slots < (1ll << 31);
    if (!aligned) return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    const int rc = layout == 1
                       ? encode_map_u8(&map, codes, n_slots, m, n_slots, tile, kMChunk)
                       : encode_map_u8(&map, codes, m, n_slots, m, row_step(m), tile);
    if (rc != 0) return rc;
    const long long smem =
        kBarBytes + (long long)n_ch * kChunkFloats * 4 + (long long)a.stages * kStageBytes;
    err = layout == 1
              ? launch(pq_adc_tma_kernel<true>, Q, blocks, kAdcThreads + 32, smem, st, map, a)
              : launch(pq_adc_tma_kernel<false>, Q, blocks, kAdcThreads + 32, smem, st, map, a);
  } else {
    const long long smem =
        kBarBytes + (long long)(m <= kResidentM ? n_ch : kRing) * kChunkFloats * 4;
    err = layout == 1 ? launch(pq_adc_ldg_kernel<true>, Q, blocks, kAdcThreads, smem, st, a)
                      : launch(pq_adc_ldg_kernel<false>, Q, blocks, kAdcThreads, smem, st, a);
  }
  return (int)err;
}
