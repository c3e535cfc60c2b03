// Probed-cluster scores for the IVF search path on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rankpo_tpu/ops/ivf_gather_pallas.py:_kernel
// (reached through probe_scores), which streams each probed [cap, D] cluster
// block HBM -> VMEM with triple-buffered DMA and fuses the dot.
//
// Contract (probe_scores):
//   corpus [K * cap, D] bf16 or fp32, cluster-major rows (row-major, 16-byte
//   aligned); probe [Q, P] int32 cluster ids; queries [Q, D] fp32;
//   out [Q, P, cap] fp32 with
//     out[q, p, c] = sum_d qv[q, d] * corpus[probe[q, p] * cap + c, d]
//   where qv is the query rounded to bf16 for bf16 rows (the TPU kernel's
//   DEFAULT-precision product, and the XLA path's explicit cast) and the fp32
//   query for fp32 rows (the TPU kernel's HIGHEST precision: true fp32
//   products, never TF32). Products are formed with fp32 FMAs, so for bf16
//   rows every product is exact and only the fp32 summation rounds.
//   A probe id outside [0, K) writes NaN over its [cap] scores instead of
//   reading out of bounds.
//
// What bounds it on this card: it is a batched, gathered matrix-vector
// product. Each row element is used for one multiply-add per query that
// probes its cluster, so at the search shapes (Q 64, P ~179, cap 336, D
// 2048, bf16) the distinct probed blocks are ~5.3 GB for ~16 GFLOP: HBM
// bandwidth (3.35 TB/s) bounds it, far below any compute peak. A batch's
// queries probe the same clusters many times over (~3 queries per distinct
// block there), so the design reads each probed block once for all the
// queries that probe it:
//   - the caller groups the (query, probe) pairs by cluster id
//     (ivf_gather.group_probes: pairs in cluster order, each group's start
//     and cluster), with no host sync; the grid is sized by a bound on the
//     group count and blocks past the last group exit at once;
//   - one block per (group, 64-row tile of cap). The group's queries are
//     staged in shared memory as fp32 (rounded once to bf16 for bf16 rows)
//     in chunks of 8; each warp takes two rows at a time, loads their
//     16-byte vectors once into registers (neighbouring lanes on
//     neighbouring addresses, so every DRAM sector fetched is used) and
//     keeps one fp32 sum per (row, query of the chunk). A group of more
//     than 8 queries reads its tile again for each further chunk, from L2
//     when the tile (256 KB at D 2048 bf16) is still there;
//   - every sum is taken in the order of the kernel this replaced (one
//     block per (query, probe, tile)): lane l takes elements l kVec +
//     j 32 kVec for ascending j, FMAs in element order, then the xor-shuffle
//     tree 16, 8, 4, 2, 1. So every score is bit-equal to that kernel's.
//     The tree is run as a reduce-scatter over the 8 sums of a chunk (each
//     step halves the sums a lane carries), which adds the same operands in
//     the same pairs, in 9 shuffles instead of 40.
// Tensor cores would buy nothing: the FMAs are ~0.25 ms at the shapes
// above against the ~1.6 ms byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kRowsPerBlock = 64;  // 8 rows per warp
constexpr int kChunk = 8;          // queries staged at once (the reduce-scatter needs 8)
constexpr int kRows = 2;           // rows a warp holds at once
constexpr int kSeg = 8;            // 16-byte vectors a lane holds per row

// acc + the dot of one 16-byte vector of row elements with the staged
// query, FMAs in element order. bf16 rows: the query is staged as two
// halves, lo (elements 0-3 of every 8) and hi (4-7), so that a warp's
// 16-byte shared-memory loads are contiguous.
__device__ __forceinline__ float dot16(const uint4& raw, const float* lo, const float* hi,
                                       float acc, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(lo);
  const float4 qb = *reinterpret_cast<const float4*>(hi);
  float2 f;
  f = __bfloat1622float2(h[0]);
  acc = fmaf(f.x, qa.x, acc);
  acc = fmaf(f.y, qa.y, acc);
  f = __bfloat1622float2(h[1]);
  acc = fmaf(f.x, qa.z, acc);
  acc = fmaf(f.y, qa.w, acc);
  f = __bfloat1622float2(h[2]);
  acc = fmaf(f.x, qb.x, acc);
  acc = fmaf(f.y, qb.y, acc);
  f = __bfloat1622float2(h[3]);
  acc = fmaf(f.x, qb.z, acc);
  acc = fmaf(f.y, qb.w, acc);
  return acc;
}

__device__ __forceinline__ float dot16(const uint4& raw, const float* lo, const float*,
                                       float acc, const float*) {
  const float4 r = *reinterpret_cast<const float4*>(&raw);
  const float4 q = *reinterpret_cast<const float4*>(lo);
  acc = fmaf(r.x, q.x, acc);
  acc = fmaf(r.y, q.y, acc);
  acc = fmaf(r.z, q.z, acc);
  acc = fmaf(r.w, q.w, acc);
  return acc;
}

// The xor-shuffle tree 16, 8, 4, 2, 1 over the 8 sums of every lane, as a
// reduce-scatter: returns the warp's total of sum (lane >> 2) (every lane
// with the same lane >> 2 holds it). Each step adds the same two partial
// sums as the plain tree (a + b == b + a in fp32), so the totals are
// bit-equal to it.
__device__ __forceinline__ float reduce8(float (&v)[kChunk], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // lanes with bit 4 keep sums 4-7, others 0-3
    const float keep = b4 ? v[i + 4] : v[i];
    const float send = b4 ? v[i] : v[i + 4];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? v[i + 2] : v[i];
    const float send = b3 ? v[i] : v[i + 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float keep = b2 ? v[1] : v[0];
  const float send = b2 ? v[0] : v[1];
  float r = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  return r;
}

// One block per (group of pairs probing one cluster, 64-row tile of cap).
// pairs[i] = q * P + p in cluster order; group g holds pairs
// [start[g], start[g + 1]) and probes cluster[g].
template <typename T>
__global__ void __launch_bounds__(kGatherThreads, 2)
ivf_probe_scores_kernel(const T* __restrict__ corpus, const int* __restrict__ pairs,
                        const int* __restrict__ start, const int* __restrict__ cluster,
                        const float* __restrict__ queries, float* __restrict__ out,
                        int n_clusters, int P, int cap, int D) {
  extern __shared__ __align__(16) float qs[];  // [kChunk][D] fp32
  __shared__ int pair_s[kChunk];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int g = blockIdx.x;
  const int begin = start[g], end = start[g + 1];
  if (begin >= end) return;  // past the last group
  const int cl = cluster[g];
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r_end = min(cap, r0 + kRowsPerBlock);
  if (cl < 0 || cl >= n_clusters) {
    const int rows = r_end - r0;
    for (int i = threadIdx.x; i < (end - begin) * rows; i += kGatherThreads) {
      out[(long long)pairs[begin + i / rows] * cap + r0 + i % rows] = nanf("");
    }
    return;
  }
  const T* block = corpus + (long long)cl * cap * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = D / 2;

  for (int c0 = begin; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    if (c0 > begin) __syncthreads();  // every warp is done with the last chunk
    if ((int)threadIdx.x < n) pair_s[threadIdx.x] = pairs[c0 + threadIdx.x];
    for (int qi = 0; qi < n; ++qi) {
      const float* qrow = queries + (long long)(pairs[c0 + qi] / P) * D;
      float* dst = qs + qi * D;
      for (int d = threadIdx.x; d < D; d += kGatherThreads) {
        const float v = qrow[d];
        if (kBf16) {  // element d of group d / 8 to lo (0-3) or hi (4-7)
          dst[(d % 8 < 4 ? 0 : half) + (d / 8) * 4 + d % 4] =
              __bfloat162float(__float2bfloat16_rn(v));
        } else {
          dst[d] = v;
        }
      }
    }
    __syncthreads();

    for (int r = r0 + warp * kRows; r < r_end; r += kGatherWarps * kRows) {
      float acc[kRows][kChunk];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int qi = 0; qi < kChunk; ++qi) acc[rr][qi] = 0.f;
      }
      for (int base = 0; base < D; base += 32 * kVec * kSeg) {
        uint4 raw[kRows][kSeg];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
          for (int s = 0; s < kSeg; ++s) {
            const int c = base + (lane + 32 * s) * kVec;
            raw[rr][s] = r + rr < r_end && c < D
                             ? __ldg(reinterpret_cast<const uint4*>(
                                   block + (long long)(r + rr) * D + c))
                             : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int qi = 0; qi < kChunk; ++qi) {
          if (qi >= n) break;
          const float* q = qs + qi * D;
#pragma unroll
          for (int s = 0; s < kSeg; ++s) {
            const int c = base + (lane + 32 * s) * kVec;
            if (c >= D) break;
            const float* lo = kBf16 ? q + c / 2 : q + c;
            const float* hi = q + half + c / 2;
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr) {
              acc[rr][qi] = dot16(raw[rr][s], lo, hi, acc[rr][qi], block);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float sum = reduce8(acc[rr], lane);
        const int qi = lane >> 2;
        if ((lane & 3) == 0 && qi < n && r + rr < r_end) {
          out[(long long)pair_s[qi] * cap + r + rr] = sum;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* corpus, const int* pairs, const int* start, const int* cluster,
           const float* queries, float* out, int n_clusters, int P, int cap, int D,
           int n_groups, cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_probe_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_groups, (cap + kRowsPerBlock - 1) / kRowsPerBlock);
  ivf_probe_scores_kernel<T><<<grid, kGatherThreads, smem, stream>>>(
      static_cast<const T*>(corpus), pairs, start, cluster, queries, out, n_clusters, P, cap,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// pairs [Q * P], start [n_groups + 1], cluster [n_groups]: the grouping of
// ivf_gather.group_probes. dtype: 0 = fp32 rows, 1 = bf16 rows. D must be a
// multiple of 8.
extern "C" int rankpo_ivf_probe_scores(const void* corpus, const int* pairs, const int* start,
                                       const int* cluster, const float* queries, float* out,
                                       int n_clusters, int Q, int P, int cap, int D,
                                       int n_groups, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || cap <= 0 || P <= 0 || Q <= 0 || n_groups <= 0 ||
      (long long)Q * P > 0x7fffffffLL || (cap + kRowsPerBlock - 1) / kRowsPerBlock > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(corpus, pairs, start, cluster, queries, out, n_clusters, P,
                                 cap, D, n_groups, st);
  }
  if (dtype == 0) {
    return launch<float>(corpus, pairs, start, cluster, queries, out, n_clusters, P, cap, D,
                         n_groups, st);
  }
  return (int)cudaErrorInvalidValue;
}
