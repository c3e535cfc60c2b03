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
// product. Each row element is read once and used for one multiply-add, so
// at the search shapes (Q 64, P ~32, cap ~336, D 2048, bf16) it moves ~2.8 GB
// for ~2.8 GFLOP: HBM bandwidth (3.35 TB/s) bounds it, far below any compute
// peak. The design therefore spends its effort on the row loads: one block
// per (query, probe, 64-row tile), the query staged once in shared memory as
// fp32 (rounded once, not per product), and each warp taking whole rows with
// 16-byte vector loads, so neighbouring lanes read neighbouring addresses and
// every DRAM sector fetched is used. Each lane keeps an fp32 partial sum over
// its slice of the row; a warp-shuffle reduction finishes the dot. Blocks of
// different queries that probe the same cluster read it again (through L2
// when it is still there); sharing a block across queries is left for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kRowsPerBlock = 64;  // 8 rows per warp

// dot of one 16-byte vector of row elements with the staged query
__device__ __forceinline__ float dot16(const uint4& raw, const float* qs,
                                       float acc, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(qs);
  const float4 qb = *reinterpret_cast<const float4*>(qs + 4);
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

__device__ __forceinline__ float dot16(const uint4& raw, const float* qs,
                                       float acc, const float*) {
  const float4 r = *reinterpret_cast<const float4*>(&raw);
  const float4 q = *reinterpret_cast<const float4*>(qs);
  acc = fmaf(r.x, q.x, acc);
  acc = fmaf(r.y, q.y, acc);
  acc = fmaf(r.z, q.z, acc);
  acc = fmaf(r.w, q.w, acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
ivf_probe_scores_kernel(const T* __restrict__ corpus,
                        const int* __restrict__ probe,
                        const float* __restrict__ queries,
                        float* __restrict__ out, int n_clusters, int P,
                        int cap, int D) {
  extern __shared__ float qs[];  // [D] fp32, 16-byte aligned
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int q = blockIdx.z;
  const int p = blockIdx.y;
  const float* qrow = queries + (long long)q * D;
  for (int i = threadIdx.x; i < D; i += kGatherThreads) {
    const float v = qrow[i];
    qs[i] = kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
  __syncthreads();

  const int cluster = probe[(long long)q * P + p];
  float* orow = out + ((long long)q * P + p) * cap;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r_end = min(cap, r0 + kRowsPerBlock);
  if (cluster < 0 || cluster >= n_clusters) {
    for (int r = r0 + threadIdx.x; r < r_end; r += kGatherThreads) {
      orow[r] = nanf("");
    }
    return;
  }
  const T* block = corpus + (long long)cluster * cap * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = r0 + warp; r < r_end; r += kGatherWarps) {
    const T* row = block + (long long)r * D;
    float acc = 0.f;
#pragma unroll 4
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c));
      acc = dot16(raw, qs + c, acc, row);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) orow[r] = acc;
  }
}

template <typename T>
int launch(const void* corpus, const int* probe, const float* queries,
           float* out, int n_clusters, int Q, int P, int cap, int D,
           cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_probe_scores_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((cap + kRowsPerBlock - 1) / kRowsPerBlock, P, Q);
  ivf_probe_scores_kernel<T><<<grid, kGatherThreads, smem, stream>>>(
      static_cast<const T*>(corpus), probe, queries, out, n_clusters, P, cap,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 rows, 1 = bf16 rows. D must be a multiple of 8.
extern "C" int rankpo_ivf_probe_scores(const void* corpus, const int* probe,
                                       const float* queries, float* out,
                                       int n_clusters, int Q, int P, int cap,
                                       int D, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || cap <= 0 || P <= 0 || Q <= 0 || Q > 65535 ||
      P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(corpus, probe, queries, out, n_clusters, Q, P,
                                 cap, D, st);
  }
  if (dtype == 0) {
    return launch<float>(corpus, probe, queries, out, n_clusters, Q, P, cap, D,
                         st);
  }
  return (int)cudaErrorInvalidValue;
}
