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
// What bounds it on this card: each probed code byte is read once and costs
// one shared-memory lookup and one add. At the search shapes (Q 64, P ~32,
// cap 384, m 64) the codes are ~50 MB and the tables ~4 MB, so HBM bytes bound
// it at ~0.02 ms; the table loads and the launch are the visible costs. The
// TPU kernel built a [cblk, 8, 256] one-hot mask per m-chunk because Mosaic
// has no gather from VMEM; here the query's table sits in shared memory and
// each code byte indexes it directly, which is the whole design:
//   - one block per (query, tile of 2048 consecutive probed slots), so a
//     block's table is loaded once for several probes of its query (cap 384:
//     ~5 probes) while Q * ceil(P * cap / 2048) blocks still fill 132 SMs;
//   - the table is staged 32 subspaces (32 KB) at a time, so every m fits
//     (m 256 would need 256 KB, more than a block's 227 KB), each thread
//     keeping the running sums of its 8 slots in registers across stages;
//   - rows layout: each thread reads its slot's code bytes 8 at a time with
//     one 8-byte load; cols layout: consecutive threads take consecutive
//     slots, so each subspace's bytes are read coalesced across the warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAdcThreads = 256;
constexpr int kSlotsPerThread = 8;
constexpr int kSlotsPerBlock = kAdcThreads * kSlotsPerThread;  // 2048
constexpr int kPqK = 256;    // entries per subspace table (8-bit codes)
constexpr int kMChunk = 32;  // subspaces staged per pass: 32 KB of table

template <bool kCols>
__global__ void __launch_bounds__(kAdcThreads)
pq_adc_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ probe,
              const float* __restrict__ lut, float* __restrict__ out,
              int n_clusters, int P, int cap, int m) {
  __shared__ __align__(16) float lut_s[kMChunk * kPqK];
  const int q = blockIdx.y;
  const long long n_rows = (long long)P * cap;  // this query's probed slots
  const long long n_slots = (long long)n_clusters * cap;
  const long long v0 = (long long)blockIdx.x * kSlotsPerBlock + threadIdx.x;

  // storage slot of each of this thread's probed rows; -1 past the end, -2
  // under an out-of-range probe id
  long long slot[kSlotsPerThread];
  float acc[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const long long v = v0 + (long long)i * kAdcThreads;
    acc[i] = 0.f;
    slot[i] = -1;
    if (v < n_rows) {
      const int p = (int)(v / cap);
      const int c = (int)(v - (long long)p * cap);
      const int cl = probe[(long long)q * P + p];
      slot[i] = (cl >= 0 && cl < n_clusters) ? (long long)cl * cap + c : -2;
    }
  }

  const float* lut_q = lut + (long long)q * m * kPqK;
  for (int m0 = 0; m0 < m; m0 += kMChunk) {
    const int mc = min(kMChunk, m - m0);
    __syncthreads();  // every thread is done with the previous stage
    const float4* src = reinterpret_cast<const float4*>(lut_q + (long long)m0 * kPqK);
    float4* dst = reinterpret_cast<float4*>(lut_s);
    for (int i = threadIdx.x; i < mc * (kPqK / 4); i += kAdcThreads) {
      dst[i] = __ldg(src + i);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      if (slot[i] < 0) continue;
      float a = acc[i];
      if (kCols) {
        const uint8_t* col = codes + (long long)m0 * n_slots + slot[i];
#pragma unroll 8
        for (int j = 0; j < mc; ++j) {
          a += lut_s[j * kPqK + __ldg(col + (long long)j * n_slots)];
        }
      } else {
        const uint8_t* row = codes + slot[i] * m + m0;
        for (int j = 0; j < mc; j += 8) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + j));
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            a += lut_s[(j + b) * kPqK + ((raw.x >> (8 * b)) & 255u)];
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            a += lut_s[(j + 4 + b) * kPqK + ((raw.y >> (8 * b)) & 255u)];
          }
        }
      }
      acc[i] = a;
    }
  }

  float* out_q = out + (long long)q * n_rows;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const long long v = v0 + (long long)i * kAdcThreads;
    if (v < n_rows) out_q[v] = slot[i] == -2 ? nanf("") : acc[i];
  }
}

}  // namespace

// layout: 0 = rows [K * cap, m], 1 = cols [m, K * cap]. m must be a multiple
// of 8 and the codes 8-byte aligned.
extern "C" int rankpo_pq_adc_scores(const void* codes, const int* probe,
                                    const float* lut, float* out,
                                    int n_clusters, int Q, int P, int cap,
                                    int m, int layout, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m <= 0 || m % 8 != 0 || cap <= 0 || P <= 0 || Q <= 0 || Q > 65535 ||
      n_clusters <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_rows = (long long)P * cap;
  const dim3 grid((unsigned)((n_rows + kSlotsPerBlock - 1) / kSlotsPerBlock), Q);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (layout == 0) {
    pq_adc_kernel<false><<<grid, kAdcThreads, 0, st>>>(c, probe, lut, out,
                                                       n_clusters, P, cap, m);
  } else if (layout == 1) {
    pq_adc_kernel<true><<<grid, kAdcThreads, 0, st>>>(c, probe, lut, out,
                                                      n_clusters, P, cap, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
