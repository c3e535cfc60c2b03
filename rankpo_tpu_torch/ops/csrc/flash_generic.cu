// Flash attention in any dtype and at any head dim: a generic SIMT build of
// K1, K3a, K3b and K2 beside the Hopper kernels (flash_fwd.cu, flash_bwd.cu).
//
// Replaces, for the inputs the Hopper kernels are not built for (fp32 and
// fp16 at any head dim, bf16 at a head dim other than 64, 128 and 256), the
// Pallas TPU kernels of rankpo_tpu/ops/flash_attention.py:
//   _fwd_kernel       (:55,  via _flash_fwd_impl :507) -> flash_fwd_generic
//   _dq_kernel        (:161, via flash_dq :550)        -> flash_dq_generic
//   _dkv_kernel       (:240, via flash_dkv :579)       -> flash_kv_generic<T, false>
//   _bwd_fused_kernel (:341, via flash_bwd_fused :621) -> flash_kv_generic<T, true>
//
// Contract: the JAX kernels', as the Hopper kernels' headers state it, with
// the element type T (fp32, fp16 or bf16) passed at run time:
//   q/k/v/do [B, S, H, D] in T, read through their strides (the head_dim
//   stride must be 1), GQA without copying K/V; mask [B, Sk] int32 (segment
//   ids when packed); lse, delta [B, Hq, Sq] fp32. s = scale * q.k with
//   fp32 sums (scale = 1/sqrt(D) rounded once to fp32, as JAX's Python
//   float); p = exp(s - m) (K1) or exp(s - lse) (backward) on valid pairs,
//   0 elsewhere; P rounded to T before P V and P^T dO, dS = p (dP - delta)
//   scale rounded to T before dS K and dS^T Q, as JAX's kernels round them
//   (no-ops in fp32). A row with no valid key gives zeros and lse = -1e30;
//   the backward gives such a row (lse = -1e30) p = 0, as the plain version.
//   The tiles run are the Hopper kernels' (64-row tiles; the valid length,
//   the causal diagonal, the window's band, the packed spans of
//   flash_common.cuh, skip_pad_q), so skip_pad_q zeroes the same rows.
//   Causal, window (-1: none), packed and skip_pad_q are run-time
//   arguments: one build per dtype, not per setting.
//   Outputs: O in T and lse in fp32 (K1); dQ in T as [B, Sq, Hq, D] (K3a);
//   dK/dV in T as [B, Sk, Hkv, D], or in fp32 with f32_out (the ring's
//   partials), each GQA group summed in the block (K3b, K2); K2 adds dQ
//   into a zeroed fp32 [B, Hq, Sq, D] buffer in key-tile order by
//   flash_bwd.cu's scheme: a ticket in sync[0] hands out the blocks' places
//   in the order they start, key tile slowest, and a counter per (batch *
//   query head, query tile, column block) gives each key tile its turn, with
//   ticks for the turns a packed key tile passes. No atomics touch an
//   output, so every output repeats bit for bit.
//
// Design: simple SIMT, fp32 FMAs only (no tensor cores, no TF32). A block is
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 patch of
// rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of every 64 x 64 tile
// product. Operands are staged in shared memory as fp32 64 x 64 chunks of D
// (transposed where a product contracts over D, so each step reads a
// thread's four rows and four columns as two float4), one chunk at a time,
// so any D runs. The output sums ([64, cols]: O; dQ; dK and dV) live in
// shared memory, each entry owned by one thread. A block owns `cols` output
// columns, a multiple of 64 up to what its shared memory holds (opt-in, up
// to 227 KB); a larger D splits its columns over blocks, each of which
// recomputes S (and dP) over the whole D.
//   - K1 and K3a: one block per (batch, query head, 64-row query tile,
//     column block), the key tiles inside the bounds in order; Q (and dO)
//     stay staged when D <= 64.
//   - K3b and K2: one block per (batch, kv head, 64-key tile, column block),
//     the (query head of the group, query tile) pairs inside the bounds in
//     order; K2 also stages dS^T and adds each pair's dQ on its turn.
// What bounds it: at the main path's shapes (fp32, D 64, S 1280 to 4096) the
// FMAs: 2 (K1), 3 (K3a), 4 (K3b) or 5 (K2) products of 64 x 64 x D per tile
// pair, against the card's fp32 rate without tensor cores; the fp32 staging
// from L2 and the transposed stores to shared memory come on top. Not tuned:
// speed against its bound is later work (ROADMAP Queue 2).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                // columns of D staged at a time
constexpr int kLd = kChunk + 4;           // a staged row, in floats
constexpr int kTileFloats = kTile * kLd;  // one staged 64 x 64 tile
// dynamic shared memory a block may ask for, the static arrays' room kept
constexpr int kSmemCap = 232448 - 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: JAX's p.astype(v.dtype) and ds.astype(q.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

struct GenArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* mask;
  const float* lse;    // backward: the forward's
  const float* delta;
  void* out;           // K1: T [B, Sq, Hq, D]
  float* lse_out;      // K1: fp32 [B, Hq, Sq]
  void* dq;            // K3a: T [B, Sq, Hq, D]; K2: fp32 [B, Hq, Sq, D], zeroed
  void* dk;            // K3b, K2: [B, Sk, Hkv, D] in T, or fp32 with f32_out
  void* dv;
  int* sync;           // K2: zeroed int32 [1 + B * Hq * q tiles * col_blocks]
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, mask_sb;
  float scale;
  int causal, skip_pad_q, window, packed;  // window > 0 with causal, else -1
  int cols, col_blocks;  // output columns a block owns, blocks over D
  int f32_out;
};

// Rows [r0, r0 + 64) and columns [c0, c0 + 64) of one head of a [B, S, H, D]
// operand (base: the head's row 0, row stride ss) as fp32, transposed into
// dst[c][r] (kTrans) or row-major into dst[r][c]; zeros past S and D.
template <bool kTrans, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, long long ss, int r0, int S,
                                      int c0, int D) {
  for (int i = threadIdx.x; i < kTile * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    float x = 0.f;
    if (r0 + r < S && c0 + c < D) x = to_f(base[(long long)(r0 + r) * ss + c0 + c]);
    dst[kTrans ? c * kLd + r : r * kLd + c] = x;
  }
}

// acc[i][j] += sum over x < 64 of A[x][4 ty + i] * B[x][4 tx + j]
__device__ __forceinline__ void product(float (&acc)[4][4], const float* A, const float* B,
                                        int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < kChunk; ++x) {
    const float4 a4 = *reinterpret_cast<const float4*>(A + x * kLd + 4 * ty);
    const float4 b4 = *reinterpret_cast<const float4*>(B + x * kLd + 4 * tx);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// max / sum over the 16 threads (tx) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// one past the last valid key of the mask row, reduced over the block
__device__ __forceinline__ int block_key_end(const int* mrow, int Sk) {
  __shared__ int warp_end[kThreads / 32];
  const int e = warp_key_end(mrow, Sk, threadIdx.x, kThreads);
  if (threadIdx.x % 32 == 0) warp_end[threadIdx.x / 32] = e;
  __syncthreads();
  int end = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) end = max(end, warp_end[i]);
  return end;
}

// The key tiles [x, y) the query tile at q0 runs: flash_fwd.cu's K1 bounds
// (the dq kernel's too). Every thread calls it (packed: two barriers).
__device__ __forceinline__ int2 key_tiles(const GenArgs& a, const int* mrow, int key_end,
                                          int q0) {
  const int q_shift = a.Sk - a.Sq;
  int end = (key_end + kTile - 1) / kTile;
  if (a.causal) {
    const int last_pos = q0 + kTile - 1 + q_shift;  // the tile's last row
    end = min(end, last_pos < 0 ? 0 : last_pos / kTile + 1);
  }
  if (a.skip_pad_q && q0 + q_shift >= key_end) end = 0;
  int begin = a.window > 0 ? max(0, q0 + q_shift - a.window + 1) / kTile : 0;
  if (a.packed) {
    const int2 span = packed_span<kThreads>(mrow, a.Sk, q0, threadIdx.x);
    begin = max(begin, span.x / kTile);
    end = min(end, (span.y + kTile - 1) / kTile);
  }
  return make_int2(begin, end);
}

// Whether (query row at position qpos of segment qseg, key at position key
// whose mask entry is kv) is a valid pair: JAX's valid, tile by tile.
__device__ __forceinline__ bool pair_valid(const GenArgs& a, int kv, int qseg, int key,
                                           int qpos) {
  return kv != 0 && (!a.packed || kv == qseg) && (!a.causal || key <= qpos) &&
         (a.window <= 0 || key > qpos - a.window);
}

// ---- K1: O and lse ----

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_generic(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // Q chunk, [d][row]
  float* Kt = Qt + kTileFloats;                 // K chunk, [d][key]; then P^T, [key][row]
  float* Vs = Kt + kTileFloats;                 // V chunk, [key][col]
  float* acc = Vs + kTileFloats;                // O sums, [row][col]
  float* Pt = Kt;
  __shared__ int kmask[kTile];
  const int acc_ld = a.cols + 4;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int per_tile = a.B * a.Hq * a.col_blocks;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x / per_tile;  // long causal tiles first
  const int cb = blockIdx.x % per_tile % a.col_blocks;
  const int bh = blockIdx.x % per_tile / a.col_blocks;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kTile, col0 = cb * a.cols;
  const int n_cc = (min(a.cols, a.D - col0) + kChunk - 1) / kChunk;  // column chunks
  const int n_dc = (a.D + kChunk - 1) / kChunk;                      // chunks of D
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  const int key_end = block_key_end(mrow, a.Sk);
  const int2 kr = key_tiles(a, mrow, key_end, q0);
  float m[4], l[4], alpha[4];
  int qpos[4], qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = row + q_shift;
    qseg[i] = a.packed && row < a.Sq ? mrow[row] : 0;
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[(4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j] = 0.f;
    }
  }
  if (n_dc == 1) stage<true>(Qt, qb, a.q_ss, q0, a.Sq, 0, a.D);

  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int key0 = kt * kTile;
    float s[4][4] = {};
    for (int dc = 0; dc < n_dc; ++dc) {  // S = Q K^T over the whole D
      if (n_dc > 1) stage<true>(Qt, qb, a.q_ss, q0, a.Sq, dc * kChunk, a.D);
      stage<true>(Kt, kb, a.k_ss, key0, a.Sk, dc * kChunk, a.D);
      if (dc == 0 && tid < kTile) kmask[tid] = key0 + tid < a.Sk ? mrow[key0 + tid] : 0;
      __syncthreads();
      product(s, Qt, Kt, ty, tx);
      __syncthreads();
    }
    // the online softmax of JAX's body: fp32 max and sum, P rounded to T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = pair_valid(a, kmask[4 * tx + j], qseg[i], key0 + 4 * tx + j, qpos[i]);
        s[i][j] = ok[j] ? a.scale * s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Pt[(4 * tx + j) * kLd + 4 * ty + i] = round_to<T>(p);
      }
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
    for (int cc = 0; cc < n_cc; ++cc) {  // O = O alpha + P V
      stage<false>(Vs, vb, a.v_ss, key0, a.Sk, col0 + cc * kChunk, a.D);
      __syncthreads();
      float o[4][4] = {};
      product(o, Pt, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = acc + (4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j;
          *p = *p * alpha[i] + o[i][j];
        }
      }
      __syncthreads();
    }
  }

  T* out = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // rows with no valid key: zeros
    const long long o_row = (((long long)b * a.Sq + row) * a.Hq + h) * a.D;
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cc * kChunk + 4 * tx + j;
        if (col0 + c < a.D && c < a.cols) {
          out[o_row + col0 + c] = from_f<T>(acc[(4 * ty + i) * acc_ld + c] / l_safe);
        }
      }
    }
    if (cb == 0 && tx == 0) a.lse_out[((long long)b * a.Hq + h) * a.Sq + row] = m[i] + logf(l_safe);
  }
}

// ---- K3a: dQ ----

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_generic(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // Q chunk, [d][row]
  float* dOt = Qt + kTileFloats;                // dO chunk, [d][row]
  float* Kt = dOt + kTileFloats;                // K chunk, [d][key]; then K, [key][col]
  float* Vt = Kt + kTileFloats;                 // V chunk, [d][key]; then dS^T, [key][row]
  float* acc = Vt + kTileFloats;                // dQ sums, [row][col]
  float* Ks = Kt;
  float* dSt = Vt;
  __shared__ int kmask[kTile];
  const int acc_ld = a.cols + 4;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int per_tile = a.B * a.Hq * a.col_blocks;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x / per_tile;
  const int cb = blockIdx.x % per_tile % a.col_blocks;
  const int bh = blockIdx.x % per_tile / a.col_blocks;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kTile, col0 = cb * a.cols;
  const int n_cc = (min(a.cols, a.D - col0) + kChunk - 1) / kChunk;
  const int n_dc = (a.D + kChunk - 1) / kChunk;
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dob = reinterpret_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  const int key_end = block_key_end(mrow, a.Sk);
  const int2 kr = key_tiles(a, mrow, key_end, q0);
  float lse[4], delta[4];
  int qpos[4], qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const long long st = ((long long)b * a.Hq + h) * a.Sq + row;
    lse[i] = row < a.Sq ? a.lse[st] : 0.f;
    delta[i] = row < a.Sq ? a.delta[st] : 0.f;
    qpos[i] = row + q_shift;
    qseg[i] = a.packed && row < a.Sq ? mrow[row] : 0;
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[(4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j] = 0.f;
    }
  }
  if (n_dc == 1) {
    stage<true>(Qt, qb, a.q_ss, q0, a.Sq, 0, a.D);
    stage<true>(dOt, dob, a.do_ss, q0, a.Sq, 0, a.D);
  }

  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int key0 = kt * kTile;
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < n_dc; ++dc) {  // S = Q K^T and dP = dO V^T
      if (n_dc > 1) {
        stage<true>(Qt, qb, a.q_ss, q0, a.Sq, dc * kChunk, a.D);
        stage<true>(dOt, dob, a.do_ss, q0, a.Sq, dc * kChunk, a.D);
      }
      stage<true>(Kt, kb, a.k_ss, key0, a.Sk, dc * kChunk, a.D);
      stage<true>(Vt, vb, a.v_ss, key0, a.Sk, dc * kChunk, a.D);
      if (dc == 0 && tid < kTile) kmask[tid] = key0 + tid < a.Sk ? mrow[key0 + tid] : 0;
      __syncthreads();
      product(s, Qt, Kt, ty, tx);
      product(dp, dOt, Vt, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = lse[i] > 0.5f * kNegInf &&
                        pair_valid(a, kmask[4 * tx + j], qseg[i], key0 + 4 * tx + j, qpos[i]);
        const float p = ok ? expf(a.scale * s[i][j] - lse[i]) : 0.f;
        dSt[(4 * tx + j) * kLd + 4 * ty + i] = round_to<T>(p * (dp[i][j] - delta[i]) * a.scale);
      }
    }
    for (int cc = 0; cc < n_cc; ++cc) {  // dQ += dS K
      stage<false>(Ks, kb, a.k_ss, key0, a.Sk, col0 + cc * kChunk, a.D);
      __syncthreads();
      float o[4][4] = {};
      product(o, dSt, Ks, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[(4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j] += o[i][j];
      }
      __syncthreads();
    }
  }

  T* dq = reinterpret_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Sq) continue;
    const long long o_row = (((long long)b * a.Sq + row) * a.Hq + h) * a.D;
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cc * kChunk + 4 * tx + j;
        if (col0 + c < a.D && c < a.cols) {
          dq[o_row + col0 + c] = from_f<T>(acc[(4 * ty + i) * acc_ld + c]);
        }
      }
    }
  }
}

// ---- K3b (dK, dV) and K2 (with dQ in key-tile order) ----

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_kv_generic(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // Q chunk, [d][row]; then Q, [row][col]
  float* dOt = Qt + kTileFloats;                // dO chunk, [d][row]; then dO, [row][col]
  float* Kt = dOt + kTileFloats;                // K chunk, [d][key]; then P, [row][key]
  float* Vt = Kt + kTileFloats;                 // V chunk, [d][key]; then dS, [row][key]
  float* dSt = Vt + kTileFloats;                // K2: dS^T, [key][row]
  float* Ks = dSt + (kFused ? kTileFloats : 0);  // K2: K, [key][col]
  float* dk_acc = Ks + (kFused ? kTileFloats : 0);  // [key][col]
  const int acc_ld = a.cols + 4;
  float* dv_acc = dk_acc + kTile * acc_ld;
  float* Qs = Qt;
  float* dOs = dOt;
  float* Ps = Kt;
  float* dSs = Vt;
  __shared__ int kmask[kTile];
  __shared__ int s_place;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (kFused) {
    if (tid == 0) s_place = atomicAdd(a.sync, 1);
    __syncthreads();
  }
  // K2: places in start order, key tile slowest, so the key tiles before
  // this one have started
  const int place = kFused ? s_place : blockIdx.x;
  const int per_tile = a.B * a.Hkv * a.col_blocks;
  const int kt = place / per_tile;
  const int cb = place % per_tile % a.col_blocks;
  const int bhk = place % per_tile / a.col_blocks;
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
  const int groups = a.Hq / a.Hkv, h0 = hk * groups;
  const int key0 = kt * kTile, col0 = cb * a.cols;
  const int n_cc = (min(a.cols, a.D - col0) + kChunk - 1) / kChunk;
  const int n_dc = (a.D + kChunk - 1) / kChunk;
  const int n_q_tiles = (a.Sq + kTile - 1) / kTile;
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the query tiles: flash_bwd.cu's kv-kernel bounds
  const int key_end = block_key_end(mrow, a.Sk);
  int qt_begin = a.causal ? max(0, key0 - q_shift) / kTile : 0;
  int qt_end = n_q_tiles;
  if (a.window > 0) qt_end = min(qt_end, window_q_end(key0, a.window, q_shift));
  if (key0 >= key_end) qt_end = 0;
  if (a.skip_pad_q) {
    const int lim = key_end - q_shift;  // tile qt runs iff qt * 64 < lim
    qt_end = min(qt_end, lim <= 0 ? 0 : (lim + kTile - 1) / kTile);
  }
  // K2 takes its dQ turn on every query tile of this unpacked range
  const int turn_begin = qt_begin, turn_end = max(qt_begin, qt_end);
  if (a.packed) {  // only the query tiles of the key tile's segments
    const int2 span = packed_span<kThreads>(mrow, a.Sk, key0, tid);
    qt_begin = max(qt_begin, span.x / kTile);
    qt_end = min(qt_end, (span.y + kTile - 1) / kTile);
  }
  const int loop_begin = kFused ? turn_begin : qt_begin;
  const int loop_end = kFused ? turn_end : qt_end;

  if (tid < kTile) kmask[tid] = key0 + tid < a.Sk ? mrow[key0 + tid] : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk_acc[(4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j] = 0.f;
        dv_acc[(4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j] = 0.f;
      }
    }
  }
  if (kFused && n_dc == 1 && n_cc == 1) stage<false>(Ks, kb, a.k_ss, key0, a.Sk, 0, a.D);
  __syncthreads();

  for (int g = 0; g < groups; ++g) {
    const int h = h0 + g;
    const long long bh = (long long)b * a.Hq + h;
    const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = reinterpret_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int qt = loop_begin; qt < loop_end; ++qt) {
      const bool run = qt >= qt_begin && qt < qt_end;  // else a K2 tick
      const int q0 = qt * kTile;
      if (run) {
        float lse[4], delta[4];
        int qpos[4], qseg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + 4 * ty + i;
          lse[i] = row < a.Sq ? a.lse[bh * a.Sq + row] : 0.f;
          delta[i] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
          qpos[i] = row + q_shift;
          qseg[i] = a.packed && row < a.Sq ? mrow[row] : 0;
        }
        float s[4][4] = {}, dp[4][4] = {};
        for (int dc = 0; dc < n_dc; ++dc) {  // S = Q K^T and dP = dO V^T
          stage<true>(Qt, qb, a.q_ss, q0, a.Sq, dc * kChunk, a.D);
          stage<true>(dOt, dob, a.do_ss, q0, a.Sq, dc * kChunk, a.D);
          stage<true>(Kt, kb, a.k_ss, key0, a.Sk, dc * kChunk, a.D);
          stage<true>(Vt, vb, a.v_ss, key0, a.Sk, dc * kChunk, a.D);
          __syncthreads();
          product(s, Qt, Kt, ty, tx);
          product(dp, dOt, Vt, ty, tx);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = q0 + 4 * ty + i < a.Sq && lse[i] > 0.5f * kNegInf &&
                            pair_valid(a, kmask[4 * tx + j], qseg[i], key0 + 4 * tx + j, qpos[i]);
            const float p = ok ? expf(a.scale * s[i][j] - lse[i]) : 0.f;
            const float ds = round_to<T>(p * (dp[i][j] - delta[i]) * a.scale);
            Ps[(4 * ty + i) * kLd + 4 * tx + j] = round_to<T>(p);
            dSs[(4 * ty + i) * kLd + 4 * tx + j] = ds;
            if (kFused) dSt[(4 * tx + j) * kLd + 4 * ty + i] = ds;
          }
        }
        for (int cc = 0; cc < n_cc; ++cc) {  // dV += P^T dO, dK += dS^T Q
          stage<false>(Qs, qb, a.q_ss, q0, a.Sq, col0 + cc * kChunk, a.D);
          stage<false>(dOs, dob, a.do_ss, q0, a.Sq, col0 + cc * kChunk, a.D);
          __syncthreads();
          float dv_o[4][4] = {}, dk_o[4][4] = {};
          product(dv_o, Ps, dOs, ty, tx);
          product(dk_o, dSs, Qs, ty, tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int e = (4 * ty + i) * acc_ld + cc * kChunk + 4 * tx + j;
              dv_acc[e] += dv_o[i][j];
              dk_acc[e] += dk_o[i][j];
            }
          }
          __syncthreads();
        }
      }
      if (kFused) {
        // this key tile's turn on (bh, qt, cb): tiles first .. kt - 1 added
        const int turn = kt - (a.window > 0 ? first_kt(qt, a.window, q_shift) : 0);
        int* counter = a.sync + 1 + ((bh * n_q_tiles + qt) * a.col_blocks + cb);
        if (tid == 0 && turn > 0) wait_turn(counter, turn);
        __syncthreads();
        if (run) {
          float* dq = reinterpret_cast<float*>(a.dq) + bh * a.Sq * a.D;
          for (int cc = 0; cc < n_cc; ++cc) {  // dQ += dS K, in key-tile order
            if (!(n_dc == 1 && n_cc == 1)) {
              stage<false>(Ks, kb, a.k_ss, key0, a.Sk, col0 + cc * kChunk, a.D);
            }
            __syncthreads();
            float o[4][4] = {};
            product(o, dSt, Ks, ty, tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = q0 + 4 * ty + i;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = col0 + cc * kChunk + 4 * tx + j;
                if (row < a.Sq && c < a.D && c < col0 + a.cols) {
                  float* dst = dq + (long long)row * a.D + c;
                  __stcg(dst, (turn > 0 ? __ldcg(dst) : 0.f) + o[i][j]);
                }
              }
            }
            __syncthreads();
          }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicAdd(counter, 1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + 4 * ty + i;
    if (key >= a.Sk) continue;
    const long long o_row = (((long long)b * a.Sk + key) * a.Hkv + hk) * a.D;
    for (int cc = 0; cc < n_cc; ++cc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cc * kChunk + 4 * tx + j;
        if (col0 + c >= a.D || c >= a.cols) continue;
        const float dkx = dk_acc[(4 * ty + i) * acc_ld + c];
        const float dvx = dv_acc[(4 * ty + i) * acc_ld + c];
        if (a.f32_out) {
          reinterpret_cast<float*>(a.dk)[o_row + col0 + c] = dkx;
          reinterpret_cast<float*>(a.dv)[o_row + col0 + c] = dvx;
        } else {
          reinterpret_cast<T*>(a.dk)[o_row + col0 + c] = from_f<T>(dkx);
          reinterpret_cast<T*>(a.dv)[o_row + col0 + c] = from_f<T>(dvx);
        }
      }
    }
  }
}

// ---- launches ----

enum Which { kFwd, kDq, kDkv, kFused };
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };  // ops/flash_attention.py GENERIC_DTYPES

// staged 64 x 64 tiles and [64, cols] sums of each kernel's shared memory
int tiles_of(Which w) { return w == kFwd ? 3 : w == kFused ? 6 : 4; }
int sums_of(Which w) { return w == kDkv || w == kFused ? 2 : 1; }
long long smem_bytes(Which w, int cols) {
  return 4LL * (tiles_of(w) * kTileFloats + sums_of(w) * kTile * (cols + 4));
}

// The fewest blocks over D whose columns (a multiple of 64) fit the shared
// memory: cols and the number of column blocks.
void pick_cols(Which w, int D, int* cols, int* blocks) {
  const int d64 = (D + kChunk - 1) / kChunk * kChunk;
  for (int n = 1;; ++n) {
    const int c = ((d64 + n - 1) / n + kChunk - 1) / kChunk * kChunk;
    if (smem_bytes(w, c) <= kSmemCap) {
      *cols = c;
      *blocks = (D + c - 1) / c;
      return;
    }
  }
}

template <typename K>
int launch(K kernel, long long grid, Which w, const GenArgs& a, cudaStream_t st) {
  if (grid <= 0 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)smem_bytes(w, a.cols);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(Which w, const GenArgs& a, cudaStream_t st) {
  const long long q_tiles = (a.Sq + kTile - 1) / kTile, k_tiles = (a.Sk + kTile - 1) / kTile;
  const long long per_q = (long long)a.B * a.Hq * a.col_blocks;
  const long long per_k = (long long)a.B * a.Hkv * a.col_blocks;
  switch (w) {
    case kFwd: return launch(flash_fwd_generic<T>, q_tiles * per_q, w, a, st);
    case kDq: return launch(flash_dq_generic<T>, q_tiles * per_q, w, a, st);
    case kDkv: return launch(flash_kv_generic<T, false>, k_tiles * per_k, w, a, st);
    default: return launch(flash_kv_generic<T, true>, k_tiles * per_k, w, a, st);
  }
}

int run(Which w, GenArgs& a, int dtype, void* stream) {
  const bool ok = a.B > 0 && a.Sq > 0 && a.Sk > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 &&
                  a.D > 0 && a.D % 8 == 0 && (!a.packed || a.Sq == a.Sk) &&
                  (a.window <= 0 || a.causal);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)a.D));
  a.window = a.window > 0 ? a.window : -1;
  pick_cols(w, a.D, &a.cols, &a.col_blocks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch<float>(w, a, st);
    case kF16: return dispatch<__half>(w, a, st);
    case kBF16: return dispatch<__nv_bfloat16>(w, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

GenArgs shape_args(const void* q, const void* k, const void* v, const int* mask, int B, int Sq,
                   int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, long long mask_sb,
                   int causal, int skip_pad_q, int window, int packed) {
  GenArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.mask_sb = mask_sb;
  a.causal = causal;
  a.skip_pad_q = skip_pad_q;
  a.window = window;
  a.packed = packed;
  return a;
}

}  // namespace

// Plain C entry points (loaded with ctypes), beside the bf16 ones of
// flash_fwd.cu and flash_bwd.cu with the same arguments, plus the element
// type (0 fp32, 1 fp16, 2 bf16) and, for the backward, f32_out (dK/dV in
// fp32; read by rankpo_flash_bwd_dkv_generic only). Each returns a
// cudaError_t value; 0 is success. The caller validates the shapes and
// dtypes, allocates the outputs (out, dq, dk, dv in T but as below) and, for
// K2, zeroes the fp32 [B, Hq, Sq, D] dq buffer and the int32 `sync` buffer
// of 1 + B * Hq * ceil(Sq / 64) * ceil(D / 64) entries (at least the
// column blocks pick_cols makes). packed: mask holds segment ids (Sq == Sk).
extern "C" int rankpo_flash_fwd_generic(
    const void* q, const void* k, const void* v, const int* mask, void* out, float* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long mask_sb, int causal, int skip_pad_q, int window, int packed,
    int dtype, void* stream) {
  GenArgs a = shape_args(q, k, v, mask, B, Sq, Sk, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                         k_sh, v_sb, v_ss, v_sh, mask_sb, causal, skip_pad_q, window, packed);
  a.out = out;
  a.lse_out = lse;
  return run(kFwd, a, dtype, stream);
}

#define RANKPO_GEN_BWD_PARAMS                                                  \
  const void *q, const void *k, const void *v, const int *mask,               \
      const void *dout, const float *lse, const float *delta, void *dq,       \
      void *dk, void *dv, int *sync, int B, int Sq, int Sk, int Hq, int Hkv,  \
      int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,  \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,         \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,      \
      long long mask_sb, int causal, int skip_pad_q, int window, int packed,  \
      int dtype, int f32_out, void *stream

namespace {

int run_bwd(Which w, RANKPO_GEN_BWD_PARAMS) {
  GenArgs a = shape_args(q, k, v, mask, B, Sq, Sk, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                         k_sh, v_sb, v_ss, v_sh, mask_sb, causal, skip_pad_q, window, packed);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sync = sync;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.f32_out = w == kDkv && f32_out;
  return run(w, a, dtype, stream);
}

}  // namespace

#define RANKPO_GEN_BWD_ARGS                                                    \
  q, k, v, mask, dout, lse, delta, dq, dk, dv, sync, B, Sq, Sk, Hq, Hkv, D,   \
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,     \
      do_sh, mask_sb, causal, skip_pad_q, window, packed, dtype, f32_out, stream

// K3a: dq in T, [B, Sq, Hq, D]; dk, dv and sync are ignored
extern "C" int rankpo_flash_bwd_dq_generic(RANKPO_GEN_BWD_PARAMS) {
  return run_bwd(kDq, RANKPO_GEN_BWD_ARGS);
}

// K3b: dk, dv (fp32 with f32_out); dq and sync are ignored
extern "C" int rankpo_flash_bwd_dkv_generic(RANKPO_GEN_BWD_PARAMS) {
  return run_bwd(kDkv, RANKPO_GEN_BWD_ARGS);
}

// K2: dq (fp32, summed in key-tile order), dk, dv in one pass
extern "C" int rankpo_flash_bwd_fused_generic(RANKPO_GEN_BWD_PARAMS) {
  return run_bwd(kFused, RANKPO_GEN_BWD_ARGS);
}
