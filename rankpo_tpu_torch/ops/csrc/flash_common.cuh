// Tile machinery shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): 64-row tiles staged in shared memory with 16-byte vector
// loads, mma.sync m16n8k16 (bf16 -> fp32) on the tensor cores, and the
// block-wide extent of the valid keys of a mask row.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a[0] (row g, cols 2t, 2t+1), a[1] (row g+8),
//     a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, "col"): b[0] (rows 2t, 2t+1, col g), b[1] (rows 2t+8, 2t+9);
//   C (16 x 8): c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8).
// So the C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of the next product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows per tile (query rows or keys)
constexpr int kWarps = 4;          // 16 tile rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;            // bf16 elements of row padding (16 bytes)
constexpr float kNegInf = -1e30f;  // the JAX kernel's NEG_INF

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) of a strided [rows, D] bf16 matrix into shared
// memory (row stride D + kPad); rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kVecPerRow = D / 8;  // 8 bf16 = 16 bytes
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// A fragments of rows [16 * warp, 16 * warp + 16) of a staged tile, for all
// D / 16 steps of the contraction over head_dim.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t frag[D / 16][4],
                                            const __nv_bfloat16* tile,
                                            int warp, int g, int t) {
  constexpr int LDS = D + kPad;
  const __nv_bfloat16* r0 = tile + (warp * 16 + g) * LDS + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * LDS;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag[kk][0] = ld_u32(r0 + kk * 16);
    frag[kk][1] = ld_u32(r1 + kk * 16);
    frag[kk][2] = ld_u32(r0 + kk * 16 + 8);
    frag[kk][3] = ld_u32(r1 + kk * 16 + 8);
  }
}

// acc[j] (16 x 8, j over the 8 column tiles of a 64-row tile) += A . T^T,
// where T is a staged [64, D] tile: row n of T is column n of the product.
template <int D>
__device__ __forceinline__ void mma_a_tileT(float acc[kTile / 8][4],
                                            const uint32_t a[D / 16][4],
                                            const __nv_bfloat16* tile, int g,
                                            int t) {
  constexpr int LDS = D + kPad;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* r = tile + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2] = {ld_u32(r + kk * 16), ld_u32(r + kk * 16 + 8)};
      mma_16816(acc[j], a[kk], b);
    }
  }
}

// acc[n] (16 x D) += X . T, where X is a 16 x 64 operand given as C
// fragments x[j] (fp32, rounded to bf16 here) and T is a staged [64, D] tile.
template <int D>
__device__ __forceinline__ void mma_c_tile(float acc[D / 8][4],
                                           const float x[kTile / 8][4],
                                           const __nv_bfloat16* tile, int g,
                                           int t) {
  constexpr int LDS = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* r0 = tile + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* rp = r0 + n * 8;
      uint32_t b[2] = {pack_pair(rp[0], rp[LDS]),
                       pack_pair(rp[8 * LDS], rp[9 * LDS])};
      mma_16816(acc[n], a, b);
    }
  }
}

// One past the last valid (non-zero) entry of mask row mrow[0 .. Sk), reduced
// over the block through *slot. Contains two __syncthreads.
__device__ __forceinline__ int block_key_end(const int* mrow, int Sk,
                                             int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int local_end = 0;
  for (int j = threadIdx.x; j < Sk; j += kThreads) {
    if (mrow[j] != 0) local_end = j + 1;
  }
  for (int off = 16; off > 0; off >>= 1) {
    local_end = max(local_end, __shfl_xor_sync(0xffffffffu, local_end, off));
  }
  if ((threadIdx.x & 31) == 0) atomicMax(slot, local_end);
  __syncthreads();
  return *slot;
}

}  // namespace
