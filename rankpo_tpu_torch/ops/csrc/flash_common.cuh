// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu and the
// generic build, flash_generic.cu) share beside the Hopper pieces of
// hopper.cuh: the tile size, the JAX kernel's NEG_INF, the bf16 pair packing
// of an A operand, the valid key extent of a mask row, the span of a tile's
// segments in packed mode, the window's query-tile bounds of a key tile, and
// the wait on K2's counters.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows per tile (query rows or keys)
constexpr float kNegInf = -1e30f;  // the JAX kernel's NEG_INF

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// One past the last valid (non-zero) entry of mask row mrow[0 .. Sk) among
// the entries this thread's warp scans (thread tid of `threads` takes every
// threads-th entry), reduced over the warp. The caller reduces the warps'
// values behind one barrier.
__device__ __forceinline__ int warp_key_end(const int* mrow, int Sk, int tid, int threads) {
  int local_end = 0;
  for (int j = tid; j < Sk; j += threads) {
    if (mrow[j] != 0) local_end = j + 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local_end = max(local_end, __shfl_xor_sync(0xffffffffu, local_end, off));
  }
  return local_end;
}

// Sequence packing (the kPacked builds): the mask row carries segment ids,
// contiguous runs 1..n with a 0-id pad tail. The rows (or keys) of the
// 64-position tile at p0 pair only with positions [lo, hi) of the row:
// lo = #(0 < m < m[p0]) and hi = #(0 < m <= max(m[p0 .. p0 + 63])), the JAX
// kernels' counts (flash_attention.py:137-147, :315-328); a tile that starts
// in the pad tail has hi = 0. Every thread of the block calls it (two
// barriers) and gets the same span.
template <int kThreads>
__device__ __forceinline__ int2 packed_span(const int* mrow, int S, int p0, int tid) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps >= 2, "the tile's 64 entries are read by warps 0 and 1");
  __shared__ int tile_max[2];
  __shared__ int warp_lo[kWarps], warp_hi[kWarps];
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (warp < 2) {
    int m = p0 + tid < S ? mrow[p0 + tid] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) tile_max[warp] = m;
  }
  __syncthreads();
  const int first = mrow[p0];
  const int last = max(tile_max[0], tile_max[1]);
  int lo = 0, hi = 0;
  for (int j = tid; j < S; j += kThreads) {
    const int m = mrow[j];
    lo += m != 0 && m < first;
    hi += m != 0 && m <= last;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
  }
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  lo = hi = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    lo += warp_lo[i];
    hi += warp_hi[i];
  }
  return make_int2(lo, hi);
}

// dQ summed in key-tile order (K2, flash_bwd.cu's header): a query tile's
// counter, read with acquire semantics, says how many key tiles have added.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void wait_turn(const int* counter, int target) {
  while (ld_acquire(counter) < target) __nanosleep(32);
}

// With a window, the last query row that sees a key of the tile starting at
// key0 is key0 + 63 + window - 1 - q_shift: the kv kernel's query tiles end
// at (that row) / 64 + 1, none if it is negative.
__device__ __forceinline__ int window_q_end(int key0, int window, int q_shift) {
  const int last_row = key0 + kTile - 2 + window - q_shift;
  return last_row < 0 ? 0 : last_row / kTile + 1;
}

// The first key tile whose window_q_end passes query tile qt: the least kt
// with qt * 64 <= kt * 64 + 62 + window - q_shift. The window's key tiles
// of qt are first_kt(qt) .. the causal and valid-length end, so key tile kt
// is the (kt - first_kt)-th to add qt's dQ.
__device__ __forceinline__ int first_kt(int qt, int window, int q_shift) {
  const int x = qt * kTile + q_shift - window - (kTile - 2);
  return x <= 0 ? 0 : (x + kTile - 1) / kTile;
}

}  // namespace
