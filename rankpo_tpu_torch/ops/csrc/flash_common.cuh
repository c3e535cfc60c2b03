// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu) share beside
// the Hopper pieces of hopper.cuh: the tile size, the JAX kernel's NEG_INF,
// the bf16 pair packing of an A operand, and the valid key extent of a mask
// row.

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

}  // namespace
