// Hopper (sm_90a) building blocks in PTX: mbarriers, TMA tile loads (2-D
// and 4-D), 1-D bulk copies, the wgmma shared-memory descriptor for 128-byte
// swizzled tiles, the m64n64k16 bf16 -> fp32 warpgroup products with A from
// shared memory (SS, K-major or both operands transposed) or from registers
// (RS), the proxy fence and named barriers; on the host, the 4-D tensor
// maps of [B, S, H, D] tensors and 2-D byte tensor maps.
//
// Tile convention. Every operand tile in shared memory is 64 rows of 64 bf16
// (128 bytes, one swizzle atom wide), written by a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned 8 KB region: 16-byte
// chunk c of row r sits at r * 128 + ((c ^ (r % 8)) * 16). A head_dim of 128
// is two such regions side by side, one per 64 columns.
//
// wgmma accumulator layout (m64nN, fp32): warp w of the warpgroup owns rows
// 16w .. 16w + 15; with g = lane / 4 and t = lane % 4, registers
// d[4j + 0..1] hold (row 16w + g, cols 8j + 2t, 8j + 2t + 1) and d[4j + 2..3]
// the same columns of row 16w + g + 8. That is mma.sync's C layout per 8
// columns, and the A registers of an RS product use mma.sync's A layout, so
// two neighbouring 8-column groups of a result, packed to bf16, are the A
// operand of the next product over those 16 columns.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSwizzleTileBytes = 64 * 128;  // one 64 x 64 bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// add `bytes` to the transactions the current phase waits for, without
// arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// block until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----
// one box of a 2-D tensor map into shared memory (128-byte aligned);
// completion is counted in bytes on `bar`. Coordinates innermost first;
// out-of-bounds elements are filled with zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are innermost first; out-of-bounds elements
// are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes from global into shared memory (1-D bulk copy);
// completion is counted in bytes on `bar`. Both addresses and `bytes` must
// be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----
// Descriptor of a 128-byte-swizzled operand tile (layout type 1 in bits
// 62-63). Addresses and offsets are in 16-byte units. SBO is the step from
// one group of 8 rows to the next (1024 bytes for 128-byte rows); LBO, the
// step between swizzle atoms along the contiguous dimension, is not used when
// a product reads one atom's width (64 bf16), as every product here does.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(1024 >> 4) << 32) |
         (1ull << 62);
}

// a descriptor moved by `bytes` (a multiple of 16) inside its tile
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin register values at this point of the program: the compiler may not
// move their reads or writes across it (wgmma reads and writes its
// registers asynchronously, until wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define RANKPO_WGMMA_D32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[0..32) (+)= A . B^T over 16 of the contraction: A [64 x 16] and B
// [64 x 16] both K-major (the contraction dimension contiguous) in shared
// memory. scale_d 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RANKPO_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0..32) += A . B over 16 of the contraction: A [64 x 16] bf16 from
// registers (a[4], mma.sync's A layout), B [16 x 64] in shared memory
// MN-major (its 64 output columns contiguous, the transposed form).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t a[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : RANKPO_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0..32) (+)= A . B over 16 of the contraction, both operands in shared
// memory MN-major (the transposed forms): A is [16 x 64] with its 64 output
// rows contiguous, B [16 x 64] with its 64 output columns contiguous.
// scale_d 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n64k16_ss_tt(float* d, uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : RANKPO_WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef RANKPO_WGMMA_D32

// shared-memory writes of this thread made visible to the async proxy
// (a wgmma that reads them), ahead of the barrier that orders them
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) among `threads` threads of the block
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- host side: TMA tensor maps ----
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the CUDA
// runtime, so the library needs no link against libcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a strided [B, S, H, D] bf16 tensor, dimensions innermost
// first (D, S, H, B), boxes of 64 rows x 64 columns of one (batch, head),
// 128-byte swizzle; rows past S read as zeros.
int encode_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
               long long sb, long long ss, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                  strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D map over a row-major byte matrix [outer, inner] (row pitch
// `pitch` bytes, a multiple of 16; base 16-byte aligned), boxes of
// box_outer rows x box_inner bytes (box_inner a multiple of 16, both at most
// 256), no swizzle; elements past either dimension read as zeros.
int encode_map_u8(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                  long long pitch, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                  strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
