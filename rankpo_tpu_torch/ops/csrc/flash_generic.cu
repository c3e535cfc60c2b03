// Flash attention in any dtype and at any head dim: a generic build of K1,
// K3a, K3b and K2 beside the Hopper kernels (flash_fwd.cu, flash_bwd.cu).
//
// Replaces, for the inputs the Hopper kernels are not built for (fp32 and
// fp16 at any head dim, bf16 at a head dim other than 64, 128 and 256), the
// Pallas TPU kernels of rankpo_tpu/ops/flash_attention.py:
//   _fwd_kernel       (:55,  via _flash_fwd_impl :507) -> flash_fwd_generic<T, kHeads>
//   _dq_kernel        (:161, via flash_dq :550)        -> flash_dq_generic<T>
//   _dkv_kernel       (:240, via flash_dkv :579)       -> flash_dkv_generic<T, false>
//   _bwd_fused_kernel (:341, via flash_bwd_fused :621) -> flash_dkv_generic<T, true>
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
//   query head, query tile, column block) gives each key tile its turn
//   (each of the block's warps counts once for its rows), with ticks for
//   the turns a packed key tile passes. No atomics touch an output, so
//   every output repeats bit for bit.
//
// All four kernels: tensor cores through mma.sync, sums in registers,
// cp.async.
//   - Products. bf16 and fp16: m16n8k16 with fp32 sums (the products of two
//     16-bit values are exact in fp32); a D that is not a multiple of 16 is
//     padded with zeros in shared memory. fp32: m16n8k8 in TF32 taken as
//     three passes: each operand x splits into hi = tf32(x) and lo =
//     tf32(x - hi), rounded as cvt.rna.tf32.f32 rounds (nearest, ties away;
//     done by two integer ops, rna_tf32), and a b = a_lo b_hi + a_hi b_lo +
//     a_hi b_hi; the dropped a_lo b_lo is near 2^-22 of the product, so the
//     result keeps fp32's accuracy at a third of the TF32 rate
//     (tests/test_torch_flash_generic.py models it on the CPU). The split
//     is done per fragment, as it is loaded. The accumulator truncates, so
//     a long sum (O and K3a's dQ over the key tiles, dK/dV over the pairs)
//     takes each triple's result by an fp32 add (mma's kFresh). mma.sync,
//     not wgmma: it takes any D that is a multiple of 8 as n8 tiles, where
//     TF32 wgmma wants both operands K-major (V transposed in shared memory).
//   - K1: a block covers one 64-row query tile of kHeads query heads of a
//     GQA group (2 where the group is even, else 1), 16 rows a warp; in
//     fp32 a warp carries its rows of both heads, so each K/V fragment,
//     loaded and split once, feeds two mma (FwdShape). S, P and O stay in
//     mma fragments; the online softmax runs on them in base 2 (ex2.approx;
//     a row's 4 threads reduce by shuffles), and a warp whose rows see every
//     key of the tile tests no pair. P's C fragments become the A operand of
//     P V without shared memory (fp32: the key order permuted to match, the
//     same permutation on V's rows). O is written once.
//   - K3a: K1's layout with one query head a block (4 warps of 16 rows),
//     the key tiles inside K1's bounds in order. S = Q K^T and dP = dO V^T
//     with B from K's and V's rows; p = 2^(s scale log2 e - lse log2 e)
//     and dS = p (dP - delta) scale built in place over dP's registers;
//     dQ += dS K with dS's C fragments as the A operand, as K1's P V (fp32:
//     the key order permuted on K's rows). dQ stays in fragments over the
//     key tiles and is written once, in T.
//   - K3b and K2 (flash_dkv_generic<T, kFused>): one block (4 warps) per
//     (batch, kv head, 64-key tile, column block), each warp 16 keys; the
//     group's (query head, query tile) pairs inside the bounds (K3b head by
//     head; K2 query tile by query tile from the last, the heads inside, so
//     the blocks of consecutive key tiles reach a pair at the same index
//     and a block waits only for the add of the key tile before). S^T = K
//     Q^T and dP^T = V dO^T over D, then dV += P^T dO and dK +=
//     dS^T Q with P^T and dS^T taken from the C fragments. dK and dV stay
//     in fragments over all pairs and are written once. K2 adds a fifth
//     product for each pair: the warps write dS (rounded to T) from their
//     C fragments over the stage's Q tile, [query row][key] (fp32: each 8
//     keys in a_from_c's order), pass one barrier, and each warp takes 16
//     query rows by the block's columns as dS K over the 64 keys (K from
//     the resident tile; a sum of 4 or 8 k-steps, kept in the accumulator),
//     after it has waited for its turn and asked for its rows of the fp32
//     dQ buffer through L2 (__ldcg), which land during the product; then it
//     adds and stores them (__stcg). The next pair's loads are in flight
//     while a warp waits for its turn.
//   - Staging: 16-byte cp.async copies into row-major tiles (rows padded by
//     16 bytes, so the fragment loads hit 32 distinct banks), zeros past S
//     and D by the copies' source size, in a ring of two stages with one
//     barrier a stage (K2: three a pair): K1 and K3a load the next key
//     tile's K and V while they work on the current one, K3b and K2 the
//     next pair's Q and dO. The mask, lse, delta and segment ids come by
//     4-byte copies in the same groups. The wrapper checks the 16-byte
//     alignment of every base pointer and stride this needs
//     (ops/flash_attention.py _check_rows).
//   - Large D: D is contracted in chunks of at most kDChunk columns (Q in
//     K1, Q and dO in K3a, K and V in K3b and K2 stay staged where D fits
//     one chunk; else every operand's chunks are staged per step, and K's
//     columns for dS K in a stage of their own). The output columns a block
//     holds in registers are capped (K1 and K3a: 64 in fp32, 128 in 16-bit;
//     K3b and K2: 64), and a larger D splits its columns over blocks, each
//     recomputing S (and dP) over the whole D. The n-tiles past a block's
//     columns are multiplied on its last staged column and never stored, so
//     no branch parts one n-tile's loads and products from the next.
//   What bounds them at the main path's shapes (fp32, D 64, S 1280 to 4096;
//   bf16 and fp16 at other head dims): the products, 2 (K1), 3 (K3a), 4
//   (K3b) or 5 (K2) of 64 x 64 x D per tile pair, at a third of the 495
//   TFLOP/s TF32 rate in fp32 and at 989 TFLOP/s in 16-bit. mma.sync
//   reaches part of that; in fp32 each product also takes its fragment
//   loads, the splits' integer work and the fresh sums' adds, and the
//   kernels run near 255 registers (PERF.md). K2 also moves its fp32 dQ
//   through L2 once a pair: a read and a write of 64 x cols floats, in
//   key-tile order, so a block may wait on the block of the key tile before.
//
// The file builds as four objects that nvcc compiles side by side:
// flash_generic_f32.cu, flash_generic_f16.cu and flash_generic_bf16.cu
// include it with RANKPO_GEN_T set, each holding that dtype's kernels behind
// its dispatch function; compiled as itself it holds the C entry points,
// which pick the object by the dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rankpo_gen {

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
  // K1 and K3b (plan_tc): chunks of D contracted for S and dP, their width,
  // the staged width where D fits one chunk, a staged row's stride
  int n_dc, kdc, wq, ld;
};

enum Which { kFwd, kDq, kDkv, kFused };
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };  // ops/flash_attention.py GENERIC_DTYPES

// each dtype's kernels, in its own object; a cudaError_t value
int dispatch_f32(Which w, const GenArgs& a, cudaStream_t st);
int dispatch_f16(Which w, const GenArgs& a, cudaStream_t st);
int dispatch_bf16(Which w, const GenArgs& a, cudaStream_t st);

}  // namespace rankpo_gen

#ifdef RANKPO_GEN_T

#include "flash_common.cuh"

namespace {

using namespace rankpo_gen;

// dynamic shared memory a block may ask for, the static arrays' room kept
constexpr int kSmemCap = 232448 - 1024;

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

// one past the last valid key of the mask row, reduced over the block of kN
// threads
template <int kN>
__device__ __forceinline__ int block_key_end(const int* mrow, int Sk) {
  __shared__ int warp_end[kN / 32];
  const int e = warp_key_end(mrow, Sk, threadIdx.x, kN);
  if (threadIdx.x % 32 == 0) warp_end[threadIdx.x / 32] = e;
  __syncthreads();
  int end = 0;
#pragma unroll
  for (int i = 0; i < kN / 32; ++i) end = max(end, warp_end[i]);
  return end;
}

// The key tiles [x, y) the query tile at q0 runs: flash_fwd.cu's K1 bounds
// (the dq kernel's too). Every thread of the kN calls it (packed: two
// barriers).
template <int kN>
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
    const int2 span = packed_span<kN>(mrow, a.Sk, q0, threadIdx.x);
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

// ---- tensor-core fragments, products and cp.async staging ----

constexpr int kDChunk = 128;    // columns of D a product contracts per staged chunk
constexpr int kDkvCols = 64;    // K3b, K2: dK/dV (and dQ) columns a block holds in registers

template <typename T>
struct Tc;  // per dtype: mma's k, K1's O (K3a's dQ) columns in registers
template <>
struct Tc<float> {
  static constexpr int kK = 8;  // m16n8k8, TF32
  static constexpr int kFwdCols = 64;
};
template <>
struct Tc<__half> {
  static constexpr int kK = 16;  // m16n8k16
  static constexpr int kFwdCols = 128;
};
template <>
struct Tc<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kFwdCols = 128;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes (or 4) from global to shared memory by cp.async; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) and columns [c0, c0 + w) of one head of a [B, S, H, D]
// operand (base: the head's row 0, row stride ss) into dst[r][c] (row
// stride ld) by kN threads, 16 bytes a copy; zeros past S and past D. c0,
// w and ld are multiples of 16 bytes, and so is D (a multiple of 8).
template <int kN, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* base, long long ss, int r0,
                                           int S, int c0, int w, int D) {
  constexpr int kE = 16 / sizeof(T);
  const int per_row = w / kE;
  for (int i = threadIdx.x; i < kTile * per_row; i += kN) {
    const int r = i / per_row, c = i % per_row * kE;
    const bool ok = r0 + r < S && c0 + c < D;
    cp_async16(dst + r * ld + c, ok ? base + (long long)(r0 + r) * ss + c0 + c : base,
               ok ? 16 : 0);
  }
}

// entries [p0, p0 + 64) of a row of n 4-byte values (mask, lse, delta,
// segment ids) into dst, zeros past n
template <int kN, typename U>
__device__ __forceinline__ void stage_row(U* dst, const U* src, int p0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kN) {
    const bool ok = p0 + i < n;
    cp_async4(dst + i, ok ? src + p0 + i : src, ok ? 4 : 0);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (nearest, ties
// away: half of the 13 dropped bits' unit added to the magnitude, then the
// bits cleared), in two integer ops: cvt's own code adds checks for inf and
// NaN that cost a third of fp32 K3b's time
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (a remainder near 2^-22 x), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU (MUFU.EX2; about 2 ulp), as the Hopper kernels' __expf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_16(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2], __half) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_16(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2], __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand registers of one mma: A (16 x kK) as a[part][4], B (kK x 8) as
// b[part][2]; part 0 holds T's values (fp32: the TF32 hi), part 1 fp32's lo.
// d += a b. In fp32 the three passes, smallest first; kFresh: they sum into
// zeros and the result into d by an fp32 add. The tensor core's accumulator
// truncates, and a sum carried through it over thousands of mma (O over the
// key tiles, dK over a GQA group at S 4096) drifts by ~1e-4 of its size;
// K1's S, 3 D / 8 mma long, is summed in d directly, and K3b's S^T and dP^T
// where D <= 64.
template <typename T, bool kFresh = true>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[2][4],
                                    const uint32_t (&b)[2][2]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (kFresh) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(p, a[1], b[0]);
      mma_tf32(p, a[0], b[1]);
      mma_tf32(p, a[0], b[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] += p[i];
    } else {
      mma_tf32(d, a[1], b[0]);
      mma_tf32(d, a[0], b[1]);
      mma_tf32(d, a[0], b[0]);
    }
  } else {
    mma_16(d, a[0], b[0], T());
  }
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);  // rounded to T, lo in bits 0-15
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane (g, t) = (lane / 4, lane % 4) holds mma.sync's fragments: A rows g
// and g + 8; B column g; C (16 x 8) rows g, g + 8 and columns 2t, 2t + 1.

// A: rows [r0, r0 + 16) and columns [k0, k0 + kK) of row-major X (stride ld)
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const T* X, int ld, int r0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 4) {
    const float* x = X + (r0 + g) * ld + k0 + t;
    split_tf32(x[0], a[0][0], a[1][0]);
    split_tf32(x[8 * ld], a[0][1], a[1][1]);
    split_tf32(x[4], a[0][2], a[1][2]);
    split_tf32(x[8 * ld + 4], a[0][3], a[1][3]);
  } else {
    const T* x = X + (r0 + g) * ld + k0 + 2 * t;
    a[0][0] = ld32(x);
    a[0][1] = ld32(x + 8 * ld);
    a[0][2] = ld32(x + 8);
    a[0][3] = ld32(x + 8 * ld + 8);
  }
}

// B with B[k][n] = Y[n0 + n][k0 + k]: a row-major tile contracted along its
// rows' columns (K in Q K^T, Q in K Q^T)
template <typename T>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2][2], const T* Y, int ld, int n0,
                                            int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 4) {
    const float* y = Y + (n0 + g) * ld + k0 + t;
    split_tf32(y[0], b[0][0], b[1][0]);
    split_tf32(y[4], b[0][1], b[1][1]);
  } else {
    const T* y = Y + (n0 + g) * ld + k0 + 2 * t;
    b[0][0] = ld32(y);
    b[0][1] = ld32(y + 8);
  }
}

// B with B[k][n] = Z[k0 + k][n0 + n]: a row-major tile contracted along its
// rows (V in P V, dO and Q in P^T dO and dS^T Q). fp32: k t is row 2t and k
// t + 4 row 2t + 1, the order a_from_c gives A's k; 16-bit: ldmatrix.trans.
template <typename T>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2][2], const T* Z, int ld, int k0,
                                            int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 4) {
    const float* z = Z + (k0 + 2 * t) * ld + n0 + g;
    split_tf32(z[0], b[0][0], b[1][0]);
    split_tf32(z[ld], b[0][1], b[1][1]);
  } else {
    const T* z = Z + (k0 + (lane & 15)) * ld + n0;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1])
                 : "r"(smem_addr(z)));
  }
}

// A from C fragments, for a product that contracts the C tile's columns:
// fp32, the 8 columns of c0 (A's k t <- column 2t, k t + 4 <- column 2t +
// 1); 16-bit, the 16 columns of c0 and c1, rounded to T.
template <typename T>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[2][4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  if constexpr (sizeof(T) == 4) {
    split_tf32(c0[0], a[0][0], a[1][0]);
    split_tf32(c0[2], a[0][1], a[1][1]);
    split_tf32(c0[1], a[0][2], a[1][2]);
    split_tf32(c0[3], a[0][3], a[1][3]);
  } else {
    a[0][0] = pack2<T>(c0[0], c0[1]);
    a[0][1] = pack2<T>(c0[2], c0[3]);
    a[0][2] = pack2<T>(c1[0], c1[1]);
    a[0][3] = pack2<T>(c1[2], c1[3]);
  }
}

// ---- K1: O and lse ----

// A warp carries 16 rows of kMT of the block's kHeads query heads (fp32:
// all of them, so each K and V fragment, loaded and split once, feeds
// kHeads mma; 16-bit: one, as O's 128 columns fill the registers), so a
// block is 4 kHeads / kMT warps; as many blocks on an SM as fill 512
// threads, or two of fp32's 2-head blocks.
template <typename T, int kHeads>
struct FwdShape {
  static constexpr int kMT = sizeof(T) == 4 ? kHeads : 1;
  static constexpr int kThreadsN = 128 * kHeads / kMT;
  static constexpr int kMinBlocks = kMT == 2 ? 2 : 512 / kThreadsN;
};

template <typename T, int kHeads>
__global__ void __launch_bounds__(FwdShape<T, kHeads>::kThreadsN, FwdShape<T, kHeads>::kMinBlocks)
    flash_fwd_generic(const GenArgs a) {
  constexpr int kMT = FwdShape<T, kHeads>::kMT;
  constexpr int kN = FwdShape<T, kHeads>::kThreadsN;
  constexpr int kK = Tc<T>::kK;
  constexpr int kNt = Tc<T>::kFwdCols / 8;  // O's n-tiles a warp may hold
  constexpr int kPerK = sizeof(T) == 4 ? 1 : 2;  // S's n-tiles per k of P V
  extern __shared__ float4 smem4[];
  __shared__ int kmask[2][kTile];
  const int ld = a.ld, tile = kTile * ld, n_dc = a.n_dc;
  // One chunk of D: Q staged once, and a stage holds a key tile's K and V.
  // Else a stage holds a chunk of K with the heads' chunks of Q, or V.
  const bool one = n_dc == 1;
  const int stage_sz = tile * (one ? 2 : 1 + kHeads);
  T* qres = reinterpret_cast<T*>(smem4);  // kHeads tiles [row][d]
  T* ring = qres + (one ? kHeads * tile : 0);  // two stages
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int slot0 = warp / 4 * kMT, r0 = warp % 4 * 16;  // the warp's first head and rows
  const int hblocks = a.Hq / kHeads;
  const int per_tile = a.B * hblocks * a.col_blocks;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x / per_tile;  // long causal tiles first
  const int cb = blockIdx.x % per_tile % a.col_blocks;
  const int bhp = blockIdx.x % per_tile / a.col_blocks;
  const int b = bhp / hblocks, h0 = bhp % hblocks * kHeads;
  const int hk = h0 / (a.Hq / a.Hkv);
  const int q0 = qt * kTile, col0 = cb * a.cols;
  const int n_nt = min(a.cols, a.D - col0) / 8;  // O's n-tiles of this block
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h0 * a.q_sh;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  const int key_end = block_key_end<kN>(mrow, a.Sk);
  const int2 kr = key_tiles<kN>(a, mrow, key_end, q0);
  const int spt = one ? 1 : n_dc + 1;  // stages a key tile
  const int total = max(0, kr.y - kr.x) * spt;

  // stage s into ring[s % 2], its key tile's mask into kmask[key tile % 2]
  auto issue = [&](int s) {
    const int kt = kr.x + s / spt, j = s % spt;
    T* buf = ring + (s & 1) * stage_sz;
    if (one) stage_tile<kN>(buf + tile, ld, vb, a.v_ss, kt * kTile, a.Sk, col0, a.cols, a.D);
    if (j < n_dc) {
      stage_tile<kN>(buf, ld, kb, a.k_ss, kt * kTile, a.Sk, j * a.kdc, a.kdc, a.D);
      if (!one) {
        for (int i = 0; i < kHeads; ++i) {
          stage_tile<kN>(buf + (1 + i) * tile, ld, qb + i * a.q_sh, a.q_ss, q0, a.Sq, j * a.kdc,
                         a.kdc, a.D);
        }
      }
      if (j == 0) stage_row<kN>(kmask[(s / spt) & 1], mrow, kt * kTile, a.Sk);
    } else {
      stage_tile<kN>(buf, ld, vb, a.v_ss, kt * kTile, a.Sk, col0, a.cols, a.D);
    }
    cp_async_commit();
  };
  if (total > 0) {
    if (one) {
      for (int i = 0; i < kHeads; ++i) {
        stage_tile<kN>(qres + i * tile, ld, qb + i * a.q_sh, a.q_ss, q0, a.Sq, 0, a.kdc, a.D);
      }
    }
    issue(0);  // one group with Q
  }

  float m[kMT][2], l[kMT][2];
  int qpos[2], qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    qpos[i] = row + q_shift;
    qseg[i] = a.packed && row < a.Sq ? mrow[row] : 0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }
  }
  float o[kMT][kNt][4] = {};
  float s[kMT][8][4];  // S, then P: the 64 keys as 8 n-tiles
  const float scale2 = a.scale * kLog2e;

  // One barrier a stage: past it, stage st has landed for every thread, and
  // every warp is done with stage st - 1, whose buffer the next stage takes.
  for (int st = 0; st < total; ++st) {
    cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < total) issue(st + 1);
    const int j = st % spt;
    const T* buf = ring + (st & 1) * stage_sz;
    if (j < n_dc) {  // S += Q K^T over this chunk of D
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int n = 0; n < 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
        }
      }
      const T* qs = one ? qres + slot0 * tile : buf + (1 + slot0) * tile;
      for (int k0 = 0; k0 < a.kdc; k0 += kK) {
        uint32_t af[kMT][2][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) load_a<T>(af[mt], qs + mt * tile, ld, r0, k0);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t bf[2][2];
          load_b_rows<T>(bf, buf, ld, n * 8, k0);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma<T, false>(s[mt][n], af[mt], bf);
        }
      }
      if (j == n_dc - 1) {
        // the online softmax of JAX's body: fp32 max and sum in base 2
        // (s2 = s log2(e), ex2.approx); P rounded to T where it becomes P V's
        // operand. A warp whose 16 rows see all 64 keys tests no pair.
        const int key0 = (kr.x + st / spt) * kTile;
        const int* km = kmask[(st / spt) & 1];
        const int pos0 = q0 + r0 + q_shift;  // the warp's first row's position
        const bool full = __all_sync(
            0xffffffffu, !a.packed && km[lane] != 0 && km[lane + 32] != 0 &&
                             (!a.causal || key0 + kTile - 1 <= pos0) &&
                             (a.window <= 0 || key0 > pos0 + 15 - a.window));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ok = 0xffffu;  // bit 2n + e: key n * 8 + 2t + e is valid
          if (!full) {
            ok = 0;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = n * 8 + 2 * t + e;
                ok |= (uint32_t)pair_valid(a, km[key], qseg[i], key0 + key, qpos[i]) << (2 * n + e);
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            float mx = kNegInf;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = s[mt][n][2 * i + e];
                x = (ok >> (2 * n + e)) & 1u ? scale2 * x : kNegInf;
                mx = fmaxf(mx, x);
              }
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[mt][i], mx);
            const float alpha = ex2(m[mt][i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = s[mt][n][2 * i + e];
                x = (ok >> (2 * n + e)) & 1u ? ex2(x - m_new) : 0.f;
                sum += x;
              }
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[mt][i] = l[mt][i] * alpha + sum;
            m[mt][i] = m_new;
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
              o[mt][n][2 * i] *= alpha;
              o[mt][n][2 * i + 1] *= alpha;
            }
          }
        }
      }
    }
    if (j == spt - 1) {  // O += P V
      const T* vs = one ? buf + tile : buf;
#pragma unroll
      for (int kk = 0; kk < kTile / kK; ++kk) {
        uint32_t af[kMT][2][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          a_from_c<T>(af[mt], s[mt][kPerK * kk], s[mt][kPerK * kk + kPerK - 1]);
        }
        // every n-tile, past n_nt on the last staged column (never stored):
        // no branch between the tiles' loads and products
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          uint32_t bf[2][2];
          load_b_cols<T>(bf, vs, ld, kk * kK, min(n, n_nt - 1) * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma<T>(o[mt][n], af[mt], bf);
        }
      }
    }
  }

  T* out = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int h = h0 + slot0 + mt;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row >= a.Sq) continue;
      const float l_safe = l[mt][i] == 0.f ? 1.f : l[mt][i];  // no valid key: zeros
      const long long o_row = (((long long)b * a.Sq + row) * a.Hq + h) * a.D + col0;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n < n_nt) {
          out[o_row + n * 8 + 2 * t] = from_f<T>(o[mt][n][2 * i] / l_safe);
          out[o_row + n * 8 + 2 * t + 1] = from_f<T>(o[mt][n][2 * i + 1] / l_safe);
        }
      }
      if (cb == 0 && t == 0) {  // natural log; NEG_INF where no key was valid
        a.lse_out[((long long)b * a.Hq + h) * a.Sq + row] =
            l[mt][i] == 0.f ? kNegInf : m[mt][i] * kLn2 + logf(l[mt][i]);
      }
    }
  }
}

// ---- K3b (dK, dV) and K2 (with dQ in key-tile order) ----

// the end of a warp's dQ turn (K2): its lanes' stores made visible at the
// device, then one count for the warp
__device__ __forceinline__ void end_turn(int* counter, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) atomicAdd(counter, 1);
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(128) flash_dkv_generic(const GenArgs a) {
  constexpr int kN = 128, kWarps = kN / 32;
  constexpr int kK = Tc<T>::kK;
  constexpr int kNt = kDkvCols / 8;  // dK's, dV's (K2: dQ's) n-tiles a warp may hold
  constexpr int kPerK = sizeof(T) == 4 ? 1 : 2;
  extern __shared__ float4 smem4[];
  __shared__ int kmask[kTile];
  __shared__ float rows[2][3][kTile];  // a pair's lse, delta, segment ids (int)
  __shared__ int s_place;
  const int ld = a.ld, tile = kTile * ld, n_dc = a.n_dc;
  const bool kv_res = n_dc == 1;  // K and V staged once; else per chunk with Q's
  const int stage_sz = tile * (kv_res ? 2 : 4);  // Q, dO (, K, V)
  T* kres = reinterpret_cast<T*>(smem4);
  T* vres = kres + tile;
  T* ring = kres + (kv_res ? 2 * tile : 0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int k_r0 = warp * 16;  // the warp's keys in the tile (K2: its query rows of dS K)
  if constexpr (kFused) {
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
  const int n_nt = min(a.cols, a.D - col0) / 8;
  const int n_q_tiles = (a.Sq + kTile - 1) / kTile;
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the query tiles: flash_bwd.cu's kv-kernel bounds
  const int key_end = block_key_end<kN>(mrow, a.Sk);
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
    const int2 span = packed_span<kN>(mrow, a.Sk, key0, tid);
    qt_begin = max(qt_begin, span.x / kTile);
    qt_end = min(qt_end, (span.y + kTile - 1) / kTile);
  }
  const int nq = max(0, qt_end - qt_begin);
  const int spp = kv_res ? 1 : n_dc + 1;  // stages a pair: chunks, then the columns
  const int total = groups * nq * spp;
  if (tid < kTile) kmask[tid] = key0 + tid < a.Sk ? mrow[key0 + tid] : 0;

  // K2's dQ order (the header): each warp of a key tile's block counts once
  // on (batch * query head, query tile, column block) when its rows have
  // added, so turn n waits for kWarps * n counts; a tick counts, adding
  // nothing
  auto counter_of = [&](long long bh, int qt) {
    return a.sync + 1 + ((bh * n_q_tiles + qt) * a.col_blocks + cb);
  };
  auto turn_of = [&](int qt) {
    return kt - (a.window > 0 ? first_kt(qt, a.window, q_shift) : 0);
  };
  auto pass_turns = [&](int qt_from, int qt_to) {  // ticks: every head's, qt descending
    for (int qt = qt_to - 1; qt >= qt_from; --qt) {
      for (int i = 0; i < groups; ++i) {
        int* counter = counter_of((long long)b * a.Hq + h0 + i, qt);
        if (turn_of(qt) > 0) wait_turn(counter, kWarps * turn_of(qt));
        end_turn(counter, lane);
      }
    }
  };
  // a pair's (query head, query tile): K3b takes the heads in order, each
  // over its query tiles in order; K2 takes the query tiles from the last,
  // each over the group's heads, so the blocks of consecutive key tiles
  // reach a (head, query tile) at the same pair index (their extra pairs,
  // the causal diagonal's, come last) and a block waits only for the add
  // of the key tile before
  auto pair_of = [&](int pair) {
    return kFused ? make_int2(h0 + pair % groups, qt_end - 1 - pair / groups)
                  : make_int2(h0 + pair / nq, qt_begin + pair % nq);
  };

  // stage s into ring[s % 2], its pair's rows into rows[pair % 2]
  auto issue = [&](int s) {
    const int pair = s / spp, j = s % spp;
    const int h = pair_of(pair).x, q0 = pair_of(pair).y * kTile;
    const long long bh = (long long)b * a.Hq + h;
    const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = reinterpret_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    T* buf = ring + (s & 1) * stage_sz;
    if (kv_res) {
      stage_tile<kN>(buf, ld, qb, a.q_ss, q0, a.Sq, 0, a.wq, a.D);
      stage_tile<kN>(buf + tile, ld, dob, a.do_ss, q0, a.Sq, 0, a.wq, a.D);
    } else if (j < n_dc) {
      const int c0 = j * a.kdc;
      stage_tile<kN>(buf, ld, qb, a.q_ss, q0, a.Sq, c0, a.kdc, a.D);
      stage_tile<kN>(buf + tile, ld, dob, a.do_ss, q0, a.Sq, c0, a.kdc, a.D);
      stage_tile<kN>(buf + 2 * tile, ld, kb, a.k_ss, key0, a.Sk, c0, a.kdc, a.D);
      stage_tile<kN>(buf + 3 * tile, ld, vb, a.v_ss, key0, a.Sk, c0, a.kdc, a.D);
    } else {
      stage_tile<kN>(buf, ld, qb, a.q_ss, q0, a.Sq, col0, a.cols, a.D);
      stage_tile<kN>(buf + tile, ld, dob, a.do_ss, q0, a.Sq, col0, a.cols, a.D);
      if (kFused) stage_tile<kN>(buf + 2 * tile, ld, kb, a.k_ss, key0, a.Sk, col0, a.cols, a.D);
    }
    if (j == 0) {
      float* r = rows[pair & 1][0];
      stage_row<kN>(r, a.lse + bh * a.Sq, q0, a.Sq);
      stage_row<kN>(r + kTile, a.delta + bh * a.Sq, q0, a.Sq);
      if (a.packed) stage_row<kN>(reinterpret_cast<int*>(r + 2 * kTile), mrow, q0, a.Sq);
    }
    cp_async_commit();
  };
  if (total > 0) {
    if (kv_res) {
      stage_tile<kN>(kres, ld, kb, a.k_ss, key0, a.Sk, 0, a.wq, a.D);
      stage_tile<kN>(vres, ld, vb, a.v_ss, key0, a.Sk, 0, a.wq, a.D);
    }
    issue(0);  // one group with K and V
  }

  float dk[kNt][4] = {}, dv[kNt][4] = {};
  float sT[8][4], dpT[8][4];  // S^T then P^T, dP^T then dS^T: 64 query rows as 8 n-tiles
  const float scale2 = a.scale * kLog2e;

  // one barrier a stage, as K1's
  for (int st = 0; st < total; ++st) {
    cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < total) issue(st + 1);
    const int pair = st / spp, j = st % spp;
    const T* buf = ring + (st & 1) * stage_sz;
    if (j < n_dc) {  // S^T = K Q^T and dP^T = V dO^T over this chunk of D
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
        }
      }
      const T* ks = kv_res ? kres : buf + 2 * tile;
      const T* vs = kv_res ? vres : buf + 3 * tile;
      auto product = [&](auto fresh) {
        for (int k0 = 0; k0 < a.kdc; k0 += kK) {
          uint32_t ak[2][4], av[2][4];
          load_a<T>(ak, ks, ld, k_r0, k0);
          load_a<T>(av, vs, ld, k_r0, k0);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t bf[2][2];
            load_b_rows<T>(bf, buf, ld, n * 8, k0);
            mma<T, decltype(fresh)::value>(sT[n], ak, bf);
            load_b_rows<T>(bf, buf + tile, ld, n * 8, k0);
            mma<T, decltype(fresh)::value>(dpT[n], av, bf);
          }
        }
      };
      // S^T and dP^T summed in the accumulator where D is one chunk of at
      // most 64 (24 mma a sum), else by fp32 adds: dS takes dP - delta,
      // where the accumulator's drift would not cancel
      if (kv_res && a.kdc <= 64) {
        product(std::false_type());
      } else {
        product(std::true_type());
      }
      if (j == n_dc - 1) {  // P^T and dS^T, in fp32 (rounded to T as operands)
        // p = 2^(s scale log2(e) - lse log2(e)) by ex2.approx, 0 on a row
        // with lse = NEG_INF; a warp whose 16 keys and the tile's 64 rows make
        // only valid pairs tests no pair
        const int q0 = pair_of(pair).y * kTile;
        const float* lse = rows[pair & 1][0];
        const float* delta = rows[pair & 1][1];
        const int* qseg = reinterpret_cast<const int*>(rows[pair & 1][2]);
        const int kpos0 = key0 + k_r0;  // the warp's first key
        const bool full = __all_sync(
            0xffffffffu, !a.packed && q0 + kTile <= a.Sq && kmask[k_r0 + (lane & 15)] != 0 &&
                             (!a.causal || kpos0 + 15 <= q0 + q_shift) &&
                             (a.window <= 0 || kpos0 > q0 + kTile - 1 + q_shift - a.window));
        uint32_t ok = ~0u;  // bit 4n + 2e + i: (key g + 8i, row 8n + 2t + e) is valid
        if (!full) {
          ok = 0;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = n * 8 + 2 * t + e, row = q0 + r;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int key = k_r0 + g + 8 * i;
                ok |= (uint32_t)(row < a.Sq && pair_valid(a, kmask[key], a.packed ? qseg[r] : 0,
                                                          key0 + key, row + q_shift))
                      << (4 * n + 2 * e + i);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = n * 8 + 2 * t + e;
            const float lse2 = lse[r] * kLog2e, dlt = delta[r];
            const bool row_ok = lse[r] > 0.5f * kNegInf;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const bool valid = row_ok && ((ok >> (4 * n + 2 * e + i)) & 1u);
              const float p = valid ? ex2(scale2 * sT[n][2 * i + e] - lse2) : 0.f;
              dpT[n][2 * i + e] = p * (dpT[n][2 * i + e] - dlt) * a.scale;
              sT[n][2 * i + e] = p;
            }
          }
        }
      }
    }
    if (j == spp - 1) {  // dV += P^T dO, dK += dS^T Q over this block's columns
      const T* qc = kv_res ? buf + col0 : buf;
      const T* doc = qc + tile;
#pragma unroll
      for (int kk = 0; kk < kTile / kK; ++kk) {
        uint32_t ap[2][4], ads[2][4];
        a_from_c<T>(ap, sT[kPerK * kk], sT[kPerK * kk + kPerK - 1]);
        a_from_c<T>(ads, dpT[kPerK * kk], dpT[kPerK * kk + kPerK - 1]);
#pragma unroll
        for (int n = 0; n < kNt; ++n) {  // as K1's P V: no branch
          const int c = min(n, n_nt - 1) * 8;
          uint32_t bf[2][2];
          load_b_cols<T>(bf, doc, ld, kk * kK, c);
          mma<T>(dv[n], ap, bf);
          load_b_cols<T>(bf, qc, ld, kk * kK, c);
          mma<T>(dk[n], ads, bf);
        }
      }
      if constexpr (kFused) {  // dQ = dS K, added on the pair's turn
        const int qt = pair_of(pair).y;
        const long long bh = (long long)b * a.Hq + pair_of(pair).x;
        // dS (rounded to T) from the C fragments into the stage's Q tile as
        // [query row][key], once every warp is done with Q; fp32: each 8
        // keys in the order a_from_c gives A's k (key 2c at column c, key 2c
        // + 1 at column c + 4), the order load_b_cols takes K's rows in
        T* ds = ring + (st & 1) * stage_sz;
        const int kc0 = sizeof(T) == 4 ? (g & 1) * 4 + g / 2 : g;
        __syncthreads();
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              ds[(n * 8 + 2 * t + e) * ld + k_r0 + 8 * i + kc0] = from_f<T>(dpT[n][2 * i + e]);
            }
          }
        }
        __syncthreads();
        // on the pair's turn, the warp's rows of the fp32 dQ buffer come
        // through L2 while it takes its 16 query rows by the block's columns
        // over the 64 keys (a short sum of 8 or 4 k-steps, kept in the
        // accumulator); the first turn adds to zeros
        if (a.packed && pair == 0) pass_turns(qt_end, turn_end);
        int* counter = counter_of(bh, qt);
        const int turn = turn_of(qt);
        if (turn > 0) wait_turn(counter, kWarps * turn);
        float* dst = reinterpret_cast<float*>(a.dq) + (bh * a.Sq + qt * kTile + k_r0) * a.D + col0;
        float2 old[2][kNt];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            const bool in = turn > 0 && n < n_nt && qt * kTile + k_r0 + g + 8 * i < a.Sq;
            old[i][n] = in ? __ldcg(reinterpret_cast<const float2*>(
                                 dst + (long long)(g + 8 * i) * a.D + n * 8 + 2 * t))
                           : make_float2(0.f, 0.f);
          }
        }
        const T* kc = kv_res ? kres + col0 : buf + 2 * tile;
        float dq[kNt][4] = {};
#pragma unroll
        for (int kk = 0; kk < kTile / kK; ++kk) {
          uint32_t af[2][4];
          load_a<T>(af, ds, ld, k_r0, kk * kK);
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            uint32_t bf[2][2];
            load_b_cols<T>(bf, kc, ld, kk * kK, min(n, n_nt - 1) * 8);
            mma<T, false>(dq[n], af, bf);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (qt * kTile + k_r0 + g + 8 * i >= a.Sq) continue;
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            if (n >= n_nt) continue;
            const float2 x = make_float2(old[i][n].x + dq[n][2 * i], old[i][n].y + dq[n][2 * i + 1]);
            __stcg(reinterpret_cast<float2*>(dst + (long long)(g + 8 * i) * a.D + n * 8 + 2 * t), x);
          }
        }
        end_turn(counter, lane);
        if (a.packed && pair == groups * nq - 1) pass_turns(turn_begin, qt_begin);
      }
    }
  }
  if constexpr (kFused) {
    if (a.packed && nq == 0) pass_turns(turn_begin, turn_end);  // no pair ran: every turn a tick
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + k_r0 + g + 8 * i;
    if (key >= a.Sk) continue;
    const long long o_row = (((long long)b * a.Sk + key) * a.Hkv + hk) * a.D + col0;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n >= n_nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long c = o_row + n * 8 + 2 * t + e;
        if (a.f32_out) {
          reinterpret_cast<float*>(a.dk)[c] = dk[n][2 * i + e];
          reinterpret_cast<float*>(a.dv)[c] = dv[n][2 * i + e];
        } else {
          reinterpret_cast<T*>(a.dk)[c] = from_f<T>(dk[n][2 * i + e]);
          reinterpret_cast<T*>(a.dv)[c] = from_f<T>(dv[n][2 * i + e]);
        }
      }
    }
  }
}

// ---- K3a: dQ ----

// K1's layout with one query head a block: S = Q K^T and dP = dO V^T, then
// dS = p (dP - delta) scale in place over dP's registers, then dQ += dS K
// with dS's C fragments as the A operand; dQ stays in fragments over the
// key tiles and is written once.
template <typename T>
__global__ void __launch_bounds__(128, 2) flash_dq_generic(const GenArgs a) {
  constexpr int kN = 128;
  constexpr int kK = Tc<T>::kK;
  constexpr int kNt = Tc<T>::kFwdCols / 8;  // dQ's n-tiles a warp may hold
  constexpr int kPerK = sizeof(T) == 4 ? 1 : 2;  // dS's n-tiles per k of dS K
  extern __shared__ float4 smem4[];
  __shared__ int kmask[2][kTile];
  const int ld = a.ld, tile = kTile * ld, n_dc = a.n_dc;
  // One chunk of D: Q and dO staged once, and a stage holds a key tile's K
  // (S's chunk and every block's columns) and V. Else a stage holds a chunk
  // of K, V, Q and dO, or K's columns of this block.
  const bool one = n_dc == 1;
  const int stage_sz = tile * (one ? 2 : 4);
  T* qres = reinterpret_cast<T*>(smem4);
  T* dores = qres + tile;
  T* ring = qres + (one ? 2 * tile : 0);  // two stages
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int per_tile = a.B * a.Hq * a.col_blocks;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x / per_tile;  // long causal tiles first
  const int cb = blockIdx.x % per_tile % a.col_blocks;
  const int bh = blockIdx.x % per_tile / a.col_blocks;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kTile, col0 = cb * a.cols;
  const int n_nt = min(a.cols, a.D - col0) / 8;  // dQ's n-tiles of this block
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dob = reinterpret_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = reinterpret_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  const int key_end = block_key_end<kN>(mrow, a.Sk);
  const int2 kr = key_tiles<kN>(a, mrow, key_end, q0);
  const int spt = one ? 1 : n_dc + 1;  // stages a key tile
  const int total = max(0, kr.y - kr.x) * spt;

  // stage s into ring[s % 2], its key tile's mask into kmask[key tile % 2]
  auto issue = [&](int s) {
    const int kt = kr.x + s / spt, j = s % spt;
    T* buf = ring + (s & 1) * stage_sz;
    if (one) {
      stage_tile<kN>(buf, ld, kb, a.k_ss, kt * kTile, a.Sk, 0, a.wq, a.D);
      stage_tile<kN>(buf + tile, ld, vb, a.v_ss, kt * kTile, a.Sk, 0, a.kdc, a.D);
    } else if (j < n_dc) {
      const int c0 = j * a.kdc;
      stage_tile<kN>(buf, ld, kb, a.k_ss, kt * kTile, a.Sk, c0, a.kdc, a.D);
      stage_tile<kN>(buf + tile, ld, vb, a.v_ss, kt * kTile, a.Sk, c0, a.kdc, a.D);
      stage_tile<kN>(buf + 2 * tile, ld, qb, a.q_ss, q0, a.Sq, c0, a.kdc, a.D);
      stage_tile<kN>(buf + 3 * tile, ld, dob, a.do_ss, q0, a.Sq, c0, a.kdc, a.D);
    } else {
      stage_tile<kN>(buf, ld, kb, a.k_ss, kt * kTile, a.Sk, col0, a.cols, a.D);
    }
    if (j == 0) stage_row<kN>(kmask[(s / spt) & 1], mrow, kt * kTile, a.Sk);
    cp_async_commit();
  };
  if (total > 0) {
    if (one) {
      stage_tile<kN>(qres, ld, qb, a.q_ss, q0, a.Sq, 0, a.kdc, a.D);
      stage_tile<kN>(dores, ld, dob, a.do_ss, q0, a.Sq, 0, a.kdc, a.D);
    }
    issue(0);  // one group with Q and dO
  }

  // the thread's rows g and g + 8: lse in base 2 (NEG_INF past Sq), delta
  float lse2[2], dlt[2];
  int qpos[2], qseg[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < a.Sq;
    const float lse = in ? a.lse[(long long)bh * a.Sq + row] : kNegInf;
    row_ok[i] = lse > 0.5f * kNegInf;
    lse2[i] = lse * kLog2e;
    dlt[i] = in ? a.delta[(long long)bh * a.Sq + row] : 0.f;
    qpos[i] = row + q_shift;
    qseg[i] = a.packed && in ? mrow[row] : 0;
  }
  float dq[kNt][4] = {};
  float s[8][4], dp[8][4];  // S then P, dP then dS: the 64 keys as 8 n-tiles
  const float scale2 = a.scale * kLog2e;

  // one barrier a stage, as K1's
  for (int st = 0; st < total; ++st) {
    cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < total) issue(st + 1);
    const int j = st % spt;
    const T* buf = ring + (st & 1) * stage_sz;
    if (j < n_dc) {  // S += Q K^T and dP += dO V^T over this chunk of D
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
      }
      const T* qs = one ? qres : buf + 2 * tile;
      const T* dos = one ? dores : buf + 3 * tile;
      auto product = [&](auto fresh) {
        for (int k0 = 0; k0 < a.kdc; k0 += kK) {
          uint32_t aq[2][4], ad[2][4];
          load_a<T>(aq, qs, ld, r0, k0);
          load_a<T>(ad, dos, ld, r0, k0);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t bf[2][2];
            load_b_rows<T>(bf, buf, ld, n * 8, k0);
            mma<T, decltype(fresh)::value>(s[n], aq, bf);
            load_b_rows<T>(bf, buf + tile, ld, n * 8, k0);
            mma<T, decltype(fresh)::value>(dp[n], ad, bf);
          }
        }
      };
      // as K3b's S^T and dP^T: in the accumulator where D is one chunk of
      // at most 64, else by fp32 adds
      if (one && a.kdc <= 64) {
        product(std::false_type());
      } else {
        product(std::true_type());
      }
      if (j == n_dc - 1) {
        // p = 2^(s scale log2(e) - lse log2(e)) by ex2.approx on the valid
        // pairs of rows with a finite lse, dS = p (dP - delta) scale over dP
        // (rounded to T where it becomes dS K's operand); a warp whose 16
        // rows see all 64 keys tests no pair
        const int key0 = (kr.x + st / spt) * kTile;
        const int* km = kmask[(st / spt) & 1];
        const int pos0 = q0 + r0 + q_shift;  // the warp's first row's position
        const bool full = __all_sync(
            0xffffffffu, !a.packed && km[lane] != 0 && km[lane + 32] != 0 &&
                             (!a.causal || key0 + kTile - 1 <= pos0) &&
                             (a.window <= 0 || key0 > pos0 + 15 - a.window));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ok = 0xffffu;  // bit 2n + e: key n * 8 + 2t + e is valid
          if (!full) {
            ok = 0;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = n * 8 + 2 * t + e;
                ok |= (uint32_t)pair_valid(a, km[key], qseg[i], key0 + key, qpos[i]) << (2 * n + e);
              }
            }
          }
          if (!row_ok[i]) ok = 0;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = (ok >> (2 * n + e)) & 1u ? ex2(scale2 * s[n][2 * i + e] - lse2[i])
                                                       : 0.f;
              dp[n][2 * i + e] = p * (dp[n][2 * i + e] - dlt[i]) * a.scale;
            }
          }
        }
      }
    }
    if (j == spt - 1) {  // dQ += dS K over this block's columns
      const T* kc = one ? buf + col0 : buf;
#pragma unroll
      for (int kk = 0; kk < kTile / kK; ++kk) {
        uint32_t af[2][4];
        a_from_c<T>(af, dp[kPerK * kk], dp[kPerK * kk + kPerK - 1]);
        // every n-tile, past n_nt on the last staged column (never stored),
        // as K1's P V
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          uint32_t bf[2][2];
          load_b_cols<T>(bf, kc, ld, kk * kK, min(n, n_nt - 1) * 8);
          mma<T>(dq[n], af, bf);
        }
      }
    }
  }

  T* out = reinterpret_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= a.Sq) continue;
    const long long o_row = (((long long)b * a.Sq + row) * a.Hq + h) * a.D + col0;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n < n_nt) {
        out[o_row + n * 8 + 2 * t] = from_f<T>(dq[n][2 * i]);
        out[o_row + n * 8 + 2 * t + 1] = from_f<T>(dq[n][2 * i + 1]);
      }
    }
  }
}

// ---- launches ----

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A kernel's plan with D contracted in chunks of at most `chunk` columns: D
// in the fewest chunks (n_dc, each kdc wide, a multiple of mma's k); the
// output columns in the fewest blocks of at most kFwdCols (K1's O, K3a's dQ)
// or kDkvCols (K3b's and K2's dK/dV, K2's dQ) (cols, a multiple of 8; K2's
// `sync` counters assume at most one block per 64 columns); where one chunk
// covers D, the width staged for it and for every block's columns (wq); the
// staged row stride, padded by 16 bytes to an odd number of 16-byte units
// (ld), at least 64 in K2, whose dS tile of 64 keys takes a stage's Q tile.
// Returns the dynamic shared memory: K1, kHeads resident Q tiles (one
// chunk) and two stages of a K or V tile (with kHeads Q tiles past one
// chunk); K3a, resident Q and dO (one chunk) and two stages of K and V (with
// Q and dO past one chunk, or K's columns); K3b and K2, resident K and V
// (one chunk) and two stages of Q and dO (with K and V past one chunk; K2's
// column stage also K's columns).
template <typename T>
long long plan_chunks(Which w, int heads, int chunk, GenArgs& a) {
  constexpr int kK = Tc<T>::kK;
  a.n_dc = (a.D + chunk - 1) / chunk;
  a.kdc = round_up((a.D + a.n_dc - 1) / a.n_dc, kK);
  const int max_cols = w == kFwd || w == kDq ? Tc<T>::kFwdCols : kDkvCols;
  a.col_blocks = (a.D + max_cols - 1) / max_cols;
  a.cols = round_up((a.D + a.col_blocks - 1) / a.col_blocks, 8);
  a.wq = a.n_dc == 1 ? round_up(max(a.kdc, a.col_blocks * a.cols), kK) : a.kdc;
  const int width = max(max(a.wq, a.cols), w == kFused ? kTile : 0);
  a.ld = round_up(width, sizeof(T) == 4 ? 8 : 16) + 16 / (int)sizeof(T);
  const long long tile = (long long)kTile * a.ld * sizeof(T);
  const bool one = a.n_dc == 1;
  if (w == kFwd) return (one ? heads : 0) * tile + 2 * (one ? 2 : 1 + heads) * tile;
  return (one ? 2 : 0) * tile + 2 * (one ? 2 : 4) * tile;
}

// the widest chunk (kDChunk, halved) whose plan fits the shared memory
// beside the kernels' static arrays (under 2 KB)
template <typename T>
long long plan_tc(Which w, int heads, GenArgs& a) {
  long long smem = 0;
  for (int chunk = kDChunk; chunk >= Tc<T>::kK; chunk /= 2) {
    smem = plan_chunks<T>(w, heads, chunk, a);
    if (smem <= kSmemCap - 1024) break;
  }
  return smem;
}

template <typename K>
int launch(K kernel, long long grid, int threads, long long smem, const GenArgs& a,
           cudaStream_t st) {
  if (grid <= 0 || grid > 0x7fffffffLL || smem > kSmemCap) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(Which w, GenArgs a, cudaStream_t st) {
  const long long q_tiles = (a.Sq + kTile - 1) / kTile, k_tiles = (a.Sk + kTile - 1) / kTile;
  switch (w) {
    case kFwd: {  // two query heads a block where the GQA group is even
      const int heads = a.Hq / a.Hkv % 2 == 0 ? 2 : 1;
      const long long smem = plan_tc<T>(w, heads, a);
      const long long grid = q_tiles * a.B * (a.Hq / heads) * a.col_blocks;
      return heads == 2
                 ? launch(flash_fwd_generic<T, 2>, grid, FwdShape<T, 2>::kThreadsN, smem, a, st)
                 : launch(flash_fwd_generic<T, 1>, grid, FwdShape<T, 1>::kThreadsN, smem, a, st);
    }
    case kDq: {
      const long long smem = plan_tc<T>(w, 1, a);
      return launch(flash_dq_generic<T>, q_tiles * a.B * a.Hq * a.col_blocks, 128, smem, a, st);
    }
    default: {  // kDkv, kFused
      const long long smem = plan_tc<T>(w, 1, a);
      const long long grid = k_tiles * a.B * a.Hkv * a.col_blocks;
      return w == kFused ? launch(flash_dkv_generic<T, true>, grid, 128, smem, a, st)
                         : launch(flash_dkv_generic<T, false>, grid, 128, smem, a, st);
    }
  }
}

}  // namespace

namespace rankpo_gen {

int RANKPO_GEN_NAME(Which w, const GenArgs& a, cudaStream_t st) {
  return dispatch<RANKPO_GEN_T>(w, a, st);
}

}  // namespace rankpo_gen

#else  // the entry points

namespace {

using namespace rankpo_gen;

int run(Which w, GenArgs& a, int dtype, void* stream) {
  const bool ok = a.B > 0 && a.Sq > 0 && a.Sk > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0 &&
                  a.D > 0 && a.D % 8 == 0 && (!a.packed || a.Sq == a.Sk) &&
                  (a.window <= 0 || a.causal);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)a.D));
  a.window = a.window > 0 ? a.window : -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_f32(w, a, st);
    case kF16: return dispatch_f16(w, a, st);
    case kBF16: return dispatch_bf16(w, a, st);
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
// column blocks plan_chunks makes). packed: mask holds segment ids (Sq == Sk).
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

#endif  // RANKPO_GEN_T
