// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of rankpo_tpu/ops/flash_attention.py:
//   _bwd_fused_kernel (flash_bwd_fused)  -> flash_bwd_kv_wgmma<D, true>
//   _dkv_kernel       (flash_dkv)        -> flash_bwd_kv_wgmma<D, false>
//                                           (bf16 dK/dV; with kF32Out fp32,
//                                           JAX flash_dkv's output dtype)
//   _dq_kernel        (flash_dq)         -> flash_bwd_dq_wgmma<D>
//
// Contract (what the Pallas kernels compute), with the forward's contract
// from flash_fwd.cu (layouts, strides, mask, bottom-right causal, GQA):
//   do [B, Sq, Hq, D] bf16 (strided); lse, delta [B, Hq, Sq] fp32, where
//   lse comes from the forward and delta = rowsum(dO * O) in fp32.
//   s = scale * q.k in fp32; p = exp(s - lse) on valid entries, 0 elsewhere;
//   dV += P^T dO with P rounded to bf16; dP = dO V^T;
//   dS = p * (dP - delta) * scale, rounded to bf16; dK += dS^T Q; dQ += dS K.
//   The fused kernel adds dQ in fp32 into a zeroed [B, Hq, Sq, D] buffer in
//   key-tile order (below); the dq kernel writes dQ as bf16 [B, Sq, Hq, D].
//   The kv kernel writes dK/dV as bf16 [B, Sk, Hkv, D], each GQA group
//   summed in fp32 registers; its kF32Out build (unwindowed, unpacked: the
//   ring attention's steps, parallel/ring_attention.py) writes the fp32
//   registers as they are, so a caller that sums partials over ring steps
//   rounds once, as JAX's fp32 flash_dkv lets it.
//   window (> 0, with causal; -1 = none): the forward's sliding window, row r
//   sees keys with k_pos > q_pos - window.
//   Loop bounds are the forward's: keys end one past the last valid key;
//   causal tiles above the diagonal are skipped; with a window, tiles below
//   the band are skipped (the dq kernel starts at the first key tile inside
//   the band of its query tile's first row, the kv kernel ends at the last
//   query tile whose rows reach its keys); with skip_pad_q a query tile the
//   forward skipped (it starts at or past the valid key extent) is skipped
//   here too, so its rows give zero dQ and add nothing to dK/dV.
//   Packed (kPacked; Sq == Sk): the mask row carries segment ids; a pair is
//   valid when the key's segment is non-zero and equal to the query row's,
//   ANDed with the tests above, and the tiles run are bounded to the span of
//   the block's tile's segments (packed_span in flash_common.cuh): the dq
//   kernel's key tiles as K1's, the kv kernel's query tiles as JAX's
//   flash_attention.py:314-328. Every output repeats bit for bit from
//   launch to launch.
//
// dQ in key-tile order. Blocks on Hopper run in parallel and in no order, so
// the Pallas fused kernel's dq block, resident across the sequential key
// axis, has no counterpart. The loop bounds make the key tiles that reach a
// query tile a range f, f + 1, ..., N - 1 (f = 0 without a window, else
// first_kt below), so key tile n is the (n - f)-th to add. Each
// (batch * q-head, 64-row query tile) has an int32 counter in a zeroed `sync`
// buffer; the adders of key tile n wait (acquire) until the counter says
// tiles f .. n - 1 have added, add with plain loads and stores through L2
// (tile f adds to zeros), fence and count themselves. sync[0] hands out the
// blocks' places in the order they start, key tile slowest, so a block waits
// only on blocks that started before it. dQ is then summed in key order, as
// in JAX.
//   Packed, the key tiles that add to a query tile are fewer: those whose
// segments meet the query tile's. The counters keep counting the unpacked
// range all the same: for each (head, query tile) of its unpacked range
// that its packed span leaves out, the dQ adder of a block takes its turn
// and passes it on without adding (a tick). So the turn a block waits for
// is still kt - f, whatever the segment layout, and no block can wait on a
// key tile that never counts. A query tile's first real adder adds to the
// zeros of the buffer.
//
// Design of the kv kernel. One block per (batch, kv head, 64-key tile), 160
// threads (192 fused):
//   - warp 4, the producer, loads the block's K and V tiles once by TMA
//     (4-D tensor maps over the caller's strides, 128-byte swizzle), then
//     streams the Q and dO tiles of every query head of the GQA group and
//     every query tile inside the forward's bounds through a 2-stage
//     mbarrier ring (3 stages for K3b, 2 for K2); its lanes post each
//     tile's lse and delta rows;
//   - warps 0-3, one consumer warpgroup, hold S^T for the block's 64 keys
//     against 64 queries: S^T = K Q^T and dP^T = V dO^T by wgmma SS; P^T and
//     dS^T in registers; dV += P^T dO and dK += dS^T Q by wgmma RS (dO and Q
//     the MN-major transposed-B operand, K1's P V form); fused, dS^T staged
//     as bf16 in shared memory (two buffers) and dQ = dS K by wgmma SS with
//     both operands transposed. dK and dV accumulate over the whole group in
//     fp32 registers and are written once;
//   - warp 5 (fused), the dQ adder, takes each dQ tile from shared memory
//     (two fp32 buffers) and adds it to the fp32 buffer in key-tile order,
//     off the consumers' path;
//   - packed: the producer's lanes also post each query tile's 64 segment
//     ids beside its lse and delta rows.
// At D 128 fp32 dK, dV and (fused) dQ exceed one warpgroup's registers and
// ptxas spills K2 (PERF.md has the times).
//
// The kv kernel at D 256 (Gemma). fp32 dK and dV of 64 keys at D 256 are
// 2 x 64 x 256 / 128 = 256 registers a consumer thread, which one warpgroup
// cannot hold. So two blocks share each key tile, one per 128-column half
// of dK, dV and (fused) dQ (KvTiles::kCols, kSplit; the grid's x is
// batch x kv head x half): each block's registers are D 128's. S^T = K Q^T
// and dP^T = V dO^T contract over all 256 columns, so both blocks load the
// whole K, V, Q and dO tiles and compute P^T and dS^T, and each runs dV, dK
// (and dQ) over its own columns: 1.5x the products of one block owning all
// columns (1.4x fused), and twice the tile loads, for no exchange between
// warpgroups and no setmaxnreg. Shared memory: K and V resident (64 KB), the
// Q/dO ring at 64 KB a stage: 2 stages for K3b (193 KB); 1 for K2, beside
// its two dS^T tiles (16 KB) and two fp32 dQ tiles of 64 x (128 + 8) (68
// KB), 213 KB. K2's dQ order is kept per half: each (batch * q-head, query
// tile, half) has its own counter, so each column of dQ is still summed in
// key-tile order and K2 repeats bit for bit. Left (ROADMAP Queue 2): one
// block of two consumer warpgroups sharing the tile loads and S^T/dP^T.
//
// Design of the dq kernel: K1's (flash_fwd.cu) with a third product. One
// block per (batch, query head, 64-row query tile), 160 threads. Warp 4, the
// producer, loads the Q and dO tiles once, then streams the K/V tiles inside
// the forward's bounds through a TMA mbarrier ring, posting each tile's 64
// key-validity bits in its stage. Warps 0-3, one consumer warpgroup, compute
// per key tile S = Q K^T and dP = dO V^T by wgmma SS (K-major), P and dS in
// registers (mask and causal tests only on tiles that need them), and
// dQ += dS K by wgmma RS, with dS (the S accumulator layout packed to bf16)
// as the A registers and K, read from the same swizzled stage, as the
// MN-major transposed-B operand (K1's P V form). dQ stays in fp32 registers
// across the key tiles and is written once as bf16: no atomics. Unlike K1,
// a block serves one query head: with two (K/V loaded once for both, as
// K1), dQ, S and dP (96 fp32 registers at D 64) spilled under the
// two-blocks-per-SM bound of 288-thread blocks and the kernel ran 1.2-1.4x
// slower (PERF.md, PR 7).
// At D 256 the same code: dQ is 128 fp32 registers a thread, S and dP 32
// each, and the Q and dO tiles (32 KB each) and a 2-stage K/V ring (128 KB)
// take 193 KB of shared memory.
//
// What bounds them on this card. At the training shapes (S <= 512, D = 64)
// a tile pair costs 5 (fused), 4 (dkv) or 3 (dq) 64 x 64 x 64 products; the
// kernels are bound by the latency of each block's chain of tile pairs (a
// kv block runs up to groups x 8 of them, a dq block up to 8), not by HBM
// bytes or the tensor-core peak. The causal and valid-length bounds remove
// whole tiles, which on right-padded batches is most of the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The file builds as four objects that nvcc compiles side by side:
// flash_bwd_d64.cu, flash_bwd_d128.cu and flash_bwd_d256.cu include it with
// RANKPO_BWD_D set, each holding that head dim's kernels behind
// dispatch_d<D>; compiled as itself it holds the C entry points, which pick
// the object by D.
namespace rankpo_bwd {

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* mask;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  float* dq_acc;          // fused: fp32 [B*Hq, Sq, D], zeroed by the caller
  __nv_bfloat16* dq;      // dq kernel: bf16 [B, Sq, Hq, D]
  __nv_bfloat16* dk;      // kv kernel: bf16 [B, Sk, Hkv, D]
  __nv_bfloat16* dv;
  float* dk_f32;          // kv kernel, kF32Out: fp32 [B, Sk, Hkv, D]
  float* dv_f32;
  int* sync;              // fused: zeroed int32 [1 + B*Hq * q tiles]
  int Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, mask_sb;
  float scale;
  int causal, skip_pad_q;
  int window;  // > 0 with causal, else -1
};

enum Which { kFused, kDkv, kDq, kDkvF32 };

int dispatch_d64(Which which, const BwdArgs& a, int B, int packed, cudaStream_t st);
int dispatch_d128(Which which, const BwdArgs& a, int B, int packed, cudaStream_t st);
int dispatch_d256(Which which, const BwdArgs& a, int B, int packed, cudaStream_t st);

}  // namespace rankpo_bwd

#ifdef RANKPO_BWD_D

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace rankpo_bwd;

// ---- dQ summed in key-tile order (the header): the counter of a query tile
// counts the key tiles that added (the dQ adder warp of each block) ----

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void wait_turn(const int* counter, int target) {
  while (ld_acquire(counter) < target) __nanosleep(32);
}

// each lane's stores made visible at the device, then one count per warp
__device__ __forceinline__ void end_turn(int* counter, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) atomicAdd(counter, 1);
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

// ---- the kv kernel: K3b, and K2 with its dq ----

template <int D, bool kFusedDq>
struct KvTiles {
  static constexpr int kAtoms = D / 64;  // 64-column swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kSwizzleTileBytes;  // 64 rows
  // the dK/dV (and dQ) columns a block owns: at D 256 two blocks share a
  // key tile, one 128-column half each (the header)
  static constexpr int kCols = D == 256 ? 128 : D;
  static constexpr int kSplit = D / kCols;
  // Q/dO ring: 3 stages keep K3b 6% ahead of 2; K2 needs its shared memory
  // for the dS and dQ buffers (2 blocks per SM at D 64). At D 256 a stage
  // is 64 KB: 2 for K3b, 1 for K2 beside its two 34 KB dQ buffers
  static constexpr int kStages = D == 256 ? (kFusedDq ? 1 : 2) : (kFusedDq ? 2 : 3);
  static constexpr int kDqLd = kCols + 8;  // fp32 row stride of a staged dQ tile
  static constexpr int kDqBytes = kTile * kDqLd * 4;
};

// warps 0-3: the consumer warpgroup; warp 4: the producer; warp 5
// (fused): the dQ adder
template <bool kFusedDq>
constexpr int kKvThreads = kFusedDq ? 192 : 160;

// acc (+)= A B^T over D, A and B [64, D] K-major tiles (S^T = K Q^T,
// dP^T = V dO^T); issue only, the caller fences, commits and waits
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], const unsigned char* At,
                                         const unsigned char* Bt) {
  const uint64_t da = sw128_desc(At), db = sw128_desc(Bt);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSwizzleTileBytes + (kk % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_add(da, off), desc_add(db, off), kk > 0);
  }
}

// acc += X B over 64: X as bf16 A registers x[4 kk .. 4 kk + 4) for rows
// 16 kk .. 16 kk + 15 of B, B a [64, D] tile read MN-major (dV += P^T dO,
// dK += dS^T Q)
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&x)[16],
                                         const unsigned char* Bt) {
  const uint64_t db = sw128_desc(Bt);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int a = 0; a < D / 64; ++a) {
      wgmma_m64n64k16_rs_tb(&acc[32 * a], &x[4 * kk],
                            desc_add(db, a * kSwizzleTileBytes + kk * 16 * 128));
    }
  }
}

// acc = X^T B over 64: X a [64, 64] tile and B a [64, D] tile, both read
// MN-major (dQ = dS K from the staged dS^T and the K tile)
template <int D>
__device__ __forceinline__ void issue_tt(float (&acc)[D / 2], const unsigned char* Xt,
                                         const unsigned char* Bt) {
  const uint64_t dx = sw128_desc(Xt), db = sw128_desc(Bt);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int a = 0; a < D / 64; ++a) {
      wgmma_m64n64k16_ss_tt(&acc[32 * a], desc_add(dx, kk * 16 * 128),
                            desc_add(db, a * kSwizzleTileBytes + kk * 16 * 128), kk > 0);
    }
  }
}

// One block per (batch, kv head, 64-key tile), the key tile slowest; see the
// header for the roles of its warps. kWindow: built with the window's bounds
// and tests (window > 0, causal), and kPacked with the segments' (the mask
// row holds segment ids), so the kernel without them is unchanged.
// kF32Out (K3b only): dK/dV written in fp32.
template <int D, bool kFusedDq, bool kWindow, bool kPacked, bool kF32Out = false>
__global__ void __launch_bounds__(kKvThreads<kFusedDq>, D == 64 ? 2 : 1)
flash_bwd_kv_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  using T = KvTiles<D, kFusedDq>;
  constexpr int kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes;
  constexpr int kThreads = kKvThreads<kFusedDq>;

  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the swizzle period)
  unsigned char* Ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Vs = Ks + kTileBytes;
  unsigned char* Qs = Vs + kTileBytes;              // [kStages] tiles
  unsigned char* dOs = Qs + kStages * kTileBytes;   // [kStages] tiles
  unsigned char* dSs = dOs + kStages * kTileBytes;  // fused: [2] dS^T tiles,
  float* dQs = reinterpret_cast<float*>(dSs + 2 * kSwizzleTileBytes);  // [2] dQ
  // packed: the query segment ids of each stage's tile, after the fused
  // buffers (or where they would start)
  int* qseg_s = reinterpret_cast<int*>(
      kFusedDq ? reinterpret_cast<unsigned char*>(dQs + 2 * kTile * T::kDqLd) : dSs);
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages], kv_bar;
  __shared__ uint64_t dq_full[2], dq_empty[2];
  __shared__ float lse_s[kStages][kTile], delta_s[kStages][kTile];
  __shared__ int warp_end[kThreads / 32];
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    if (kFusedDq) s_ticket = atomicAdd(a.sync, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 32);  // every producer lane (lse/delta rows)
      mbar_init(&empty_bar[s], 4);  // lane 0 of every consumer warp
    }
    mbar_init(&kv_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&dq_full[s], 128);  // every consumer thread
      mbar_init(&dq_empty[s], 1);   // lane 0 of the dQ adder
    }
    fence_barrier_init();
  }
  __syncthreads();
  // fused: blocks take (batch * kv head, column half, key tile) in the
  // order they start, key tile slowest, so the key tiles before this one
  // have started
  const int place = kFusedDq ? s_ticket : blockIdx.y * gridDim.x + blockIdx.x;
  const int half = (place % gridDim.x) % T::kSplit;  // 0 but at D 256
  const int bhk = (place % gridDim.x) / T::kSplit;
  const int kt = place / gridDim.x;
  const int col0 = half * T::kCols;  // this block's first dK/dV/dQ column
  const int b = bhk / a.Hkv;
  const int hk = bhk % a.Hkv;
  const int groups = a.Hq / a.Hkv;
  const int h0 = hk * groups;
  const int key0 = kt * kTile;
  const int q_shift = a.Sk - a.Sq;
  const int* mrow = a.mask + (long long)b * a.mask_sb;

  // one past the last valid key, reduced over the block with one barrier
  const int local_end = warp_key_end(mrow, a.Sk, tid, kThreads);
  if (lane == 0) warp_end[warp] = local_end;
  __syncthreads();
  int key_end = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) key_end = max(key_end, warp_end[i]);

  // the query tiles of every head of the group: from the diagonal (causal)
  // to the end of the tiles the forward ran and, with a window, of the rows
  // whose band reaches these keys; none past the valid keys
  constexpr bool windowed = kWindow;
  int qt_begin = a.causal ? max(0, key0 - q_shift) / kTile : 0;
  int qt_end = (a.Sq + kTile - 1) / kTile;
  if (windowed) qt_end = min(qt_end, window_q_end(key0, a.window, q_shift));
  if (key0 >= key_end) qt_end = 0;
  if (a.skip_pad_q) {
    const int lim = key_end - q_shift;  // tile qt runs iff qt*64 < lim
    qt_end = min(qt_end, lim <= 0 ? 0 : (lim + kTile - 1) / kTile);
  }
  // fused and packed: the range whose dQ turns the adder takes (the header)
  const int turn_begin = qt_begin;
  const int n_turn_qt = max(0, qt_end - qt_begin);
  if constexpr (kPacked) {  // only the query tiles of the key tile's segments
    const int2 span = packed_span<kThreads>(mrow, a.Sk, key0, tid);
    qt_begin = max(qt_begin, span.x / kTile);
    qt_end = min(qt_end, (span.y + kTile - 1) / kTile);
  }
  const int n_qt = max(0, qt_end - qt_begin);
  const int n_it = groups * n_qt;  // (head, query tile) pairs, head outer
  const int n_q_tiles = (a.Sq + kTile - 1) / kTile;

  if (kFusedDq && warp == 5) {
    // ---- dQ adder: each staged dQ tile (this block's columns) into the
    // fp32 buffer, after the key tiles first .. kt - 1 added theirs; all of
    // a pass's L2 loads in flight at once (one pass at D 64, two at D 128
    // and at D 256's halves); one counter per column half ----
    constexpr int kLanesPerRow = T::kCols / 4;            // float4 columns
    constexpr int kBatch = 32;                            // float4 per lane
    constexpr int kRowsPerPass = kBatch * 32 / kLanesPerRow;
    const int r0 = lane / kLanesPerRow;
    const int c = 4 * (lane % kLanesPerRow);
    // packed: every (head, query tile) of the unpacked range takes its
    // turn; `it` counts the staged tiles, those of the packed range
    const int n_pairs = kPacked ? groups * n_turn_qt : n_it;
    int it = 0;
    for (int pair = 0; pair < n_pairs; ++pair) {
      const int n_row = kPacked ? n_turn_qt : n_qt;
      const int staged = kPacked ? it : pair;  // unpacked, every pair is staged
      const int buf = staged & 1;
      const long long bh = (long long)b * a.Hq + h0 + pair / n_row;
      const int qt = (kPacked ? turn_begin : qt_begin) + pair % n_row;
      const int q0 = qt * kTile;
      const float* src = dQs + buf * kTile * T::kDqLd;
      float* dst = a.dq_acc + (bh * a.Sq + q0) * D + col0;
      int* counter = a.sync + 1 + (bh * n_q_tiles + qt) * T::kSplit + half;
      // the turns before this key tile's: first is the first to add
      const int turn = kt - (windowed ? first_kt(qt, a.window, q_shift) : 0);
      if (kPacked && (qt < qt_begin || qt >= qt_end)) {  // a tick (the header)
        if (turn > 0) wait_turn(counter, turn);
        end_turn(counter, lane);
        continue;
      }
      mbar_wait(&dq_full[buf], (staged >> 1) & 1);
      if (turn > 0) wait_turn(counter, turn);  // the first adds to the zeros
#pragma unroll 1
      for (int pass = 0; pass < kTile / kRowsPerPass; ++pass) {
        float4 sum[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = pass * kRowsPerPass + r0 + i * (32 / kLanesPerRow);
          sum[i] = turn > 0 && q0 + r < a.Sq
                       ? __ldcg(reinterpret_cast<const float4*>(dst + (long long)r * D + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = pass * kRowsPerPass + r0 + i * (32 / kLanesPerRow);
          const float4 add = *reinterpret_cast<const float4*>(src + r * T::kDqLd + c);
          sum[i].x += add.x;
          sum[i].y += add.y;
          sum[i].z += add.z;
          sum[i].w += add.w;
          if (q0 + r < a.Sq) {
            __stcg(reinterpret_cast<float4*>(dst + (long long)r * D + c), sum[i]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&dq_empty[buf]);  // the staged tile is read
      end_turn(counter, lane);
      if constexpr (kPacked) ++it;
    }
    return;
  }

  if (warp == 4) {
    // ---- producer: K and V once, then (Q, dO, lse, delta) through the ring ----
    if (n_it == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&kv_bar, 2 * kTileBytes);
      for (int c = 0; c < T::kAtoms; ++c) {
        const int off = c * kSwizzleTileBytes;
        tma_load_4d(Ks + off, &k_map, &kv_bar, 64 * c, key0, hk, b);
        tma_load_4d(Vs + off, &v_map, &kv_bar, 64 * c, key0, hk, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int stage = it % kStages;
      const int h = h0 + it / n_qt;
      const int q0 = (qt_begin + it % n_qt) * kTile;
      mbar_wait(&empty_bar[stage], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, then the rows while they load
        mbar_expect_tx(&full_bar[stage], 2 * kTileBytes);
        for (int c = 0; c < T::kAtoms; ++c) {
          const int off = stage * kTileBytes + c * kSwizzleTileBytes;
          tma_load_4d(Qs + off, &q_map, &full_bar[stage], 64 * c, q0, h, b);
          tma_load_4d(dOs + off, &do_map, &full_bar[stage], 64 * c, q0, h, b);
        }
      }
      const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
#pragma unroll
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < a.Sq;
        lse_s[stage][r] = in ? a.lse[row0 + q0 + r] : 0.f;
        delta_s[stage][r] = in ? a.delta[row0 + q0 + r] : 0.f;
        if constexpr (kPacked) qseg_s[stage * kTile + r] = in ? mrow[q0 + r] : 0;
      }
      mbar_arrive(&full_bar[stage]);
    }
    return;
  }

  // ---- consumer warpgroup: rows of S^T are this block's keys ----
  const int w = warp;
  const int g = lane / 4;  // keys 16w + g and 16w + g + 8
  const int t = lane % 4;  // query columns 8j + 2t, 8j + 2t + 1
  const int key_a = key0 + w * 16 + g;
  const int key_b = key_a + 8;
  const bool ok_a = key_a < a.Sk && mrow[key_a] != 0;
  const bool ok_b = key_b < a.Sk && mrow[key_b] != 0;
  // packed: the two keys' segments (valid keys' are non-zero)
  const int kseg_a = kPacked && key_a < a.Sk ? mrow[key_a] : 0;
  const int kseg_b = kPacked && key_b < a.Sk ? mrow[key_b] : 0;

  // [4n + e]: columns col0 + 8n + 2t (+1) of keys a, b
  constexpr int kCols = T::kCols;
  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk[i] = dv[i] = 0.f;
  // this block's columns of a [64, D] tile: its first swizzle atom
  const int col_off = (col0 / 64) * kSwizzleTileBytes;

  if (n_it > 0) mbar_wait(&kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % kStages;
    const int q0 = (qt_begin + it % n_qt) * kTile;
    const unsigned char* Qt = Qs + stage * kTileBytes;
    const unsigned char* dOt = dOs + stage * kTileBytes;
    mbar_wait(&full_bar[stage], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, one commit group
    float st[32], dpt[32];
    wgmma_fence();
    issue_ss<D>(st, Ks, Qt);
    issue_ss<D>(dpt, Vs, dOt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(s scale - lse) on valid entries, else 0, rounded to bf16 for
    // dV; dS^T = P^T (dP^T - delta) scale, rounded to bf16 for dK and dQ.
    // Two neighbouring 8-query groups of either are the A registers of a
    // product over those 16 queries.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int row = q0 + col;
        const int pos = row + q_shift;
        const bool qin = row < a.Sq;
        const float l = lse_s[stage][col];
        const float dl = delta_s[stage][col];
        bool va = qin && ok_a && (!a.causal || key_a <= pos) &&
                  (!windowed || key_a > pos - a.window);
        bool vb = qin && ok_b && (!a.causal || key_b <= pos) &&
                  (!windowed || key_b > pos - a.window);
        if constexpr (kPacked) {
          const int qs = qseg_s[stage * kTile + col];
          va = va && qs == kseg_a;
          vb = vb && qs == kseg_b;
        }
        st[4 * j + e] = va ? __expf(st[4 * j + e] * a.scale - l) : 0.f;
        st[4 * j + 2 + e] = vb ? __expf(st[4 * j + 2 + e] * a.scale - l) : 0.f;
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl) * a.scale;
        dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dl) * a.scale;
      }
    }
    uint32_t p[16], ds[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[4 * kk + i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
        ds[4 * kk + i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }
    }

    float dq[kCols / 2];
    unsigned char* dSt = dSs + (it & 1) * kSwizzleTileBytes;
    if constexpr (kFusedDq) {
      // stage dS^T (keys as rows, 64 queries per 128-byte swizzled row) for
      // dQ = dS K; two buffers, so a warp may write the next one while the
      // others still read this one
      const int ra = w * 16 + g;  // ra % 8 == (ra + 8) % 8 == g
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int chunk = ((j ^ g) * 16) + 4 * t;
        *reinterpret_cast<uint32_t*>(dSt + ra * 128 + chunk) = ds[4 * (j / 2) + 2 * (j % 2)];
        *reinterpret_cast<uint32_t*>(dSt + (ra + 8) * 128 + chunk) =
            ds[4 * (j / 2) + 2 * (j % 2) + 1];
      }
      fence_proxy_async_shared();
      named_barrier_sync(1, 128);
    }

    // dV += P^T dO, dK += dS^T Q and (fused) dQ = dS K over this block's
    // columns, one commit group
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p);
    fence_regs(ds);
    wgmma_fence();
    issue_rs<kCols>(dv, p, dOt + col_off);
    issue_rs<kCols>(dk, ds, Qt + col_off);
    if constexpr (kFusedDq) issue_tt<kCols>(dq, dSt, Ks + col_off);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (kFusedDq) fence_regs(dq);

    // this warp is done with the stage (all four warps' arrivals free it)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[stage]);

    if constexpr (kFusedDq) {
      // the dQ tile to the adders, once they are done with this buffer
      const int buf = it & 1;
      float* dqs = dQs + buf * kTile * T::kDqLd + (w * 16 + g) * T::kDqLd + 2 * t;
      mbar_wait(&dq_empty[buf], ((it >> 1) & 1) ^ 1);
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        *reinterpret_cast<float2*>(dqs + n * 8) = make_float2(dq[4 * n], dq[4 * n + 1]);
        *reinterpret_cast<float2*>(dqs + 8 * T::kDqLd + n * 8) =
            make_float2(dq[4 * n + 2], dq[4 * n + 3]);
      }
      mbar_arrive(&dq_full[buf]);
    }
  }

  // dK/dV of the whole group, bf16 [B, Sk, Hkv, D], this block's columns
  // (zeros for a key tile that ran no queries)
  if constexpr (kF32Out) {  // fp32: two floats (8 bytes, aligned) per store
    if (key_a < a.Sk) {
      const long long o = (((long long)b * a.Sk + key_a) * a.Hkv + hk) * D + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        *reinterpret_cast<float2*>(a.dk_f32 + o + n * 8) = make_float2(dk[4 * n], dk[4 * n + 1]);
        *reinterpret_cast<float2*>(a.dv_f32 + o + n * 8) = make_float2(dv[4 * n], dv[4 * n + 1]);
      }
    }
    if (key_b < a.Sk) {
      const long long o = (((long long)b * a.Sk + key_b) * a.Hkv + hk) * D + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        *reinterpret_cast<float2*>(a.dk_f32 + o + n * 8) =
            make_float2(dk[4 * n + 2], dk[4 * n + 3]);
        *reinterpret_cast<float2*>(a.dv_f32 + o + n * 8) =
            make_float2(dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
    return;
  }
  if (key_a < a.Sk) {
    const long long o = (((long long)b * a.Sk + key_a) * a.Hkv + hk) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + o + n * 8) = pack_bf16(dk[4 * n], dk[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + o + n * 8) = pack_bf16(dv[4 * n], dv[4 * n + 1]);
    }
  }
  if (key_b < a.Sk) {
    const long long o = (((long long)b * a.Sk + key_b) * a.Hkv + hk) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + o + n * 8) =
          pack_bf16(dk[4 * n + 2], dk[4 * n + 3]);
      *reinterpret_cast<uint32_t*>(a.dv + o + n * 8) =
          pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// ---- the dq kernel: K3a ----

template <int D>
struct DqTiles {
  static constexpr int kAtoms = D / 64;  // 64-column swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kSwizzleTileBytes;  // 64 rows
  static constexpr int kStages = D == 64 ? 3 : 2;                 // K/V ring, as K1
};

// dS = P (dP - delta) scale in place of s, P = exp(s scale - lse) on valid
// entries and 0 elsewhere, packed to bf16 as the A registers of dQ += dS K
// (two neighbouring 8-key groups per 16 keys). kAll: every entry is valid
// (an interior tile), so no test is made. kPacked: a key is valid for a row
// only in the row's segment (kseg: the stage's key segments from column 2t;
// seg_a, seg_b: the rows').
template <bool kAll, bool kPacked>
__device__ __forceinline__ void dscores(uint32_t (&ds)[16], float (&s)[32], const float (&dp)[32],
                                        uint64_t bits, int t, int lim_a, int lim_b, int lo_a,
                                        int lo_b, float lse_a, float lse_b, float dl_a, float dl_b,
                                        float scale, const int* kseg, int seg_a, int seg_b) {
  // this thread's key bits, causal limits and window floors (lim, lo),
  // relative to its columns 2t + 8j + e, so that every test below has a
  // constant left side
  const uint32_t bits_lo = uint32_t(bits) >> (2 * t);
  const uint32_t bits_hi = uint32_t(bits >> 32) >> (2 * t);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + e;  // minus 2t
      const bool ok = kAll || (((j < 4 ? bits_lo : bits_hi) >> (col % 32)) & 1);
      bool ok_a = ok, ok_b = ok;
      if constexpr (kPacked && !kAll) {
        const int ks = kseg[col];
        ok_a = ok && ks == seg_a;
        ok_b = ok && ks == seg_b;
      }
      const bool va = ok_a && (kAll || (col <= lim_a && col >= lo_a));
      const bool vb = ok_b && (kAll || (col <= lim_b && col >= lo_b));
      const float pa = va ? __expf(s[4 * j + e] * scale - lse_a) : 0.f;
      const float pb = vb ? __expf(s[4 * j + 2 + e] * scale - lse_b) : 0.f;
      s[4 * j + e] = pa * (dp[4 * j + e] - dl_a) * scale;
      s[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b) * scale;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ds[4 * kk + i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

// warps 0-3: the consumer warpgroup; warp 4: the producer
constexpr int kDqThreads = 160;

// One block per (batch, query head, 64-row query tile); see the header for
// the roles of its warps. kWindow and kPacked as in the kv kernel; packed,
// the producer posts each stage's key segments as K1's does.
template <int D, bool kWindow, bool kPacked>
__global__ void __launch_bounds__(kDqThreads, D == 64 ? 2 : 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map, const BwdArgs a) {
  using T = DqTiles<D>;
  constexpr int kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes;
  constexpr int kWarpsAll = kDqThreads / 32;

  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the swizzle period)
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dOs = Qs + kTileBytes;
  unsigned char* Ks = dOs + kTileBytes;           // [kStages] tiles
  unsigned char* Vs = Ks + kStages * kTileBytes;  // [kStages] tiles
  // packed: K1's key segments and one-segment flags of each stage
  int* key_seg = reinterpret_cast<int*>(Vs + kStages * kTileBytes);
  int* key_useg = key_seg + kStages * kTile;
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages], q_bar;
  __shared__ uint64_t key_bits[kStages];  // valid keys of the tile in a stage
  __shared__ int warp_end[kWarpsAll];

  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kTile;  // long tiles first
  const int q_shift = a.Sk - a.Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int* mrow = a.mask + (long long)b * a.mask_sb;

  // one past the last valid key, reduced over the block with one barrier
  const int local_end = warp_key_end(mrow, a.Sk, tid, kDqThreads);
  if (lane == 0) warp_end[warp] = local_end;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], kPacked ? 32 : 1);  // packed: every producer lane
      mbar_init(&empty_bar[s], 4);  // lane 0 of every consumer warp
    }
    mbar_init(&q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  int key_end = 0;
#pragma unroll
  for (int i = 0; i < kWarpsAll; ++i) key_end = max(key_end, warp_end[i]);

  // the forward's key-tile bounds
  int n_tiles = (key_end + kTile - 1) / kTile;
  if (a.causal) {
    const int last_pos = q_start + kTile - 1 + q_shift;  // last row's position
    const int diag_tiles = last_pos < 0 ? 0 : last_pos / kTile + 1;
    n_tiles = min(n_tiles, diag_tiles);
  }
  if (a.skip_pad_q && q_start + q_shift >= key_end) n_tiles = 0;
  // the window: key tiles below the band of the tile's first row are skipped
  constexpr bool windowed = kWindow;
  int kt_begin = windowed ? max(0, q_start + q_shift - a.window + 1) / kTile : 0;
  if constexpr (kPacked) {  // only the keys of the query tile's segments
    const int2 span = packed_span<kDqThreads>(mrow, a.Sk, q_start, tid);
    kt_begin = max(kt_begin, span.x / kTile);
    n_tiles = min(n_tiles, (span.y + kTile - 1) / kTile);
  }
  // the ring's stage and parity count the tiles run (it), not the tile index
  const int n_run = max(0, n_tiles - kt_begin);

  if (warp == 4) {
    // ---- producer: Q and dO once, then K/V tiles through the ring ----
    if (n_run == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_bar, 2 * kTileBytes);
      for (int at = 0; at < T::kAtoms; ++at) {
        const int off = at * kSwizzleTileBytes;
        tma_load_4d(Qs + off, &q_map, &q_bar, 64 * at, q_start, h, b);
        tma_load_4d(dOs + off, &do_map, &q_bar, 64 * at, q_start, h, b);
      }
    }
    for (int it = 0; it < n_run; ++it) {
      const int stage = it % kStages;
      mbar_wait(&empty_bar[stage], ((it / kStages) & 1) ^ 1);
      const int key0 = (kt_begin + it) * kTile;
      const int k_lo = key0 + lane, k_hi = key0 + 32 + lane;
      const uint32_t lo = __ballot_sync(0xffffffffu, k_lo < a.Sk && mrow[k_lo] != 0);
      const uint32_t hi = __ballot_sync(0xffffffffu, k_hi < a.Sk && mrow[k_hi] != 0);
      if constexpr (kPacked) {
        const int s_lo = k_lo < a.Sk ? mrow[k_lo] : 0;
        const int s_hi = k_hi < a.Sk ? mrow[k_hi] : 0;
        key_seg[stage * kTile + lane] = s_lo;
        key_seg[stage * kTile + 32 + lane] = s_hi;
        const int s0 = __shfl_sync(0xffffffffu, s_lo, 0);
        const bool one = __all_sync(0xffffffffu, s_lo == s0 && s_hi == s0);
        if (lane == 0) key_useg[stage] = one && s0 != 0 ? s0 : -2;
        if (lane != 0) mbar_arrive(&full_bar[stage]);  // after this lane's posts
      }
      if (lane == 0) {
        key_bits[stage] = uint64_t(lo) | (uint64_t(hi) << 32);
        mbar_arrive_expect_tx(&full_bar[stage], 2 * kTileBytes);
        for (int at = 0; at < T::kAtoms; ++at) {
          const int off = stage * kTileBytes + at * kSwizzleTileBytes;
          tma_load_4d(Ks + off, &k_map, &full_bar[stage], 64 * at, key0, hk, b);
          tma_load_4d(Vs + off, &v_map, &full_bar[stage], 64 * at, key0, hk, b);
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int w = warp;
  const int g = lane / 4;  // rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // columns 2t, 2t + 1 of every 8

  const int row_a = q_start + w * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const long long stats = ((long long)b * a.Hq + h) * a.Sq;
  const float lse_a = row_a < a.Sq ? a.lse[stats + row_a] : 0.f;
  const float lse_b = row_b < a.Sq ? a.lse[stats + row_b] : 0.f;
  const float dl_a = row_a < a.Sq ? a.delta[stats + row_a] : 0.f;
  const float dl_b = row_b < a.Sq ? a.delta[stats + row_b] : 0.f;
  // packed: the rows' segments and the warp's one segment, as in K1
  int seg_a = 0, seg_b = 0, warp_seg = -1;
  if constexpr (kPacked) {
    seg_a = row_a < a.Sq ? mrow[row_a] : 0;
    seg_b = row_b < a.Sq ? mrow[row_b] : 0;
    const int s0 = __shfl_sync(0xffffffffu, seg_a, 0);
    if (__all_sync(0xffffffffu, seg_a == s0 && seg_b == s0) && s0 != 0) warp_seg = s0;
  }

  float dq[D / 2];  // dq[4n + e]: columns 8n + 2t (+1) of rows a, b
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_run > 0) mbar_wait(&q_bar, 0);
  for (int it = 0; it < n_run; ++it) {
    const int stage = it % kStages;
    const unsigned char* Kt = Ks + stage * kTileBytes;
    const unsigned char* Vt = Vs + stage * kTileBytes;
    mbar_wait(&full_bar[stage], (it / kStages) & 1);
    const uint64_t bits = key_bits[stage];
    const int key0 = (kt_begin + it) * kTile;

    // S = Q K^T and dP = dO V^T, one commit group
    float s[32], dp[32];
    wgmma_fence();
    issue_ss<D>(s, Qs, Kt);
    issue_ss<D>(dp, dOs, Vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // an interior tile (every key valid and, when causal, every row of the
    // warp at or past the tile's last key and, with a window, every key
    // inside the band of the warp's last row; packed, the tile's keys and the
    // warp's rows all in one segment) needs no mask or causal test
    uint32_t ds[16];
    const int* kseg = key_seg + stage * kTile + 2 * t;
    const bool all_keys = kPacked ? key_useg[stage] == warp_seg : bits == ~0ull;
    const bool interior =
        all_keys && (!a.causal || key0 + kTile - 1 <= q_start + 16 * w + q_shift) &&
        (!windowed || key0 > q_start + 16 * w + 15 + q_shift - a.window);
    if (interior) {
      dscores<true, kPacked>(ds, s, dp, bits, t, 0, 0, 0, 0, lse_a, lse_b, dl_a, dl_b, a.scale,
                             kseg, seg_a, seg_b);
    } else {
      const int lim_a = a.causal ? row_a + q_shift - key0 - 2 * t : kTile;
      const int lim_b = a.causal ? row_b + q_shift - key0 - 2 * t : kTile;
      const int lo_a = windowed ? row_a + q_shift - a.window + 1 - key0 - 2 * t : -kTile;
      const int lo_b = windowed ? row_b + q_shift - a.window + 1 - key0 - 2 * t : -kTile;
      dscores<false, kPacked>(ds, s, dp, bits, t, lim_a, lim_b, lo_a, lo_b, lse_a, lse_b, dl_a,
                              dl_b, a.scale, kseg, seg_a, seg_b);
    }

    // dQ += dS K, K read MN-major from the same stage
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_rs<D>(dq, ds, Kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    // this warp is done with the stage (wgmma_wait is warp-synchronous, so
    // every lane's products have completed)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[stage]);
  }

  // dQ as bf16 [B, Sq, Hq, D] (zeros for a query tile that ran no key tiles)
  if (row_a < a.Sq) {
    __nv_bfloat16* o = a.dq + (((long long)b * a.Sq + row_a) * a.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(dq[4 * n], dq[4 * n + 1]);
    }
  }
  if (row_b < a.Sq) {
    __nv_bfloat16* o = a.dq + (((long long)b * a.Sq + row_b) * a.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(dq[4 * n + 2], dq[4 * n + 3]);
    }
  }
}

// the 4-D tensor maps of q, k, v and do over the caller's strides
int encode_maps(CUtensorMap (&m)[4], const BwdArgs& a, int B, int D) {
  int rc = encode_map(&m[0], a.q, B, a.Sq, a.Hq, D, a.q_sb, a.q_ss, a.q_sh);
  if (rc == 0) rc = encode_map(&m[1], a.k, B, a.Sk, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh);
  if (rc == 0) rc = encode_map(&m[2], a.v, B, a.Sk, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh);
  if (rc == 0) rc = encode_map(&m[3], a.dout, B, a.Sq, a.Hq, D, a.do_sb, a.do_ss, a.do_sh);
  return rc;
}

template <int D, bool kWindow, bool kPacked>
int launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  using T = DqTiles<D>;
  CUtensorMap m[4];
  const int rc = encode_maps(m, a, B, D);
  if (rc != 0) return rc;
  constexpr int smem = 1024 + (2 + 2 * T::kStages) * T::kTileBytes +
                       (kPacked ? T::kStages * (kTile + 1) * 4 : 0);
  auto kernel = flash_bwd_dq_wgmma<D, kWindow, kPacked>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.Hq, (a.Sq + kTile - 1) / kTile);
  kernel<<<grid, kDqThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

template <int D, bool kFused, bool kWindow, bool kPacked, bool kF32Out = false>
int launch_kv(const BwdArgs& a, int B, cudaStream_t stream) {
  using T = KvTiles<D, kFused>;
  CUtensorMap m[4];
  const int rc = encode_maps(m, a, B, D);
  if (rc != 0) return rc;
  constexpr int smem = 1024 + (2 + 2 * T::kStages) * T::kTileBytes +
                       (kFused ? 2 * kSwizzleTileBytes + 2 * T::kDqBytes : 0) +
                       (kPacked ? T::kStages * kTile * 4 : 0);
  auto kernel = flash_bwd_kv_wgmma<D, kFused, kWindow, kPacked, kF32Out>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.Hkv * T::kSplit, (a.Sk + kTile - 1) / kTile);
  kernel<<<grid, kKvThreads<kFused>, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

template <int D, bool kWindow, bool kPacked>
int dispatch_kernel(Which which, const BwdArgs& a, int B, cudaStream_t st) {
  switch (which) {
    case kFused:
      return launch_kv<D, true, kWindow, kPacked>(a, B, st);
    case kDkv:
      return launch_kv<D, false, kWindow, kPacked>(a, B, st);
    case kDkvF32:  // built for the ring's steps only: no window, no segments
      if constexpr (!kWindow && !kPacked) return launch_kv<D, false, false, false, true>(a, B, st);
      return (int)cudaErrorInvalidValue;
    default:
      return launch_dq<D, kWindow, kPacked>(a, B, st);
  }
}

template <int D, bool kPacked>
int dispatch_window(Which which, const BwdArgs& a, int B, cudaStream_t st) {
  return a.window > 0 ? dispatch_kernel<D, true, kPacked>(which, a, B, st)
                      : dispatch_kernel<D, false, kPacked>(which, a, B, st);
}

template <int D>
int dispatch(Which which, const BwdArgs& a, int B, int packed, cudaStream_t st) {
  return packed ? dispatch_window<D, true>(which, a, B, st)
                : dispatch_window<D, false>(which, a, B, st);
}

}  // namespace

namespace rankpo_bwd {

#define RANKPO_BWD_PASTE(d) dispatch_d##d
#define RANKPO_BWD_DISPATCH(d) RANKPO_BWD_PASTE(d)

int RANKPO_BWD_DISPATCH(RANKPO_BWD_D)(Which which, const BwdArgs& a, int B, int packed,
                                      cudaStream_t st) {
  return dispatch<RANKPO_BWD_D>(which, a, B, packed, st);
}

}  // namespace rankpo_bwd

#else  // the entry points

namespace {

using namespace rankpo_bwd;

int run(Which which, const void* q, const void* k, const void* v,
        const int* mask, const void* dout, const float* lse,
        const float* delta, void* dq, void* dk, void* dv, int* sync, int B,
        int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh, long long do_sb,
        long long do_ss, long long do_sh, long long mask_sb, int causal,
        int skip_pad_q, int window, int packed, void* stream) {
  BwdArgs a;
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = reinterpret_cast<const __nv_bfloat16*>(k);
  a.v = reinterpret_cast<const __nv_bfloat16*>(v);
  a.mask = mask;
  a.dout = reinterpret_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq_acc = which == kFused ? reinterpret_cast<float*>(dq) : nullptr;
  a.dq = which == kDq ? reinterpret_cast<__nv_bfloat16*>(dq) : nullptr;
  const bool f32 = which == kDkvF32;
  a.dk = f32 ? nullptr : reinterpret_cast<__nv_bfloat16*>(dk);
  a.dv = f32 ? nullptr : reinterpret_cast<__nv_bfloat16*>(dv);
  a.dk_f32 = f32 ? reinterpret_cast<float*>(dk) : nullptr;
  a.dv_f32 = f32 ? reinterpret_cast<float*>(dv) : nullptr;
  a.sync = sync;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.mask_sb = mask_sb;
  a.scale = rsqrtf((float)D);
  a.causal = causal;
  a.skip_pad_q = skip_pad_q;
  a.window = causal && window > 0 ? window : -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (Hq % Hkv != 0 || (packed && Sq != Sk)) return (int)cudaErrorInvalidValue;
  if (D == 64) return dispatch_d64(which, a, B, packed, st);
  if (D == 128) return dispatch_d128(which, a, B, packed, st);
  if (D == 256) return dispatch_d256(which, a, B, packed, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t
// value; 0 is success. The caller validates shapes, types, strides and
// alignment (TMA's rules: a 16-byte-aligned base, strides that are multiples
// of 16 bytes), zeroes the fused kernel's fp32 dq buffer and its int32
// `sync` buffer (1 + B * Hq * ceil(Sq / 64) * split entries, split 2 at
// D 256 and 1 otherwise: KvTiles::kSplit), and allocates dk/dv as bf16
// [B, Sk, Hkv, D] (fp32 for rankpo_flash_bwd_dkv_f32). packed: mask holds
// segment ids (Sq == Sk).
#define RANKPO_BWD_PARAMS                                                     \
  const void *q, const void *k, const void *v, const int *mask,              \
      const void *dout, const float *lse, const float *delta, void *dq,      \
      void *dk, void *dv, int *sync, int B, int Sq, int Sk, int Hq, int Hkv, \
      int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb, \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      long long mask_sb, int causal, int skip_pad_q, int window, int packed, \
      void *stream
#define RANKPO_BWD_ARGS                                                       \
  q, k, v, mask, dout, lse, delta, dq, dk, dv, sync, B, Sq, Sk, Hq, Hkv, D,  \
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,    \
      do_sh, mask_sb, causal, skip_pad_q, window, packed, stream

// K2: dq (fp32, summed in key-tile order), dk, dv in one pass
extern "C" int rankpo_flash_bwd_fused_bf16(RANKPO_BWD_PARAMS) {
  return run(kFused, RANKPO_BWD_ARGS);
}

// K3b: dk, dv; dq and sync are ignored
extern "C" int rankpo_flash_bwd_dkv_bf16(RANKPO_BWD_PARAMS) {
  return run(kDkv, RANKPO_BWD_ARGS);
}

// K3b with fp32 dk, dv (no window, not packed: anything else returns
// cudaErrorInvalidValue); dq and sync are ignored
extern "C" int rankpo_flash_bwd_dkv_f32(RANKPO_BWD_PARAMS) {
  if (window > 0 || packed) return (int)cudaErrorInvalidValue;
  return run(kDkvF32, RANKPO_BWD_ARGS);
}

// K3a: dq (bf16, [B, Sq, Hq, D]); dk, dv and sync are ignored
extern "C" int rankpo_flash_bwd_dq_bf16(RANKPO_BWD_PARAMS) {
  return run(kDq, RANKPO_BWD_ARGS);
}

#endif  // RANKPO_BWD_D
