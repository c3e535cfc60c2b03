// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel rankpo_tpu/ops/flash_attention.py:_fwd_kernel
// (line 55; FlashAttention-2 forward: online softmax over key blocks with fp32
// running max and sum, returning O and the logsumexp).
//
// Contract (what _fwd_kernel computes):
//   q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16, read through their strides
//   (the head_dim stride must be 1); mask [B, Sk] int32, non-zero = valid key.
//   scale 1/sqrt(D); logits in fp32; causal alignment is bottom-right
//   (query row r sits at position r + Sk - Sq); P is rounded to bf16 before the
//   PV product; rows with no valid key output exact zeros and lse = NEG_INF;
//   lse = m + log(l). GQA: query head h reads kv head h / (Hq / Hkv), K/V are
//   never copied. skip_pad_q: a query tile whose first position is at or past
//   the valid key length runs no key tiles, so its rows output zeros
//   (block-granular, as in the JAX kernel; only rows below the valid length
//   are meaningful). window (> 0, with causal; -1 = none): row r sees keys
//   with k_pos > q_pos - window (the HF Mistral/Qwen2 rule); a row with no
//   visible valid key outputs zeros and lse = NEG_INF. The loop over key
//   tiles stops at the last valid key and, when causal, at the diagonal;
//   with a window it starts at the first tile inside the band of the query
//   tile's first row, so the work grows with S * window, not S^2.
//   Packed (kPacked; Sq == Sk): the mask row carries segment ids,
//   contiguous runs 1..n with a 0-id pad tail; a pair is valid when the
//   key's segment is non-zero and equal to the query row's, ANDed with the
//   tests above. The key tiles run are further bounded to the span of the
//   query tile's segments (packed_span in flash_common.cuh, JAX's
//   flash_attention.py:132-147), so a row's work grows with its segment's
//   length, and a query tile in the pad tail runs none. No atomics: out
//   and lse repeat bit for bit.
//
// What bounds it on this card. At the encoder's shapes (S <= 512, D = 64, 32
// query heads over 8 kv heads, causal) a (head, query tile) pair runs at most
// 8 key tiles of 64, so the work per block is small and the kernel is bound
// by the latency of each tile's chain (load, S = Q K^T, softmax, O += P V),
// not by HBM bytes or the tensor-core peak; the softmax's ALU work was the
// largest part of that chain.
//
// Design. Block = (batch, kv head, NC query heads of that GQA group, one
// 64-row query tile); NC is 2 when the group size is even, else 1, and 1 at
// D 256 (below). Warps
// 0 .. 4 NC - 1 are NC consumer warpgroups, one per query head; warp 4 NC is
// the producer. All heads of a block need the same key tiles (same rows,
// causal edge and valid length), so each K/V tile is loaded once for all of
// them:
//   - the producer loads the NC Q tiles once and then K/V tiles with TMA (4-D
//     tensor maps over the caller's [B, S, H, D] strides, 128-byte swizzle,
//     zero fill past S) into a ring of kStages stages, each with a full and
//     an empty mbarrier; with each tile it posts the tile's 64 key-validity
//     bits in the stage, so no consumer reads the mask;
//   - each consumer warpgroup computes S = Q K^T by wgmma m64n64k16 with both
//     operands in shared memory (K-major), the softmax in registers (mask and
//     causal tests only on tiles that need them; __expf of natural-log
//     logits and sums in the order of the mma.sync design this replaced,
//     whose rounding the smoke's full-width training loss repeats), and
//     O += P V by wgmma m64n64k16 with P from registers (the S accumulator
//     layout packed to bf16 is the A operand layout) and V in shared memory
//     (MN-major, the transposed-B form); D 128 runs two 64-column halves
//     and D 256 four;
//   - the valid key length is reduced once per block, behind one barrier;
//   - packed: the producer also posts the tile's 64 segment ids and
//     whether they are all one segment, and every producer lane arrives on
//     the stage's full barrier; each consumer thread compares its two rows'
//     segments with its columns' keys. A warp whose 16 rows and the tile's
//     64 keys all lie in one segment takes the interior path.
// D 256 (Gemma): a 64-row tile is four swizzle atoms, 32 KB. The O
// accumulator alone is D / 2 = 128 fp32 registers a thread (plus 32 for S
// and 16 for P), so a block takes one query head (NC 1: 160 threads, up to
// 255 registers each; two heads would be 288 threads at ~200 registers,
// more than an SM holds) and a 2-stage K/V ring: 1 KB + (1 + 2 x 2) x 32 KB
// = 161 KB of shared memory. The same code, instantiated at D 256; the
// D 64 and D 128 instantiations are unchanged.
// Left out (ROADMAP Queue 2, K1): setmaxnreg register rebalancing between the
// producer and the consumers, ping-pong scheduling of the consumer
// warpgroups, overlap of the softmax with the next wgmma inside a warpgroup,
// a persistent grid, clusters with TMA multicast, fp8.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// max of this thread's 16 entries of one row (E = 0: row g, E = 2: row
// g + 8) as a tree, for a short dependency chain (a max is exact in any order)
template <int E>
__device__ __forceinline__ float row_max(const float (&s)[32]) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = fmaxf(s[4 * j + E], s[4 * j + E + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
  }
  return m[0];
}

template <int D>
struct FwdTiles {
  static constexpr int kAtoms = D / 64;  // 64-column swizzle atoms per row
  static constexpr int kTileBytes = kAtoms * kSwizzleTileBytes;  // 64 rows
  static constexpr int kStages = D == 64 ? 3 : 2;                 // K/V ring
};

// s[4j + e] = S entries of this thread's rows against keys 8j + 2t + e
// (e < 2: row g, e >= 2: row g + 8): Q K^T over D / 16 steps of 16
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], const unsigned char* Qt,
                                       const unsigned char* Kt) {
  const uint64_t dq = sw128_desc(Qt), dk = sw128_desc(Kt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSwizzleTileBytes + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, desc_add(dq, off), desc_add(dk, off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// o += P V: P as bf16 A registers p[4 kk .. 4 kk + 4) for keys 16 kk ..
// 16 kk + 15, V a [64, D] tile; one product per 16 keys and 64 columns
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], uint32_t (&p)[16],
                                   const unsigned char* Vt) {
  const uint64_t dv = sw128_desc(Vt);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int a = 0; a < D / 64; ++a) {
      wgmma_m64n64k16_rs_tb(&o[32 * a], &p[4 * kk],
                            desc_add(dv, a * kSwizzleTileBytes + kk * 16 * 128));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// One block per (batch, kv head, NC query heads, 64-row query tile); see the
// header for the roles of its warps. kWindow: built with the window's bounds
// and tests (window > 0, causal), and kPacked with the segments' (the mask
// row holds segment ids), so the kernel without them is unchanged.
template <int D, int NC, bool kWindow, bool kPacked>
__global__ void __launch_bounds__(NC * 128 + 32, D == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 long long mask_sb, float scale, int causal, int skip_pad_q,
                 int window) {
  using T = FwdTiles<D>;
  constexpr int kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes;
  constexpr int kWarpsAll = 4 * NC + 1;

  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the swizzle period)
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + NC * kTileBytes;
  unsigned char* Vs = Ks + kStages * kTileBytes;
  // packed: each stage's 64 key segment ids, then per stage the tiles'
  // one segment (-2 when its keys are not all of one non-zero segment)
  int* key_seg = reinterpret_cast<int*>(Vs + kStages * kTileBytes);
  int* key_useg = key_seg + kStages * kTile;
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages], q_bar;
  __shared__ uint64_t key_bits[kStages];  // valid keys of the tile in a stage
  __shared__ int warp_end[kWarpsAll];

  const int groups = Hq / Hkv;
  const int sets = groups / NC;
  const int set = blockIdx.x % sets;
  const int hk = (blockIdx.x / sets) % Hkv;
  const int b = blockIdx.x / (sets * Hkv);
  const int h0 = hk * groups + set * NC;                   // first query head
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kTile;  // long tiles first
  const int q_shift = Sk - Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int* mrow = mask + (long long)b * mask_sb;

  // one past the last valid key, reduced over the block with one barrier
  int local_end = 0;
  for (int j = tid; j < Sk; j += kWarpsAll * 32) {
    if (mrow[j] != 0) local_end = j + 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local_end = max(local_end, __shfl_xor_sync(0xffffffffu, local_end, off));
  }
  if (lane == 0) warp_end[warp] = local_end;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], kPacked ? 32 : 1);  // packed: every producer lane
      mbar_init(&empty_bar[s], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_init(&q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  int key_end = 0;
#pragma unroll
  for (int i = 0; i < kWarpsAll; ++i) key_end = max(key_end, warp_end[i]);

  int n_tiles = (key_end + kTile - 1) / kTile;
  if (causal) {
    const int last_pos = q_start + kTile - 1 + q_shift;  // last row's position
    const int diag_tiles = last_pos < 0 ? 0 : last_pos / kTile + 1;
    n_tiles = min(n_tiles, diag_tiles);
  }
  if (skip_pad_q && q_start + q_shift >= key_end) n_tiles = 0;
  // the window: key tiles below the band of the tile's first row are skipped
  constexpr bool windowed = kWindow;
  int kt_begin = windowed ? max(0, q_start + q_shift - window + 1) / kTile : 0;
  if constexpr (kPacked) {  // only the keys of the query tile's segments
    const int2 span = packed_span<kWarpsAll * 32>(mrow, Sk, q_start, tid);
    kt_begin = max(kt_begin, span.x / kTile);
    n_tiles = min(n_tiles, (span.y + kTile - 1) / kTile);
  }
  // the ring's stage and parity count the tiles run (it), not the tile index
  const int n_run = max(0, n_tiles - kt_begin);

  if (warp == 4 * NC) {
    // ---- producer: Q once, then K/V tiles through the ring ----
    if (n_run == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_bar, NC * kTileBytes);
      for (int c = 0; c < NC; ++c) {
        for (int a = 0; a < T::kAtoms; ++a) {
          tma_load_4d(Qs + c * kTileBytes + a * kSwizzleTileBytes, &q_map, &q_bar,
                      64 * a, q_start, h0 + c, b);
        }
      }
    }
    for (int it = 0; it < n_run; ++it) {
      const int stage = it % kStages;
      mbar_wait(&empty_bar[stage], ((it / kStages) & 1) ^ 1);
      const int key0 = (kt_begin + it) * kTile;
      const int k_lo = key0 + lane, k_hi = key0 + 32 + lane;
      const uint32_t lo = __ballot_sync(0xffffffffu, k_lo < Sk && mrow[k_lo] != 0);
      const uint32_t hi = __ballot_sync(0xffffffffu, k_hi < Sk && mrow[k_hi] != 0);
      if constexpr (kPacked) {
        const int s_lo = k_lo < Sk ? mrow[k_lo] : 0;
        const int s_hi = k_hi < Sk ? mrow[k_hi] : 0;
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
        for (int a = 0; a < T::kAtoms; ++a) {
          const int off = stage * kTileBytes + a * kSwizzleTileBytes;
          tma_load_4d(Ks + off, &k_map, &full_bar[stage], 64 * a, key0, hk, b);
          tma_load_4d(Vs + off, &v_map, &full_bar[stage], 64 * a, key0, hk, b);
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- consumers: warpgroup c computes query head h0 + c ----
  const int c = warp / 4;
  const int w = warp % 4;
  const int h = h0 + c;
  const int g = lane / 4;  // rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // columns 2t, 2t + 1 of every 8
  const unsigned char* Qt = Qs + c * kTileBytes;

  const int row_a = q_start + w * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const int pos_a = row_a + q_shift;
  const int pos_b = row_b + q_shift;
  // packed: the two rows' segments (0 past Sq: such rows see no key) and
  // the warp's one segment (-1 when its 16 rows span more than one)
  int seg_a = 0, seg_b = 0, warp_seg = -1;
  if constexpr (kPacked) {
    seg_a = row_a < Sq ? mrow[row_a] : 0;
    seg_b = row_b < Sq ? mrow[row_b] : 0;
    const int s0 = __shfl_sync(0xffffffffu, seg_a, 0);
    if (__all_sync(0xffffffffu, seg_a == s0 && seg_b == s0) && s0 != 0) warp_seg = s0;
  }

  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sum
  float o[D / 2];                      // o[4n + e]: columns 8n + 2t (+1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  if (n_run > 0) mbar_wait(&q_bar, 0);
  for (int it = 0; it < n_run; ++it) {
    const int stage = it % kStages;
    mbar_wait(&full_bar[stage], (it / kStages) & 1);
    const uint64_t bits = key_bits[stage];
    const int key0 = (kt_begin + it) * kTile;

    float s[32];
    scores<D>(s, Qt, Ks + stage * kTileBytes);

    // scale, mask. An interior tile (every key valid and, when causal, every
    // row of the warp at or past the tile's last key and, with a window, every
    // key inside the band of the warp's last row; packed, the tile's keys and
    // the warp's rows all in one segment) needs no mask or causal test.
    const bool all_keys = kPacked ? key_useg[stage] == warp_seg : bits == ~0ull;
    const bool interior =
        all_keys && (!causal || key0 + kTile - 1 <= q_start + 16 * w + q_shift) &&
        (!windowed || key0 > q_start + 16 * w + 15 + q_shift - window);
    if (interior) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    } else {
      // this thread's key bits, causal limits and window floors, relative to
      // its columns 2t + 8j + e, so that every test below has a constant left
      // side
      const uint32_t bits_lo = uint32_t(bits) >> (2 * t);
      const uint32_t bits_hi = uint32_t(bits >> 32) >> (2 * t);
      const int lim_a = causal ? pos_a - key0 - 2 * t : kTile;
      const int lim_b = causal ? pos_b - key0 - 2 * t : kTile;
      const int lo_a = windowed ? pos_a - window + 1 - key0 - 2 * t : -kTile;
      const int lo_b = windowed ? pos_b - window + 1 - key0 - 2 * t : -kTile;
      const int* kseg = key_seg + stage * kTile + 2 * t;  // packed: column 8j + e
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + e;  // minus 2t
          const bool ok = ((j < 4 ? bits_lo : bits_hi) >> (col % 32)) & 1;
          bool ok_a = ok, ok_b = ok;
          if constexpr (kPacked) {
            const int ks = kseg[col];
            ok_a = ok && ks == seg_a;
            ok_b = ok && ks == seg_b;
          }
          s[4 * j + e] =
              ok_a && col <= lim_a && col >= lo_a ? s[4 * j + e] * scale : kNegInf;
          s[4 * j + 2 + e] =
              ok_b && col <= lim_b && col >= lo_b ? s[4 * j + 2 + e] * scale : kNegInf;
        }
      }
    }
    float mx_a = row_max<0>(s), mx_b = row_max<2>(s);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = __expf(m_a - mn_a);
    const float alpha_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // P = exp(S - m); masked entries are exactly 0, so a row that has seen
    // no valid key keeps l == 0 and ends in the zeros path
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = __expf(s[4 * j + e] - mn_a);
        float pb = __expf(s[4 * j + 2 + e] - mn_b);
        if (!interior) {
          pa = s[4 * j + e] > kNegInf ? pa : 0.f;
          pb = s[4 * j + 2 + e] > kNegInf ? pb : 0.f;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        ps_a += pa;
        ps_b += pb;
      }
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= alpha_a;
      o[4 * n + 1] *= alpha_a;
      o[4 * n + 2] *= alpha_b;
      o[4 * n + 3] *= alpha_b;
    }

    // P rounded to bf16: two neighbouring 8-key groups of S are the A
    // registers of the PV product over those 16 keys
    uint32_t p[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    pv<D>(o, p, Vs + stage * kTileBytes);

    // this warp is done with the stage (wgmma_wait is warp-synchronous, so
    // every lane's products have completed)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[stage]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // no valid key: zeros (not NaN) and lse = NEG_INF
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
  const float lse_a = l_a == 0.f ? kNegInf : m_a + logf(l_a);
  const float lse_b = l_b == 0.f ? kNegInf : m_b + logf(l_b);
  const long long bh = (long long)b * Hq + h;

  if (row_a < Sq) {
    __nv_bfloat16* op = out + (((long long)b * Sq + row_a) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    }
    if (t == 0) lse[bh * Sq + row_a] = lse_a;
  }
  if (row_b < Sq) {
    __nv_bfloat16* op = out + (((long long)b * Sq + row_b) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
    }
    if (t == 0) lse[bh * Sq + row_b] = lse_b;
  }
}

// ---- host side (tensor maps: encode_map in hopper.cuh) ----
template <int D, int NC, bool kWindow, bool kPacked>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const int* mask, void* out, float* lse, int B, int Sq, int Sk, int Hq,
           int Hkv, long long mask_sb, int causal, int skip_pad_q, int window,
           cudaStream_t stream) {
  using T = FwdTiles<D>;
  constexpr int smem = 1024 + (NC + 2 * T::kStages) * T::kTileBytes +
                       (kPacked ? T::kStages * (kTile + 1) * 4 : 0);
  auto kernel = flash_fwd_kernel<D, NC, kWindow, kPacked>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq / NC, (Sq + kTile - 1) / kTile);
  kernel<<<grid, NC * 128 + 32, smem, stream>>>(
      qm, km, vm, mask, reinterpret_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv,
      mask_sb, rsqrtf((float)D), causal, skip_pad_q, window);
  return (int)cudaGetLastError();
}

// Query heads per block where the group size is even: 2, or 1 when built
// with -DRANKPO_FWD_HEADS=1 (scripts/flash_fwd_compare.py times both).
#ifndef RANKPO_FWD_HEADS
#define RANKPO_FWD_HEADS 2
#endif

template <int D, bool kWindow, bool kPacked>
int dispatch_heads(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const int* mask, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                   int Hkv, long long mask_sb, int causal, int skip_pad_q, int window,
                   cudaStream_t stream) {
  if constexpr (D != 256) {  // D 256: one query head per block (the header)
    if (RANKPO_FWD_HEADS == 2 && (Hq / Hkv) % 2 == 0) {
      return launch<D, 2, kWindow, kPacked>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv,
                                            mask_sb, causal, skip_pad_q, window, stream);
    }
  }
  return launch<D, 1, kWindow, kPacked>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv,
                                        mask_sb, causal, skip_pad_q, window, stream);
}

template <int D, bool kPacked>
int dispatch_window(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                    const int* mask, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                    int Hkv, long long mask_sb, int causal, int skip_pad_q, int window,
                    cudaStream_t stream) {
  if (causal && window > 0) {
    return dispatch_heads<D, true, kPacked>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv,
                                            mask_sb, causal, skip_pad_q, window, stream);
  }
  return dispatch_heads<D, false, kPacked>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv,
                                           mask_sb, causal, skip_pad_q, -1, stream);
}

template <int D>
int dispatch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
             const int* mask, void* out, float* lse, int B, int Sq, int Sk, int Hq,
             int Hkv, long long mask_sb, int causal, int skip_pad_q, int window, int packed,
             cudaStream_t stream) {
  if (packed) {
    return dispatch_window<D, true>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv, mask_sb,
                                    causal, skip_pad_q, window, stream);
  }
  return dispatch_window<D, false>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv, mask_sb,
                                   causal, skip_pad_q, window, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t value; 0 is
// success. The caller validates shapes, types, strides and alignment (TMA's
// rules: a 16-byte-aligned base, strides that are multiples of 16 bytes).
// packed: mask holds segment ids (Sq == Sk).
extern "C" int rankpo_flash_fwd_bf16(
    const void* q, const void* k, const void* v, const int* mask, void* out,
    float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long mask_sb, int causal, int skip_pad_q, int window, int packed, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hq % Hkv != 0 || (packed && Sq != Sk)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm;
  int rc = encode_map(&qm, q, B, Sq, Hq, D, q_sb, q_ss, q_sh);
  if (rc == 0) rc = encode_map(&km, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh);
  if (rc == 0) rc = encode_map(&vm, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh);
  if (rc != 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) {
    return dispatch<64>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv, mask_sb, causal,
                        skip_pad_q, window, packed, st);
  }
  if (D == 256) {
    return dispatch<256>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv, mask_sb, causal,
                         skip_pad_q, window, packed, st);
  }
  return dispatch<128>(qm, km, vm, mask, out, lse, B, Sq, Sk, Hq, Hkv, mask_sb, causal,
                       skip_pad_q, window, packed, st);
}
