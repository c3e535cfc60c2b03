// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of rankpo_tpu/ops/flash_attention.py:
//   _bwd_fused_kernel (flash_bwd_fused)  -> flash_bwd_kv_kernel<D, true>
//   _dkv_kernel       (flash_dkv)        -> flash_bwd_kv_kernel<D, false>
//   _dq_kernel        (flash_dq)         -> flash_bwd_dq_kernel<D>
//
// Contract (what the Pallas kernels compute), with the forward's contract
// from flash_fwd.cu (layouts, strides, mask, bottom-right causal, GQA):
//   do [B, Sq, Hq, D] bf16 (strided); lse, delta [B, Hq, Sq] fp32, where
//   lse comes from the forward and delta = rowsum(dO * O) in fp32.
//   s = scale * q.k in fp32; p = exp(s - lse) on valid entries, 0 elsewhere;
//   dV += P^T dO with P rounded to bf16; dP = dO V^T;
//   dS = p * (dP - delta) * scale, rounded to bf16; dK += dS^T Q; dQ += dS K.
//   dK/dV are written per query head in fp32 ([B, Hq, Sk, D]); the caller
//   sums each GQA group. The fused kernel adds dQ in fp32 into a zeroed
//   [B, Hq, Sq, D] buffer; the dq kernel writes dQ as bf16 [B, Sq, Hq, D].
//   Loop bounds are the forward's: keys end one past the last valid key;
//   causal tiles above the diagonal are skipped; with skip_pad_q a query
//   tile the forward skipped (it starts at or past the valid key extent)
//   is skipped here too, so its rows give zero dQ and add nothing to dK/dV.
//
// Design. 4 warps per block, 16 tile rows per warp, both operands of every
// product on the tensor cores through mma.sync m16n8k16, fragments of one
// product's fp32 accumulators reused as the next product's bf16 A operand.
//   * kv kernels: one block per (batch*q-head, 64-key tile), as the Pallas
//     grid (bh, k_blocks). The key and value tile stay in shared memory; the
//     block loops over 64-row query tiles (Q, dO, lse, delta staged each
//     step). Each warp computes S^T for its 16 keys against the 64 queries,
//     so dK and dV accumulate in registers over the whole loop.
//   * Blocks on Hopper run in parallel and in no order, so the Pallas fused
//     kernel's dq block resident across the sequential key axis has no
//     counterpart: the fused variant stages dS (bf16, transposed) in shared
//     memory, forms the 64 x D dQ contribution of its key tile and adds it
//     to the fp32 buffer with atomicAdd. The summation order of those adds
//     changes from run to run, so fused dQ is not bit-reproducible.
//   * dq kernel: one block per (batch*q-head, 64-row query tile) looping over
//     key tiles like the forward, dQ held in registers and rounded once:
//     bit-reproducible.
//
// What bounds it on this card. At the training shapes (S <= 512, D = 64) a
// tile pair costs 5 (fused), 4 (dkv) or 3 (dq) 64 x 64 x 64 products and each
// kernel reads its inputs a few times from L2 (K/V per head are <= 64 KB), so
// like the forward it is bound by latency and occupancy (128-thread blocks,
// ~46 KB of shared memory at D = 64) and, for the fused kernel, by the fp32
// atomics into dQ (one per dQ element per key tile). The causal and
// valid-length bounds remove whole tiles, which on right-padded batches is
// most of the work. wgmma, TMA and a dQ reduction without atomics are left
// for later work.

#include "flash_common.cuh"

namespace {

// lse/delta of query rows [row0, row0 + 64) into shared memory (0 past n)
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int row0, int n) {
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < n ? src[r] : 0.f;
  }
}

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
  float* dk;              // kv kernels: fp32 [B*Hq, Sk, D]
  float* dv;
  int Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, mask_sb;
  float scale;
  int causal, skip_pad_q;
};

template <int D, bool kFusedDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const BwdArgs a) {
  constexpr int LDS = D + kPad;
  constexpr int LDP = kTile + kPad;  // row stride of the staged dS
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * LDS;
  __nv_bfloat16* Qs = Vs + kTile * LDS;
  __nv_bfloat16* dOs = Qs + kTile * LDS;
  __nv_bfloat16* dSs = dOs + kTile * LDS;  // [64 queries][LDP], fused only
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ int key_ok[kTile];
  __shared__ int s_key_end;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int key0 = blockIdx.y * kTile;
  const int q_shift = a.Sk - a.Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const int key_end = block_key_end(mrow, a.Sk, &s_key_end);

  const __nv_bfloat16* qb = a.q + (long long)b * a.q_sb + (long long)h * a.q_sh;
  const __nv_bfloat16* dob = a.dout + (long long)b * a.do_sb + (long long)h * a.do_sh;
  const __nv_bfloat16* kb = a.k + (long long)b * a.k_sb + (long long)hk * a.k_sh;
  const __nv_bfloat16* vb = a.v + (long long)b * a.v_sb + (long long)hk * a.v_sh;
  const float* lse_row = a.lse + (long long)bh * a.Sq;
  const float* delta_row = a.delta + (long long)bh * a.Sq;

  load_tile<D>(Ks, kb, a.k_ss, key0, a.Sk);
  load_tile<D>(Vs, vb, a.v_ss, key0, a.Sk);
  if (tid < kTile) {
    key_ok[tid] = (key0 + tid < a.Sk) ? (mrow[key0 + tid] != 0) : 0;
  }
  __syncthreads();

  // this warp's 16 keys (rows of the S^T tile) as A fragments
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_rows<D>(kf, Ks, warp, g, t);
  load_a_rows<D>(vf, Vs, warp, g, t);
  const int key_a = key0 + warp * 16 + g;
  const int key_b = key_a + 8;
  const bool ok_a = key_ok[warp * 16 + g] != 0;
  const bool ok_b = key_ok[warp * 16 + g + 8] != 0;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // query tiles: from the diagonal (causal) to the end of the tiles the
  // forward ran; none when this key tile lies past the valid keys
  int qt_begin = 0;
  int qt_end = (a.Sq + kTile - 1) / kTile;
  if (key0 >= key_end) qt_end = 0;
  if (a.causal) qt_begin = max(0, key0 - q_shift) / kTile;
  if (a.skip_pad_q) {
    const int lim = key_end - q_shift;  // tile qt runs iff qt*64 < lim
    qt_end = min(qt_end, lim <= 0 ? 0 : (lim + kTile - 1) / kTile);
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kTile;
    load_tile<D>(Qs, qb, a.q_ss, q0, a.Sq);
    load_tile<D>(dOs, dob, a.do_ss, q0, a.Sq);
    load_stats(lse_s, lse_row, q0, a.Sq);
    load_stats(delta_s, delta_row, q0, a.Sq);
    __syncthreads();

    // S^T = K Q^T (16 keys x 64 queries per warp), then P^T in place
    float st[kTile / 8][4];
    mma_a_tileT<D>(st, kf, Qs, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int row = q0 + col;
        const int pos = row + q_shift;
        const bool qin = row < a.Sq;
        const float l = lse_s[col];
        const bool va = qin && ok_a && (!a.causal || key_a <= pos);
        const bool vb_ = qin && ok_b && (!a.causal || key_b <= pos);
        st[j][e] = va ? __expf(st[j][e] * a.scale - l) : 0.f;
        st[j][2 + e] = vb_ ? __expf(st[j][2 + e] * a.scale - l) : 0.f;
      }
    }

    // dV += P^T dO (P rounded to bf16)
    mma_c_tile<D>(dv, st, dOs, g, t);

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place
    float dpt[kTile / 8][4];
    mma_a_tileT<D>(dpt, vf, dOs, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = delta_s[j * 8 + 2 * t + e];
        st[j][e] = st[j][e] * (dpt[j][e] - dl) * a.scale;
        st[j][2 + e] = st[j][2 + e] * (dpt[j][2 + e] - dl) * a.scale;
      }
    }

    // dK += dS^T Q (dS rounded to bf16)
    mma_c_tile<D>(dk, st, Qs, g, t);

    if constexpr (kFusedDq) {
      // stage dS as [query][key] (bf16, the rounding dK used) ...
      const int r = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          dSs[col * LDP + r] = __float2bfloat16_rn(st[j][e]);
          dSs[col * LDP + r + 8] = __float2bfloat16_rn(st[j][2 + e]);
        }
      }
      __syncthreads();
      // ... then dQ rows [16 warp, 16 warp + 16) of this query tile over the
      // block's 64 keys: dS (16 x 64) K (64 x D), added to the fp32 buffer
      float dq[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
      }
      const __nv_bfloat16* s0 = dSs + (warp * 16 + g) * LDP + 2 * t;
      const __nv_bfloat16* s1 = s0 + 8 * LDP;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t af[4] = {ld_u32(s0 + kk * 16), ld_u32(s1 + kk * 16),
                          ld_u32(s0 + kk * 16 + 8), ld_u32(s1 + kk * 16 + 8)};
        const __nv_bfloat16* k0 = Ks + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const __nv_bfloat16* kp = k0 + n * 8;
          uint32_t bf[2] = {pack_pair(kp[0], kp[LDS]),
                            pack_pair(kp[8 * LDS], kp[9 * LDS])};
          mma_16816(dq[n], af, bf);
        }
      }
      const int ra = q0 + warp * 16 + g;
      const int rb = ra + 8;
      float* dqa = a.dq_acc + ((long long)bh * a.Sq + ra) * D + 2 * t;
      float* dqb = dqa + 8 * D;
      if (ra < a.Sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          atomicAdd(dqa + n * 8, dq[n][0]);
          atomicAdd(dqa + n * 8 + 1, dq[n][1]);
        }
      }
      if (rb < a.Sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          atomicAdd(dqb + n * 8, dq[n][2]);
          atomicAdd(dqb + n * 8 + 1, dq[n][3]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites Qs/dOs/dSs/stats
  }

  // dK/dV of this query head, fp32 (zeros for a tile that ran no queries)
  if (key_a < a.Sk) {
    float* pk = a.dk + ((long long)bh * a.Sk + key_a) * D + 2 * t;
    float* pv = a.dv + ((long long)bh * a.Sk + key_a) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(pk + n * 8) = make_float2(dk[n][0], dk[n][1]);
      *reinterpret_cast<float2*>(pv + n * 8) = make_float2(dv[n][0], dv[n][1]);
    }
  }
  if (key_b < a.Sk) {
    float* pk = a.dk + ((long long)bh * a.Sk + key_b) * D + 2 * t;
    float* pv = a.dv + ((long long)bh * a.Sk + key_b) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(pk + n * 8) = make_float2(dk[n][2], dk[n][3]);
      *reinterpret_cast<float2*>(pv + n * 8) = make_float2(dv[n][2], dv[n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LDS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kTile * LDS;
  __nv_bfloat16* Ks = dOs + kTile * LDS;
  __nv_bfloat16* Vs = Ks + kTile * LDS;
  __shared__ int key_ok[kTile];
  __shared__ int s_key_end;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_start = blockIdx.y * kTile;
  const int q_shift = a.Sk - a.Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int* mrow = a.mask + (long long)b * a.mask_sb;
  const int key_end = block_key_end(mrow, a.Sk, &s_key_end);

  const __nv_bfloat16* qb = a.q + (long long)b * a.q_sb + (long long)h * a.q_sh;
  const __nv_bfloat16* dob = a.dout + (long long)b * a.do_sb + (long long)h * a.do_sh;
  const __nv_bfloat16* kb = a.k + (long long)b * a.k_sb + (long long)hk * a.k_sh;
  const __nv_bfloat16* vb = a.v + (long long)b * a.v_sb + (long long)hk * a.v_sh;
  load_tile<D>(Qs, qb, a.q_ss, q_start, a.Sq);
  load_tile<D>(dOs, dob, a.do_ss, q_start, a.Sq);
  __syncthreads();

  // the forward's key-tile bounds
  int n_tiles = (key_end + kTile - 1) / kTile;
  if (a.causal) {
    const int last_pos = q_start + kTile - 1 + q_shift;
    const int diag_tiles = last_pos < 0 ? 0 : last_pos / kTile + 1;
    n_tiles = min(n_tiles, diag_tiles);
  }
  if (a.skip_pad_q && q_start + q_shift >= key_end) n_tiles = 0;

  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_rows<D>(qf, Qs, warp, g, t);
  load_a_rows<D>(dof, dOs, warp, g, t);

  const int row_a = q_start + warp * 16 + g;
  const int row_b = row_a + 8;
  const int pos_a = row_a + q_shift;
  const int pos_b = row_b + q_shift;
  const float* lse_row = a.lse + (long long)bh * a.Sq;
  const float* delta_row = a.delta + (long long)bh * a.Sq;
  const float lse_a = row_a < a.Sq ? lse_row[row_a] : 0.f;
  const float lse_b = row_b < a.Sq ? lse_row[row_b] : 0.f;
  const float dl_a = row_a < a.Sq ? delta_row[row_a] : 0.f;
  const float dl_b = row_b < a.Sq ? delta_row[row_b] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kTile;
    load_tile<D>(Ks, kb, a.k_ss, key0, a.Sk);
    load_tile<D>(Vs, vb, a.v_ss, key0, a.Sk);
    if (tid < kTile) {
      key_ok[tid] = (key0 + tid < a.Sk) ? (mrow[key0 + tid] != 0) : 0;
    }
    __syncthreads();

    float s[kTile / 8][4];
    mma_a_tileT<D>(s, qf, Ks, g, t);  // S = Q K^T
    float dp[kTile / 8][4];
    mma_a_tileT<D>(dp, dof, Vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int key = key0 + col;
        const bool ok = key_ok[col] != 0;
        const bool va = ok && (!a.causal || key <= pos_a);
        const bool vb_ = ok && (!a.causal || key <= pos_b);
        const float pa = va ? __expf(s[j][e] * a.scale - lse_a) : 0.f;
        const float pb = vb_ ? __expf(s[j][2 + e] * a.scale - lse_b) : 0.f;
        s[j][e] = pa * (dp[j][e] - dl_a) * a.scale;  // dS
        s[j][2 + e] = pb * (dp[j][2 + e] - dl_b) * a.scale;
      }
    }
    mma_c_tile<D>(dq, s, Ks, g, t);  // dQ += dS K (dS rounded to bf16)
    __syncthreads();  // before the next tile overwrites Ks/Vs/key_ok
  }

  if (row_a < a.Sq) {
    __nv_bfloat16* o = a.dq + (((long long)b * a.Sq + row_a) * a.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(dq[n][0], dq[n][1]);
    }
  }
  if (row_b < a.Sq) {
    __nv_bfloat16* o = a.dq + (((long long)b * a.Sq + row_b) * a.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(dq[n][2], dq[n][3]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const BwdArgs& a, int B, int rows, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * a.Hq, (rows + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

enum Which { kFused, kDkv, kDq };

template <int D>
int dispatch(Which which, const BwdArgs& a, int B, cudaStream_t st) {
  constexpr int tile_bytes = kTile * (D + kPad) * (int)sizeof(__nv_bfloat16);
  constexpr int dS_bytes = kTile * (kTile + kPad) * (int)sizeof(__nv_bfloat16);
  switch (which) {
    case kFused:
      return launch(flash_bwd_kv_kernel<D, true>, a, B, a.Sk,
                    4 * tile_bytes + dS_bytes, st);
    case kDkv:
      return launch(flash_bwd_kv_kernel<D, false>, a, B, a.Sk, 4 * tile_bytes, st);
    default:
      return launch(flash_bwd_dq_kernel<D>, a, B, a.Sq, 4 * tile_bytes, st);
  }
}

int run(Which which, const void* q, const void* k, const void* v,
        const int* mask, const void* dout, const float* lse,
        const float* delta, void* dq, float* dk, float* dv, int B, int Sq,
        int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh, long long do_sb,
        long long do_ss, long long do_sh, long long mask_sb, int causal,
        int skip_pad_q, void* stream) {
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
  a.dk = dk;
  a.dv = dv;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch<64>(which, a, B, st);
  if (D == 128) return dispatch<128>(which, a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t
// value; 0 is success. The caller validates shapes, types, strides and
// alignment, and zeroes the fused kernel's fp32 dq buffer.
#define RANKPO_BWD_PARAMS                                                     \
  const void *q, const void *k, const void *v, const int *mask,              \
      const void *dout, const float *lse, const float *delta, void *dq,      \
      float *dk, float *dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,   \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,        \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      long long mask_sb, int causal, int skip_pad_q, void *stream
#define RANKPO_BWD_ARGS                                                       \
  q, k, v, mask, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, q_sb,  \
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,   \
      mask_sb, causal, skip_pad_q, stream

// K2: dq (fp32, atomics), dk, dv (fp32 per q-head) in one pass
extern "C" int rankpo_flash_bwd_fused_bf16(RANKPO_BWD_PARAMS) {
  return run(kFused, RANKPO_BWD_ARGS);
}

// K3b: dk, dv (fp32 per q-head); dq is ignored
extern "C" int rankpo_flash_bwd_dkv_bf16(RANKPO_BWD_PARAMS) {
  return run(kDkv, RANKPO_BWD_ARGS);
}

// K3a: dq (bf16, [B, Sq, Hq, D]); dk and dv are ignored
extern "C" int rankpo_flash_bwd_dq_bf16(RANKPO_BWD_PARAMS) {
  return run(kDq, RANKPO_BWD_ARGS);
}
