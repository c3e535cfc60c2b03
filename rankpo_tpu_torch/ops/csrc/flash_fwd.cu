// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel rankpo_tpu/ops/flash_attention.py:_fwd_kernel
// (FlashAttention-2 forward: online softmax over key blocks with fp32 running
// max and sum, returning O and the logsumexp).
//
// Contract (what _fwd_kernel computes):
//   q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16, read through their strides
//   (the head_dim stride must be 1); mask [B, Sk] int32, non-zero = valid key.
//   scale 1/sqrt(D); logits in fp32; causal alignment is bottom-right
//   (query row r sits at position r + Sk - Sq); P is rounded to bf16 before the
//   PV product; rows with no valid key output exact zeros; lse = m + log(l).
//   GQA: query head h reads kv head h / (Hq / Hkv), K/V are never copied.
//   skip_pad_q: a query tile whose first position is at or past the valid key
//   length runs no key tiles, so its rows output zeros (block-granular, as in
//   the JAX kernel; only rows below the valid length are meaningful).
//   The loop over key tiles stops at the last valid key and, when causal, at
//   the diagonal.
//
// Design. One thread block of 4 warps owns one (batch*q-head, 64-row query
// tile) pair; each warp owns 16 query rows. Key/value tiles of 64 rows are
// staged in shared memory with 16-byte vector loads; Q K^T and P V run on the
// tensor cores with mma.sync m16n8k16 (bf16 -> fp32). The online-softmax
// state (row max m, row sum l, output accumulator) lives in registers, and P
// goes from the S accumulators straight into the A operand of the PV product
// without touching shared memory.
//
// What bounds it on this card. At the serving shapes (S <= 512, D = 64) the
// whole per-head K/V is at most 128 KB, so the kernel reads each byte of
// Q/K/V/O about once per query tile: it is bound by latency and occupancy,
// not by HBM bandwidth or the tensor-core peak, and attention is a small share
// of a layer next to the projections. The design answers with small tiles
// (many blocks in flight: B*Hq*ceil(Sq/64) blocks, ~28 KB of shared memory
// each at D = 64, so several blocks per SM) and with skipping whole key tiles
// past the valid length and above the diagonal, which on right-padded
// batches removes most of the work. wgmma, TMA and warp specialisation are
// left for later work.

#include "flash_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long mask_sb, float scale, int causal, int skip_pad_q) {
  constexpr int LDS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile * LDS;
  __nv_bfloat16* Vs = Ks + kTile * LDS;
  __shared__ int key_ok[kTile];
  __shared__ int s_key_end;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_start = blockIdx.y * kTile;
  const int q_shift = Sk - Sq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // mma group: rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // thread in group: columns 2t, 2t + 1 (+ 8)

  const int* mrow = mask + (long long)b * mask_sb;

  // valid key extent: one past the last valid key (the valid key count on
  // right-padded rows, which is what bounds the JAX kernel's loop)
  const int key_end = block_key_end(mrow, Sk, &s_key_end);

  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;
  load_tile<D>(Qs, qb, q_ss, q_start, Sq);
  __syncthreads();

  int n_tiles = (key_end + kTile - 1) / kTile;
  if (causal) {
    const int last_pos = q_start + kTile - 1 + q_shift;  // last row's position
    const int diag_tiles = last_pos < 0 ? 0 : last_pos / kTile + 1;
    n_tiles = min(n_tiles, diag_tiles);
  }
  if (skip_pad_q && q_start + q_shift >= key_end) n_tiles = 0;

  // this warp's Q rows as mma A fragments, kept in registers for all tiles
  uint32_t qf[D / 16][4];
  load_a_rows<D>(qf, Qs, warp, g, t);

  const int row_a = q_start + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const int pos_a = row_a + q_shift;
  const int pos_b = row_b + q_shift;

  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sum
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kTile;
    load_tile<D>(Ks, kb, k_ss, key0, Sk);
    load_tile<D>(Vs, vb, v_ss, key0, Sk);
    if (tid < kTile) {
      key_ok[tid] = (key0 + tid < Sk) ? (mrow[key0 + tid] != 0) : 0;
    }
    __syncthreads();

    // S = Q K^T: 8 key columns per n-tile
    float s[kTile / 8][4];
    mma_a_tileT<D>(s, qf, Ks, g, t);

    // scale, mask, row max
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int key = key0 + col;
        const bool ok = key_ok[col] != 0;
        const bool va = ok && (!causal || key <= pos_a);
        const bool vb_ = ok && (!causal || key <= pos_b);
        s[j][e] = va ? s[j][e] * scale : kNegInf;
        s[j][2 + e] = vb_ ? s[j][2 + e] * scale : kNegInf;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
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
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = s[j][e] > kNegInf ? __expf(s[j][e] - mn_a) : 0.f;
        const float pb = s[j][2 + e] > kNegInf ? __expf(s[j][2 + e] - mn_b) : 0.f;
        s[j][e] = pa;
        s[j][2 + e] = pb;
        ps_a += pa;
        ps_b += pb;
      }
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha_a;
      acc[n][1] *= alpha_a;
      acc[n][2] *= alpha_b;
      acc[n][3] *= alpha_b;
    }

    // O += P V, with P rounded to bf16 (the S accumulator layout is the A
    // fragment layout of the next product)
    mma_c_tile<D>(acc, s, Vs, g, t);
    __syncthreads();  // before the next tile overwrites Ks/Vs/key_ok
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float ls_a = l_a == 0.f ? 1.f : l_a;  // no valid key -> zeros, not NaN
  const float ls_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / ls_a;
  const float inv_b = 1.f / ls_b;

  if (row_a < Sq) {
    __nv_bfloat16* o = out + (((long long)b * Sq + row_a) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    }
    if (t == 0) lse[(long long)bh * Sq + row_a] = m_a + logf(ls_a);
  }
  if (row_b < Sq) {
    __nv_bfloat16* o = out + (((long long)b * Sq + row_b) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
    }
    if (t == 0) lse[(long long)bh * Sq + row_b] = m_b + logf(ls_b);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long mask_sb, int causal, int skip_pad_q,
           cudaStream_t stream) {
  const int smem = 3 * kTile * (D + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Sq + kTile - 1) / kTile);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), mask,
      reinterpret_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv, q_sb, q_ss,
      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, mask_sb,
      rsqrtf((float)D), causal, skip_pad_q);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t value; 0 is
// success. The caller validates shapes, types, strides and alignment.
extern "C" int rankpo_flash_fwd_bf16(
    const void* q, const void* k, const void* v, const int* mask, void* out,
    float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long mask_sb, int causal, int skip_pad_q, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch<64>(q, k, v, mask, out, lse, B, Sq, Sk, Hq, Hkv, q_sb, q_ss,
                      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, mask_sb, causal,
                      skip_pad_q, st);
  }
  if (D == 128) {
    return launch<128>(q, k, v, mask, out, lse, B, Sq, Sk, Hq, Hkv, q_sb, q_ss,
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, mask_sb,
                       causal, skip_pad_q, st);
  }
  return (int)cudaErrorInvalidValue;
}
