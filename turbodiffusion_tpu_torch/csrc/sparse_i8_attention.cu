// K7, K19 and K28: block-sparse INT8 SageSLA attention for sm_90a.
//
// K7 tdx_sparse_attention_i8_vt replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:sparse_attention_i8_vt (body
//    _sparse_attn_kernel_i8b_vt), with its fused SLA linear-branch epilogue:
//    each block_q-row Q block attends to the `sel` K blocks its LUT row
//    names; scores are int8 q . int8 k (smooth-k, one scale per K block)
//    times the q row scale, V is int8 per channel (the transposed panel K6
//    writes), and the output is bf16 planes (B, H, Lp, 128).
//
// What bounds it on an H100: tensor-core math. At the 1.3B 480p shape a call
// is 6.2e11 operations (12 heads x 32,768 rows x 3,072 keys x 128 x 2 x 2)
// over ~100 MB of panels, far above the ridge. The design is K3's
// FlashAttention-2 loop on mma.sync with the QK product in int8:
//   * one block of 4 warps owns 64 query rows of one (b, h); each warp keeps
//     its 16 rows' int8 Q fragments (16 registers, half of K3's bf16 ones),
//     a 16 x 128 fp32 accumulator and the running max / sum in registers;
//   * 64-key chunks of the selected blocks stream through shared memory: K
//     as int8 rows (row stride 144 bytes, so fragment loads hit 32 banks), V
//     converted from int8 to bf16 (exact) as it is staged, already
//     transposed by K6 so no transpose is needed here;
//   * S = Q K^T on mma.sync m16n8k32 s8 x s8 -> s32 (exact), scaled by the
//     q row scale and the K block scale (which carries Dh^-0.5 * log2 e);
//     keys >= kv_len are set to -1e9 before the row max, so garbage in the
//     tail of the last block can never win it; chunks wholly past kv_len are
//     skipped;
//   * an online softmax in the log2 domain (the TPU kernel holds all
//     sel * block_k = 3,072 scores of a row at once; that only changes where
//     p is rounded to bf16), then O += P V on mma.sync m16n8k16 bf16 with P
//     taken from the S accumulators as A fragments;
//   * epilogue: o / max(l, 1e-20) * vch, and with the linear branch
//     phi(q) = softmax_D(q_i8 * qs) (from global q, a quad of threads per
//     row), o += phi(q) kvw / (1e-5 + phi(q) . ksum) + bias in fp32, with
//     phi staged in shared memory and kvw streamed through it 8 rows at a
//     time.
// A first, simple version: synchronous loads (no cp.async or TMA ring) and
// no wgmma; both are later work.
//
// K19 tdx_sparse_attention_i8_planes replaces the per-row form of the TPU
//    kernel turbodiffusion_tpu/ops/flash_pallas.py:sparse_attention_i8_planes
//    (body _sparse_attn_kernel_i8, metadata rows built at :1391-1421), the
//    v_quant=row path: int8 Q with per-row scales (the softmax scale folded
//    in, qs * Dh^-0.5), and K18's packed (B, H, Lk, 256) K|V rows with
//    per-row fp32 K and V scales.
//    s = (int32(q . k) * (qs * Dh^-0.5)) * ks, natural exp (the TPU kernel's
//    domain), and V's row scale folded into P before its bf16 rounding:
//    O += bf16(p * vs) bf16(v_i8); o = O / max(l, 1e-20) with l the sum of
//    the unscaled p. Bound like K7 by tensor-core math (the same pair count;
//    the PV product scales P per key instead of O per channel). K7's main
//    loop with three changes: the K and V halves of a chunk come from one
//    packed 256-byte row a key (V converted to bf16 and transposed as it is
//    staged, as K3 stages bf16 V); the chunk's 64 K and V row scales are
//    staged in shared memory, the V scales zeroed past kv_len; p is
//    rescaled per key before it is packed into the A fragments of P V.
//    Keys at or past kv_len get -1e30 before the row max: the port's rule
//    for K3 / K4 / K7, which replaces the TPU's poison block (LUT padding
//    pointing at a zero block with a -1e30 bias).

//
// K28 tdx_sparse_attention_i8_planes_bs replaces the block-scale form of
//    flash_pallas.py:sparse_attention_i8_planes (body _sparse_attn_kernel_i8b,
//    wrapper :1345-1390), which fused sagesla at v_quant=channel takes once
//    sel * block_k exceeds 8,192 (480p at --sla_topk 0.3: 38 of 128 blocks):
//    K19's walk over K27's packed K|V rows with K7's scoring: one K scale a
//    block, read from the (B, H, nK) table and multiplied by Dh^-0.5 *
//    log2 e (the TPU wrapper folds both into its table, not into qs),
//    s = (int32(q . k) * qs) * that, keys >= kv_len at -1e9 before the row
//    max (K27 quantises rows past kv_len, which may have been NaN, with the
//    block's scale; they never reach a live score), exp2, O += bf16(p)
//    bf16(v_i8), o = O / max(l, 1e-20) * vch. Bound like K7 (the same
//    pair count; K19's gather of 256-byte rows, one stream a key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_step.cuh"

namespace {

constexpr int kDh = 128;
constexpr int kBM = 64;                      // query rows per block
constexpr int kBN = 64;                      // keys per chunk
constexpr int kThreads = 128;
constexpr int kKStride = kDh + 16;           // bytes per int8 row of Ks / Q staging
constexpr int kVStride = kBN + 8;            // bf16 per row of Vt
constexpr int kPhiStride = kDh + 4;          // floats per row of phi
constexpr int kKvRows = 8;                   // kvw rows per epilogue step
constexpr int kMainBytes = kBM * kKStride + kDh * kVStride * 2;
constexpr int kEpiBytes = (kBM * kPhiStride + kKvRows * kDh) * 4;
constexpr int kSmemBytes = kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes;
constexpr float kNegInf = -1e30f;            // running-max start
constexpr float kMasked = -1e9f;             // score of a key >= kv_len

__global__ void __launch_bounds__(kThreads)
sparse_i8_vt_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qs,
                    const int8_t* __restrict__ kp, const int8_t* __restrict__ vtp,
                    const float* __restrict__ ks, const float* __restrict__ vch,
                    const int* __restrict__ lut, const float* __restrict__ kvw,
                    const float* __restrict__ ksb, __nv_bfloat16* __restrict__ out,
                    int H, int Lp, int Lkp, int kv_len, int nQ, int sel, int block_q,
                    int block_k, float scale_log2) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + kBM * kKStride);

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int nK = Lkp / block_k;

  // Q rows -> int8 A fragments (m16n8k32: rows g / g + 8, bytes t*4 (+16))
  const int8_t* qb = qi + (bh * Lp + row0) * kDh;
  for (int u = threadIdx.x; u < kBM * (kDh / 16); u += kThreads) {
    const int r = u >> 3, c = u & 7;
    *reinterpret_cast<uint4*>(Ks + r * kKStride + c * 16) =
        *reinterpret_cast<const uint4*>(qb + (size_t)r * kDh + c * 16);
  }
  __syncthreads();
  uint32_t qa[kDh / 32][4];
  {
    const int8_t* base = Ks + (warp * 16) * kKStride;
#pragma unroll
    for (int kk = 0; kk < kDh / 32; ++kk) {
      qa[kk][0] = lds32(base + g * kKStride + kk * 32 + t * 4);
      qa[kk][1] = lds32(base + (g + 8) * kKStride + kk * 32 + t * 4);
      qa[kk][2] = lds32(base + g * kKStride + kk * 32 + 16 + t * 4);
      qa[kk][3] = lds32(base + (g + 8) * kKStride + kk * 32 + 16 + t * 4);
    }
  }
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const float qs0 = qs[bh * Lp + r0], qs1 = qs[bh * Lp + r1];

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;

  const int* lut_row = lut + (bh * nQ + row0 / block_q) * sel;
  const int per = block_k / kBN;
  const int n_chunks = sel * per;
  for (int c = 0; c < n_chunks; ++c) {
    const int kb = lut_row[c / per];
    const int off = (c % per) * kBN;
    const int key0 = kb * block_k + off;
    // an id out of range, or a chunk wholly past the tail: no valid key
    if (kb < 0 || kb >= nK || key0 >= kv_len) continue;
    const float ks_eff = ks[bh * nK + kb] * scale_log2;
    __syncthreads();  // previous chunk (or the Q staging) fully consumed
    const int8_t* ksrc = kp + (bh * Lkp + key0) * kDh;
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u >> 3, cc = u & 7;
      *reinterpret_cast<uint4*>(Ks + r * kKStride + cc * 16) =
          *reinterpret_cast<const uint4*>(ksrc + (size_t)r * kDh + cc * 16);
    }
    const int8_t* vsrc = vtp + (bh * nK + kb) * (size_t)kDh * block_k + off;
    for (int u = threadIdx.x; u < kDh * (kBN / 16); u += kThreads) {
      const int d = u >> 2, c16 = u & 3;
      const uint4 val = *reinterpret_cast<const uint4*>(vsrc + (size_t)d * block_k + c16 * 16);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&val);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)q8[2 * e], (float)q8[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>(Vt + d * kVStride + c16 * 16);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();

    // S = Q K^T (exact int32) for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < kDh / 32; ++kk) {
        const int8_t* kq = Ks + (j * 8 + g) * kKStride + kk * 32 + t * 4;
        mma_s8(si, qa[kk], lds32(kq), lds32(kq + 16));
      }
      // (s32 * qs) * ks * Dh^-0.5 * log2 e, keys >= kv_len masked
      const int nvalid = kv_len - key0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float v = __fmul_rn(__fmul_rn((float)si[e], e < 2 ? qs0 : qs1), ks_eff);
        s[j][e] = col < nvalid ? v : kMasked;
      }
    }

    // log2 domain; O += P V with bf16 P taken from the S accumulators
    softmax_pv_step<true, kVStride>(s, acc, m0, m1, l0, l1, Vt);
  }

  // o = acc / max(l, 1e-20) * vch
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  const float* vc = vch + bh * kDh;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const float2 sc = *reinterpret_cast<const float2*>(vc + d * 8 + t * 2);
    acc[d][0] = __fmul_rn(acc[d][0] / l0, sc.x);
    acc[d][1] = __fmul_rn(acc[d][1] / l0, sc.y);
    acc[d][2] = __fmul_rn(acc[d][2] / l1, sc.x);
    acc[d][3] = __fmul_rn(acc[d][3] / l1, sc.y);
  }

  if (kvw != nullptr) {
    // the SLA linear branch: o += phi(q) kvw / (1e-5 + phi(q) . ksum) + b
    __syncthreads();  // the main loop's Ks / Vt are dead: reuse as phi
    float* phi = reinterpret_cast<float*>(smem);
    float* kvs = phi + kBM * kPhiStride;
    const float* ksum = ksb + bh * 2 * kDh;
    const float* bias = ksum + kDh;
    float den[2];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int rl = warp * 16 + g + 8 * which;
      const float qsr = which ? qs1 : qs0;
      const int8_t* qrow = qi + (bh * Lp + row0 + rl) * kDh + t * 32;
      uint4 raw[2];
      raw[0] = *reinterpret_cast<const uint4*>(qrow);
      raw[1] = *reinterpret_cast<const uint4*>(qrow + 16);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(raw);
      float f[32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        f[i] = __fmul_rn((float)q8[i], qsr);
        mx = fmaxf(mx, f[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        f[i] = expf(f[i] - mx);
        sum += f[i];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        f[i] = f[i] / sum;
        dp += f[i] * ksum[t * 32 + i];
        phi[rl * kPhiStride + t * 32 + i] = f[i];
      }
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      den[which] = 1e-5f + dp;
    }
    const int rl0 = warp * 16 + g, rl1 = rl0 + 8;
    float num[kDh / 8][4];
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) num[d][0] = num[d][1] = num[d][2] = num[d][3] = 0.f;
    const float* kw = kvw + bh * kDh * kDh;
    for (int d0 = 0; d0 < kDh; d0 += kKvRows) {
      __syncthreads();  // phi written / the previous kvw rows consumed
      for (int u = threadIdx.x; u < kKvRows * kDh / 4; u += kThreads)
        reinterpret_cast<float4*>(kvs)[u] =
            reinterpret_cast<const float4*>(kw + (size_t)d0 * kDh)[u];
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kKvRows; ++dd) {
        const float p0 = phi[rl0 * kPhiStride + d0 + dd];
        const float p1 = phi[rl1 * kPhiStride + d0 + dd];
#pragma unroll
        for (int d = 0; d < kDh / 8; ++d) {
          const float2 kv2 = *reinterpret_cast<const float2*>(kvs + dd * kDh + d * 8 + t * 2);
          num[d][0] = fmaf(p0, kv2.x, num[d][0]);
          num[d][1] = fmaf(p0, kv2.y, num[d][1]);
          num[d][2] = fmaf(p1, kv2.x, num[d][2]);
          num[d][3] = fmaf(p1, kv2.y, num[d][3]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + d * 8 + t * 2);
      acc[d][0] = (acc[d][0] + num[d][0] / den[0]) + bb.x;
      acc[d][1] = (acc[d][1] + num[d][1] / den[0]) + bb.y;
      acc[d][2] = (acc[d][2] + num[d][2] / den[1]) + bb.x;
      acc[d][3] = (acc[d][3] + num[d][3] / den[1]) + bb.y;
    }
  }

  __nv_bfloat16* ob = out + bh * Lp * kDh;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kDh + col) = pack_bf16(acc[d][0], acc[d][1]);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kDh + col) = pack_bf16(acc[d][2], acc[d][3]);
  }
}


// K19 (BS false) and K28 (BS true). Grid (Lp / 64, H, B), 4 warps of 16
// query rows. K19: ks and vs are per-key row scales (B, H, Lkp) and `scale`
// is Dh^-0.5; K28: ks is the per-block table (B, H, nK), vs the per-channel
// V scale (B, H, 128) and `scale` is Dh^-0.5 * log2 e.
template <bool BS>
__global__ void __launch_bounds__(kThreads)
sparse_i8_planes_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qs,
                        const int8_t* __restrict__ kvi, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lut,
                        __nv_bfloat16* __restrict__ out, int H, int Lp, int Lkp, int kv_len,
                        int nQ, int sel, int block_q, int block_k, float scale) {
  __shared__ __align__(16) unsigned char smem[kMainBytes];
  __shared__ float s_ks[kBN], s_vs[kBN];
  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + kBM * kKStride);

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int nK = Lkp / block_k;

  // Q rows -> int8 A fragments, as K7
  const int8_t* qb = qi + (bh * Lp + row0) * kDh;
  for (int u = threadIdx.x; u < kBM * (kDh / 16); u += kThreads) {
    const int r = u >> 3, c = u & 7;
    *reinterpret_cast<uint4*>(Ks + r * kKStride + c * 16) =
        *reinterpret_cast<const uint4*>(qb + (size_t)r * kDh + c * 16);
  }
  __syncthreads();
  uint32_t qa[kDh / 32][4];
  {
    const int8_t* base = Ks + (warp * 16) * kKStride;
#pragma unroll
    for (int kk = 0; kk < kDh / 32; ++kk) {
      qa[kk][0] = lds32(base + g * kKStride + kk * 32 + t * 4);
      qa[kk][1] = lds32(base + (g + 8) * kKStride + kk * 32 + t * 4);
      qa[kk][2] = lds32(base + g * kKStride + kk * 32 + 16 + t * 4);
      qa[kk][3] = lds32(base + (g + 8) * kKStride + kk * 32 + 16 + t * 4);
    }
  }
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  // K19: the softmax scale folds into the row scale (flash_pallas.py:1319);
  // K28: it rides the K block-scale table, as the TPU wrapper folds it
  const float qs0 = BS ? qs[bh * Lp + r0] : __fmul_rn(qs[bh * Lp + r0], scale);
  const float qs1 = BS ? qs[bh * Lp + r1] : __fmul_rn(qs[bh * Lp + r1], scale);

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;

  const int* lut_row = lut + (bh * nQ + row0 / block_q) * sel;
  const int per = block_k / kBN;
  const int n_chunks = sel * per;
  for (int c = 0; c < n_chunks; ++c) {
    const int kb = lut_row[c / per];
    const int key0 = kb * block_k + (c % per) * kBN;
    if (kb < 0 || kb >= nK || key0 >= kv_len) continue;
    __syncthreads();  // previous chunk (or the Q staging) fully consumed
    const int8_t* src = kvi + (bh * Lkp + key0) * (2 * kDh);
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u >> 3, cc = u & 7;
      *reinterpret_cast<uint4*>(Ks + r * kKStride + cc * 16) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * 2 * kDh + cc * 16);
    }
    // V half -> bf16 (exact), transposed: keys walk fastest so the 2-byte
    // shared stores of a warp fall in distinct words
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u % kBN, c16 = u / kBN;
      const uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * 2 * kDh + kDh + c16 * 16);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int e = 0; e < 16; ++e) Vt[(c16 * 16 + e) * kVStride + r] = __float2bfloat16_rn((float)q8[e]);
    }
    if (!BS && threadIdx.x < kBN) {
      const int key = key0 + threadIdx.x;
      const bool live = key < kv_len;
      s_ks[threadIdx.x] = live ? ks[bh * Lkp + key] : 0.f;
      s_vs[threadIdx.x] = live ? vs[bh * Lkp + key] : 0.f;
    }
    // K28: the block's scale times Dh^-0.5 * log2 e (the TPU wrapper's
    // table), one product in fp32
    const float kb_scale = BS ? __fmul_rn(ks[bh * nK + kb], scale) : 0.f;
    __syncthreads();

    // K19: s = (s32 * qs') * ks[key], keys >= kv_len at -1e30; K28: s =
    // (s32 * qs) * kb_scale in the log2 domain, keys >= kv_len at -1e9
    // before the row max
    const int nvalid = kv_len - key0;
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < kDh / 32; ++kk) {
        const int8_t* kq = Ks + (j * 8 + g) * kKStride + kk * 32 + t * 4;
        mma_s8(si, qa[kk], lds32(kq), lds32(kq + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float v = __fmul_rn(__fmul_rn((float)si[e], e < 2 ? qs0 : qs1),
                                  BS ? kb_scale : s_ks[col]);
        s[j][e] = col < nvalid ? v : (BS ? kMasked : kNegInf);
      }
    }

    if constexpr (BS) {
      // exp2; O += bf16(p) V, V's channel scale at the finalize
      softmax_pv_step<true, kVStride>(s, acc, m0, m1, l0, l1, Vt);
    } else {
      // natural exp; O += bf16(p * vs) V
      softmax_pv_step<false, kVStride>(s, acc, m0, m1, l0, l1, Vt, s_vs);
    }
  }

  // o = acc / max(l, 1e-20) (K28: times the per-channel V scale)
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* ob = out + bh * Lp * kDh;
  const float* vc = vs + bh * kDh;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    float o[4] = {__fdiv_rn(acc[d][0], l0), __fdiv_rn(acc[d][1], l0),
                  __fdiv_rn(acc[d][2], l1), __fdiv_rn(acc[d][3], l1)};
    if constexpr (BS) {
      const float2 sc = *reinterpret_cast<const float2*>(vc + col);
      o[0] = __fmul_rn(o[0], sc.x);
      o[1] = __fmul_rn(o[1], sc.y);
      o[2] = __fmul_rn(o[2], sc.x);
      o[3] = __fmul_rn(o[3], sc.y);
    }
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kDh + col) = pack_bf16(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kDh + col) = pack_bf16(o[2], o[3]);
  }
}

}  // namespace

extern "C" int tdx_sparse_attention_i8_vt(
    const void* qi, const void* qs, const void* kp, const void* vtp, const void* ks,
    const void* vch, const void* lut, const void* kvw, const void* ksb, void* out,
    int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel, int block_q,
    int block_k, float scale_log2, void* stream) {
  if (Lp % kBM || block_q % kBM || block_k % kBN) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / kBM, H, B);
  sparse_i8_vt_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)qs, (const int8_t*)kp, (const int8_t*)vtp,
      (const float*)ks, (const float*)vch, (const int*)lut, (const float*)kvw,
      (const float*)ksb, (__nv_bfloat16*)out, H, Lp, Lkp, kv_len, nQ, sel, block_q,
      block_k, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_attention_i8_planes(
    const void* qi, const void* qs, const void* kvi, const void* ks, const void* vs,
    const void* lut, void* out, int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel,
    int block_q, int block_k, float scale, void* stream) {
  if (Lp % kBM || block_q % kBM || block_k % kBN) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / kBM, H, B);
  sparse_i8_planes_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)qs, (const int8_t*)kvi, (const float*)ks,
      (const float*)vs, (const int*)lut, (__nv_bfloat16*)out, H, Lp, Lkp, kv_len, nQ, sel,
      block_q, block_k, scale);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_attention_i8_planes_bs(
    const void* qi, const void* qs, const void* kvi, const void* ks, const void* vch,
    const void* lut, void* out, int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel,
    int block_q, int block_k, float scale_log2, void* stream) {
  if (Lp % kBM || block_q % kBM || block_k % kBN) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / kBM, H, B);
  sparse_i8_planes_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)qs, (const int8_t*)kvi, (const float*)ks,
      (const float*)vch, (const int*)lut, (__nv_bfloat16*)out, H, Lp, Lkp, kv_len, nQ, sel,
      block_q, block_k, scale_log2);
  return (int)cudaGetLastError();
}
