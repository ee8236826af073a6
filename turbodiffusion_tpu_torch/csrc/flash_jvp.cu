// K25 and K26: forward-mode (JVP) flash attention for sm_90a, dense and
// block-sparse: the attention output and its tangent in one online-softmax
// pass, for the sCM tangent of rCM distillation.
//
// K25 tdx_flash_attention_jvp replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_jvp_pallas.py:_flash_jvp_dense_pallas
//    (launch :170, body _jvp_kernel :85): softmax attention over all kv_len
//    keys (self attention of a dense student, cross attention over the 512
//    text tokens of every student).
// K26 tdx_sparse_flash_attention_jvp replaces _flash_jvp_sparse_pallas
//    (launch :367, body _sparse_jvp_kernel :198): the same recurrence over
//    the `sel` K-blocks of block_k rows that each block_q-row Q-block's LUT
//    row names (self attention of an sla student).
//
// With S = scale q k^T, dS = scale (dq k^T + q dk^T) and, over the streamed
// keys, the running max m, P = exp(S - m), l = rowsum P, mu = rowsum P dS:
//     acc_o += P v,   acc_t += (P dS) v + P dv    (both rescaled on a new max)
//     o = acc_o / l,  do = acc_t / l - (mu / l) o
// which is (P / l)(dS - mu / l) v + (P / l) dv, the JVP of softmax(S) v. P
// and P dS are rounded to bf16 before their products with v and dv, as the
// TPU kernel's `.astype(v.dtype)` dots round them; everything else is fp32.
// Columns at or past kv_len take S = -1e30 and dS = 0 (P = 0); query rows
// at or past Lq are never written.
//
// What bounds them on an H100: tensor-core math. Six products a tile where
// the forward (K3 / K4) has two: S, dq k^T, q dk^T, P v, (P dS) v, P dv. At
// the 1.3B 480p/81f training shape (32,760 tokens, 12 heads) a K25 self call
// is ~2.0e13 FLOPs (20 ms at the bf16 dense peak), a cross call over 512
// keys ~3.1e11, and a K26 call at 512/256 with 12 of 128 K-blocks ~1.9e12,
// against ~300 MB of inputs and outputs. The design is K23's (row_tiles.cuh):
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), one block of 4 warps owning
// 64 query rows of one (batch, head), each warp 16 of them with its two
// 16x128 fp32 accumulators (acc_o, acc_t) in registers; K, dK (row-major),
// V and dV (transposed) stream through shared memory in 64-key chunks, each
// taken in two 32-key steps so that S and dS, the two accumulators and the
// fragments fit the register file. Q and dQ are staged once in shared
// memory and their A fragments read per step; P and P dS go from the
// accumulators straight into A fragments, and each fragment of V^T feeds
// both of the products that read it.
// Tails: the kernels loop over exactly ceil(kv_len / 64) chunks (K25) or
// `sel` LUT entries (K26; no entry is padded and no poison block appended,
// where the TPU pads its LUT to a gather group), skip chunks wholly past
// kv_len and zero-fill key rows past it, so whatever the buffers hold there
// never enters a product. Head dim 128 only.
// A first, simple version: loads are synchronous (no cp.async/TMA ring) and
// there is no wgmma; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

// S = X K^T and dS = dX K^T + X dK^T for the warp's 16 rows against the
// streamed rows [r0, r0 + 32): X, dX the staged query tiles (A), K, dK the
// streamed row-major tiles (B).
__device__ __forceinline__ void jvp_products(float (&s)[kStep / 8][4], float (&ds)[kStep / 8][4],
                                             const __nv_bfloat16* xs, const __nv_bfloat16* dxs,
                                             const __nv_bfloat16* ks, const __nv_bfloat16* dks,
                                             int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t ax[4], adx[4];
    a_frag(ax, xs, kk);
    a_frag(adx, dxs, kk);
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
      const int off = (r0 + j * 8 + g) * kStride + kk * 16 + t * 2;
      const uint32_t k0 = lds32(ks + off), k1 = lds32(ks + off + 8);
      mma_bf16(s[j], ax, k0, k1);
      mma_bf16(ds[j], adx, k0, k1);
      mma_bf16(ds[j], ax, lds32(dks + off), lds32(dks + off + 8));
    }
  }
}

// acc_o += P V, acc_t += (P dS) V + P dV over the 32 streamed keys
// [r0, r0 + 32): p, pds the warp's (16 x 32) fp32 values in the accumulator
// layout, rounded to bf16 A fragments here; vt, dvt the chunk's V and dV
// transposed (128 rows of kTStride).
__device__ __forceinline__ void jvp_accumulate(float (&acc_o)[kDh / 8][4],
                                               float (&acc_t)[kDh / 8][4],
                                               const float (&p)[kStep / 8][4],
                                               const float (&pds)[kStep / 8][4],
                                               const __nv_bfloat16* vt,
                                               const __nv_bfloat16* dvt, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    uint32_t ap[4], ad[4];
    ap[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    ap[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    ap[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    ap[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    ad[0] = pack_bf16(pds[2 * kk][0], pds[2 * kk][1]);
    ad[1] = pack_bf16(pds[2 * kk][2], pds[2 * kk][3]);
    ad[2] = pack_bf16(pds[2 * kk + 1][0], pds[2 * kk + 1][1]);
    ad[3] = pack_bf16(pds[2 * kk + 1][2], pds[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      const int off = (d * 8 + g) * kTStride + r0 + kk * 16 + t * 2;
      const uint32_t v0 = lds32(vt + off), v1 = lds32(vt + off + 8);
      mma_bf16(acc_o[d], ap, v0, v1);
      mma_bf16(acc_t[d], ad, v0, v1);
      mma_bf16(acc_t[d], ap, lds32(dvt + off), lds32(dvt + off + 8));
    }
  }
}

// K25 (SPARSE false) and K26. Grid (ceil(Lq / 64), H, B): query rows
// [64 x, 64 x + 64).
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads)
flash_jvp_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dq,
                 const __nv_bfloat16* __restrict__ dk, const __nv_bfloat16* __restrict__ dv,
                 __nv_bfloat16* __restrict__ o, __nv_bfloat16* __restrict__ dout,
                 const int* __restrict__ lut, int H, int Lq, int kv_len, int nQ, int sel,
                 int block_q, int block_k, Strides qs, Strides ks, Strides vs, Strides dqs,
                 Strides dks, Strides dvs, Strides os, Strides dos, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dQs = Qs + kTile;
  __nv_bfloat16* Ks = dQs + kTile;
  __nv_bfloat16* dKs = Ks + kTile;
  __nv_bfloat16* Vt = dKs + kTile;
  __nv_bfloat16* dVt = Vt + kTTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<false>(Qs, nullptr, q + b * qs.b + h * qs.h, qs.l, row0, Lq);
  load_tile<false>(dQs, nullptr, dq + b * dqs.b + h * dqs.h, dqs.l, row0, Lq);

  float acc_o[kDh / 8][4], acc_t[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[d][e] = acc_t[d][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain), rows g, g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  float mu0 = 0.f, mu1 = 0.f;        // ... and of rowsum(P dS)

  const int per = block_k / kRows;
  const int n_chunks = SPARSE ? sel * per : (kv_len + kRows - 1) / kRows;
  const int* lut_row =
      SPARSE ? lut + (((long long)b * H + h) * nQ + row0 / block_q) * sel : nullptr;
  const long long kofs = b * ks.b + h * ks.h, dkofs = b * dks.b + h * dks.h;
  const long long vofs = b * vs.b + h * vs.h, dvofs = b * dvs.b + h * dvs.h;
  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = SPARSE ? lut_row[c / per] * block_k + (c % per) * kRows : c * kRows;
    if (key0 < 0 || key0 >= kv_len) continue;   // no valid column
    __syncthreads();  // the previous chunk is consumed
    load_tile<false>(Ks, nullptr, k + kofs, ks.l, key0, kv_len);
    load_tile<false>(dKs, nullptr, dk + dkofs, dks.l, key0, kv_len);
    load_tile<true, false>(nullptr, Vt, v + vofs, vs.l, key0, kv_len);
    load_tile<true, false>(nullptr, dVt, dv + dvofs, dvs.l, key0, kv_len);
    __syncthreads();
    const int nvalid = kv_len - key0;
#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kStep) {
      float s[kStep / 8][4], ds[kStep / 8][4];
      jvp_products(s, ds, Qs, dQs, Ks, dKs, r0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = r0 + j * 8 + t * 2 + (e & 1);
          s[j][e] = col < nvalid ? s[j][e] * scale_log2 : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
          else mx1 = fmaxf(mx1, s[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f, ru0 = 0.f, ru1 = 0.f;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = r0 + j * 8 + t * 2 + (e & 1);
          const bool live = col < nvalid;
          const float p = live ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          const float pds = live ? p * (ds[j][e] * scale) : 0.f;
          s[j][e] = p;
          ds[j][e] = pds;
          if (e < 2) {
            rs0 += p;
            ru0 += pds;
          } else {
            rs1 += p;
            ru1 += pds;
          }
        }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      mu0 = mu0 * al0 + ru0;
      mu1 = mu1 * al1 + ru1;
#pragma unroll
      for (int d = 0; d < kDh / 8; ++d) {
        acc_o[d][0] *= al0;
        acc_o[d][1] *= al0;
        acc_o[d][2] *= al1;
        acc_o[d][3] *= al1;
        acc_t[d][0] *= al0;
        acc_t[d][1] *= al0;
        acc_t[d][2] *= al1;
        acc_t[d][3] *= al1;
      }
      jvp_accumulate(acc_o, acc_t, s, ds, Vt, dVt, r0);
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float u0 = quad_sum(mu0) / l0, u1 = quad_sum(mu1) / l1;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = e < 2 ? l0 : l1;
      acc_o[d][e] = acc_o[d][e] / l;
      acc_t[d][e] = acc_t[d][e] / l - (e < 2 ? u0 : u1) * acc_o[d][e];
    }
  store_rows(o + b * os.b + h * os.h, os.l, row0, Lq, acc_o);
  store_rows(dout + b * dos.b + h * dos.h, dos.l, row0, Lq, acc_t);
}

constexpr int kJvpSmem = 4 * kTile * 2 + 2 * kTTile * 2;

template <bool SPARSE>
int launch_jvp(const void* q, const void* k, const void* v, const void* dq, const void* dk,
               const void* dv, void* o, void* dout, const void* lut, int B, int H, int Lq,
               int kv_len, int nQ, int sel, int block_q, int block_k, const long long* st,
               float scale, void* stream) {
  if (kv_len <= 0 || Lq <= 0 ||
      (SPARSE && (block_q % kRows || block_k % kRows || (long long)nQ * block_q < Lq)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_jvp_kernel<SPARSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kJvpSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kRows - 1) / kRows, H, B);
  flash_jvp_kernel<SPARSE><<<grid, kThreads, kJvpSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dq, (const __nv_bfloat16*)dk, (const __nv_bfloat16*)dv,
      (__nv_bfloat16*)o, (__nv_bfloat16*)dout, (const int*)lut, H, Lq, kv_len, nQ, sel,
      block_q, block_k, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
      Strides{st[18], st[19], st[20]}, Strides{st[21], st[22], st[23]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 24 values, (batch, token, head) of q, k, v, dq, dk, dv, o, dout
extern "C" int tdx_flash_attention_jvp(const void* q, const void* k, const void* v,
                                       const void* dq, const void* dk, const void* dv, void* o,
                                       void* dout, int B, int H, int Lq, int kv_len,
                                       const long long* strides, float scale, void* stream) {
  return launch_jvp<false>(q, k, v, dq, dk, dv, o, dout, nullptr, B, H, Lq, kv_len, 0, 0, 0,
                           kRows, strides, scale, stream);
}

extern "C" int tdx_sparse_flash_attention_jvp(const void* q, const void* k, const void* v,
                                              const void* dq, const void* dk, const void* dv,
                                              void* o, void* dout, const void* lut, int B,
                                              int H, int Lq, int kv_len, int nQ, int sel,
                                              int block_q, int block_k,
                                              const long long* strides, float scale,
                                              void* stream) {
  return launch_jvp<true>(q, k, v, dq, dk, dv, o, dout, lut, B, H, Lq, kv_len, nQ, sel,
                          block_q, block_k, strides, scale, stream);
}
