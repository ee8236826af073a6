// K23 and K24: the backward of the bf16 block-sparse attention (K3) for
// sm_90a, in two passes, as the TPU computes it.
//
// K23 tdx_sparse_attention_bwd_dq replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:_flash_bwd_fused, dq pass
//    (launch :1796, body _sparse_bwd_dq_kernel :1488): each Q-block walks
//    exactly its forward LUT row (the `sel` K-blocks K3 gathered) and
//    recomputes s = scale q k^T with an online max, keeping three
//    accumulators per row:
//        acc1 = sum exp(s - m) * dp @ k,  acc2 = sum exp(s - m) @ k,
//        acc3 = rowsum(exp(s - m) * dp),  dp = dO v^T,
//    so that with l the softmax sum and delta = acc3 / l (= rowsum P dp)
//        dq = scale (acc1 - delta acc2) / l
//    needs no saved forward output. It also writes each row's (lse, delta)
//    in fp32, (B*H, Lp, 2), for K24.
// K24 tdx_sparse_attention_bwd_dkv replaces the dk/dv pass (launch :1836,
//    body _sparse_bwd_dkv_kernel :1611): each K-block walks the Q-blocks
//    that selected it, through the inverse LUT (rows [count, q ids...],
//    built in plain torch as `_inverse_lut` :1726 is jnp), with the exact P
//    = exp(s - lse) from K23's lse:
//        dv = sum P^T dO,   dk = scale sum (P (dp - delta))^T q.
//    Each K-block's rows are written once, by one thread block: no atomics,
//    so the gradients are the same bits from run to run, and a K-block no
//    Q-block selected gets dk = dv = 0 exactly.
//
// What bounds them on an H100: tensor-core math. At the 1.3B 480p training
// shape (12 heads, blocks 512/256, 12 of 128 K-blocks) a K23 call needs 3
// products of 2 * 512 * 256 * 128 per selected block pair (S, dP, dS K;
// 9,216 pairs, ~0.93 TFLOP) and K24 4 (S^T, dP^T, P^T dO, dS^T q; ~1.24
// TFLOP), against ~100 MB of q, k, v, dO each. The design is K3's:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), one block of 4 warps owning
// 64 rows (K23: query rows, K24: key rows) of one (batch, head), each warp
// 16 of them with its fp32 accumulators in registers; the other side
// streams through shared memory in 64-row chunks, each taken in two 32-row
// steps so the two 16x128 accumulators, S and dP fit the register file
// without spilling. The one-pass dq keeps a fourth product (acc2) where a
// two-pass dq would recompute S and dP: it spends 4 products on 3 products'
// work, as the TPU kernel does, and keeps no state between passes.
//   * operands a warp multiplies as A (Q and dO in K23, K and V in K24) are
//     staged once in shared memory and their fragments read per step;
//   * the B operands are staged row-major (for S and dP) and transposed (for
//     the products over the streamed rows), rows padded by 8 so fragment
//     loads hit 32 distinct banks;
//   * P and dS go from the S / dP accumulators straight into A fragments,
//     rounded to bf16 as the TPU kernel rounds them before its dots.
// K24's S^T = K Q^T adds each 16-channel step's product to its sum in fp32
// (two_products<true>): chained on the tensor core, the running sum is
// truncated a step at a time, one way, and P = exp(s scale - lse) took that
// error (up to ~8 ulps of |s| ~ 150 at q of std 3) into every bf16(dS); on
// the worst K-block of chip_smoke's inputs the kernel then sat ~4x further
// from a float64 reference than the plain version (tools/k24_seeds.py).
// Tails: the kernels loop over exactly `sel` (K23) or `count` (K24) entries
// and pad no LUT entry; K23 skips chunks wholly past kv_len and gives
// columns at or past it P = 0; K24 skips chunks wholly past Lq and gives
// query rows at or past it (and key rows at or past kv_len) P = 0, whatever
// the buffers hold there. Head dim 128 only.
// A first, simple version: loads are synchronous (no cp.async/TMA ring) and
// there is no wgmma; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

// K23. Grid (ceil(Lq / 64), H, B): query rows [64 x, 64 x + 64).
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dq, float* __restrict__ ld,
                     const int* __restrict__ lut, int H, int Lq, int kv_len, int nQ, int sel,
                     int block_q, int block_k, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dqs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTile;
  __nv_bfloat16* Ks = dOs + kTile;
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Kt = Vs + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<false>(Qs, nullptr, q + b * qs.b + h * qs.h, qs.l, row0, Lq);
  load_tile<false>(dOs, nullptr, dout + b * dos.b + h * dos.h, dos.l, row0, Lq);

  float acc1[kDh / 8][4], acc2[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[d][e] = acc2[d][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain), rows g, g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  float a30 = 0.f, a31 = 0.f;        // ... and of rowsum(exp(s - m) dp)

  const int per = block_k / kRows;
  const int* lut_row = lut + (((long long)b * H + h) * nQ + row0 / block_q) * sel;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  for (int c = 0; c < sel * per; ++c) {
    const int key0 = lut_row[c / per] * block_k + (c % per) * kRows;
    if (key0 < 0 || key0 >= kv_len) continue;   // no valid column
    __syncthreads();  // the previous chunk is consumed
    load_tile<true>(Ks, Kt, kb, ks.l, key0, kv_len);
    load_tile<false>(Vs, nullptr, vb, vs.l, key0, kv_len);
    __syncthreads();
    const int nvalid = kv_len - key0;
#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kStep) {
      float s[kStep / 8][4], dp[kStep / 8][4];
      two_products(s, dp, Qs, Ks, dOs, Vs, r0);
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
      float rs0 = 0.f, rs1 = 0.f, r30 = 0.f, r31 = 0.f;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = r0 + j * 8 + t * 2 + (e & 1);
          const float p = col < nvalid ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          const float pdp = p * dp[j][e];
          s[j][e] = p;
          dp[j][e] = pdp;
          if (e < 2) {
            rs0 += p;
            r30 += pdp;
          } else {
            rs1 += p;
            r31 += pdp;
          }
        }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      a30 = a30 * al0 + r30;
      a31 = a31 * al1 + r31;
#pragma unroll
      for (int d = 0; d < kDh / 8; ++d) {
        acc1[d][0] *= al0;
        acc1[d][1] *= al0;
        acc1[d][2] *= al1;
        acc1[d][3] *= al1;
        acc2[d][0] *= al0;
        acc2[d][1] *= al0;
        acc2[d][2] *= al1;
        acc2[d][3] *= al1;
      }
      accumulate(acc1, acc2, dp, s, Kt, Kt, r0);
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float dl0 = quad_sum(a30) / l0, dl1 = quad_sum(a31) / l1;
  const float f0 = scale / l0, f1 = scale / l1;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    acc1[d][0] = (acc1[d][0] - dl0 * acc2[d][0]) * f0;
    acc1[d][1] = (acc1[d][1] - dl0 * acc2[d][1]) * f0;
    acc1[d][2] = (acc1[d][2] - dl1 * acc2[d][2]) * f1;
    acc1[d][3] = (acc1[d][3] - dl1 * acc2[d][3]) * f1;
  }
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.l, row0, Lq, acc1);
  if (t == 0) {
    const long long Lp = (long long)nQ * block_q;
    float* ldb = ld + (((long long)b * H + h) * Lp + row0 + warp * 16 + g) * 2;
    ldb[0] = m0 * kLn2 + logf(l0);
    ldb[1] = dl0;
    ldb[16] = m1 * kLn2 + logf(l1);
    ldb[17] = dl1;
  }
}

// K24. Grid (ceil(Lk / 64), H, B): key rows [64 x, 64 x + 64) of K-block
// 64 x / block_k.
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ ld, const int* __restrict__ inv,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                      int Lq, int Lk, int kv_len, int nQ, int nK, int block_q, int block_k,
                      Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;
  __nv_bfloat16* dOs = Qs + kTile;
  __nv_bfloat16* Qt = dOs + kTile;
  __nv_bfloat16* dOt = Qt + kTTile;
  float* lse_s = reinterpret_cast<float*>(dOt + kTTile);
  float* dl_s = lse_s + kRows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * H + h;
  const long long Lp = (long long)nQ * block_q;

  load_tile<false>(Ks, nullptr, k + b * ks.b + h * ks.h, ks.l, key0, Lk);
  load_tile<false>(Vs, nullptr, v + b * vs.b + h * vs.h, vs.l, key0, Lk);
  // key rows at or past kv_len take no part (P = 0)
  const bool kv0 = key0 + warp * 16 + g < kv_len, kv1 = key0 + warp * 16 + g + 8 < kv_len;

  float dka[kDh / 8][4], dva[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  const int* row = inv + (bh * nK + key0 / block_k) * (1 + nQ);
  const int count = row[0];
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  const float* ldb = ld + bh * Lp * 2;
  for (int e = 0; e < count; ++e) {
    const int qblk = row[1 + e];
    for (int c = 0; c < block_q / kRows; ++c) {
      const int qrow0 = qblk * block_q + c * kRows;
      if (qrow0 >= Lq) break;   // no valid row
      __syncthreads();  // the previous chunk is consumed
      load_tile<true>(Qs, Qt, qb, qs.l, qrow0, Lq);
      load_tile<true>(dOs, dOt, dob, dos.l, qrow0, Lq);
      if (threadIdx.x < kRows) {
        const bool live = qrow0 + (int)threadIdx.x < Lq;
        lse_s[threadIdx.x] = live ? ldb[(qrow0 + threadIdx.x) * 2] : 0.f;
        dl_s[threadIdx.x] = live ? ldb[(qrow0 + threadIdx.x) * 2 + 1] : 0.f;
      }
      __syncthreads();
      const int nvalid = Lq - qrow0;
#pragma unroll 1
      for (int r0 = 0; r0 < kRows; r0 += kStep) {
        float st[kStep / 8][4], dpt[kStep / 8][4];
        two_products<true>(st, dpt, Ks, Qs, Vs, dOs, r0);
#pragma unroll
        for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int col = r0 + j * 8 + t * 2 + (x & 1);
            const bool live = col < nvalid && (x < 2 ? kv0 : kv1);
            const float p = live ? expf(st[j][x] * scale - lse_s[col]) : 0.f;
            st[j][x] = p;
            dpt[j][x] = p * (dpt[j][x] - dl_s[col]) * scale;
          }
        accumulate(dka, dva, dpt, st, Qt, dOt, r0);
      }
    }
  }
  store_rows(dk + b * dks.b + h * dks.h, dks.l, key0, Lk, dka);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.l, key0, Lk, dva);
}

constexpr int kDqSmem = 4 * kTile * 2 + kTTile * 2;
constexpr int kDkvSmem = 4 * kTile * 2 + 2 * kTTile * 2 + 2 * kRows * 4;

}  // namespace

extern "C" int tdx_sparse_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* ld,
    const void* lut, int B, int H, int Lq, int kv_len, int nQ, int sel, int block_q,
    int block_k, long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
    long long ksh, long long vsb, long long vsl, long long vsh, long long dsb, long long dsl,
    long long dsh, long long gsb, long long gsl, long long gsh, float scale, void* stream) {
  if (block_q % kRows || block_k % kRows || kv_len <= 0 || Lq <= 0 ||
      (long long)nQ * block_q < Lq)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kRows - 1) / kRows, H, B);
  sparse_bwd_dq_kernel<<<grid, kThreads, kDqSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq, (float*)ld, (const int*)lut, H, Lq,
      kv_len, nQ, sel, block_q, block_k, Strides{qsb, qsl, qsh}, Strides{ksb, ksl, ksh},
      Strides{vsb, vsl, vsh}, Strides{dsb, dsl, dsh}, Strides{gsb, gsl, gsh}, scale);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* ld,
    const void* inv, void* dk, void* dv, int B, int H, int Lq, int Lk, int kv_len, int nQ,
    int nK, int block_q, int block_k, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
    long long dsb, long long dsl, long long dsh, long long ksb2, long long ksl2,
    long long ksh2, long long vsb2, long long vsl2, long long vsh2, float scale,
    void* stream) {
  if (block_q % kRows || block_k % kRows || kv_len <= 0 || kv_len > Lk || Lq <= 0 ||
      (long long)nQ * block_q < Lq || (long long)nK * block_k < Lk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kRows - 1) / kRows, H, B);
  sparse_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)ld, (const int*)inv, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, H, Lq, Lk, kv_len, nQ, nK, block_q, block_k, Strides{qsb, qsl, qsh},
      Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, Strides{dsb, dsl, dsh},
      Strides{ksb2, ksl2, ksh2}, Strides{vsb2, vsl2, vsh2}, scale);
  return (int)cudaGetLastError();
}
