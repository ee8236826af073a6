// What the mma.sync attention kernels share (the mma.sync forms of K3, K19
// and K28; the wgmma kernels K4 / K3 / K20 / K30, K7 / K19 / K28 and K14 /
// K17 their bf16 packing): the tensor-core wrappers and one 64-key
// chunk's online-softmax step with O += P V.
//
// The step works on a warp's 16 query rows in the m16n8 accumulator layout:
// lane = 4 g + t holds rows g and g + 8, columns 8 j + 2 t (+1) of each
// 8-column tile j, and a quad of 4 lanes shares a row.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool EXP2>
__device__ __forceinline__ float step_exp(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

// One chunk of NB * 8 keys for the warp's rows. s holds the chunk's scaled
// logits, masked columns already at a large negative value, in the log2
// domain when EXP2 (K3, K28) and the natural one otherwise (K19).
// Updates the rows' running max (m0, m1), this lane's share of their sums
// (l0, l1) and the fp32 output acc (ND tiles of 8 channels), then adds P V:
// P rounds to bf16 (times the key's V scale vsc[key] before the rounding
// when vsc is given: K19's per-row V) and multiplies Vt, the chunk's V
// transposed (ND * 8 rows of VSTRIDE keys), on the tensor cores.
template <bool EXP2, int VSTRIDE, int NB, int ND>
__device__ __forceinline__ void softmax_pv_step(float (&s)[NB][4], float (&acc)[ND][4],
                                                float& m0, float& m1, float& l0, float& l1,
                                                const __nv_bfloat16* Vt,
                                                const float* vsc = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float alpha0 = step_exp<EXP2>(m0 - mn0), alpha1 = step_exp<EXP2>(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = step_exp<EXP2>(s[j][0] - mn0);
    s[j][1] = step_exp<EXP2>(s[j][1] - mn0);
    s[j][2] = step_exp<EXP2>(s[j][2] - mn1);
    s[j][3] = step_exp<EXP2>(s[j][3] - mn1);
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    acc[d][0] *= alpha0;
    acc[d][1] *= alpha0;
    acc[d][2] *= alpha1;
    acc[d][3] *= alpha1;
  }

  // P from the S accumulators as the A fragments of m16n8k16
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t pa[4];
    if (vsc != nullptr) {
      // keys kk * 16 + 2 t (+1) and 8 further on: each scale read once
      const int c0 = kk * 16 + t * 2;
      const float va = vsc[c0], vb = vsc[c0 + 1], vc = vsc[c0 + 8], vd = vsc[c0 + 9];
      pa[0] = pack_bf16(__fmul_rn(s[2 * kk][0], va), __fmul_rn(s[2 * kk][1], vb));
      pa[1] = pack_bf16(__fmul_rn(s[2 * kk][2], va), __fmul_rn(s[2 * kk][3], vb));
      pa[2] = pack_bf16(__fmul_rn(s[2 * kk + 1][0], vc), __fmul_rn(s[2 * kk + 1][1], vd));
      pa[3] = pack_bf16(__fmul_rn(s[2 * kk + 1][2], vc), __fmul_rn(s[2 * kk + 1][3], vd));
    } else {
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const __nv_bfloat16* vp = Vt + (d * 8 + g) * VSTRIDE + kk * 16 + t * 2;
      mma_bf16(acc[d], pa, lds32(vp), lds32(vp + 8));
    }
  }
}

}  // namespace
