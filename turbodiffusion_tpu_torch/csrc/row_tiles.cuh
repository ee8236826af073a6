// What the mma.sync kernels that own 64 rows of one (batch, head) and
// stream the other side in 64-row chunks share (K23 / K24, K25 / K26): the
// tile geometry, the loads of (B, L, H, 128) rows into padded shared-memory
// tiles, the fragment reads, the S-like products over 32 streamed rows, the
// P-like products into two accumulators, the row stores and the quad
// reductions. Built on attention_step.cuh's tensor-core wrappers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_step.cuh"

namespace {

constexpr int kDh = 128;            // head dim
constexpr int kRows = 64;           // rows a block owns, rows a chunk streams
constexpr int kStep = 32;           // streamed rows a softmax step takes
constexpr int kThreads = 128;       // 4 warps x 16 owned rows
constexpr int kStride = kDh + 8;    // padded row of a row-major tile
constexpr int kTStride = kRows + 8; // padded row of a transposed tile
constexpr int kTile = kRows * kStride;     // elements of a row-major tile
constexpr int kTTile = kDh * kTStride;     // elements of a transposed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, l, h;
};

// Rows [row0, row0 + kRows) of one (batch, head) of a (B, L, H, 128) tensor
// -> dst (row stride kStride) when ROW, zero past nrows; with TRANS also
// transposed into dst_t (128 rows of kTStride). 16 bytes a thread a step:
// neighbouring threads read neighbouring addresses, except for the
// transposed copy, where they walk rows so that the 2-byte shared stores are
// conflict-free.
template <bool TRANS, bool ROW = true>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                          const __nv_bfloat16* src, long long sl,
                                          int row0, int nrows) {
  constexpr int kVec = kDh / 8;
#pragma unroll
  for (int i = 0; i < kRows * kVec / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = TRANS ? idx % kRows : idx / kVec, c8 = TRANS ? idx / kRows : idx % kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sl + c8 * 8);
    if (ROW) *reinterpret_cast<uint4*>(dst + r * kStride + c8 * 8) = val;
    if (TRANS) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c8 * 8 + j) * kTStride + r] = e[j];
    }
  }
}

// The A fragment (16 rows x 16 channels kk*16..) of a warp's rows of a
// row-major tile.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* base = tile + (warp * 16) * kStride + kk * 16 + t * 2;
  a[0] = lds32(base + g * kStride);
  a[1] = lds32(base + (g + 8) * kStride);
  a[2] = lds32(base + g * kStride + 8);
  a[3] = lds32(base + (g + 8) * kStride + 8);
}

// X Y^T for the warp's 16 owned rows against streamed rows [r0, r0 + 32):
// x = the owned tile (A), y = the streamed row-major tile (B). Two products
// at once (S and dP) share the loop.
__device__ __forceinline__ void two_products(float (&s)[kStep / 8][4], float (&d)[kStep / 8][4],
                                             const __nv_bfloat16* xs, const __nv_bfloat16* ys,
                                             const __nv_bfloat16* xd, const __nv_bfloat16* yd,
                                             int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t as[4], ad[4];
    a_frag(as, xs, kk);
    a_frag(ad, xd, kk);
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
      const int off = (r0 + j * 8 + g) * kStride + kk * 16 + t * 2;
      mma_bf16(s[j], as, lds32(ys + off), lds32(ys + off + 8));
      mma_bf16(d[j], ad, lds32(yd + off), lds32(yd + off + 8));
    }
  }
}

// acc1 += X1 Z, acc2 += X2 Z over the 32 streamed rows [r0, r0 + 32): X1,
// X2 the warp's (16 x 32) fp32 values in the accumulator layout, rounded to
// bf16 A fragments here; Z the streamed rows transposed (zt, 128 rows of
// kTStride), and Z2 (zt2) for acc2 when it differs.
__device__ __forceinline__ void accumulate(float (&acc1)[kDh / 8][4], float (&acc2)[kDh / 8][4],
                                           const float (&x1)[kStep / 8][4],
                                           const float (&x2)[kStep / 8][4],
                                           const __nv_bfloat16* zt1, const __nv_bfloat16* zt2,
                                           int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    uint32_t a1[4], a2[4];
    a1[0] = pack_bf16(x1[2 * kk][0], x1[2 * kk][1]);
    a1[1] = pack_bf16(x1[2 * kk][2], x1[2 * kk][3]);
    a1[2] = pack_bf16(x1[2 * kk + 1][0], x1[2 * kk + 1][1]);
    a1[3] = pack_bf16(x1[2 * kk + 1][2], x1[2 * kk + 1][3]);
    a2[0] = pack_bf16(x2[2 * kk][0], x2[2 * kk][1]);
    a2[1] = pack_bf16(x2[2 * kk][2], x2[2 * kk][3]);
    a2[2] = pack_bf16(x2[2 * kk + 1][0], x2[2 * kk + 1][1]);
    a2[3] = pack_bf16(x2[2 * kk + 1][2], x2[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      const int off = (d * 8 + g) * kTStride + r0 + kk * 16 + t * 2;
      mma_bf16(acc1[d], a1, lds32(zt1 + off), lds32(zt1 + off + 8));
      mma_bf16(acc2[d], a2, lds32(zt2 + off), lds32(zt2 + off + 8));
    }
  }
}

// Store a warp's (16 x 128) fp32 accumulator as bf16 rows r < nrows of a
// (B, L, H, 128) tensor at `base` (row stride sl).
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long sl, int row0,
                                           int nrows, const float (&acc)[kDh / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < nrows)
      *reinterpret_cast<uint32_t*>(base + (long long)r0 * sl + col) =
          pack_bf16(acc[d][0], acc[d][1]);
    if (r1 < nrows)
      *reinterpret_cast<uint32_t*>(base + (long long)r1 * sl + col) =
          pack_bf16(acc[d][2], acc[d][3]);
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace
