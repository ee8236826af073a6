// What the linear branch's kv sums share: K6's (sla_fused.cu
// k6::pack_kvt_kernel, int8 V) and K21's kv pass (linear_attention.cu
// k21::kv_kernel, bf16 V). Both walk a flat (b, h, row block) order in runs
// of persistent blocks, build phi = softmax_D(k) of a step's rows from
// shared memory (a half warp a row, 8 channels a lane) into swizzled
// MN-major operand tiles, sum phi^T V on wgmma, and write each run's sums
// of a head as one fp32 partial (128 rows of kv, then ksum), which an
// ordered reduce adds: deterministic, no fp32 atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_rows.cuh"

namespace {
namespace linkv {

constexpr int kDh = 128;
constexpr int kSlot = (kDh + 1) * kDh;     // floats of a partial: 128 kv rows, then ksum
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2eLo = 1.925963033e-8f;   // log2(e) - fl(log2(e))
constexpr float kLn2 = 0.6931471805599453f;

// first flat row block (b, h, block in order) of block i of `grid`
__host__ __device__ __forceinline__ int run_start(int i, int total, int grid) {
  return (int)((long long)i * total / grid);
}

// the block whose run holds flat row block `blk`
__host__ __device__ __forceinline__ int run_of(int blk, int total, int grid) {
  return (int)(((long long)(blk + 1) * grid - 1) / total);
}

// 16-byte chunk q of row r of a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw_chunk(uint32_t tile, int r, int q) {
  return tile + r * 128 + ((q ^ (r & 7)) << 4);
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// exp(t) for t = x - max <= 0, exact as an fp32 difference of bf16 values:
// 2^y (1 + r ln 2), y = fl(t log2 e), r = t log2 e - y; only the SFU's 2^y
// rounds
__device__ __forceinline__ float exp_rel(float t) {
  const float y = __fmul_rn(t, kLog2e);
  const float r = fmaf(t, kLog2eLo, fmaf(t, kLog2e, -y));
  const float p2 = ex2_approx(y);
  return fmaf(p2, r * kLn2, p2);
}

// 1/s: the SFU's estimate and one Newton step (within an ulp)
__device__ __forceinline__ float rcp_newton(float s) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return fmaf(fmaf(-s, r, 1.f), r, r);
}

// phi = softmax over the 128 channels of R rows, each held by a half warp
// (lane & 15 holds channels 8 (lane & 15) .. + 7 of row j in x[j]), times
// `scale`; zeros in a row where !valid (the half warp alike). The rows'
// steps interleave. 1 / sum is the SFU's estimate and one Newton step
// (within an ulp), or with RN rounded to nearest. Every lane of the warp
// calls it.
template <int R, bool RN = false>
__device__ __forceinline__ void phi_rows(float (&x)[R][8], const bool (&valid)[R], float scale) {
  float mx[R], sum[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mx[j] = x[j][0];
#pragma unroll
    for (int e = 1; e < 8; ++e) mx[j] = fmaxf(mx[j], x[j][e]);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sum[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[j][e] = exp_rel(__fsub_rn(x[j][e], mx[j]));
      sum[j] += x[j][e];
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float rs = valid[j] ? (RN ? rcp_rn(sum[j]) : rcp_newton(sum[j])) * scale : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[j][e] = __fmul_rn(x[j][e], rs);
  }
}

// the same for one row (K6's step)
__device__ __forceinline__ void phi_row(float (&x)[8], bool valid, float scale) {
  const bool v[1] = {valid};
  phi_rows<1>(*reinterpret_cast<float(*)[1][8]>(&x), v, scale);
}

// kv (B H, 128, 128) and ksum (B H, 128) of head blockIdx.y: its runs'
// partials (slot 0 of a run that starts in the head, else slot 1) added in
// run order, 4 floats a thread; n row blocks a head (grid of the kernel:
// (ceil(kSlot / 1024), B H))
__device__ __forceinline__ void reduce_partials(const float* __restrict__ part,
                                                float* __restrict__ kv,
                                                float* __restrict__ ksum, int n, int total,
                                                int grid) {
  const int bh = blockIdx.y;
  const int e = (blockIdx.x * kReduceThreads + threadIdx.x) * 4;
  if (e >= kSlot) return;
  const int i0 = run_of(bh * n, total, grid), i1 = run_of(bh * n + n - 1, total, grid);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = i0; i <= i1; ++i) {
    const int slot = run_start(i, total, grid) / n == bh ? 0 : 1;
    const float4 q =
        __ldcg(reinterpret_cast<const float4*>(part + ((size_t)i * 2 + slot) * kSlot + e));
    sum.x += q.x; sum.y += q.y; sum.z += q.z; sum.w += q.w;
  }
  float* out = e < kDh * kDh ? kv + (size_t)bh * kDh * kDh + e
                             : ksum + (size_t)bh * kDh + (e - kDh * kDh);
  *reinterpret_cast<float4*>(out) = sum;
}

}  // namespace linkv
}  // namespace
