// K1 and K2: the row-wise fused norms of the Wan block, for sm_90a.
//
// K1 tdx_modulated_layer_norm replaces the TPU kernel
//    turbodiffusion_tpu/ops/fused_norm.py:_mln_pallas (body _mln_kernel).
// K2 tdx_rmsnorm_rope replaces
//    turbodiffusion_tpu/ops/fused_norm.py:_rmsrope_pallas (body _rmsrope_kernel).
//
// What bounds them on an H100: memory. Each is one read and one write of a
// (B*L, D) bf16 activation (about 200 MB per call at the 1.3B 480p shape,
// D = 1536, L = 32,760) with a few FLOPs per element, far below the ~295
// FLOP/byte ridge. The design keeps the whole row in registers: one block of
// 256 threads per row, each thread holding up to 8 element pairs, so x is
// read once, the statistics are two block reductions over registers, and the
// output is written once — no fp32 intermediate ever reaches device memory.
// Pairs are read as bf16x2 (K1) so a warp moves 128 contiguous bytes.
//
// Both follow the JAX cast chain exactly (fused_norm.py:43-65, :241-260):
//   K1: fp32 LN -> (affine in fp32) -> bf16 -> fp32 -> x*(1+scale)+shift -> bf16
//   K2: fp32 RMS over the full H*Dh row -> bf16 -> bf16 weight multiply ->
//       fp32 rotate-half RoPE with (L, Dh) cos/sin tables -> bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 8;  // rows of up to 2 * 8 * 256 = 4096 elements

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads / 32) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

// One block per row of x (rows = B*L). Element pairs (2p, 2p+1) with
// p = threadIdx.x + i*kThreads.
__global__ void __launch_bounds__(kThreads)
mln_kernel(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out,
           const float2* __restrict__ mod_scale, const float2* __restrict__ mod_shift,
           const __nv_bfloat162* __restrict__ weight,
           const __nv_bfloat162* __restrict__ bias, int L, int D, float eps) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  const int b = row / L;
  const int npairs = D / 2;
  const __nv_bfloat162* xr = x + (size_t)row * npairs;

  float2 v[kMaxPairs];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads;
    v[i] = p < npairs ? __bfloat1622float2(xr[p]) : make_float2(0.f, 0.f);
    s += v[i].x + v[i].y;
  }
  const float mean = block_sum(s, red) / D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < npairs) {
      const float a = v[i].x - mean, c = v[i].y - mean;
      s2 += a * a + c * c;
    }
  }
  const float inv = rsqrtf(block_sum(s2, red) / D + eps);

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p >= npairs) continue;
    float y0 = (v[i].x - mean) * inv, y1 = (v[i].y - mean) * inv;
    if (weight) {
      const float2 w = __bfloat1622float2(weight[p]);
      y0 *= w.x;
      y1 *= w.y;
    }
    if (bias) {
      const float2 c = __bfloat1622float2(bias[p]);
      y0 += c.x;
      y1 += c.y;
    }
    // WanLayerNorm casts out to bf16 before the fp32 modulation
    y0 = round_bf16(y0);
    y1 = round_bf16(y1);
    if (mod_scale) {
      const float2 ms = mod_scale[(size_t)b * npairs + p];
      const float2 mb = mod_shift[(size_t)b * npairs + p];
      y0 = y0 * (1.f + ms.x) + mb.x;
      y1 = y1 * (1.f + ms.y) + mb.y;
    }
    out[(size_t)row * npairs + p] = __floats2bfloat162_rn(y0, y1);
  }
}

// One block per row. Pair p = (head h, index i < Dh/2) holds the two
// channels that rotate-half RoPE mixes: h*Dh + i and h*Dh + i + Dh/2.
__global__ void __launch_bounds__(kThreads)
rmsrope_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
               const __nv_bfloat16* __restrict__ weight,
               const float* __restrict__ cos_full, const float* __restrict__ sin_full,
               int L, int H, int Dh, float eps) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  const int l = row % L;
  const int half = Dh / 2;
  const int HD = H * Dh;
  const int npairs = HD / 2;
  const __nv_bfloat16* xr = x + (size_t)row * HD;
  __nv_bfloat16* orow = out + (size_t)row * HD;

  float a[kMaxPairs], c[kMaxPairs];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kThreads;
    a[k] = c[k] = 0.f;
    if (p < npairs) {
      const int e0 = (p / half) * Dh + (p % half);
      a[k] = bf2f(xr[e0]);
      c[k] = bf2f(xr[e0 + half]);
    }
    s += a[k] * a[k] + c[k] * c[k];
  }
  const float rms = rsqrtf(block_sum(s, red) / HD + eps);

#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= npairs) continue;
    const int i = p % half;
    const int e0 = (p / half) * Dh + i;
    // cast to bf16 BEFORE the (bf16) weight multiply, as WanRMSNorm does
    const float y0 = round_bf16(round_bf16(a[k] * rms) * bf2f(weight[e0]));
    const float y1 = round_bf16(round_bf16(c[k] * rms) * bf2f(weight[e0 + half]));
    if (cos_full) {
      const float* cs = cos_full + (size_t)l * Dh;
      const float* sn = sin_full + (size_t)l * Dh;
      // out[j] = y[j]*cos[j] + y[(j + Dh/2) % Dh]*sin[j]
      orow[e0] = f2bf(y0 * cs[i] + y1 * sn[i]);
      orow[e0 + half] = f2bf(y1 * cs[i + half] + y0 * sn[i + half]);
    } else {
      orow[e0] = f2bf(y0);
      orow[e0 + half] = f2bf(y1);
    }
  }
}

}  // namespace

extern "C" int tdx_modulated_layer_norm(const void* x, void* out,
                                        const void* mod_scale, const void* mod_shift,
                                        const void* weight, const void* bias,
                                        int rows, int L, int D, float eps,
                                        void* stream) {
  mln_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat162*)x, (__nv_bfloat162*)out, (const float2*)mod_scale,
      (const float2*)mod_shift, (const __nv_bfloat162*)weight,
      (const __nv_bfloat162*)bias, L, D, eps);
  return (int)cudaGetLastError();
}

extern "C" int tdx_rmsnorm_rope(const void* x, void* out, const void* weight,
                                const void* cos_full, const void* sin_full,
                                int rows, int L, int H, int Dh, float eps,
                                void* stream) {
  rmsrope_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const __nv_bfloat16*)weight,
      (const float*)cos_full, (const float*)sin_full, L, H, Dh, eps);
  return (int)cudaGetLastError();
}
