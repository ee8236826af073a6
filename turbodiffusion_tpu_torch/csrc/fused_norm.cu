// K1, K2 and K12: the row-wise fused norms of the Wan block, for sm_90a.
//
// K1 tdx_modulated_layer_norm replaces the TPU kernel
//    turbodiffusion_tpu/ops/fused_norm.py:_mln_pallas (body _mln_kernel).
// K12 tdx_modulated_layer_norm_quant replaces the same launch with
//    quant_out=True: the row goes out as int8 with one fp32 scale, the feed of
//    the next W8A8 GEMM (fused QKV, cross Q, fc1), so no bf16 row is written
//    and no row quantiser runs after it.
// K2 tdx_rmsnorm_rope replaces
//    turbodiffusion_tpu/ops/fused_norm.py:_rmsrope_pallas (body _rmsrope_kernel).
//    Its input rows are `ld` elements apart, so the Q or K column group of the
//    fused (B, L, 3*D) QKV GEMM output is read in place.
//
// What bounds them on an H100: memory. Each is one read and one write of a
// (B*L, D) activation (about 200 MB per call at the 1.3B 480p shape,
// D = 1536, L = 32,760; K12 writes int8, 150 MB in all: 0.045 ms at
// 3.35 TB/s) with a few FLOPs per element, far below the ~295 FLOP/byte
// ridge. The design keeps the whole row in registers: one block of 256
// threads per row, each thread holding up to 8 element pairs (K1 and K12 up
// to 10, the 14B's 5120-wide rows, as a second instance of the template so
// the narrow rows keep their registers), so x is read once, the statistics
// are block reductions over registers (K12 adds one for the row's absmax),
// and the output is written once — no fp32 intermediate ever reaches device
// memory. Pairs are read as bf16x2 (K1, K12) so a warp moves 128 contiguous
// bytes.
//
// All follow the JAX cast chain exactly (fused_norm.py:43-65, :68-93,
// :241-260):
//   K1: fp32 LN -> (affine in fp32) -> bf16 -> fp32 -> x*(1+scale)+shift -> bf16
//   K12: K1's chain up to the modulation, then int8 from the fp32 modulated
//        value (never rounded to bf16), or from the bf16 affine value when
//        there is no modulation (norm3): scale = max(amax, 1e-8) * (1/127),
//        q = round-half-even(y * (1/scale)), the TPU kernel's rule;
//   K2: fp32 RMS over the full H*Dh row -> bf16 -> bf16 weight multiply ->
//       fp32 rotate-half RoPE with (L, Dh) cos/sin tables -> bf16.
// The affine and modulation products and sums are __fmul_rn / __fadd_rn, one
// rounding each as in the plain version, so nvcc cannot contract them into an
// FMA that moves an fp32 value K12 quantises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 8;   // rows of up to 2 * 8 * 256 = 4096 elements
constexpr int kWidePairs = 10; // K1 / K12 rows of up to 5120 elements

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

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads / 32) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ int8_t to_i8(float v) {
  // |y| * (1/scale) rounds to at most 127; the clamp only guards the rule
  return (int8_t)max(-127, min(127, __float2int_rn(v)));
}

// One block per row of x (rows = B*L). Element pairs (2p, 2p+1) with
// p = threadIdx.x + i*kThreads, i < PAIRS. QUANT: out is int8 (rows, D) and
// rs one fp32 scale per row (K12); else out is bf16 (K1).
template <bool QUANT, int PAIRS>
__global__ void __launch_bounds__(kThreads)
mln_kernel(const __nv_bfloat162* __restrict__ x, void* __restrict__ out,
           float* __restrict__ rs, const float2* __restrict__ mod_scale,
           const float2* __restrict__ mod_shift, const __nv_bfloat162* __restrict__ weight,
           const __nv_bfloat162* __restrict__ bias, int L, int D, float eps) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  const int b = row / L;
  const int npairs = D / 2;
  const __nv_bfloat162* xr = x + (size_t)row * npairs;

  float2 v[PAIRS];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int p = threadIdx.x + i * kThreads;
    v[i] = p < npairs ? __bfloat1622float2(xr[p]) : make_float2(0.f, 0.f);
    s += v[i].x + v[i].y;
  }
  const float mean = block_sum(s, red) / D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < npairs) {
      const float a = v[i].x - mean, c = v[i].y - mean;
      s2 += a * a + c * c;
    }
  }
  const float inv = rsqrtf(block_sum(s2, red) / D + eps);

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p >= npairs) continue;
    float y0 = __fmul_rn(v[i].x - mean, inv), y1 = __fmul_rn(v[i].y - mean, inv);
    if (weight) {
      const float2 w = __bfloat1622float2(weight[p]);
      y0 = __fmul_rn(y0, w.x);
      y1 = __fmul_rn(y1, w.y);
    }
    if (bias) {
      const float2 c = __bfloat1622float2(bias[p]);
      y0 = __fadd_rn(y0, c.x);
      y1 = __fadd_rn(y1, c.y);
    }
    // WanLayerNorm casts out to bf16 before the fp32 modulation
    y0 = round_bf16(y0);
    y1 = round_bf16(y1);
    if (mod_scale) {
      const float2 ms = mod_scale[(size_t)b * npairs + p];
      const float2 mb = mod_shift[(size_t)b * npairs + p];
      y0 = __fadd_rn(__fmul_rn(y0, 1.f + ms.x), mb.x);
      y1 = __fadd_rn(__fmul_rn(y1, 1.f + ms.y), mb.y);
    }
    if (QUANT) {
      v[i] = make_float2(y0, y1);
      amax = fmaxf(amax, fmaxf(fabsf(y0), fabsf(y1)));
    } else {
      reinterpret_cast<__nv_bfloat162*>(out)[(size_t)row * npairs + p] =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  if (!QUANT) return;
  const float scale = __fmul_rn(fmaxf(block_max(amax, red), 1e-8f), 1.0f / 127.0f);
  const float qinv = 1.f / scale;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p >= npairs) continue;
    char2 q;
    q.x = to_i8(__fmul_rn(v[i].x, qinv));
    q.y = to_i8(__fmul_rn(v[i].y, qinv));
    reinterpret_cast<char2*>(out)[(size_t)row * npairs + p] = q;
  }
  if (threadIdx.x == 0) rs[row] = scale;
}

// One block per row. Pair p = (head h, index i < Dh/2) holds the two
// channels that rotate-half RoPE mixes: h*Dh + i and h*Dh + i + Dh/2.
__global__ void __launch_bounds__(kThreads)
rmsrope_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
               const __nv_bfloat16* __restrict__ weight,
               const float* __restrict__ cos_full, const float* __restrict__ sin_full,
               long long ld, int L, int H, int Dh, float eps) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  const int l = row % L;
  const int half = Dh / 2;
  const int HD = H * Dh;
  const int npairs = HD / 2;
  const __nv_bfloat16* xr = x + (size_t)row * ld;
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

namespace {

// The instance whose registers hold a D-wide row: 8 pairs a thread up to
// 4096, 10 up to 5120.
template <bool QUANT>
int launch_mln(const void* x, void* out, float* rs, const void* mod_scale,
               const void* mod_shift, const void* weight, const void* bias, int rows, int L,
               int D, float eps, void* stream) {
  if (D <= 0 || D % 2 || D > 2 * kThreads * kWidePairs) return (int)cudaErrorInvalidValue;
  const auto kernel = D <= 2 * kThreads * kMaxPairs ? &mln_kernel<QUANT, kMaxPairs>
                                                    : &mln_kernel<QUANT, kWidePairs>;
  kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat162*)x, out, rs, (const float2*)mod_scale, (const float2*)mod_shift,
      (const __nv_bfloat162*)weight, (const __nv_bfloat162*)bias, L, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdx_modulated_layer_norm(const void* x, void* out,
                                        const void* mod_scale, const void* mod_shift,
                                        const void* weight, const void* bias,
                                        int rows, int L, int D, float eps,
                                        void* stream) {
  return launch_mln<false>(x, out, nullptr, mod_scale, mod_shift, weight, bias, rows, L, D,
                           eps, stream);
}

extern "C" int tdx_modulated_layer_norm_quant(const void* x, void* out_q, void* out_scale,
                                              const void* mod_scale, const void* mod_shift,
                                              const void* weight, const void* bias,
                                              int rows, int L, int D, float eps,
                                              void* stream) {
  return launch_mln<true>(x, out_q, (float*)out_scale, mod_scale, mod_shift, weight, bias,
                          rows, L, D, eps, stream);
}

extern "C" int tdx_rmsnorm_rope(const void* x, void* out, const void* weight,
                                const void* cos_full, const void* sin_full,
                                long long ld, int rows, int L, int H, int Dh, float eps,
                                void* stream) {
  rmsrope_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const __nv_bfloat16*)weight,
      (const float*)cos_full, (const float*)sin_full, ld, L, H, Dh, eps);
  return (int)cudaGetLastError();
}
