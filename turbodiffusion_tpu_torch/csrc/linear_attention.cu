// The SLA linear branch for sm_90a: K21.
//
// tdx_linear_kv is its kv pass: kv = sum softmax_D(k)^T v (B, H, 128, 128)
//    and ksum = sum softmax_D(k) (B, H, 1, 128) over rows < kv_len of bf16 k
//    and v; rows past kv_len are never read, so a NaN there stays out (the
//    TPU kernel's where() on both). K6 folds the same sums for int8 V into
//    its own walk (csrc/sla_fused.cu k6::pack_kvt_kernel).
// K21 tdx_linear_apply, after kvw = kv @ W^T (torch.matmul between the
//    passes, as JAX leaves it to XLA), replaces the apply pass: o = softmax_D(q)
//    kvw / (1e-5 + softmax_D(q) . ksum) + bias, bf16 out. With the kv pass it
//    replaces turbodiffusion_tpu/ops/linear_attention_pallas.py:_planes_impl
//    (bodies _kv_kernel, _apply_kernel; the fused sagesla path at v_quant=row)
//    and _linear_projected_impl (the same bodies over (B, L, H, D); the sla
//    path). Every tensor is read through (batch, head, row) strides with a
//    unit channel stride, so planes (B, H, L, 128) and (B, L, H, 128) views
//    take the same kernels.
//
// What bounds them on an H100: fp32 arithmetic. At the 1.3B 480p shape each
// pass does 2 x 12 x 32,768 x 128 x 128 = 1.29e10 fp32 FMA operations
// (0.19 ms at the 67 TFLOP/s of fp32 outside the tensor cores) over ~200 MB
// (0.06 ms): both passes are SIMT fp32 register tiles.
//   * kv pass: the sum crosses thread blocks, so it is two launches:
//     per-2048-row partials (256 threads, 8 x 8 outputs a thread, 32-row
//     slabs of softmax_D(k) and v in shared memory), then an ordered sum of
//     the partials. Deterministic, no atomics.
//   * apply: one 256-thread block per 64 rows of one (b, h); each warp
//     computes softmax_D(q) of 8 rows (a lane holds 4 channels) and its
//     denominator, kept in shared memory; kvw streams through shared memory
//     16 rows at a time and each thread accumulates 4 rows x 8 channels.
// A first, simple version: no tensor cores (the fp32 semantics would need
// 3xTF32), synchronous loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kLinRows = 2048;                 // rows of one linear-kv partial
constexpr int kLinSub = 32;                    // rows of one shared slab
constexpr int kApRows = 64;                    // rows of one apply block
constexpr int kApKvRows = 16;                  // kvw rows a shared step holds
constexpr int kPhiStride = kDh + 4;            // floats per phi row

struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 bf16 channels (8 bytes) -> fp32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p2[0]), c = __bfloat1622float2(p2[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = c.x;
  f[3] = c.y;
}

// 16 bf16 channels of v (32 bytes) -> fp32
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[h];
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p2[i]);
      f[8 * h + 2 * i] = t.x;
      f[8 * h + 2 * i + 1] = t.y;
    }
  }
}

// softmax over the 128 channels of one row, a lane holding channels
// 4 lane .. 4 lane + 3: exp(x - max) / sum, as the TPU kernels write it
__device__ __forceinline__ void softmax_row(float* f) {
  const float mx = warp_max(fmaxf(fmaxf(f[0], f[1]), fmaxf(f[2], f[3])));
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = expf(f[e] - mx);
  const float s = warp_sum(f[0] + f[1] + f[2] + f[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = f[e] / s;
}

// Partial sums of softmax_D(k)^T v and softmax_D(k) over rows
// [chunk * kLinRows, min(kv_len, (chunk + 1) * kLinRows)): part holds, per
// (b, h, chunk), 128 rows of kv then one row of ksum.
__global__ void __launch_bounds__(256)
linear_kv_partial_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                         float* __restrict__ part, int kv_len, int n_chunks, Strides ks,
                         Strides vs) {
  __shared__ __align__(16) float sphi[kLinSub * kDh];
  __shared__ __align__(16) float sv[kLinSub * kDh];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * gridDim.y + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row_begin = chunk * kLinRows;
  const int row_end = min(kv_len, row_begin + kLinRows);
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  float acc[8][8], ksa[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ksa[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int base = row_begin; base < row_end; base += kLinSub) {
    // phi = softmax over the 128 channels of the raw k row: 4 rows a warp
#pragma unroll
    for (int rr = 0; rr < kLinSub / 8; ++rr) {
      const int lr = warp * (kLinSub / 8) + rr, row = base + lr;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < row_end) {
        load4(kb + row * ks.l + lane * 4, f);
        softmax_row(f);
      }
      *reinterpret_cast<float4*>(sphi + lr * kDh + lane * 4) = make_float4(f[0], f[1], f[2], f[3]);
    }
    {
      const int lr = threadIdx.x >> 3, c16 = threadIdx.x & 7, row = base + lr;
      float f[16];
      if (row < row_end) {
        load16(vb + row * vs.l + c16 * 16, f);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) f[e] = 0.f;
      }
      float* dst = sv + lr * kDh + c16 * 16;
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();
    for (int rr = 0; rr < kLinSub; ++rr) {
      float pd[8], vv[8];
      *reinterpret_cast<float4*>(pd) = *reinterpret_cast<const float4*>(sphi + rr * kDh + ty * 8);
      *reinterpret_cast<float4*>(pd + 4) = *reinterpret_cast<const float4*>(sphi + rr * kDh + ty * 8 + 4);
      *reinterpret_cast<float4*>(vv) = *reinterpret_cast<const float4*>(sv + rr * kDh + tx * 8);
      *reinterpret_cast<float4*>(vv + 4) = *reinterpret_cast<const float4*>(sv + rr * kDh + tx * 8 + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ksa[i] += pd[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pd[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (bh * n_chunks + chunk) * (size_t)(kDh + 1) * kDh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = out + (size_t)(ty * 8 + i) * kDh + tx * 8;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(size_t)kDh * kDh + ty * 8 + i] = ksa[i];
  }
}

// kv (B, H, 128, 128) and ksum (B, H, 1, 128): the partials summed in order.
__global__ void __launch_bounds__(256)
linear_kv_reduce_kernel(const float* __restrict__ part, float* __restrict__ kv,
                        float* __restrict__ ksum, int n_chunks) {
  const size_t bh = blockIdx.x;
  constexpr int kN = (kDh + 1) * kDh;
  for (int idx = threadIdx.x; idx < kN; idx += 256) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += part[(bh * n_chunks + c) * kN + idx];
    if (idx < kDh * kDh)
      kv[bh * kDh * kDh + idx] = s;
    else
      ksum[bh * kDh + idx - kDh * kDh] = s;
  }
}

// Grid (ceil(Lq / 64), H, B), 256 threads. kvw (B, H, 128, 128), ksum
// (B, H, 128), bias (128,) fp32; q and out (b, h, row) strided bf16.
__global__ void __launch_bounds__(256)
linear_apply_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ kvw,
                    const float* __restrict__ ksum, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int Lq, Strides qs, Strides os) {
  __shared__ __align__(16) float phi[kApRows * kPhiStride];
  __shared__ __align__(16) float kvs[kApKvRows * kDh];
  __shared__ float den[kApRows];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * gridDim.y + h;
  const int row0 = blockIdx.x * kApRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const float* ks = ksum + bh * kDh;

  // phi = softmax_D(q) of 8 rows a warp, and each row's denominator
  float k4[4];
  *reinterpret_cast<float4*>(k4) = *reinterpret_cast<const float4*>(ks + lane * 4);
#pragma unroll
  for (int rr = 0; rr < kApRows / 8; ++rr) {
    const int lr = warp * (kApRows / 8) + rr, row = row0 + lr;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    float dp = 0.f;
    if (row < Lq) {
      load4(qb + row * qs.l + lane * 4, f);
      softmax_row(f);
      dp = warp_sum(f[0] * k4[0] + f[1] * k4[1] + f[2] * k4[2] + f[3] * k4[3]);
    }
    *reinterpret_cast<float4*>(phi + lr * kPhiStride + lane * 4) = make_float4(f[0], f[1], f[2], f[3]);
    if (lane == 0) den[lr] = 1e-5f + dp;
  }

  // num = phi kvw: rows ty * 4 + [0, 4), channels tx * 8 + [0, 8)
  float num[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) num[i][j] = 0.f;
  const float* kw = kvw + bh * kDh * kDh;
  for (int d0 = 0; d0 < kDh; d0 += kApKvRows) {
    __syncthreads();  // phi written / the previous kvw rows consumed
    for (int u = threadIdx.x; u < kApKvRows * kDh / 4; u += 256)
      reinterpret_cast<float4*>(kvs)[u] = reinterpret_cast<const float4*>(kw + (size_t)d0 * kDh)[u];
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kApKvRows; ++dd) {
      float kv8[8];
      *reinterpret_cast<float4*>(kv8) = *reinterpret_cast<const float4*>(kvs + dd * kDh + tx * 8);
      *reinterpret_cast<float4*>(kv8 + 4) = *reinterpret_cast<const float4*>(kvs + dd * kDh + tx * 8 + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = phi[(ty * 4 + i) * kPhiStride + d0 + dd];
#pragma unroll
        for (int j = 0; j < 8; ++j) num[i][j] = fmaf(p, kv8[j], num[i][j]);
      }
    }
  }

  // o = num / den + bias -> bf16, 16 bytes a thread
  float bb[8];
  *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + tx * 8);
  *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + tx * 8 + 4);
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i, row = row0 + lr;
    if (row >= Lq) continue;
    const float dn = den[lr];
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p2[j] = __floats2bfloat162_rn(__fadd_rn(__fdiv_rn(num[i][2 * j], dn), bb[2 * j]),
                                    __fadd_rn(__fdiv_rn(num[i][2 * j + 1], dn), bb[2 * j + 1]));
    *reinterpret_cast<uint4*>(ob + row * os.l + tx * 8) = packed;
  }
}

}  // namespace

extern "C" int tdx_linear_kv(const void* k, const void* v, void* part, void* kv, void* ksum,
                             int B, int H, int kv_len, int n_chunks, long long ksb,
                             long long ksh, long long ksl, long long vsb, long long vsh,
                             long long vsl, void* stream) {
  if (kv_len <= 0 || n_chunks != (kv_len + kLinRows - 1) / kLinRows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_chunks, H, B);
  const Strides ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl};
  linear_kv_partial_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (float*)part, kv_len, n_chunks, ks, vs);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  linear_kv_reduce_kernel<<<B * H, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)kv, (float*)ksum, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int tdx_linear_apply(const void* q, const void* kvw, const void* ksum,
                                const void* bias, void* out, int B, int H, int Lq,
                                long long qsb, long long qsh, long long qsl, long long osb,
                                long long osh, long long osl, void* stream) {
  if (Lq <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq + kApRows - 1) / kApRows, H, B);
  linear_apply_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const float*)kvw, (const float*)ksum, (const float*)bias,
      (__nv_bfloat16*)out, Lq, Strides{qsb, qsh, qsl}, Strides{osb, osh, osl});
  return (int)cudaGetLastError();
}
