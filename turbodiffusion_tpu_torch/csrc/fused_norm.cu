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
//    fused (B, L, 3*D) QKV GEMM output is read in place. Like the TPU kernel
//    it takes any H*Dh with an even Dh (to 2^30 elements); the C entry
//    refuses the rest with cudaErrorInvalidValue.
//
// What bounds them on an H100: memory. Each is one read and one write of a
// (B*L, D) activation (about 200 MB per call at the 1.3B 480p shape,
// D = 1536, L = 32,760: 0.060 ms at 3.35 TB/s; K12 writes int8, 150 MB)
// with a few FLOPs per element, far below the ~295 FLOP/byte ridge.
//
// K1, K12 and K2 are warp-per-row kernels (mln_rows_kernel<VPL, QUANT>,
// rmsrope_rows_kernel; their shared helpers are in warp_rows.cuh, which K5
// builds on too): a row takes one warp, or 2 or 4 for rows wider than 32
// lanes x kMaxVpl vectors (the 14B's 5120), and a block of 8 warps walks its
// rows persistently (as many blocks as fit on the card). Each lane loads its
// share of the row as 16-byte vectors of 8 bf16 (a warp moves 512 contiguous
// bytes an instruction; the loads skip L1 and ask L2 for 256-byte blocks),
// holds them in registers as packed bf16 and stores 16 bytes (K12: 8 int8)
// at a time (streaming), so the row is read once. A warp's share of the row
// is its only work in flight; more warps, not deeper rows, cover the latency
// (a warp loading its next row first measured no faster). The statistics are
// warp shuffles; the warps of a wide row exchange their partial sums through
// shared memory behind a named barrier of the row's warps (K1 / K12 exchange
// each warp's sum and centred sum of squares and combine them as Chan et
// al.'s parallel variance; K12 then exchanges the warps' absmax the same
// way). No block-wide barrier runs per row. The operands that do not change
// from row to row are staged in shared memory once a block: the modulation
// of the block's batch (1 + scale and shift, fp32), the weight and bias;
// K2's weight. K12 computes each modulated value twice from the packed row,
// once for the absmax and once to quantise, rather than hold the row in
// fp32. A lane's column within its head is the same for every vector it
// holds, so K2 loads its 8 cos and 8 sin values once a row, and the RoPE
// partner of element j (j +- Dh/2) sits in lane ^ Dh/16 of the same vector:
// one shuffle per bf16 pair. The vector forms take the shapes and alignments
// of *_vector below; any other launch takes, by shape, the block-per-row
// kernels: mln_kernel<false> (K1), mln_kernel<true> (K12; one block of 256
// threads per row, the row in registers as bf16 pairs, block reductions
// through shared memory) and rmsrope_kernel (K2).
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

#include "warp_rows.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM the path's K12 instances (VPL 5 and 6: 5120 and 1536 wide)
// are compiled for: 2 holds them to 128 registers; and whether a K12 warp's
// next row is in flight (cp.async into shared memory) while it works on its
// row (tools/time_k5_k12.py --design)
constexpr int kQuantMinBlocks = 2;
constexpr bool kQuantPrefetch = true;
constexpr int kMaxPairs = 8;   // K1 / K12 rows of up to 2 * 8 * 256 = 4096 elements
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
// rs one fp32 scale per row (K12); else out is bf16 (K1 at the shapes
// mln_vector refuses).
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

// K2's loop form, for the shapes rmsrope_vector refuses (a head dim that is
// not a power of two from 16 to 256, a row stride that is not a multiple of
// 8, an unaligned view, rows above kMaxVecRow): one block per row, at any
// width. Pair p = (head h, index i < Dh/2) holds the two channels that
// rotate-half RoPE mixes: h*Dh + i and h*Dh + i + Dh/2. Each thread walks its
// pairs twice, once for the sum of squares and once for the output, reading x
// again (from L2).
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

  float s = 0.f;
  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    const int e0 = (p / half) * Dh + (p % half);
    const float a = bf2f(xr[e0]), c = bf2f(xr[e0 + half]);
    s += a * a + c * c;
  }
  const float rms = rsqrtf(block_sum(s, red) / HD + eps);

  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    const int i = p % half;
    const int e0 = (p / half) * Dh + i;
    // cast to bf16 BEFORE the (bf16) weight multiply, as WanRMSNorm does
    const float y0 = round_bf16(round_bf16(bf2f(xr[e0]) * rms) * bf2f(weight[e0]));
    const float y1 = round_bf16(round_bf16(bf2f(xr[e0 + half]) * rms) * bf2f(weight[e0 + half]));
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


// ---------------------------------------------------------------------------
// The warp-per-row kernels of K1 and K2
// ---------------------------------------------------------------------------

// K1 (bf16 out) and K12 (QUANT: int8 out and one fp32 scale a row, rs).
// x, out (B*L, D) with D = 8 * nvec; one block walks rows of batch b =
// blockIdx.x / per_batch, so its staged modulation is that batch's. Shared
// memory holds, for each operand present, 2 * nvec float4: channels
// 8v..8v+3 at [v] and 8v+4..8v+7 at [nvec + v], so a warp's 16-byte reads
// are consecutive (no bank conflict). inv_d = 1/D, from the host. K12
// takes the row's absmax over the modulated values, then computes them again
// from the packed row to quantise them (no fp32 row held in registers).
template <int VPL, bool QUANT>
__global__ void __launch_bounds__(kRowThreads, QUANT && VPL <= 6 ? kQuantMinBlocks : 1)
mln_rows_kernel(const uint4* __restrict__ x, void* __restrict__ out, float* __restrict__ rs,
                const float4* __restrict__ mod_scale, const float4* __restrict__ mod_shift,
                const uint4* __restrict__ weight, const uint4* __restrict__ bias, int L,
                int D, int per_batch, float inv_d, float eps) {
  extern __shared__ float4 stage[];
  __shared__ float4 xch[2][kRowWarps];
  __shared__ float xmax[2][kRowWarps];         // K12: the row's absmax
  const int nvec = D / 8;
  const int RW = row_warps(nvec);
  const bool has_mod = mod_scale != nullptr, has_w = weight != nullptr,
             has_b = bias != nullptr;
  float4* s_scale = stage;                                  // 1 + scale
  float4* s_shift = s_scale + (has_mod ? 2 * nvec : 0);
  float4* s_w = s_shift + (has_mod ? 2 * nvec : 0);
  float4* s_b = s_w + (has_w ? 2 * nvec : 0);
  // K12 with kQuantPrefetch: each warp's two row buffers of VPL x 32 vectors
  constexpr bool PREFETCH = QUANT && kQuantPrefetch;
  uint4* my_buf = reinterpret_cast<uint4*>(s_b + (has_b ? 2 * nvec : 0)) +
                  (threadIdx.x >> 5) * 2 * VPL * 32;
  const int b = blockIdx.x / per_batch, bx = blockIdx.x % per_batch;
  for (int v = threadIdx.x; v < nvec; v += kRowThreads) {
    if (has_mod) {
      const float4 a = mod_scale[(size_t)b * 2 * nvec + 2 * v];
      const float4 c = mod_scale[(size_t)b * 2 * nvec + 2 * v + 1];
      s_scale[v] = make_float4(1.f + a.x, 1.f + a.y, 1.f + a.z, 1.f + a.w);
      s_scale[nvec + v] = make_float4(1.f + c.x, 1.f + c.y, 1.f + c.z, 1.f + c.w);
      s_shift[v] = mod_shift[(size_t)b * 2 * nvec + 2 * v];
      s_shift[nvec + v] = mod_shift[(size_t)b * 2 * nvec + 2 * v + 1];
    }
    if (has_w) {
      const uint4 u = weight[v];
      const float2 p0 = unpack2(u.x), p1 = unpack2(u.y), p2 = unpack2(u.z), p3 = unpack2(u.w);
      s_w[v] = make_float4(p0.x, p0.y, p1.x, p1.y);
      s_w[nvec + v] = make_float4(p2.x, p2.y, p3.x, p3.y);
    }
    if (has_b) {
      const uint4 u = bias[v];
      const float2 p0 = unpack2(u.x), p1 = unpack2(u.y), p2 = unpack2(u.z), p3 = unpack2(u.w);
      s_b[v] = make_float4(p0.x, p0.y, p1.x, p1.y);
      s_b[nvec + v] = make_float4(p2.x, p2.y, p3.x, p3.y);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kRowWarps / RW, group = warp / RW, wig = warp % RW;
  // a wide row's warps centre their sums of squares on their own means (any
  // centre c is exact through the correction below; 1/n by the SFU is enough)
  const float n_w = (float)warp_share<VPL>(nvec, RW, wig);
  const float inv_nw = RW > 1 ? __fdividef(1.f, n_w) : inv_d;
  const uint4* xb = x + (size_t)b * L * nvec;
  const int step = per_batch * groups;
  int parity = 0;
  // K12: the row after l (l + step) is in flight while l is worked on
  const auto prefetch = [&](int l_, int k_) {
    if (l_ < L)
      prefetch_row<VPL>(my_buf + (k_ & 1) * VPL * 32, xb + (size_t)l_ * nvec, nvec, RW, wig,
                        lane);
    cp_async_commit();
  };
  if (PREFETCH) prefetch(bx * groups + group, 0);
  int kr = 0;                           // the group's rows so far
  for (int l = bx * groups + group; l < L; l += step, ++kr) {
    uint4 v[VPL];
    if constexpr (PREFETCH) {
      prefetch(l + step, kr + 1);
      cp_async_wait<1>();               // this row's group is in
      slot_row<VPL>(v, my_buf + (kr & 1) * VPL * 32, nvec, RW, wig, lane);
    } else {
      load_row<VPL>(v, xb + (size_t)l * nvec, nvec, RW, wig, lane);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack2(word(v[i], k));
        s += f.x + f.y;
      }
    s = warp_sum(s);
    float mean = RW > 1 ? s * inv_nw : div_n(s, (float)D, inv_d);
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (vec_index(i, RW, wig, lane) >= nvec) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack2(word(v[i], k));
        const float a = f.x - mean, c = f.y - mean;
        m2 += a * a + c * c;
      }
    }
    m2 = warp_sum(m2);
    if (RW > 1) {
      // one exchange: each warp's (sum, sum of squares about its centre c,
      // c, its element count), combined in the same order by every warp:
      // sum (x - mu)^2 = m2 + 2 (c - mu) (s - n c) + n (c - mu)^2
      if (lane == 0) xch[parity][warp] = make_float4(s, m2, mean, n_w);
      row_sync(group, RW);
      float S = 0.f;
#pragma unroll 1
      for (int j = 0; j < RW; ++j) S += xch[parity][group * RW + j].x;
      const float mu = div_n(S, (float)D, inv_d);
      float M2 = 0.f;
#pragma unroll 1
      for (int j = 0; j < RW; ++j) {
        const float4 e = xch[parity][group * RW + j];
        const float d = e.z - mu;
        M2 += e.y + 2.f * d * (e.x - e.w * e.z) + e.w * d * d;
      }
      mean = mu;
      m2 = M2;
    }
    const float inv = rsqrtf(div_n(m2, (float)D, inv_d) + eps);

    // vector i's values as the plain version rounds them: the affine in
    // fp32, then bf16, then the modulation in fp32 (K1 rounds the result to
    // bf16; K12 quantises it, or the bf16 affine value without modulation)
    const auto values = [&](int i, int vi, float (&y)[8]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack2(word(v[i], k));
        y[2 * k] = __fmul_rn(f.x - mean, inv);
        y[2 * k + 1] = __fmul_rn(f.y - mean, inv);
      }
      if (has_w) {
        const float4 a = s_w[vi], c = s_w[nvec + vi];
        const float w8[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = __fmul_rn(y[k], w8[k]);
      }
      if (has_b) {
        const float4 a = s_b[vi], c = s_b[nvec + vi];
        const float b8[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = __fadd_rn(y[k], b8[k]);
      }
      if (has_mod) {
        // WanLayerNorm casts out to bf16 before the fp32 modulation
        const float4 a = s_scale[vi], c = s_scale[nvec + vi];
        const float4 e = s_shift[vi], f = s_shift[nvec + vi];
        const float sc[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
        const float sh[8] = {e.x, e.y, e.z, e.w, f.x, f.y, f.z, f.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 r = unpack2(pack2(y[2 * k], y[2 * k + 1]));   // bf16, a pair a cvt
          y[2 * k] = __fadd_rn(__fmul_rn(r.x, sc[2 * k]), sh[2 * k]);
          y[2 * k + 1] = __fadd_rn(__fmul_rn(r.y, sc[2 * k + 1]), sh[2 * k + 1]);
        }
      } else if (QUANT) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 r = unpack2(pack2(y[2 * k], y[2 * k + 1]));
          y[2 * k] = r.x;
          y[2 * k + 1] = r.y;
        }
      }
    };

    const size_t row = (size_t)b * L + l;
    if constexpr (!QUANT) {
      uint4* orow = reinterpret_cast<uint4*>(out) + row * nvec;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = vec_index(i, RW, wig, lane);
        if (vi >= nvec) continue;
        float y[8];
        values(i, vi, y);
        store_vec(orow + vi, make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                                        pack2(y[4], y[5]), pack2(y[6], y[7])));
      }
    } else {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = vec_index(i, RW, wig, lane);
        if (vi >= nvec) continue;
        float y[8];
        values(i, vi, y);
#pragma unroll
        for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(y[k]));
      }
      amax = warp_max_nonneg(amax);
      if (RW > 1) {
        // the second exchange of a wide row: its warps' absmax
        if (lane == 0) xmax[parity][warp] = amax;
        row_sync(group, RW);
#pragma unroll 1
        for (int j = 0; j < RW; ++j) amax = fmaxf(amax, xmax[parity][group * RW + j]);
      }
      // the TPU kernel's rule: scale = max(amax, 1e-8) / 127, q =
      // round-half-even(y * (1 / scale)) saturated to +-127
      const float scale = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
      const float qinv = rcp_rn(scale);
      // the values again from the packed row and the staged operands: as far
      // as the compiler knows the row and shared memory have changed, so it
      // recomputes them rather than hold the fp32 row in registers
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        asm volatile("" : "+r"(v[i].x), "+r"(v[i].y), "+r"(v[i].z), "+r"(v[i].w)::"memory");
      uint2* orow = reinterpret_cast<uint2*>(out) + row * nvec;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = vec_index(i, RW, wig, lane);
        if (vi >= nvec) continue;
        float y[8];
        values(i, vi, y);
        store_vec8(orow + vi, quant8_rn(y, qinv));
      }
      if (wig == 0 && lane == 0) rs[row] = scale;
    }
    parity ^= 1;
  }
  if (PREFETCH) cp_async_wait<0>();
}

// K2's vector form. x rows `ld` elements apart, out (rows, HD) with
// HD = 8 * nvec; Dh a power of two from 16 to 256, so a head is Dh/8 lanes
// of one 32-vector span and the partner of a lane's vector is lane ^ Dh/16.
// inv_hd = 1/HD, from the host.
template <int VPL, bool ROPE>
__global__ void __launch_bounds__(kRowThreads)
rmsrope_rows_kernel(const __nv_bfloat16* __restrict__ x, uint4* __restrict__ out,
                    const uint4* __restrict__ weight, const float* __restrict__ cos_full,
                    const float* __restrict__ sin_full, long long ld, int rows, int L,
                    int HD, int Dh, float inv_hd, float eps) {
  extern __shared__ uint4 s_wv[];   // the bf16 weight, nvec vectors
  __shared__ float xch[2][kRowWarps];
  const int nvec = HD / 8;
  const int RW = row_warps(nvec);
  for (int v = threadIdx.x; v < nvec; v += kRowThreads) s_wv[v] = weight[v];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kRowWarps / RW, group = warp / RW, wig = warp % RW;
  const int hv = Dh / 16;                       // the RoPE partner: lane ^ hv
  const int col = (lane & (Dh / 8 - 1)) * 8;    // the lane's column in each head
  const int step = gridDim.x * groups;
  int parity = 0;
  for (int r = blockIdx.x * groups + group; r < rows; r += step) {
    uint4 v[VPL];
    load_row<VPL>(v, reinterpret_cast<const uint4*>(x + r * ld), nvec, RW, wig, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack2(word(v[i], k));
        s += f.x * f.x + f.y * f.y;
      }
    s = warp_sum(s);
    if (RW > 1) {
      if (lane == 0) xch[parity][warp] = s;
      row_sync(group, RW);
      s = 0.f;
#pragma unroll 1
      for (int j = 0; j < RW; ++j) s += xch[parity][group * RW + j];
      parity ^= 1;
    }
    const float rms = rsqrtf(div_n(s, (float)HD, inv_hd) + eps);
    float cs[8], sn[8];
    if (ROPE) {
      const int t = (r % L) * Dh + col;
      const float4 c0 = *reinterpret_cast<const float4*>(cos_full + t);
      const float4 c1 = *reinterpret_cast<const float4*>(cos_full + t + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sin_full + t);
      const float4 s1 = *reinterpret_cast<const float4*>(sin_full + t + 4);
      cs[0] = c0.x; cs[1] = c0.y; cs[2] = c0.z; cs[3] = c0.w;
      cs[4] = c1.x; cs[5] = c1.y; cs[6] = c1.z; cs[7] = c1.w;
      sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
      sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
    }

    uint4* orow = out + (size_t)r * nvec;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = vec_index(i, RW, wig, lane);
      const uint4 wv = s_wv[vi < nvec ? vi : 0];
      uint32_t y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // cast to bf16 BEFORE the (bf16) weight multiply, as WanRMSNorm does
        const float2 f = unpack2(word(v[i], k)), w = unpack2(word(wv, k));
        const float2 t = unpack2(pack2(f.x * rms, f.y * rms));
        y[k] = pack2(t.x * w.x, t.y * w.y);
      }
      if (ROPE) {
        // out[j] = y[j]*cos[j] + y[(j + Dh/2) % Dh]*sin[j]; every lane
        // shuffles (a head's lanes are all in or all past the row)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a = unpack2(y[k]);
          const float2 p = unpack2(__shfl_xor_sync(0xffffffffu, y[k], hv));
          y[k] = pack2(a.x * cs[2 * k] + p.x * sn[2 * k],
                       a.y * cs[2 * k + 1] + p.y * sn[2 * k + 1]);
        }
      }
      if (vi < nvec) store_vec(orow + vi, make_uint4(y[0], y[1], y[2], y[3]));
    }
  }
}

}  // namespace

namespace {

// The shapes the warp-per-row kernels take (1 = vector form, 0 = the
// block-per-row kernel). K1: D a multiple of 8 up to kMaxVecRow, every
// operand 16-byte aligned.
bool mln_vector(const void* x, const void* out, const void* mod_scale, const void* mod_shift,
                const void* weight, const void* bias, int D) {
  return D > 0 && D % 8 == 0 && D <= kMaxVecRow && aligned16(x) && aligned16(out) &&
         aligned16(mod_scale) && aligned16(mod_shift) && aligned16(weight) &&
         aligned16(bias);
}

// K2: Dh a power of two from 16 to 256 (Dh/2 a multiple of 8, Dh/8 lanes
// dividing the warp), H*Dh up to kMaxVecRow, a row stride that is a multiple
// of 8, every pointer 16-byte aligned.
bool rmsrope_vector(const void* x, const void* out, const void* weight, const void* cos_full,
                    const void* sin_full, long long ld, int H, int Dh) {
  return Dh >= 16 && Dh <= 256 && (Dh & (Dh - 1)) == 0 && (long long)H * Dh <= kMaxVecRow &&
         ld % 8 == 0 && aligned16(x) && aligned16(out) && aligned16(weight) &&
         aligned16(cos_full) && aligned16(sin_full);
}

template <int V, bool QUANT>
int launch_mln_rows(int vpl, const void* x, void* out, float* rs, const void* mod_scale,
                    const void* mod_shift, const void* weight, const void* bias, int rows,
                    int L, int D, float eps, cudaStream_t stream) {
  if constexpr (V > kMaxVpl) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vpl != V)
      return launch_mln_rows<V + 1, QUANT>(vpl, x, out, rs, mod_scale, mod_shift, weight, bias,
                                           rows, L, D, eps, stream);
    const auto kernel = &mln_rows_kernel<V, QUANT>;
    const size_t smem =
        (size_t)D * sizeof(float) *
            (2 * (mod_scale != nullptr) + (weight != nullptr) + (bias != nullptr)) +
        (QUANT && kQuantPrefetch ? (size_t)kRowWarps * 2 * V * 32 * 16 : 0);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int B = rows / L, groups = kRowWarps / row_warps(D / 8);
    const int per_batch =
        std::max(1, std::min((L + groups - 1) / groups, resident_blocks(kernel, smem) / B));
    kernel<<<B * per_batch, kRowThreads, smem, stream>>>(
        (const uint4*)x, out, rs, (const float4*)mod_scale, (const float4*)mod_shift,
        (const uint4*)weight, (const uint4*)bias, L, D, per_batch, 1.f / D, eps);
    return (int)cudaGetLastError();
  }
}

template <int V, bool ROPE>
int launch_rmsrope_rows(int vpl, const void* x, void* out, const void* weight,
                        const void* cos_full, const void* sin_full, long long ld, int rows,
                        int L, int HD, int Dh, float eps, cudaStream_t stream) {
  if constexpr (V > kMaxVpl) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vpl != V)
      return launch_rmsrope_rows<V + 1, ROPE>(vpl, x, out, weight, cos_full, sin_full, ld,
                                              rows, L, HD, Dh, eps, stream);
    const auto kernel = &rmsrope_rows_kernel<V, ROPE>;
    const size_t smem = (size_t)HD * 2;
    const int groups = kRowWarps / row_warps(HD / 8);
    const int grid = std::min((rows + groups - 1) / groups, resident_blocks(kernel, smem));
    kernel<<<grid, kRowThreads, smem, stream>>>(
        (const __nv_bfloat16*)x, (uint4*)out, (const uint4*)weight, (const float*)cos_full,
        (const float*)sin_full, ld, rows, L, HD, Dh, 1.f / HD, eps);
    return (int)cudaGetLastError();
  }
}

// K1 and K12 at the shapes mln_vector refuses: the instance whose
// registers hold a D-wide row, 8 pairs a thread up to 4096, 10 up to 5120.
// It reads x, weight and bias as bf16 pairs and the modulation as float2,
// and writes pairs: it refuses operands off those alignments.
template <bool QUANT>
int launch_mln(const void* x, void* out, float* rs, const void* mod_scale,
               const void* mod_shift, const void* weight, const void* bias, int rows, int L,
               int D, float eps, void* stream) {
  if (D <= 0 || D % 2 || D > 2 * kThreads * kWidePairs) return (int)cudaErrorInvalidValue;
  const auto off = [](const void* p, int n) { return ((uintptr_t)p % n) != 0; };
  if (off(x, 4) || off(out, QUANT ? 2 : 4) || off(mod_scale, 8) || off(mod_shift, 8) ||
      off(weight, 4) || off(bias, 4))
    return (int)cudaErrorInvalidValue;
  const auto kernel = D <= 2 * kThreads * kMaxPairs ? &mln_kernel<QUANT, kMaxPairs>
                                                    : &mln_kernel<QUANT, kWidePairs>;
  kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat162*)x, out, rs, (const float2*)mod_scale, (const float2*)mod_shift,
      (const __nv_bfloat162*)weight, (const __nv_bfloat162*)bias, L, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdx_modulated_layer_norm_form(const void* x, const void* out,
                                             const void* mod_scale, const void* mod_shift,
                                             const void* weight, const void* bias, int D) {
  return mln_vector(x, out, mod_scale, mod_shift, weight, bias, D) ? 1 : 0;
}

extern "C" int tdx_rmsnorm_rope_form(const void* x, const void* out, const void* weight,
                                     const void* cos_full, const void* sin_full, long long ld,
                                     int H, int Dh) {
  return rmsrope_vector(x, out, weight, cos_full, sin_full, ld, H, Dh) ? 1 : 0;
}

// K1 and K12 take the same form for the same operands
extern "C" int tdx_modulated_layer_norm_quant_form(const void* x, const void* out_q,
                                                   const void* mod_scale, const void* mod_shift,
                                                   const void* weight, const void* bias, int D) {
  return mln_vector(x, out_q, mod_scale, mod_shift, weight, bias, D) ? 1 : 0;
}

extern "C" int tdx_modulated_layer_norm(const void* x, void* out,
                                        const void* mod_scale, const void* mod_shift,
                                        const void* weight, const void* bias,
                                        int rows, int L, int D, float eps,
                                        void* stream) {
  if (!mln_vector(x, out, mod_scale, mod_shift, weight, bias, D))
    return launch_mln<false>(x, out, nullptr, mod_scale, mod_shift, weight, bias, rows, L, D,
                             eps, stream);
  if (rows < 0 || L <= 0 || rows % L) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return launch_mln_rows<1, false>(lane_vectors(D / 8), x, out, nullptr, mod_scale, mod_shift,
                                   weight, bias, rows, L, D, eps, (cudaStream_t)stream);
}

extern "C" int tdx_modulated_layer_norm_quant(const void* x, void* out_q, void* out_scale,
                                              const void* mod_scale, const void* mod_shift,
                                              const void* weight, const void* bias,
                                              int rows, int L, int D, float eps,
                                              void* stream) {
  if (!mln_vector(x, out_q, mod_scale, mod_shift, weight, bias, D))
    return launch_mln<true>(x, out_q, (float*)out_scale, mod_scale, mod_shift, weight, bias,
                            rows, L, D, eps, stream);
  if (rows < 0 || L <= 0 || rows % L) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return launch_mln_rows<1, true>(lane_vectors(D / 8), x, out_q, (float*)out_scale, mod_scale,
                                  mod_shift, weight, bias, rows, L, D, eps,
                                  (cudaStream_t)stream);
}

extern "C" int tdx_rmsnorm_rope(const void* x, void* out, const void* weight,
                                const void* cos_full, const void* sin_full,
                                long long ld, int rows, int L, int H, int Dh, float eps,
                                void* stream) {
  // a row of H*Dh elements with an even Dh, up to 2^30 (no int overflows)
  const long long HD = (long long)H * Dh;
  if (rows < 0 || L <= 0 || H <= 0 || Dh <= 0 || Dh % 2 || HD > (1LL << 30) || ld < HD)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  if (rmsrope_vector(x, out, weight, cos_full, sin_full, ld, H, Dh)) {
    const int HD = H * Dh, vpl = lane_vectors(HD / 8);
    return cos_full ? launch_rmsrope_rows<1, true>(vpl, x, out, weight, cos_full, sin_full, ld,
                                                   rows, L, HD, Dh, eps, (cudaStream_t)stream)
                    : launch_rmsrope_rows<1, false>(vpl, x, out, weight, nullptr, nullptr, ld,
                                                    rows, L, HD, Dh, eps, (cudaStream_t)stream);
  }
  rmsrope_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const __nv_bfloat16*)weight,
      (const float*)cos_full, (const float*)sin_full, ld, L, H, Dh, eps);
  return (int)cudaGetLastError();
}
