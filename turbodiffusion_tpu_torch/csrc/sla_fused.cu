// K5, K6, K13, K15, K16, K18, K27 and K29: the fused SageSLA front-end for
// sm_90a.
//
// K5 tdx_head_planes replaces the TPU kernel
//    turbodiffusion_tpu/ops/sla_fused.py:head_planes (body _head_planes_kernel):
//    one pass over a (B, L, H*128) bf16 projection output (rows `ld` elements
//    apart, so a Q, K or V column group of the fused (B, L, 3*H*128) QKV GEMM
//    output is read in place) that writes any of
//    the bf16 head planes (B, H, Lp, 128), per-(head, token) int8 planes with
//    fp32 scales (B, H, Lp), and per-block pooled means (B, H, nP, 128) fp32,
//    with the full-row RMSNorm and the rotate-half RoPE fused in.
// K6 tdx_subquant_pack_kvt replaces sla_fused.py:subquant_pack_kvt (body
//    _subquant_pack_kvt_kernel): smooth-k subtract + per-block int8 K with one
//    fp32 scale per block_k rows (rows >= kv_len stay out of the statistic),
//    and the per-block transposed int8 V panel (B, H, nK, 128, block_k) that
//    K7 stages without a transpose. With the linear branch on, tdx_linear_kv
//    (csrc/linear_attention.cu, shared with K21) adds kv = sum softmax_D(k)^T
//    v_i8 (B, H, 128, 128) and ksum = sum softmax_D(k) over rows < kv_len.
// K13 tdx_unfold_quant replaces sla_fused.py:unfold_quant, narrow form (body
//    _unfold_quant_kernel): K7's bf16 planes (B, H, Lp, Dh) -> the int8 feed of
//    the W8A8 O projection, (B, L, H*Dh) int8 with one fp32 scale per token
//    across all heads; only the L live rows are written.
// K15 tdx_row_rms_inv replaces sla_fused.py:row_rms_inv (body _row_rms_kernel):
//    (B, L, W) bf16 rows `ld` elements apart -> (B, L) fp32
//    rsqrt(mean(x^2) + eps), the full-row statistic that K5's external-RMS
//    mode and K17 read for the wide models (14B: dim 5120).
// K18 tdx_subquant_pack_kv replaces sla_fused.py:subquant_pack_kv in its
//    per-row mode (body _subquant_pack_kernel with block_k 0), the
//    v_quant=row producer: xf = f32(k) - mu, one fp32 scale per row, int8 K
//    written into the first half of a packed (B, H, Lp, 256) K|V row and the
//    per-row int8 V row (K5's) copied into the second half: the layout K19
//    gathers, one 256-byte row a key. No trailing poison block and no
//    (TL/128, 128) scale relayout: K19 masks keys past kv_len by column.
// K27 tdx_subquant_pack_kv_blocks replaces sla_fused.py:subquant_pack_kv in
//    its block-scale mode (body _subquant_pack_kernel with block_k), the
//    producer of the block-scale sparse kernel (K28) that fused sagesla at
//    v_quant=channel takes once sel * block_k exceeds 8,192: K6's block
//    statistic (max |k - mu| over the block's rows < kv_len; rows past it
//    may hold NaN and stay out), every row of the block quantised with it,
//    written into K18's packed (B, H, Lp, 256) K|V layout with the int8 V
//    row beside it; one fp32 scale per (b, h, K block). No poison block.
// K29 tdx_subquant_planes replaces sla_fused.py:subquant_planes (body
//    _subquant_kernel): K18's per-row rule without the packing, (B, H, Lp,
//    128) bf16 planes minus mu -> int8 planes and (B, H, Lp) fp32 scales.
// K16 tdx_unfold_quant_wide replaces sla_fused.py:unfold_quant, wide form
//    (H*Dh > 4096; bodies _unfold_scale_kernel and _unfold_write_kernel, two
//    TPU passes): K13's function with the wide kernel's rule, one launch.
//
// What bounds them on an H100: memory. A K5 pass reads the 100.6 MB
// projection (1.3B, 480p: L = 32,760, H*Dh = 1536) and writes 51-101 MB at
// a few FLOPs per byte; K6 reads 151 MB of K and V and writes 75 MB. The
// designs move each byte once:
//   * K5: one warp per row (8 warps x 8 rows = one 64-row block). A lane
//     owns whole 8-element chunks and their rotate-half partners (channel i
//     and i + 64 of one head), so the RoPE needs no shuffle; the row's RMS is
//     one warp reduction and a head's int8 absmax a reduction over the 8
//     lanes that hold it. Loads and stores are 16 bytes a lane. The pooled
//     sums are kept in registers per warp, combined in shared memory in warp
//     order, written as one partial per 64-row block, and the last block of
//     each pool window (an atomic counter) sums that window's partials in
//     order: one launch, deterministic, no fp32 atomics on the data.
//   * K6: one 256-thread block per (b, h, K block): the block absmax over
//     valid rows, a second read of the block (an L2 hit) to quantise, and the
//     V block transposed through shared memory.
//   * tdx_linear_kv (csrc/linear_attention.cu) re-reads K and V, where the
//     TPU kernel folds the sums into its K/V walk; the main path (random
//     weights, so proj_l = 0) does not run it.
//   * K27: K6's block (a 256-thread block per (b, h, K block), the
//     statistic then a second read of the block, an L2 hit), with K written
//     at a 256-byte row stride and the V rows copied beside it 16 bytes a
//     thread (1.3B 480p: 100.7 MB of K and 50.3 MB of V in, 100.7 MB out).
//   * K29: K18's warp-a-row kernel writing the int8 row alone (100.7 MB in,
//     50.3 MB and 1.6 MB of scales out).
//   * K18: memory-bound (1.3B 480p: 100.7 MB of K and 50.3 MB of V in,
//     100.7 MB of K|V and 1.6 MB of scales out, 0.076 ms). One warp per row,
//     8-byte K loads, 4-byte V copies and 4-byte int8 stores a lane, all
//     coalesced; the row absmax is one warp reduction. K8's rule (fp32
//     subtract, 1.0f / scale then a multiply, round half to even), so it is
//     bit-equal to the TPU kernel.
// The arithmetic follows the JAX chain: RMS over the whole row in fp32, a
// bf16 round, a bf16 product with the weight, fp32 RoPE; the int8 plane and
// the pooled means come from that fp32 value; scale = max(amax, 1e-8) *
// (1/127), q = round-half-even(y * (1/scale)) saturated to +-127. Products
// and sums that the plain version rounds one by one use __fmul_rn /
// __fadd_rn so nvcc does not contract them into FMAs.
//   * K13: memory-bound too (100.6 MB in, 50.4 MB out at the main shape:
//     0.045 ms). One warp per token: each lane loads 16-byte chunks of the
//     token's head slices (a warp reads two heads' 256-byte rows at a time),
//     keeps them in registers for the absmax and the quantise, and the warp
//     writes the token's 1536-byte int8 row as contiguous 8-byte stores. The
//     rule is K8's (csrc/quant.cu) on the unfolded bf16 row, so the two agree
//     bit for bit.
//   * K5 at more than 16 heads (14B: 40) walks the heads in groups of 16
//     inside one launch: a lane holds one group's chunks at a time, so the
//     registers stay those of the 16-head form. That needs the row's RMS
//     before the first group: it comes from K15 (`ri`, the TPU kernel's
//     external-RMS mode), or there is no norm (the V pass). With the RMS in
//     the row (ri null) the whole row is one group (H <= 16).
//   * K15: 335.5 MB in at 14B (0.100 ms). One warp per row, 16-byte loads,
//     an fp32 sum of squares per lane, one warp reduction.
//   * K16: K13's warp-a-token kernel with 20 chunks a lane (a 5120-wide row
//     in registers) and the wide TPU kernel's rule, q = round-half-even(y /
//     scale) with IEEE division (__fdiv_rn), where K13 keeps the narrow
//     kernel's y * (1/scale). Each is bit-equal to its own TPU kernel.
// A first, simple version: no cp.async or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kHpRows = 64;                    // rows of one K5 block
constexpr int kHpWarps = 8;
constexpr int kHpThreads = kHpWarps * 32;
constexpr int kRowsPerWarp = kHpRows / kHpWarps;
constexpr int kMaxHeads = 40;                  // the pooled sums' shared row
constexpr int kGroupHeads = 16;               // heads a lane's registers hold
constexpr float kInvInt8 = 1.0f / 127.0f;
constexpr int kSqThreads = 256;
constexpr int kMaxBlockK = 256;
constexpr int kVTileStride = kDh + 4;          // bytes per row of K6's V tile

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// 8 values -> 8 int8: round half to even, saturated to +-127.
__device__ __forceinline__ uint2 quant8(const float* f, float inv) {
  uint32_t w[2];
#pragma unroll
  for (int hw = 0; hw < 2; ++hw) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q = __float2int_rn(__fmul_rn(f[4 * hw + i], inv));
      q = max(-127, min(127, q));
      acc |= (uint32_t)(q & 0xff) << (8 * i);
    }
    w[hw] = acc;
  }
  return make_uint2(w[0], w[1]);
}

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

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// NI = pair-chunks per lane = ceil(G * 8 / 32) for a group of G heads.
// Pair-chunk p = lane + 32 i of the group starting at head h0 is head
// h0 + p / 8, channels (p % 8) * 8 + [0, 8) and the same + 64. ri: the row's
// RMS inverse (B, L) from K15, or null (RMS over the row, or no norm).
template <int NI>
__global__ void __launch_bounds__(kHpThreads)
head_planes_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w, const float* __restrict__ ri,
                   const float* __restrict__ cosF, const float* __restrict__ sinF,
                   __nv_bfloat16* __restrict__ out_bf, int8_t* __restrict__ out_i8,
                   float* __restrict__ out_scale, float* __restrict__ partial,
                   float* __restrict__ pooled, int* __restrict__ counters, long long ld,
                   int L, int Lp, int H, int pool, int nP, float eps) {
  __shared__ float red[kMaxHeads * kDh];
  __shared__ int s_last;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HD = H * kDh, G = NI * 4;
  const __nv_bfloat16* xb = x + (size_t)b * L * ld;
  // below 16 heads the launch picked NI with G >= H: one group, which the
  // compiler sees (a bound it cannot see costs the 12-head form a spill)
  const int h_end = G < kGroupHeads ? G : H;

  for (int h0 = 0; h0 < h_end; h0 += G) {
    const int npc = min(G, H - h0) * 8;
    float pacc[NI][16];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) pacc[i][e] = 0.f;

    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = tile * kHpRows + warp * kRowsPerWarp + r;
      const bool valid = row < L;
      float y[NI][16];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int p = lane + 32 * i;
        if (valid && p < npc) {
          const __nv_bfloat16* src = xb + (size_t)row * ld + (h0 + (p >> 3)) * kDh + (p & 7) * 8;
          unpack8(*reinterpret_cast<const uint4*>(src), y[i]);
          unpack8(*reinterpret_cast<const uint4*>(src + 64), y[i] + 8);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) y[i][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) ss += y[i][e] * y[i][e];
      }
      if (valid) {
        if (w != nullptr) {
          const float rms = ri != nullptr ? ri[(size_t)b * L + row]
                                          : 1.f / sqrtf(warp_sum(ss) / HD + eps);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int p = lane + 32 * i;
            if (p >= npc) continue;
            const __nv_bfloat16* wp = w + (h0 + (p >> 3)) * kDh + (p & 7) * 8;
            float wv[16];
            unpack8(*reinterpret_cast<const uint4*>(wp), wv);
            unpack8(*reinterpret_cast<const uint4*>(wp + 64), wv + 8);
            // cast to bf16 BEFORE the bf16 weight product, as WanRMSNorm does
#pragma unroll
            for (int e = 0; e < 16; ++e)
              y[i][e] = round_bf16(__fmul_rn(round_bf16(__fmul_rn(y[i][e], rms)), wv[e]));
          }
        }
        if (cosF != nullptr) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int p = lane + 32 * i;
            if (p >= npc) continue;
            const int c0 = (p & 7) * 8;
            const float* cr = cosF + (size_t)row * kDh;
            const float* sr = sinF + (size_t)row * kDh;
            float cl[8], ch[8], sl[8], sh[8];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              *reinterpret_cast<float4*>(cl + 4 * q) = *reinterpret_cast<const float4*>(cr + c0 + 4 * q);
              *reinterpret_cast<float4*>(ch + 4 * q) = *reinterpret_cast<const float4*>(cr + 64 + c0 + 4 * q);
              *reinterpret_cast<float4*>(sl + 4 * q) = *reinterpret_cast<const float4*>(sr + c0 + 4 * q);
              *reinterpret_cast<float4*>(sh + 4 * q) = *reinterpret_cast<const float4*>(sr + 64 + c0 + 4 * q);
            }
            // out[j] = y[j] cos[j] + y[(j + 64) % 128] sin[j]
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float a = y[i][e], c = y[i][8 + e];
              y[i][e] = __fadd_rn(__fmul_rn(a, cl[e]), __fmul_rn(c, sl[e]));
              y[i][8 + e] = __fadd_rn(__fmul_rn(c, ch[e]), __fmul_rn(a, sh[e]));
            }
          }
        }
        if (pool) {
#pragma unroll
          for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int e = 0; e < 16; ++e) pacc[i][e] += y[i][e];
        }
      }
      // rows in [L, Lp) are the planes of a zero row
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int p = lane + 32 * i;
        float inv = 0.f, scale = 0.f;
        if (out_i8 != nullptr) {
          float amax = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(y[i][e]));
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
          scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
          inv = 1.f / scale;
        }
        if (p >= npc) continue;
        const int h = h0 + (p >> 3), c0 = (p & 7) * 8;
        const size_t off = (((size_t)b * H + h) * Lp + row) * kDh + c0;
        if (out_bf != nullptr) {
          *reinterpret_cast<uint4*>(out_bf + off) = pack8(y[i]);
          *reinterpret_cast<uint4*>(out_bf + off + 64) = pack8(y[i] + 8);
        }
        if (out_i8 != nullptr) {
          *reinterpret_cast<uint2*>(out_i8 + off) = quant8(y[i], inv);
          *reinterpret_cast<uint2*>(out_i8 + off + 64) = quant8(y[i] + 8, inv);
          if ((p & 7) == 0) out_scale[((size_t)b * H + h) * Lp + row] = scale;
        }
      }
    }

    if (!pool) continue;
    // this block's pooled sums of the group, warp by warp in order
    for (int wv = 0; wv < kHpWarps; ++wv) {
      if (warp == wv) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int p = lane + 32 * i;
          if (p >= npc) continue;
          const int base = (h0 + (p >> 3)) * kDh + (p & 7) * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            red[base + e] = (wv ? red[base + e] : 0.f) + pacc[i][e];
            red[base + 64 + e] = (wv ? red[base + 64 + e] : 0.f) + pacc[i][8 + e];
          }
        }
      }
      __syncthreads();
    }
  }

  if (!pool) return;
  const int n_tiles = Lp / kHpRows;
  float* part = partial + ((size_t)b * n_tiles + tile) * HD;
  for (int c = threadIdx.x; c < HD; c += kHpThreads) part[c] = red[c];
  __threadfence();
  __syncthreads();
  const int per = pool / kHpRows, pb = tile / per;
  if (threadIdx.x == 0)
    s_last = atomicAdd(&counters[b * (Lp / pool) + pb], 1) == per - 1;
  __syncthreads();
  if (!s_last || pb >= nP) return;
  // the last block of this pool window: sum its partials in order
  __threadfence();
  const float cnt = (float)min(pool, L - pb * pool);
  const float* first = partial + ((size_t)b * n_tiles + (size_t)pb * per) * HD;
  for (int c = threadIdx.x; c < HD; c += kHpThreads) {
    float s = 0.f;
    for (int t = 0; t < per; ++t) s += __ldcg(first + (size_t)t * HD + c);
    pooled[(((size_t)b * H + c / kDh) * nP + pb) * kDh + (c % kDh)] = s / cnt;
  }
}

// ---------------------------------------------------------------------------
// K6 and K27
// ---------------------------------------------------------------------------

// One block per (b, h, K block). PACKED (K27): the int8 K rows go into the
// first half of packed (B, H, Lp, 256) K|V rows and the V rows are copied
// beside them; else (K6) K goes to kp (B, H, Lp, 128) and V into the
// per-block transposed panel vtp.
template <bool PACKED>
__global__ void __launch_bounds__(kSqThreads)
subquant_block_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ mu,
                      const int8_t* __restrict__ v, int8_t* __restrict__ kp,
                      int8_t* __restrict__ vtp, float* __restrict__ ks, int H, int Lp,
                      int block_k, int kv_len) {
  constexpr int kRow = PACKED ? 2 * kDh : kDh;   // bytes between K rows of kp
  __shared__ __align__(16) int8_t vtile[PACKED ? 16 : kMaxBlockK * kVTileStride];
  __shared__ float red[kSqThreads / 32];
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nK = Lp / block_k;
  const size_t bh = (size_t)b * H + h;
  const int row0 = kb * block_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x & 15;            // this thread's 8 channels
  const int r0 = threadIdx.x >> 4;           // rows r0, r0 + 16, ...
  const __nv_bfloat16* kbase = k + (bh * Lp + row0) * kDh + c * 8;

  float m8[8];
  *reinterpret_cast<float4*>(m8) = *reinterpret_cast<const float4*>(mu + bh * kDh + c * 8);
  *reinterpret_cast<float4*>(m8 + 4) = *reinterpret_cast<const float4*>(mu + bh * kDh + c * 8 + 4);

  // the block statistic over rows < kv_len (rows past it may hold NaN)
  float amax = 0.f;
  for (int r = r0; r < block_k && row0 + r < kv_len; r += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(kbase + (size_t)r * kDh), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fsub_rn(f[e], m8[e])));
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kSqThreads / 32; ++i) m = fmaxf(m, red[i]);
  const float scale = __fmul_rn(fmaxf(m, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  if (threadIdx.x == 0) ks[bh * nK + kb] = scale;

  // every row, rows past kv_len too, with the block's scale
  int8_t* kout = kp + (bh * Lp + row0) * kRow + c * 8;
  for (int r = r0; r < block_k; r += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(kbase + (size_t)r * kDh), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fsub_rn(f[e], m8[e]);
    *reinterpret_cast<uint2*>(kout + (size_t)r * kRow) = quant8(f, inv);
  }

  const int8_t* vbase = v + (bh * Lp + row0) * kDh;
  if constexpr (PACKED) {
    // V rows beside K: 16-byte copies, neighbouring threads on neighbouring
    // addresses
    int8_t* vout = kp + (bh * Lp + row0) * kRow + kDh;
    for (int u = threadIdx.x; u < block_k * 8; u += kSqThreads) {
      const int r = u >> 3, c16 = u & 7;
      *reinterpret_cast<uint4*>(vout + (size_t)r * kRow + c16 * 16) =
          *reinterpret_cast<const uint4*>(vbase + (size_t)r * kDh + c16 * 16);
    }
  } else {
    // V block (block_k, 128) -> (128, block_k) through shared memory
    for (int u = threadIdx.x; u < block_k * 8; u += kSqThreads) {
      const int r = u >> 3, c16 = u & 7;
      const uint4 val = *reinterpret_cast<const uint4*>(vbase + (size_t)r * kDh + c16 * 16);
      uint32_t* dst = reinterpret_cast<uint32_t*>(vtile + r * kVTileStride + c16 * 16);
      dst[0] = val.x;
      dst[1] = val.y;
      dst[2] = val.z;
      dst[3] = val.w;
    }
    __syncthreads();
    int8_t* vout = vtp + (bh * nK + kb) * (size_t)kDh * block_k;
    const int nq = block_k / 4;
    for (int u = threadIdx.x; u < kDh * nq; u += kSqThreads) {
      const int d = u / nq, jq = u % nq;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= (uint32_t)(uint8_t)vtile[(jq * 4 + i) * kVTileStride + d] << (8 * i);
      *reinterpret_cast<uint32_t*>(vout + (size_t)d * block_k + jq * 4) = word;
    }
  }
}

// ---------------------------------------------------------------------------
// K18 and K29
// ---------------------------------------------------------------------------

constexpr int kSpWarps = 8;

// One warp per row of the (B*H*Lp) K planes: a lane owns channels
// 4 lane .. 4 lane + 3 of K (8 bytes) and of V (4 bytes). PACK (K18): the
// packed row is 128 bytes of int8 K then the 128 bytes of the V row; else
// (K29, v null) the int8 row goes to out (B*H*Lp, 128).
template <bool PACK>
__global__ void __launch_bounds__(kSpWarps * 32)
subquant_pack_kv_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ mu,
                        const int8_t* __restrict__ v, int8_t* __restrict__ out,
                        float* __restrict__ ks, int rows, int Lp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSpWarps + warp;
  if (row >= rows) return;
  const size_t bh = row / Lp;
  const uint2 u = *reinterpret_cast<const uint2*>(k + (size_t)row * kDh + lane * 4);
  const float4 m = *reinterpret_cast<const float4*>(mu + bh * kDh + lane * 4);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p2[0]), c = __bfloat1622float2(p2[1]);
  float f[4] = {__fsub_rn(a.x, m.x), __fsub_rn(a.y, m.y), __fsub_rn(c.x, m.z),
                __fsub_rn(c.y, m.w)};
  const float amax = warp_max(fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])),
                                    fmaxf(fabsf(f[2]), fabsf(f[3]))));
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int q = __float2int_rn(__fmul_rn(f[i], inv));
    q = max(-127, min(127, q));
    w |= (uint32_t)(q & 0xff) << (8 * i);
  }
  constexpr int kRow = PACK ? 2 * kDh : kDh;
  int8_t* dst = out + (size_t)row * kRow;
  *reinterpret_cast<uint32_t*>(dst + lane * 4) = w;
  if constexpr (PACK)
    *reinterpret_cast<uint32_t*>(dst + kDh + lane * 4) =
        *reinterpret_cast<const uint32_t*>(v + (size_t)row * kDh + lane * 4);
  if (lane == 0) ks[row] = scale;
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

constexpr int kUqWarps = 8;
constexpr int kUqChunks = 16;      // 16-byte chunks a lane holds: K13, rows <= 4096 wide
constexpr int kUqWideChunks = 20;  // K16, rows <= 5120 wide

// 8 values -> 8 int8 as the wide TPU kernel rounds them: round-half-even(y /
// scale) with an IEEE division, saturated to +-127.
__device__ __forceinline__ uint2 quant8_div(const float* f, float scale) {
  uint32_t w[2];
#pragma unroll
  for (int hw = 0; hw < 2; ++hw) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q = __float2int_rn(__fdiv_rn(f[4 * hw + i], scale));
      q = max(-127, min(127, q));
      acc |= (uint32_t)(q & 0xff) << (8 * i);
    }
    w[hw] = acc;
  }
  return make_uint2(w[0], w[1]);
}

// One warp per token row = b * L + l. Chunk c = lane + 32 i of the row is
// head c / (Dh / 8), channels (c % (Dh / 8)) * 8 + [0, 8). DIVIDE: K16's rule
// y / scale, else K13's y * (1 / scale).
template <int NC, bool DIVIDE>
__device__ __forceinline__ void unfold_quant_row(const __nv_bfloat16* __restrict__ planes,
                                                 int8_t* __restrict__ xq, float* __restrict__ rs,
                                                 int rows, int L, int Lp, int H, int Dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kUqWarps + warp;
  if (row >= rows) return;
  const int b = row / L, l = row % L;
  const int cph = Dh / 8, n = H * cph;
  uint4 u[NC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c >= n) break;
    const int h = c / cph;
    u[i] = *reinterpret_cast<const uint4*>(
        planes + (((size_t)b * H + h) * Lp + l) * Dh + (c - h * cph) * 8);
    float f[8];
    unpack8(u[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  amax = warp_max(amax);
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  int8_t* qr = xq + (size_t)row * n * 8;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c >= n) break;
    float f[8];
    unpack8(u[i], f);
    *reinterpret_cast<uint2*>(qr + c * 8) = DIVIDE ? quant8_div(f, scale) : quant8(f, inv);
  }
  if (lane == 0) rs[row] = scale;
}

__global__ void __launch_bounds__(kUqWarps * 32)
unfold_quant_kernel(const __nv_bfloat16* __restrict__ planes, int8_t* __restrict__ xq,
                    float* __restrict__ rs, int rows, int L, int Lp, int H, int Dh) {
  unfold_quant_row<kUqChunks, false>(planes, xq, rs, rows, L, Lp, H, Dh);
}

__global__ void __launch_bounds__(kUqWarps * 32)
unfold_quant_wide_kernel(const __nv_bfloat16* __restrict__ planes, int8_t* __restrict__ xq,
                         float* __restrict__ rs, int rows, int L, int Lp, int H, int Dh) {
  unfold_quant_row<kUqWideChunks, true>(planes, xq, rs, rows, L, Lp, H, Dh);
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

constexpr int kRrWarps = 8;

// One warp per row of W bf16 values, rows `ld` elements apart.
__global__ void __launch_bounds__(kRrWarps * 32)
row_rms_inv_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                   long long ld, int rows, int W, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRrWarps + warp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * ld;
  float s = 0.f;
#pragma unroll 4
  for (int c = lane * 8; c < W; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e] * f[e];
  }
  s = warp_sum(s);
  if (lane == 0) out[row] = 1.f / sqrtf(s / W + eps);
}

}  // namespace

extern "C" int tdx_unfold_quant(const void* planes, void* xq, void* rs, int B, int L,
                                int Lp, int H, int Dh, void* stream) {
  if (Dh % 8 || H * Dh > kUqChunks * 32 * 8 || L > Lp) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  unfold_quant_kernel<<<(rows + kUqWarps - 1) / kUqWarps, kUqWarps * 32, 0,
                        (cudaStream_t)stream>>>((const __nv_bfloat16*)planes, (int8_t*)xq,
                                                (float*)rs, rows, L, Lp, H, Dh);
  return (int)cudaGetLastError();
}

extern "C" int tdx_unfold_quant_wide(const void* planes, void* xq, void* rs, int B, int L,
                                     int Lp, int H, int Dh, void* stream) {
  if (Dh % 8 || H * Dh > kUqWideChunks * 32 * 8 || L > Lp) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  unfold_quant_wide_kernel<<<(rows + kUqWarps - 1) / kUqWarps, kUqWarps * 32, 0,
                             (cudaStream_t)stream>>>((const __nv_bfloat16*)planes,
                                                     (int8_t*)xq, (float*)rs, rows, L, Lp,
                                                     H, Dh);
  return (int)cudaGetLastError();
}

extern "C" int tdx_row_rms_inv(const void* x, void* out, long long ld, int rows, int W,
                               float eps, void* stream) {
  if (W <= 0 || W % 8 || ld % 8 || ld < W) return (int)cudaErrorInvalidValue;
  row_rms_inv_kernel<<<(rows + kRrWarps - 1) / kRrWarps, kRrWarps * 32, 0,
                       (cudaStream_t)stream>>>((const __nv_bfloat16*)x, (float*)out, ld,
                                               rows, W, eps);
  return (int)cudaGetLastError();
}

extern "C" int tdx_head_planes(const void* x, const void* w, const void* ri,
                               const void* cos_full, const void* sin_full, void* out_bf,
                               void* out_i8, void* out_scale, void* partial, void* pooled,
                               void* counters, long long ld, int B, int L, int Lp, int H,
                               int pool, int nP, float eps, void* stream) {
  // more than one head group needs the row's RMS from K15 (or no norm)
  if (H < 1 || H > kMaxHeads || (H > kGroupHeads && w != nullptr && ri == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / kHpRows, B);
  const int ni = (min(H, kGroupHeads) * 8 + 31) / 32;
#define TDX_HP_LAUNCH(NI)                                                             \
  head_planes_kernel<NI><<<grid, kHpThreads, 0, (cudaStream_t)stream>>>(              \
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)ri,             \
      (const float*)cos_full, (const float*)sin_full, (__nv_bfloat16*)out_bf,         \
      (int8_t*)out_i8, (float*)out_scale, (float*)partial, (float*)pooled,            \
      (int*)counters, ld, L, Lp, H, pool, nP, eps)
  switch (ni) {
    case 1: TDX_HP_LAUNCH(1); break;
    case 2: TDX_HP_LAUNCH(2); break;
    case 3: TDX_HP_LAUNCH(3); break;
    case 4: TDX_HP_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDX_HP_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_pack_kvt(const void* k, const void* mu, const void* v,
                                     void* kp, void* vtp, void* ks, int B, int H,
                                     int Lp, int block_k, int kv_len, void* stream) {
  if (block_k > kMaxBlockK || block_k % 64) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / block_k, H, B);
  subquant_block_kernel<false><<<grid, kSqThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kp,
      (int8_t*)vtp, (float*)ks, H, Lp, block_k, kv_len);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_pack_kv_blocks(const void* k, const void* mu, const void* v,
                                           void* kvi, void* ks, int B, int H, int Lp,
                                           int block_k, int kv_len, void* stream) {
  if (block_k <= 0 || block_k % 64 || Lp % block_k) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / block_k, H, B);
  subquant_block_kernel<true><<<grid, kSqThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kvi, nullptr,
      (float*)ks, H, Lp, block_k, kv_len);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_pack_kv(const void* k, const void* mu, const void* v, void* kvi,
                                    void* ks, int BH, int Lp, void* stream) {
  if (BH <= 0 || Lp <= 0) return (int)cudaErrorInvalidValue;
  const int rows = BH * Lp;
  subquant_pack_kv_kernel<true><<<(rows + kSpWarps - 1) / kSpWarps, kSpWarps * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kvi, (float*)ks,
      rows, Lp);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_planes(const void* k, const void* mu, void* out, void* ks, int BH,
                                   int Lp, void* stream) {
  if (BH <= 0 || Lp <= 0) return (int)cudaErrorInvalidValue;
  const int rows = BH * Lp;
  subquant_pack_kv_kernel<false><<<(rows + kSpWarps - 1) / kSpWarps, kSpWarps * 32, 0,
                                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, nullptr, (int8_t*)out, (float*)ks, rows, Lp);
  return (int)cudaGetLastError();
}
