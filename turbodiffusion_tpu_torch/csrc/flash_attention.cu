// K3, K4, K14, K17, K20 and K30: flash attention forward for sm_90a,
// block-sparse, dense, the cross attention with the int8 O feed, and the
// int8-QK forms.
//
// K3 tdx_sparse_flash_attention replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:_flash_fwd_impl, bf16 sparse
//    branch (body _sparse_attn_kernel): each block_q-row Q-block attends only
//    to the `sel` K-blocks of block_k rows that its LUT row names.
// K4 tdx_flash_attention replaces the dense branches of the same function
//    (bodies _attn_kernel_onepass and _attn_kernel without int8 QK):
//    softmax attention over all kv_len keys (cross-attention over the 512
//    text tokens; self-attention under --attention_type original).
// K14 tdx_cross_attention_qout replaces flash_pallas.py:cross_attention_qout,
//    fused-norm mode (body _cross_attn_qout_kernel): the raw cross-Q rows
//    (B, Lq, H*128) -> full-row RMSNorm (fp32 statistic, bf16 cast, bf16
//    weight product) -> per head softmax(q k^T * scale) V over the text keys
//    -> the int8 feed of the W8A8 O projection, (B, Lq, H*128) int8 with one
//    fp32 scale per token across all heads, taken from the fp32 output.
// K17 tdx_cross_attention_qout_wide replaces flash_pallas.py:
//    _cross_attention_qout_wide, fused-norm mode (body
//    _cross_attn_qout_wide_kernel; H*Dh > 2048, the 14B's 40 heads): K14's
//    function with the row's RMS inverse given (K15, (B, Lq) fp32), as the
//    TPU kernel takes it from row_rms_inv.
//
// What bounds them on an H100: tensor-core math. At the 1.3B 480p shape a K3
// call is ~6.2e11 FLOPs over ~100 MB of q/k/v, and a K4 or K14 cross call
// ~1.0e11 FLOPs, all well above the ridge. The design is FlashAttention-2 on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//   * one block of 4 warps owns 64 query rows of one (batch, head); each warp
//     owns 16 rows and keeps its Q fragments, its 16x128 fp32 output
//     accumulator and its running max / sum in registers;
//   * K and V stream through shared memory in 64-key chunks (K row-major, V
//     transposed, rows padded by 8 so fragment loads hit 32 distinct banks);
//     S = Q K^T and O += P V run on the tensor cores, and the probabilities
//     go from the S accumulators straight into the A fragments of P V
//     without touching shared memory;
//   * the online softmax runs in the log2 domain (scale * log2 e folded in).
// The TPU kernel's grouped K/V gather ring, LUT rings and (B*H) fold with
// head-dim padding are not carried over: the kernel reads (B, L, H, Dh)
// through strides, loops over exactly `sel` LUT entries, skips the chunks
// that lie wholly past kv_len, zero-fills rows past kv_len, masks columns
// >= kv_len to -1e30 before the row max, and never writes rows past Lq.
//
// K14 needs two things a CUDA block cannot carry across the grid the way the
// TPU's sequential grid carries its o scratch: the RMS of the whole
// H*128-wide row before any head's QK, and the absmax over every head's
// output before any int8 store. So the C = H / G blocks that own one row
// tile (G heads each, C <= 8) run as one thread-block cluster: each sums the
// squares of its G heads' columns, and reads the other blocks' partial sums
// through distributed shared memory; each keeps its heads' fp32 outputs in
// shared memory (34 KB a head), reduces their row maxima, and reads the
// others' the same way before it quantises its own columns (the 1.3B's 12
// heads: clusters of 6 blocks of 2 heads; up to 40 heads fit, 5 a block).
// K17 is the same kernel with the RMS read from K15's output instead of the
// cluster's exchange of sums of squares; the absmax exchange stays (at 40
// heads: clusters of 8 blocks of 5 heads, 204 KB of shared memory a block).
// It keeps the TPU kernel's exact softmax: a first pass over the keys takes
// each row's max of the scaled logits, the second computes P = exp(s - max),
// rounds it to bf16 for P V and divides by the fp32 row sum (no online
// rescaling, so P rounds where the JAX kernel rounds it). The logit scale
// multiplies in fp32 (s * scale) and exp is expf, as the plain version
// computes them. The first pass costs a second QK product and K stream.
// A first, simple version: loads are synchronous (no cp.async/TMA ring) and
// there is no wgmma; both are later work.
//
// K20 tdx_sparse_flash_attention_i8qk replaces the int8-QK sparse branch of
//    flash_pallas.py:_flash_fwd_impl for blocks < 128 (body
//    _sparse_attn_kernel with int8_qk=True), which sagesla at --sla_block 64
//    takes: K3's gather, with Q quantised per row once (qq = round(q * (127 /
//    qa)), qa = max(max |q|, 1e-6)) and every gathered K row the same way, so
//    QK runs on mma.sync m16n8k32 s8 x s8 -> s32 (exact) and
//    s = ((s32 * (qa / 127)) * (ka / 127)) * Dh^-0.5 in fp32; natural exp
//    (the TPU kernel's domain), P in bf16 against bf16 V, o = O / max(l,
//    1e-20). The caller subtracts K's mean first (smooth-k, plain torch).
//    Bound by tensor-core math like K3 (at 64/64 and 1.3B 480p: 51 of 512
//    K-blocks a Q-block, 3.3e11 int8 + 3.3e11 bf16 operations), but a
//    64-row block gathers ~1.6 MB of K and V from device memory (one 64-key
//    chunk a LUT entry, ~10 GB a call), which the 50 MB L2 serves while
//    the heads run in order (a head's K and V are 16.8 MB). A K row's int8
//    values do not depend on the Q block that gathers it, so a first
//    launch quantises every K row once (a warp a row, a lane 4 channels, the
//    row's absmax one warp reduction) into (B, H, Lk, 128) int8 and its
//    scale, and the gather stages int8 K rows as K7 does, where the TPU
//    kernel requantises each gathered block (at 64/64 each K row is
//    gathered by ~51 Q blocks); V is staged transposed as K3 stages it.
//    Keys at or past kv_len are zero-filled and masked to -1e30 before the
//    row max;
//    JAX's LUT padding to a group (block nK, past K's end) has no
//    counterpart: the kernel loops over exactly `sel` entries.
// K30 tdx_flash_attention_i8qk replaces the dense branch of _flash_fwd_impl
//    with int8 QK (launch :1139, body _attn_kernel with int8_qk=True), which
//    flash_attention(..., int8_qk=True) without a LUT takes: K20's function
//    over every key of [0, kv_len) instead of the LUT's blocks (the same
//    kernel, its chunk walk a template flag; the same first launch
//    quantising each K row once). The caller subtracts K's mean first, as
//    JAX's flash_attention does. Bound by tensor-core math: at the 1.3B
//    480p dense self shape (12 heads, 32,760 x 32,760) 3.3e12 int8 and
//    3.3e12 bf16 operations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 128;            // head dim
constexpr int kBM = 64;             // query rows per block
constexpr int kBN = 64;             // keys per chunk
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kKStride = kDh + 8;   // padded row of Ks (and Q staging)
constexpr int kVStride = kBN + 8;   // padded row of Vt
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, l, h;
};

// Copy a kBM x kDh tile of rows [row0, row0 + kBM) into dst (row stride
// kKStride), zero-filling rows >= nrows. 16 bytes per thread per step,
// neighbouring threads on neighbouring addresses.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, Strides s,
                                          int row0, int nrows) {
  constexpr int kVec = kDh / 8;  // uint4 per row
#pragma unroll
  for (int i = 0; i < kBM * kVec / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kVec, c8 = idx % kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * s.l + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * kKStride + c8 * 8) = val;
  }
}

// Copy a kBN x kDh V chunk into Vt (kDh rows of kVStride keys), transposed.
// Threads walk keys fastest so the 2-byte shared stores are conflict-free.
__device__ __forceinline__ void load_v_transposed(__nv_bfloat16* vt,
                                                  const __nv_bfloat16* src,
                                                  Strides s, int key0, int kv_len) {
  constexpr int kVec = kDh / 8;
#pragma unroll
  for (int i = 0; i < kBN * kVec / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx % kBN, c8 = idx / kBN;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (key0 + r < kv_len)
      val = *reinterpret_cast<const uint4*>(src + (long long)(key0 + r) * s.l + c8 * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c8 * 8 + j) * kVStride + r] = e[j];
  }
}

// SPARSE: chunks come from the LUT row of this block's Q-block; else all
// chunks of [0, kv_len).
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ lut, int H, int Lq, int kv_len, int nQ,
                 int sel, int block_q, int block_k, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 Vt[kDh * kVStride];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // Q fragments (A operand, 16 rows x 128) via the Ks buffer as staging.
  load_rows(Ks, qb, qs, row0, Lq);
  __syncthreads();
  uint32_t qa[kDh / 16][4];
  {
    const __nv_bfloat16* base = Ks + (warp * 16) * kKStride;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      qa[kk][0] = lds32(base + g * kKStride + kk * 16 + t * 2);
      qa[kk][1] = lds32(base + (g + 8) * kKStride + kk * 16 + t * 2);
      qa[kk][2] = lds32(base + g * kKStride + kk * 16 + 8 + t * 2);
      qa[kk][3] = lds32(base + (g + 8) * kKStride + kk * 16 + 8 + t * 2);
    }
  }

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  const int* lut_row = nullptr;
  int n_chunks;
  if (SPARSE) {
    lut_row = lut + (((long long)b * H + h) * nQ + row0 / block_q) * sel;
    n_chunks = sel * (block_k / kBN);
  } else {
    n_chunks = (kv_len + kBN - 1) / kBN;
  }

  for (int c = 0; c < n_chunks; ++c) {
    int key0;
    if (SPARSE) {
      const int per = block_k / kBN;
      key0 = lut_row[c / per] * block_k + (c % per) * kBN;
      // wholly past the tail (or an id out of range): no valid column
      if (key0 < 0 || key0 >= kv_len) continue;
    } else {
      key0 = c * kBN;
    }
    __syncthreads();  // previous chunk (or the Q staging) fully consumed
    load_rows(Ks, kb, ks, key0, kv_len);
    load_v_transposed(Vt, vb, vs, key0, kv_len);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * kKStride + kk * 16 + t * 2;
        mma_bf16(s[j], qa[kk], lds32(kp), lds32(kp + 8));
      }
    }

    // scale (log2 domain), mask columns past kv_len; the softmax step and
    // O += P V with P (bf16) taken from the S accumulators
    const int nvalid = kv_len - key0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        s[j][e] = col < nvalid ? s[j][e] * scale_log2 : kNegInf;
      }
    softmax_pv_step<true, kVStride>(s, acc, m0, m1, l0, l1, Vt);
  }

  // finalize: full row sums over the quad, normalise, write rows < Lq
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os.l + col) =
          pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os.l + col) =
          pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// K20
// ---------------------------------------------------------------------------

constexpr int kI8Stride = kDh + 16;   // bytes per int8 row of Qi / Ki

// One row's channels 4 lane .. 4 lane + 3 (a warp a row) -> their int8
// values packed in a word, quantised per row as the TPU kernel does:
// round(x * (127 / amax)), amax = max(max |x|, 1e-6); `scale` gets amax / 127
// (the same in every lane).
__device__ __forceinline__ uint32_t quant_row4_i8(uint2 u, float& scale) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p2[0]), c = __bfloat1622float2(p2[1]);
  const float f[4] = {a.x, a.y, c.x, c.y};
  float amax = fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-6f);
  const float mul = __fdiv_rn(127.f, amax);
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = max(-127, min(127, __float2int_rn(__fmul_rn(f[e], mul))));
    w |= (uint32_t)(q & 0xff) << (8 * e);
  }
  scale = __fdiv_rn(amax, 127.f);
  return w;
}

// Rows [row0 + 16 warp, + 16) of src (row stride sl, zero past nrows) ->
// int8 rows of dst by quant_row4_i8, each row's scale into scale[]. The
// warp issues its 16 rows' loads before it reduces any, so it waits on
// memory once a chunk rather than once a row.
__device__ __forceinline__ void quant_rows_i8(int8_t* dst, float* scale,
                                              const __nv_bfloat16* src, long long sl,
                                              int row0, int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint2 u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = row0 + warp * 16 + i;
    u[i] = r < nrows ? *reinterpret_cast<const uint2*>(src + (long long)r * sl + lane * 4)
                     : make_uint2(0, 0);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float sc;
    *reinterpret_cast<uint32_t*>(dst + r * kI8Stride + lane * 4) = quant_row4_i8(u[i], sc);
    if (lane == 0) scale[r] = sc;
  }
}

// K20's first launch: every K row (b, l, h), read through strides, ->
// int8 kq (B, H, Lk, 128) and ka / 127 (B, H, Lk) by quant_row4_i8 (a warp a
// row), so the gather reads the values the TPU kernel computes for each
// gathered block.
__global__ void __launch_bounds__(256)
i8qk_quant_k_kernel(const __nv_bfloat16* __restrict__ k, int8_t* __restrict__ kq,
                    float* __restrict__ ksc, int Lk, Strides ks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (l >= Lk) return;
  const uint2 u = *reinterpret_cast<const uint2*>(k + b * ks.b + h * ks.h + l * ks.l + lane * 4);
  float sc;
  const uint32_t w = quant_row4_i8(u, sc);
  const size_t row = ((size_t)b * gridDim.y + h) * Lk + l;
  *reinterpret_cast<uint32_t*>(kq + row * kDh + lane * 4) = w;
  if (lane == 0) ksc[row] = sc;
}

// K20 (SPARSE: the chunks of this Q-block's LUT row) and K30 (every chunk
// of [0, kv_len)). Grid (ceil(Lq / 64), H, B), 4 warps of 16 query rows.
template <bool SPARSE>
__global__ void __launch_bounds__(kThreads)
flash_i8qk_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
                         const float* __restrict__ ksc, const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, const int* __restrict__ lut, int H,
                         int Lq, int Lk, int kv_len, int nQ, int sel, int block_q, int block_k,
                         Strides qs, Strides vs, Strides os, float scale) {
  __shared__ __align__(16) int8_t Ki[kBN * kI8Stride];       // Q staging, then K chunks
  __shared__ __align__(16) __nv_bfloat16 Vt[kDh * kVStride];
  __shared__ float s_qa[kBM], s_ka[kBN];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const size_t bh = (size_t)b * H + h;
  const int8_t* kqb = kq + bh * Lk * kDh;
  const float* kab = ksc + bh * Lk;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // Q rows -> int8 A fragments (m16n8k32), their scales qa / 127
  quant_rows_i8(Ki, s_qa, qb, qs.l, row0, Lq);
  __syncthreads();
  uint32_t qa[kDh / 32][4];
  {
    const int8_t* base = Ki + (warp * 16) * kI8Stride;
#pragma unroll
    for (int kk = 0; kk < kDh / 32; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * kI8Stride + kk * 32 + t * 4);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * kI8Stride + kk * 32 + t * 4);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * kI8Stride + kk * 32 + 16 + t * 4);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * kI8Stride + kk * 32 + 16 + t * 4);
    }
  }
  const float qa0 = s_qa[warp * 16 + g], qa1 = s_qa[warp * 16 + g + 8];

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;

  const int* lut_row = SPARSE ? lut + (bh * nQ + row0 / block_q) * sel : nullptr;
  const int per = block_k / kBN;
  const int n_chunks = SPARSE ? sel * per : (kv_len + kBN - 1) / kBN;
  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = SPARSE ? lut_row[c / per] * block_k + (c % per) * kBN : c * kBN;
    // wholly past the tail (or an id out of range): no valid column
    if (key0 < 0 || key0 >= kv_len) continue;
    __syncthreads();  // previous chunk (or the Q fragments' staging) consumed
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u >> 3, cc = u & 7;
      *reinterpret_cast<uint4*>(Ki + r * kI8Stride + cc * 16) =
          key0 + r < kv_len
              ? *reinterpret_cast<const uint4*>(kqb + (size_t)(key0 + r) * kDh + cc * 16)
              : make_uint4(0, 0, 0, 0);
    }
    if (threadIdx.x < kBN)
      s_ka[threadIdx.x] = key0 + threadIdx.x < kv_len ? kab[key0 + threadIdx.x] : 0.f;
    load_v_transposed(Vt, vb, vs, key0, kv_len);
    __syncthreads();

    // s = ((s32 * qa') * ka') * scale for this warp's 16 rows x 64 keys
    const int nvalid = kv_len - key0;
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < kDh / 32; ++kk) {
        const int8_t* kq = Ki + (j * 8 + g) * kI8Stride + kk * 32 + t * 4;
        mma_s8(si, qa[kk], *reinterpret_cast<const uint32_t*>(kq),
               *reinterpret_cast<const uint32_t*>(kq + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float x = __fmul_rn(__fmul_rn(__fmul_rn((float)si[e], e < 2 ? qa0 : qa1),
                                            s_ka[col]), scale);
        s[j][e] = col < nvalid ? x : kNegInf;
      }
    }
    // natural exp; O += P V with P (bf16) from the S accumulators
    softmax_pv_step<false, kVStride>(s, acc, m0, m1, l0, l1, Vt);
  }

  // finalize: full row sums over the quad, o = O / max(l, 1e-20), rows < Lq
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os.l + col) =
          pack_bf16(__fdiv_rn(acc[d][0], l0), __fdiv_rn(acc[d][1], l0));
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os.l + col) =
          pack_bf16(__fdiv_rn(acc[d][2], l1), __fdiv_rn(acc[d][3], l1));
  }
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

constexpr int kOStride = kDh + 8;             // padded fp32 row of the o buffer
constexpr int kQoutMaxCluster = 8;            // portable cluster size
constexpr int kQoutStageBytes = (kBN * kKStride + kDh * kVStride) * 2;
constexpr float kInvInt8 = 1.0f / 127.0f;

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

__device__ __forceinline__ uint32_t to_u8(float v) {
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, __float2int_rn(v)));
}

// S = Q K^T for one warp's 16 rows x kBN keys of the chunk in Ks, scaled in
// fp32 and masked past nvalid.
__device__ __forceinline__ void qk_chunk(float (&s)[kBN / 8][4], const uint32_t (&qa)[kDh / 16][4],
                                         const __nv_bfloat16* Ks, int g, int t, int nvalid,
                                         float scale) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const __nv_bfloat16* kp = Ks + (j * 8 + g) * kKStride + kk * 16 + t * 2;
      mma_bf16(s[j], qa[kk], lds32(kp), lds32(kp + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + t * 2 + (e & 1);
      s[j][e] = col < nvalid ? __fmul_rn(s[j][e], scale) : kNegInf;
    }
  }
}

// Grid (n_tiles * C, B), clusters of C blocks along x: block rank r of tile
// `tile` owns rows [64 tile, 64 tile + 64) and heads [r G, r G + G).
// EXT_RMS (K17): the rows' RMS inverse is ri (B, Lq); else (K14) the cluster
// computes it.
template <bool EXT_RMS>
__global__ void __launch_bounds__(kThreads)
cross_qout_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ norm_w,
                  const float* __restrict__ ri, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, int8_t* __restrict__ out_q,
                  float* __restrict__ out_s, long long ldq, int Lq, int kv_len, int H, int G,
                  Strides ks, Strides vs, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // K chunk / Q staging
  __nv_bfloat16* Vt = Ks + kBN * kKStride;
  float* Ob = reinterpret_cast<float*>(smem + kQoutStageBytes);   // G x kBM x kOStride
  __shared__ float s_part[kBM];   // this block's share of a row statistic
  __shared__ float s_row[kBM];    // the row's rms, then its int8 scale

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * kBM;
  const int b = blockIdx.y;
  const int HD = H * kDh, width = G * kDh, col0 = rank * width;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + (long long)b * Lq * ldq;

  // 1. the full-row RMS: partial sums of squares over this block's columns,
  // then over the cluster's blocks in rank order. A warp owns 16 rows and
  // issues all their loads before it reduces, so it waits on memory once a
  // 256-column slab rather than once a row. K17 reads it.
  if (EXT_RMS) {
    if (threadIdx.x < kBM)
      s_row[threadIdx.x] = row0 + threadIdx.x < Lq ? ri[(long long)b * Lq + row0 + threadIdx.x] : 0.f;
  }
  for (int c0 = 0; !EXT_RMS && c0 < width; c0 += 256) {
    const int c = c0 + lane * 8;
    uint4 u[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      u[i] = make_uint4(0, 0, 0, 0);
      if (row0 + r < Lq && c < width)
        u[i] = *reinterpret_cast<const uint4*>(qb + (long long)(row0 + r) * ldq + col0 + c);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float f[8];
      unpack8(u[i], f);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e] * f[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) s_part[warp * 16 + i] = c0 ? s_part[warp * 16 + i] + s : s;
    }
  }
  if (!EXT_RMS) {
    cluster.sync();
    if (threadIdx.x < kBM) {
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(&s_part[threadIdx.x], r);
      s_row[threadIdx.x] = rsqrtf(s / HD + eps);
    }
  }
  cluster.sync();  // s_row visible; every block has read s_part before its reuse

  const int n_chunks = (kv_len + kBN - 1) / kBN;
  float amax0 = 0.f, amax1 = 0.f;  // |o| maxima of rows warp*16 + g and + 8
  for (int hl = 0; hl < G; ++hl) {
    const int h = rank * G + hl;
    const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

    // 2. this head's normed Q slice, staged in Ks: bf16(x * rms) * w in bf16
    __syncthreads();  // the previous head's last chunk consumed
#pragma unroll
    for (int i = 0; i < kBM * (kDh / 8) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kDh / 8), c8 = (idx % (kDh / 8)) * 8;
      float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row0 + r < Lq) {
        float f[8], w[8];
        unpack8(*reinterpret_cast<const uint4*>(qb + (long long)(row0 + r) * ldq + h * kDh + c8), f);
        unpack8(*reinterpret_cast<const uint4*>(norm_w + h * kDh + c8), w);
        const float rms = s_row[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = round_bf16(__fmul_rn(round_bf16(__fmul_rn(f[e], rms)), w[e]));
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) pw[e] = pack_bf16(y[2 * e], y[2 * e + 1]);
      *reinterpret_cast<uint4*>(Ks + r * kKStride + c8) = packed;
    }
    __syncthreads();
    uint32_t qa[kDh / 16][4];
    {
      const __nv_bfloat16* base = Ks + (warp * 16) * kKStride;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        qa[kk][0] = lds32(base + g * kKStride + kk * 16 + t * 2);
        qa[kk][1] = lds32(base + (g + 8) * kKStride + kk * 16 + t * 2);
        qa[kk][2] = lds32(base + g * kKStride + kk * 16 + 8 + t * 2);
        qa[kk][3] = lds32(base + (g + 8) * kKStride + kk * 16 + 8 + t * 2);
      }
    }

    // 3. pass 1: each row's exact max of the scaled, masked logits. It reads
    // K alone, so the V buffer is free: K chunks double-buffer in Ks and Vt
    // and chunk c + 1 lands while chunk c is multiplied.
    float m0 = kNegInf, m1 = kNegInf;
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      load_rows(Ks, kb, ks, c * kBN, kv_len);
      __syncthreads();
      float s[kBN / 8][4];
      qk_chunk(s, qa, Ks, g, t, kv_len - c * kBN, scale);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }

    // 4. pass 2: P = exp(s - max) in fp32, its row sum, O += bf16(P) V
    float acc[kDh / 8][4];
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int key0 = c * kBN;
      __syncthreads();
      load_rows(Ks, kb, ks, key0, kv_len);
      load_v_transposed(Vt, vb, vs, key0, kv_len);
      __syncthreads();
      float s[kBN / 8][4];
      qk_chunk(s, qa, Ks, g, t, kv_len - key0, scale);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[j][0] = expf(s[j][0] - m0);
        s[j][1] = expf(s[j][1] - m0);
        s[j][2] = expf(s[j][2] - m1);
        s[j][3] = expf(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int d = 0; d < kDh / 8; ++d) {
          const __nv_bfloat16* vp = Vt + (d * 8 + g) * kVStride + kk * 16 + t * 2;
          mma_bf16(acc[d], pa, lds32(vp), lds32(vp + 8));
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    l0 = fmaxf(l0, 1e-20f);
    l1 = fmaxf(l1, 1e-20f);

    // 5. o = O / l in fp32 into this head's o buffer; the rows' |o| maxima
    float* ob = Ob + (hl * kBM + warp * 16 + g) * kOStride;
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      const float2 o0 = make_float2(__fdiv_rn(acc[d][0], l0), __fdiv_rn(acc[d][1], l0));
      const float2 o1 = make_float2(__fdiv_rn(acc[d][2], l1), __fdiv_rn(acc[d][3], l1));
      amax0 = fmaxf(amax0, fmaxf(fabsf(o0.x), fabsf(o0.y)));
      amax1 = fmaxf(amax1, fmaxf(fabsf(o1.x), fabsf(o1.y)));
      *reinterpret_cast<float2*>(ob + d * 8 + t * 2) = o0;
      *reinterpret_cast<float2*>(ob + 8 * kOStride + d * 8 + t * 2) = o1;
    }
  }

  // 6. each row's absmax over the cluster's heads -> its int8 scale
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    amax0 = fmaxf(amax0, __shfl_xor_sync(0xffffffffu, amax0, off));
    amax1 = fmaxf(amax1, __shfl_xor_sync(0xffffffffu, amax1, off));
  }
  if (t == 0) {
    s_part[warp * 16 + g] = amax0;
    s_part[warp * 16 + g + 8] = amax1;
  }
  cluster.sync();
  if (threadIdx.x < kBM) {
    float m = 0.f;
    for (int r = 0; r < C; ++r) m = fmaxf(m, *cluster.map_shared_rank(&s_part[threadIdx.x], r));
    s_row[threadIdx.x] = __fmul_rn(fmaxf(m, 1e-8f), kInvInt8);
  }
  cluster.sync();  // remote reads done before any block exits; s_row visible

  // 7. this block's columns of each live row as int8, 8 bytes a thread
  const int cpr = width / 8;
  for (int idx = threadIdx.x; idx < kBM * cpr; idx += kThreads) {
    const int r = idx / cpr, c = idx % cpr;
    if (row0 + r >= Lq) continue;
    const float inv = 1.f / s_row[r];
    const float* src = Ob + ((c / (kDh / 8)) * kBM + r) * kOStride + (c % (kDh / 8)) * 8;
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w0 |= to_u8(__fmul_rn(src[e], inv)) << (8 * e);
      w1 |= to_u8(__fmul_rn(src[4 + e], inv)) << (8 * e);
    }
    *reinterpret_cast<uint2*>(out_q + ((long long)b * Lq + row0 + r) * HD + col0 + c * 8) =
        make_uint2(w0, w1);
  }
  if (rank == 0 && threadIdx.x < kBM && row0 + threadIdx.x < Lq)
    out_s[(long long)b * Lq + row0 + threadIdx.x] = s_row[threadIdx.x];
}

}  // namespace

extern "C" int tdx_sparse_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* lut,
    int B, int H, int Lq, int kv_len, int nQ, int sel, int block_q, int block_k,
    long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
    long long ksh, long long vsb, long long vsl, long long vsh, long long osb,
    long long osl, long long osh, float scale, void* stream) {
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (const int*)lut, H, Lq, kv_len, nQ, sel, block_q, block_k,
      Strides{qsb, qsl, qsh}, Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
      Strides{osb, osl, osh}, scale * kLog2e);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_flash_attention_i8qk(
    const void* q, const void* k, const void* v, void* o, const void* lut, void* kq,
    void* ksc, int B, int H, int Lq, int Lk, int kv_len, int nQ, int sel, int block_q,
    int block_k, long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
    long long ksh, long long vsb, long long vsl, long long vsh, long long osb,
    long long osl, long long osh, float scale, void* stream) {
  if (block_q % kBM || block_k % kBN || kv_len > Lk) return (int)cudaErrorInvalidValue;
  i8qk_quant_k_kernel<<<dim3((Lk + 7) / 8, H, B), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (int8_t*)kq, (float*)ksc, Lk, Strides{ksb, ksl, ksh});
  const int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_i8qk_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ksc, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (const int*)lut, H, Lq, Lk, kv_len, nQ, sel, block_q, block_k,
      Strides{qsb, qsl, qsh}, Strides{vsb, vsl, vsh}, Strides{osb, osl, osh}, scale);
  return (int)cudaGetLastError();
}

extern "C" int tdx_flash_attention_i8qk(
    const void* q, const void* k, const void* v, void* o, void* kq, void* ksc, int B, int H,
    int Lq, int Lk, int kv_len, long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl, long long vsh, long long osb,
    long long osl, long long osh, float scale, void* stream) {
  if (kv_len <= 0 || kv_len > Lk) return (int)cudaErrorInvalidValue;
  i8qk_quant_k_kernel<<<dim3((Lk + 7) / 8, H, B), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (int8_t*)kq, (float*)ksc, Lk, Strides{ksb, ksl, ksh});
  const int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_i8qk_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ksc, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, nullptr, H, Lq, Lk, kv_len, 0, 0, kBN, kBN,
      Strides{qsb, qsl, qsh}, Strides{vsb, vsl, vsh}, Strides{osb, osl, osh}, scale);
  return (int)cudaGetLastError();
}

extern "C" int tdx_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
    int kv_len, long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
    long long osb, long long osl, long long osh, float scale, void* stream) {
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, nullptr, H, Lq, kv_len, 0, 0, 0, 0, Strides{qsb, qsl, qsh},
      Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, Strides{osb, osl, osh},
      scale * kLog2e);
  return (int)cudaGetLastError();
}


namespace {

template <bool EXT_RMS>
int launch_cross_qout(const void* q, const void* norm_w, const void* ri, const void* k,
                      const void* v, void* out_q, void* out_s, long long ldq, int B, int H,
                      int G, int Lq, int kv_len, Strides ks, Strides vs, float scale, float eps,
                      void* stream) {
  // G heads a block, C = H / G blocks a cluster (portable: at most 8)
  if (G <= 0 || H % G || H / G > kQoutMaxCluster || ldq % 8 || kv_len <= 0 || Lq <= 0)
    return (int)cudaErrorInvalidValue;
  const int C = H / G;
  const int smem = kQoutStageBytes + G * kBM * kOStride * 4;
  cudaError_t err = cudaFuncSetAttribute(cross_qout_kernel<EXT_RMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((Lq + kBM - 1) / kBM) * C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cross_qout_kernel<EXT_RMS>, (const __nv_bfloat16*)q,
                           (const __nv_bfloat16*)norm_w, (const float*)ri,
                           (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (int8_t*)out_q,
                           (float*)out_s, ldq, Lq, kv_len, H, G, ks, vs, scale, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdx_cross_attention_qout(const void* q, const void* norm_w, const void* k,
                                        const void* v, void* out_q, void* out_s,
                                        long long ldq, int B, int H, int G, int Lq,
                                        int kv_len, long long ksb, long long ksl,
                                        long long ksh, long long vsb, long long vsl,
                                        long long vsh, float scale, float eps,
                                        void* stream) {
  return launch_cross_qout<false>(q, norm_w, nullptr, k, v, out_q, out_s, ldq, B, H, G, Lq,
                                  kv_len, Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                                  scale, eps, stream);
}

extern "C" int tdx_cross_attention_qout_wide(const void* q, const void* norm_w, const void* ri,
                                             const void* k, const void* v, void* out_q,
                                             void* out_s, long long ldq, int B, int H, int G,
                                             int Lq, int kv_len, long long ksb, long long ksl,
                                             long long ksh, long long vsb, long long vsl,
                                             long long vsh, float scale, void* stream) {
  return launch_cross_qout<true>(q, norm_w, ri, k, v, out_q, out_s, ldq, B, H, G, Lq, kv_len,
                                 Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, scale, 0.f,
                                 stream);
}
