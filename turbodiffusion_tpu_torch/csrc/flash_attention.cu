// K3 and K4: bf16 flash attention forward for sm_90a, block-sparse and dense.
//
// K3 tdx_sparse_flash_attention replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:_flash_fwd_impl, bf16 sparse
//    branch (body _sparse_attn_kernel): each block_q-row Q-block attends only
//    to the `sel` K-blocks of block_k rows that its LUT row names.
// K4 tdx_flash_attention replaces the dense branches of the same function
//    (bodies _attn_kernel_onepass and _attn_kernel without int8 QK):
//    softmax attention over all kv_len keys (cross-attention over the 512
//    text tokens; self-attention under --attention_type original).
//
// What bounds them on an H100: tensor-core math. At the 1.3B 480p shape a K3
// call is ~6.2e11 FLOPs over ~100 MB of q/k/v, and a K4 cross call ~1.0e11
// FLOPs, both well above the ridge. The design is FlashAttention-2 on
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
// A first, simple version: loads are synchronous (no cp.async/TMA ring) and
// there is no wgmma; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

    // scale, mask columns past kv_len, row max over the quad
    const int nvalid = kv_len - key0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        s[j][e] = col < nvalid ? s[j][e] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // O += P V: P (bf16) comes from the S accumulators as A fragments.
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
