// K8-K11: the W8A8 "postscale" linears for sm_90a.
//
// K8  tdx_quantize_rows_int8 replaces the TPU kernel
//     turbodiffusion_tpu/ops/quant.py:quantize_rows_int8_pallas (body
//     _rowquant_kernel): a (M, K) bf16 activation -> int8 (M, K) and one fp32
//     scale per row, in fp32: scale = max(amax, 1e-8) * (1/127),
//     q = round-half-even(x * (1/scale)), no clip (none is needed: |x| * (1/scale)
//     rounds to at most 127).
// K9  tdx_int8_gemm_postscale replaces quant.py:int8_gemm_postscale_pallas
//     (_postscale_gemm_kernel, with its weight-resident form _postscale_wres):
//     s8 (M, K) x s8 (K, N) -> exact s32, then in fp32
//     ((acc * rs[m]) * cs[n]) (+ bias[n]) (GELU-tanh) (* gate[n]) (+ res[m, n]),
//     one cast to bf16 at the end.
// K10 tdx_int8_gemm_qout replaces quant.py:int8_gemm_postscale_qout_pallas
//     (_postscale_gemm_qout_kernel, _qout_wres): K9's product and epilogue up
//     to the GELU, then int8 with one fp32 scale per (row, BNQ columns), BNQ =
//     _pick_bn_div(N) (896 for the 1.3B FFN), taken from the fp32 values.
// K11 tdx_int8_gemm_blockact replaces quant.py:int8_gemm_blockact_pallas
//     (_blockact_gemm_kernel, _blockact_wres): the product over a per-(row,
//     bk-slab) scaled int8 activation: acc_f32 = sum over slabs of
//     float(s32 slab product) * xs[m, slab], in slab order, then K9's
//     epilogue from the col scale on.
//
// What bounds them on an H100. K8 is memory-bound: at (32,760, 1,536) it
// reads 100.6 MB and writes 50.4 MB, 0.045 ms at 3.35 TB/s; one warp per
// row, 16-byte loads, the row re-read from L1 for the quantise. K9-K11 are
// bound by int8 tensor-core math (2*M*N*K operations: 4.64e11 for the fused
// QKV, 9.02e11 for fc1 / fc2, 0.23-0.46 ms at 1,979 TOP/s). The design is
// one main loop for all three:
//   * a 128 x 128 output tile per 256-thread block, 8 warps of 64 x 32;
//   * a 4-stage cp.async ring of 64-byte K slices of both operands in shared
//     memory (rows padded to 80 bytes, so ldmatrix reads hit 32 banks); rows
//     of A past M are zero-filled;
//   * ldmatrix.x4 fragments and mma.sync.m16n8k32 s8 x s8 -> s32, exact
//     (|127 * 127 * 8960| < 2^31); the weight is stored (N, K), K-contiguous,
//     which is the "col" operand layout mma.sync reads;
//   * K11 moves the s32 accumulators into fp32 ones at every slab edge
//     (bk = 896 = 14 K slices, so no slice straddles a slab);
//   * K10's per-(row, 896) scale spans 7 output tiles: the 7 blocks of one
//     stripe run as one thread-block cluster, reduce each row's amax over
//     their 128 columns in shared memory, read the other blocks' maxima
//     through distributed shared memory, and each quantises its own tile.
//     No fp32 stripe is written to memory and no block holds 896 columns.
// Products the plain version rounds one by one use __fmul_rn / __fadd_rn so
// nvcc does not contract them. Outputs are written to fresh buffers (the
// residual may be the caller's trunk). A first, simple version: mma.sync, no
// wgmma or TMA, and fragment-wise stores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInvInt8 = 1.0f / 127.0f;
constexpr float kGeluC = 0.7978845608028654f;  // fp32 sqrt(2 / pi)

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kRqWarps = 8;

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ int8_t to_i8(float v) {
  // the product is at most 127 * (1 + 2^-23) in magnitude: rounds into range
  return (int8_t)max(-127, min(127, __float2int_rn(v)));
}

__global__ void __launch_bounds__(kRqWarps * 32)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, long long ld,
                     int8_t* __restrict__ xq, float* __restrict__ rs, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRqWarps + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * ld;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  int8_t* qr = xq + (size_t)row * K;
  for (int c = lane * 8; c < K; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e >> 2] |= (uint32_t)(uint8_t)to_i8(__fmul_rn(f[e], inv)) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) rs[row] = scale;
}

// ---------------------------------------------------------------------------
// K9-K11: the int8 GEMM
// ---------------------------------------------------------------------------

enum Mode { kPostscale = 0, kQout = 1, kBlockact = 2 };

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 256;
constexpr int WARPS_N = 4, WM = 64, WN = 32;
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int SROW = BK + 16;                  // bytes per shared row
constexpr int STAGE_BYTES = (BM + BN) * SROW;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

struct GemmParams {
  const int8_t* a;          // (M, K) int8
  const int8_t* w;          // (N, K) int8
  const float* rs;          // (M,) row scales (K9, K10)
  const float* xs;          // (M, K / bk) slab scales (K11)
  const float* cs;          // (N,) col scales
  const float* bias;        // (N,) or null
  const float* gate;        // (N,) or null
  const __nv_bfloat16* res; // (M, N) or null
  __nv_bfloat16* out;       // (M, N) bf16 (K9, K11)
  int8_t* out_q;            // (M, N) int8 (K10)
  float* out_s;             // (M, N / BNQ) fp32 (K10)
  int M, N, K, bk, act;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fadd_rn(x, __fmul_rn(0.044715f, cube));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(__fmul_rn(kGeluC, inner)))));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const GemmParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = p.K / BK;

  auto load_tile = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sw = sa + BM * SROW;
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c >> 2, cc = c & 3;
      const int gm = m0 + r;
      // rows past M: zero-filled from a valid address
      const int8_t* src = p.a + (size_t)min(gm, p.M - 1) * p.K + k0 + cc * 16;
      cp_async16(sa + r * SROW + cc * 16, src, gm < p.M ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < BN * (BK / 16); c += THREADS) {
      const int r = c >> 2, cc = c & 3;
      cp_async16(sw + r * SROW + cc * 16, p.w + (size_t)(n0 + r) * p.K + k0 + cc * 16, 16);
    }
  };

  int acc[MT][NT][4];
  float facc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

  // rows of this thread's accumulators: i-th m tile, e < 2 -> g, else g + 8
  int rows[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    rows[i][0] = m0 + wm * WM + i * 16 + g;
    rows[i][1] = rows[i][0] + 8;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1's stage is free
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sw = sa + BM * SROW;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sa + (wm * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW +
                               kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, sw + (wn * WN + jp * 16 + (lane & 7) + (lane >> 4) * 8) * SROW +
                           kk * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if constexpr (MODE == kBlockact) {
      if (((kt + 1) * BK) % p.bk == 0) {  // a slab ends: rescale into fp32
        const int slab = (kt + 1) * BK / p.bk - 1;
        const int n_slab = p.K / p.bk;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float xsv[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xsv[h] = p.xs[(size_t)min(rows[i][h], p.M - 1) * n_slab + slab];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              facc[i][j][e] = __fadd_rn(facc[i][j][e], __fmul_rn((float)acc[i][j][e], xsv[e >> 1]));
              acc[i][j][e] = 0;
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue in fp32: the values v[i][j][e] (reusing facc)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float rsv[2] = {1.f, 1.f};
    if constexpr (MODE != kBlockact) {
      rsv[0] = p.rs[min(rows[i][0], p.M - 1)];
      rsv[1] = p.rs[min(rows[i][1], p.M - 1)];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WN + j * 8 + t * 2;
      const float2 csv = *reinterpret_cast<const float2*>(p.cs + col);
      float2 bv = make_float2(0.f, 0.f);
      if (p.bias) bv = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = MODE == kBlockact ? facc[i][j][e]
                                    : __fmul_rn((float)acc[i][j][e], rsv[e >> 1]);
        v = __fmul_rn(v, (e & 1) ? csv.y : csv.x);
        if (p.bias) v = __fadd_rn(v, (e & 1) ? bv.y : bv.x);
        if (p.act) v = gelu_tanh(v);
        facc[i][j][e] = v;
      }
    }
  }

  if constexpr (MODE == kQout) {
    // per-row amax over this tile's 128 columns, then over the cluster's
    __shared__ float s_part[WARPS_N][BM];
    __shared__ float s_tile[BM];
    __shared__ float s_row[BM];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          m = fmaxf(m, fmaxf(fabsf(facc[i][j][2 * h]), fabsf(facc[i][j][2 * h + 1])));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0) s_part[wn][wm * WM + i * 16 + g + 8 * h] = m;
      }
    __syncthreads();
    if (tid < BM) {
      float m = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS_N; ++w) m = fmaxf(m, s_part[w][tid]);
      s_tile[tid] = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every tile's maxima written
    const int csize = (int)cluster.num_blocks();
    if (tid < BM) {
      float m = 0.f;
      for (int r = 0; r < csize; ++r) m = fmaxf(m, *cluster.map_shared_rank(&s_tile[tid], r));
      s_row[tid] = m;
    }
    cluster.sync();  // remote reads done before any block exits; s_row visible
    const int n_q = p.N / (BN * csize);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * WM + i * 16 + g + 8 * h;
        const int row = rows[i][h];
        if (row >= p.M) continue;
        const float scale = __fmul_rn(fmaxf(s_row[lr], 1e-8f), kInvInt8);
        const float inv = 1.f / scale;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn * WN + j * 8 + t * 2;
          const uint16_t pair =
              (uint16_t)(uint8_t)to_i8(__fmul_rn(facc[i][j][2 * h], inv)) |
              (uint16_t)((uint16_t)(uint8_t)to_i8(__fmul_rn(facc[i][j][2 * h + 1], inv)) << 8);
          *reinterpret_cast<uint16_t*>(p.out_q + (size_t)row * p.N + col) = pair;
        }
        if (cluster.block_rank() == 0 && wn == 0 && t == 0)
          p.out_s[(size_t)row * n_q + blockIdx.x / csize] = scale;
      }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rows[i][h];
        if (row >= p.M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn * WN + j * 8 + t * 2;
          float v0 = facc[i][j][2 * h], v1 = facc[i][j][2 * h + 1];
          if (p.gate) {
            const float2 gv = *reinterpret_cast<const float2*>(p.gate + col);
            v0 = __fmul_rn(v0, gv.x);
            v1 = __fmul_rn(v1, gv.y);
          }
          if (p.res) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.res + (size_t)row * p.N + col));
            v0 = __fadd_rn(v0, rv.x);
            v1 = __fadd_rn(v1, rv.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)row * p.N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
  }
}

template <int MODE>
int launch_gemm(const GemmParams& p, int cluster_x, void* stream) {
  if (p.M <= 0 || p.N % BN || p.K % BK || p.K <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, (p.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_kernel<MODE>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

GemmParams make_params(const void* a, const void* w, const void* cs, const void* bias, int M,
                       int N, int K, int act) {
  GemmParams p = {};
  p.a = (const int8_t*)a;
  p.w = (const int8_t*)w;
  p.cs = (const float*)cs;
  p.bias = (const float*)bias;
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = act;
  p.bk = K;
  return p;
}

}  // namespace

extern "C" int tdx_quantize_rows_int8(const void* x, long long ld, void* xq, void* rs, int M,
                                      int K, void* stream) {
  if (K % 8 || ld % 8) return (int)cudaErrorInvalidValue;
  quantize_rows_kernel<<<(M + kRqWarps - 1) / kRqWarps, kRqWarps * 32, 0,
                         (cudaStream_t)stream>>>((const __nv_bfloat16*)x, ld, (int8_t*)xq,
                                                 (float*)rs, M, K);
  return (int)cudaGetLastError();
}

extern "C" int tdx_int8_gemm_postscale(const void* a, const void* w, const void* rs,
                                       const void* cs, const void* bias, const void* gate,
                                       const void* res, void* out, int M, int N, int K,
                                       int act, void* stream) {
  GemmParams p = make_params(a, w, cs, bias, M, N, K, act);
  p.rs = (const float*)rs;
  p.gate = (const float*)gate;
  p.res = (const __nv_bfloat16*)res;
  p.out = (__nv_bfloat16*)out;
  return launch_gemm<kPostscale>(p, 1, stream);
}

extern "C" int tdx_int8_gemm_qout(const void* a, const void* w, const void* rs, const void* cs,
                                  const void* bias, void* out_q, void* out_s, int M, int N,
                                  int K, int bnq, int act, void* stream) {
  // one cluster of bnq / 128 blocks per scale column; at most 8 (portable)
  if (bnq % BN || N % bnq || bnq / BN > 8) return (int)cudaErrorInvalidValue;
  GemmParams p = make_params(a, w, cs, bias, M, N, K, act);
  p.rs = (const float*)rs;
  p.out_q = (int8_t*)out_q;
  p.out_s = (float*)out_s;
  return launch_gemm<kQout>(p, bnq / BN, stream);
}

extern "C" int tdx_int8_gemm_blockact(const void* a, const void* w, const void* xs,
                                      const void* cs, const void* bias, const void* gate,
                                      const void* res, void* out, int M, int N, int K, int bk,
                                      int act, void* stream) {
  if (bk <= 0 || bk % BK || K % bk) return (int)cudaErrorInvalidValue;
  GemmParams p = make_params(a, w, cs, bias, M, N, K, act);
  p.xs = (const float*)xs;
  p.gate = (const float*)gate;
  p.res = (const __nv_bfloat16*)res;
  p.out = (__nv_bfloat16*)out;
  p.bk = bk;
  return launch_gemm<kBlockact>(p, 1, stream);
}
