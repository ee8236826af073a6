// K8-K11 and K22: the W8A8 linears for sm_90a.
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
//     (_postscale_gemm_qout_kernel, _qout_wres), the FFN's fc1: K9's product
//     and epilogue up to the GELU, then int8 with one fp32 scale per (row, BNQ
//     columns), BNQ = _pick_bn_div(N) (896 for the 1.3B FFN, 768 for the 14B),
//     scale = max(amax, 1e-8) * (1/127), q = rn(v * (1/scale)), from the fp32
//     values.
// K11 tdx_int8_gemm_blockact replaces quant.py:int8_gemm_blockact_pallas
//     (_blockact_gemm_kernel, _blockact_wres), the FFN's fc2: the product over
//     a per-(row, bk-slab) scaled int8 activation: acc_f32 = sum over slabs of
//     float(s32 slab product) * xs[m, slab], in slab order, then * cs[n]
//     (+ bias[n]) (* gate[n]) (+ res[m, n]), one cast to bf16.
// K22 tdx_int8_gemm_block replaces quant.py:_int8_block_matmul_pallas (body
//     _gemm_kernel): W8A8 with 128 x 128 block scales on both operands, the
//     reference's Int8Linear checkpoint layout. For each 128-wide K block kb,
//     in order: facc += float(s32 block product) * (xs[mb, kb] * ws[nb, kb]),
//     in fp32, the scale product first as the TPU kernel forms it; then the
//     fp32 bias and one store, fp32 or bf16 (the same single rounding as the
//     TPU kernel's fp32 output cast by its caller).
//
// What bounds them on an H100. K8 is memory-bound: at (32,760, 1,536) it
// reads 100.6 MB and writes 50.4 MB, 0.045 ms at 3.35 TB/s. The GEMMs are
// bound by int8 tensor-core math, 2*M*N*K operations at 1,979 TOP/s: 0.46 ms
// for the 1.3B fc1 / fc2 (9.02e11), 2.34 ms for the 14B's (4.64e12); their
// bytes are far below that (K10's int8 out: 293 MB at 1.3B, 453 MB at 14B,
// 0.09 / 0.14 ms; K11's bf16 residual read and output write: 201 / 671 MB).
//
// K10 and K11: `w8a8_ffn_kernel`, Hopper's GEMM shape.
//   * A block is a producer warpgroup and two (K10) or three (K11) consumer
//     warpgroups. One producer warp starts TMA tile loads
//     (cp.async.bulk.tensor, 128-byte swizzle, 128-byte K tiles of both
//     operands) into a ring of shared-memory stages guarded by mbarriers
//     (full: the bytes landed; empty: every consumer warpgroup of the
//     cluster is done with the stage). The consumers run wgmma.mma_async
//     m64n128k32 s8 x s8 -> s32 from shared memory, one commit group in
//     flight while the next stage is waited on. setmaxnreg moves registers
//     from the producer (40) to the consumers (232 / 152). Both operands
//     are K-major as they lie in memory (activation (M, K), weight (N, K)):
//     the layout wgmma takes for 8-bit types. TMA zero-fills rows past M;
//     the int8 sums are exact (|127 * 127 * 13,824| < 2^31).
//   * Tiles are 128 columns wide (every K10 scale block is whole tiles) and
//     run as one thread-block cluster along N whose blocks share the M
//     rows: block 0 of the cluster loads the activation tile once and
//     multicasts it to all of them.
//   * K10: 256 x 128 tiles, 4 stages (each consumer warpgroup two m64
//     slices: two independent accumulator chains, 128 s32 registers); the
//     cluster is the scale block (BNQ / 128 blocks, 3-8). The fp32 epilogue
//     takes GELU-tanh as x * sigmoid(2u) on the SFU (see gelu_tanh_sfu).
//     Each row's amax over the tile's 128 columns takes two shuffles (four
//     lanes hold a row); each block writes it into every cluster block's
//     shared memory (distributed shared memory), one cluster barrier, and
//     each block quantises its own tile against the row's scale into shared
//     memory (128-byte swizzled rows, rounded by the fp32 adder) and stores
//     it with one TMA store.
//   * K11: 192 x 128 tiles, 5 stages (one m64 slice a warpgroup: 64 s32 and
//     64 fp32 accumulator registers; the third warpgroup cuts the L2 bytes
//     an operation); clusters of 2 along N where N / 128 is even. At each
//     slab edge (bk / 128 K tiles: 7 at 1.3B, 6 at 14B) a consumer waits on
//     its wgmmas and folds the s32 sums into fp32 with the slab's xs, which
//     the producer staged in shared memory beside the slab's last K tile;
//     the epilogue reads the residual and writes the bf16 output through
//     shared memory, a TMA load and a TMA store a 64 x 64 box.
//   * Tensor maps are encoded on the host at each launch
//     (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint:
//     libcuda is not on the link line) and passed as __grid_constant__
//     parameters. The helpers K7, K9, K10 and K11 share are in hopper.cuh.
//   What holds them back on an H100 80GB HBM3 (tools/time_w8a8_ffn.py,
//   tools/stamp_w8a8_ffn.py): K10's main loop runs near the int8 peak, and
//   its epilogue (GELU, the amax exchange, the quantise) is about half of a
//   block's time at the 1.3B's K of 1,536; K11's main loop runs at about
//   half the peak, at the same rate of unique L2 bytes per SM as K10's.
//   Not yet: K9's persistent ping-pong schedule, which would overlap one
//   tile's epilogue with the next tile's loads and math.
//
// K9: `ffn::postscale_gemm_kernel`, the same wgmma + TMA main loop on a
// schedule for short K (12 K tiles at the 1.3B's 1,536, 40 at the 14B's):
//   * persistent blocks, as many as the card holds at once, walk the output
//     in 128 x 128 tiles (N fastest); clusters of 2 along N share the rows
//     (block 0 multicasts the activation tile) where N / 128 is even;
//   * two consumer warpgroups in ping-pong: each takes every other tile of
//     its block whole (two m64 slices, 128 s32 registers), so one runs its
//     epilogue while the other runs its main loop; the producer walks every
//     tile's K tiles through one 5-stage ring and runs ahead across tiles;
//   * the epilogue, ((acc * rs) * cs) (+ bias) (GELU-tanh) (* gate) (+ res)
//     in the order of the plain version, one bf16 rounding, works in a
//     128 x 128 bf16 box a consumer (two 64-column TMA boxes): the residual
//     lands there by TMA while the tile's main loop runs and is read in
//     place, the output leaves by TMA store and drains under the next
//     tile's main loop;
//   * K a multiple of 64: the last 128-byte K tile may read zeros past K
//     (TMA fills them), rows past M read zeros and are not written.
//   What holds it back on an H100 80GB HBM3 (tools/time_k9_k7.py): 40% of
//   the int8 peak at the 1.3B's fused QKV, 32% at its O (K = 1,536: 12 K
//   tiles a tile), 52-61% at the 14B's; a consumer's 128 x 128 tile reads
//   more L2 bytes an operation than K10's 256 x 128 cluster tile. The
//   512-row text K / V are 48 tiles, a third of the card (~3x
//   torch._int_mm there).
//
// K22: `ffn::block_gemm_kernel`, K9's wgmma + TMA machinery with K22's fold:
//   * persistent blocks walk the output in 192 x 128 tiles (N fastest),
//     clusters of 2 along N sharing the activation tile (block 0
//     multicasts it) where N / 128 is even; one producer warp feeds a
//     5-stage ring of 128-byte K tiles and runs ahead across tiles;
//   * a 128-byte K tile is exactly one quant block, so every stage ends in
//     a fold. Three consumer warpgroups share each 192 x 128 tile, 64 rows
//     each (K11's layout: 64 s32 and 64 fp32 registers; each consumer's
//     rows lie in one 128-row quant block), so two fold while the third's
//     wgmmas run;
//   * the fold converts s32 to fp32 exactly with an integer add and an fp32
//     subtract (|s32| <= 127^2 * 128 < 2^22), then one FMUL by the block's
//     scale product and one FADD, never an FFMA: fp32 output bit-equal to
//     the plain version; the scales are read while the wgmmas run;
//   * the epilogue adds the bias and stores fp32 or bf16 from the registers
//     (rows past M left out), while the producer fills the ring for the
//     next tile.
//   What holds it back on an H100 80GB HBM3 (tools/time_k4_k22.py; PERF.md):
//   36-41% of the int8 peak at the 14B's shapes, 26-39% at the 1.3B's,
//   1.19-1.33x torch._int_mm. A fold is 4 instructions an s32 sum (IADD,
//   FADD, FMUL, FADD), as many issue slots a K tile as the tensor cores take
//   for its wgmmas, and they overlap only across consumers: a second s32
//   set a consumer gained 5% on two consumers, the third consumer (fewer L2
//   bytes an operation, one more warp to fold while another's wgmmas run)
//   7-9%. The 1.3B's 512-row text GEMMs are 36 tiles, a quarter of the card.
//
// Products the plain version rounds one by one use __fmul_rn / __fadd_rn so
// nvcc does not contract them. Outputs are written to fresh buffers (the
// residual may be the caller's trunk).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fadd_rn(x, __fmul_rn(0.044715f, cube));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(__fmul_rn(kGeluC, inner)))));
}

// K10's GELU-tanh as x * sigmoid(2 u), 0.5 (1 + tanh u) = 1 / (1 + exp(-2 u)),
// with the SFU's exp2 and reciprocal: ~3e-7 relative to tanhf's form, in ~10
// instructions where tanhf takes ~25 (K10's epilogue is bound by instruction throughput)
__device__ __forceinline__ float gelu_tanh_sfu(float x) {
  constexpr float kNeg2CLog2e = -2.f * kGeluC * 1.4426950408889634f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fadd_rn(x, __fmul_rn(0.044715f, cube));
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(kNeg2CLog2e, inner)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.f, e)));
  return __fmul_rn(x, r);
}

// two int8 rn(a * inv), rn(b * inv) (|.| <= 127 * (1 + 2^-23)) as a byte pair:
// y + 1.5 * 2^23 leaves rn-even(y) in the low bits of its fp32 word, by the
// full-rate adder where cvt.rni is quarter rate
__device__ __forceinline__ uint16_t q8_pair(float a, float b, float inv) {
  const uint32_t qa = __float_as_uint(__fadd_rn(__fmul_rn(a, inv), 12582912.f));
  const uint32_t qb = __float_as_uint(__fadd_rn(__fmul_rn(b, inv), 12582912.f));
  return (uint16_t)__byte_perm(qa, qb, 0x0040);
}

// the modes of w8a8_ffn_kernel: K10 and K11 (K9 and K22 have kernels of
// their own)
enum Mode { kQout = 1, kBlockact = 2 };

// ---------------------------------------------------------------------------
// K10, K11: w8a8_ffn_kernel (wgmma, TMA, mbarrier ring, clusters)
// ---------------------------------------------------------------------------

namespace ffn {

constexpr int kTN = 128;          // tile columns: divide every K10 scale block
constexpr int kTK = 128;          // K bytes a stage: one 128-byte swizzle row
constexpr int kWG = 128;          // threads of a warpgroup
constexpr int kMaxCluster = 8;    // portable cluster size

// A block is one producer warpgroup and NCW consumer warpgroups of MS m64
// slices each: K10 2 x 2 (256 x 128 tiles, 128 s32 registers a thread), K11
// 3 x 1 (192 x 128 tiles: its fp32 slab accumulator lives beside the s32 one,
// so one slice a warpgroup, and a third warpgroup for fewer L2 bytes an
// operation). setmaxnreg moves registers from the producer to the consumers
// within the block's allocation at launch (65,536 / THREADS in steps of 8).
template <int MODE>
struct Layout {
  static constexpr int MS = MODE == kQout ? 2 : 1;
  static constexpr int NCW = MODE == kQout ? 2 : 3;
  static constexpr int THREADS = (NCW + 1) * kWG;
  static constexpr int REGS = MODE == kQout ? 168 : 128;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = MODE == kQout ? 232 : 152;
  static_assert(REGS == 65536 / THREADS / 8 * 8, "registers a thread at launch");
  static_assert(PRODUCER_REGS * kWG + CONSUMER_REGS * NCW * kWG <= REGS * THREADS,
                "setmaxnreg within the block's allocation");
  static constexpr int STAGES = MODE == kQout ? 4 : 5;
  static constexpr int BM = NCW * 64 * MS;
  static constexpr int A_BYTES = BM * kTK, B_BYTES = kTN * kTK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled tiles 1024-byte aligned");
  // after the stages: K10 the cluster's row maxima [kMaxCluster][BM], K11 the
  // slab scales [STAGES][BM]; then the barriers
  static constexpr int EXTRA = STAGES * STAGE_BYTES;
  static constexpr int BARS = EXTRA + (MODE == kQout ? kMaxCluster : STAGES) * BM * 4;
  // full and empty barriers a stage; K11: one residual barrier a consumer
  static constexpr int SMEM = BARS + (2 * STAGES + NCW) * 8 + 1024;  // + alignment slack
};

struct FfnParams {
  const float* rs;            // (M,) row scales (K10)
  const float* xs;            // (M, K / bk) slab scales (K11)
  const float* cs;            // (N,) col scales
  const float* bias;          // (N,) or null
  const float* gate;          // (N,) or null (K11)
  const __nv_bfloat16* res;   // (M, N) or null (K11; read through tm_r)
  float* out_s;               // (M, N / bnq) fp32 (K10)
  int M, N, K, bk, act;
};

__device__ __forceinline__ void st_remote_f32(uint32_t addr, uint32_t rank, float v) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "st.shared::cluster.f32 [ra], %2;\n\t}" ::"r"(addr),
      "r"(rank), "f"(v)
      : "memory");
}

// Grid (N / 128, cdiv(M, BM)), clusters of C blocks along x. Fragment of a
// consumer thread (warp w of its warpgroup, lane l): register i of an m64
// slice holds row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 (l & 3) + (i & 1).
template <int MODE>
__global__ void __launch_bounds__(Layout<MODE>::THREADS, 1)
w8a8_ffn_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_r,
                const FfnParams p) {
  using Ly = Layout<MODE>;
  constexpr int MS = Ly::MS, NCW = Ly::NCW, STAGES = Ly::STAGES, BM = Ly::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  float* extra = reinterpret_cast<float*>(smem + Ly::EXTRA);
  const uint32_t full0 = base + Ly::BARS, empty0 = full0 + STAGES * 8;
  const uint32_t res0 = empty0 + STAGES * 8;   // K11's residual barriers
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank(), csize = cluster_blocks();
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * BM;
  const int KT = p.K / kTK;
  const int SK = p.bk / kTK;   // K tiles a slab (K11)

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCW * csize);   // every consumer warpgroup of the cluster
    }
#pragma unroll 1
    for (int c = 0; c < NCW; ++c) mbar_init(res0 + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // the cluster's barriers live before any multicast or remote arrive

  if (tid < kWG) {
    // ---- producer: warp 0 feeds the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Ly::PRODUCER_REGS));
    if (tid < 32) {
      const int lane = tid;
      const uint16_t mask = (uint16_t)((1u << csize) - 1u);
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        if constexpr (MODE == kBlockact) {
          if ((kt + 1) % SK == 0) {   // the slab's last tile carries its row scales
            const int slab = (kt + 1) / SK - 1, n_slab = p.K / p.bk;
            float* ring = extra + s * BM;
            for (int r = lane; r < BM; r += 32)
              ring[r] = m0 + r < p.M ? p.xs[(size_t)(m0 + r) * n_slab + slab] : 0.f;
            __syncwarp();
          }
        }
        if (lane == 0) {
          const uint32_t a = base + s * Ly::STAGE_BYTES, full = full0 + 8 * s;
          mbar_arrive_expect_tx(full, Ly::STAGE_BYTES);
          tma_load(&tm_w, a + Ly::A_BYTES, full, kt * kTK, n0);
          if (rank == 0) tma_load_multicast(&tm_a, a, full, kt * kTK, m0, mask);
        }
        __syncwarp();
      }
    }
    cluster_sync();   // the consumers' one
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Ly::CONSUMER_REGS));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int row0 = cw * 64 * MS + warp * 16 + (lane >> 2);   // local row of register 0
  int acc[MS][64];
  float facc[MODE == kBlockact ? 64 : 1];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[ms][i] = 0;
#pragma unroll
  for (int i = 0; i < (MODE == kBlockact ? 64 : 1); ++i) facc[i] = 0.f;

  // a stage is free once every consumer warpgroup of the cluster is done with it:
  // lanes 0..C-1 of the warpgroup's first warp arrive, one per cluster block
  auto release = [&](int s) {
    if (lt < (int)csize) mbar_arrive_remote(empty0 + 8 * s, (uint32_t)lt);
  };
  int prev = -1;   // the stage read by the commit group still in flight
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = base + s * Ly::STAGE_BYTES + cw * 64 * MS * kTK;
    const uint32_t b = base + s * Ly::STAGE_BYTES + Ly::A_BYTES;
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) reg_fence(acc[ms]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk)
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
        wgmma_s8(acc[ms], sw128_desc(a + ms * 64 * kTK + kk * 32), sw128_desc(b + kk * 32));
    wgmma_commit();
    bool folded = false;
    if constexpr (MODE == kBlockact) {
      if ((kt + 1) % SK == 0) {
        // a slab ends: its exact sums into fp32 with the slab's row scales
        wgmma_wait<0>();
        reg_fence(acc[0]);
        const float* ring = extra + s * BM + row0;
        const float x0 = ring[0], x1 = ring[8];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          facc[i] = __fadd_rn(facc[i], __fmul_rn((float)acc[0][i], (i & 2) ? x1 : x0));
          acc[0][i] = 0;
        }
        if (prev >= 0) release(prev);
        release(s);
        prev = -1;
        folded = true;
      }
    }
    if (!folded) {
      wgmma_wait<1>();
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) reg_fence(acc[ms]);
      if (prev >= 0) release(prev);
      prev = s;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) reg_fence(acc[ms]);

  if constexpr (MODE == kQout) {
    // fp32 values: ((acc * rs) * cs) (+ bias) (GELU)
    float v[MS][64];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      const int r = m0 + row0 + ms * 64;
      const float rs0 = p.rs[min(r, p.M - 1)], rs1 = p.rs[min(r + 8, p.M - 1)];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + 2 * (lane & 3);
        const float2 csv = *reinterpret_cast<const float2*>(p.cs + col);
        const float2 bv = p.bias ? *reinterpret_cast<const float2*>(p.bias + col)
                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn((float)acc[ms][4 * j + e], (e & 2) ? rs1 : rs0);
          x = __fmul_rn(x, (e & 1) ? csv.y : csv.x);
          if (p.bias) x = __fadd_rn(x, (e & 1) ? bv.y : bv.x);
          if (p.act) x = gelu_tanh_sfu(x);
          v[ms][4 * j + e] = x;
        }
      }
    }
    // each row's amax over the tile (its four lanes), into slot [rank][row]
    // of every block of the cluster
    const uint32_t smax = smem_u32(extra);
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          m = fmaxf(m, fmaxf(fabsf(v[ms][4 * j + 2 * h]), fabsf(v[ms][4 * j + 2 * h + 1])));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const int lr = row0 + ms * 64 + 8 * h;
        for (uint32_t r = lane & 3; r < csize; r += 4)
          st_remote_f32(smax + 4 * (rank * BM + lr), r, m);
      }
    // every block's maxima written; every block's main loop done, so no load
    // into this block is pending and stage 0 can hold the int8 tile
    cluster_sync();
    unsigned char* otile = smem;
    const int n_q = p.N / (kTN * (int)csize);
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = row0 + ms * 64 + 8 * h;
        float amax = 0.f;
        for (uint32_t r = 0; r < csize; ++r) amax = fmaxf(amax, extra[r * BM + lr]);
        const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
        const float inv = 1.f / scale;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = j * 8 + 2 * (lane & 3);
          const uint16_t pair = q8_pair(v[ms][4 * j + 2 * h], v[ms][4 * j + 2 * h + 1], inv);
          // the TMA store's 128-byte swizzle: 16-byte chunk c / 16 of row lr
          // sits at chunk (c / 16) ^ (lr % 8)
          *reinterpret_cast<uint16_t*>(otile + lr * kTK + ((((c >> 4) ^ (lr & 7)) << 4) | (c & 15))) =
              pair;
        }
        if (rank == 0 && (lane & 3) == 0 && m0 + lr < p.M)
          p.out_s[(size_t)(m0 + lr) * n_q + blockIdx.x / csize] = scale;
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(NCW * kWG) : "memory");   // the consumer warpgroups
    if (tid == kWG) {   // rows past M are not written
      tma_store(&tm_q, base, n0, m0);
      tma_store_wait();
    }
  } else {
    // (facc * cs) (+ bias) (GELU) (* gate) (+ res), one bf16 rounding. The
    // residual and the output pass through shared memory as two 64 x 64
    // boxes a warpgroup (128-byte swizzled rows, TMA in and out), in the
    // warpgroup's own activation rows of stages 0 and 1: its main loop is
    // done, so no load is pending there and no other warpgroup reads them
    const uint32_t box[2] = {base + cw * 64 * kTK, base + Ly::STAGE_BYTES + cw * 64 * kTK};
    const int r0 = m0 + cw * 64;
    if (p.res) {
      if (lt == 0) {
        mbar_arrive_expect_tx(res0 + 8 * cw, 2 * 64 * kTK);
        tma_load(&tm_r, box[0], res0 + 8 * cw, n0, r0);
        tma_load(&tm_r, box[1], res0 + 8 * cw, n0 + 64, r0);
      }
      mbar_wait(res0 + 8 * cw, 0);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + 2 * (lane & 3);   // the pair's column in the tile
      const float2 csv = *reinterpret_cast<const float2*>(p.cs + n0 + c);
      const float2 bv = p.bias ? *reinterpret_cast<const float2*>(p.bias + n0 + c)
                               : make_float2(0.f, 0.f);
      const float2 gv = p.gate ? *reinterpret_cast<const float2*>(p.gate + n0 + c)
                               : make_float2(1.f, 1.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 - cw * 64 + 8 * h;   // the row in the warpgroup's box
        const int cb = 2 * (c & 63);            // the pair's byte in the box row
        __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
            smem + (box[c >> 6] - base) + r * kTK + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));
        float v0 = __fmul_rn(facc[4 * j + 2 * h], csv.x);
        float v1 = __fmul_rn(facc[4 * j + 2 * h + 1], csv.y);
        if (p.bias) {
          v0 = __fadd_rn(v0, bv.x);
          v1 = __fadd_rn(v1, bv.y);
        }
        if (p.act) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        if (p.gate) {
          v0 = __fmul_rn(v0, gv.x);
          v1 = __fmul_rn(v1, gv.y);
        }
        if (p.res) {
          const float2 rv = __bfloat1622float2(*slot);
          v0 = __fadd_rn(v0, rv.x);
          v1 = __fadd_rn(v1, rv.y);
        }
        *slot = __floats2bfloat162_rn(v0, v1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" ::"r"(2 + cw), "n"(kWG) : "memory");   // this warpgroup
    if (lt == 0) {   // rows past M are not written
      tma_store(&tm_q, box[0], n0, r0);
      tma_store(&tm_q, box[1], n0 + 64, r0);
      tma_store_wait();
    }
    // no block exits while a remote arrive or multicast may still reach it
    cluster_sync();
  }
}

// once per mode: the shared-memory size, and the register count setmaxnreg
// assumes (else the consumers' request could not be met: refuse, not hang)
template <int MODE>
int prepare() {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, w8a8_ffn_kernel<MODE>);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs != Layout<MODE>::REGS) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(w8a8_ffn_kernel<MODE>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<MODE>::SMEM);
}

// a (M, K) x w (N, K); out (M, N): K10's int8, K11's bf16 (beside the residual)
template <int MODE>
int launch(const void* a, const void* w, void* out, const FfnParams& p, int cluster,
           void* stream) {
  using Ly = Layout<MODE>;
  if (p.M <= 0 || p.K <= 0 || p.K % kTK || cluster < 1 || cluster > kMaxCluster ||
      p.N % (kTN * cluster))
    return (int)cudaErrorInvalidValue;
  static const int ready = prepare<MODE>();
  if (ready != 0) return ready;
  constexpr bool kBf16Out = MODE == kBlockact;
  CUtensorMap ta, tw, tq, tr;
  if (!tile_map(&ta, a, false, p.M, p.K, Ly::BM) || !tile_map(&tw, w, false, p.N, p.K, kTN) ||
      !tile_map(&tq, out, kBf16Out, p.M, p.N, kBf16Out ? 64 : Ly::BM) ||
      !tile_map(&tr, p.res ? (const void*)p.res : out, kBf16Out, p.M, p.N,
                kBf16Out ? 64 : Ly::BM))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / kTN, (p.M + Ly::BM - 1) / Ly::BM, 1);
  cfg.blockDim = dim3(Ly::THREADS, 1, 1);
  cfg.dynamicSmemBytes = Ly::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, w8a8_ffn_kernel<MODE>, ta, tw, tq, tr, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9: postscale_gemm_kernel (persistent blocks, ping-pong consumers)
// ---------------------------------------------------------------------------

// One producer warpgroup and two consumer warpgroups, each consumer a whole
// 128 x 128 tile (two m64 slices, 128 s32 registers a thread); 5 stages of
// 128 x 128-byte tiles of both operands, then a 128 x 128 bf16 box a
// consumer for its residual and output.
struct PsLayout {
  static constexpr int NCW = 2;
  static constexpr int THREADS = (NCW + 1) * kWG;
  static constexpr int REGS = 168;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(REGS == 65536 / THREADS / 8 * 8, "registers a thread at launch");
  static_assert(PRODUCER_REGS * kWG + CONSUMER_REGS * NCW * kWG <= REGS * THREADS,
                "setmaxnreg within the block's allocation");
  static constexpr int STAGES = 5;
  static constexpr int BM = 128;
  static constexpr int A_BYTES = BM * kTK, B_BYTES = kTN * kTK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BOX_BYTES = BM * 64 * 2;            // 64 bf16 columns of the tile
  static constexpr int EPI = STAGES * STAGE_BYTES;         // two boxes a consumer
  static constexpr int BARS = EPI + NCW * 2 * BOX_BYTES;
  // full and empty barriers a stage, a residual and an order barrier a consumer
  static constexpr int SMEM = BARS + (2 * STAGES + 2 * NCW) * 8 + 1024;
  static_assert(SMEM <= 232448, "one block an SM");
};

struct PsParams {
  const float* rs;            // (M,) row scales
  const float* cs;            // (N,) col scales
  const float* bias;          // (N,) or null
  const float* gate;          // (N,) or null
  const __nv_bfloat16* res;   // (M, N) or null (read through tm_r)
  int M, N, K, act;
};

// Grid: clusters of C (1 or 2) blocks along N, as many as the card holds at
// once. The output is walked in units of C tiles of 128 x 128 that share
// their rows (N fastest); cluster q takes units q, q + Q, q + 2Q, ... (Q
// clusters), the block of rank r the unit's r-th tile, and its consumer
// warpgroups take the block's tiles in turn (0, 2, 4, ... and 1, 3, ...).
// The producer walks every tile's K tiles in that order through one ring
// and runs ahead across tiles; block 0 of a cluster multicasts the
// activation tile. The consumers' main loops take turns (an order barrier
// each, as CUTLASS's ping-pong kernel orders its math warpgroups): a
// consumer waits for the ring only once the other has left it, so its wait
// on a stage's parity can never match a phase two turns early. Fragment of
// a consumer thread as in w8a8_ffn_kernel.
__global__ void __launch_bounds__(PsLayout::THREADS, 1)
postscale_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_o,
                      const __grid_constant__ CUtensorMap tm_r, const PsParams p) {
  using Ly = PsLayout;
  constexpr int STAGES = Ly::STAGES, BM = Ly::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + Ly::BARS, empty0 = full0 + STAGES * 8;
  const uint32_t res0 = empty0 + STAGES * 8, ord0 = res0 + Ly::NCW * 8;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank(), csize = cluster_blocks();
  const int cl = blockIdx.x / csize, n_cl = gridDim.x / csize;
  const int KT = (p.K + kTK - 1) / kTK;            // the last tile's tail reads zeros
  const int n_units_n = p.N / (kTN * csize);
  const int n_units = (p.M + BM - 1) / BM * n_units_n;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, csize);   // the stage's consumer in every cluster block
    }
    for (int c = 0; c < Ly::NCW; ++c) {
      mbar_init(res0 + 8 * c, 1);
      mbar_init(ord0 + 8 * c, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid < kWG) {
    // ---- producer: warp 0 feeds the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Ly::PRODUCER_REGS));
    if (tid < 32) {
      const uint16_t mask = (uint16_t)((1u << csize) - 1u);
      int it = 0;
#pragma unroll 1
      for (int u = cl; u < n_units; u += n_cl) {
        const int m0 = u / n_units_n * BM, n0 = (u % n_units_n * (int)csize + (int)rank) * kTN;
#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          if (tid == 0) {
            const uint32_t a = base + s * Ly::STAGE_BYTES, full = full0 + 8 * s;
            mbar_arrive_expect_tx(full, Ly::STAGE_BYTES);
            tma_load(&tm_w, a + Ly::A_BYTES, full, kt * kTK, n0);
            if (csize == 1)
              tma_load(&tm_a, a, full, kt * kTK, m0);
            else if (rank == 0)
              tma_load_multicast(&tm_a, a, full, kt * kTK, m0, mask);
          }
          __syncwarp();
        }
      }
    }
    cluster_sync();   // the consumers' one
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Ly::CONSUMER_REGS));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int row_w = warp * 16 + (lane >> 2);   // tile row of register 0 of slice 0
  const uint32_t box = base + Ly::EPI + cw * 2 * Ly::BOX_BYTES;
  const uint32_t rbar = res0 + 8 * cw;
  int acc[2][64];

  // a stage is free once its consumer in every cluster block is done with
  // it: lanes 0..C-1 of the warpgroup's first warp arrive, one per block
  auto release = [&](int s) {
    if (lt < (int)csize) mbar_arrive_remote(empty0 + 8 * s, (uint32_t)lt);
  };
  int n_done = 0;
#pragma unroll 1
  for (int u = cl + cw * n_cl, j = cw; u < n_units; u += 2 * n_cl, j += 2, ++n_done) {
    const int m0 = u / n_units_n * BM, n0 = (u % n_units_n * (int)csize + (int)rank) * kTN;
    if (lt == 0) {
      // the box is free once the previous tile's output store has read it;
      // the residual lands there while the main loop runs
      tma_store_wait_read();
      if (p.res) {
        mbar_arrive_expect_tx(rbar, 2 * Ly::BOX_BYTES);
        tma_load(&tm_r, box, rbar, n0, m0);
        tma_load(&tm_r, box + Ly::BOX_BYTES, rbar, n0 + 64, m0);
      }
    }
    // my turn on the ring: the other consumer's previous tile has left it
    // (consumer 0's first tile goes first)
    if (j > 0) mbar_wait(ord0 + 8 * cw, (n_done - 1 + cw) & 1);
    int prev = -1;   // the stage read by the commit group still in flight
#pragma unroll 1
    for (int kt = 0; kt < KT; ++kt) {
      const int it = j * KT + kt, s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * Ly::STAGE_BYTES, b = a + Ly::A_BYTES;
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 32; ++kk)
#pragma unroll
        for (int ms = 0; ms < 2; ++ms)
          wgmma_s8(acc[ms], sw128_desc(a + ms * 64 * kTK + kk * 32), sw128_desc(b + kk * 32),
                   kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      if (prev >= 0) release(prev);
      prev = s;
    }
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    release(prev);
    // every warp of this warpgroup issued its last wgmma, so has passed its
    // last wait on the ring: the other consumer's turn
    if (lt == 0) mbar_arrive(ord0 + 8 * (1 - cw));

    // ((acc * rs) * cs) (+ bias) (GELU) (* gate) (+ res), one bf16 rounding,
    // into the box (128-byte swizzled rows, the residual read in place),
    // then two TMA stores that drain while the next tile's main loop runs
    named_sync(2 + cw, kWG);   // lane 0's wait for the box is behind every thread
    if (p.res) mbar_wait(rbar, n_done & 1);
    float rsv[2][2];
#pragma unroll
    for (int ms = 0; ms < 2; ++ms)
#pragma unroll
      for (int h = 0; h < 2; ++h) rsv[ms][h] = p.rs[min(m0 + ms * 64 + row_w + 8 * h, p.M - 1)];
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int c = jn * 8 + 2 * (lane & 3);   // the pair's column in the tile
      const float2 csv = *reinterpret_cast<const float2*>(p.cs + n0 + c);
      const float2 bv = p.bias ? *reinterpret_cast<const float2*>(p.bias + n0 + c)
                               : make_float2(0.f, 0.f);
      const float2 gv = p.gate ? *reinterpret_cast<const float2*>(p.gate + n0 + c)
                               : make_float2(1.f, 1.f);
      const int cb = 2 * (c & 63);              // the pair's byte in the box row
#pragma unroll
      for (int ms = 0; ms < 2; ++ms)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ms * 64 + row_w + 8 * h;
          __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
              smem + (box - base) + (c >> 6) * Ly::BOX_BYTES + r * kTK +
              ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));
          float v0 = __fmul_rn(__fmul_rn((float)acc[ms][4 * jn + 2 * h], rsv[ms][h]), csv.x);
          float v1 = __fmul_rn(__fmul_rn((float)acc[ms][4 * jn + 2 * h + 1], rsv[ms][h]), csv.y);
          if (p.bias) {
            v0 = __fadd_rn(v0, bv.x);
            v1 = __fadd_rn(v1, bv.y);
          }
          if (p.act) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          if (p.gate) {
            v0 = __fmul_rn(v0, gv.x);
            v1 = __fmul_rn(v1, gv.y);
          }
          if (p.res) {
            const float2 rv = __bfloat1622float2(*slot);
            v0 = __fadd_rn(v0, rv.x);
            v1 = __fadd_rn(v1, rv.y);
          }
          *slot = __floats2bfloat162_rn(v0, v1);
        }
    }
    fence_async_shared();
    named_sync(2 + cw, kWG);
    if (lt == 0) {   // rows past M are not written
      tma_store(&tm_o, box, n0, m0);
      tma_store(&tm_o, box + Ly::BOX_BYTES, n0 + 64, m0);
      tma_store_commit();
    }
  }
  if (lt == 0) tma_store_wait_all();
  // no block exits while a remote arrive or multicast may still reach it
  cluster_sync();
}

// clusters of C blocks of `kernel` the card holds at once (the caller's
// cache, once per C)
template <typename Kernel>
int max_clusters(Kernel kernel, cudaLaunchConfig_t cfg, int csize, int (&cached)[3]) {
  if (!cached[csize]) {
    int n = 0;
    cfg.gridDim = dim3(csize, 1, 1);
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n <= 0) {
      cudaGetLastError();
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      n = sms / csize;
    }
    cached[csize] = n;
  }
  return cached[csize];
}

// a (M, K) x w (N, K) -> bf16 out (M, N); K a multiple of 64 (the last
// 128-byte K tile may be half zeros), N of 128
int launch_postscale(const void* a, const void* w, void* out, const PsParams& p,
                     void* stream) {
  using Ly = PsLayout;
  if (p.M <= 0 || p.K <= 0 || p.K % 64 || p.N <= 0 || p.N % kTN)
    return (int)cudaErrorInvalidValue;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, postscale_gemm_kernel);
    if (err != cudaSuccess) return (int)err;
    if (fa.numRegs != Ly::REGS) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaFuncSetAttribute(postscale_gemm_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::SMEM);
  }();
  if (ready != 0) return ready;
  // pairs of blocks along N share the activation tile where N / 128 is even
  const int csize = (p.N / kTN) % 2 ? 1 : 2;
  CUtensorMap ta, tw, to, tr;
  if (!tile_map(&ta, a, false, p.M, p.K, Ly::BM) || !tile_map(&tw, w, false, p.N, p.K, kTN) ||
      !tile_map(&to, out, true, p.M, p.N, Ly::BM) ||
      !tile_map(&tr, p.res ? (const void*)p.res : out, true, p.M, p.N, Ly::BM))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Ly::THREADS, 1, 1);
  cfg.dynamicSmemBytes = Ly::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int n_units = (p.M + Ly::BM - 1) / Ly::BM * (p.N / (kTN * csize));
  static int cached[3] = {0, 0, 0};
  const int n_cl = max_clusters(postscale_gemm_kernel, cfg, csize, cached);
  cfg.gridDim = dim3((n_units < n_cl ? n_units : n_cl) * csize, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, postscale_gemm_kernel, ta, tw, to, tr, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K22: block_gemm_kernel (persistent blocks, three consumers a tile, a fold
// a K tile)
// ---------------------------------------------------------------------------

constexpr int kQBlock = 128;   // K22's quant block, both operands: one K tile

// One producer warpgroup and three consumer warpgroups that share each 192
// x 128 output tile (K11's), 64 rows each (one m64 slice: 64 s32 registers,
// 64 fp32 sums); 5 stages of 128-byte K tiles of both operands (40 KB).
struct BsLayout {
  static constexpr int NCW = 3;
  static constexpr int THREADS = (NCW + 1) * kWG;
  static constexpr int REGS = 128;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 152;
  static_assert(REGS == 65536 / THREADS / 8 * 8, "registers a thread at launch");
  static_assert(PRODUCER_REGS * kWG + CONSUMER_REGS * NCW * kWG <= REGS * THREADS,
                "setmaxnreg within the block's allocation");
  static constexpr int STAGES = 5;
  static constexpr int BM = 64 * NCW;
  static constexpr int A_BYTES = BM * kTK, B_BYTES = kTN * kTK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BARS = STAGES * STAGE_BYTES;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "one block an SM");
};

struct BsParams {
  const float* xs;      // (Mb, Kb) activation block scales
  const float* ws;      // (Nb, Kb) weight block scales
  const float* bias;    // (N,) or null
  void* out;            // (M, N) fp32 or bf16
  int M, N, K, out_f32;
};

// Grid: clusters of C (1 or 2) blocks along N, as many as the card holds at
// once, walking the output in units of C tiles of 192 x 128 that share
// their rows (N fastest) as K9 walks it; block 0 of a cluster multicasts the
// activation tile. Each consumer's 64 rows lie in one 128-row quant block,
// and a 128-byte K tile is one quant block: each consumer folds its exact
// s32 sums into its fp32 sums once a stage, facc + float(s32) * (xs[mb, kb]
// * ws[nb, kb]), three roundings in the plain version's order (nothing
// contracted into an FFMA), the scales read while the tile's wgmmas run. A
// consumer whose rows all lie past M (the last tile's) reads the last quant
// block's scales: xs holds ceil(M / 128) rows, and its sums are never
// stored.
// Every consumer reads every stage, so a stage is free once all of every
// cluster block are done with it. Then + bias and one store from the
// registers, rows past M left out. Fragment of a consumer thread as in
// w8a8_ffn_kernel.
__global__ void __launch_bounds__(BsLayout::THREADS, 1)
block_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_w, const BsParams p) {
  using Ly = BsLayout;
  constexpr int NCW = Ly::NCW, STAGES = Ly::STAGES, BM = Ly::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  const uint32_t full0 = base + Ly::BARS, empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank(), csize = cluster_blocks();
  const int cl = blockIdx.x / csize, n_cl = gridDim.x / csize;
  const int KB = p.K / kQBlock, last_mb = (p.M - 1) / kQBlock;
  const int n_units_n = p.N / (kTN * csize);
  const int n_units = (p.M + BM - 1) / BM * n_units_n;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCW * csize);   // every consumer of every cluster block
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid < kWG) {
    // ---- producer: warp 0 feeds the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Ly::PRODUCER_REGS));
    if (tid < 32) {
      const uint16_t mask = (uint16_t)((1u << csize) - 1u);
      int it = 0;
#pragma unroll 1
      for (int u = cl; u < n_units; u += n_cl) {
        const int mt = u / n_units_n, nb = u % n_units_n * (int)csize + (int)rank;
#pragma unroll 1
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          if (tid == 0) {
            const uint32_t a = base + s * Ly::STAGE_BYTES, full = full0 + 8 * s;
            mbar_arrive_expect_tx(full, Ly::STAGE_BYTES);
            tma_load(&tm_w, a + Ly::A_BYTES, full, kb * kTK, nb * kTN);
            if (csize == 1)
              tma_load(&tm_a, a, full, kb * kTK, mt * BM);
            else if (rank == 0)
              tma_load_multicast(&tm_a, a, full, kb * kTK, mt * BM, mask);
          }
          __syncwarp();
        }
      }
    }
    cluster_sync();   // the consumers' one
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Ly::CONSUMER_REGS));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int row_w = cw * 64 + warp * 16 + (lane >> 2);   // tile row of register 0
  int acc[64];
  float facc[64];

  // a stage is free once every consumer of every cluster block is done with
  // it: lanes 0..C-1 of each consumer's first warp arrive, one per block
  auto release = [&](int s) {
    if (lt < (int)csize) mbar_arrive_remote(empty0 + 8 * s, (uint32_t)lt);
  };
  // this consumer's 64 rows x 128 columns of the K tile in stage s
  auto issue = [&](int* d, int s) {
    const uint32_t b = base + s * Ly::STAGE_BYTES + Ly::A_BYTES;
    const uint32_t a = base + s * Ly::STAGE_BYTES + cw * 64 * kTK;
    reg_fence(d);
    wgmma_fence();
    wgmma_s8_first(d, sw128_desc(a), sw128_desc(b));
#pragma unroll
    for (int kk = 1; kk < kTK / 32; ++kk)
      wgmma_s8(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
    wgmma_commit();
  };
  // facc + float(s32) * sc: |s32| <= 127^2 * 128 < 2^22, converted exactly
  // on the adders; the stage is free once its sums are out
  auto fold = [&](int* d, int s, float sc) {
    reg_fence(d);
    release(s);
#pragma unroll
    for (int i = 0; i < 64; ++i) facc[i] = __fadd_rn(facc[i], __fmul_rn(s32_float(d[i]), sc));
  };

  int it = 0;
#pragma unroll 1
  for (int u = cl; u < n_units; u += n_cl) {
    const int m0 = u / n_units_n * BM, n0 = (u % n_units_n * (int)csize + (int)rank) * kTN;
    const float* xrow = p.xs + (size_t)min((m0 + cw * 64) / kQBlock, last_mb) * KB;
    const float* wrow = p.ws + (size_t)(n0 / kTN) * KB;
    // K block kb's scale product, one fp32 rounding (loaded before a wgmma
    // wait, whose memory clobber keeps the load ahead of it)
    auto scale = [&](int kb) { return __fmul_rn(__ldg(xrow + kb), __ldg(wrow + kb)); };
#pragma unroll
    for (int i = 0; i < 64; ++i) facc[i] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb) {
      const int s = (it + kb) % STAGES;
      mbar_wait(full0 + 8 * s, ((it + kb) / STAGES) & 1);
      issue(acc, s);
      const float sc = scale(kb);
      wgmma_wait<0>();
      fold(acc, s, sc);
    }
    it += KB;

    // + bias in fp32, one store (fp32, or bf16: one rounding)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + row_w + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = n0 + jn * 8 + 2 * (lane & 3);
        float v0 = facc[4 * jn + 2 * h], v1 = facc[4 * jn + 2 * h + 1];
        if (p.bias) {
          const float2 bv = *reinterpret_cast<const float2*>(p.bias + col);
          v0 = __fadd_rn(v0, bv.x);
          v1 = __fadd_rn(v1, bv.y);
        }
        const size_t at = (size_t)r * p.N + col;
        if (p.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  // no block exits while a remote arrive or multicast may still reach it
  cluster_sync();
}

// xq (M, K) x w (N, K) with block scales -> out (M, N); K and N multiples of
// 128, 16-byte aligned operands
int launch_block(const void* a, const void* w, const BsParams& p, void* stream) {
  using Ly = BsLayout;
  if (p.M <= 0 || p.K <= 0 || p.K % kQBlock || p.N <= 0 || p.N % kQBlock ||
      (uintptr_t)a % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, block_gemm_kernel);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != Ly::REGS) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaFuncSetAttribute(block_gemm_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::SMEM);
  }();
  if (ready != 0) return ready;
  // pairs of blocks along N share the activation tile where N / 128 is even
  const int csize = (p.N / kTN) % 2 ? 1 : 2;
  CUtensorMap ta, tw;
  if (!tile_map(&ta, a, false, p.M, p.K, Ly::BM) || !tile_map(&tw, w, false, p.N, p.K, kTN))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Ly::THREADS, 1, 1);
  cfg.dynamicSmemBytes = Ly::SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int n_units = (p.M + Ly::BM - 1) / Ly::BM * (p.N / (kTN * csize));
  static int cached[3] = {0, 0, 0};
  const int n_cl = max_clusters(block_gemm_kernel, cfg, csize, cached);
  cfg.gridDim = dim3((n_units < n_cl ? n_units : n_cl) * csize, 1, 1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, block_gemm_kernel, ta, tw, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace ffn

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
  ffn::PsParams p = {};
  p.rs = (const float*)rs;
  p.cs = (const float*)cs;
  p.bias = (const float*)bias;
  p.gate = (const float*)gate;
  p.res = (const __nv_bfloat16*)res;
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = act;
  return ffn::launch_postscale(a, w, out, p, stream);
}

extern "C" int tdx_int8_gemm_qout(const void* a, const void* w, const void* rs, const void* cs,
                                  const void* bias, void* out_q, void* out_s, int M, int N,
                                  int K, int bnq, int act, void* stream) {
  // one cluster of bnq / 128 blocks per scale column; at most 8 (portable)
  if (bnq <= 0 || bnq % ffn::kTN || N % bnq || bnq / ffn::kTN > ffn::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  ffn::FfnParams p = {};
  p.rs = (const float*)rs;
  p.cs = (const float*)cs;
  p.bias = (const float*)bias;
  p.out_s = (float*)out_s;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = K;
  p.act = act;
  return ffn::launch<kQout>(a, w, out_q, p, bnq / ffn::kTN, stream);
}

extern "C" int tdx_int8_gemm_blockact(const void* a, const void* w, const void* xs,
                                      const void* cs, const void* bias, const void* gate,
                                      const void* res, void* out, int M, int N, int K, int bk,
                                      int act, void* stream) {
  if (bk <= 0 || bk % ffn::kTK || K % bk || N % ffn::kTN) return (int)cudaErrorInvalidValue;
  ffn::FfnParams p = {};
  p.xs = (const float*)xs;
  p.cs = (const float*)cs;
  p.bias = (const float*)bias;
  p.gate = (const float*)gate;
  p.res = (const __nv_bfloat16*)res;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.act = act;
  // pairs of blocks along N share the activation tile where N / 128 is even
  return ffn::launch<kBlockact>(a, w, out, p, (N / ffn::kTN) % 2 ? 1 : 2, stream);
}

extern "C" int tdx_int8_gemm_block(const void* a, const void* w, const void* xs,
                                   const void* ws, const void* bias, void* out, int out_f32,
                                   int M, int N, int K, void* stream) {
  ffn::BsParams p = {};
  p.xs = (const float*)xs;
  p.ws = (const float*)ws;
  p.bias = (const float*)bias;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_f32 = out_f32;
  return ffn::launch_block(a, w, p, stream);
}
