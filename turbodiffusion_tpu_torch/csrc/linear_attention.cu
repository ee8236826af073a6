// The SLA linear branch for sm_90a: K21.
//
// K21 replaces turbodiffusion_tpu/ops/linear_attention_pallas.py:_planes_impl
// (launches :141 and :169, bodies _kv_kernel :41-65 and _apply_kernel
// :68-75; the fused sagesla path at v_quant=row and topk 0.3 over (B, H, Lp,
// 128) planes) and _linear_projected_impl (launches :198 and :226, the same
// bodies over (B, L, H, 128); the sla path and training). Every tensor is
// read through (batch, head, row) strides with a unit channel stride, so
// both layouts take the same kernels. Per (b, h), phi = softmax over the
// 128 channels in fp32:
//   tdx_linear_kv, the kv pass: kv = sum phi(k)^T v (128 x 128) and ksum =
//     sum phi(k) over the rows < kv_len of bf16 k and v (a NaN past kv_len
//     stays out: the TPU kernel's where() on both);
//   then kvw = kv @ W^T (torch.matmul in fp32 between the passes, as JAX
//     leaves it to XLA);
//   tdx_linear_apply, the apply pass: o = phi(q) kvw / (1e-5 + phi(q) .
//     ksum) + bias, bf16 out.
//
// What bounds them on an H100: bytes. At the 1.3B 480p shape each pass
// reads or writes two bf16 tensors of 12 x 32,768 x 128 (201 MB, 0.060 ms at
// 3.35 TB/s) and does 2 x 12 x 32,768 x 128^2 multiply-adds, which on the
// tensor cores (three bf16 products, below) take 0.04 ms at the dense peak;
// in fp32 on the CUDA cores they took 0.19 ms at best. The designs:
//   * kv pass (k21::kv_kernel, then k21::kv_reduce_kernel): K6's kv walk
//     (sla_fused.cu k6::, the run split, phi of a row and the reduce shared
//     through linear_kv.cuh) without its int8 work, in two roles. Persistent
//     blocks (one an SM) walk runs of the flat (b, h, 64-row chunk) order,
//     split evenly so that 12 and 40 heads fill the card alike; a chunk's K
//     and V rows arrive by TMA (rank-4 maps over the caller's strides that
//     end at kv_len: rows past it read as zeros, so a NaN tail is never
//     read) into a 3-stage ring. Two phi warpgroups (a half warp a row,
//     two rows at once) write phi of each chunk as three bf16 parts, split by
//     truncation: h1 = the high half of phi's fp32 bits, h2 that of phi - h1,
//     h3 = phi - h1 - h2, which has at most 8 significant bits, so h1 + h2 +
//     h3 = phi exactly; and sum ksum. Against V as it lies (bf16: exact for
//     any finite value, where fp16 overflows above 65,504 and loses bits
//     below 2^-14), two product warpgroups issue phi^T V for their 64
//     channels of kv on wgmma m64n128k16 with both operands MN-major (rows x
//     channels as they lie), three products a 16-row k step, small parts
//     first, onto a fragment that holds minus the Kahan compensation of
//     their fp32 sum, and add the fragment to the sum (Kahan's add in three
//     fp32 operations an element, what it lost left in the fragment). The
//     tensor core cuts each product's sum to 24 bits toward zero, 2 bits
//     below the largest term's last (`tools/time_k21.py --probe`), so each
//     fragment adds one such cut: on int8-valued V (|kv| in the hundreds)
//     over 32,760 rows at 40 heads, a chunk's 12 products chained into one
//     fragment left kv 1.37x rtol / atol 1e-4 from float64, a 32-row pair of
//     k steps 0.84x, the 16-row step 0.59x; plain fp32 sums of the
//     fragments, as K6's (ROADMAP Queue C 5), 2.2x on another draw. setmaxnreg gives the
//     product warpgroups 208 registers (fragment and sum: 128), the phi
//     warpgroups 48. The phi build and the Kahan adds share the SM's issue
//     slots and set the pass's time (PERF.md). Each run writes one fp32
//     partial a head; the reduce adds a head's partials in run order:
//     deterministic, no fp32 atomics.
//   * apply pass (k21::apply_kernel): persistent blocks of two warpgroups
//     walk runs of the flat (b, h, 64-row q tile) order, the warpgroups
//     taking the run's tiles in turn, each with its own 3-stage TMA ring of q
//     tiles and its own bf16 output tile (stored by TMA). A block splits its
//     head's fp32 kvw once into two bf16 parts (round to nearest: hi, then
//     lo of the rest) in MN-major shared-memory tiles. phi(q) is computed in
//     registers in wgmma's A-fragment layout (a quad of lanes a row), split
//     the same way, and fed as the register A operand:
//     num = phi_hi kvw_hi + phi_hi kvw_lo + phi_lo kvw_hi on wgmma
//     m64n128k16 with fp32 accumulation (~2^-16 of each term, under the
//     output's bf16 step); den = 1e-5 + phi . ksum on the CUDA cores in fp32;
//     o = num (1/den) + bias, 1/den rounded to nearest (within an ulp of
//     the quotient, as the bf16 output needs). exp in the apply pass is the
//     SFU's 2^x of one product (~2^-19 of phi, under bf16's 2^-9); the kv
//     pass keeps K6's corrected exp: its sums over 32,768 rows are held to
//     1e-4 of float64.

#include <algorithm>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "linear_kv.cuh"
#include "warp_rows.cuh"

namespace {

constexpr int kDh = 128;

namespace k21 {

// ---- the kv pass ----
// warpgroups 0 and 1 take the products (kv's channel halves 64 g .., on
// m64n128), 2 and 3 build phi; setmaxnreg moves registers from the phi
// warpgroups to the product warpgroups (their fragment and sum: 128)
constexpr int kWG = 128;
constexpr int kKvThreads = 4 * kWG;
constexpr int kKvRegs = 128, kMmaRegs = 208, kPhiRegs = 48;
static_assert(kKvRegs == 65536 / kKvThreads / 8 * 8, "registers a thread at launch");
static_assert(2 * kWG * (kMmaRegs + kPhiRegs) <= kKvRegs * kKvThreads,
              "setmaxnreg within the block's allocation");
constexpr int kRows = 64;                 // rows of a chunk: a TMA stage, a step
constexpr int kStages = 3;
constexpr int kBox = kRows * 128;         // a 64-channel box of a chunk's rows (8 KB)
constexpr int kStage = 4 * kBox;          // K's two boxes, then V's
constexpr int kParts = 3;                 // phi as three bf16 parts
constexpr int kPhiTile = kRows * 128;     // one part's 64 channels of a step's phi
constexpr int kWork = kParts * 2 * kPhiTile;
constexpr int kKsBytes = 2 * kWG / 32 * 128 * 4;   // the phi warps' ksum rows
constexpr int kPhiRows = 2;             // rows a phi half warp takes at once
constexpr size_t kKvSmem = 1024 + (size_t)kStages * kStage + 2 * (size_t)kWork + kKsBytes;

// ---- the apply pass ----
constexpr int kApThreads = 256;           // two warpgroups, a 64-row q tile each in turn
constexpr int kQRows = 64;
constexpr int kQStages = 3;               // q tiles in flight a warpgroup
constexpr int kQTile = 2 * kQRows * 128;  // two 64-channel boxes (16 KB)
constexpr int kBBox = kDh * 128;          // one 64-column box of a kvw part (16 KB)
constexpr size_t kApSmem = 1024 + 4 * (size_t)kBBox + (2 * kQStages + 2) * (size_t)kQTile;

// phi of chunk rows r + 16 j (j < R; a half warp's) from the chunk's K rows
// at kst (two swizzled 64-channel boxes), zero at rows >= live, written as
// three bf16 parts into the step's MN-major A tiles at buf (part p, channel
// half c at buf + (2 p + c) kPhiTile); ksl += phi of the lane's 8 channels.
// The parts: h1 and h2 the high halves (bf16 by truncation) of phi and of
// phi - h1, h3 = phi - h1 - h2, which has at most 8 significant bits: h1 +
// h2 + h3 = phi exactly. The rows' steps interleave (a row alone is bound
// by its shuffles' and the SFU's latency).
template <int R>
__device__ __forceinline__ void build_rows(const unsigned char* kst, uint32_t buf, int live,
                                           int r, int l16, float (&ksl)[8]) {
  float x[R][8];
  bool valid[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int rj = r + 16 * j;
    valid[j] = rj < live;                          // the half warp alike
    const uint4 u = valid[j] ? *reinterpret_cast<const uint4*>(
                                   kst + (l16 >> 3) * kBox + rj * 128 +
                                   (((l16 & 7) ^ (rj & 7)) << 4))
                             : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack2(w[e]);
      x[j][2 * e] = f.x;
      x[j][2 * e + 1] = f.y;
    }
  }
  linkv::phi_rows<R, true>(x, valid, 1.f);
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) ksl[e] += x[j][e];
    // part k: the high halves of what the parts before it leave
    const uint32_t ta = linkv::sw_chunk(buf + (l16 >> 3) * kPhiTile, r + 16 * j, l16 & 7);
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h[e] = __float_as_uint(x[j][e]) & (k + 1 < kParts ? 0xffff0000u : 0xffffffffu);
        x[j][e] = __fsub_rn(x[j][e], __uint_as_float(h[e]));
      }
      linkv::sts128(ta + 2 * k * kPhiTile,
                    make_uint4(__byte_perm(h[0], h[1], 0x7632), __byte_perm(h[2], h[3], 0x7632),
                               __byte_perm(h[4], h[5], 0x7632), __byte_perm(h[6], h[7], 0x7632)));
    }
  }
}

// A grid of run_start's runs over the flat chunks (b, h, 64-row chunk c) of
// nC a head, in two roles. The product warpgroups' thread 0 TMA-loads the
// run's chunks (K and V rows) into a 3-stage ring, the next into a stage as
// soon as both roles are done with it. The phi warpgroups (2, 3; a
// half warp a row) write each chunk's phi as three bf16 parts into one of
// two tile sets and sum ksum; the product warpgroups take it, sum phi^T V
// for their channel half of kv on wgmma onto a fragment and add that to
// their fp32 sum, Kahan's compensation kept in the fragment. mbarriers: full (the TMA
// bytes), phi_full (the phi tiles written), phi_empty (the products
// done). At the end of the run's part of a head each role writes its share
// of the partial of (block, slot): slot 0 for the run's first head, 1 for a
// second (grid >= B H: a run spans at most two heads).
__global__ void __launch_bounds__(kKvThreads, 1)
kv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
          float* __restrict__ part, int H, int kv_len, int nC, int total) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 4];   // full[], phi_full[2], phi_empty[2]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int first = linkv::run_start(blockIdx.x, total, gridDim.x);
  const int n = linkv::run_start(blockIdx.x + 1, total, gridDim.x) - first;
  const uint32_t full = smem_u32(&bars[0]);
  const uint32_t phi_full = full + 8 * kStages, phi_empty = phi_full + 16;
  const uint32_t work = base + kStages * kStage;
  float* ks_x = reinterpret_cast<float*>(sm + kStages * kStage + 2 * kWork);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages + 4; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the run's chunk i: its head, its first row
  auto head = [&](int i) { return (first + i) / nC; };
  auto row0 = [&](int i) { return ((first + i) % nC) * kRows; };

  if (wg >= 2) {
    // ---- phi warpgroups ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kPhiRegs));
    const int bt = tid - 2 * kWG, bw = bt >> 5;
    const int rr = bw * 2 + (lane >> 4), l16 = lane & 15;   // rows rr + 16 q
    float ksl[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ksl[e] = 0.f;
    for (int i = 0; i < n; ++i) {
      if (i >= 2) mbar_wait(phi_empty + 8 * (i & 1), ((i - 2) >> 1) & 1);
      mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
      const unsigned char* kst = sm + (i % kStages) * kStage;
      const uint32_t buf = work + (i & 1) * kWork;
      const int live = min(kRows, kv_len - row0(i));
#pragma unroll 1
      for (int q = 0; q < kRows / 16; q += kPhiRows)
        build_rows<kPhiRows>(kst, buf, live, rr + 16 * q, l16, ksl);
      fence_async_shared();
      named_sync(2, 2 * kWG);
      if (bt == 0) mbar_arrive(phi_full + 8 * (i & 1));
      if (i + 1 == n || head(i + 1) != head(i)) {
        // this run's ksum of head(i): the two half warps' rows, then the
        // warps in order
        float* p = part + ((size_t)blockIdx.x * 2 + (head(i) == head(0) ? 0 : 1)) * linkv::kSlot;
#pragma unroll
        for (int e = 0; e < 8; ++e) ksl[e] += __shfl_xor_sync(0xffffffffu, ksl[e], 16);
        if (lane < 16) {
          *reinterpret_cast<float4*>(ks_x + bw * kDh + lane * 8) =
              make_float4(ksl[0], ksl[1], ksl[2], ksl[3]);
          *reinterpret_cast<float4*>(ks_x + bw * kDh + lane * 8 + 4) =
              make_float4(ksl[4], ksl[5], ksl[6], ksl[7]);
        }
        named_sync(2, 2 * kWG);
        if (bt < kDh) {
          float sk = 0.f;
#pragma unroll
          for (int w = 0; w < 2 * kWG / 32; ++w) sk += ks_x[w * kDh + bt];
          p[kDh * kDh + bt] = sk;
        }
        named_sync(2, 2 * kWG);   // ks_x read
#pragma unroll
        for (int e = 0; e < 8; ++e) ksl[e] = 0.f;
      }
    }
    return;
  }

  // ---- products ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kMmaRegs));
  const CUtensorMap* mk = &tm_k;
  const CUtensorMap* mv = &tm_v;
  // chunk i of the run into stage i % kStages
  auto issue = [&](int i) {
    const int bh = head(i), c = row0(i), b = bh / H, h = bh - b * H;
    const uint32_t st = base + (i % kStages) * kStage, bb = full + 8 * (i % kStages);
    mbar_arrive_expect_tx(bb, kStage);
    tma_load_4d(mk, st, bb, 0, h, c, b);
    tma_load_4d(mk, st + kBox, bb, 64, h, c, b);
    tma_load_4d(mv, st + 2 * kBox, bb, 0, h, c, b);
    tma_load_4d(mv, st + 3 * kBox, bb, 64, h, c, b);
  };
  if (tid == 0)
    for (int i = 0; i < min(n, kStages); ++i) issue(i);
  // the sum, and the fragment: between k steps it holds minus the sum's
  // compensation (what the last add lost), which the next step's products
  // are added to on the tensor core
  float acc[64], frag[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = frag[e] = 0.f;
  for (int i = 0; i < n; ++i) {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    mbar_wait(phi_full + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t a0 = work + (i & 1) * kWork + wg * kPhiTile;
    const uint32_t bv = base + (i % kStages) * kStage + 2 * kBox;
    // a 16-row k step's three products, small parts first (only h1's bring
    // the sum to its size, so one rounding at that size a step), onto the
    // fragment (minus the compensation), then added to the fp32 sum: the
    // fragment keeps what the add lost (Kahan's y - (t - acc))
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      const uint64_t db = sw128_desc_mn(bv + ks * 2048, kBox);
      wgmma_fence();
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p)
        wgmma_bf16_ss_mn(frag, sw128_desc_mn(a0 + 2 * p * kPhiTile + ks * 2048, 0), db, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<64>(frag);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const float t = __fadd_rn(acc[e], frag[e]);
        frag[e] = __fsub_rn(frag[e], __fsub_rn(t, acc[e]));
        acc[e] = t;
      }
    }
    named_sync(1, 2 * kWG);        // both product warpgroups are done with the chunk
    if (tid == 0) {
      mbar_arrive(phi_empty + 8 * (i & 1));
      if (i + kStages < n) issue(i + kStages);
    }
    if (i + 1 == n || head(i + 1) != head(i)) {
      // this run's kv of head(i)
      float* p = part + ((size_t)blockIdx.x * 2 + (head(i) == head(0) ? 0 : 1)) * linkv::kSlot;
      const int w4 = warp & 3, gq = lane >> 2, t = lane & 3;
      const int c0 = wg * 64 + w4 * 16 + gq;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int d = jn * 8 + 2 * t;
        *reinterpret_cast<float2*>(p + c0 * kDh + d) = make_float2(
            __fadd_rn(acc[4 * jn], frag[4 * jn]), __fadd_rn(acc[4 * jn + 1], frag[4 * jn + 1]));
        *reinterpret_cast<float2*>(p + (c0 + 8) * kDh + d) =
            make_float2(__fadd_rn(acc[4 * jn + 2], frag[4 * jn + 2]),
                        __fadd_rn(acc[4 * jn + 3], frag[4 * jn + 3]));
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = frag[e] = 0.f;
    }
  }
}

// kv (B, H, 128, 128) and ksum (B, H, 1, 128): head bh's partials added in
// run order (grid: (ceil(kSlot / 1024), B H))
__global__ void __launch_bounds__(linkv::kReduceThreads)
kv_reduce_kernel(const float* __restrict__ part, float* __restrict__ kv,
                 float* __restrict__ ksum, int nC, int total, int grid) {
  linkv::reduce_partials(part, kv, ksum, nC, total, grid);
}

// A grid of run_start's runs over the flat q tiles (b, h, 64-row tile) of nT
// a head; warpgroup g takes the run's tiles g, g + 2, ... For each head of
// the run, both warpgroups split its kvw into bf16 hi / lo B tiles (MN-major:
// rows c, two 64-column boxes of d) and stage its ksum. Per tile: wait for
// its q rows, phi and den in registers (rows 16 w + r / 8 (+ 8): a quad of
// lanes a row, 32 channels a lane in A-fragment order), hand the stage back
// to the warpgroup's TMA thread, 24 wgmmas, then o = num / den + bias as
// bf16 into the warpgroup's output tile, stored by TMA.
__global__ void __launch_bounds__(kApThreads, 1)
apply_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
             const float* __restrict__ kvw, const float* __restrict__ ksum,
             const float* __restrict__ bias, int H, int nT, int total) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2 * kQStages];
  __shared__ __align__(16) float ks_s[kDh];
  __shared__ __align__(16) float bias_s[kDh];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const bool elect = (tid & 127) == 0;
  const int first = linkv::run_start(blockIdx.x, total, gridDim.x);
  const int n = linkv::run_start(blockIdx.x + 1, total, gridDim.x) - first;
  const int nw = (n - wg + 1) / 2;                 // this warpgroup's tiles
  const uint32_t bt = base;                        // B parts: hi boxes 0, 1; lo boxes 2, 3
  const uint32_t qs0 = base + 4 * kBBox + wg * kQStages * kQTile;
  const uint32_t ot = base + 4 * kBBox + 2 * kQStages * kQTile + wg * kQTile;
  const uint32_t bar0 = smem_u32(&full[0]) + 8 * wg * kQStages;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2 * kQStages; ++s) mbar_init(smem_u32(&full[0]) + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kDh) bias_s[tid] = __ldg(bias + tid);
  __syncthreads();
  // this warpgroup's k-th tile (the run's tile wg + 2 k) into its stage k % kQStages
  const CUtensorMap* mq = &tm_q;
  auto issue = [&](int k) {
    const int blk = first + wg + 2 * k, bh = blk / nT, tile = blk - bh * nT;
    const int b = bh / H, h = bh - b * H;
    const uint32_t st = qs0 + (k % kQStages) * kQTile, bb = bar0 + 8 * (k % kQStages);
    mbar_arrive_expect_tx(bb, kQTile);
    tma_load_4d(mq, st, bb, 0, h, tile * kQRows, b);
    tma_load_4d(mq, st + kQTile / 2, bb, 64, h, tile * kQRows, b);
  };
  if (elect)
    for (int k = 0; k < min(nw, kQStages); ++k) issue(k);

  const int r0 = w4 * 16 + g;                      // this lane's rows r0, r0 + 8 of a tile
  for (int i = 0; i < n;) {
    const int bh = (first + i) / nT, end = min(n, (bh + 1) * nT - first);
    // kvw's bf16 hi and lo parts, 8 columns of a row a step
    const float* kw = kvw + (size_t)bh * kDh * kDh;
    for (int u = tid; u < kDh * kDh / 8; u += kApThreads) {
      const int c = u >> 4, dq = u & 15;
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(kw + c * kDh + dq * 8));
      const float4 x1 = __ldg(reinterpret_cast<const float4*>(kw + c * kDh + dq * 8 + 4));
      const float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = pack2(v[2 * e], v[2 * e + 1]);
        const float2 f = unpack2(hi[e]);
        lo[e] = pack2(__fsub_rn(v[2 * e], f.x), __fsub_rn(v[2 * e + 1], f.y));
      }
      const uint32_t box = bt + (dq >> 3) * kBBox;
      linkv::sts128(linkv::sw_chunk(box, c, dq & 7), make_uint4(hi[0], hi[1], hi[2], hi[3]));
      linkv::sts128(linkv::sw_chunk(box + 2 * kBBox, c, dq & 7),
                    make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
    if (tid < kDh) ks_s[tid] = __ldcg(ksum + (size_t)bh * kDh + tid);
    fence_async_shared();
    __syncthreads();

    for (int j = i + ((i ^ wg) & 1); j < end; j += 2) {
      const int k = j >> 1, s = k % kQStages;
      const uint32_t st = qs0 + s * kQTile;
      mbar_wait(bar0 + 8 * s, (k / kQStages) & 1);
      // q of rows r0, r0 + 8: A-fragment order, 16 channel steps x (c0, c0 + 1,
      // c0 + 8, c0 + 9), c0 = 16 ks + 2 t
      float x[2][32];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = r0 + 8 * h2;
          const uint32_t row = st + (ks >> 2) * (kQTile / 2) + r * 128 + 4 * t;
          uint32_t u0, u1;
          asm volatile("ld.shared.b32 %0, [%1];"
                       : "=r"(u0)
                       : "r"(row + (((2 * (ks & 3)) ^ (r & 7)) << 4)));
          asm volatile("ld.shared.b32 %0, [%1];"
                       : "=r"(u1)
                       : "r"(row + (((2 * (ks & 3) + 1) ^ (r & 7)) << 4)));
          const float2 f0 = unpack2(u0), f1 = unpack2(u1);
          x[h2][4 * ks] = f0.x;
          x[h2][4 * ks + 1] = f0.y;
          x[h2][4 * ks + 2] = f1.x;
          x[h2][4 * ks + 3] = f1.y;
        }
      }
      named_sync(1 + wg, 128);                     // the warpgroup has read the stage
      if (elect && k + kQStages < nw) issue(k + kQStages);
      // phi = softmax over the row's 128 channels (the quad's), den
      float den[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = x[h2][0];
#pragma unroll
        for (int e = 1; e < 32; ++e) mx = fmaxf(mx, x[h2][e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          x[h2][e] = ex2_approx(__fsub_rn(x[h2][e], mx) * linkv::kLog2e);
          sum += x[h2][e];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float rs = linkv::rcp_newton(sum);
        float dot = 0.f;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const float2 k0 = *reinterpret_cast<const float2*>(ks_s + 16 * ks + 2 * t);
          const float2 k1 = *reinterpret_cast<const float2*>(ks_s + 16 * ks + 2 * t + 8);
          const float kk[4] = {k0.x, k0.y, k1.x, k1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[h2][4 * ks + e] = __fmul_rn(x[h2][4 * ks + e], rs);
            dot = fmaf(x[h2][4 * ks + e], kk[e], dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        den[h2] = __fadd_rn(1e-5f, dot);
      }
      // phi as bf16 hi and lo A fragments: k step ks, registers (row r0, c0),
      // (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8)
      uint32_t ah[32], al[32];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h2 = q & 1, e = 4 * ks + 2 * (q >> 1);
          ah[4 * ks + q] = pack2(x[h2][e], x[h2][e + 1]);
          const float2 f = unpack2(ah[4 * ks + q]);
          al[4 * ks + q] = pack2(__fsub_rn(x[h2][e], f.x), __fsub_rn(x[h2][e + 1], f.y));
        }
      }
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint64_t dh = sw128_desc_mn(bt + ks * 2048, kBBox);
        const uint64_t dl = sw128_desc_mn(bt + 2 * kBBox + ks * 2048, kBBox);
        wgmma_bf16_rs<1>(acc, ah + 4 * ks, dh);
        wgmma_bf16_rs<1>(acc, ah + 4 * ks, dl);
        wgmma_bf16_rs<1>(acc, al + 4 * ks, dh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<64>(acc);
      reg_fence<32>(ah);
      reg_fence<32>(al);
      // o = num / den + bias, num times 1/den rounded to nearest (within an
      // ulp of the quotient)
      const float inv[2] = {rcp_rn(den[0]), rcp_rn(den[1])};
      if (elect) tma_store_wait_read();            // the last tile's store has read ot
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * jn + 2 * t);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float o0 = __fmul_rn(acc[4 * jn + 2 * h2], inv[h2]);
          const float o1 = __fmul_rn(acc[4 * jn + 2 * h2 + 1], inv[h2]);
          const int r = r0 + 8 * h2;
          const uint32_t addr = ot + (jn >> 3) * (kQTile / 2) + r * 128 +
                                (((jn & 7) ^ (r & 7)) << 4) + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                       "r"(pack2(__fadd_rn(o0, bb.x), __fadd_rn(o1, bb.y)))
                       : "memory");
        }
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (elect) {
        const int blk = first + j, tb = blk / nT, tile = blk - tb * nT;
        const int b = tb / H, h = tb - b * H;
        tma_store_4d(&tm_o, ot, 0, h, tile * kQRows, b);
        tma_store_4d(&tm_o, ot + kQTile / 2, 64, h, tile * kQRows, b);
        tma_store_commit();
      }
    }
    __syncthreads();   // both warpgroups' products of head bh are done
    i = end;
  }
  if (elect) tma_store_wait_all();
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the views the kernels take: 16-byte aligned, (batch, head, row) strides
// of 8-element multiples (the TMA maps' 16-byte strides), sizes in range
bool views_ok(const void* const* ptrs, int np, const long long* strides, int ns, int B, int H,
              int Lq, int kv_len) {
  if (B <= 0 || H <= 0 || Lq <= 0 || kv_len <= 0) return false;
  if ((long long)B * H * ((std::max(Lq, kv_len) + kRows - 1) / kRows) >= (1LL << 31))
    return false;
  for (int i = 0; i < np; ++i)
    if (!aligned(ptrs[i])) return false;
  for (int i = 0; i < ns; ++i)
    if (strides[i] <= 0 || strides[i] % 8) return false;
  return true;
}

// blocks of a kv launch: one a resident slot (one an SM), at least one a
// (b, h) so that no run spans more than two heads, at most one a chunk
int kv_grid(int B, int H, int kv_len) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kKvSmem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kv_kernel, kKvThreads, kKvSmem);
  const int total = B * H * ((kv_len + kRows - 1) / kRows);
  return std::min(total, std::max(std::max(1, n_sm * per_sm), B * H));
}

}  // namespace k21
}  // namespace

// the form K21 takes for these views (1: the wgmma kernels; -1: refused):
// q, k, v, out and 12 strides (q, k, v, out: batch, head, row)
extern "C" int tdx_linear_form(const void* q, const void* k, const void* v, const void* out,
                               int B, int H, int Lq, int kv_len, const long long* strides) {
  const void* ptrs[4] = {q, k, v, out};
  return k21::views_ok(ptrs, 4, strides, 12, B, H, Lq, kv_len) ? 1 : -1;
}

// blocks of a kv launch (0: refused): B, H, kv_len
extern "C" int tdx_linear_kv_grid(int B, int H, int kv_len) {
  if (B <= 0 || H <= 0 || kv_len <= 0 ||
      (long long)B * H * ((kv_len + k21::kRows - 1) / k21::kRows) >= (1LL << 31))
    return 0;
  return k21::kv_grid(B, H, kv_len);
}

// k, v (b, h, row strided bf16), part (2 x grid partials of (128 + 1) x
// 128 floats), kv (B, H, 128, 128) and ksum (B, H, 1, 128) fp32; `grid`
// blocks as tdx_linear_kv_grid gives them (any count from B H to the chunks
// is correct; another is refused)
extern "C" int tdx_linear_kv(const void* k, const void* v, void* part, void* kv, void* ksum,
                             int B, int H, int kv_len, int grid, long long ksb, long long ksh,
                             long long ksl, long long vsb, long long vsh, long long vsl,
                             void* stream) {
  const void* ptrs[2] = {k, v};
  const long long st[6] = {ksb, ksh, ksl, vsb, vsh, vsl};
  if (!k21::views_ok(ptrs, 2, st, 6, B, H, 1, kv_len)) return (int)cudaErrorInvalidValue;
  const int nC = (kv_len + k21::kRows - 1) / k21::kRows, total = B * H * nC;
  if (grid < B * H || grid > total) return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!bhld_map(&tk, k, B, kv_len, H, ksb, ksl, ksh, k21::kRows) ||
      !bhld_map(&tv, v, B, kv_len, H, vsb, vsl, vsh, k21::kRows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      k21::kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k21::kKvSmem);
  if (err) return (int)err;
  // the register count setmaxnreg assumes (else refuse, not hang)
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k21::kv_kernel);
  if (err) return (int)err;
  if (fa.numRegs != k21::kKvRegs) return (int)cudaErrorInvalidConfiguration;
  k21::kv_kernel<<<grid, k21::kKvThreads, k21::kKvSmem, s>>>(tk, tv, (float*)part, H, kv_len,
                                                             nC, total);
  err = cudaGetLastError();
  if (err) return (int)err;
  const dim3 rgrid((linkv::kSlot / 4 + linkv::kReduceThreads - 1) / linkv::kReduceThreads, B * H);
  k21::kv_reduce_kernel<<<rgrid, linkv::kReduceThreads, 0, s>>>(
      (const float*)part, (float*)kv, (float*)ksum, nC, total, grid);
  return (int)cudaGetLastError();
}

// q, out (b, h, row strided bf16), kvw (B, H, 128, 128), ksum (B, H, 128),
// bias (128,) fp32
extern "C" int tdx_linear_apply(const void* q, const void* kvw, const void* ksum,
                                const void* bias, void* out, int B, int H, int Lq,
                                long long qsb, long long qsh, long long qsl, long long osb,
                                long long osh, long long osl, void* stream) {
  const void* ptrs[5] = {q, out, kvw, ksum, bias};
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  if (!k21::views_ok(ptrs, 5, st, 6, B, H, Lq, 1)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, to;
  if (!bhld_map(&tq, q, B, Lq, H, qsb, qsl, qsh, k21::kQRows) ||
      !bhld_map(&to, out, B, Lq, H, osb, osl, osh, k21::kQRows))
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int nT = (Lq + k21::kQRows - 1) / k21::kQRows, total = B * H * nT;
  const int grid = std::min(total, std::max(n_sm, B * H));
  cudaError_t err = cudaFuncSetAttribute(
      k21::apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k21::kApSmem);
  if (err) return (int)err;
  k21::apply_kernel<<<grid, k21::kApThreads, k21::kApSmem, (cudaStream_t)stream>>>(
      tq, to, (const float*)kvw, (const float*)ksum, (const float*)bias, H, nT, total);
  return (int)cudaGetLastError();
}
