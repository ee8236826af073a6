// K25 and K26: forward-mode (JVP) flash attention for sm_90a, dense and
// block-sparse: the attention output and its tangent in one online-softmax
// pass, for the sCM tangent of rCM distillation.
//
// K25 tdx_flash_attention_jvp replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_jvp_pallas.py:_flash_jvp_dense_pallas
//    (launch :170, body _jvp_kernel :85): softmax attention over all kv_len
//    keys (self attention of a dense student, cross attention over the 512
//    text tokens of every student).
// K26 tdx_sparse_flash_attention_jvp replaces _flash_jvp_sparse_pallas
//    (launch :367, body _sparse_jvp_kernel :198): the same recurrence over
//    the `sel` K-blocks of block_k rows that each block_q-row Q-block's LUT
//    row names (self attention of an sla student).
//
// With S = scale q k^T, dS = scale (dq k^T + q dk^T) and, over the streamed
// keys, the running max m, P = exp(S - m), l = rowsum P, mu = rowsum P dS:
//     acc_o += P v,   acc_t += (P dS) v + P dv    (both rescaled on a new max)
//     o = acc_o / l,  do = acc_t / l - (mu / l) o
// which is (P / l)(dS - mu / l) v + (P / l) dv, the JVP of softmax(S) v. P
// and P dS are rounded to bf16 before their products with v and dv, as the
// TPU kernel's `.astype(v.dtype)` dots round them; everything else is fp32.
// Columns at or past kv_len take S = -inf and dS = 0 (P = 0); l is clamped
// at 1e-20; query rows at or past Lq are never written.
//
// What bounds them on an H100: tensor-core math. Six products a tile where
// the forward (K3 / K4) has two: S, dq k^T, q dk^T, P v, (P dS) v, P dv. At
// the 1.3B 480p/81f training shape (32,760 tokens, 12 heads) a K25 self call
// is ~2.0e13 FLOPs (20 ms at the bf16 dense peak), a cross call over 512
// keys ~3.1e11, and a K26 call at 512/256 with 12 of 128 K-blocks ~1.9e12,
// against ~300 MB of inputs and outputs.
//
// Two forms (`jvp_form`; ops/flash_jvp.py `jvp_form` mirrors it):
//
// 1. `k25::jvp_fwd_kernel<SPARSE>` (K25, and K26 at block_q a multiple of
//    128, block_k of 64: every path's 512/256) is K4's warp-specialised
//    shape (flash_attention.cu, k4::flash_fwd_kernel) with the tangents:
//   * persistent blocks, one an SM, walk 128-row query tiles of every (b,
//     h), the tiles of one head in turn (the blocks at work share its K, dK,
//     V and dV in L2); each walks the chunks of chunk_walk.cuh's ChunkWalk
//     (dense: every 64-key chunk of [0, kv_len); sparse: the tile's LUT row
//     in order, an id outside [0, nK) skipped, the chunks of a block that
//     start before kv_len);
//   * a producer thread TMA-loads through rank-4 maps over (D, H, L, B)
//     with the caller's strides (hopper.cuh bhld_map; fused-QKV column
//     views in place), 64-channel boxes, 128-byte swizzle: the tile's Q and
//     dQ (64 KB, one buffer) and each 64-key chunk's K and dK on one
//     barrier, V and dV on another (64 KB a stage, two stages). K / dK and V
//     / dV are released apart, so the next chunk's K lands under this
//     chunk's P V. The k, v, dk, dv maps end at kv_len and the q, dq maps
//     at Lq: rows past them read as zeros, so a NaN tail is never read;
//   * two consumer warpgroups own 64 rows each. Registers set the chunk:
//     acc_o and acc_t (m64n128 fp32) take 128 a thread, S and dS of 64 keys
//     (m64n64) 64 more; 128 keys would not fit. S = Q K^T on wgmma m64n64k16
//     bf16 from shared memory, dS = dQ K^T + Q dK^T chained in one
//     accumulator (16 k-steps); the online softmax in fp32 registers in the
//     log2 domain (exp2(s * scale log2 e - max): one FFMA and the SFU's
//     exp2); P V, (P dS) V and P dV on wgmma m64n128k16 with bf16(P) and
//     bf16(P dS) in registers as the A fragments and V, dV as they lie
//     (keys x channels: MN-major, the transpose bit);
//   * a chunk in a warpgroup's order: S and dS (24 wgmmas, one commit),
//     the softmax, the three P products (12 wgmmas); live registers peak
//     at 192 (acc_o, acc_t, S, dS). The two warpgroups interleave: one's
//     softmax runs under the other's products. Issuing S with the previous
//     chunk's P products, the exp2 under them and dS after (FA3's
//     intra-warpgroup order at the same 192 registers) was 8-9% slower on
//     an H100 (tools/time_k25_k26.py --design overlap): a third wait a chunk;
//   * the epilogue writes o and do in bf16 into the warpgroup's own Q and
//     dQ rows and stores both by TMA; the buffer is released once the
//     stores have read it, and the producer loads the next tile's first
//     chunks before its Q.
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232). 197,712 bytes of shared memory.
// 2. `sparse_jvp_mma_kernel` (K26 at block_q an odd multiple of 64: no
//    default path, reached by 64/64 or 192/320 blocks through the
//    model.attention overrides; a 128-row tile would hold two Q blocks with
//    two LUT rows)
//    keeps the first design (row_tiles.cuh, K23's first shape): mma.sync m16n8k16,
//    one block of 4 warps owning 64 query rows, synchronous loads of K, dK
//    and V, dV (transposed) in 64-key chunks, two 32-key steps a chunk.
// Head dim 128 only; strides and bases 16-byte aligned (TMA, 16-byte
// vectors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_walk.cuh"
#include "hopper.cuh"
#include "row_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// K25, and K26 at block_q a multiple of 128: k25::jvp_fwd_kernel
// ---------------------------------------------------------------------------

namespace k25 {

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kThreadsJ = 3 * kWG;         // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kRegs == 65536 / kThreadsJ / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsJ,
              "setmaxnreg within the block's allocation");

constexpr int kTileRows = 128;             // query rows a tile, 64 a consumer
constexpr int kKeys = 64;                  // keys a chunk
constexpr int kStages = 2;                 // chunks in flight
constexpr int kQBox = kTileRows * 128;     // 64 channels of the tile's rows
constexpr int kQTile = 2 * kQBox;          // the tile's Q (or dQ), then o (do)
constexpr int kKVBox = kKeys * 128;        // 64 channels of a chunk
constexpr int kKVTile = 2 * kKVBox;        // a chunk's K, dK, V or dV
constexpr int kStage = 4 * kKVTile;        // K, dK | V, dV
constexpr int kBarsAt = 2 * kQTile + kStages * kStage;
// qfull, qempty; kfull, vfull, kempty, vempty a stage
constexpr int kBars = 2 + 4 * kStages;
constexpr int kSmem = kBarsAt + kBars * 8 + 1024;
static_assert(kSmem <= 232448, "one block an SM");
constexpr float kMaskedLogit = -__builtin_huge_valf();   // a key >= kv_len: p = 0

struct Params {
  int B, H, Lq, kv_len;
  float scale, scale_log2;
  // K26: the LUT (B, H, nQ, sel) of K-block ids, block_q query rows a Q
  // block, block_k keys a K block, nK = ceil(kv_len / block_k)
  const int* lut;
  int nQ, sel, block_q, block_k, nK;
};

template <bool SPARSE>
using Walk = ChunkWalk<SPARSE, kTileRows, kKeys>;

// Grid: persistent blocks, at most one an SM; tile t of the walk is (b, h) =
// t / n_tiles, rows 128 (t % n_tiles); block x takes tiles x, x + grid, ...
// Warp 0's lane 0 loads, warpgroups 1 and 2 compute rows 0-63 and 64-127 of
// each tile. Fragment of a consumer thread (warp w, lane l): register i of
// an accumulator holds row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >>
// 2) + 2 (l & 3) + (i & 1).
template <bool SPARSE>
__global__ void __launch_bounds__(kThreadsJ, 1)
jvp_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_dq,
               const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
               const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_do,
               const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int n_tiles = (p.Lq + kTileRows - 1) / kTileRows;
  const int n_items = p.B * p.H * n_tiles;
  // Q at base, dQ at base + kQTile; stage s at st0 + s kStage: K, dK, V, dV
  const uint32_t st0 = base + 2 * kQTile;
  const uint32_t qfull = base + kBarsAt, qempty = qfull + 8;
  const uint32_t kfull0 = qempty + 8, vfull0 = kfull0 + 8 * kStages;
  const uint32_t kempty0 = vfull0 + 8 * kStages, vempty0 = kempty0 + 8 * kStages;

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 2);
#pragma unroll 1
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(kempty0 + 8 * s, 2);
      mbar_init(vempty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      int n = 0, c = 0;
#pragma unroll 1
      for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
        const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
        const int row0 = tile * kTileRows;
        // the tile's Q and dQ, once the previous tile's o and do stores
        // have read the buffer
        auto load_q = [&] {
          if (n > 0) mbar_wait(qempty, (n - 1) & 1);
          mbar_arrive_expect_tx(qfull, 2 * kQTile);
          tma_load_4d(&tm_q, base, qfull, 0, h, row0, b);
          tma_load_4d(&tm_q, base + kQBox, qfull, 64, h, row0, b);
          tma_load_4d(&tm_dq, base + kQTile, qfull, 0, h, row0, b);
          tma_load_4d(&tm_dq, base + kQTile + kQBox, qfull, 64, h, row0, b);
        };
        Walk<SPARSE> walk(p, b, h, tile);
        int i = 0;   // the tile's chunks issued: the first kStages go before Q
#pragma unroll 1
        for (int key0 = walk.next(p); key0 >= 0; key0 = walk.next(p), ++c, ++i) {
          if (i == kStages) load_q();
          const int s = c % kStages, ph = ((c / kStages) & 1) ^ 1;
          const uint32_t kd = st0 + s * kStage, vd = kd + 2 * kKVTile;
          const uint32_t kbar = kfull0 + 8 * s, vbar = vfull0 + 8 * s;
          if (c >= kStages) mbar_wait(kempty0 + 8 * s, ph);
          mbar_arrive_expect_tx(kbar, 2 * kKVTile);
          tma_load_4d(&tm_k, kd, kbar, 0, h, key0, b);
          tma_load_4d(&tm_k, kd + kKVBox, kbar, 64, h, key0, b);
          tma_load_4d(&tm_dk, kd + kKVTile, kbar, 0, h, key0, b);
          tma_load_4d(&tm_dk, kd + kKVTile + kKVBox, kbar, 64, h, key0, b);
          if (c >= kStages) mbar_wait(vempty0 + 8 * s, ph);
          mbar_arrive_expect_tx(vbar, 2 * kKVTile);
          tma_load_4d(&tm_v, vd, vbar, 0, h, key0, b);
          tma_load_4d(&tm_v, vd + kKVBox, vbar, 64, h, key0, b);
          tma_load_4d(&tm_dv, vd + kKVTile, vbar, 0, h, key0, b);
          tma_load_4d(&tm_dv, vd + kKVTile + kKVBox, vbar, 64, h, key0, b);
        }
        if (i <= kStages) load_q();
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;   // the warpgroup's row of registers with (i & 2) == 0
  const int row_off = cw * 64;     // its rows in the tile
  const uint32_t qa = base + row_off * 128, dqa = qa + kQTile;
  const float sl2 = p.scale_log2;

  float o[64], ot[64], sc[32], ds[32];   // acc_o, acc_t; S then P, dS then P dS
  uint32_t pa[16], pd[16];               // bf16(P), bf16(P dS): A fragments

  // S = Q K^T of the chunk whose K lies at kb (64 rows x 64 keys)
  auto issue_s = [&](uint32_t kb) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_bf16_ss_n64(sc, sw128_desc(qa + (kk >> 2) * kQBox + (kk & 3) * 32),
                        sw128_desc(kb + (kk >> 2) * kKVBox + (kk & 3) * 32), kk > 0);
  };
  // dS = dQ K^T + Q dK^T (unscaled), chained in one accumulator
  auto issue_ds = [&](uint32_t kb) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_bf16_ss_n64(ds, sw128_desc(dqa + (kk >> 2) * kQBox + (kk & 3) * 32),
                        sw128_desc(kb + (kk >> 2) * kKVBox + (kk & 3) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_bf16_ss_n64(ds, sw128_desc(qa + (kk >> 2) * kQBox + (kk & 3) * 32),
                        sw128_desc(kb + kKVTile + (kk >> 2) * kKVBox + (kk & 3) * 32));
  };
  // acc_o += bf16(P) V, acc_t += bf16(P dS) V + bf16(P) dV, V at vb and dV
  // after it: the keys are wgmma's K, the channels N (MN-major), a 16-key
  // step two 8-row groups (2048 bytes)
  auto issue_pv = [&](uint32_t vb) {
    const uint32_t dvb = vb + kKVTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(o, pa + 4 * kk, sw128_desc_mn(vb + kk * 2048, kKVBox));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(ot, pd + 4 * kk, sw128_desc_mn(vb + kk * 2048, kKVBox));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(ot, pa + 4 * kk, sw128_desc_mn(dvb + kk * 2048, kKVBox));
    wgmma_commit();
  };
  auto fence_pv = [&] {
    reg_fence<64>(o);
    reg_fence<64>(ot);
    reg_fence<16>(pa);
    reg_fence<16>(pd);
  };

  int n = 0, c = 0;   // tiles and chunks done: the producer's counts
#pragma unroll 1
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
    const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = ot[e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, mu0 = 0.f, mu1 = 0.f;
    mbar_wait(qfull, n & 1);
    Walk<SPARSE> walk(p, b, h, tile);
#pragma unroll 1
    for (int key0 = walk.next(p); key0 >= 0; key0 = walk.next(p), ++c) {
      const int s = c % kStages;
      const uint32_t kb = st0 + s * kStage;
      mbar_wait(kfull0 + 8 * s, (c / kStages) & 1);
      fence_pv();
      wgmma_fence();
      issue_s(kb);
      issue_ds(kb);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<32>(sc);
      reg_fence<32>(ds);
      if (lt == 0) mbar_arrive(kempty0 + 8 * s);   // K and dK are read

      // the online softmax in the log2 domain: keys >= kv_len (only in the
      // last chunk of a block or of [0, kv_len)) at -inf before the row max
      const int nvalid = p.kv_len - key0;
      if (nvalid < kKeys) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sc[e] = kMaskedLogit;
      }
      float mx0 = row_tree<true, 0>(sc), mx1 = row_tree<true, 2>(sc);
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      const float alpha0 = ex2_approx(m0 - mn0), alpha1 = ex2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sc[e] = ex2_approx(fmaf(sc[e], sl2, (e & 2) ? -mn1 : -mn0));
      l0 = l0 * alpha0 + row_tree<false, 0>(sc);
      l1 = l1 * alpha1 + row_tree<false, 2>(sc);
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float a = (e & 2) ? alpha1 : alpha0;
          o[e] *= a;
          ot[e] *= a;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      // P dS (dS scaled here; 0 where P is: keys past kv_len read as zero
      // rows, so their dS is 0, never NaN)
#pragma unroll
      for (int e = 0; e < 32; ++e) ds[e] = sc[e] * (ds[e] * p.scale);
      mu0 = mu0 * alpha0 + row_tree<false, 0>(ds);
      mu1 = mu1 * alpha1 + row_tree<false, 2>(ds);
#pragma unroll
      for (int e = 0; e < 16; ++e) pd[e] = pack_bf16(ds[2 * e], ds[2 * e + 1]);
      fence_pv();
      wgmma_fence();
      mbar_wait(vfull0 + 8 * s, (c / kStages) & 1);
      issue_pv(kb + 2 * kKVTile);
      wgmma_wait<0>();
      fence_pv();
      if (lt == 0) mbar_arrive(vempty0 + 8 * s);
    }

    // (a K26 LUT row with no chunk before kv_len leaves l = 0: its rows are
    // o = 0 / max(0, 1e-20) = 0, do = 0)
    // o = acc_o / l, do = acc_t / l - (mu / l) o in bf16, into this
    // warpgroup's own Q and dQ rows (its last S and dS are done) as the TMA
    // stores read them: 16-byte chunk ch of row r at ch ^ (r % 8); rows past
    // Lq are not written
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
    const float u0 = quad_sum(mu0) * inv0, u1 = quad_sum(mu1) * inv1;
    unsigned char* orow = smem + (qa - base) + rl0 * 128 + 4 * t;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      unsigned char* at = orow + (jn >> 3) * kQBox + (((jn & 7) ^ g) << 4);
      const float a0 = o[4 * jn] * inv0, a1 = o[4 * jn + 1] * inv0;
      const float a2 = o[4 * jn + 2] * inv1, a3 = o[4 * jn + 3] * inv1;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(a0, a1);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) = pack_bf16(a2, a3);
      *reinterpret_cast<uint32_t*>(at + kQTile) =
          pack_bf16(ot[4 * jn] * inv0 - u0 * a0, ot[4 * jn + 1] * inv0 - u0 * a1);
      *reinterpret_cast<uint32_t*>(at + kQTile + 8 * 128) =
          pack_bf16(ot[4 * jn + 2] * inv1 - u1 * a2, ot[4 * jn + 3] * inv1 - u1 * a3);
    }
    fence_async_shared();
    named_sync(1 + cw, kWG);
    if (lt == 0) {
      const int r0 = tile * kTileRows + row_off;
      tma_store_4d(&tm_o, qa, 0, h, r0, b);
      tma_store_4d(&tm_o, qa + kQBox, 64, h, r0, b);
      tma_store_4d(&tm_do, dqa, 0, h, r0, b);
      tma_store_4d(&tm_do, dqa + kQBox, 64, h, r0, b);
      tma_store_wait();   // commit; the buffer is read: the next Q may land
      mbar_arrive(qempty);
    }
  }
  if (lt == 0) tma_store_wait_all();
}

// ptrs: q, k, v, dq, dk, dv, o, do; st: their (batch, token, head) strides
template <bool SPARSE>
int launch(const void* const* ptrs, const long long* st, int B, int H, int Lq, int kv_len,
           const int* lut, int nQ, int sel, int block_q, int block_k, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || kv_len <= 0 || (SPARSE && (!lut || sel < 0)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i)
    if ((uintptr_t)ptrs[i] % 16) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, jvp_fwd_kernel<SPARSE>);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs) return (int)cudaErrorInvalidConfiguration;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    return (int)cudaFuncSetAttribute(jvp_fwd_kernel<SPARSE>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }();
  if (ready != 0) return ready;
  // q, dq, o, do over Lq rows; k, v, dk, dv over kv_len
  const int rows[8] = {Lq, kv_len, kv_len, Lq, kv_len, kv_len, Lq, Lq};
  const int box[8] = {kTileRows, kKeys, kKeys, kTileRows, kKeys, kKeys, 64, 64};
  CUtensorMap tm[8];
  for (int i = 0; i < 8; ++i)
    if (!bhld_map(&tm[i], ptrs[i], B, rows[i], H, st[3 * i], st[3 * i + 1], st[3 * i + 2],
                  box[i]))
      return (int)cudaErrorInvalidValue;
  const int n_tiles = (Lq + kTileRows - 1) / kTileRows;
  const long long items = (long long)B * H * n_tiles;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items > n_sm ? n_sm : (int)items;
  const Params p{B, H, Lq, kv_len, scale, scale * kLog2e, lut, nQ, sel, block_q, block_k,
                 SPARSE ? (kv_len + block_k - 1) / block_k : 0};
  jvp_fwd_kernel<SPARSE><<<grid, kThreadsJ, kSmem, (cudaStream_t)stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], tm[7], p);
  return (int)cudaGetLastError();
}

}  // namespace k25

// ---------------------------------------------------------------------------
// K26 at block_q an odd multiple of 64: sparse_jvp_mma_kernel (mma.sync)
// ---------------------------------------------------------------------------

// S = X K^T and dS = dX K^T + X dK^T for the warp's 16 rows against the
// streamed rows [r0, r0 + 32): X, dX the staged query tiles (A), K, dK the
// streamed row-major tiles (B).
__device__ __forceinline__ void jvp_products(float (&s)[kStep / 8][4], float (&ds)[kStep / 8][4],
                                             const __nv_bfloat16* xs, const __nv_bfloat16* dxs,
                                             const __nv_bfloat16* ks, const __nv_bfloat16* dks,
                                             int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t ax[4], adx[4];
    a_frag(ax, xs, kk);
    a_frag(adx, dxs, kk);
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
      const int off = (r0 + j * 8 + g) * kStride + kk * 16 + t * 2;
      const uint32_t k0 = lds32(ks + off), k1 = lds32(ks + off + 8);
      mma_bf16(s[j], ax, k0, k1);
      mma_bf16(ds[j], adx, k0, k1);
      mma_bf16(ds[j], ax, lds32(dks + off), lds32(dks + off + 8));
    }
  }
}

// acc_o += P V, acc_t += (P dS) V + P dV over the 32 streamed keys
// [r0, r0 + 32): p, pds the warp's (16 x 32) fp32 values in the accumulator
// layout, rounded to bf16 A fragments here; vt, dvt the chunk's V and dV
// transposed (128 rows of kTStride).
__device__ __forceinline__ void jvp_accumulate(float (&acc_o)[kDh / 8][4],
                                               float (&acc_t)[kDh / 8][4],
                                               const float (&p)[kStep / 8][4],
                                               const float (&pds)[kStep / 8][4],
                                               const __nv_bfloat16* vt,
                                               const __nv_bfloat16* dvt, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    uint32_t ap[4], ad[4];
    ap[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    ap[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    ap[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    ap[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    ad[0] = pack_bf16(pds[2 * kk][0], pds[2 * kk][1]);
    ad[1] = pack_bf16(pds[2 * kk][2], pds[2 * kk][3]);
    ad[2] = pack_bf16(pds[2 * kk + 1][0], pds[2 * kk + 1][1]);
    ad[3] = pack_bf16(pds[2 * kk + 1][2], pds[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      const int off = (d * 8 + g) * kTStride + r0 + kk * 16 + t * 2;
      const uint32_t v0 = lds32(vt + off), v1 = lds32(vt + off + 8);
      mma_bf16(acc_o[d], ap, v0, v1);
      mma_bf16(acc_t[d], ad, v0, v1);
      mma_bf16(acc_t[d], ap, lds32(dvt + off), lds32(dvt + off + 8));
    }
  }
}

// Grid (ceil(Lq / 64), H, B): query rows [64 x, 64 x + 64) of one (b, h),
// the chunks of their Q block's LUT row.
__global__ void __launch_bounds__(kThreads)
sparse_jvp_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dq,
                      const __nv_bfloat16* __restrict__ dk, const __nv_bfloat16* __restrict__ dv,
                      __nv_bfloat16* __restrict__ o, __nv_bfloat16* __restrict__ dout,
                      const int* __restrict__ lut, int H, int Lq, int kv_len, int nQ, int sel,
                      int block_q, int block_k, Strides qs, Strides ks, Strides vs, Strides dqs,
                      Strides dks, Strides dvs, Strides os, Strides dos, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dQs = Qs + kTile;
  __nv_bfloat16* Ks = dQs + kTile;
  __nv_bfloat16* dKs = Ks + kTile;
  __nv_bfloat16* Vt = dKs + kTile;
  __nv_bfloat16* dVt = Vt + kTTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  load_tile<false>(Qs, nullptr, q + b * qs.b + h * qs.h, qs.l, row0, Lq);
  load_tile<false>(dQs, nullptr, dq + b * dqs.b + h * dqs.h, dqs.l, row0, Lq);

  float acc_o[kDh / 8][4], acc_t[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[d][e] = acc_t[d][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain), rows g, g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  float mu0 = 0.f, mu1 = 0.f;        // ... and of rowsum(P dS)

  const int per = block_k / kRows;
  const int n_chunks = sel * per;
  const int* lut_row = lut + (((long long)b * H + h) * nQ + row0 / block_q) * sel;
  const long long kofs = b * ks.b + h * ks.h, dkofs = b * dks.b + h * dks.h;
  const long long vofs = b * vs.b + h * vs.h, dvofs = b * dvs.b + h * dvs.h;
  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = lut_row[c / per] * block_k + (c % per) * kRows;
    if (key0 < 0 || key0 >= kv_len) continue;   // no valid column
    __syncthreads();  // the previous chunk is consumed
    load_tile<false>(Ks, nullptr, k + kofs, ks.l, key0, kv_len);
    load_tile<false>(dKs, nullptr, dk + dkofs, dks.l, key0, kv_len);
    load_tile<true, false>(nullptr, Vt, v + vofs, vs.l, key0, kv_len);
    load_tile<true, false>(nullptr, dVt, dv + dvofs, dvs.l, key0, kv_len);
    __syncthreads();
    const int nvalid = kv_len - key0;
#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kStep) {
      float s[kStep / 8][4], ds[kStep / 8][4];
      jvp_products(s, ds, Qs, dQs, Ks, dKs, r0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = r0 + j * 8 + t * 2 + (e & 1);
          s[j][e] = col < nvalid ? s[j][e] * scale_log2 : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
          else mx1 = fmaxf(mx1, s[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f, ru0 = 0.f, ru1 = 0.f;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = r0 + j * 8 + t * 2 + (e & 1);
          const bool live = col < nvalid;
          const float p = live ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          const float pds = live ? p * (ds[j][e] * scale) : 0.f;
          s[j][e] = p;
          ds[j][e] = pds;
          if (e < 2) {
            rs0 += p;
            ru0 += pds;
          } else {
            rs1 += p;
            ru1 += pds;
          }
        }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      mu0 = mu0 * al0 + ru0;
      mu1 = mu1 * al1 + ru1;
#pragma unroll
      for (int d = 0; d < kDh / 8; ++d) {
        acc_o[d][0] *= al0;
        acc_o[d][1] *= al0;
        acc_o[d][2] *= al1;
        acc_o[d][3] *= al1;
        acc_t[d][0] *= al0;
        acc_t[d][1] *= al0;
        acc_t[d][2] *= al1;
        acc_t[d][3] *= al1;
      }
      jvp_accumulate(acc_o, acc_t, s, ds, Vt, dVt, r0);
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float u0 = quad_sum(mu0) / l0, u1 = quad_sum(mu1) / l1;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = e < 2 ? l0 : l1;
      acc_o[d][e] = acc_o[d][e] / l;
      acc_t[d][e] = acc_t[d][e] / l - (e < 2 ? u0 : u1) * acc_o[d][e];
    }
  store_rows(o + b * os.b + h * os.h, os.l, row0, Lq, acc_o);
  store_rows(dout + b * dos.b + h * dos.h, dos.l, row0, Lq, acc_t);
}

constexpr int kMmaSmem = 4 * kTile * 2 + 2 * kTTile * 2;

// The kernel a K25 / K26 launch takes (ops/flash_jvp.py `jvp_form` mirrors
// it): 1, `k25::jvp_fwd_kernel`, for the dense launch (block_q = block_k =
// 0) and for blocks with block_q a multiple of 128 and block_k of 64; 0,
// `sparse_jvp_mma_kernel`, for block_q an odd multiple of 64; -1, refused:
// other blocks, no key, or a stride (elements; q, k, v, dq, dk, dv, o, do by
// batch, token, head) off 16 bytes, which neither form reads (TMA boxes,
// 16-byte vectors).
int jvp_form(int block_q, int block_k, int kv_len, const long long* strides) {
  if (kv_len <= 0) return -1;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8) return -1;
  if (block_q == 0 && block_k == 0) return 1;
  if (block_q <= 0 || block_k <= 0 || block_q % kRows || block_k % k25::kKeys) return -1;
  return block_q % k25::kTileRows == 0 ? 1 : 0;
}

}  // namespace

extern "C" int tdx_flash_attention_jvp_form(int block_q, int block_k, int kv_len,
                                            const long long* strides) {
  return jvp_form(block_q, block_k, kv_len, strides);
}

// strides: 24 values, (batch, token, head) of q, k, v, dq, dk, dv, o, dout
extern "C" int tdx_flash_attention_jvp(const void* q, const void* k, const void* v,
                                       const void* dq, const void* dk, const void* dv, void* o,
                                       void* dout, int B, int H, int Lq, int kv_len,
                                       const long long* strides, float scale, void* stream) {
  if (jvp_form(0, 0, kv_len, strides) != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, dq, dk, dv, o, dout};
  return k25::launch<false>(ptrs, strides, B, H, Lq, kv_len, nullptr, 0, 0, 0, 0, scale,
                            stream);
}

extern "C" int tdx_sparse_flash_attention_jvp(const void* q, const void* k, const void* v,
                                              const void* dq, const void* dk, const void* dv,
                                              void* o, void* dout, const void* lut, int B,
                                              int H, int Lq, int kv_len, int nQ, int sel,
                                              int block_q, int block_k,
                                              const long long* strides, float scale,
                                              void* stream) {
  const int form = jvp_form(block_q, block_k, kv_len, strides);
  if (form < 0 || Lq <= 0 || nQ != (Lq + block_q - 1) / block_q)
    return (int)cudaErrorInvalidValue;
  if (form == 1) {
    const void* ptrs[8] = {q, k, v, dq, dk, dv, o, dout};
    return k25::launch<true>(ptrs, strides, B, H, Lq, kv_len, (const int*)lut, nQ, sel,
                             block_q, block_k, scale, stream);
  }
  const long long* st = strides;
  cudaError_t err = cudaFuncSetAttribute(sparse_jvp_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kRows - 1) / kRows, H, B);
  sparse_jvp_mma_kernel<<<grid, kThreads, kMmaSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dq, (const __nv_bfloat16*)dk, (const __nv_bfloat16*)dv,
      (__nv_bfloat16*)o, (__nv_bfloat16*)dout, (const int*)lut, H, Lq, kv_len, nQ, sel,
      block_q, block_k, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
      Strides{st[18], st[19], st[20]}, Strides{st[21], st[22], st[23]}, scale);
  return (int)cudaGetLastError();
}
