// K23 and K24: the backward of the bf16 block-sparse attention (K3) for
// sm_90a, in two passes, as the TPU computes it.
//
// K23 tdx_sparse_attention_bwd_dq replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:_flash_bwd_fused, dq pass
//    (launch :1796, body _sparse_bwd_dq_kernel :1488): each Q-block walks
//    exactly its forward LUT row (the `sel` K-blocks K3 gathered) and
//    recomputes s = scale q k^T with an online max, keeping three
//    accumulators per row:
//        acc1 = sum exp(s - m) * dp @ k,  acc2 = sum exp(s - m) @ k,
//        acc3 = rowsum(exp(s - m) * dp),  dp = dO v^T,
//    so that with l the softmax sum and delta = acc3 / l (= rowsum P dp)
//        dq = scale (acc1 - delta acc2) / l
//    needs no saved forward output. It also writes each row's (lse, delta)
//    in fp32, (B*H, Lp, 2), for K24.
// K24 tdx_sparse_attention_bwd_dkv replaces the dk/dv pass (launch :1836,
//    body _sparse_bwd_dkv_kernel :1611): each K-block walks the Q-blocks
//    that selected it, through the inverse LUT (rows [count, q ids...],
//    built in plain torch as `_inverse_lut` :1726 is jnp), with the exact P
//    = exp(s - lse) from K23's lse:
//        dv = sum P^T dO,   dk = scale sum (P (dp - delta))^T q.
//    Each K-block's rows are written once, by one thread block: no atomics,
//    so the gradients are the same bits from run to run, and a K-block no
//    Q-block selected gets dk = dv = 0 exactly.
//
// What bounds them on an H100: tensor-core math. At the 1.3B 480p training
// shape (12 heads, blocks 512/256, 12 of 128 K-blocks) a K23 call needs 3
// products of 2 * 512 * 256 * 128 per selected block pair (S, dP, dS K;
// 9,216 pairs, ~0.93 TFLOP) and K24 4 (S^T, dP^T, P^T dO, dS^T q; ~1.24
// TFLOP), against ~100 MB of q, k, v, dO each. The one-pass dq keeps a
// fourth product (acc2) where a two-pass dq would recompute S and dP: it
// spends 4 products on 3 products' work, as the TPU kernel does, and keeps
// no state between passes.
//
// Both passes are one kernel, `kbwd::bwd_kernel<PASS, ROWS>`, K25's
// warp-specialised shape (flash_jvp.cu, k25::jvp_fwd_kernel) with its two
// m64n128 accumulators and two m64n64 products a chunk:
//   * a tile is ROWS rows of one (b, h) that stay in shared memory as two
//     tensors X1, X2 (K23: the query rows' q and dO; K24: the key rows' k
//     and v); the other side streams through a ring in 64-row chunks of two
//     tensors Y1, Y2 (K23: the keys' k and v; K24: the query rows' q and dO,
//     with their 64 (lse, delta) pairs);
//   * the walk: K23's is chunk_walk.cuh's ChunkWalk over the tile's LUT row
//     (an id outside [0, nK) skipped, the chunks of a block that start
//     before kv_len); K24's `InvWalk` over the K-block's inverse-LUT row
//     (a Q-block id outside [0, nQ) skipped, the chunks of a block that
//     start before Lq; none for a tile whose rows start at or past kv_len).
//     Only the producer walks: it writes each chunk's first row into its
//     stage's slot and each tile's chunk count into the tile's, both in
//     shared memory before the barrier that publishes them (the consumers'
//     registers are all taken by the accumulators: their own walk spilled);
//   * persistent blocks, one an SM, take tiles from an atomic counter in
//     the order (b, h, rows): the blocks at work share a head's streamed rows
//     in L2, K24's two tiles of a 256-key block run side by side and read
//     the same Q chunks, and a block that drew light tiles takes more (the
//     inverse-LUT rows are uneven: K24's static schedule gave its busiest
//     block 1.25x the mean of chunks at 512/256). The counter decides only
//     which block computes a tile, so the outputs are the same bits;
//   * a producer thread TMA-loads through rank-4 maps over (D, H, L, B)
//     with the caller's strides (hopper.cuh bhld_map; fused-QKV column
//     views and autograd's strided dO in place), 64-channel boxes, 128-byte
//     swizzle: the tile's X1 and X2 (64 KB at ROWS 128) on one barrier, each
//     chunk's Y1 and Y2 (32 KB; K24 also its (lse, delta) through a 2-d fp32
//     map over the (B*H, 2 Lp) buffer) on one barrier of a 4-stage ring.
//     The maps end where the rows end (K23: q, dO at Lq, k, v at kv_len;
//     K24: k, v at kv_len, q, dO and (lse, delta) at Lq): rows past them read
//     as zeros, so a NaN tail is never read, and neither are the (lse,
//     delta) rows past Lq;
//   * two consumer warpgroups own 64 rows each. A chunk in a warpgroup's
//     order: S = X1 Y1^T and D = X2 Y2^T on wgmma m64n64k16 bf16 from shared
//     memory (16 wgmmas, one commit); the elementwise step in fp32
//     registers; then two products on wgmma m64n128k16 with the A fragment
//     bf16 in registers and Y as it lies (rows x channels: MN-major, the
//     transpose bit). K23: the online softmax in the log2 domain (exp2(s
//     scale log2 e - max): one FFMA and the SFU's exp2), P and P dp, acc1 +=
//     bf16(P dp) K, acc2 += bf16(P) K. K24: P = exp2(s scale log2 e - lse
//     log2 e), no max and no rescale, dS = P (dp - delta) scale, dk +=
//     bf16(dS) Q, dv += bf16(P) dO. Live registers peak at 192 (the two
//     accumulators, S and D), as in K25; the two warpgroups interleave, one's
//     elementwise step under the other's products;
//   * the epilogue writes the bf16 outputs into the warpgroup's own X1 (and,
//     K24, X2) rows and stores them by TMA; the tile buffer is released once
//     the stores have read it, and the producer loads the next tile's first
//     chunks before its X1 and X2. K23 writes (lse, delta), 8 bytes a row,
//     with plain stores.
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232). ROWS is 128 where the tile side's blocks (K23: block_q, K24:
//   block_k) are multiples of 128 (every training path's 512/256); at the
//   other multiples of 64 (sagesla's straight-through backward at 64/64) a
//   block runs two streams of 64-row tiles, one consumer warpgroup each,
//   each with its own producer thread, tile buffer, 2-stage ring and
//   barriers (K20's k4::Plan<2>). `bwd_form` (ops/sparse_attention_bwd.py
//   `bwd_form` mirrors it) chooses.
// K23's S is chained on the tensor core over the 128 channels; K24's S^T,
// whose error P = exp(s - lse) takes into every bf16(dS), in two chained
// 64-channel halves added in fp32 (kSplitS23, kSplitS24). Against float64
// on every K-block of 10 draws of chip_smoke's inputs (tools/k24_seeds.py),
// S^T chained over 128 left dk's mean |error| 0.05% above fp32 sums of
// each 16-channel step; two halves are level with those at no cost in
// time, 8 parts cost K24 11%, and 8 parts of K23's S cost K23 30%
// (PERF.md §6). Tails: columns at or past kv_len (K23) and query rows at
// or past Lq or key rows at or past kv_len (K24) take P = 0 by selection,
// whatever the buffers hold there. Head dim 128 only; strides and bases
// 16-byte aligned (TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attention_step.cuh"
#include "chunk_walk.cuh"
#include "hopper.cuh"

namespace {

namespace kbwd {

constexpr int kDq = 0, kDkv = 1;           // the passes: K23, K24

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;          // the running max before any key
constexpr float kMaskedLogit = -__builtin_huge_valf();   // a key >= kv_len: p = 0

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kThreadsB = 3 * kWG;         // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kRegs == 65536 / kThreadsB / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsB,
              "setmaxnreg within the block's allocation");

// S = X1 Y1^T of K23 and of K24 in this many parts of 128 / n channels,
// each chained on the tensor core and added to the sum in fp32 (1: chained
// over all 128; see the header)
constexpr int kSplitS23 = 1, kSplitS24 = 2;

constexpr int kChunk = 64;                 // streamed rows a chunk
constexpr int kCBox = kChunk * 128;        // 64 channels of a chunk's rows (bytes)
constexpr int kCTile = 2 * kCBox;          // a chunk's rows of one tensor
constexpr int kLdBytes = kChunk * 8;       // K24: a chunk's (lse, delta)

// A form's tiles and shared memory: kStreams streams of ROWS-row tiles,
// each with its tile buffer (X1, then X2), its ring of chunks (Y1, then
// Y2), K24's (lse, delta) slots and its barriers.
template <int ROWS>
struct Plan {
  static_assert(ROWS == 64 || ROWS == 128, "a tile is one or two warpgroups' rows");
  static constexpr int kStreams = ROWS == 128 ? 1 : 2;
  static constexpr int kCons = 2 / kStreams;         // consumer warpgroups a stream
  static constexpr int kBox = ROWS * 128;            // 64 channels of a tile's rows
  static constexpr int kTile = 2 * kBox;             // a tile's rows of one tensor
  static constexpr int kRes = 2 * kTile;             // X1, X2
  static constexpr int kStages = ROWS == 128 ? 4 : 2;
  static constexpr int kStage = 2 * kCTile;          // Y1, Y2
  static constexpr int kStream = kRes + kStages * kStage;
  static constexpr int kLdAt = kStreams * kStream;
  // each stream's chunk rows a stage, its tile's chunk count and the tile
  static constexpr int kMetaAt = kLdAt + kStreams * kStages * kLdBytes;
  static constexpr int kMeta = 4 * (kStages + 2);
  static constexpr int kBarsAt = kMetaAt + kStreams * 64;
  static_assert(kMeta <= 64, "a stream's chunk rows and count");
  // resfull, resempty; full, empty a stage
  static constexpr int kBarsA = 2 + 2 * kStages;
  static constexpr int kSmem = kBarsAt + kStreams * kBarsA * 8 + 1024;
  static_assert(kSmem <= 232448, "one block an SM");
};

struct Params {
  int B, H, Lq, Lk, kv_len;
  float scale, scale_log2;
  // K23: the LUT (B, H, nQ, sel) of K-block ids, nK = ceil(kv_len /
  // block_k) K blocks that hold a key before kv_len (chunk_walk.cuh)
  const int* lut;
  int nQ, sel, block_q, block_k, nK;
  // K24: the inverse LUT (B*H, nKi, 1 + nQ), nKi = ceil(Lk / block_k)
  const int* inv;
  int nKi;
  // K23: (lse, delta) (B*H, Lp, 2) fp32
  float* ld;
  int Lp;
  // the launch's tile counter (zero at the start)
  int* work;
};

// The tile counters the launches take their tiles from: one of kWorkSlots
// a launch, in turn, zeroed on the launch's stream before it (launches in
// flight on other streams take other slots).
constexpr int kWorkSlots = 64;
__device__ int g_work[kWorkSlots];

int* work_slot(cudaStream_t stream, cudaError_t* err) {
  static std::atomic<unsigned> next{0};
  int* slots = nullptr;
  *err = cudaGetSymbolAddress(reinterpret_cast<void**>(&slots), g_work);
  if (*err != cudaSuccess) return nullptr;
  int* slot = slots + next++ % kWorkSlots;
  *err = cudaMemsetAsync(slot, 0, sizeof(int), stream);
  return slot;
}

// K24's walk: the 64-row query chunks of the Q blocks in the tile's K-block
// inverse-LUT row, in order; a Q block id outside [0, nQ) names no row, and
// of each Q block the chunks that start before Lq. None for a tile whose
// rows start at or past kv_len (every P of it is 0).
template <int ROWS>
struct InvWalk {
  const int* row;
  int n, j, qb, off, end;   // entries; next entry; the block, its next chunk's offset, its rows

  __device__ __forceinline__ InvWalk(const Params& p, int b, int h, int tile)
      : j(0), qb(0), off(0), end(0) {
    row = p.inv + (((long long)b * p.H + h) * p.nKi + tile * ROWS / p.block_k) * (1 + p.nQ);
    n = tile * ROWS < p.kv_len ? min(__ldg(row), p.nQ) : 0;
  }

  // the next chunk's first query row, or -1 past the last
  __device__ __forceinline__ int next(const Params& p) {
#pragma unroll 1
    while (off >= end) {
      if (j >= n) return -1;
      qb = __ldg(row + 1 + j++);
      off = 0;
      end = qb >= 0 && qb < p.nQ ? min(p.block_q, p.Lq - qb * p.block_q) : 0;
    }
    const int r0 = qb * p.block_q + off;
    off += kChunk;
    return r0;
  }
};

template <int PASS, int ROWS>
using Walk = std::conditional_t<PASS == kDq, ChunkWalk<true, ROWS, kChunk>, InvWalk<ROWS>>;

__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Grid: persistent blocks, at most one an SM. A tile is ROWS rows of one
// (b, h) (K23: query rows inside one Q block; K24: key rows inside one K
// block); tile t is (b, h) = t / n_tiles, rows ROWS (t % n_tiles). Lane 0
// of producer warp s loads stream s, taking its next tile from the
// launch's counter and handing it to the stream's consumers with the
// tile's chunk count (-1 when none is left); each consumer warpgroup owns
// 64 rows of its stream's tiles. Fragment of a consumer thread (warp w,
// lane l): register i of an accumulator holds row 16 w + l / 4 + 8 ((i >>
// 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
// Maps: x1, x2 the tile's tensors, y1, y2 the streamed ones, o1, o2 the
// outputs (K23: dq, and o2 unused), ld K24's (lse, delta).
template <int PASS, int ROWS>
__global__ void __launch_bounds__(kThreadsB, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tm_x1, const __grid_constant__ CUtensorMap tm_x2,
           const __grid_constant__ CUtensorMap tm_y1, const __grid_constant__ CUtensorMap tm_y2,
           const __grid_constant__ CUtensorMap tm_o1, const __grid_constant__ CUtensorMap tm_o2,
           const __grid_constant__ CUtensorMap tm_ld, const Params p) {
  using P = Plan<ROWS>;
  constexpr bool DKV = PASS == kDkv;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int n_tiles = ((DKV ? p.Lk : p.Lq) + ROWS - 1) / ROWS;
  const int n_items = p.B * p.H * n_tiles;
  // stream sm: its tile buffer (X1, X2), its stages (Y1, Y2), K24's (lse,
  // delta) of each stage, its barriers
  auto res0 = [&](int sm) { return base + sm * P::kStream; };
  auto stage0 = [&](int sm) { return base + sm * P::kStream + P::kRes; };
  auto ld0 = [&](int sm) { return base + P::kLdAt + sm * kStages * kLdBytes; };
  auto bars0 = [&](int sm) { return base + P::kBarsAt + sm * P::kBarsA * 8; };
  // the walk is the producer's: it writes each chunk's first row into its
  // stage's slot before the chunk's barrier, and each tile's chunk count
  // before the tile's, so the consumers hold no walk state
  auto meta0 = [&](int sm) { return base + P::kMetaAt + sm * 64; };

  if (tid == 0) {
#pragma unroll 1
    for (int sm = 0; sm < P::kStreams; ++sm) {
      const uint32_t b0 = bars0(sm);
      mbar_init(b0, 1);                                    // resfull
      mbar_init(b0 + 8, P::kCons);                         // resempty
#pragma unroll 1
      for (int s = 0; s < kStages; ++s) {
        mbar_init(b0 + 16 + 8 * s, 1);                     // full
        mbar_init(b0 + 16 + 8 * (kStages + s), P::kCons);  // empty
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if ((tid & 31) == 0 && tid / 32 < P::kStreams) {
      const int sm = tid / 32;
      const uint32_t resfull = bars0(sm), resempty = resfull + 8;
      const uint32_t full0 = resfull + 16, empty0 = full0 + 8 * kStages;
      const uint32_t res = res0(sm), meta = meta0(sm);
      int n = 0, c = 0;
#pragma unroll 1
      for (;; ++n) {
        const int it = atomicAdd(p.work, 1);
        if (it >= n_items) {
          // no tile left: tell the consumers, once they have read the last
          if (n > 0) mbar_wait(resempty, (n - 1) & 1);
          st_shared(meta + 4 * (kStages + 1), -1);
          mbar_arrive(resfull);
          break;
        }
        const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
        const int row0 = tile * ROWS;
        int count = 0;   // the tile's chunks: one walk to count them, one to load them
        {
          Walk<PASS, ROWS> w(p, b, h, tile);
#pragma unroll 1
          while (w.next(p) >= 0) ++count;
        }
        Walk<PASS, ROWS> walk(p, b, h, tile);
        // the tile's chunk count, X1 and X2 (none where it walks no chunk),
        // once the previous tile's stores have read the buffer
        auto load_res = [&](bool any) {
          if (n > 0) mbar_wait(resempty, (n - 1) & 1);
          st_shared(meta + 4 * kStages, count);
          st_shared(meta + 4 * (kStages + 1), it);
          if (!any) {
            mbar_arrive(resfull);
            return;
          }
          mbar_arrive_expect_tx(resfull, P::kRes);
          tma_load_4d(&tm_x1, res, resfull, 0, h, row0, b);
          tma_load_4d(&tm_x1, res + P::kBox, resfull, 64, h, row0, b);
          tma_load_4d(&tm_x2, res + P::kTile, resfull, 0, h, row0, b);
          tma_load_4d(&tm_x2, res + P::kTile + P::kBox, resfull, 64, h, row0, b);
        };
        int i = 0;   // the tile's chunks issued: the first kStages go before X1, X2
#pragma unroll 1
        for (int r0 = walk.next(p); r0 >= 0; r0 = walk.next(p), ++c, ++i) {
          if (i == kStages) load_res(true);
          const int s = c % kStages, ph = ((c / kStages) & 1) ^ 1;
          const uint32_t yd = stage0(sm) + s * P::kStage, bar = full0 + 8 * s;
          if (c >= kStages) mbar_wait(empty0 + 8 * s, ph);
          st_shared(meta + 4 * s, r0);
          mbar_arrive_expect_tx(bar, 2 * kCTile + (DKV ? kLdBytes : 0));
          tma_load_4d(&tm_y1, yd, bar, 0, h, r0, b);
          tma_load_4d(&tm_y1, yd + kCBox, bar, 64, h, r0, b);
          tma_load_4d(&tm_y2, yd + kCTile, bar, 0, h, r0, b);
          tma_load_4d(&tm_y2, yd + kCTile + kCBox, bar, 64, h, r0, b);
          if constexpr (DKV) tma_load(&tm_ld, ld0(sm) + s * kLdBytes, bar, 2 * r0, bh);
        }
        if (i <= kStages) load_res(i > 0);
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;   // the warpgroup's row of registers with (i & 2) == 0
  const int sm = P::kStreams == 2 ? cw : 0;      // this consumer's stream
  const int row_off = (cw % P::kCons) * 64;      // its rows in the stream's tiles
  const uint32_t resfull = bars0(sm), resempty = resfull + 8;
  const uint32_t full0 = resfull + 16, empty0 = full0 + 8 * kStages;
  const uint32_t xa = res0(sm) + row_off * 128;  // its X1 rows; X2's kTile on
  const uint32_t st0 = stage0(sm), meta = meta0(sm);
  const float sl2 = p.scale_log2;

  // a1, a2: K23 acc1, acc2; K24 dk, dv. sc: S, then P; dp: D, then K23's P
  // dp or K24's dS
  float a1[64], a2[64], sc[32], dp[32];
  uint32_t pa[16], pd[16];               // bf16(P), bf16(P dp or dS): A fragments

  // S = X1 Y1^T and D = X2 Y2^T of the chunk at yb (64 rows x 64 chunk rows)
  constexpr int kSplitS = DKV ? kSplitS24 : kSplitS23;
  static_assert(kSplitS == 1 || kSplitS == 2 || kSplitS == 4 || kSplitS == 8, "parts of 8 steps");
  auto issue_sd = [&](uint32_t yb) {
    if constexpr (kSplitS == 1) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_bf16_ss_n64(sc, sw128_desc(xa + (kk >> 2) * P::kBox + (kk & 3) * 32),
                          sw128_desc(yb + (kk >> 2) * kCBox + (kk & 3) * 32), kk > 0);
    } else {
      // part 0 into S, each later part into D's registers, added to S in
      // fp32 (parts 0 and 1 under one wait)
      constexpr int kSteps = 8 / kSplitS;
#pragma unroll
      for (int part = 0; part < kSplitS; ++part) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int kk = part * kSteps + j;
          const uint64_t da = sw128_desc(xa + (kk >> 2) * P::kBox + (kk & 3) * 32);
          const uint64_t db = sw128_desc(yb + (kk >> 2) * kCBox + (kk & 3) * 32);
          if (part == 0)
            wgmma_bf16_ss_n64(sc, da, db, j > 0);
          else
            wgmma_bf16_ss_n64(dp, da, db, j > 0);
        }
        if (part > 0) {
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence<32>(sc);
          reg_fence<32>(dp);
#pragma unroll
          for (int e = 0; e < 32; ++e) sc[e] = __fadd_rn(sc[e], dp[e]);
          wgmma_fence();
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_bf16_ss_n64(dp, sw128_desc(xa + P::kTile + (kk >> 2) * P::kBox + (kk & 3) * 32),
                        sw128_desc(yb + kCTile + (kk >> 2) * kCBox + (kk & 3) * 32), kk > 0);
    wgmma_commit();
  };
  // a1 += bf16(P dp or dS) Y1, a2 += bf16(P) (K23: Y1; K24: Y2): the chunk's
  // rows are wgmma's K, the channels N (MN-major), a 16-row step two 8-row
  // groups (2048 bytes)
  auto issue_products = [&](uint32_t yb) {
    const uint32_t y2 = DKV ? yb + kCTile : yb;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(a1, pd + 4 * kk, sw128_desc_mn(yb + kk * 2048, kCBox));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(a2, pa + 4 * kk, sw128_desc_mn(y2 + kk * 2048, kCBox));
    wgmma_commit();
  };
  auto fence_acc = [&] {
    reg_fence<64>(a1);
    reg_fence<64>(a2);
    reg_fence<16>(pa);
    reg_fence<16>(pd);
  };

  int n = 0, c = 0;   // tiles and chunks done: the producer's counts
#pragma unroll 1
  for (;; ++n) {
    mbar_wait(resfull, n & 1);
    const int it = ld_shared(meta + 4 * (kStages + 1));   // the tile, or -1: none left
    if (it < 0) break;
    const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
    const int row0 = tile * ROWS;
#pragma unroll
    for (int e = 0; e < 64; ++e) a1[e] = a2[e] = 0.f;
    // K23: the running max (log2 domain), the row sums of P and of P dp
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
    const int count = ld_shared(meta + 4 * kStages);
#pragma unroll 1
    for (int i = 0; i < count; ++i, ++c) {
      const int s = c % kStages;
      const uint32_t yb = st0 + s * P::kStage;
      mbar_wait(full0 + 8 * s, (c / kStages) & 1);
      const int r0 = ld_shared(meta + 4 * s);   // the chunk's first row
      fence_acc();
      wgmma_fence();
      issue_sd(yb);
      wgmma_wait<0>();
      reg_fence<32>(sc);
      reg_fence<32>(dp);

      if constexpr (!DKV) {
        // the online softmax in the log2 domain: keys >= kv_len (only in the
        // last chunk of a block) at -inf before the row max
        const int nvalid = p.kv_len - r0;
        if (nvalid < kChunk) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sc[e] = kMaskedLogit;
        }
        const float mx0 = quad_max(row_tree<true, 0>(sc)), mx1 = quad_max(row_tree<true, 2>(sc));
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
            a1[e] *= a;
            a2[e] *= a;
          }
        }
        // P dp (0 where P is: keys past kv_len read as zero rows of v)
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] *= sc[e];
        u0 = u0 * alpha0 + row_tree<false, 0>(dp);
        u1 = u1 * alpha1 + row_tree<false, 2>(dp);
      } else {
        // P = exp(s scale - lse), dS = P (dp - delta) scale; query rows past
        // Lq (read as zeros, with zero (lse, delta)) and key rows past kv_len
        // take P = dS = 0
        const uint32_t lds = ld0(sm) + s * kLdBytes;
        const int nvalid = p.Lq - r0, kvalid = p.kv_len - row0 - row_off;
        const bool whole = nvalid >= kChunk && kvalid >= 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // (lse, delta) of columns 8 j + 2 t and 8 j + 2 t + 1
          const float4 w = ld_shared_f4(lds + 8 * (8 * j + 2 * t));
          const float ls0 = w.x * kLog2e, ls1 = w.z * kLog2e;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i;
            float pv = ex2_approx(fmaf(sc[e], sl2, (i & 1) ? -ls1 : -ls0));
            float dv = pv * (dp[e] - ((i & 1) ? w.w : w.y)) * p.scale;
            if (!whole) {
              const bool live = 8 * j + 2 * t + (i & 1) < nvalid &&
                                rl0 + ((i & 2) ? 8 : 0) < kvalid;
              pv = live ? pv : 0.f;
              dv = live ? dv : 0.f;
            }
            sc[e] = pv;
            dp[e] = dv;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
#pragma unroll
      for (int e = 0; e < 16; ++e) pd[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);
      fence_acc();
      wgmma_fence();
      issue_products(yb);
      wgmma_wait<0>();
      fence_acc();
      if (lt == 0) mbar_arrive(empty0 + 8 * s);   // Y1 and Y2 are read
    }

    // The outputs in bf16, into this warpgroup's own X1 (K24: and X2) rows
    // (its last S and D are done) as the TMA stores read them: 16-byte
    // chunk ch of row r at ch ^ (r % 8); rows past Lq (K23) or Lk (K24) are
    // not written
    float f0 = 0.f, f1 = 0.f, d0 = 0.f, d1 = 0.f;   // K23's factors
    if constexpr (!DKV) {
      // dq = scale (acc1 - delta acc2) / l, delta = acc3 / l (a K23 LUT row
      // with no chunk before kv_len leaves l = 0: its rows are 0, and its
      // lse the plain version's -1e30 + ln 1e-20, the max left unscaled)
      const float lc0 = fmaxf(quad_sum(l0), 1e-20f), lc1 = fmaxf(quad_sum(l1), 1e-20f);
      d0 = quad_sum(u0) / lc0;
      d1 = quad_sum(u1) / lc1;
      f0 = p.scale / lc0;
      f1 = p.scale / lc1;
      const int r = row0 + row_off + rl0;
      if (t == 0) {
        float2* out = reinterpret_cast<float2*>(p.ld) + (long long)bh * p.Lp + r;
        const float mm0 = m0 == kNegInf ? m0 : m0 * kLn2, mm1 = m1 == kNegInf ? m1 : m1 * kLn2;
        if (r < p.Lq) out[0] = make_float2(mm0 + logf(lc0), d0);
        if (r + 8 < p.Lq) out[8] = make_float2(mm1 + logf(lc1), d1);
      }
    }
    unsigned char* orow = smem + (xa - base) + rl0 * 128 + 4 * t;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      unsigned char* at = orow + (jn >> 3) * P::kBox + (((jn & 7) ^ g) << 4);
      float o[4];   // K23 dq, K24 dk: rows rl0 (0, 1) and rl0 + 8 (2, 3)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * jn + i;
        o[i] = DKV ? a1[e] : (a1[e] - ((i & 2) ? d1 : d0) * a2[e]) * ((i & 2) ? f1 : f0);
      }
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[0], o[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) = pack_bf16(o[2], o[3]);
      if constexpr (DKV) {
        *reinterpret_cast<uint32_t*>(at + P::kTile) = pack_bf16(a2[4 * jn], a2[4 * jn + 1]);
        *reinterpret_cast<uint32_t*>(at + P::kTile + 8 * 128) =
            pack_bf16(a2[4 * jn + 2], a2[4 * jn + 3]);
      }
    }
    fence_async_shared();
    named_sync(1 + cw, kWG);
    if (lt == 0) {
      const int r = row0 + row_off;
      tma_store_4d(&tm_o1, xa, 0, h, r, b);
      tma_store_4d(&tm_o1, xa + P::kBox, 64, h, r, b);
      if constexpr (DKV) {
        tma_store_4d(&tm_o2, xa + P::kTile, 0, h, r, b);
        tma_store_4d(&tm_o2, xa + P::kTile + P::kBox, 64, h, r, b);
      }
      tma_store_wait();   // commit; the buffer is read: the next tile may land
      mbar_arrive(resempty);
    }
  }
  if (lt == 0) tma_store_wait_all();
}

// K24's (lse, delta) (B*H, Lp, 2) fp32 as a (2 Lq, B*H) map in boxes of one
// chunk's 64 pairs: the pairs of rows past Lq read as zero
bool ld_map(CUtensorMap* map, const void* ld, int BH, int Lq, long long Lp) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)(2 * Lq), (cuuint64_t)BH};
  const cuuint64_t strides[1] = {(cuuint64_t)(8 * Lp)};
  const cuuint32_t box[2] = {2 * kChunk, 1};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ld), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// maps: x1, x2, y1, y2, o1, o2, ld (kernel order); n_tiles tiles a (b, h)
template <int PASS, int ROWS>
int launch(const CUtensorMap* tm, const Params& p, int n_tiles, void* stream) {
  using P = Plan<ROWS>;
  static int n_sm = 0;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, bwd_kernel<PASS, ROWS>);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs) return (int)cudaErrorInvalidConfiguration;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    return (int)cudaFuncSetAttribute(bwd_kernel<PASS, ROWS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  }();
  if (ready != 0) return ready;
  const long long items = (long long)p.B * p.H * n_tiles;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long long blocks = (items + P::kStreams - 1) / P::kStreams;
  const int grid = blocks > n_sm ? n_sm : (int)blocks;
  cudaError_t err;
  Params pw = p;
  pw.work = work_slot((cudaStream_t)stream, &err);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<PASS, ROWS><<<grid, kThreadsB, P::kSmem, (cudaStream_t)stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], pw);
  return (int)cudaGetLastError();
}

}  // namespace kbwd

// The tile rows a K23 (pass 0) or K24 (pass 1) launch takes
// (ops/sparse_attention_bwd.py `bwd_form` mirrors it): 128 where the blocks
// of its tile's side (K23: block_q; K24: block_k) are multiples of 128, 64 at
// the other multiples of 64; -1, refused: a block that is not a positive
// multiple of 64, no key, or a stride (elements; q, k, v, dout by batch,
// token, head) off 16 bytes (TMA).
int bwd_form(int pass, int block_q, int block_k, int kv_len, const long long* strides) {
  if (block_q <= 0 || block_k <= 0 || block_q % 64 || block_k % 64 || kv_len <= 0) return -1;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return -1;
  return (pass == kbwd::kDq ? block_q : block_k) % 128 == 0 ? 128 : 64;
}

bool aligned(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16) return false;
  return true;
}

}  // namespace

extern "C" int tdx_sparse_attention_bwd_form(int pass, int block_q, int block_k, int kv_len,
                                             const long long* strides) {
  return bwd_form(pass, block_q, block_k, kv_len, strides);
}

extern "C" int tdx_sparse_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* ld,
    const void* lut, int B, int H, int Lq, int kv_len, int nQ, int sel, int block_q,
    int block_k, long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
    long long ksh, long long vsb, long long vsl, long long vsh, long long dsb, long long dsl,
    long long dsh, long long gsb, long long gsl, long long gsh, float scale, void* stream) {
  using namespace kbwd;
  const long long st[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, dsb, dsl, dsh};
  const int rows = bwd_form(kDq, block_q, block_k, kv_len, st);
  const void* ptrs[6] = {q, k, v, dout, dq, ld};
  if (rows < 0 || B <= 0 || H <= 0 || Lq <= 0 || sel < 0 || !lut ||
      nQ != (Lq + block_q - 1) / block_q || gsb % 8 || gsl % 8 || gsh % 8 || !aligned(ptrs, 6))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[7];
  const bool maps = bhld_map(&tm[0], q, B, Lq, H, qsb, qsl, qsh, rows) &&
                    bhld_map(&tm[1], dout, B, Lq, H, dsb, dsl, dsh, rows) &&
                    bhld_map(&tm[2], k, B, kv_len, H, ksb, ksl, ksh, kChunk) &&
                    bhld_map(&tm[3], v, B, kv_len, H, vsb, vsl, vsh, kChunk) &&
                    bhld_map(&tm[4], dq, B, Lq, H, gsb, gsl, gsh, 64);
  if (!maps) return (int)cudaErrorInvalidValue;
  tm[5] = tm[6] = tm[4];   // K23 stores one output and reads no (lse, delta)
  const Params p{B, H, Lq, 0, kv_len, scale, scale * kLog2e, (const int*)lut, nQ, sel,
                 block_q, block_k, (kv_len + block_k - 1) / block_k, nullptr, 0, (float*)ld,
                 nQ * block_q, nullptr};
  const int n_tiles = (Lq + rows - 1) / rows;
  return rows == 128 ? launch<kDq, 128>(tm, p, n_tiles, stream)
                     : launch<kDq, 64>(tm, p, n_tiles, stream);
}

extern "C" int tdx_sparse_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* ld,
    const void* inv, void* dk, void* dv, int B, int H, int Lq, int Lk, int kv_len, int nQ,
    int nK, int block_q, int block_k, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
    long long dsb, long long dsl, long long dsh, long long ksb2, long long ksl2,
    long long ksh2, long long vsb2, long long vsl2, long long vsh2, float scale,
    void* stream) {
  using namespace kbwd;
  const long long st[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, dsb, dsl, dsh};
  const int rows = bwd_form(kDkv, block_q, block_k, kv_len, st);
  const long long ost[6] = {ksb2, ksl2, ksh2, vsb2, vsl2, vsh2};
  const void* ptrs[7] = {q, k, v, dout, ld, dk, dv};
  bool ok = rows > 0 && B > 0 && H > 0 && Lq > 0 && kv_len <= Lk && inv &&
            nQ == (Lq + block_q - 1) / block_q && nK == (Lk + block_k - 1) / block_k &&
            aligned(ptrs, 7);
  for (int i = 0; i < 6; ++i) ok = ok && ost[i] % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long Lp = (long long)nQ * block_q;
  CUtensorMap tm[7];
  const bool maps = bhld_map(&tm[0], k, B, kv_len, H, ksb, ksl, ksh, rows) &&
                    bhld_map(&tm[1], v, B, kv_len, H, vsb, vsl, vsh, rows) &&
                    bhld_map(&tm[2], q, B, Lq, H, qsb, qsl, qsh, kChunk) &&
                    bhld_map(&tm[3], dout, B, Lq, H, dsb, dsl, dsh, kChunk) &&
                    bhld_map(&tm[4], dk, B, Lk, H, ksb2, ksl2, ksh2, 64) &&
                    bhld_map(&tm[5], dv, B, Lk, H, vsb2, vsl2, vsh2, 64) &&
                    ld_map(&tm[6], ld, B * H, Lq, Lp);
  if (!maps) return (int)cudaErrorInvalidValue;
  const Params p{B, H, Lq, Lk, kv_len, scale, scale * kLog2e, nullptr, nQ, 0, block_q,
                 block_k, 0, (const int*)inv, nK, nullptr, (int)Lp, nullptr};
  const int n_tiles = (Lk + rows - 1) / rows;
  return rows == 128 ? launch<kDkv, 128>(tm, p, n_tiles, stream)
                     : launch<kDkv, 64>(tm, p, n_tiles, stream);
}
