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
// ~1.0e11 FLOPs, all well above the ridge.
//
// K3 (`sparse_flash_fwd_kernel`) is FlashAttention-2 on mma.sync m16n8k16
// (bf16 in, fp32 accumulate):
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
// K4 (`k4::dense_fwd_kernel`) is Hopper's warp-specialised attention
// (FlashAttention-3's forward shape, K7's in bf16):
//   * persistent blocks, one an SM, walk 128-row query tiles of every (b,
//     h) (tiles of one head in turn, so the blocks at work share its K and V
//     in L2); a block is one producer warp and two consumer warpgroups of
//     64 rows each;
//   * the producer reads q, k, v and writes o through rank-4 TMA maps over
//     (D, H, L, B) with the caller's strides (fused-QKV column groups in
//     place), in 64-channel boxes with 128-byte swizzle: each tile's Q into
//     one of two Q buffers, each 128-key chunk's K and V into a 2-stage
//     mbarrier ring, running ahead across tiles (the next tile's Q lands
//     under the current tile's last chunks). K and V are released apart, as
//     FlashAttention-3 does: a chunk's K once both QKs have read it, its V
//     after both P Vs, so the next K load starts a chunk ahead of its use
//     (one release a stage left the load a few hundred cycles). The K and V
//     maps end at kv_len, so rows past it arrive as zeros and a poisoned
//     tail is never read; columns >= kv_len are still masked to -inf before
//     the row max;
//   * S = Q K^T on wgmma m64n128k16 bf16 -> fp32, both operands K-major in
//     shared memory; the online softmax in fp32 registers in the log2
//     domain, exp2(s * scale log2 e - max) as one FFMA and the SFU's exp2;
//     O += bf16(P) V on wgmma with P in registers (the S accumulator is the
//     A fragment) and V as it lies (keys x channels: MN-major, the transpose
//     bit; no V transpose pass); the next chunk's QK is issued with the
//     previous chunk's P V, and the softmax runs under that P V;
//   * the epilogue writes o / l in bf16 into the warpgroup's own Q rows and
//     stores them by TMA (rows past Lq are not written), draining under the
//     next tile's first chunks.
//   setmaxnreg moves registers from the producer (40) to the consumers (232).
//   What holds it back on an H100 80GB HBM3 (tools/time_k4_k22.py; PERF.md):
//   it runs at 63-65% of the bf16 peak dense (14B 32,760^2: 35.3 ms, bound
//   22.2, SDPA 39.2) and 54-59% at the cross shapes, where a tile has four
//   chunks. The SFU's exp2 (one a score, quarter rate) and P's bf16 packing
//   sit beside the tensor cores' QK and P V, and the two consumers overlap
//   each other's products only as the warp scheduler interleaves them:
//   FlashAttention-3's turn barriers between them ran 29% slower here.
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
#include "hopper.cuh"

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

// K3: the chunks of the LUT row of this block's Q-block.
__global__ void __launch_bounds__(kThreads)
sparse_flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
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

  const int* lut_row = lut + (((long long)b * H + h) * nQ + row0 / block_q) * sel;
  const int per = block_k / kBN;
  const int n_chunks = sel * per;
  for (int c = 0; c < n_chunks; ++c) {
    const int key0 = lut_row[c / per] * block_k + (c % per) * kBN;
    // wholly past the tail (or an id out of range): no valid column
    if (key0 < 0 || key0 >= kv_len) continue;
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
// K4: k4::dense_fwd_kernel (warp-specialised, wgmma fed by TMA)
// ---------------------------------------------------------------------------

namespace k4 {

constexpr int kRows = 128;                 // query rows a tile: two warpgroups of 64
constexpr int kKeys = 128;                 // keys a chunk
constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kStages = 2;                 // K / V chunks in flight
constexpr int kQBufs = 2;                  // Q tiles in flight
constexpr int kThreadsK4 = 3 * kWG;        // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kRegs == 65536 / kThreadsK4 / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsK4,
              "setmaxnreg within the block's allocation");
constexpr int kBox = kRows * 128;          // 64 bf16 channels of 128 rows (one TMA box)
constexpr int kTile = 2 * kBox;            // 128 rows x 128 channels
constexpr int kBars = kQBufs * kTile + kStages * 2 * kTile;
// qfull, qempty a Q buffer; kfull, vfull, kempty, vempty a stage
constexpr int kSmem = kBars + (2 * kQBufs + 4 * kStages) * 8 + 1024;
static_assert(kSmem <= 232448, "one block an SM");
constexpr float kMaskedLogit = -__builtin_huge_valf();   // a key >= kv_len: p = 0

struct Params {
  int B, H, Lq, kv_len;
  float scale_log2;
};

// Grid: min(tiles, SMs) persistent blocks. A tile is 128
// query rows of one (b, h); tile t of the walk is (b, h) = t / n_tiles, rows
// 128 (t % n_tiles), and block x takes tiles x, x + grid, ... Producer
// thread 0 loads each tile's Q (two 64-channel boxes) into one of two Q
// buffers and each 128-key chunk's K and V (as they lie: keys x channels)
// into a 2-stage ring, running ahead across tiles. Each consumer warpgroup
// owns 64 rows of every tile: S = Q K^T on wgmma bf16 from shared memory,
// the online softmax in fp32 registers, O += bf16(P) V on wgmma with P in
// registers and V MN-major (the transpose bit), the next chunk's QK issued
// with the previous chunk's P V. The epilogue writes o / l as bf16 into the
// warpgroup's own Q rows (swizzled) and stores them by TMA; the Q buffer is
// released once that store has read it. Fragment of a consumer thread (warp
// w, lane l): register i holds row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l & 3) + (i & 1).
__global__ void __launch_bounds__(kThreadsK4, 1)
dense_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t st0 = base + kQBufs * kTile;     // stage s: K tile, then V tile
  const uint32_t qfull0 = base + kBars, qempty0 = qfull0 + 8 * kQBufs;
  const uint32_t kfull0 = qempty0 + 8 * kQBufs, vfull0 = kfull0 + 8 * kStages;
  const uint32_t kempty0 = vfull0 + 8 * kStages, vempty0 = kempty0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int n_tiles = (p.Lq + kRows - 1) / kRows;
  const int n_items = p.B * p.H * n_tiles;
  const int n_chunks = (p.kv_len + kKeys - 1) / kKeys;

  if (tid == 0) {
#pragma unroll 1
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(qempty0 + 8 * i, 2);   // both consumer warpgroups
    }
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
      // ---- loads; K and V maps end at kv_len: rows past it read as zeros ----
      int n = 0, c = 0;
#pragma unroll 1
      for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
        const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
        const int qb = n % kQBufs;
        if (n >= kQBufs) mbar_wait(qempty0 + 8 * qb, ((n / kQBufs) & 1) ^ 1);
        const uint32_t qd = base + qb * kTile, qbar = qfull0 + 8 * qb;
        mbar_arrive_expect_tx(qbar, kTile);
        tma_load_4d(&tm_q, qd, qbar, 0, h, tile * kRows, b);
        tma_load_4d(&tm_q, qd + kBox, qbar, 64, h, tile * kRows, b);
#pragma unroll 1
        for (int j = 0; j < n_chunks; ++j, ++c) {
          // K and V have barriers of their own: a chunk's K is free once
          // both consumers' QK has read it, a chunk before its V
          const int s = c % kStages, ph = ((c / kStages) & 1) ^ 1;
          const uint32_t kd = st0 + s * 2 * kTile, vd = kd + kTile;
          const uint32_t kbar = kfull0 + 8 * s, vbar = vfull0 + 8 * s;
          if (c >= kStages) mbar_wait(kempty0 + 8 * s, ph);
          mbar_arrive_expect_tx(kbar, kTile);
          tma_load_4d(&tm_k, kd, kbar, 0, h, j * kKeys, b);
          tma_load_4d(&tm_k, kd + kBox, kbar, 64, h, j * kKeys, b);
          if (c >= kStages) mbar_wait(vempty0 + 8 * s, ph);
          mbar_arrive_expect_tx(vbar, kTile);
          tma_load_4d(&tm_v, vd, vbar, 0, h, j * kKeys, b);
          tma_load_4d(&tm_v, vd + kBox, vbar, 64, h, j * kKeys, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;   // the warpgroup's row of registers with (i & 2) == 0

  float o[64], sc[64];
  uint32_t pa[32];

  // O += bf16(P) V of the chunk in stage s: V's keys are wgmma's K, its
  // channels N (MN-major): a 16-key step is two 8-row groups, 2048 bytes
  auto issue_pv = [&](int s, int cc) {
    mbar_wait(vfull0 + 8 * s, (cc / kStages) & 1);
    const uint32_t vb = st0 + s * 2 * kTile + kTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_bf16_rs<1>(o, pa + 4 * kk, sw128_desc_mn(vb + kk * 2048, kBox));
    wgmma_commit();
  };

  int n = 0, c = 0;   // tiles and chunks done: the producer's counts
  int pend = -1;      // the Q buffer whose O store has yet to be read
#pragma unroll 1
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
    const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
    const int qb = n % kQBufs;
    const uint32_t qbuf = base + qb * kTile, qa = qbuf + cw * 64 * 128;
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    int prev = -1;   // the stage of the chunk whose P V is pending
    mbar_wait(qfull0 + 8 * qb, (n / kQBufs) & 1);
#pragma unroll 1
    for (int j = 0; j < n_chunks; ++j, ++c) {
      const int s = c % kStages;
      const uint32_t kb = st0 + s * 2 * kTile;
      mbar_wait(kfull0 + 8 * s, (c / kStages) & 1);
      // S = Q K^T (64 rows x 128 keys, fp32); then the previous P V
      reg_fence<64>(o);
      reg_fence<32>(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_bf16_ss(sc, sw128_desc(qa + (kk >> 2) * kBox + (kk & 3) * 32),
                      sw128_desc(kb + (kk >> 2) * kBox + (kk & 3) * 32), kk > 0);
      wgmma_commit();
      if (prev >= 0) issue_pv(prev, c - 1);
      if (prev >= 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      reg_fence<64>(sc);
      if (lt == 0) mbar_arrive(kempty0 + 8 * s);   // this chunk's K is read
      if (j == 0 && pend >= 0) {
        // the previous tile's O store has read its Q buffer: release it
        // (after the wait: a divergent block inside the products' window
        // made ptxas serialize every wgmma)
        if (lt == 0) {
          tma_store_wait_read();
          mbar_arrive(qempty0 + 8 * pend);
        }
        pend = -1;
      }

      // the online softmax in the log2 domain: keys >= kv_len (only in the
      // last chunk; zeros by TMA) at -inf before the row max; the scale is
      // positive, so the row max of s times scale * log2 e is the max of
      // the scaled logits; p = exp2(s * scale_log2 - max), one FFMA and the
      // SFU's exp2
      const int nvalid = p.kv_len - j * kKeys;
      if (nvalid < kKeys) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sc[e] = kMaskedLogit;
      }
      float mx0 = row_tree<true, 0>(sc), mx1 = row_tree<true, 2>(sc);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * p.scale_log2), mn1 = fmaxf(m1, mx1 * p.scale_log2);
      const float alpha0 = ex2_approx(m0 - mn0), alpha1 = ex2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < 64; ++e)
        sc[e] = ex2_approx(fmaf(sc[e], p.scale_log2, (e & 2) ? -mn1 : -mn0));
      const float rs0 = row_tree<false, 0>(sc), rs1 = row_tree<false, 2>(sc);
      // the previous P V is done: its stage is free, O and P are ours
      wgmma_wait<0>();
      reg_fence<64>(o);
      reg_fence<32>(pa);
      if (prev >= 0 && lt == 0) mbar_arrive(vempty0 + 8 * prev);
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) o[e] *= (e & 2) ? alpha1 : alpha0;
      }
      // P as the A fragments of the 8 k16 steps: keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int e = 0; e < 32; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      prev = s;
    }
    // the last chunk's P V
    reg_fence<64>(o);
    reg_fence<32>(pa);
    wgmma_fence();
    issue_pv(prev, c - 1);
    wgmma_wait<0>();
    reg_fence<64>(o);
    reg_fence<32>(pa);
    if (lt == 0) mbar_arrive(vempty0 + 8 * prev);

    // o = O / max(l, 1e-20) in bf16, into this warpgroup's own Q rows (its
    // last QK is done) as the TMA store reads them: 16-byte chunk ch of row
    // r at ch ^ (r % 8); rows past Lq are not written
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
    unsigned char* orow = smem + (qa - base) + rl0 * 128 + 4 * t;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      unsigned char* at = orow + (jn >> 3) * kBox + (((jn & 7) ^ g) << 4);
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) =
          pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
    }
    fence_async_shared();
    named_sync(1 + cw, kWG);
    if (lt == 0) {
      const int r0 = tile * kRows + cw * 64;
      tma_store_4d(&tm_o, qa, 0, h, r0, b);
      tma_store_4d(&tm_o, qa + kBox, 64, h, r0, b);
      tma_store_commit();
    }
    pend = qb;
  }
  if (lt == 0) tma_store_wait_all();
}

int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
           int kv_len, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || kv_len <= 0) return (int)cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and strides
  const Strides st[4] = {qs, ks, vs, os};
  const void* ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (st[i].b % 8 || st[i].l % 8 || st[i].h % 8 || (uintptr_t)ptr[i] % 16)
      return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, dense_fwd_kernel);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs) return (int)cudaErrorInvalidConfiguration;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    return (int)cudaFuncSetAttribute(dense_fwd_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }();
  if (ready != 0) return ready;
  CUtensorMap tq, tk, tv, to;
  if (!bhld_map(&tq, q, B, Lq, H, qs.b, qs.l, qs.h, kRows) ||
      !bhld_map(&tk, k, B, kv_len, H, ks.b, ks.l, ks.h, kKeys) ||
      !bhld_map(&tv, v, B, kv_len, H, vs.b, vs.l, vs.h, kKeys) ||
      !bhld_map(&to, o, B, Lq, H, os.b, os.l, os.h, 64))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * H * ((Lq + kRows - 1) / kRows);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items > n_sm ? n_sm : (int)items;
  dense_fwd_kernel<<<grid, kThreadsK4, kSmem, (cudaStream_t)stream>>>(
      tq, tk, tv, to, Params{B, H, Lq, kv_len, scale * kLog2e});
  return (int)cudaGetLastError();
}

}  // namespace k4

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
  sparse_flash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
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
  return k4::launch(q, k, v, o, B, H, Lq, kv_len, Strides{qsb, qsl, qsh},
                    Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, Strides{osb, osl, osh},
                    scale, stream);
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
