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
// ~1.0e11 FLOPs, all well above the ridge (K14's q in and int8 out are
// 150 MB, 0.045 ms at 3.35 TB/s).
//
// K3 takes two forms by its blocks (`k3_form`; ops/flash_attention.py
// `sparse_flash_form`). At blocks that are multiples of 128 (the paths'
// 512/256) it is K4's kernel with its chunk walk a template form,
// `k4::flash_fwd_kernel<1>` (below): a 128-row tile lies in one Q block
// and reads LUT row tile * 128 / block_q; the producer and both consumers
// walk the same list of 128-key chunks (each LUT entry in order, an id
// outside [0, nK) skipped, the chunks of its block that start before
// kv_len); the blocks walk the tiles of one head in turn, so the four tiles
// of a 512-row Q block read the same K / V chunks, and the head's K and V
// (16.8 MB at 480p), from L2; a LUT row with no live chunk gives zero rows.
// At the other multiples of 64 (`sla` at --sla_block 64: 512/64) it is
// `sparse_flash_fwd_kernel`, FlashAttention-2 on mma.sync m16n8k16 (bf16
// in, fp32 accumulate):
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
// head-dim padding are carried over by neither form: both read (B, L, H, Dh)
// through strides, walk exactly the LUT's entries, skip the chunks that lie
// wholly past kv_len, read rows past kv_len as zeros, mask columns >= kv_len
// before the row max, and never write rows past Lq. On an H100 80GB HBM3
// (tools/time_k3_k28.py, PERF.md) the wgmma form takes 1.05 ms at the 1.3B
// 480p `sla` call (12 of 128 K blocks; bound 0.63) and 3.41 ms at the 14B's
// (2.08), 63-68% of the bf16 peak like K4's; the mma.sync form at 512/64
// 4.41 ms (17%).
//
// K4 (`k4::flash_fwd_kernel<0>`) is Hopper's warp-specialised attention
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
//   setmaxnreg moves registers from the producer (24) to the consumers (240).
//   What holds it back on an H100 80GB HBM3 (tools/time_k4_k22.py; PERF.md):
//   it runs at 63-65% of the bf16 peak dense (14B 32,760^2: 35.3 ms, bound
//   22.2, SDPA 39.2) and 54-59% at the cross shapes, where a tile has four
//   chunks. The SFU's exp2 (one a score, quarter rate) and P's bf16 packing
//   sit beside the tensor cores' QK and P V, and the two consumers overlap
//   each other's products only as the warp scheduler interleaves them:
//   FlashAttention-3's turn barriers between them ran 29% slower here.
//
// K14 / K17 (`k14::cross_qout_kernel`) need two things a CUDA block cannot
// carry across the grid the way the TPU's sequential grid carries its o
// scratch: the RMS of the whole H*128-wide row before any head's QK, and the
// |o| max over every head's output before any int8 store. So the C = H / G
// blocks that own one 64-row tile (G heads each, C <= 8) run as one
// thread-block cluster: K14's blocks sum the squares of their G heads'
// columns and read the others' partial sums through distributed shared
// memory (K17 reads K15's RMS instead); each block keeps its heads' fp32 o
// on chip and the rows' |o| maxima meet the same way before any int8 store
// (1.3B: clusters of 3 blocks of 4 heads; 14B: 8 of 5). A block is Hopper's
// warp-specialised shape, K4's in its parts:
//   * a producer warpgroup: warp 0 and warp 1 each TMA-load one consumer's
//     64-key K and V chunks (64 channels a box, 128-byte swizzle; the maps
//     end at kv_len, so keys past it read as zeros) into that consumer's
//     ring of mbarrier-guarded 16 KB stages (4 stages, 2 at 5 heads a
//     block), the first chunks before the row statistics; warp 2 TMA-loads
//     each head's raw q rows into one of two Q tiles (one at 5 heads a
//     block), the next head's under this head's work, where each consumer
//     norms its 32 rows in place, bf16(bf16(x * rms) * w): the swizzled A
//     tile of S = Q K^T;
//   * two consumer warpgroups share the block's 64 rows and split the keys
//     (512: 256 each): each computes its S chunks on wgmma m64n64k16 (bf16,
//     both operands in shared memory) and holds them in registers (128
//     fp32 a thread), so every logit is computed once; the two exchange
//     their 64 row maxima through shared memory (a named barrier), so P =
//     exp(s - max) uses the exact row max over all kv_len keys, as the
//     TPU kernel's single K/V tile does (an online max would round bf16(P)
//     at another max); P = exp2(s * scale log2 e - max), one FFMA and the
//     SFU's exp2, its fp32 row sum over the unrounded P, and O += bf16(P) V
//     on wgmma with P in registers and V as it lies (MN-major: no
//     transpose), a chunk's softmax under the previous chunk's P V;
//   * the consumers' partial O and row sums meet in the head's fp32 o slot
//     in shared memory (each writes its partial of the other's 64 channels
//     and finishes its own: o = (O + O') / (l + l')); the last head's o
//     stays in registers (its meeting place: the first stage of each ring,
//     which no load refills), so 5 heads take 4 slots (128 KB) beside the
//     Q tile and the rings (217,680 bytes at 5 heads);
//   * the int8 feed: scale = max(|o| max over all H heads, 1e-8) / 127 (the
//     producer reduces it over the cluster), int8 = round-half-even(o * (1 /
//     scale)) clipped to +-127: the slots by 16-byte stores, the last head
//     from the registers.
//   Above 512 keys (4 chunks a consumer) the same kernel takes two passes:
//   the first over K for the exact row max, the second computes S again
//   for P V (any kv_len; the paths' text is 512 keys).
//   setmaxnreg moves registers from the producer (24) to the consumers (240).
//   What bounds it on an H100: tensor-core math, 4 B H Lq Lk 128 operations
//   (1.3B: 1.03e11, 0.104 ms at 989 TFLOP/s; 14B 3.43e11, 0.347 ms).
// K20 tdx_sparse_flash_attention_i8qk replaces the int8-QK sparse branch of
//    flash_pallas.py:_flash_fwd_impl for blocks < 128 (body
//    _sparse_attn_kernel with int8_qk=True), which sagesla at --sla_block 64
//    takes: K3's gather, with Q quantised per row once (qq = round(q * (127 /
//    qa)), qa = max(max |q|, 1e-6)) and every gathered K row the same way, so
//    QK runs on int8 tensor cores (exact s32) and s = ((s32 * (qa / 127)) *
//    (ka / 127)) * Dh^-0.5; natural exp (the TPU kernel's domain; the kernel
//    folds log2 e into the row's scale and takes exp2), P in bf16 against
//    bf16 V, o = O / max(l, 1e-20). The caller subtracts K's mean first
//    (smooth-k, plain torch). A row's int8 values do not depend on the block
//    that reads it, so two first launches (`i8qk_quant_kernel`, a warp a
//    row) quantise q's rows and k's rows before kv_len once into (B, H,
//    L64, 128) int8 panels and their scales (rows padded to multiples of 64
//    with zeros), where the TPU kernel requantises each gathered block (at
//    64/64 each K row is gathered by ~51 Q blocks). Then K4's kernel in its
//    third form, `k4::flash_fwd_kernel<2>`, for any blocks that are
//    multiples of 64 (`k20_form`): at 64/64 two neighbouring 64-row tiles
//    lie in two Q blocks with two LUT rows, so a block runs two streams of
//    64-row tiles, one a consumer warpgroup, each with its own producer
//    thread, Q buffers, 3-stage ring of 64-key chunks and mbarriers (one
//    block an SM, persistent, the streams' tiles walked in head order); the
//    producer TMA-loads the int8 Q tile, each chunk's int8 K rows (64 x 128
//    bytes) and, by a bulk copy on the same barrier, their 64 scales, and
//    its bf16 V (64 keys x 128 channels as it lies, the map ending at
//    kv_len); the consumer runs S on wgmma m64n64k32 s8 -> s32, multiplies
//    each column by its key's scale in fp32 before the row max (a scale a
//    key: the max of the integer sums is not the max of the scores), keys
//    >= kv_len selected to -inf, p = exp2(S * qa scale log2 e - max), and P
//    V on wgmma m64n128k16 bf16 with P in registers (4 k-steps a chunk);
//    O goes out by TMA from the tile's Q buffer.
//    What bounds it on an H100: not the tensor cores (at 64/64 and 1.3B
//    480p, 51 of 512 K blocks a Q block: 3.3e11 int8 + 3.3e11 bf16
//    operations, 0.50 ms) but the gather: every 64-row tile reads its 51
//    chunks' 8 KB of int8 K and 16 KB of bf16 V, ~7.5 GB a call, which
//    the 50 MB L2 serves (a head's int8 K and bf16 V are 12.6 MB and the
//    blocks at work share a head); JAX's LUT padding to a group (block nK,
//    past K's end) has no counterpart: the walk takes exactly the LUT's
//    entries.
// K30 tdx_flash_attention_i8qk replaces the dense branch of _flash_fwd_impl
//    with int8 QK (launch :1139, body _attn_kernel with int8_qk=True), which
//    flash_attention(..., int8_qk=True) without a LUT takes: K20's function
//    over every key of [0, kv_len). The caller subtracts K's mean first, as
//    JAX's flash_attention does. No path reaches it, in JAX either. Two first
//    launches (`i8qk_quant_kernel`) quantise q's rows and k's rows before
//    kv_len once, padded with zero rows to 128 and to the chunk; then K4's
//    kernel in its fourth form, `k4::flash_fwd_kernel<3>`: K4's dense walk
//    and geometry (one stream of 128-row tiles shared by the two consumer
//    warpgroups, persistent blocks walking tiles in head order) with K20's
//    int8 arithmetic: the producer TMA-loads the tile's int8 Q (128 rows x
//    128 bytes), each chunk's int8 K rows and, by a bulk copy on the same
//    barrier, their scales, and its bf16 V as it lies (MN-major, the map
//    ending at kv_len); S on wgmma s8 -> s32 (both operands K-major), each
//    column times its key's scale in fp32 before the row max, keys >= kv_len
//    selected to -inf, p = exp2(S * qa scale log2 e - max), P V on wgmma
//    m64n128k16 bf16 with P in registers; O goes out by TMA through the Q
//    buffer. The two consumers issue a chunk's products in turns (named
//    barriers, FlashAttention-3's ping-pong), each handing the turn on once
//    its QK is done. The chunk (kDenseI8Keys int8 keys), the ring's depth
//    and the turns were chosen on the card (tools/time_k30.py --design;
//    PERF.md): 9.5 ms at the shape below on an H100 80GB HBM3, K4's bf16
//    10.1-10.5 beside it.
//    What bounds it on an H100: tensor-core math, at the 1.3B 480p dense
//    self shape (12 heads, 32,760 x 32,760) 3.3e12 int8 operations (1.67 ms
//    at 1,979 TOP/s) and 3.3e12 bf16 (3.33 ms at 989 TFLOP/s): 5.0 ms; with
//    int8 QK the softmax's per-score work (the key's scale, the SFU's exp2,
//    one a score, 1.3e10) sits closer to the products than in K4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_step.cuh"
#include "chunk_walk.cuh"
#include "hopper.cuh"

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
// K4, K3 and K20: k4::flash_fwd_kernel<FORM> (warp-specialised, wgmma fed by
// TMA)
// ---------------------------------------------------------------------------

namespace k4 {

// the kernel's forms
constexpr int kDense = 0;      // K4: every chunk of [0, kv_len)
constexpr int kSparse = 1;     // K3: the chunks of the tile's LUT row
constexpr int kSparseI8 = 2;   // K20: K3's walk with int8 QK, 64-row tiles, 64-key chunks
constexpr int kDenseI8 = 3;    // K30: K4's walk with int8 QK
// K30's int8 keys a chunk and chunks in flight (tools/time_k30.py --design)
constexpr int kDenseI8Keys = 128, kDenseI8Stages = 2;

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kQBufs = 2;                  // Q tiles in flight a stream
constexpr int kThreadsK4 = 3 * kWG;        // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kRegs == 65536 / kThreadsK4 / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsK4,
              "setmaxnreg within the block's allocation");
constexpr float kMaskedLogit = -__builtin_huge_valf();   // a key >= kv_len: p = 0

// A form's tiles and shared memory. A block runs kStreams streams of
// tiles, each with its own Q buffers, ring and barriers: K4 / K3 / K30 one
// stream of 128-row tiles that both consumer warpgroups share (64 rows
// each, one chunk walk), K20 two streams of 64-row tiles, one a consumer (at
// blocks 64/64 two neighbouring 64-row tiles lie in two Q blocks and walk
// two LUT rows).
template <int FORM>
struct Plan {
  static constexpr bool kI8 = FORM == kSparseI8 || FORM == kDenseI8;   // int8 Q and K
  static constexpr bool kLut = FORM == kSparse || FORM == kSparseI8;   // the LUT's walk
  static constexpr int kStreams = FORM == kSparseI8 ? 2 : 1;
  static constexpr int kCons = 2 / kStreams;         // consumer warpgroups a stream
  static constexpr int kRows = 64 * kCons;           // query rows a tile
  static constexpr int kKeys =                       // keys a chunk
      FORM == kSparseI8 ? 64 : FORM == kDenseI8 ? kDenseI8Keys : 128;
  static constexpr int kStages =                     // chunks in flight a stream
      FORM == kSparseI8 ? 3 : FORM == kDenseI8 ? kDenseI8Stages : 2;
  static constexpr int kOBox = kRows * 128;          // 64 channels of a tile's rows
  // a Q buffer: the tile's Q (bf16 in two 64-channel boxes; K20 / K30: int8
  // rows of 128 bytes), then its bf16 O as the TMA store reads it
  static constexpr int kQTile = 2 * kOBox;
  static constexpr int kQBytes = kI8 ? kRows * 128 : kQTile;
  static constexpr int kKVBox = kKeys * 128;         // 64 channels of a chunk's bf16 K or V
  static constexpr int kKTile = kI8 ? kKeys * 128 : 2 * kKVBox;   // a chunk's K
  static constexpr int kStage = kKTile + 2 * kKVBox;
  static constexpr int kStream = kQBufs * kQTile + kStages * kStage;
  // K20 / K30: each stage's per-key K scales, after the streams
  static constexpr int kScaleBytes = kI8 ? kKeys * 4 : 0;
  static constexpr int kBarsAt = kStreams * (kStream + kStages * kScaleBytes);
  // qfull, qempty a Q buffer; kfull, vfull, kempty, vempty a stage
  static constexpr int kBarsA = 2 * kQBufs + 4 * kStages;
  static constexpr int kSmem = kBarsAt + kStreams * kBarsA * 8 + 1024;
  static_assert(kSmem <= 232448, "one block an SM");
};

struct Params {
  int B, H, Lq, kv_len;
  float scale_log2;
  // K3 / K20: the LUT (B, H, nQ, sel) of K-block ids, block_q query rows a
  // Q block, block_k keys a K block, nK = ceil(kv_len / block_k) K blocks
  // that hold a key before kv_len
  const int* lut;
  int nQ, sel, block_q, block_k, nK;
  // K20 / K30: the int8 rows' scales (absmax / 127) of q (B, H, Lqp) and k
  // (B, H, Lkp), rows padded to the tile and the chunk
  const float* qsc;
  const float* ksc;
  int Lqp, Lkp;
};

// The chunks one tile attends to (chunk_walk.cuh): dense (K4, K30) every
// chunk of [0, kv_len), sparse (K3, K20) the chunks of the tile's LUT row.
template <int FORM>
using Walk = ChunkWalk<Plan<FORM>::kLut, Plan<FORM>::kRows, Plan<FORM>::kKeys>;

// Grid: persistent blocks, at most one an SM. A tile is kRows query rows of
// one (b, h) (K3 / K20: inside one Q block, block_q a multiple of kRows);
// tile t of the walk is (b, h) = t / n_tiles, rows kRows (t % n_tiles), and
// stream s of block x takes tiles kStreams x + s, + kStreams grid, ... (the
// blocks at work share a head's K and V in L2). The producer thread of
// stream s (lane 0 of producer warp s) loads each tile's Q into one of two
// Q buffers and each chunk of its Walk's K and V (as they lie: keys x
// channels) into the stream's ring, running ahead across tiles. Each
// consumer warpgroup owns 64 rows of its stream's tiles: S = Q K^T on wgmma
// from shared memory (K4 / K3 bf16; K20 / K30 int8 -> exact s32, times the
// key's scale), the online softmax in fp32 registers, O += bf16(P) V on wgmma
// with P in registers and V MN-major (the transpose bit), the next chunk's
// QK issued with the previous chunk's P V. The epilogue writes o / l as
// bf16 into the warpgroup's own Q rows (swizzled) and stores them by TMA;
// the Q buffer is released once that store has read it. Fragment of a
// consumer thread (warp w, lane l): register i holds row 16 w + l / 4 + 8
// ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
template <int FORM>
__global__ void __launch_bounds__(kThreadsK4, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const Params p) {
  using P = Plan<FORM>;
  constexpr bool I8 = P::kI8;
  constexpr int kRows = P::kRows, kKeys = P::kKeys, kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int n_tiles = (p.Lq + kRows - 1) / kRows;
  const int n_items = p.B * p.H * n_tiles;
  // stream sm: its Q buffers, its stages (K tile, then V tile), K20's and
  // K30's scales of each stage, its barriers
  auto qbuf0 = [&](int sm) { return base + sm * P::kStream; };
  auto stage0 = [&](int sm) { return base + sm * P::kStream + kQBufs * P::kQTile; };
  auto scales0 = [&](int sm) {
    return base + P::kStreams * P::kStream + sm * kStages * P::kScaleBytes;
  };
  auto bars0 = [&](int sm) { return base + P::kBarsAt + sm * P::kBarsA * 8; };
  // K20 / K30: each consumer warp releases a chunk's K (it reads the
  // chunk's scales itself); K4 / K3: one thread a warpgroup
  constexpr int kKArrivals = I8 ? 4 * P::kCons : P::kCons;
  // K30: the two consumers issue each chunk's products in turns (named
  // barriers kTurnBar + consumer), so that one's softmax runs under the
  // other's products (FlashAttention-3's ping-pong: 11.5 -> 9.4 ms on an
  // H100; no gain for K4, tools/time_k30.py --design)
  constexpr bool kTurns = FORM == kDenseI8;
  constexpr int kTurnBar = 3;

  if (tid == 0) {
#pragma unroll 1
    for (int sm = 0; sm < P::kStreams; ++sm) {
      const uint32_t b0 = bars0(sm);
#pragma unroll 1
      for (int i = 0; i < kQBufs; ++i) {
        mbar_init(b0 + 8 * i, 1);                          // qfull
        mbar_init(b0 + 8 * (kQBufs + i), P::kCons);        // qempty
      }
#pragma unroll 1
      for (int s = 0; s < kStages; ++s) {
        const uint32_t kf = b0 + 16 * kQBufs + 8 * s;
        mbar_init(kf, 1);                                  // kfull
        mbar_init(kf + 8 * kStages, 1);                    // vfull
        mbar_init(kf + 16 * kStages, kKArrivals);          // kempty
        mbar_init(kf + 24 * kStages, P::kCons);            // vempty
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if ((tid & 31) == 0 && tid / 32 < P::kStreams) {
      // ---- loads; K4's and K3's K and V maps end at kv_len (K20's and
      // K30's V map; their int8 K rows past it are zeros): rows past it
      // read as zeros ----
      const int sm = tid / 32;
      const uint32_t qfull0 = bars0(sm), qempty0 = qfull0 + 8 * kQBufs;
      const uint32_t kfull0 = qempty0 + 8 * kQBufs, vfull0 = kfull0 + 8 * kStages;
      const uint32_t kempty0 = vfull0 + 8 * kStages, vempty0 = kempty0 + 8 * kStages;
      int n = 0, c = 0;
#pragma unroll 1
      for (int it = blockIdx.x * P::kStreams + sm; it < n_items;
           it += gridDim.x * P::kStreams, ++n) {
        const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
        const int qb = n % kQBufs;
        if (n >= kQBufs) mbar_wait(qempty0 + 8 * qb, ((n / kQBufs) & 1) ^ 1);
        const uint32_t qd = qbuf0(sm) + qb * P::kQTile, qbar = qfull0 + 8 * qb;
        mbar_arrive_expect_tx(qbar, P::kQBytes);
        if constexpr (I8) {
          tma_load(&tm_q, qd, qbar, 0, bh * p.Lqp + tile * kRows);
        } else {
          tma_load_4d(&tm_q, qd, qbar, 0, h, tile * kRows, b);
          tma_load_4d(&tm_q, qd + P::kOBox, qbar, 64, h, tile * kRows, b);
        }
        Walk<FORM> walk(p, b, h, tile);
#pragma unroll 1
        for (int key0 = walk.next(p); key0 >= 0; key0 = walk.next(p), ++c) {
          // K and V have barriers of their own: a chunk's K is free once
          // its consumers' QK has read it, a chunk before its V
          const int s = c % kStages, ph = ((c / kStages) & 1) ^ 1;
          const uint32_t kd = stage0(sm) + s * P::kStage, vd = kd + P::kKTile;
          const uint32_t kbar = kfull0 + 8 * s, vbar = vfull0 + 8 * s;
          if (c >= kStages) mbar_wait(kempty0 + 8 * s, ph);
          if constexpr (I8) {
            // the chunk's int8 K rows and their scales
            mbar_arrive_expect_tx(kbar, P::kKTile + P::kScaleBytes);
            tma_load(&tm_k, kd, kbar, 0, bh * p.Lkp + key0);
            bulk_load(scales0(sm) + s * P::kScaleBytes, p.ksc + (size_t)bh * p.Lkp + key0,
                      P::kScaleBytes, kbar);
          } else {
            mbar_arrive_expect_tx(kbar, P::kKTile);
            tma_load_4d(&tm_k, kd, kbar, 0, h, key0, b);
            tma_load_4d(&tm_k, kd + P::kKVBox, kbar, 64, h, key0, b);
          }
          if (c >= kStages) mbar_wait(vempty0 + 8 * s, ph);
          mbar_arrive_expect_tx(vbar, 2 * P::kKVBox);
          tma_load_4d(&tm_v, vd, vbar, 0, h, key0, b);
          tma_load_4d(&tm_v, vd + P::kKVBox, vbar, 64, h, key0, b);
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
  const int sm = P::kStreams == 1 ? 0 : cw;      // this consumer's stream (folds to 0)
  const int row_off = (cw % P::kCons) * 64;      // its rows in the stream's tiles
  const uint32_t qfull0 = bars0(sm), qempty0 = qfull0 + 8 * kQBufs;
  const uint32_t kfull0 = qempty0 + 8 * kQBufs, vfull0 = kfull0 + 8 * kStages;
  const uint32_t kempty0 = vfull0 + 8 * kStages, vempty0 = kempty0 + 8 * kStages;
  const uint32_t st0 = stage0(sm);

  float o[64], sc[kKeys / 2];
  int si[I8 ? kKeys / 2 : 1];   // K20 / K30: S as exact s32
  uint32_t pa[kKeys / 4];

  // O += bf16(P) V of the chunk in stage s: V's keys are wgmma's K, its
  // channels N (MN-major): a 16-key step is two 8-row groups, 2048 bytes
  auto issue_pv = [&](int s, int cc) {
    mbar_wait(vfull0 + 8 * s, (cc / kStages) & 1);
    const uint32_t vb = st0 + s * P::kStage + P::kKTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_bf16_rs<1>(o, pa + 4 * kk, sw128_desc_mn(vb + kk * 2048, P::kKVBox));
    wgmma_commit();
  };

  int n = 0, c = 0;   // tiles and chunks done: the producer's counts
  int pend = -1;      // the Q buffer whose O store has yet to be read
  if constexpr (kTurns)
    if (cw == 1) named_arrive(kTurnBar, 2 * kWG);   // consumer 0 goes first
#pragma unroll 1
  for (int it = blockIdx.x * P::kStreams + sm; it < n_items;
       it += gridDim.x * P::kStreams, ++n) {
    const int tile = it % n_tiles, bh = it / n_tiles, h = bh % p.H, b = bh / p.H;
    const int qb = n % kQBufs;
    const uint32_t qbuf = qbuf0(sm) + qb * P::kQTile, qa = qbuf + row_off * 128;
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // the logits times log2 e are S times mul (K4 / K3: scale * log2 e;
    // K20 / K30: the row's int8 scale times that, S already times the key's)
    float mul0 = p.scale_log2, mul1 = p.scale_log2;
    if constexpr (I8) {
      const float* qsr = p.qsc + (size_t)bh * p.Lqp + tile * kRows + row_off + rl0;
      mul0 = __ldg(qsr) * p.scale_log2;
      mul1 = __ldg(qsr + 8) * p.scale_log2;
    }
    int prev = -1;   // the stage of the chunk whose P V is pending
    mbar_wait(qfull0 + 8 * qb, (n / kQBufs) & 1);
    Walk<FORM> walk(p, b, h, tile);
#pragma unroll 1
    for (int key0 = walk.next(p); key0 >= 0; key0 = walk.next(p), ++c) {
      const int s = c % kStages;
      const uint32_t kb = st0 + s * P::kStage;
      mbar_wait(kfull0 + 8 * s, (c / kStages) & 1);
      if constexpr (kTurns) named_sync(kTurnBar + cw, 2 * kWG);   // my turn
      // S = Q K^T (64 rows x the chunk's keys); then the previous P V
      reg_fence<64>(o);
      reg_fence<kKeys / 4>(pa);
      wgmma_fence();
      if constexpr (I8 && kKeys == 64) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_n64(si, sw128_desc(qa + kk * 32), sw128_desc(kb + kk * 32), kk > 0);
      } else if constexpr (I8) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(si, sw128_desc(qa + kk * 32), sw128_desc(kb + kk * 32), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_bf16_ss(sc, sw128_desc(qa + (kk >> 2) * P::kOBox + (kk & 3) * 32),
                        sw128_desc(kb + (kk >> 2) * P::kKVBox + (kk & 3) * 32), kk > 0);
      }
      wgmma_commit();
      if (prev >= 0) issue_pv(prev, c - 1);
      if (prev >= 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      // the other consumer's turn, once this one's QK is done (a barrier
      // inside the products' window made ptxas serialize every wgmma)
      if constexpr (kTurns) named_arrive(kTurnBar + 1 - cw, 2 * kWG);
      if constexpr (I8) {
        // S = s32 (exact, |s| < 2^22) times the key's scale, in fp32: the
        // row max is taken on these, since each key has a scale of its own
        reg_fence<kKeys / 2>(si);
        const float* ks = reinterpret_cast<const float*>(
            smem + (scales0(sm) - base) + s * P::kScaleBytes);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float2 k2 = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * t);
          sc[4 * j] = s32_float(si[4 * j]) * k2.x;
          sc[4 * j + 1] = s32_float(si[4 * j + 1]) * k2.y;
          sc[4 * j + 2] = s32_float(si[4 * j + 2]) * k2.x;
          sc[4 * j + 3] = s32_float(si[4 * j + 3]) * k2.y;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(kempty0 + 8 * s);   // this warp is done with the K stage
      } else {
        reg_fence<64>(sc);
        if (lt == 0) mbar_arrive(kempty0 + 8 * s);     // this chunk's K is read
      }
      if (pend >= 0) {
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
      // last chunk) at -inf before the row max, selected, never added (a
      // poisoned tail cannot reach a live row); mul is positive, so the row
      // max of S times mul is the max of the scaled logits; p = exp2(S mul
      // - max), one FFMA and the SFU's exp2
      const int nvalid = p.kv_len - key0;
      if (nvalid < kKeys) {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e)
          if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sc[e] = kMaskedLogit;
      }
      float mx0 = row_tree<true, 0>(sc), mx1 = row_tree<true, 2>(sc);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * mul0), mn1 = fmaxf(m1, mx1 * mul1);
      const float alpha0 = ex2_approx(m0 - mn0), alpha1 = ex2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e)
        sc[e] = ex2_approx(fmaf(sc[e], (e & 2) ? mul1 : mul0, (e & 2) ? -mn1 : -mn0));
      const float rs0 = row_tree<false, 0>(sc), rs1 = row_tree<false, 2>(sc);
      // the previous P V is done: its stage is free, O and P are ours
      wgmma_wait<0>();
      reg_fence<64>(o);
      reg_fence<kKeys / 4>(pa);
      if (prev >= 0 && lt == 0) mbar_arrive(vempty0 + 8 * prev);
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) o[e] *= (e & 2) ? alpha1 : alpha0;
      }
      // P as the A fragments of the k16 steps: keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int e = 0; e < kKeys / 4; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
      prev = s;
    }
    // the last chunk's P V (K3 / K20: a LUT row with no chunk before kv_len
    // has none, and its rows are 0 / max(0, 1e-20) = 0)
    if (prev >= 0) {
      reg_fence<64>(o);
      reg_fence<kKeys / 4>(pa);
      wgmma_fence();
      issue_pv(prev, c - 1);
      wgmma_wait<0>();
      reg_fence<64>(o);
      reg_fence<kKeys / 4>(pa);
      if (lt == 0) mbar_arrive(vempty0 + 8 * prev);
    }
    if (pend >= 0) {
      // no chunk released the previous tile's Q buffer: release it now
      if (lt == 0) {
        tma_store_wait_read();
        mbar_arrive(qempty0 + 8 * pend);
      }
      pend = -1;
    }

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
      unsigned char* at = orow + (jn >> 3) * P::kOBox + (((jn & 7) ^ g) << 4);
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) =
          pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
    }
    fence_async_shared();
    named_sync(1 + cw, kWG);
    if (lt == 0) {
      const int r0 = tile * kRows + row_off;
      tma_store_4d(&tm_o, qa, 0, h, r0, b);
      tma_store_4d(&tm_o, qa + P::kOBox, 64, h, r0, b);
      tma_store_commit();
    }
    pend = qb;
  }
  if constexpr (kTurns)
    if (cw == 0) named_sync(kTurnBar, 2 * kWG);   // consumer 1's last turn
  if (lt == 0) tma_store_wait_all();
}

// K4 (kDense), K3 (kSparse, over the LUT (B, H, ceil(Lq / block_q), sel)),
// K20 (kSparseI8: the LUT, and q's and k's int8 rows qi (B, H, Lqp, 128)
// and ki (B, H, Lkp, 128) with their scales, Lqp = Lq and Lkp = kv_len
// padded to the form's tile rows and chunk keys; q and k are then read
// through these, not their maps) or K30 (kDenseI8: no LUT, the int8 rows)
template <int FORM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
           int kv_len, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           const int* lut, int sel, int block_q, int block_k, void* stream,
           const void* qi = nullptr, const float* qsc = nullptr, const void* ki = nullptr,
           const float* ksc = nullptr) {
  using P = Plan<FORM>;
  if (B <= 0 || H <= 0 || Lq <= 0 || kv_len <= 0) return (int)cudaErrorInvalidValue;
  if (P::kLut && (block_q <= 0 || block_q % P::kRows || block_k <= 0 ||
                  block_k % P::kKeys || sel < 0 || !lut))
    return (int)cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and strides
  const Strides st[4] = {qs, ks, vs, os};
  const void* ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (st[i].b % 8 || st[i].l % 8 || st[i].h % 8 || (uintptr_t)ptr[i] % 16)
      return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, flash_fwd_kernel<FORM>);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs) return (int)cudaErrorInvalidConfiguration;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    return (int)cudaFuncSetAttribute(flash_fwd_kernel<FORM>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  }();
  if (ready != 0) return ready;
  const int n_tiles = (Lq + P::kRows - 1) / P::kRows;
  const int Lqp = n_tiles * P::kRows, Lkp = (kv_len + P::kKeys - 1) / P::kKeys * P::kKeys;
  CUtensorMap tq, tk, tv, to;
  const bool maps =
      (P::kI8 ? tile_map(&tq, qi, false, (long long)B * H * Lqp, kDh, P::kRows) &&
                    tile_map(&tk, ki, false, (long long)B * H * Lkp, kDh, P::kKeys)
              : bhld_map(&tq, q, B, Lq, H, qs.b, qs.l, qs.h, P::kRows) &&
                    bhld_map(&tk, k, B, kv_len, H, ks.b, ks.l, ks.h, P::kKeys)) &&
      bhld_map(&tv, v, B, kv_len, H, vs.b, vs.l, vs.h, P::kKeys) &&
      bhld_map(&to, o, B, Lq, H, os.b, os.l, os.h, 64);
  if (!maps || (P::kI8 && (!qsc || !ksc || (uintptr_t)ksc % 16)))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * H * n_tiles;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long long blocks = (items + P::kStreams - 1) / P::kStreams;
  const int grid = blocks > n_sm ? n_sm : (int)blocks;
  const Params p{B, H, Lq, kv_len, scale * kLog2e, lut,
                 P::kLut ? (Lq + block_q - 1) / block_q : 0, sel, block_q, block_k,
                 P::kLut ? (kv_len + block_k - 1) / block_k : 0,
                 qsc, ksc, Lqp, Lkp};
  flash_fwd_kernel<FORM><<<grid, kThreadsK4, P::kSmem, (cudaStream_t)stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace k4

// ---------------------------------------------------------------------------
// K20 and K30: the int8 rows
// ---------------------------------------------------------------------------

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

// K20's and K30's first launches: rows l < Lpad of x (b, l, h), read through
// strides (rows at or past nrows as zeros), -> int8 xq (B, H, Lpad, 128) and
// amax / 127 (B, H, Lpad) by quant_row4_i8 (a warp a row), so the kernels
// read the values the TPU kernel computes for each Q block and each gathered
// K block: q's rows and k's rows before kv_len, padded with zero rows to the
// form's tile rows and chunk keys (K20: 64 and 64; K30: 128 and its chunk).
__global__ void __launch_bounds__(256)
i8qk_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ xsc, int nrows, int Lpad, Strides xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (l >= Lpad) return;
  const uint2 u = l < nrows ? *reinterpret_cast<const uint2*>(x + b * xs.b + h * xs.h +
                                                              l * xs.l + lane * 4)
                            : make_uint2(0, 0);
  float sc;
  const uint32_t w = quant_row4_i8(u, sc);
  const size_t row = ((size_t)b * gridDim.y + h) * Lpad + l;
  *reinterpret_cast<uint32_t*>(xq + row * kDh + lane * 4) = w;
  if (lane == 0) xsc[row] = sc;
}

int launch_i8qk_quant(const void* x, void* xq, void* xsc, int B, int H, int nrows, int Lpad,
                      Strides xs, void* stream) {
  i8qk_quant_kernel<<<dim3((Lpad + 7) / 8, H, B), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xsc, nrows, Lpad, xs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14 / K17: k14::cross_qout_kernel (warp-specialised, wgmma fed by TMA)
// ---------------------------------------------------------------------------

namespace k14 {

constexpr int kRows = 64;                   // query rows a block
constexpr int kChunk = 64;                  // keys a chunk (one ring stage)
constexpr int kHeld = 4;                    // chunks a consumer holds as S (256 keys)
constexpr int kWG = 128;                    // threads of a warpgroup
constexpr int kThreadsQ = 3 * kWG;          // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kRegs == 65536 / kThreadsQ / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsQ,
              "setmaxnreg within the block's allocation");
constexpr int kBox = kChunk * 128;          // 64 bf16 channels of 64 rows (one TMA box)
constexpr int kTile = 2 * kBox;             // 64 rows x 128 channels bf16: Q, a K or V chunk
constexpr int kSlot = kRows * kDh * 4;      // a head's fp32 o, 64 x 128
constexpr int kMaxGroup = 5, kMaxCluster = 8, kMaxStages = 4;
// the per-row statistics and the mbarriers, in static shared memory (fixed
// addresses: no register holds them)
struct RowSmem {
  float ss[kRows], row[kRows];   // partial sum of squares; the row's RMS inverse
  float mx[4][kRows];            // row max [head parity x 2 + consumer]
  float l[4][kRows];             // row sums [head parity x 2 + consumer]
  float amx[2][kRows];           // |o| max [consumer]
  float inv[kRows];              // 1 / the int8 scale
  // full / empty of each stage of each sub-ring; qempty and xfull (the raw
  // q tile) of two Q tiles; the scales
  unsigned long long bars[4 * kMaxStages + 5];
};
// dynamic shared memory: the block's 227 KB less a 4 KB allowance for the
// static (RowSmem's 3,496 bytes and what the compiler adds)
constexpr int kSmemLimit = 232448 - 4096;
static_assert(sizeof(RowSmem) <= 4096, "the static shared memory allowance");
constexpr float kInvInt8 = 1.0f / 127.0f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* norm_w;
  const float* ri;          // K17: the rows' RMS inverse (B, Lq); K14: null
  int8_t* out_q;
  float* out_s;
  long long ldq;
  int Lq, kv_len, H, G, stages, qbufs, n_chunks, n0;
  float scale_log2, eps;
};

// dynamic shared memory: [G - 1 o slots | qbufs Q tiles | two sub-rings of
// `stages` chunks], 1024-byte aligned from `base`
struct Layout {
  int q, ring, bytes;
};

__host__ __device__ inline Layout layout(int G, int stages, int qbufs) {
  Layout l;
  l.q = (G - 1) * kSlot;
  l.ring = l.q + qbufs * kTile;
  l.bytes = l.ring + 2 * stages * kTile + 1024;
  return l;
}

// G heads a block fit with `qbufs` Q tiles and `stages` ring stages: two Q
// tiles (the next head's raw rows land under this head's work) with at
// least 2 stages, else one; then as many stages as fit, at most 4 (stages
// 0: G does not fit)
struct Shape {
  int stages, qbufs;
};

__host__ __device__ inline Shape shape_for(int G) {
  for (int qb = 2; qb >= 1; --qb) {
    int s = kMaxStages;
    while (s >= 2 && layout(G, s, qb).bytes > kSmemLimit) --s;
    if (s >= 2) return Shape{s, qb};
  }
  return Shape{0, 1};
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t to_u8(float v) {
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, __float2int_rn(v)));
}

// fp32 element (row, col) of a row-major (rows x width) buffer whose 8-float
// groups are XOR-swizzled by row % 4: a warp's fragment stores (rows g, g +
// 8 of 4 quads) and 16-byte row reads hit distinct banks
__device__ __forceinline__ int osw(int row, int col, int width) {
  return row * width + (col ^ ((row & 3) << 3));
}

// the raw q rows of head hl by TMA into Q tile hl % qbufs (normed there);
// the head that takes this tile next brought into L2
__device__ __forceinline__ void load_x(const CUtensorMap* tm_x, uint32_t qbuf0, uint32_t xfull0,
                                       int qbufs, int G, int col0, int row0, int b, int hl) {
  const uint32_t dst = qbuf0 + (hl % qbufs) * kTile, xb = xfull0 + 8 * (hl % qbufs);
  mbar_arrive_expect_tx(xb, kTile);
  tma_load_3d(tm_x, dst, xb, col0 + hl * kDh, row0, b);
  tma_load_3d(tm_x, dst + kBox, xb, col0 + hl * kDh + 64, row0, b);
  if (hl + qbufs < G) {
    tma_prefetch_3d(tm_x, col0 + (hl + qbufs) * kDh, row0, b);
    tma_prefetch_3d(tm_x, col0 + (hl + qbufs) * kDh + 64, row0, b);
  }
}

// Items [from, to) of sub-ring c, the producer's chunks of consumer c's
// keys (the first half of the chunks, rounded up, or the rest), item by
// item: per head, K of every chunk, then V of every chunk (single pass), or
// K of every chunk, then K and V of each chunk in turn (two passes, above
// kHeld chunks a consumer). Item i takes stage i % stages once the
// consumer has released its previous use.
__device__ __forceinline__ void load_items(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           uint32_t ring0, uint32_t bars, const Params& p, int c,
                                           bool single, int rank, int b, int from, int to) {
  const int first = c ? p.n0 : 0, nc = c ? p.n_chunks - p.n0 : p.n0;
  const int per = single ? 2 * nc : 3 * nc;
  const uint32_t ring = ring0 + c * p.stages * kTile, full0 = bars + 16 * c * p.stages;
  int it = 0, st = 0, ph = 0;   // item, its stage and that stage's use parity
#pragma unroll 1
  for (int hl = 0; hl < p.G; ++hl) {
#pragma unroll 1
    for (int k = 0; k < per; ++k, ++it) {
      if (it >= to) return;
      if (it >= from) {
        const bool is_v = single ? k >= nc : k >= nc && ((k - nc) & 1);
        const int j = k < nc ? k : single ? k - nc : (k - nc) >> 1;
        if (it >= p.stages) mbar_wait(full0 + 8 * (p.stages + st), ph ^ 1);
        const uint32_t dst = ring + st * kTile, bar = full0 + 8 * st;
        const CUtensorMap* tm = is_v ? tm_v : tm_k;
        const int h = rank * p.G + hl, key0 = (first + j) * kChunk;
        mbar_arrive_expect_tx(bar, kTile);
        tma_load_4d(tm, dst, bar, 0, h, key0, b);
        tma_load_4d(tm, dst + kBox, bar, 64, h, key0, b);
      }
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// a value the compiler must take as made here: what it feeds (the wgmma
// descriptors of one chunk, the producer's walk) is computed at its use, not
// hoisted or kept live in registers the S and O fragments need
__device__ __forceinline__ void launder(uint32_t& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void launder(int& v) { asm volatile("" : "+r"(v)); }

// keys >= nvalid of a 64-key S chunk at -inf (their p is 0)
__device__ __forceinline__ void mask_chunk(float (&s)[32], int nvalid, int t) {
  if (nvalid >= kChunk) return;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) s[e] = -__builtin_huge_valf();
}

// p = exp2(s * scale_log2 - m) in place (one FFMA and the SFU's exp2),
// added to the rows' sums
__device__ __forceinline__ void exp_chunk(float (&s)[32], float sl2, float m0, float m1,
                                          float& l0, float& l1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = ex2_approx(fmaf(s[e], sl2, (e & 2) ? -m1 : -m0));
  l0 += row_tree<false, 0>(s);
  l1 += row_tree<false, 2>(s);
}

// P as the bf16 A fragments of P V's four 16-key steps
__device__ __forceinline__ void pack_chunk(const float (&s)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
}

// O += bf16(P) V for the 64-key V chunk at vb (keys x channels as it lies:
// MN-major, a 16-key step is two 8-row groups, the next 64 channels one box
// on)
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pa)[16], uint32_t vb) {
  launder(vb);
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
    wgmma_bf16_rs<1>(o, pa + 4 * kk, sw128_desc_mn(vb + kk * 2048, kBox));
  wgmma_commit();
}

// S = Q K^T of the 64-key K chunk at kb (64 rows x 64 keys, fp32)
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa, uint32_t kb) {
  launder(qa);
  launder(kb);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_bf16_ss_n64(s, sw128_desc(qa + (kk >> 2) * kBox + (kk & 3) * 32),
                      sw128_desc(kb + (kk >> 2) * kBox + (kk & 3) * 32), kk > 0);
  wgmma_commit();
}

// The two consumers' partial O (this one's keys) and row sums meet: each
// owns channel half HALF (registers 32 HALF ..), writes its partial of the
// other half where the other reads it (the head's o slot, or for the last
// head its own first ring stage), reads the other's partial of its own
// half, and forms o = (O + O') / (l + l'); into the slot, or (last head) kept
// in its registers for the int8 stores. Tracks the rows' |o| maxima.
template <int HALF>
__device__ __forceinline__ void combine(float (&o)[64], float* wbuf, const float* rbuf,
                                        bool last, float l0, float l1, float* s_l, int r0,
                                        int t, float& amax0, float& amax1) {
  constexpr int OTH = 1 - HALF;
  const int width = last ? 64 : 128;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int i = 32 * OTH + 4 * jn, col = 8 * jn + 2 * t + (last ? 0 : 64 * OTH);
    *reinterpret_cast<float2*>(wbuf + osw(r0, col, width)) = make_float2(o[i], o[i + 1]);
    *reinterpret_cast<float2*>(wbuf + osw(r0 + 8, col, width)) =
        make_float2(o[i + 2], o[i + 3]);
  }
  if (t == 0) {
    s_l[HALF * kRows + r0] = l0;
    s_l[HALF * kRows + r0 + 8] = l1;
  }
  named_sync(2, 2 * kWG);
  const float inv0 = 1.f / fmaxf(l0 + s_l[OTH * kRows + r0], 1e-20f);
  const float inv1 = 1.f / fmaxf(l1 + s_l[OTH * kRows + r0 + 8], 1e-20f);
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int i = 32 * HALF + 4 * jn, col = 8 * jn + 2 * t + (last ? 0 : 64 * HALF);
    const float2 a = *reinterpret_cast<const float2*>(rbuf + osw(r0, col, width));
    const float2 c = *reinterpret_cast<const float2*>(rbuf + osw(r0 + 8, col, width));
    o[i] = (o[i] + a.x) * inv0;
    o[i + 1] = (o[i + 1] + a.y) * inv0;
    o[i + 2] = (o[i + 2] + c.x) * inv1;
    o[i + 3] = (o[i + 3] + c.y) * inv1;
    amax0 = fmaxf(amax0, fmaxf(fabsf(o[i]), fabsf(o[i + 1])));
    amax1 = fmaxf(amax1, fmaxf(fabsf(o[i + 2]), fabsf(o[i + 3])));
    if (!last) {
      float* w = const_cast<float*>(rbuf);
      *reinterpret_cast<float2*>(w + osw(r0, col, width)) = make_float2(o[i], o[i + 1]);
      *reinterpret_cast<float2*>(w + osw(r0 + 8, col, width)) = make_float2(o[i + 2], o[i + 3]);
    }
  }
}

// the last head's o (channel half HALF, in registers) as int8 pairs
template <int HALF>
__device__ __forceinline__ void store_last(const float (&o)[64], int8_t* orow0, int8_t* orow1,
                                           float inv0, float inv1, int t) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int i = 32 * HALF + 4 * jn, col = 64 * HALF + 8 * jn + 2 * t;
    if (orow0)
      *reinterpret_cast<uint16_t*>(orow0 + col) =
          (uint16_t)(to_u8(__fmul_rn(o[i], inv0)) | (to_u8(__fmul_rn(o[i + 1], inv0)) << 8));
    if (orow1)
      *reinterpret_cast<uint16_t*>(orow1 + col) = (uint16_t)(
          to_u8(__fmul_rn(o[i + 2], inv1)) | (to_u8(__fmul_rn(o[i + 3], inv1)) << 8));
  }
}

// Grid (n_tiles * C, B), clusters of C blocks along x: block rank r of tile
// `tile` owns rows [64 tile, 64 tile + 64) and heads [r G, r G + G). Warp 0
// (lane 0) of the producer warpgroup loads consumer 0's K / V chunks into its
// sub-ring, warp 1 consumer 1's, warp 2 each head's raw q rows.
// Consumer c takes keys [64 first_c, 64 (first_c + nc)), half the chunks:
// S = Q K^T (wgmma bf16, both operands from shared memory), the rows' max
// exchanged with the other consumer, P = exp(s - max) in fp32, its row sums,
// O += bf16(P) V (P in registers, V MN-major). Fragment of a consumer thread
// (warp w, lane l): register i holds row 16 w + l / 4 + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 (l & 3) + (i & 1). EXT_RMS (K17): the rows' RMS
// inverse is p.ri; else (K14) the cluster sums the squares of the row.
template <bool EXT_RMS>
__global__ void __launch_bounds__(kThreadsQ, 1)
cross_qout_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  __shared__ RowSmem rs;
  const Layout ly = layout(p.G, p.stages, p.qbufs);
  float* slots = reinterpret_cast<float*>(smem);
  const uint32_t qbuf0 = base + ly.q, ring0 = base + ly.ring;
  float* s_ss = rs.ss;
  float* s_row = rs.row;
  float* s_mx = &rs.mx[0][0];         // [head parity][consumer][row]
  float* s_l = &rs.l[0][0];           // [head parity][consumer][row]
  float* s_amx = &rs.amx[0][0];       // [consumer][row]
  float* s_inv = rs.inv;
  const uint32_t bars = smem_u32(rs.bars);
  // sub-ring c: its stages at ring0 + c stages kTile; full barriers at
  // bars + 16 c stages, empty ones 8 stages on; Q tile i: qempty0 + 8 i,
  // xfull0 + 8 i
  const uint32_t qempty0 = bars + 4 * p.stages * 8, xfull0 = qempty0 + 16, sbar = xfull0 + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank(), C = (int)cluster_blocks();
  const int row0 = (blockIdx.x / C) * kRows, b = blockIdx.y;
  const int HD = p.H * kDh, col0 = rank * p.G * kDh;
  const bool single = p.n0 <= kHeld;
  const __nv_bfloat16* qb = p.q + (long long)b * p.Lq * p.ldq;

  if (tid == 0) {
#pragma unroll 1
    for (int i = 0; i < 4 * p.stages; ++i) mbar_init(bars + 8 * i, 1);   // full, empty
    for (int i = 0; i < 2; ++i) {
      mbar_init(qempty0 + 8 * i, 2);   // both consumers
      mbar_init(xfull0 + 8 * i, 1);    // the raw q tile's TMA
    }
    mbar_init(sbar, kRows);            // the rows' int8 scales
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the first heads' raw q rows (from device memory) first, then the
  // first chunks of each sub-ring (from L2; they need no free stage), all
  // in flight before the row statistics
  if (tid == 2 * 32)
    for (int hl = 0; hl < min(p.qbufs, p.G); ++hl)
      load_x(&tm_x, qbuf0, xfull0, p.qbufs, p.G, col0, row0, b, hl);
  __syncthreads();
  if (warp < 2 && lane == 0)
    load_items(&tm_k, &tm_v, ring0, bars, p, warp, single, rank, b, 0, p.stages);

  // 1. the rows' RMS inverse. K14: each warp sums the squares of its rows
  // over this block's G * 128 columns (16 bytes a lane), then the cluster's
  // blocks add their partial sums in rank order. K17 reads it.
  if (EXT_RMS) {
    if (tid < kRows) s_row[tid] = row0 + tid < p.Lq ? p.ri[(long long)b * p.Lq + row0 + tid] : 0.f;
    __syncthreads();
  } else {
    const int n16 = p.G * 16;   // 16-byte pieces of the block's columns
    // warp w sums rows w, w + 12, ...: three rows' loads in flight at once
#pragma unroll 1
    for (int k0 = 0; k0 < (kRows + 11) / 12; k0 += 3) {
      uint4 u[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = warp + 12 * (k0 + k);
        const bool live = r < kRows && row0 + r < p.Lq;
        const __nv_bfloat16* src = qb + (long long)(row0 + (live ? r : 0)) * p.ldq + col0;
#pragma unroll
        for (int x = 0; x < 3; ++x)
          u[k][x] = live && lane + 32 * x < n16
                        ? *reinterpret_cast<const uint4*>(src + 8 * (lane + 32 * x))
                        : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[k][x]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            s += f.x * f.x + f.y * f.y;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const int r = warp + 12 * (k0 + k);
        if (r < kRows && lane == 0) s_ss[r] = s;
      }
    }
    cluster_sync();
    if (tid < kRows) {
      // every block's partial sum in flight at once, added in rank order
      float part[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        part[r] = r < C ? ld_remote_f32(smem_u32(&s_ss[tid]), r) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) s += part[r];
      s_row[tid] = rsqrtf(s / HD + p.eps);
    }
    __syncthreads();
  }

  if (tid < kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp < 2) {
      // ---- K / V loads of sub-ring `warp`; the maps end at kv_len ----
      if (lane == 0) {
        // the walk's values made anew here, not kept from the prologue
        int c = warp;
        launder(c);
        load_items(&tm_k, &tm_v, ring0, bars, p, c, single, rank, b, p.stages, 1 << 30);
      }
    } else if (warp == 2 && lane == 0) {
      // ---- each head's raw q rows into its Q tile, the head after the
      // next once both consumers' QK has read the tile ----
#pragma unroll 1
      for (int hl = p.qbufs; hl < p.G; ++hl) {
        mbar_wait(qempty0 + 8 * (hl % p.qbufs), (hl / p.qbufs - 1) & 1);
        load_x(&tm_x, qbuf0, xfull0, p.qbufs, p.G, col0, row0, b, hl);
      }
    }
    // 3. each row's |o| max over the cluster's heads -> its int8 scale; no
    // block exits before every block's remote reads are done
    cluster_sync();
    if (tid < kRows) {
      float part[2 * kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        part[2 * r] = r < C ? ld_remote_f32(smem_u32(&s_amx[tid]), r) : 0.f;
        part[2 * r + 1] = r < C ? ld_remote_f32(smem_u32(&s_amx[kRows + tid]), r) : 0.f;
      }
      float mx = 0.f;
#pragma unroll
      for (int r = 0; r < 2 * kMaxCluster; ++r) mx = fmaxf(mx, part[r]);
      const float sc = __fmul_rn(fmaxf(mx, 1e-8f), kInvInt8);
      s_inv[tid] = 1.f / sc;
      if (rank == 0 && row0 + tid < p.Lq) p.out_s[(long long)b * p.Lq + row0 + tid] = sc;
      mbar_arrive(sbar);
    }
    cluster_arrive();
    cluster_wait();
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = tid / kWG - 1, lt = tid % kWG;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (lt >> 5) * 16 + g;   // this thread's rows r0 and r0 + 8
    float o[64];
    float amax0 = 0.f, amax1 = 0.f;
    const int first = cw ? p.n0 : 0, nc = cw ? p.n_chunks - p.n0 : p.n0;
    const uint32_t rbase = ring0 + cw * p.stages * kTile, fb = bars + 16 * cw * p.stages;
    const uint32_t eb = fb + 8 * p.stages;
    int n = 0;   // items of this sub-ring consumed: stage n % stages
    float sc[kHeld][32];
    uint32_t pa[16];
#pragma unroll 1
    for (int hl = 0; hl < p.G; ++hl) {
      const int qi = hl % p.qbufs;
      const uint32_t qbuf = qbuf0 + qi * kTile, qempty = qempty0 + 8 * qi;
      // this head's normed q, bf16(bf16(x * rms) * w), in place in the
      // swizzled K-major A tile of S = Q K^T its raw rows arrived in (rows
      // past Lq arrive as zeros): each consumer its 32 rows, 16 bytes a
      // thread at a time
      {
        const int c8 = lt & 15;
        const uint4 wu = *reinterpret_cast<const uint4*>(p.norm_w + col0 + hl * kDh + c8 * 8);
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wu);
        unsigned char* qt = smem + ly.q + qi * kTile + (c8 >> 3) * kBox;
        mbar_wait(xfull0 + 8 * qi, (hl / p.qbufs) & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * cw + (lt >> 4) + 8 * i;
          uint4* at = reinterpret_cast<uint4*>(qt + r * 128 + (((c8 & 7) ^ (r & 7)) << 4));
          uint4 u = *at;
          uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
          const float rms = s_row[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&uw[e]));
            const float2 w = __bfloat1622float2(w2[e]);
            uw[e] = pack_bf16(round_bf16(__fmul_rn(round_bf16(__fmul_rn(x.x, rms)), w.x)),
                              round_bf16(__fmul_rn(round_bf16(__fmul_rn(x.y, rms)), w.y)));
          }
          *at = u;
        }
        fence_async_shared();
        named_sync(3, 2 * kWG);   // both halves of the tile normed
      }
      float mx0 = -__builtin_huge_valf(), mx1 = -__builtin_huge_valf();
      if (single) {
        // every S chunk of this consumer's keys, held in registers; a
        // chunk's stage is released once the next chunk's QK is issued
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
          if (j < nc) {
            mbar_wait(fb + 8 * ((n + j) % p.stages), (((n + j) / p.stages) & 1));
            issue_qk(sc[j], qbuf, rbase + ((n + j) % p.stages) * kTile);
            if (j > 0) {
              wgmma_wait<1>();
              if (lt == 0) mbar_arrive(eb + 8 * ((n + j - 1) % p.stages));
            }
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kHeld; ++j) reg_fence<32>(sc[j]);
        if (nc > 0 && lt == 0) mbar_arrive(eb + 8 * ((n + nc - 1) % p.stages));
        if (lt == 0) mbar_arrive(qempty);
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
          if (j < nc) {
            mask_chunk(sc[j], p.kv_len - (first + j) * kChunk, t);
            mx0 = fmaxf(mx0, row_tree<true, 0>(sc[j]));
            mx1 = fmaxf(mx1, row_tree<true, 2>(sc[j]));
          }
        }
        n += nc;
      } else {
        // pass 1 of two: the rows' exact max over every chunk
#pragma unroll 1
        for (int j = 0; j < nc; ++j, ++n) {
          mbar_wait(fb + 8 * (n % p.stages), ((n / p.stages) & 1));
          wgmma_fence();
          issue_qk(sc[0], qbuf, rbase + (n % p.stages) * kTile);
          wgmma_wait<0>();
          reg_fence<32>(sc[0]);
          if (lt == 0) mbar_arrive(eb + 8 * (n % p.stages));
          mask_chunk(sc[0], p.kv_len - (first + j) * kChunk, t);
          mx0 = fmaxf(mx0, row_tree<true, 0>(sc[0]));
          mx1 = fmaxf(mx1, row_tree<true, 2>(sc[0]));
        }
      }
      // the rows' max over both consumers' keys (raw logits; the scale is
      // positive), in the log2 domain
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      float* mxb = s_mx + (hl & 1) * 2 * kRows;
      if (t == 0) {
        mxb[cw * kRows + r0] = mx0;
        mxb[cw * kRows + r0 + 8] = mx1;
      }
      named_sync(1, 2 * kWG);
      const float m0 = fmaxf(mx0, mxb[(1 - cw) * kRows + r0]) * p.scale_log2;
      const float m1 = fmaxf(mx1, mxb[(1 - cw) * kRows + r0 + 8]) * p.scale_log2;

      // P = exp(s - max), its fp32 row sums, O += bf16(P) V
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      float l0 = 0.f, l1 = 0.f;
      if (single) {
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
          if (j < nc) {
            // this chunk's softmax runs under the previous chunk's P V
            exp_chunk(sc[j], p.scale_log2, m0, m1, l0, l1);
            if (j > 0) {
              wgmma_wait<0>();
              reg_fence<64>(o);
              reg_fence<16>(pa);
              if (lt == 0) mbar_arrive(eb + 8 * ((n + j - 1) % p.stages));
            }
            pack_chunk(sc[j], pa);
            mbar_wait(fb + 8 * ((n + j) % p.stages), (((n + j) / p.stages) & 1));
            reg_fence<64>(o);
            reg_fence<16>(pa);
            wgmma_fence();
            issue_pv(o, pa, rbase + ((n + j) % p.stages) * kTile);
          }
        }
        wgmma_wait<0>();
        reg_fence<64>(o);
        reg_fence<16>(pa);
        if (nc > 0 && lt == 0) mbar_arrive(eb + 8 * ((n + nc - 1) % p.stages));
        n += nc;
      } else {
        // pass 2: each chunk's S again, then its P V
#pragma unroll 1
        for (int j = 0; j < nc; ++j) {
          mbar_wait(fb + 8 * (n % p.stages), ((n / p.stages) & 1));
          reg_fence<64>(o);
          wgmma_fence();
          issue_qk(sc[0], qbuf, rbase + (n % p.stages) * kTile);
          wgmma_wait<0>();
          reg_fence<32>(sc[0]);
          if (lt == 0) mbar_arrive(eb + 8 * (n % p.stages));
          if (lt == 0 && j == nc - 1) mbar_arrive(qempty);
          ++n;
          mask_chunk(sc[0], p.kv_len - (first + j) * kChunk, t);
          exp_chunk(sc[0], p.scale_log2, m0, m1, l0, l1);
          pack_chunk(sc[0], pa);
          mbar_wait(fb + 8 * (n % p.stages), ((n / p.stages) & 1));
          reg_fence<64>(o);
          reg_fence<16>(pa);
          wgmma_fence();
          issue_pv(o, pa, rbase + (n % p.stages) * kTile);
          wgmma_wait<0>();
          reg_fence<64>(o);
          reg_fence<16>(pa);
          if (lt == 0) mbar_arrive(eb + 8 * (n % p.stages));
          ++n;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }

      // 2. the two halves of the keys meet in the head's o slot; the last
      // head's o stays in registers (its scratch: the first stage of each
      // consumer's ring, which no load refills)
      const bool last = hl == p.G - 1;
      float* own = last ? reinterpret_cast<float*>(smem + (rbase - base))
                        : slots + hl * (kSlot / 4);
      const float* other = last ? reinterpret_cast<float*>(smem + (ring0 + (1 - cw) * p.stages * kTile - base)) : own;
      float* sl = s_l + (hl & 1) * 2 * kRows;
      if (cw == 0)
        combine<0>(o, own, other, last, l0, l1, sl, r0, t, amax0, amax1);
      else
        combine<1>(o, own, other, last, l0, l1, sl, r0, t, amax0, amax1);
    }
    // the rows' |o| maxima over this consumer's half of every head
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      amax0 = fmaxf(amax0, __shfl_xor_sync(0xffffffffu, amax0, off));
      amax1 = fmaxf(amax1, __shfl_xor_sync(0xffffffffu, amax1, off));
    }
    if (t == 0) {
      s_amx[cw * kRows + r0] = amax0;
      s_amx[cw * kRows + r0 + 8] = amax1;
    }
    cluster_sync();
    mbar_wait(sbar, 0);   // the producer's scales
    cluster_arrive();

    // 4. int8 = round(o * (1 / scale)): the o slots 16 channels a thread (two
    // 8-float groups of a swizzled row, one 16-byte store), the last head
    // from registers
    int8_t* outb = p.out_q + ((long long)b * p.Lq + row0) * HD + col0;
    const int n_items = (p.G - 1) * kRows * 8;
#pragma unroll 1
    for (int it = tid - kWG; it < n_items; it += 2 * kWG) {
      const int c16 = it & 7, r = (it >> 3) % kRows, hl = (it >> 3) / kRows;
      if (row0 + r >= p.Lq) continue;
      const float* src = slots + hl * (kSlot / 4);
      const float inv = s_inv[r];
      uint32_t w[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float4* g8 = reinterpret_cast<const float4*>(src + osw(r, 16 * c16 + 8 * hf, kDh));
        const float4 a = g8[0], c = g8[1];
        w[2 * hf] = to_u8(__fmul_rn(a.x, inv)) | (to_u8(__fmul_rn(a.y, inv)) << 8) |
                    (to_u8(__fmul_rn(a.z, inv)) << 16) | (to_u8(__fmul_rn(a.w, inv)) << 24);
        w[2 * hf + 1] = to_u8(__fmul_rn(c.x, inv)) | (to_u8(__fmul_rn(c.y, inv)) << 8) |
                        (to_u8(__fmul_rn(c.z, inv)) << 16) | (to_u8(__fmul_rn(c.w, inv)) << 24);
      }
      *reinterpret_cast<uint4*>(outb + (long long)r * HD + hl * kDh + 16 * c16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    int8_t* last = outb + (p.G - 1) * kDh;
    int8_t* o0 = row0 + r0 < p.Lq ? last + (long long)r0 * HD : nullptr;
    int8_t* o1 = row0 + r0 + 8 < p.Lq ? last + (long long)(r0 + 8) * HD : nullptr;
    if (cw == 0)
      store_last<0>(o, o0, o1, s_inv[r0], s_inv[r0 + 8], t);
    else
      store_last<1>(o, o0, o1, s_inv[r0], s_inv[r0 + 8], t);
    cluster_wait();
  }
}

// G heads a block, C = H / G blocks a cluster (at most 8) on each 64-row
// tile; keys in 64-key chunks, half of them each consumer's
template <bool EXT_RMS>
int launch(const void* q, const void* norm_w, const void* ri, const void* k, const void* v,
           void* out_q, void* out_s, long long ldq, int B, int H, int G, int Lq, int kv_len,
           Strides ks, Strides vs, float scale, float eps, void* stream) {
  if (B <= 0 || Lq <= 0 || kv_len <= 0 || G <= 0 || G > kMaxGroup || H % G ||
      H / G > kMaxCluster || ldq % 8 || ldq < (long long)H * kDh)
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors and TMA: aligned bases and strides
  const Strides st[2] = {ks, vs};
  for (int i = 0; i < 2; ++i)
    if (st[i].b % 8 || st[i].l % 8 || st[i].h % 8) return (int)cudaErrorInvalidValue;
  const void* ptr[5] = {q, norm_w, k, v, out_q};
  for (int i = 0; i < 5; ++i)
    if ((uintptr_t)ptr[i] % 16) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_for(G);
  if (sh.stages < 2) return (int)cudaErrorInvalidValue;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, cross_qout_kernel<EXT_RMS>);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs || fa.sharedSizeBytes + kSmemLimit > 232448)
      return (int)cudaErrorInvalidConfiguration;
    return (int)cudaFuncSetAttribute(cross_qout_kernel<EXT_RMS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  }();
  if (ready != 0) return ready;
  CUtensorMap tx, tk, tv;
  if (!brows_map(&tx, q, B, Lq, H * kDh, ldq, kRows) ||
      !bhld_map(&tk, k, B, kv_len, H, ks.b, ks.l, ks.h, kChunk) ||
      !bhld_map(&tv, v, B, kv_len, H, vs.b, vs.l, vs.h, kChunk))
    return (int)cudaErrorInvalidValue;
  const int C = H / G, n_chunks = (kv_len + kChunk - 1) / kChunk;
  const long long tiles = ((long long)Lq + kRows - 1) / kRows;
  if (tiles * C > 0x7fffffff || B > 65535) return (int)cudaErrorInvalidValue;
  Params p{(const __nv_bfloat16*)q, (const __nv_bfloat16*)norm_w, (const float*)ri,
           (int8_t*)out_q, (float*)out_s, ldq, Lq, kv_len, H, G, sh.stages, sh.qbufs,
           n_chunks, (n_chunks + 1) / 2, scale * kLog2e, eps};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C), B, 1);
  cfg.blockDim = dim3(kThreadsQ, 1, 1);
  cfg.dynamicSmemBytes = layout(G, sh.stages, sh.qbufs).bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cross_qout_kernel<EXT_RMS>, tx, tk, tv, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace k14

// The kernel a K3 launch takes (ops/flash_attention.py `sparse_flash_form`
// mirrors it): 1, `k4::flash_fwd_kernel<1>`, for blocks that are
// multiples of 128 (a 128-row tile lies in one Q block; K blocks are whole
// 128-key chunks); 0, `sparse_flash_fwd_kernel`, for the other multiples of
// 64 (`sla` at --sla_block 64: 512/64); -1, refused: other blocks, no key, or
// a stride (elements; q, k, v, o by batch, token, head) off 16 bytes,
// which neither form reads (TMA boxes, 16-byte vectors).
int k3_form(int block_q, int block_k, int kv_len, const long long* strides) {
  if (block_q <= 0 || block_k <= 0 || block_q % kBM || block_k % kBN || kv_len <= 0) return -1;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return -1;
  using P = k4::Plan<k4::kSparse>;
  return block_q % P::kRows == 0 && block_k % P::kKeys == 0 ? 1 : 0;
}

// The kernel a K20 launch takes (ops/flash_attention.py
// `sparse_flash_i8qk_form` mirrors it): 1, `k4::flash_fwd_kernel<2>`, for
// blocks that are multiples of 64 (a 64-row tile lies in one Q block, a K
// block is whole 64-key chunks); -1, refused: other blocks, kv_len outside
// (0, Lk], or a stride off 16 bytes (TMA boxes of v and o).
int k20_form(int block_q, int block_k, int kv_len, int Lk, const long long* strides) {
  using P = k4::Plan<k4::kSparseI8>;
  if (block_q <= 0 || block_k <= 0 || block_q % P::kRows || block_k % P::kKeys ||
      kv_len <= 0 || kv_len > Lk)
    return -1;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return -1;
  return 1;
}

// K30's operands (ops/flash_attention.py `_check_qkv` holds them first):
// kv_len in (0, Lk] and every stride (elements; q, k, v, o by batch,
// token, head) a 16-byte multiple (the int8 rows' loads, the TMA boxes of v
// and o)
bool k30_takes(int B, int H, int Lq, int kv_len, int Lk, const long long* strides) {
  if (B <= 0 || H <= 0 || Lq <= 0 || kv_len <= 0 || kv_len > Lk) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return false;
  return true;
}

}  // namespace

extern "C" int tdx_sparse_flash_attention_form(int block_q, int block_k, int kv_len,
                                               const long long* strides) {
  return k3_form(block_q, block_k, kv_len, strides);
}

extern "C" int tdx_sparse_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* lut,
    int B, int H, int Lq, int kv_len, int nQ, int sel, int block_q, int block_k,
    long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
    long long ksh, long long vsb, long long vsl, long long vsh, long long osb,
    long long osl, long long osh, float scale, void* stream) {
  const long long st[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  const int form = k3_form(block_q, block_k, kv_len, st);
  if (form < 0 || nQ != (Lq + block_q - 1) / block_q) return (int)cudaErrorInvalidValue;
  if (form == 1)
    return k4::launch<k4::kSparse>(q, k, v, o, B, H, Lq, kv_len, Strides{qsb, qsl, qsh},
                                   Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                                   Strides{osb, osl, osh}, scale, (const int*)lut, sel,
                                   block_q, block_k, stream);
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  sparse_flash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (const int*)lut, H, Lq, kv_len, nQ, sel, block_q, block_k,
      Strides{qsb, qsl, qsh}, Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
      Strides{osb, osl, osh}, scale * kLog2e);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_flash_attention_i8qk_form(int block_q, int block_k, int kv_len,
                                                    int Lk, const long long* strides) {
  return k20_form(block_q, block_k, kv_len, Lk, strides);
}

// K20: q's rows and k's rows before kv_len quantised into qi (B, H, Lqp, 128)
// / qsc and ki (B, H, Lkp, 128) / ksc (Lqp = ceil(Lq / 64) * 64, Lkp =
// ceil(kv_len / 64) * 64; scratch the caller allocates), then the walk
extern "C" int tdx_sparse_flash_attention_i8qk(
    const void* q, const void* k, const void* v, void* o, const void* lut, void* qi,
    void* qsc, void* ki, void* ksc, int B, int H, int Lq, int Lk, int kv_len, int nQ,
    int sel, int block_q, int block_k, long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
    long long osb, long long osl, long long osh, float scale, void* stream) {
  const long long st[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  if (k20_form(block_q, block_k, kv_len, Lk, st) < 0 || B <= 0 || H <= 0 || Lq <= 0 ||
      nQ != (Lq + block_q - 1) / block_q)
    return (int)cudaErrorInvalidValue;
  using P = k4::Plan<k4::kSparseI8>;
  const int Lqp = (Lq + P::kRows - 1) / P::kRows * P::kRows;
  const int Lkp = (kv_len + P::kKeys - 1) / P::kKeys * P::kKeys;
  int err = launch_i8qk_quant(k, ki, ksc, B, H, kv_len, Lkp, Strides{ksb, ksl, ksh}, stream);
  if (!err) err = launch_i8qk_quant(q, qi, qsc, B, H, Lq, Lqp, Strides{qsb, qsl, qsh}, stream);
  if (err) return err;
  return k4::launch<k4::kSparseI8>(q, k, v, o, B, H, Lq, kv_len, Strides{qsb, qsl, qsh},
                                   Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                                   Strides{osb, osl, osh}, scale, (const int*)lut, sel,
                                   block_q, block_k, stream, qi, (const float*)qsc, ki,
                                   (const float*)ksc);
}

// K30: q's rows and k's rows before kv_len quantised into qi (B, H, Lqp, 128)
// / qsc and ki (B, H, Lkp, 128) / ksc (Lqp = ceil(Lq / 128) * 128, Lkp =
// kv_len padded to the chunk, at most ceil(kv_len / 128) * 128; scratch the
// caller allocates at those sizes), then K4's dense walk on them
extern "C" int tdx_flash_attention_i8qk(
    const void* q, const void* k, const void* v, void* o, void* qi, void* qsc, void* ki,
    void* ksc, int B, int H, int Lq, int Lk, int kv_len, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh, long long vsb, long long vsl,
    long long vsh, long long osb, long long osl, long long osh, float scale, void* stream) {
  const long long st[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh};
  if (!k30_takes(B, H, Lq, kv_len, Lk, st)) return (int)cudaErrorInvalidValue;
  using P = k4::Plan<k4::kDenseI8>;
  static_assert(P::kRows == 128 && P::kKeys <= 128, "the caller's scratch sizes");
  const int Lqp = (Lq + P::kRows - 1) / P::kRows * P::kRows;
  const int Lkp = (kv_len + P::kKeys - 1) / P::kKeys * P::kKeys;
  int err = launch_i8qk_quant(k, ki, ksc, B, H, kv_len, Lkp, Strides{ksb, ksl, ksh}, stream);
  if (!err) err = launch_i8qk_quant(q, qi, qsc, B, H, Lq, Lqp, Strides{qsb, qsl, qsh}, stream);
  if (err) return err;
  return k4::launch<k4::kDenseI8>(q, k, v, o, B, H, Lq, kv_len, Strides{qsb, qsl, qsh},
                                  Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                                  Strides{osb, osl, osh}, scale, nullptr, 0, 0, 0, stream, qi,
                                  (const float*)qsc, ki, (const float*)ksc);
}

extern "C" int tdx_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
    int kv_len, long long qsb, long long qsl, long long qsh, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
    long long osb, long long osl, long long osh, float scale, void* stream) {
  return k4::launch<k4::kDense>(q, k, v, o, B, H, Lq, kv_len, Strides{qsb, qsl, qsh},
                                Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh},
                                Strides{osb, osl, osh}, scale, nullptr, 0, 0, 0, stream);
}


// the launch K14 / K17 take (ops/flash_attention.py `qout_shape` mirrors
// it): out = {cluster blocks, ring stages, key chunks, consumer 0's chunks,
// shared memory bytes, Q tiles}
extern "C" int tdx_cross_attention_qout_shape(int H, int G, int kv_len, void* out) {
  if (H <= 0 || G <= 0 || G > k14::kMaxGroup || H % G || H / G > k14::kMaxCluster ||
      kv_len <= 0)
    return (int)cudaErrorInvalidValue;
  const k14::Shape sh = k14::shape_for(G);
  const int chunks = (kv_len + k14::kChunk - 1) / k14::kChunk;
  if (sh.stages < 2) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  o[0] = H / G;
  o[1] = sh.stages;
  o[2] = chunks;
  o[3] = (chunks + 1) / 2;
  o[4] = k14::layout(G, sh.stages, sh.qbufs).bytes;
  o[5] = sh.qbufs;
  return 0;
}

extern "C" int tdx_cross_attention_qout(const void* q, const void* norm_w, const void* k,
                                        const void* v, void* out_q, void* out_s,
                                        long long ldq, int B, int H, int G, int Lq,
                                        int kv_len, long long ksb, long long ksl,
                                        long long ksh, long long vsb, long long vsl,
                                        long long vsh, float scale, float eps,
                                        void* stream) {
  return k14::launch<false>(q, norm_w, nullptr, k, v, out_q, out_s, ldq, B, H, G, Lq, kv_len,
                            Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, scale, eps, stream);
}

extern "C" int tdx_cross_attention_qout_wide(const void* q, const void* norm_w, const void* ri,
                                             const void* k, const void* v, void* out_q,
                                             void* out_s, long long ldq, int B, int H, int G,
                                             int Lq, int kv_len, long long ksb, long long ksl,
                                             long long ksh, long long vsb, long long vsl,
                                             long long vsh, float scale, void* stream) {
  return k14::launch<true>(q, norm_w, ri, k, v, out_q, out_s, ldq, B, H, G, Lq, kv_len,
                           Strides{ksb, ksl, ksh}, Strides{vsb, vsl, vsh}, scale, 0.f, stream);
}
