// K7, K19 and K28: block-sparse INT8 SageSLA attention for sm_90a.
//
// K7 tdx_sparse_attention_i8_vt replaces the TPU kernel
//    turbodiffusion_tpu/ops/flash_pallas.py:sparse_attention_i8_vt (body
//    _sparse_attn_kernel_i8b_vt), with its fused SLA linear-branch epilogue:
//    each block_q-row Q block attends to the `sel` K blocks its LUT row
//    names; scores are int8 q . int8 k (smooth-k, one scale per K block)
//    times the q row scale, V is int8 per channel (the transposed panel K6
//    writes), and the output is bf16 planes (B, H, Lp, 128).
//
// What bounds it on an H100: tensor-core math. At the 1.3B 480p shape a call
// is 6.2e11 operations (12 heads x 32,768 rows x 3,072 keys x 128 x 2 x 2)
// over ~100 MB of panels, far above the ridge; half of them (P V) run at the
// bf16 rate. The design (`k7::sparse_i8_vt_kernel`) is Hopper's
// warp-specialised attention shape:
//   * a block owns 128 query rows of one (b, h): one producer warpgroup and
//     two consumer warpgroups of 64 rows; the Q rows stay in shared memory as
//     int8 (128-byte swizzled rows, one TMA load);
//   * the producer's warp 0 walks the LUT row and loads each 128-key chunk
//     by TMA into a 3-stage mbarrier ring: K as int8 rows (keys x 128, as K6
//     writes it) and V^T as int8 (128 channel rows of the chunk's keys, K6's
//     transposed panel); its warps 1-3 convert V to bf16 (exact: a byte
//     placed in the mantissa of 2^23, less 2^23 + 128) once a chunk, into
//     the K-major 128-byte-swizzled layout wgmma reads, for both consumers;
//   * S = Q K^T on wgmma m64n128k32 s8 x s8 -> s32 (exact), scaled by the q
//     row scale and the K block scale (which carries Dh^-0.5 * log2 e); keys
//     >= kv_len are set to -1e9 before the row max, so garbage in the tail of
//     the last block can never win it; chunks wholly past kv_len are skipped;
//   * an online softmax in the log2 domain in fp32 registers (the TPU kernel
//     holds all sel * block_k = 3,072 scores of a row at once; that only
//     changes where p is rounded to bf16): the row max on the exact int32
//     sums (the scales are positive), exp2(s32 * scale - max) as one FFMA
//     and the SFU's exp2; then O += bf16(P) V on wgmma
//     m64n128k16 bf16 with P in registers (the S accumulator is already the
//     A fragment) and V from the converted stage; the next chunk's QK is
//     issued before the previous P V is waited on;
//   * epilogue: o / max(l, 1e-20) * vch, and with the linear branch
//     phi(q) = softmax_D(q_i8 * qs) (from global q, a quad of threads per
//     row), o += phi(q) kvw / (1e-5 + phi(q) . ksum) + bias in fp32, with
//     phi and all of kvw staged in the freed stages; bf16 stores from the
//     fragments.
//   setmaxnreg moves registers from the producer (56: four units of V in
//   flight a converter thread) to the consumers (224).
//   Blocks of 128 rows: block_q and block_k must be multiples of 128 (the
//   fused path's blocks are 128, 256 or 512).
//   What holds it back on an H100 80GB HBM3 (tools/time_k9_k7.py,
//   tools/stamp_k7.py): ~3x its bound, the tensor cores busy about a third
//   of the time. A consumer's time goes to the softmax (64 exp2 a thread a
//   chunk on the quarter-rate SFU, beside P's bf16 packing) and to wgmma
//   issue stalls; the producer's spare warps convert V for most of a
//   block's time. Not yet: exp2 partly on the FMA pipe; a cluster of the
//   blocks that share a LUT row converting V once and multicasting K and V.
//   The linear epilogue runs in fp32 on the CUDA cores.
//
// K19 tdx_sparse_attention_i8_planes replaces the per-row form of the TPU
//    kernel turbodiffusion_tpu/ops/flash_pallas.py:sparse_attention_i8_planes
//    (body _sparse_attn_kernel_i8, metadata rows built at :1391-1421), the
//    v_quant=row path: int8 Q with per-row scales (the softmax scale folded
//    in, qs * Dh^-0.5), and K18's packed (B, H, Lk, 256) K|V rows with
//    per-row fp32 K and V scales.
//    s = (int32(q . k) * (qs * Dh^-0.5)) * ks, natural exp (the TPU kernel's
//    domain), and V's row scale folded into P before its bf16 rounding:
//    O += bf16(p * vs) bf16(v_i8); o = O / max(l, 1e-20) with l the sum of
//    the unscaled p. Bound like K7 by tensor-core math (the same pair count;
//    the PV product scales P per key instead of O per channel). Two forms by
//    its blocks (`planes_form`; ops/sparse_i8_attention.py
//    `sparse_i8_planes_form`). At multiples of 128 (every --v_quant row
//    call: 512/256) K7's kernel in its third source layout,
//    `k7::sparse_i8_vt_kernel<2>`: K28's loads of K and V from the two halves
//    of the packed rows and K7's V conversion into an MN-major tile, and
//    with each chunk its 128 K and 128 V row scales (two bulk copies on the
//    chunk's barrier); S = s32 times the key's K scale in fp32 before the
//    row max (K7's max on the integer sums holds only under one scale a
//    chunk), log2 e folded into the row's scale, exp2; l sums the unscaled
//    p, and each column of P is multiplied by its key's V scale before the
//    bf16 packing (JAX's rounding: bf16(p vs), not bf16(p) bf16(v vs)); a
//    key >= kv_len gets its score, p and V scale by selection, so NaN
//    scales past kv_len never reach a live row. At the other multiples of
//    64, `sparse_i8_planes_kernel<false>`, K3's FlashAttention-2 loop on
//    mma.sync: a block of 4 warps owns 64 query
//    rows, each warp its 16 rows' int8 Q fragments, a 16 x 128 fp32
//    accumulator and the running max / sum in registers; 64-key chunks are
//    staged synchronously in shared memory (int8 K rows of 144 bytes, so
//    fragment loads hit 32 banks) and S = Q K^T runs on mma.sync m16n8k32
//    s8, P V on m16n8k16 bf16 with P from the S accumulators. Beside K3's
//    loop: the K and V halves of a chunk come from one
//    packed 256-byte row a key (V converted to bf16 and transposed as it is
//    staged, as K3 stages bf16 V); the chunk's 64 K and V row scales are
//    staged in shared memory, the V scales zeroed past kv_len; p is
//    rescaled per key before it is packed into the A fragments of P V.
//    Keys at or past kv_len get -1e30 before the row max: the port's rule
//    for K3 / K4 / K7, which replaces the TPU's poison block (LUT padding
//    pointing at a zero block with a -1e30 bias).
//
// K28 tdx_sparse_attention_i8_planes_bs replaces the block-scale form of
//    flash_pallas.py:sparse_attention_i8_planes (body _sparse_attn_kernel_i8b,
//    wrapper :1345-1390), which fused sagesla at v_quant=channel takes once
//    sel * block_k exceeds 8,192 (480p at --sla_topk 0.3: 38 of 128 blocks):
//    K19's walk over K27's packed K|V rows with K7's scoring: one K scale a
//    block, read from the (B, H, nK) table and multiplied by Dh^-0.5 *
//    log2 e (the TPU wrapper folds both into its table, not into qs),
//    s = (int32(q . k) * qs) * that, keys >= kv_len at -1e9 before the row
//    max (K27 quantises rows past kv_len, which may have been NaN, with the
//    block's scale; they never reach a live score), exp2, O += bf16(p)
//    bf16(v_i8), o = O / max(l, 1e-20) * vch. Bound like K7 (the same
//    pair count). Two forms by its blocks (`planes_form`;
//    ops/sparse_i8_attention.py `sparse_i8_planes_bs_form`): at multiples
//    of 128 (fused sagesla's blocks) K7's kernel with its source layout a
//    template argument, `k7::sparse_i8_vt_kernel<1>`: producer warp 0 loads
//    K by TMA as 128 keys x 128 bytes at column 0 of the packed 256-byte
//    rows and V at column 128 (keys x channels, a map of the same rows), its
//    warps 1-3 convert V with K7's exact integer conversion into a 128-byte
//    swizzled MN-major bf16 tile, which P V's wgmma reads with the transpose
//    bit as K4 reads bf16 V; K7's scoring, tail mask, chunk walk and
//    finalize as they are, the (B, H, nK) table times scale * log2 e in fp32
//    the K scale (the product K7 takes of its own table). At the other
//    multiples of 64, `sparse_i8_planes_kernel<true>`: K19's mma.sync loop
//    with that scoring, the 64-key chunks of each K block staged
//    synchronously. On an H100 80GB HBM3 (tools/time_k3_k28.py, PERF.md)
//    the wgmma form takes 3.74 ms at the 1.3B topk-0.3 call (38 of 128 K
//    blocks; bound 1.48), as K7 does on the same LUT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_step.cuh"
#include "hopper.cuh"

namespace {

constexpr int kDh = 128;
constexpr int kBM = 64;                      // query rows per block
constexpr int kBN = 64;                      // keys per chunk
constexpr int kThreads = 128;
constexpr int kKStride = kDh + 16;           // bytes per int8 row of Ks / Q staging
constexpr int kVStride = kBN + 8;            // bf16 per row of Vt
constexpr int kMainBytes = kBM * kKStride + kDh * kVStride * 2;
constexpr float kNegInf = -1e30f;            // running-max start
constexpr float kMasked = -1e9f;             // score of a key >= kv_len
constexpr int kMaskedS32 = -(1 << 22);       // K7: below every int8 QK sum

// ---------------------------------------------------------------------------
// K7, K28 and K19: k7::sparse_i8_vt_kernel<SRC> (warp-specialised, wgmma
// fed by TMA)
// ---------------------------------------------------------------------------

namespace k7 {

// the kernel's source layouts
constexpr int kPanels = 0;       // K7: K6's K panel and V^T panel, one K scale a block
constexpr int kPacked = 1;       // K28: K27's packed K|V rows, one K scale a block
constexpr int kPackedRows = 2;   // K19: K18's packed K|V rows, a K and a V scale a key

constexpr int kRows = 128;                 // query rows a block: two warpgroups of 64
constexpr int kKeys = 128;                 // keys a chunk
constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kStages = 3;
constexpr int kThreadsK7 = 3 * kWG;        // producer warpgroup + two consumers
constexpr int kRegs = 168, kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kRegs == 65536 / kThreadsK7 / 8 * 8, "registers a thread at launch");
static_assert(kProducerRegs * kWG + 2 * kConsumerRegs * kWG <= kRegs * kThreadsK7,
              "setmaxnreg within the block's allocation");
constexpr int kConvThreads = 3 * 32;       // producer warps 1-3 convert V
constexpr int kQBytes = kRows * kDh;       // int8 Q, 128-byte swizzled rows
constexpr int kKBytes = kKeys * kDh;       // int8 K rows of the chunk
constexpr int kViBytes = kDh * kKeys;      // int8 V^T (channel rows of 128 keys)
constexpr int kVbAtom = kDh * 64 * 2;      // bf16 V^T, 64 keys (128 bytes) a row
constexpr int kStageBytes = kKBytes + kViBytes + 2 * kVbAtom;
constexpr int kBars = kQBytes + kStages * kStageBytes;
// q, then full / ready / empty a stage
constexpr int kSmem = kBars + (1 + 3 * kStages) * 8 + 1024;
// K19: each stage's 128 K and 128 V scales, after the barriers
constexpr int kScalesAt = kBars + 128, kScaleBytes = 2 * kKeys * 4;
constexpr int kSmemRows = kScalesAt + kStages * kScaleBytes + 1024;
static_assert(kSmemRows <= 232448, "one block an SM");
// the linear branch's epilogue, over the stages: phi (kRows rows) and kvw
constexpr int kPhiStride = kDh + 4;
static_assert(kRows * kPhiStride * 4 + kDh * kDh * 4 <= kStages * kStageBytes,
              "phi and kvw fit in the stages");

struct VtParams {
  const float* qs;      // (B, H, Lp) q row scales
  const float* ks;      // (B, H, nK) K block scales (K19: (B, H, Lkp) K row scales)
  const float* vch;     // (B, H, 128) V channel scales (K19: (B, H, Lkp) V row scales)
  const int* lut;       // (B, H, nQ, sel)
  const int8_t* qi;     // (B, H, Lp, 128) (the linear branch's phi)
  const float* kvw;     // (B, H, 128, 128) or null
  const float* ksb;     // (B, H, 2, 128): ksum, bias
  __nv_bfloat16* out;   // (B, H, Lp, 128)
  int H, Lp, Lkp, kv_len, nQ, sel, block_q, block_k;
  float scale_log2;
};

// four int8 (a word) as two bf16 pairs, exactly and on the integer and fp32
// adders (not the conversion unit the softmax's exp2 and P packing load):
// byte + 128 in the low bits of 2^23 (a prmt), less 2^23 + 128; the fp32
// value of an integer |v| <= 128 has zeros in its low 16 bits, so its bf16
// is its high half (a prmt packs two)
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(
        __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | k)), 8388736.f));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// Grid (Lp / 128, H, B): a block owns 128 query rows of one (b, h) (inside
// one Q block of the LUT: block_q is a multiple of 128) and walks the
// 128-key chunks of the K blocks its LUT row selects. Warp 0 of the producer
// warpgroup loads Q once and, for each chunk, K (keys x 128 int8, as K6
// writes it) and V^T (128 channels x the chunk's keys) by TMA into a 3-stage
// ring; warps 1-3 convert each chunk's V to bf16 once, into the K-major
// swizzled layout wgmma reads. Packed (K28, K19): K and V are the two
// halves of K27's / K18's 256-byte rows, V keys x channels, converted into
// an MN-major tile; K19's chunk brings its 128 K and 128 V row scales along
// (one bulk copy each). Each consumer warpgroup owns 64 rows: S = Q K^T on
// wgmma s8 (Q and K from shared memory), the scales, the tail mask and the
// online softmax in fp32 registers, then O += bf16(P) V on wgmma bf16 with
// P in registers (the m16n8k16 A fragment the S accumulator already is;
// K19: P times each key's V scale before its bf16 rounding). Fragment of a
// consumer thread (warp w, lane l): register i holds row 16 w + l / 4 + 8
// ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
template <int SRC>
__global__ void __launch_bounds__(kThreadsK7, 1)
sparse_i8_vt_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const VtParams p) {
  constexpr bool PACKED = SRC != kPanels, ROWS = SRC == kPackedRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles: 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qbar = base + kBars, full0 = qbar + 8, ready0 = full0 + 8 * kStages;
  const uint32_t empty0 = ready0 + 8 * kStages;
  const uint32_t scales0 = base + kScalesAt;   // K19: stage s's K scales, then its V scales
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const size_t bh = (size_t)blockIdx.z * p.H + blockIdx.y;
  const int nK = p.Lkp / p.block_k;
  const int* lut_row = p.lut + (bh * p.nQ + row0 / p.block_q) * p.sel;
  // fn(kb, off) for the chunks the LUT row names, in order: the 128-key
  // chunks of K block kb that start before kv_len (an id out of range
  // names none)
  auto for_chunks = [&](auto&& fn) {
#pragma unroll 1
    for (int j = 0; j < p.sel; ++j) {
      const int kb = lut_row[j];
      if (kb < 0 || kb >= nK) continue;
      const int keys = min(p.block_k, p.kv_len - kb * p.block_k);
#pragma unroll 1
      for (int off = 0; off < keys; off += kKeys) fn(kb, off);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll 1
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kConvThreads);
      mbar_init(empty0 + 8 * s, 2);   // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      // ---- loads ----
      mbar_arrive_expect_tx(qbar, kQBytes);
      tma_load(&tm_q, base, qbar, 0, (int)(bh * p.Lp + row0));
      int i = 0;
      for_chunks([&](int kb, int off) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t st = base + kQBytes + s * kStageBytes, full = full0 + 8 * s;
        const int krow = (int)(bh * p.Lkp + kb * p.block_k + off);
        mbar_arrive_expect_tx(full, kKBytes + kViBytes + (ROWS ? kScaleBytes : 0));
        tma_load(&tm_k, st, full, 0, krow);
        if (PACKED)   // the V half of the same rows: keys x channels
          tma_load(&tm_v, st + kKBytes, full, 0, krow);
        else
          tma_load(&tm_v, st + kKBytes, full, off, (int)((bh * nK + kb) * kDh));
        if (ROWS) {   // the keys' K and V row scales
          const uint32_t sd = scales0 + s * kScaleBytes;
          bulk_load(sd, p.ks + krow, kKeys * 4, full);
          bulk_load(sd + kKeys * 4, p.vch + krow, kKeys * 4, full);
        }
        ++i;
      });
    } else if (tid >= 32) {
      // ---- V: int8 -> bf16, once a chunk ----
      // unit u: row d of the swizzled int8 tile (a channel of V^T; PACKED:
      // a key of V as it lies), its 16 bytes q -> half q / 4 of the bf16
      // tile (a K-major atom of 64 keys; PACKED: an MN-major box of 64
      // channels), the same bytes moved either way; eight lanes take eight
      // rows of one q, so both the swizzled reads and the swizzled writes
      // hit 32 banks
      const int ct = tid - 32;
      int i = 0;
      for_chunks([&](int, int) {
        const int s = i % kStages;
        mbar_wait(full0 + 8 * s, (i / kStages) & 1);
        const unsigned char* vi = smem + kQBytes + s * kStageBytes + kKBytes;
        unsigned char* vb = smem + kQBytes + s * kStageBytes + kKBytes + kViBytes;
#pragma unroll 4
        for (int u = ct; u < kDh * 8; u += kConvThreads) {
          const int d = (u & 7) | ((u >> 6) << 3), q = (u >> 3) & 7;
          const uint4 w = *reinterpret_cast<const uint4*>(vi + d * kKeys + ((q ^ (d & 7)) << 4));
          const uint2 b0 = i8x4_bf16(w.x), b1 = i8x4_bf16(w.y), b2 = i8x4_bf16(w.z),
                      b3 = i8x4_bf16(w.w);
          // bytes 16 q .. 16 q + 15: half q / 4, 16-byte chunks 2 (q % 4) and + 1
          unsigned char* row = vb + (q >> 2) * kVbAtom + d * 128;
          const int c0 = 2 * (q & 3);
          *reinterpret_cast<uint4*>(row + ((c0 ^ (d & 7)) << 4)) = make_uint4(b0.x, b0.y, b1.x, b1.y);
          *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (d & 7)) << 4)) =
              make_uint4(b2.x, b2.y, b3.x, b3.y);
        }
        fence_async_shared();   // wgmma reads them through the async proxy
        mbar_arrive(ready0 + 8 * s);
        ++i;
      });
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = tid / kWG - 1, lt = tid % kWG, warp = lt >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int rl0 = cw * 64 + warp * 16 + (lane >> 2), rl1 = rl0 + 8;   // block rows
  const float qs0 = p.qs[bh * p.Lp + row0 + rl0], qs1 = p.qs[bh * p.Lp + row0 + rl1];
  // K19: the logits times log2 e are S times the key's K scale times these
  const float qr0 = qs0 * p.scale_log2, qr1 = qs1 * p.scale_log2;
  const uint32_t qa = base + cw * 64 * kDh;       // this warpgroup's Q rows

  // Each consumer issues a chunk's QK and the previous chunk's P V
  // together, then runs the chunk's softmax under that P V (and under the
  // other consumer's products).

  float o[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  int sc[64];
  uint32_t pa[32];

  // O += bf16(P) V of the chunk in stage s: V^T converted, two 64-key atoms
  // (K-major); PACKED: V converted as it lies, keys x channels (MN-major,
  // the transpose bit: a 16-key step is two 8-row groups, 2048 bytes, the
  // next 64 channels one box on), as K4 reads bf16 V
  auto issue_pv = [&](int s, int i) {
    mbar_wait(ready0 + 8 * s, (i / kStages) & 1);
    const uint32_t vb = base + kQBytes + s * kStageBytes + kKBytes + kViBytes;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      if (PACKED)
        wgmma_bf16_rs<1>(o, pa + 4 * kk, sw128_desc_mn(vb + kk * 2048, kVbAtom));
      else
        wgmma_bf16_rs(o, pa + 4 * kk, sw128_desc(vb + (kk >> 2) * kVbAtom + (kk & 3) * 32));
    }
    wgmma_commit();
  };

  mbar_wait(qbar, 0);
  int i = 0, prev = -1;   // prev: the stage of the chunk whose P V is pending
  for_chunks([&](int kb, int off) {
    const int key0 = kb * p.block_k + off;
    const int s = i % kStages;
    const uint32_t st = base + kQBytes + s * kStageBytes;
    const float ks_eff = ROWS ? 0.f : p.ks[bh * nK + kb] * p.scale_log2;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    // S = Q K^T, exact s32 (64 rows x 128 keys); then the previous P V
    reg_fence<64>(o);
    reg_fence<32>(pa);
    wgmma_fence();
    wgmma_s8_first(sc, sw128_desc(qa), sw128_desc(st));
#pragma unroll
    for (int kk = 1; kk < kDh / 32; ++kk)
      wgmma_s8(sc, sw128_desc(qa + kk * 32), sw128_desc(st + kk * 32));
    wgmma_commit();
    if (prev >= 0) issue_pv(prev, i - 1);
    if (prev >= 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    reg_fence<64>(sc);

    // s = s32 * (qs * ks * Dh^-0.5 * log2 e), the online softmax in the
    // log2 domain. The scales are positive, so a row's max is its largest
    // exact s32 sum, taken on the integers; keys >= kv_len (only in a K
    // block's last chunk before kv_len) never win it and get p = 0, as
    // their -1e9 gives the plain version. The s32 sums (|s| <= 127^2 * 128
    // < 2^22) become fp32 exactly as 1.5 * 2^23 + s less 1.5 * 2^23, and
    // exp2(s32 * scale - max) is one FFMA and the SFU's exp2
    const int nvalid = p.kv_len - key0;
    const bool tail = nvalid < kKeys;
    const float* ksr = reinterpret_cast<const float*>(smem + kScalesAt + s * kScaleBytes);
    float sf[64];
    float alpha0, alpha1;
    if constexpr (ROWS) {
      // K19: S = s32 times the key's K scale in fp32, a key >= kv_len
      // selected to kMasked (its scale may be NaN); a scale a key, so the
      // row max is taken over these; then exp2(S qs scale log2 e - max)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 k2 = *reinterpret_cast<const float2*>(ksr + 8 * j + 2 * t);
        sf[4 * j] = s32_float(sc[4 * j]) * k2.x;
        sf[4 * j + 1] = s32_float(sc[4 * j + 1]) * k2.y;
        sf[4 * j + 2] = s32_float(sc[4 * j + 2]) * k2.x;
        sf[4 * j + 3] = s32_float(sc[4 * j + 3]) * k2.y;
      }
      if (tail) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sf[e] = kMasked;
      }
      float mx0 = row_tree<true, 0>(sf), mx1 = row_tree<true, 2>(sf);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * qr0), mn1 = fmaxf(m1, mx1 * qr1);
      alpha0 = ex2_approx(m0 - mn0);
      alpha1 = ex2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < 64; ++e)
        sf[e] = ex2_approx(fmaf(sf[e], (e & 2) ? qr1 : qr0, (e & 2) ? -mn1 : -mn0));
    } else {
      // s = s32 * (qs * ks * Dh^-0.5 * log2 e), the online softmax in the
      // log2 domain. The scales are positive, so a row's max is its largest
      // exact s32 sum, taken on the integers; keys >= kv_len (only in a K
      // block's last chunk before kv_len) never win it and get p = 0, as
      // their -1e9 gives the plain version. The s32 sums (|s| <= 127^2 * 128
      // < 2^22) become fp32 exactly as 1.5 * 2^23 + s less 1.5 * 2^23, and
      // exp2(s32 * scale - max) is one FFMA and the SFU's exp2
      const float qk0 = qs0 * ks_eff, qk1 = qs1 * ks_eff;
      if (tail) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sc[e] = kMaskedS32;
      }
      // row maxima and sums as trees over the thread's 32 values a row
      // (registers e with e & 2 clear: row g; set: row g + 8)
      int im0 = row_tree<true, 0>(sc), im1 = row_tree<true, 2>(sc);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        im0 = max(im0, __shfl_xor_sync(0xffffffffu, im0, off));
        im1 = max(im1, __shfl_xor_sync(0xffffffffu, im1, off));
      }
      const float mn0 = fmaxf(m0, s32_float(im0) * qk0), mn1 = fmaxf(m1, s32_float(im1) * qk1);
      alpha0 = ex2_approx(m0 - mn0);
      alpha1 = ex2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < 64; ++e)
        sf[e] = ex2_approx(fmaf(s32_float(sc[e]), (e & 2) ? qk1 : qk0, (e & 2) ? -mn1 : -mn0));
    }
    if (tail) {
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if (8 * (e >> 2) + 2 * t + (e & 1) >= nvalid) sf[e] = 0.f;
    }
    const float rs0 = row_tree<false, 0>(sf), rs1 = row_tree<false, 2>(sf);
    // the previous P V is done: its stage is free, O and P are ours
    wgmma_wait<0>();
    reg_fence<64>(o);
    reg_fence<32>(pa);
    if (prev >= 0 && lt == 0) mbar_arrive(empty0 + 8 * prev);
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    // (a warp whose row maxima all held skips the multiply by 1)
    if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] *= (e & 2) ? alpha1 : alpha0;
    }
    // P as the A fragments of the 8 k16 steps: keys 16 kk .. 16 kk + 15
    // (K19: bf16(p * vs[key]), the V scale of a key >= kv_len selected to 0)
    if constexpr (ROWS) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 v2 = *reinterpret_cast<const float2*>(ksr + kKeys + 8 * j + 2 * t);
        if (tail) {
          v2.x = 8 * j + 2 * t < nvalid ? v2.x : 0.f;
          v2.y = 8 * j + 2 * t + 1 < nvalid ? v2.y : 0.f;
        }
        pa[2 * j] = pack_bf16(sf[4 * j] * v2.x, sf[4 * j + 1] * v2.y);
        pa[2 * j + 1] = pack_bf16(sf[4 * j + 2] * v2.x, sf[4 * j + 3] * v2.y);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) pa[e] = pack_bf16(sf[2 * e], sf[2 * e + 1]);
    }
    prev = s;
    ++i;
  });
  if (prev >= 0) {
    reg_fence<64>(o);
    reg_fence<32>(pa);
    wgmma_fence();
    issue_pv(prev, i - 1);
    wgmma_wait<0>();
    reg_fence<64>(o);
    reg_fence<32>(pa);
    if (lt == 0) mbar_arrive(empty0 + 8 * prev);
  }

  // o = O / max(l, 1e-20) * vch (K19: o = O / max(l, 1e-20))
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  if constexpr (ROWS) {
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] /= (e & 2) ? l1 : l0;
  } else {
    const float* vc = p.vch + bh * kDh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 sc2 = *reinterpret_cast<const float2*>(vc + j * 8 + t * 2);
      o[4 * j] = __fmul_rn(o[4 * j] / l0, sc2.x);
      o[4 * j + 1] = __fmul_rn(o[4 * j + 1] / l0, sc2.y);
      o[4 * j + 2] = __fmul_rn(o[4 * j + 2] / l1, sc2.x);
      o[4 * j + 3] = __fmul_rn(o[4 * j + 3] / l1, sc2.y);
    }
  }

  if (!PACKED && p.kvw != nullptr) {
    // the SLA linear branch: o += phi(q) kvw / (1e-5 + phi(q) . ksum) + b,
    // phi and kvw in the stages once both warpgroups are done with them
    named_sync(1, 2 * kWG);
    float* phi = reinterpret_cast<float*>(smem + kQBytes);
    float* kvs = phi + kRows * kPhiStride;
    const float* ksum = p.ksb + bh * 2 * kDh;
    const float* bias = ksum + kDh;
    const float4* kw = reinterpret_cast<const float4*>(p.kvw + bh * kDh * kDh);
#pragma unroll 4
    for (int u = tid - kWG; u < kDh * kDh / 4; u += 2 * kWG)
      reinterpret_cast<float4*>(kvs)[u] = kw[u];
    float den[2];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int rl = which ? rl1 : rl0;
      const float qsr = which ? qs1 : qs0;
      const int8_t* qrow = p.qi + (bh * p.Lp + row0 + rl) * kDh + t * 32;
      uint4 qraw[2];
      qraw[0] = *reinterpret_cast<const uint4*>(qrow);
      qraw[1] = *reinterpret_cast<const uint4*>(qrow + 16);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(qraw);
      float f[32];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        f[e] = __fmul_rn((float)q8[e], qsr);
        mx = fmaxf(mx, f[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        f[e] = expf(f[e] - mx);
        sum += f[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      float dp = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        f[e] = f[e] / sum;
        dp += f[e] * ksum[t * 32 + e];
        phi[rl * kPhiStride + t * 32 + e] = f[e];
      }
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      den[which] = 1e-5f + dp;
    }
    named_sync(1, 2 * kWG);   // phi and kvw written
    float num[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) num[e] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < kDh; ++dd) {
      const float p0 = phi[rl0 * kPhiStride + dd], p1 = phi[rl1 * kPhiStride + dd];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 kv2 = *reinterpret_cast<const float2*>(kvs + dd * kDh + j * 8 + t * 2);
        num[4 * j] = fmaf(p0, kv2.x, num[4 * j]);
        num[4 * j + 1] = fmaf(p0, kv2.y, num[4 * j + 1]);
        num[4 * j + 2] = fmaf(p1, kv2.x, num[4 * j + 2]);
        num[4 * j + 3] = fmaf(p1, kv2.y, num[4 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + t * 2);
      o[4 * j] = (o[4 * j] + num[4 * j] / den[0]) + bb.x;
      o[4 * j + 1] = (o[4 * j + 1] + num[4 * j + 1] / den[0]) + bb.y;
      o[4 * j + 2] = (o[4 * j + 2] + num[4 * j + 2] / den[1]) + bb.x;
      o[4 * j + 3] = (o[4 * j + 3] + num[4 * j + 3] / den[1]) + bb.y;
    }
  }

  __nv_bfloat16* ob = p.out + (bh * p.Lp + row0) * kDh;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(ob + (size_t)rl0 * kDh + col) = pack_bf16(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(ob + (size_t)rl1 * kDh + col) =
        pack_bf16(o[4 * j + 2], o[4 * j + 3]);
  }
}

// K7 (kp the K panel, vtp the V^T panel) or, packed, K28 / K19 (kp the
// packed (B, H, Lkp, 256) K|V rows; vtp unused: V is the second half of each
// row)
template <int SRC>
int launch(const void* qi, const void* kp, const void* vtp, const VtParams& p, int B,
           void* stream) {
  constexpr bool PACKED = SRC != kPanels, ROWS = SRC == kPackedRows;
  constexpr int smem = ROWS ? kSmemRows : kSmem;
  if (p.Lp % kRows || p.block_q % kRows || p.block_k % kKeys || p.Lkp % p.block_k)
    return (int)cudaErrorInvalidValue;
  // K19's scales come by bulk copies: 16-byte aligned
  if (ROWS && ((uintptr_t)p.ks % 16 || (uintptr_t)p.vch % 16)) return (int)cudaErrorInvalidValue;
  static const int ready = [] {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, sparse_i8_vt_kernel<SRC>);
    if (err != cudaSuccess) return (int)err;
    // the register count setmaxnreg assumes (else refuse, not hang)
    if (fa.numRegs != kRegs) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaFuncSetAttribute(sparse_i8_vt_kernel<SRC>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (ready != 0) return ready;
  const long long bh = (long long)B * p.H;
  CUtensorMap tq, tk, tv;
  // packed: K at column 0 and V at column 128 of the 256-byte rows
  const bool maps =
      tile_map(&tq, qi, false, bh * p.Lp, kDh, kRows) &&
      (PACKED ? tile_map(&tk, kp, false, bh * p.Lkp, kDh, kKeys, 2 * kDh) &&
                    tile_map(&tv, (const int8_t*)kp + kDh, false, bh * p.Lkp, kDh, kKeys,
                             2 * kDh)
              : tile_map(&tk, kp, false, bh * p.Lkp, kDh, kKeys) &&
                    tile_map(&tv, vtp, false, bh * (p.Lkp / p.block_k) * kDh, p.block_k, kDh));
  if (!maps) return (int)cudaErrorInvalidValue;
  sparse_i8_vt_kernel<SRC>
      <<<dim3(p.Lp / kRows, p.H, B), kThreadsK7, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace k7


// K19 (BS false) and K28 at blocks off 128 (BS true). Grid (Lp / 64, H, B), 4 warps of 16
// query rows. K19: ks and vs are per-key row scales (B, H, Lkp) and `scale`
// is Dh^-0.5; K28: ks is the per-block table (B, H, nK), vs the per-channel
// V scale (B, H, 128) and `scale` is Dh^-0.5 * log2 e.
template <bool BS>
__global__ void __launch_bounds__(kThreads)
sparse_i8_planes_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qs,
                        const int8_t* __restrict__ kvi, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lut,
                        __nv_bfloat16* __restrict__ out, int H, int Lp, int Lkp, int kv_len,
                        int nQ, int sel, int block_q, int block_k, float scale) {
  __shared__ __align__(16) unsigned char smem[kMainBytes];
  __shared__ float s_ks[kBN], s_vs[kBN];
  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + kBM * kKStride);

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const int nK = Lkp / block_k;

  // Q rows -> int8 A fragments, as K7
  const int8_t* qb = qi + (bh * Lp + row0) * kDh;
  for (int u = threadIdx.x; u < kBM * (kDh / 16); u += kThreads) {
    const int r = u >> 3, c = u & 7;
    *reinterpret_cast<uint4*>(Ks + r * kKStride + c * 16) =
        *reinterpret_cast<const uint4*>(qb + (size_t)r * kDh + c * 16);
  }
  __syncthreads();
  uint32_t qa[kDh / 32][4];
  {
    const int8_t* base = Ks + (warp * 16) * kKStride;
#pragma unroll
    for (int kk = 0; kk < kDh / 32; ++kk) {
      qa[kk][0] = lds32(base + g * kKStride + kk * 32 + t * 4);
      qa[kk][1] = lds32(base + (g + 8) * kKStride + kk * 32 + t * 4);
      qa[kk][2] = lds32(base + g * kKStride + kk * 32 + 16 + t * 4);
      qa[kk][3] = lds32(base + (g + 8) * kKStride + kk * 32 + 16 + t * 4);
    }
  }
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  // K19: the softmax scale folds into the row scale (flash_pallas.py:1319);
  // K28: it rides the K block-scale table, as the TPU wrapper folds it
  const float qs0 = BS ? qs[bh * Lp + r0] : __fmul_rn(qs[bh * Lp + r0], scale);
  const float qs1 = BS ? qs[bh * Lp + r1] : __fmul_rn(qs[bh * Lp + r1], scale);

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;

  const int* lut_row = lut + (bh * nQ + row0 / block_q) * sel;
  const int per = block_k / kBN;
  const int n_chunks = sel * per;
  for (int c = 0; c < n_chunks; ++c) {
    const int kb = lut_row[c / per];
    const int key0 = kb * block_k + (c % per) * kBN;
    if (kb < 0 || kb >= nK || key0 >= kv_len) continue;
    __syncthreads();  // previous chunk (or the Q staging) fully consumed
    const int8_t* src = kvi + (bh * Lkp + key0) * (2 * kDh);
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u >> 3, cc = u & 7;
      *reinterpret_cast<uint4*>(Ks + r * kKStride + cc * 16) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * 2 * kDh + cc * 16);
    }
    // V half -> bf16 (exact), transposed: keys walk fastest so the 2-byte
    // shared stores of a warp fall in distinct words
    for (int u = threadIdx.x; u < kBN * (kDh / 16); u += kThreads) {
      const int r = u % kBN, c16 = u / kBN;
      const uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * 2 * kDh + kDh + c16 * 16);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int e = 0; e < 16; ++e) Vt[(c16 * 16 + e) * kVStride + r] = __float2bfloat16_rn((float)q8[e]);
    }
    if (!BS && threadIdx.x < kBN) {
      const int key = key0 + threadIdx.x;
      const bool live = key < kv_len;
      s_ks[threadIdx.x] = live ? ks[bh * Lkp + key] : 0.f;
      s_vs[threadIdx.x] = live ? vs[bh * Lkp + key] : 0.f;
    }
    // K28: the block's scale times Dh^-0.5 * log2 e (the TPU wrapper's
    // table), one product in fp32
    const float kb_scale = BS ? __fmul_rn(ks[bh * nK + kb], scale) : 0.f;
    __syncthreads();

    // K19: s = (s32 * qs') * ks[key], keys >= kv_len at -1e30; K28: s =
    // (s32 * qs) * kb_scale in the log2 domain, keys >= kv_len at -1e9
    // before the row max
    const int nvalid = kv_len - key0;
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < kDh / 32; ++kk) {
        const int8_t* kq = Ks + (j * 8 + g) * kKStride + kk * 32 + t * 4;
        mma_s8(si, qa[kk], lds32(kq), lds32(kq + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float v = __fmul_rn(__fmul_rn((float)si[e], e < 2 ? qs0 : qs1),
                                  BS ? kb_scale : s_ks[col]);
        s[j][e] = col < nvalid ? v : (BS ? kMasked : kNegInf);
      }
    }

    if constexpr (BS) {
      // exp2; O += bf16(p) V, V's channel scale at the finalize
      softmax_pv_step<true, kVStride>(s, acc, m0, m1, l0, l1, Vt);
    } else {
      // natural exp; O += bf16(p * vs) V
      softmax_pv_step<false, kVStride>(s, acc, m0, m1, l0, l1, Vt, s_vs);
    }
  }

  // o = acc / max(l, 1e-20) (K28: times the per-channel V scale)
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = fmaxf(l0, 1e-20f);
  l1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* ob = out + bh * Lp * kDh;
  const float* vc = vs + bh * kDh;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + t * 2;
    float o[4] = {__fdiv_rn(acc[d][0], l0), __fdiv_rn(acc[d][1], l0),
                  __fdiv_rn(acc[d][2], l1), __fdiv_rn(acc[d][3], l1)};
    if constexpr (BS) {
      const float2 sc = *reinterpret_cast<const float2*>(vc + col);
      o[0] = __fmul_rn(o[0], sc.x);
      o[1] = __fmul_rn(o[1], sc.y);
      o[2] = __fmul_rn(o[2], sc.x);
      o[3] = __fmul_rn(o[3], sc.y);
    }
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kDh + col) = pack_bf16(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kDh + col) = pack_bf16(o[2], o[3]);
  }
}

// The kernel a K19 or K28 launch takes (ops/sparse_i8_attention.py
// `sparse_i8_planes_form` / `sparse_i8_planes_bs_form` mirror it): 1, K7's
// kernel on the packed rows (`k7::sparse_i8_vt_kernel<2>` / `<1>`), for
// blocks that are multiples of 128 (fused sagesla's always are); 0, the
// mma.sync loop (`sparse_i8_planes_kernel<false>` / `<true>`), for the other
// multiples of 64; -1, refused: other blocks, blocks that do not divide the
// padded lengths, or kv_len outside (0, Lkp].
int planes_form(int Lp, int Lkp, int kv_len, int block_q, int block_k) {
  if (block_q <= 0 || block_k <= 0 || block_q % kBM || block_k % kBN || Lp <= 0 ||
      Lp % block_q || Lkp <= 0 || Lkp % block_k || kv_len <= 0 || kv_len > Lkp)
    return -1;
  return block_q % k7::kRows == 0 && block_k % k7::kKeys == 0 ? 1 : 0;
}

}  // namespace

extern "C" int tdx_sparse_attention_i8_vt(
    const void* qi, const void* qs, const void* kp, const void* vtp, const void* ks,
    const void* vch, const void* lut, const void* kvw, const void* ksb, void* out,
    int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel, int block_q,
    int block_k, float scale_log2, void* stream) {
  k7::VtParams p = {};
  p.qs = (const float*)qs;
  p.ks = (const float*)ks;
  p.vch = (const float*)vch;
  p.lut = (const int*)lut;
  p.qi = (const int8_t*)qi;
  p.kvw = (const float*)kvw;
  p.ksb = (const float*)ksb;
  p.out = (__nv_bfloat16*)out;
  p.H = H;
  p.Lp = Lp;
  p.Lkp = Lkp;
  p.kv_len = kv_len;
  p.nQ = nQ;
  p.sel = sel;
  p.block_q = block_q;
  p.block_k = block_k;
  p.scale_log2 = scale_log2;
  return k7::launch<k7::kPanels>(qi, kp, vtp, p, B, stream);
}

extern "C" int tdx_sparse_attention_i8_planes_form(int Lp, int Lkp, int kv_len, int block_q,
                                                   int block_k) {
  return planes_form(Lp, Lkp, kv_len, block_q, block_k);
}

extern "C" int tdx_sparse_attention_i8_planes(
    const void* qi, const void* qs, const void* kvi, const void* ks, const void* vs,
    const void* lut, void* out, int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel,
    int block_q, int block_k, float scale, void* stream) {
  const int form = planes_form(Lp, Lkp, kv_len, block_q, block_k);
  if (form < 0 || nQ != Lp / block_q) return (int)cudaErrorInvalidValue;
  if (form == 1) {
    k7::VtParams p = {};
    p.qs = (const float*)qs;
    p.ks = (const float*)ks;
    p.vch = (const float*)vs;
    p.lut = (const int*)lut;
    p.qi = (const int8_t*)qi;
    p.out = (__nv_bfloat16*)out;
    p.H = H;
    p.Lp = Lp;
    p.Lkp = Lkp;
    p.kv_len = kv_len;
    p.nQ = nQ;
    p.sel = sel;
    p.block_q = block_q;
    p.block_k = block_k;
    p.scale_log2 = scale * 1.4426950408889634f;
    return k7::launch<k7::kPackedRows>(qi, kvi, nullptr, p, B, stream);
  }
  const dim3 grid(Lp / kBM, H, B);
  sparse_i8_planes_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)qs, (const int8_t*)kvi, (const float*)ks,
      (const float*)vs, (const int*)lut, (__nv_bfloat16*)out, H, Lp, Lkp, kv_len, nQ, sel,
      block_q, block_k, scale);
  return (int)cudaGetLastError();
}

extern "C" int tdx_sparse_attention_i8_planes_bs_form(int Lp, int Lkp, int kv_len, int block_q,
                                                      int block_k) {
  return planes_form(Lp, Lkp, kv_len, block_q, block_k);
}

extern "C" int tdx_sparse_attention_i8_planes_bs(
    const void* qi, const void* qs, const void* kvi, const void* ks, const void* vch,
    const void* lut, void* out, int B, int H, int Lp, int Lkp, int kv_len, int nQ, int sel,
    int block_q, int block_k, float scale_log2, void* stream) {
  const int form = planes_form(Lp, Lkp, kv_len, block_q, block_k);
  if (form < 0 || nQ != Lp / block_q) return (int)cudaErrorInvalidValue;
  if (form == 1) {
    k7::VtParams p = {};
    p.qs = (const float*)qs;
    p.ks = (const float*)ks;
    p.vch = (const float*)vch;
    p.lut = (const int*)lut;
    p.qi = (const int8_t*)qi;
    p.out = (__nv_bfloat16*)out;
    p.H = H;
    p.Lp = Lp;
    p.Lkp = Lkp;
    p.kv_len = kv_len;
    p.nQ = nQ;
    p.sel = sel;
    p.block_q = block_q;
    p.block_k = block_k;
    p.scale_log2 = scale_log2;
    return k7::launch<k7::kPacked>(qi, kvi, nullptr, p, B, stream);
  }
  const dim3 grid(Lp / kBM, H, B);
  sparse_i8_planes_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qi, (const float*)qs, (const int8_t*)kvi, (const float*)ks,
      (const float*)vch, (const int*)lut, (__nv_bfloat16*)out, H, Lp, Lkp, kv_len, nQ, sel,
      block_q, block_k, scale_log2);
  return (int)cudaGetLastError();
}
