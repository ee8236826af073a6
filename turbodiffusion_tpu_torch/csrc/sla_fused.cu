// K5, K6, K13, K15, K16, K18, K27 and K29: the fused SageSLA front-end for
// sm_90a.
//
// K5 tdx_head_planes replaces the TPU kernel
//    turbodiffusion_tpu/ops/sla_fused.py:head_planes (body _head_planes_kernel):
//    one pass over a (B, L, H*128) bf16 projection output (rows `ld` elements
//    apart, so a Q, K or V column group of the fused (B, L, 3*H*128) QKV GEMM
//    output is read in place) that writes any of
//    the bf16 head planes (B, H, Lp, 128), per-(head, token) int8 planes with
//    fp32 scales (B, H, Lp), and per-block pooled means (B, H, nP, 128) fp32,
//    with the full-row RMSNorm and the rotate-half RoPE fused in.
// K6 tdx_subquant_pack_kvt replaces sla_fused.py:subquant_pack_kvt (body
//    _subquant_pack_kvt_kernel): smooth-k subtract + per-block int8 K with one
//    fp32 scale per block_k rows (rows >= kv_len stay out of the statistic),
//    and the per-block transposed int8 V panel (B, H, nK, 128, block_k) that
//    K7 stages without a transpose; with the linear branch on, in the same
//    walk over K and V, kv = sum softmax_D(k)^T v_i8 (B, H, 128, 128) and
//    ksum = sum softmax_D(k) over rows < kv_len, as the TPU kernel folds them.
// K13 tdx_unfold_quant replaces sla_fused.py:unfold_quant, narrow form (body
//    _unfold_quant_kernel): K7's bf16 planes (B, H, Lp, Dh) -> the int8 feed of
//    the W8A8 O projection, (B, L, H*Dh) int8 with one fp32 scale per token
//    across all heads; only the L live rows are written.
// K15 tdx_row_rms_inv replaces sla_fused.py:row_rms_inv (body _row_rms_kernel):
//    (B, L, W) bf16 rows `ld` elements apart -> (B, L) fp32
//    rsqrt(mean(x^2) + eps), the full-row statistic that K17 reads for the
//    wide models (14B: dim 5120) and that K5's external-RMS mode takes.
// K18 tdx_subquant_pack_kv replaces sla_fused.py:subquant_pack_kv in its
//    per-row mode (body _subquant_pack_kernel with block_k 0), the
//    v_quant=row producer: xf = f32(k) - mu, one fp32 scale per row, int8 K
//    written into the first half of a packed (B, H, Lp, 256) K|V row and the
//    per-row int8 V row (K5's) copied into the second half: the layout K19
//    gathers, one 256-byte row a key. No trailing poison block and no
//    (TL/128, 128) scale relayout: K19 masks keys past kv_len by column.
// K27 tdx_subquant_pack_kv_blocks replaces sla_fused.py:subquant_pack_kv in
//    its block-scale mode (body _subquant_pack_kernel with block_k), the
//    producer of the block-scale sparse kernel (K28) that fused sagesla at
//    v_quant=channel takes once sel * block_k exceeds 8,192: K6's block
//    statistic (max |k - mu| over the block's rows < kv_len; rows past it
//    may hold NaN and stay out), every row of the block quantised with it,
//    written into K18's packed (B, H, Lp, 256) K|V layout with the int8 V
//    row beside it; one fp32 scale per (b, h, K block). No poison block.
// K29 tdx_subquant_planes replaces sla_fused.py:subquant_planes (body
//    _subquant_kernel): K18's per-row rule without the packing, (B, H, Lp,
//    128) bf16 planes minus mu -> int8 planes and (B, H, Lp) fp32 scales.
// K16 tdx_unfold_quant_wide replaces sla_fused.py:unfold_quant, wide form
//    (H*Dh > 4096; bodies _unfold_scale_kernel and _unfold_write_kernel, two
//    TPU passes): K13's function with the wide kernel's rule, one launch.
//
// What bounds them on an H100: memory. A K5 pass reads the 100.6 MB
// projection (1.3B, 480p: L = 32,760, H*Dh = 1536) and writes 51-101 MB at
// a few FLOPs per byte; K6 reads 151 MB of K and V and writes 101 MB. The
// designs move each byte once:
//   * K5: K2's warp-per-row kernel (warp_rows.cuh): a row takes one warp,
//     or 4 at the 14B's 5120, 8-warp blocks walk 64-row tiles persistently,
//     each lane loads its share of the row once as 16-byte vectors and holds
//     it as packed bf16. A 32-vector span is two heads of 16 lanes, so the
//     RoPE partner is a shuffle (lane ^ 8), a head's int8 absmax two warp
//     max reductions (redux.sync on the bits, one a half-warp), and
//     a lane's bf16 (16 bytes) and int8 (8 bytes) vectors are stored where
//     the (B, H, Lp, 128) planes hold them, streaming. The row's RMS is the
//     warp's sum of squares (a wide row's warps exchange theirs once behind a
//     named barrier), or the external one. The pooled sums are kept per lane
//     in shared-memory slots of its own, combined in group order into one
//     partial per 64-row tile, and the last tile of each pool window (an
//     atomic counter) sums that window's partials in order: one launch,
//     deterministic, no fp32 atomics on the data.
//   * K6 (k6::pack_kvt_kernel): persistent blocks of four warpgroups, one an
//     SM, each walking a run of K blocks (runs split the flat (b, h, K block)
//     order evenly, so 12 heads and 40 fill the card alike). A block's K rows
//     and V rows arrive by two bulk copies (TMA) into one of two stages while
//     the block before is worked: its statistic from shared memory, the int8
//     K rows quantised from there (one read of K), V transposed 8 x 16 bytes
//     a thread with byte permutes. With the linear branch (the run split,
//     the step's phi and the ordered reduce shared with K21's kv pass through
//     linear_kv.cuh), each 32-row step
//     writes 2^8 phi (phi = softmax_D(k)) split into fp16 hi + lo (hi =
//     fp16(2^8 phi), lo = fp16(2^8 phi - hi): ~2^-22 of phi; a bf16 split,
//     ~2^-17, left kv 5e-4 from its plain version at L = 3,000, past the
//     1e-4 it is held to) and V as fp16 (exact) into swizzled tiles, and each
//     warpgroup issues phi^T V for its 64 x 64 quadrant of kv on wgmma (both
//     operands MN-major, fp32 accumulation) while the threads quantise the
//     step's K rows; the steps run in lockstep (builder and MMA warpgroups
//     apart, setmaxnreg 80 / 168, spilled and ran 2.6x slower). A step's products go into a zeroed fragment that is then added
//     to an fp32 register sum (a chain through the accumulator truncates
//     step by step); ksum is summed on the CUDA cores.
//     Rows >= kv_len are zeros in the operand tiles (NaN x 0 is NaN on a
//     tensor core). Each block writes its run's sums of a head as one fp32
//     partial; k6::kv_reduce_kernel adds a head's partials in run order:
//     deterministic, no atomics. Bound: bytes (1.3B 480p: 100.7 MB of K and
//     50.3 MB of V in, 50.3 MB of kp and of vtp out: 0.075 ms); the two fp16
//     products are 0.026 ms at the dense peak.
//   * K27: a 256-thread block per (b, h, K block): the statistic, then a
//     second read of the block (an L2 hit), K written at a 256-byte row
//     stride and the V rows copied beside it 16 bytes a thread (1.3B 480p:
//     100.7 MB of K and 50.3 MB of V in, 100.7 MB out).
//   * K29: K18's warp-a-row kernel writing the int8 row alone (100.7 MB in,
//     50.3 MB and 1.6 MB of scales out).
//   * K18: memory-bound (1.3B 480p: 100.7 MB of K and 50.3 MB of V in,
//     100.7 MB of K|V and 1.6 MB of scales out, 0.076 ms). One warp per row,
//     8-byte K loads, 4-byte V copies and 4-byte int8 stores a lane, all
//     coalesced; the row absmax is one warp reduction. K8's rule (fp32
//     subtract, 1.0f / scale then a multiply, round half to even), so it is
//     bit-equal to the TPU kernel.
// The arithmetic follows the JAX chain: RMS over the whole row in fp32, a
// bf16 round, a bf16 product with the weight, fp32 RoPE; the int8 plane and
// the pooled means come from that fp32 value; scale = max(amax, 1e-8) *
// (1/127), q = round-half-even(y * (1/scale)) saturated to +-127. Products
// and sums that the plain version rounds one by one use __fmul_rn /
// __fadd_rn so nvcc does not contract them into FMAs.
//   * K13: memory-bound too (100.6 MB in, 50.4 MB out at the main shape:
//     0.045 ms). One warp per token: each lane loads 16-byte chunks of the
//     token's head slices (a warp reads two heads' 256-byte rows at a time),
//     keeps them in registers for the absmax and the quantise, and the warp
//     writes the token's 1536-byte int8 row as contiguous 8-byte stores. The
//     rule is K8's (csrc/quant.cu) on the unfolded bf16 row, so the two agree
//     bit for bit.
//   * K15: 335.5 MB in at 14B (0.100 ms). One warp per row, 16-byte loads,
//     an fp32 sum of squares per lane, one warp reduction.
//   * K16: a token row on 2 warps (kWideRowWarps), 10 16-byte vectors a
//     lane, its absmax on packed bf16 pairs exchanged once between the
//     row's warps, and the wide kernel's rule q = round-half-even(fl(y /
//     scale)) kept without a division: fl(y / scale) as y * rcp_rn(scale)
//     corrected by one FMA residual step (quant8_wide), rounded by the
//     1.5 * 2^23 FADD. Where K13 keeps the narrow kernel's y * (1/scale).
//     Each is bit-equal to its own TPU kernel.
// K13, K15, K18, K27 and K29: a first, simple version, no cp.async or TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "linear_kv.cuh"
#include "warp_rows.cuh"

namespace {

constexpr int kDh = 128;
constexpr int kHpRows = 64;            // rows of a K5 tile: the grain of its pooled partials
// blocks an SM the path's K5 instances (VPL 5 and 6: 40 and 12 heads) are
// compiled for: 2 holds them to 128 registers (1: ptxas held some at 64 or
// 128 with spills; 3: 80 registers with spills, 5-15% slower;
// tools/time_k5_k12.py --design)
constexpr int kHpMinBlocks = 2;
constexpr int kMaxHeads = kMaxVecRow / kDh;   // K5: rows up to 8192 wide, 64 heads
constexpr float kInvInt8 = 1.0f / 127.0f;
constexpr int kSqThreads = 256;

// 8 values -> 8 int8: round half to even, saturated to +-127 (K27: a NaN row
// past kv_len gives 0, as the plain version's cast)
__device__ __forceinline__ uint2 quant8(const float* f, float inv) {
  uint32_t w[2];
#pragma unroll
  for (int hw = 0; hw < 2; ++hw) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q = __float2int_rn(__fmul_rn(f[4 * hw + i], inv));
      q = max(-127, min(127, q));
      acc |= (uint32_t)(q & 0xff) << (8 * i);
    }
    w[hw] = acc;
  }
  return make_uint2(w[0], w[1]);
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

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// K5's warp-per-row kernel, K2's design (rmsrope_rows_kernel) with K5's
// outputs: x rows `ld` elements apart (batches L rows apart), H heads of 128,
// nvec = 16 H vectors a row. A 32-vector span of a row is two heads of 16
// lanes, so lane l holds channels (l & 15) * 8 .. + 7 of each head it holds,
// its RoPE partner (channel j +- 64) is lane l ^ 8 and a head's int8 absmax
// is a max over its 16 lanes; the lane's bf16 and int8 vectors
// go straight to (b, h, row, (l & 15) * 8). A block walks 64-row tiles of
// one batch; its row groups (kRowWarps / RW of them) take the tile's rows in
// turn. With pool, a lane sums its channels over its rows of the tile in
// shared-memory slots of its own (group, vector), in row order; at the end
// of the tile the block adds the groups' slots in group order and writes the
// tile's partial, and the last tile of each pool window (an atomic counter)
// adds its window's partials in tile order and divides by the window's live
// rows: deterministic, no fp32 atomics. ri: the row's RMS inverse (B, L)
// (the TPU kernel's external-RMS mode), else the row's own (w null: no
// norm). Rows in [L, Lp) are the planes of a zero row. inv_hd = 1 / (H 128).
template <int VPL>
__global__ void __launch_bounds__(kRowThreads, VPL <= 6 ? kHpMinBlocks : 1)
head_planes_rows_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ w,
                        const float* __restrict__ ri, const float* __restrict__ cosF,
                        const float* __restrict__ sinF, uint4* __restrict__ out_bf,
                        uint2* __restrict__ out_i8, float* __restrict__ out_scale,
                        float* __restrict__ partial, float* __restrict__ pooled,
                        int* __restrict__ counters, float* __restrict__ rms_out, long long ld,
                        int B, int L, int Lp, int H, int pool, int nP, float inv_hd,
                        float eps) {
  // the weight (nvec vectors, with w), then the pooled sums (with pool): a
  // group's 2 nvec float4 slots, channels 8v..8v+3 at [v] and 8v+4..8v+7 at
  // [nvec + v], so a warp's 16-byte accesses are consecutive
  extern __shared__ uint4 hp_smem[];
  __shared__ float xch[2][kRowWarps];
  __shared__ int s_last;
  const int nvec = H * (kDh / 8), HD = H * kDh;
  const int RW = row_warps(nvec);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kRowWarps / RW, group = warp / RW, wig = warp % RW;
  uint4* s_w = hp_smem;
  float4* red = reinterpret_cast<float4*>(hp_smem + (w != nullptr ? nvec : 0));
  float4* my_red = red + group * 2 * nvec;
  if (w != nullptr)
    for (int v = threadIdx.x; v < nvec; v += kRowThreads) s_w[v] = w[v];
  __syncthreads();

  const int col = (lane & 15) * 8;      // the lane's channels in each head it holds
  const int n_tiles = Lp / kHpRows;
  const int per = pool / kHpRows;       // tiles a pool window
  // a plane row is 16 vectors; vector i of the lane is head 2 (i RW + wig) +
  // lane / 16, so its planes lie 2 RW Lp rows apart from one i to the next
  const uint32_t head_step = 2u * RW * Lp * 16;
  int parity = 0;
  for (int t = blockIdx.x; t < B * n_tiles; t += gridDim.x) {
    const int b = t / n_tiles, tile = t - b * n_tiles;
    if (pool) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int vi = vec_index(i, RW, wig, lane);
        if (vi < nvec) my_red[vi] = my_red[nvec + vi] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int l = tile * kHpRows + group; l < (tile + 1) * kHpRows; l += groups) {
      const bool valid = l < L;               // the same for the row's warps
      const size_t row = (size_t)b * L + l;
      uint4 v[VPL];
      float rms = 0.f, cs[8], sn[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) cs[q] = sn[q] = 0.f;
      if (valid) {
        load_row<VPL>(v, reinterpret_cast<const uint4*>(x + row * ld), nvec, RW, wig, lane);
        if (cosF != nullptr) {
          // the row's 8 cos and 8 sin of the lane's channels, asked for
          // before the statistic (whose exchange no load crosses)
          const float4* c4 = reinterpret_cast<const float4*>(cosF + (size_t)l * kDh + col);
          const float4* s4 = reinterpret_cast<const float4*>(sinF + (size_t)l * kDh + col);
          const float4 c0 = __ldg(c4), c1 = __ldg(c4 + 1), s0 = __ldg(s4), s1 = __ldg(s4 + 1);
          cs[0] = c0.x; cs[1] = c0.y; cs[2] = c0.z; cs[3] = c0.w;
          cs[4] = c1.x; cs[5] = c1.y; cs[6] = c1.z; cs[7] = c1.w;
          sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
          sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
        }
        if (w != nullptr && ri != nullptr) {
          rms = ri[row];
        } else if (w != nullptr) {
          // K2's statistic: the fp32 sum of squares, one exchange for a
          // wide row's warps
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = unpack2(word(v[i], k));
              s += f.x * f.x + f.y * f.y;
            }
          s = warp_sum(s);
          if (RW > 1) {
            if (lane == 0) xch[parity][warp] = s;
            row_sync(group, RW);
            s = 0.f;
#pragma unroll 1
            for (int r = 0; r < RW; ++r) s += xch[parity][group * RW + r];
            parity ^= 1;
          }
          rms = rsqrtf(div_n(s, (float)HD, inv_hd) + eps);
        }
        if (rms_out != nullptr && wig == 0 && lane == 0) rms_out[row] = rms;
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
      }

      // this lane's vector in the planes of its first head, row l
      uint32_t at = ((uint32_t)(b * H + wig * 2 + (lane >> 4)) * Lp + l) * 16 + (lane & 15);
#pragma unroll
      for (int i = 0; i < VPL; ++i, at += head_step) {
        const int vi = vec_index(i, RW, wig, lane);
        const bool live = vi < nvec;          // a head's 16 lanes alike
        uint32_t p[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        if (w != nullptr) {
          // cast to bf16 BEFORE the bf16 weight product, as WanRMSNorm does
          const uint4 wv = s_w[live ? vi : 0];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = unpack2(p[k]);
            p[k] = mul_bf16x2(pack2(f.x * rms, f.y * rms), word(wv, k));
          }
        }
        float y[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a = unpack2(p[k]);
          if (cosF != nullptr) {
            // out[j] = y[j] cos[j] + y[(j + 64) % 128] sin[j], each product
            // and the sum rounded once (the int8 and the pooled means come
            // from this fp32 value); every lane shuffles
            const float2 q = unpack2(__shfl_xor_sync(0xffffffffu, p[k], 8));
            y[2 * k] = __fadd_rn(__fmul_rn(a.x, cs[2 * k]), __fmul_rn(q.x, sn[2 * k]));
            y[2 * k + 1] =
                __fadd_rn(__fmul_rn(a.y, cs[2 * k + 1]), __fmul_rn(q.y, sn[2 * k + 1]));
          } else {
            y[2 * k] = a.x;
            y[2 * k + 1] = a.y;
          }
        }
        if (out_bf != nullptr && live)
          // without RoPE the plane is the packed row itself
          store_vec(out_bf + at,
                    cosF == nullptr ? make_uint4(p[0], p[1], p[2], p[3])
                                    : make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                                                 pack2(y[4], y[5]), pack2(y[6], y[7])));
        if (out_i8 != nullptr) {
          float amax = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(y[k]));
          const float scale = __fmul_rn(fmaxf(half_warp_max(amax, lane), 1e-8f), kInvInt8);
          if (live) {
            store_vec8(out_i8 + at, quant8_rn(y, rcp_rn(scale)));
            if ((lane & 15) == 0) out_scale[at >> 4] = scale;
          }
        }
        if (pool && valid && live) {
          float4& r0 = my_red[vi];
          float4& r1 = my_red[nvec + vi];
          r0.x += y[0]; r0.y += y[1]; r0.z += y[2]; r0.w += y[3];
          r1.x += y[4]; r1.y += y[5]; r1.z += y[6]; r1.w += y[7];
        }
      }
    }
    if (!pool) continue;

    // the tile's partial: the groups' slots in group order
    __syncthreads();
    float* part = partial + (size_t)t * HD;
    for (int c = threadIdx.x; c < 2 * nvec; c += kRowThreads) {
      float4 a = red[c];
      for (int g = 1; g < groups; ++g) {
        const float4 e = red[g * 2 * nvec + c];
        a.x += e.x; a.y += e.y; a.z += e.z; a.w += e.w;
      }
      *reinterpret_cast<float4*>(part + (c < nvec ? 8 * c : 8 * (c - nvec) + 4)) = a;
    }
    __threadfence();
    __syncthreads();
    const int pb = tile / per;
    if (threadIdx.x == 0) s_last = atomicAdd(&counters[b * (Lp / pool) + pb], 1) == per - 1;
    __syncthreads();
    if (!s_last || pb >= nP) continue;
    // the last tile of this pool window: its partials in tile order
    __threadfence();
    const float cnt = (float)min(pool, L - pb * pool);
    const float inv_cnt = rcp_rn(cnt);
    const float* first = partial + ((size_t)b * n_tiles + (size_t)pb * per) * HD;
    for (int c = threadIdx.x; c < HD; c += kRowThreads) {
      float s = 0.f;
      for (int q = 0; q < per; ++q) s += __ldcg(first + (size_t)q * HD + c);
      pooled[(((size_t)b * H + (c >> 7)) * nP + pb) * kDh + (c & (kDh - 1))] =
          div_n(s, cnt, inv_cnt);
    }
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

namespace k6 {

constexpr int kThreads = 512;              // four warpgroups: a kv quadrant each
constexpr int kMaxBlockK = 256;
constexpr int kSub = 32;                   // rows of one step of the kv product
using linkv::kSlot;                        // floats of a partial: 128 kv rows, then ksum
constexpr int kTileA = kSub * 128;         // bytes of a 64-channel fp16 phi tile
constexpr int kTileB = 2 * kTileA;         // bytes of the fp16 V tile: two 64-channel boxes
constexpr int kWork = 4 * kTileA + kTileB; // phi hi and lo of both halves, then V
using linkv::kReduceThreads;
// the most K blocks a run sums into its fp32 kv accumulators with the
// linear branch: the rounding of those sums grows with a run's rows, so a
// longer walk takes further waves of blocks instead
constexpr int kMaxRun = 24;
// phi enters the products times 2^8, so that lo = fp16(2^8 phi - hi) stays a
// normal fp16 down to phi ~ 2^-14 (below that its absolute error, 2^-33,
// is nothing a sum of up to 10^5 terms of 127 can see); the partials undo it
constexpr float kPhiScale = 256.f, kPhiUnscale = 1.f / 256.f;

// bytes of one stage: a block's K rows (bf16), then its V rows (int8)
__host__ __device__ __forceinline__ int stage_bytes(int bk) { return bk * 3 * kDh; }

// dynamic shared memory of a launch: two stages, the work tiles with the
// linear branch, 1 KB to align the swizzled tiles
inline size_t smem_bytes(int bk, bool linear) {
  return 1024 + 2 * (size_t)stage_bytes(bk) + (linear ? kWork : 0);
}

// the run split of the flat K blocks (b, h, K block in order)
using linkv::run_of;
using linkv::run_start;

// 4 rows x 4 int8 channels (a word a row) -> 4 channels x 4 rows
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* t) {
  const uint32_t x = __byte_perm(a, b, 0x5140), y = __byte_perm(c, d, 0x5140);
  const uint32_t x2 = __byte_perm(a, b, 0x7362), y2 = __byte_perm(c, d, 0x7362);
  t[0] = __byte_perm(x, y, 0x5410);
  t[1] = __byte_perm(x, y, 0x7632);
  t[2] = __byte_perm(x2, y2, 0x5410);
  t[3] = __byte_perm(x2, y2, 0x7632);
}

// 4 int8 (a word) -> 2 words of fp16 pairs, exactly: the byte plus 128 as
// the low bits of fp16 1024 (0x6400), less 1024 + 128
__device__ __forceinline__ uint2 i8x4_f16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const __half2 off = __float2half2_rn(1152.f);
  uint32_t a = __byte_perm(x, 0x64646464u, 0x4140), b = __byte_perm(x, 0x64646464u, 0x4342);
  const __half2 ha = __hsub2(*reinterpret_cast<__half2*>(&a), off);
  const __half2 hb = __hsub2(*reinterpret_cast<__half2*>(&b), off);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&ha),
                    *reinterpret_cast<const uint32_t*>(&hb));
}

// two fp32 as a packed fp16 pair (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_h2(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

using linkv::sts128;
using linkv::sw_chunk;

// rows r0 + 8 (u / 8) .. + 7 of a block's V rows (`vsm`, 128 bytes each)
// and channels 16 (u % 8) .. + 15, transposed into the block's panel `vout`
// (128 rows of block_k) with byte permutes: a quarter warp reads 128 bytes
// of a row
__device__ __forceinline__ void transpose_tile(const unsigned char* vsm, int8_t* vout,
                                               int block_k, int r0, int u) {
  const int cq = u & 7, r8 = (r0 >> 3) + (u >> 3);
  uint32_t w[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint4 x = *reinterpret_cast<const uint4*>(vsm + (r8 * 8 + r) * kDh + cq * 16);
    w[r][0] = x.x; w[r][1] = x.y; w[r][2] = x.z; w[r][3] = x.w;
  }
#pragma unroll
  for (int J = 0; J < 4; ++J) {
    uint32_t lo[4], hi[4];
    transpose4(w[0][J], w[1][J], w[2][J], w[3][J], lo);
    transpose4(w[4][J], w[5][J], w[6][J], w[7][J], hi);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store_vec8(reinterpret_cast<uint2*>(vout + (size_t)(cq * 16 + 4 * J + c) * block_k + r8 * 8),
                 make_uint2(lo[c], hi[c]));
  }
}

// A grid of run_start's runs over the flat K blocks (b, h, kb) of
// (B, H, Lp, 128) planes, Lp = nK block_k. Per K block: the statistic over
// its rows < kv_len, ks, the transposed V panel; per 32-row step, its K rows
// quantised; with LINEAR, first: 2^8 phi of the step's rows (zero rows past
// kv_len) as fp16 hi and lo into the MN-major A tiles (rows x 64 channels),
// V as fp16 into the MN-major B tile (rows x 128 channels, two boxes of
// 64), then warpgroup g takes the quadrant (c half g % 2, d half g / 2):
// frag = hi^T V + lo^T V on wgmma (a zeroed fragment a step: the tensor
// core's accumulation truncates) while every thread quantises a K row's
// 8 channels of the step, and acc += frag in fp32. At the end of each
// head's part of the run the block writes 2^-8 acc and its ksum as the
// partial of (block, slot): slot 0 for the run's first head, 1 for a second.
template <bool LINEAR>
__global__ void __launch_bounds__(kThreads, 1)
pack_kvt_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ mu,
                const int8_t* __restrict__ v, int8_t* __restrict__ kp, int8_t* __restrict__ vtp,
                float* __restrict__ ks, float* __restrict__ part, int nK, int block_k,
                int kv_len, int total) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float red[kThreads / 32];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sbytes = stage_bytes(block_k), kbytes = block_k * 2 * kDh;
  const int first = run_start(blockIdx.x, total, gridDim.x);
  const int last = run_start(blockIdx.x + 1, total, gridDim.x);
  const uint32_t bar = smem_u32(&full[0]);
  const uint32_t work = base + 2 * sbytes;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // block blk's K rows and V rows (flat rows blk * block_k on) into stage s
  auto issue = [&](int blk, int s) {
    const size_t row0 = (size_t)blk * block_k;
    mbar_arrive_expect_tx(bar + 8 * s, sbytes);
    bulk_load(base + s * sbytes, k + row0 * kDh, kbytes, bar + 8 * s);
    bulk_load(base + s * sbytes + kbytes, v + row0 * kDh, block_k * kDh, bar + 8 * s);
  };
  if (tid == 0) issue(first, 0);

  const int c16 = tid & 15;                  // the thread's 8 channels of a K row
  float m8[8];
  float acc[LINEAR ? 32 : 1], frag[LINEAR ? 32 : 1], ksl[8];
  if constexpr (LINEAR) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ksl[i] = 0.f;
  }
  int cur_bh = -1;
  for (int blk = first, j = 0; blk < last; ++blk, ++j) {
    const int s = j & 1;
    const int bh = blk / nK, row0 = (blk - bh * nK) * block_k;
    if (tid == 0 && blk + 1 < last) issue(blk + 1, s ^ 1);
    if (bh != cur_bh) {
      const float4* m4 = reinterpret_cast<const float4*>(mu + (size_t)bh * kDh + c16 * 8);
      *reinterpret_cast<float4*>(m8) = __ldg(m4);
      *reinterpret_cast<float4*>(m8 + 4) = __ldg(m4 + 1);
      cur_bh = bh;
    }
    mbar_wait(bar + 8 * s, (j >> 1) & 1);
    const unsigned char* ksm = sm + s * sbytes;       // K rows, 256 bytes each
    const unsigned char* vsm = ksm + kbytes;          // V rows, 128 bytes each
    const int live = min(block_k, kv_len - row0);     // rows < kv_len (may be <= 0)

    // the block statistic over rows < kv_len (rows past it may hold NaN)
    float amax = 0.f;
    for (int r = tid >> 4; r < live; r += kThreads / 16) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(ksm + r * 2 * kDh + c16 * 16), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fsub_rn(f[e], m8[e])));
    }
    amax = warp_max(amax);
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
    const float scale = __fmul_rn(fmaxf(m, 1e-8f), kInvInt8);
    const float inv = rcp_rn(scale);
    if (tid == 0) ks[blk] = scale;

    // the transposed V panel, 8 rows x 16 channels a thread
    int8_t* vout = vtp + (size_t)blk * kDh * block_k;
    for (int u = tid; u < block_k; u += kThreads) transpose_tile(vsm, vout, block_k, 0, u);
    int8_t* kout = kp + ((size_t)blk * block_k) * kDh + c16 * 8;
    for (int r0 = 0; r0 < block_k; r0 += kSub) {
      if constexpr (LINEAR) {
        // 2^8 phi of the step's rows: a half warp a row, 8 channels a lane
        const int l16 = lane & 15, rr = warp * 2 + (lane >> 4);
        const bool valid = r0 + rr < live;             // the half warp alike
        float x[8];
        unpack8(valid ? *reinterpret_cast<const uint4*>(ksm + (r0 + rr) * 2 * kDh + l16 * 16)
                      : make_uint4(0u, 0u, 0u, 0u), x);
        linkv::phi_row(x, valid, kPhiScale);
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s0 = x[2 * e], s1 = x[2 * e + 1];
          ksl[2 * e] += s0;
          ksl[2 * e + 1] += s1;
          h[e] = pack_h2(s0, s1);
          const float2 hf = __half22float2(*reinterpret_cast<const __half2*>(&h[e]));
          l[e] = pack_h2(__fsub_rn(s0, hf.x), __fsub_rn(s1, hf.y));
        }
        const uint32_t ta = work + (l16 >> 3) * kTileA;
        sts128(sw_chunk(ta, rr, l16 & 7), make_uint4(h[0], h[1], h[2], h[3]));
        sts128(sw_chunk(ta + 2 * kTileA, rr, l16 & 7), make_uint4(l[0], l[1], l[2], l[3]));
        // V rows of the step as fp16: thread = (row tid / 8, 16 channels)
        if (tid < kSub * 8) {
          const int vr = tid >> 3, cq = tid & 7;
          const uint4 vx = *reinterpret_cast<const uint4*>(vsm + (r0 + vr) * kDh + cq * 16);
          const uint2 a = i8x4_f16(vx.x), b = i8x4_f16(vx.y), c = i8x4_f16(vx.z),
                      d = i8x4_f16(vx.w);
          const uint32_t tb = work + 4 * kTileA + (cq >> 2) * kTileA;
          sts128(sw_chunk(tb, vr, (cq & 3) * 2), make_uint4(a.x, a.y, b.x, b.y));
          sts128(sw_chunk(tb, vr, (cq & 3) * 2 + 1), make_uint4(c.x, c.y, d.x, d.y));
        }
        fence_async_shared();
        __syncthreads();
        // warpgroup g: phi's channels 64 (g % 2) .. (A, M-major) against V's
        // 64 (g / 2) .. (B, N-major); a k step of 16 rows is two 1024-byte
        // groups
        const int g = warp >> 2;
        const uint32_t a_hi = work + (g & 1) * kTileA, a_lo = a_hi + 2 * kTileA;
        const uint32_t b_v = work + 4 * kTileA + (g >> 1) * kTileA;
        wgmma_fence();
#pragma unroll
        for (int ks16 = 0; ks16 < kSub / 16; ++ks16) {
          const uint64_t db = sw128_desc_mn(b_v + ks16 * 2048, 0);
          wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_hi + ks16 * 2048, 0), db, ks16);
          wgmma_f16_ss_mn_n64(frag, sw128_desc_mn(a_lo + ks16 * 2048, 0), db, 1);
        }
        wgmma_commit();
      }
      // the step's K rows, every row, with the block's scale
#pragma unroll
      for (int i = 0; i < kSub * 16 / kThreads; ++i) {
        const int r = r0 + (tid >> 4) + (kThreads / 16) * i;
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(ksm + r * 2 * kDh + c16 * 16), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = __fsub_rn(f[e], m8[e]);
        store_vec8(reinterpret_cast<uint2*>(kout + (size_t)r * kDh), quant8_rn(f, inv));
      }
      if constexpr (LINEAR) {
        wgmma_wait<0>();
        reg_fence<32>(frag);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);
        __syncthreads();                               // the tiles are free
      }
    }
    __syncthreads();                                   // the stage is read

    if constexpr (LINEAR) {
      if (blk + 1 == last || (blk + 1) % nK == 0) {
        // this run's part of head bh: its partial
        float* p = part + ((size_t)blockIdx.x * 2 + (bh == first / nK ? 0 : 1)) * kSlot;
        const int g = warp >> 2, w4 = warp & 3, gq = lane >> 2, t = lane & 3;
        const int c0 = (g & 1) * 64 + w4 * 16 + gq;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int d = (g >> 1) * 64 + jn * 8 + 2 * t;
          *reinterpret_cast<float2*>(p + c0 * kDh + d) =
              make_float2(acc[4 * jn] * kPhiUnscale, acc[4 * jn + 1] * kPhiUnscale);
          *reinterpret_cast<float2*>(p + (c0 + 8) * kDh + d) =
              make_float2(acc[4 * jn + 2] * kPhiUnscale, acc[4 * jn + 3] * kPhiUnscale);
        }
        // ksum: the two half warps' rows, then the warps in order, in the
        // work tiles' shared memory (free after the last step)
        float* ks_x = reinterpret_cast<float*>(sm + 2 * sbytes);
#pragma unroll
        for (int i = 0; i < 8; ++i) ksl[i] += __shfl_xor_sync(0xffffffffu, ksl[i], 16);
        if (lane < 16) {
          *reinterpret_cast<float4*>(ks_x + warp * kDh + lane * 8) =
              make_float4(ksl[0], ksl[1], ksl[2], ksl[3]);
          *reinterpret_cast<float4*>(ks_x + warp * kDh + lane * 8 + 4) =
              make_float4(ksl[4], ksl[5], ksl[6], ksl[7]);
        }
        __syncthreads();
        if (tid < kDh) {
          float sk = 0.f;
#pragma unroll
          for (int w = 0; w < kThreads / 32; ++w) sk += ks_x[w * kDh + tid];
          p[kDh * kDh + tid] = sk * kPhiUnscale;
        }
        __syncthreads();                               // ks_x read: the tiles are free
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) ksl[i] = 0.f;
      }
    }
  }
}

// kv (B, H, 128, 128) and ksum (B, H, 1, 128): head bh's partials added in
// run order, 4 floats a thread (grid: (ceil(kSlot / 1024), B H))
__global__ void __launch_bounds__(kReduceThreads)
kv_reduce_kernel(const float* __restrict__ part, float* __restrict__ kv,
                 float* __restrict__ ksum, int nK, int total, int grid) {
  linkv::reduce_partials(part, kv, ksum, nK, total, grid);
}

// the planes and blocks the kernel takes
inline bool shape_ok(int B, int H, int Lp, int block_k) {
  return B >= 1 && H >= 1 && block_k > 0 && block_k <= kMaxBlockK && block_k % 64 == 0 &&
         Lp % block_k == 0 && Lp >= block_k && (long long)B * H * Lp < (1LL << 31);
}

template <bool LINEAR>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(pack_kvt_kernel<LINEAR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// blocks of a launch: one a resident slot (with LINEAR, as many waves of
// them as keep the runs to kMaxRun K blocks), at least one a (b, h) so
// that no run spans more than two heads, at most one a K block
template <bool LINEAR>
int grid_size(int B, int H, int nK, int block_k) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(block_k, LINEAR);
  set_smem<LINEAR>(smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_kvt_kernel<LINEAR>, kThreads, smem);
  const int total = B * H * nK, resident = std::max(1, n_sm * per_sm);
  const int waves = LINEAR ? (total + resident * kMaxRun - 1) / (resident * kMaxRun) : 1;
  return std::min(total, std::max(resident * waves, B * H));
}

}  // namespace k6

// ---------------------------------------------------------------------------
// K27
// ---------------------------------------------------------------------------

// One block per (b, h, K block): the int8 K rows go into the first half of
// packed (B, H, Lp, 256) K|V rows and the V rows are copied beside them.
__global__ void __launch_bounds__(kSqThreads)
subquant_block_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ mu,
                      const int8_t* __restrict__ v, int8_t* __restrict__ kp,
                      float* __restrict__ ks, int H, int Lp, int block_k, int kv_len) {
  constexpr int kRow = 2 * kDh;                  // bytes between K rows of kp
  __shared__ float red[kSqThreads / 32];
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nK = Lp / block_k;
  const size_t bh = (size_t)b * H + h;
  const int row0 = kb * block_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x & 15;            // this thread's 8 channels
  const int r0 = threadIdx.x >> 4;           // rows r0, r0 + 16, ...
  const __nv_bfloat16* kbase = k + (bh * Lp + row0) * kDh + c * 8;

  float m8[8];
  *reinterpret_cast<float4*>(m8) = *reinterpret_cast<const float4*>(mu + bh * kDh + c * 8);
  *reinterpret_cast<float4*>(m8 + 4) = *reinterpret_cast<const float4*>(mu + bh * kDh + c * 8 + 4);

  // the block statistic over rows < kv_len (rows past it may hold NaN)
  float amax = 0.f;
  for (int r = r0; r < block_k && row0 + r < kv_len; r += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(kbase + (size_t)r * kDh), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fsub_rn(f[e], m8[e])));
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kSqThreads / 32; ++i) m = fmaxf(m, red[i]);
  const float scale = __fmul_rn(fmaxf(m, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  if (threadIdx.x == 0) ks[bh * nK + kb] = scale;

  // every row, rows past kv_len too, with the block's scale
  int8_t* kout = kp + (bh * Lp + row0) * kRow + c * 8;
  for (int r = r0; r < block_k; r += 16) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(kbase + (size_t)r * kDh), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fsub_rn(f[e], m8[e]);
    *reinterpret_cast<uint2*>(kout + (size_t)r * kRow) = quant8(f, inv);
  }

  // V rows beside K: 16-byte copies, neighbouring threads on neighbouring
  // addresses
  const int8_t* vbase = v + (bh * Lp + row0) * kDh;
  int8_t* vout = kp + (bh * Lp + row0) * kRow + kDh;
  for (int u = threadIdx.x; u < block_k * 8; u += kSqThreads) {
    const int r = u >> 3, c16 = u & 7;
    *reinterpret_cast<uint4*>(vout + (size_t)r * kRow + c16 * 16) =
        *reinterpret_cast<const uint4*>(vbase + (size_t)r * kDh + c16 * 16);
  }
}

// ---------------------------------------------------------------------------
// K18 and K29
// ---------------------------------------------------------------------------

constexpr int kSpWarps = 8;

// One warp per row of the (B*H*Lp) K planes: a lane owns channels
// 4 lane .. 4 lane + 3 of K (8 bytes) and of V (4 bytes). PACK (K18): the
// packed row is 128 bytes of int8 K then the 128 bytes of the V row; else
// (K29, v null) the int8 row goes to out (B*H*Lp, 128).
template <bool PACK>
__global__ void __launch_bounds__(kSpWarps * 32)
subquant_pack_kv_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ mu,
                        const int8_t* __restrict__ v, int8_t* __restrict__ out,
                        float* __restrict__ ks, int rows, int Lp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSpWarps + warp;
  if (row >= rows) return;
  const size_t bh = row / Lp;
  const uint2 u = *reinterpret_cast<const uint2*>(k + (size_t)row * kDh + lane * 4);
  const float4 m = *reinterpret_cast<const float4*>(mu + bh * kDh + lane * 4);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p2[0]), c = __bfloat1622float2(p2[1]);
  float f[4] = {__fsub_rn(a.x, m.x), __fsub_rn(a.y, m.y), __fsub_rn(c.x, m.z),
                __fsub_rn(c.y, m.w)};
  const float amax = warp_max(fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])),
                                    fmaxf(fabsf(f[2]), fabsf(f[3]))));
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int q = __float2int_rn(__fmul_rn(f[i], inv));
    q = max(-127, min(127, q));
    w |= (uint32_t)(q & 0xff) << (8 * i);
  }
  constexpr int kRow = PACK ? 2 * kDh : kDh;
  int8_t* dst = out + (size_t)row * kRow;
  *reinterpret_cast<uint32_t*>(dst + lane * 4) = w;
  if constexpr (PACK)
    *reinterpret_cast<uint32_t*>(dst + kDh + lane * 4) =
        *reinterpret_cast<const uint32_t*>(v + (size_t)row * kDh + lane * 4);
  if (lane == 0) ks[row] = scale;
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

constexpr int kUqWarps = 8;
constexpr int kUqChunks = 16;      // 16-byte chunks a lane holds: K13, rows <= 4096 wide
constexpr int kUqWideChunks = 20;  // K16: rows <= 5120 wide on one warp
// warps a K16 row (1, 2 or 4): 2 hold 10 vectors a lane in 61 registers
// (4: 5 vectors, 5% slower; 1: 20 vectors in 114 registers, 2 blocks an SM,
// 32% slower; tools/time_k6_k16.py --design)
constexpr int kWideRowWarps = 2;

// One warp per token row = b * L + l (K13). Chunk c = lane + 32 i of the row
// is head c / (Dh / 8), channels (c % (Dh / 8)) * 8 + [0, 8); K8's rule,
// y * (1 / scale).
__global__ void __launch_bounds__(kUqWarps * 32)
unfold_quant_kernel(const __nv_bfloat16* __restrict__ planes, int8_t* __restrict__ xq,
                    float* __restrict__ rs, int rows, int L, int Lp, int H, int Dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kUqWarps + warp;
  if (row >= rows) return;
  const int b = row / L, l = row % L;
  const int cph = Dh / 8, n = H * cph;
  uint4 u[kUqChunks];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kUqChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= n) break;
    const int h = c / cph;
    u[i] = *reinterpret_cast<const uint4*>(
        planes + (((size_t)b * H + h) * Lp + l) * Dh + (c - h * cph) * 8);
    float f[8];
    unpack8(u[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  amax = warp_max(amax);
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = 1.f / scale;
  int8_t* qr = xq + (size_t)row * n * 8;
#pragma unroll
  for (int i = 0; i < kUqChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= n) break;
    float f[8];
    unpack8(u[i], f);
    *reinterpret_cast<uint2*>(qr + c * 8) = quant8(f, inv);
  }
  if (lane == 0) rs[row] = scale;
}

// 8 bf16 values (a packed vector) -> 8 int8 by the wide TPU kernel's rule,
// q = round-half-even(fl(y / s)) saturated to +-127, without a division:
// with inv = rcp_rn(s) (1/s rounded to nearest) and t = fl(y inv) (within an
// ulp of y / s), r = y - t s is exact (one FMA) and fl(t + r inv) is the
// quotient rounded to nearest (Markstein's correction step; checked against
// the IEEE quotient for every bf16 y of |y / s| >= 2^-11 / 127 under every
// bf16 amax in [1, 2), which covers all amax by scaling with powers of 2:
// smaller quotients round to 0 either way), then rounded half to even by the
// 1.5 * 2^23 FADD (warp_rows.cuh quant8_rn). 3 FMA-pipe instructions a value
// where the division takes a call.
__device__ __forceinline__ uint2 quant8_wide(const uint4& u, float s, float inv) {
  uint32_t b[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 y = unpack2(word(u, k));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float yv = h ? y.y : y.x;
      const float t = __fmul_rn(yv, inv);
      const float q = fmaf(fmaf(-t, s, yv), inv, t);
      b[2 * k + h] = __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), 12582912.f));
    }
  }
  return make_uint2(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040), 0x5410));
}

// K16: RW warps a token row = b * L + l; vector c = (i RW + wig) 32 + lane of
// the row (a 32-vector span is two heads of 128) is head c / (Dh / 8),
// channels (c % (Dh / 8)) * 8 + [0, 8). The absmax on packed bf16 pairs
// (|y| by the sign bits cleared, exact); a wide row's warps exchange it once.
template <int NC, int RW>
__global__ void __launch_bounds__(kUqWarps * 32)
unfold_quant_wide_kernel(const __nv_bfloat16* __restrict__ planes, int8_t* __restrict__ xq,
                         float* __restrict__ rs, int rows, int L, int Lp, int H, int Dh) {
  __shared__ float xch[kUqWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / RW, wig = warp % RW;
  const int row = blockIdx.x * (kUqWarps / RW) + group;
  if (row >= rows) return;                     // the row's warps alike
  const int b = row / L, l = row - b * L;
  const int cph = Dh / 8, n = H * cph;
  uint4 u[NC];
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = (i * RW + wig) * 32 + lane;
    u[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n) {
      const int h = c / cph;
      u[i] = load_vec(reinterpret_cast<const uint4*>(
          planes + (((size_t)b * H + h) * Lp + l) * Dh + (c - h * cph) * 8));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = word(u[i], k) & 0x7fff7fffu;
      m2 = __hmax2(m2, *reinterpret_cast<const __nv_bfloat162*>(&a));
    }
  }
  const float2 mf = __bfloat1622float2(m2);
  float amax = warp_max_nonneg(fmaxf(mf.x, mf.y));
  if constexpr (RW > 1) {
    if (lane == 0) xch[warp] = amax;
    row_sync(group, RW);
#pragma unroll
    for (int r = 0; r < RW; ++r) amax = fmaxf(amax, xch[group * RW + r]);
  }
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInvInt8);
  const float inv = rcp_rn(scale);
  int8_t* qr = xq + (size_t)row * n * 8;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = (i * RW + wig) * 32 + lane;
    if (c < n) store_vec8(reinterpret_cast<uint2*>(qr + c * 8), quant8_wide(u[i], scale, inv));
  }
  if (wig == 0 && lane == 0) rs[row] = scale;
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

constexpr int kRrWarps = 8;

// One warp per row of W bf16 values, rows `ld` elements apart.
__global__ void __launch_bounds__(kRrWarps * 32)
row_rms_inv_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                   long long ld, int rows, int W, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRrWarps + warp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * ld;
  float s = 0.f;
#pragma unroll 4
  for (int c = lane * 8; c < W; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e] * f[e];
  }
  s = warp_sum(s);
  if (lane == 0) out[row] = 1.f / sqrtf(s / W + eps);
}

// K5's kernel takes H heads of 128 (1-64: rows up to kMaxVecRow), a row stride
// that is a multiple of 8 and at least the row, and 16-byte aligned x,
// weight, tables, bf16 and int8 planes and partials (null for an absent
// one); the C entry refuses any other launch.
bool head_planes_vector(const void* x, const void* w, const void* cos_full,
                        const void* sin_full, const void* out_bf, const void* out_i8,
                        const void* partial, long long ld, int H) {
  return H >= 1 && H <= kMaxHeads && ld % 8 == 0 && ld >= (long long)H * kDh && x != nullptr &&
         aligned16(x) && aligned16(w) && aligned16(cos_full) && aligned16(sin_full) &&
         aligned16(out_bf) && aligned16(out_i8) && aligned16(partial);
}

template <int V>
int launch_head_planes_rows(int vpl, const void* x, const void* w, const void* ri,
                            const void* cos_full, const void* sin_full, void* out_bf,
                            void* out_i8, void* out_scale, void* partial, void* pooled,
                            void* counters, void* rms_out, long long ld, int B, int L, int Lp,
                            int H, int pool, int nP, float eps, cudaStream_t stream) {
  if constexpr (V > kMaxVpl) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vpl != V)
      return launch_head_planes_rows<V + 1>(vpl, x, w, ri, cos_full, sin_full, out_bf, out_i8,
                                            out_scale, partial, pooled, counters, rms_out, ld,
                                            B, L, Lp, H, pool, nP, eps, stream);
    const auto kernel = &head_planes_rows_kernel<V>;
    const int nvec = H * (kDh / 8), groups = kRowWarps / row_warps(nvec);
    const size_t smem = (size_t)nvec * 16 * ((w != nullptr) + (pool ? 2 * groups : 0));
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int tiles = B * (Lp / kHpRows);
    const int grid = std::min(tiles, resident_blocks(kernel, smem));
    kernel<<<grid, kRowThreads, smem, stream>>>(
        (const __nv_bfloat16*)x, (const uint4*)w, (const float*)ri, (const float*)cos_full,
        (const float*)sin_full, (uint4*)out_bf, (uint2*)out_i8, (float*)out_scale,
        (float*)partial, (float*)pooled, (int*)counters, (float*)rms_out, ld, B, L, Lp, H,
        pool, nP, 1.f / (H * kDh), eps);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" int tdx_unfold_quant(const void* planes, void* xq, void* rs, int B, int L,
                                int Lp, int H, int Dh, void* stream) {
  if (Dh % 8 || H * Dh > kUqChunks * 32 * 8 || L > Lp) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  unfold_quant_kernel<<<(rows + kUqWarps - 1) / kUqWarps, kUqWarps * 32, 0,
                        (cudaStream_t)stream>>>((const __nv_bfloat16*)planes, (int8_t*)xq,
                                                (float*)rs, rows, L, Lp, H, Dh);
  return (int)cudaGetLastError();
}

extern "C" int tdx_unfold_quant_wide(const void* planes, void* xq, void* rs, int B, int L,
                                     int Lp, int H, int Dh, void* stream) {
  constexpr int kNc = kUqWideChunks / kWideRowWarps, kRows = kUqWarps / kWideRowWarps;
  if (Dh % 8 || H * Dh > kUqWideChunks * 32 * 8 || L > Lp) return (int)cudaErrorInvalidValue;
  const int rows = B * L;
  unfold_quant_wide_kernel<kNc, kWideRowWarps><<<(rows + kRows - 1) / kRows, kUqWarps * 32, 0,
                                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (int8_t*)xq, (float*)rs, rows, L, Lp, H, Dh);
  return (int)cudaGetLastError();
}

extern "C" int tdx_row_rms_inv(const void* x, void* out, long long ld, int rows, int W,
                               float eps, void* stream) {
  if (W <= 0 || W % 8 || ld % 8 || ld < W) return (int)cudaErrorInvalidValue;
  row_rms_inv_kernel<<<(rows + kRrWarps - 1) / kRrWarps, kRrWarps * 32, 0,
                       (cudaStream_t)stream>>>((const __nv_bfloat16*)x, (float*)out, ld,
                                               rows, W, eps);
  return (int)cudaGetLastError();
}

extern "C" int tdx_head_planes_form(const void* x, const void* w, const void* cos_full,
                                    const void* sin_full, const void* out_bf, const void* out_i8,
                                    const void* partial, long long ld, int H) {
  return head_planes_vector(x, w, cos_full, sin_full, out_bf, out_i8, partial, ld, H) ? 1 : 0;
}

// rms_out (optional, B x L fp32): the RMS inverse each live row took (with a
// norm weight), for a check of the transform against its plain version fed
// the kernel's own statistic
extern "C" int tdx_head_planes(const void* x, const void* w, const void* ri,
                               const void* cos_full, const void* sin_full, void* out_bf,
                               void* out_i8, void* out_scale, void* partial, void* pooled,
                               void* counters, void* rms_out, long long ld, int B, int L,
                               int Lp, int H, int pool, int nP, float eps, void* stream) {
  if (!head_planes_vector(x, w, cos_full, sin_full, out_bf, out_i8, partial, ld, H) ||
      B < 1 || L < 1 || L > Lp || Lp % kHpRows || (cos_full == nullptr) != (sin_full == nullptr) ||
      (out_i8 == nullptr) != (out_scale == nullptr) || (!out_bf && !out_i8 && !pool) ||
      (pool && (pool % kHpRows || Lp % pool || !partial || !pooled || !counters ||
                nP != (L + pool - 1) / pool)) ||
      (long long)B * H * Lp * 16 >= (1LL << 32))     // the planes' 32-bit vector index
    return (int)cudaErrorInvalidValue;
  return launch_head_planes_rows<1>(lane_vectors(H * (kDh / 8)), x, w, ri, cos_full, sin_full,
                                    out_bf, out_i8, out_scale, partial, pooled, counters,
                                    rms_out, ld, B, L, Lp, H, pool, nP, eps,
                                    (cudaStream_t)stream);
}

// blocks of a K6 launch (the partials' slots are 2 a block), 0 for a shape
// the kernel refuses
extern "C" int tdx_subquant_pack_kvt_grid(int B, int H, int Lp, int block_k, int linear_kv) {
  if (!k6::shape_ok(B, H, Lp, block_k)) return 0;
  return linear_kv ? k6::grid_size<true>(B, H, Lp / block_k, block_k)
                   : k6::grid_size<false>(B, H, Lp / block_k, block_k);
}

// `grid` blocks, as tdx_subquant_pack_kvt_grid gives them (any count from
// B H to the K blocks is correct; another is refused); part holds 2 x grid
// partials of (128 + 1) x 128 floats. kv, ksum and part all null: the
// linear branch is off
extern "C" int tdx_subquant_pack_kvt(const void* k, const void* mu, const void* v, void* kp,
                                     void* vtp, void* ks, void* part, void* kv, void* ksum,
                                     int B, int H, int Lp, int block_k, int kv_len, int grid,
                                     void* stream) {
  const bool linear = kv != nullptr;
  if (!k6::shape_ok(B, H, Lp, block_k) || kv_len <= 0 || kv_len > Lp ||
      grid < B * H || grid > B * H * (Lp / block_k) || (ksum != nullptr) != linear ||
      (part != nullptr) != linear)
    return (int)cudaErrorInvalidValue;
  const int nK = Lp / block_k, total = B * H * nK;
  const size_t smem = k6::smem_bytes(block_k, linear);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = linear ? k6::set_smem<true>(smem) : k6::set_smem<false>(smem);
  if (err) return (int)err;
  if (linear)
    k6::pack_kvt_kernel<true><<<grid, k6::kThreads, smem, st>>>(
        (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kp, (int8_t*)vtp,
        (float*)ks, (float*)part, nK, block_k, kv_len, total);
  else
    k6::pack_kvt_kernel<false><<<grid, k6::kThreads, smem, st>>>(
        (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kp, (int8_t*)vtp,
        (float*)ks, nullptr, nK, block_k, kv_len, total);
  err = cudaGetLastError();
  if (err || !linear) return (int)err;
  const dim3 rgrid((k6::kSlot / 4 + k6::kReduceThreads - 1) / k6::kReduceThreads, B * H);
  k6::kv_reduce_kernel<<<rgrid, k6::kReduceThreads, 0, st>>>(
      (const float*)part, (float*)kv, (float*)ksum, nK, total, grid);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_pack_kv_blocks(const void* k, const void* mu, const void* v,
                                           void* kvi, void* ks, int B, int H, int Lp,
                                           int block_k, int kv_len, void* stream) {
  if (block_k <= 0 || block_k % 64 || Lp % block_k) return (int)cudaErrorInvalidValue;
  const dim3 grid(Lp / block_k, H, B);
  subquant_block_kernel<<<grid, kSqThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kvi, (float*)ks, H,
      Lp, block_k, kv_len);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_pack_kv(const void* k, const void* mu, const void* v, void* kvi,
                                    void* ks, int BH, int Lp, void* stream) {
  if (BH <= 0 || Lp <= 0) return (int)cudaErrorInvalidValue;
  const int rows = BH * Lp;
  subquant_pack_kv_kernel<true><<<(rows + kSpWarps - 1) / kSpWarps, kSpWarps * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, (const int8_t*)v, (int8_t*)kvi, (float*)ks,
      rows, Lp);
  return (int)cudaGetLastError();
}

extern "C" int tdx_subquant_planes(const void* k, const void* mu, void* out, void* ks, int BH,
                                   int Lp, void* stream) {
  if (BH <= 0 || Lp <= 0) return (int)cudaErrorInvalidValue;
  const int rows = BH * Lp;
  subquant_pack_kv_kernel<false><<<(rows + kSpWarps - 1) / kSpWarps, kSpWarps * 32, 0,
                                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)k, (const float*)mu, nullptr, (int8_t*)out, (float*)ks, rows, Lp);
  return (int)cudaGetLastError();
}
