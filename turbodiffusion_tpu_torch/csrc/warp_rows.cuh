// What the warp-per-row kernels share (K1 / K12 mln_rows_kernel and K2
// rmsrope_rows_kernel in fused_norm.cu, K5 head_planes_rows_kernel in
// sla_fused.cu): a row of bf16 values takes one warp, or 2 or 4 for rows
// wider than 32 lanes x kMaxVpl 16-byte vectors, and a block of kRowWarps
// warps walks its rows persistently. A lane holds its share of the row as
// packed bf16 in registers, loaded once (L1::no_allocate, L2::256B), and
// stores 16 (or 8) bytes at a time, streaming. The warps of a wide row meet
// at a named barrier of their own.

#pragma once

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// (mln_rows_kernel's __launch_bounds__ names 1 block an SM: without it
// ptxas held some of its instances to 48 or 64 registers with a few bytes
// of spill; the path's instances, 104-122 registers, keep 2 blocks an SM)
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
// the most 16-byte vectors a lane holds of a row; a row takes the fewest
// warps (1, 2 or 4) whose lanes hold it
constexpr int kMaxVpl = 8;
constexpr int kMaxRowWarps = 4;
constexpr int kMaxVecRow = 8 * 32 * kMaxRowWarps * kMaxVpl;   // 8192 elements
// x's loads skip L1 and ask L2 for 256-byte blocks; out's stores stream
// (evict first): 2-5% at the 1.3B width, within 2% either way at 5120
// (tools/time_k2.py --design)
constexpr bool kLoadHint = true;
constexpr bool kStoreHint = true;

__device__ __forceinline__ uint4 load_vec(const uint4* p) {
  if constexpr (kLoadHint) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  } else {
    return *p;
  }
}

__device__ __forceinline__ void store_vec(uint4* p, const uint4& v) {
  if constexpr (kStoreHint) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
  } else {
    *p = v;
  }
}

// 8 int8 values (K5 and K12's int8 rows)
__device__ __forceinline__ void store_vec8(uint2* p, const uint2& v) {
  if constexpr (kStoreHint) {
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x), "r"(v.y)
                 : "memory");
  } else {
    *p = v;
  }
}

__host__ __device__ __forceinline__ int row_warps(int nvec) {
  int rw = 1;
  while (rw < kMaxRowWarps && nvec > 32 * rw * kMaxVpl) rw *= 2;
  return rw;
}

// vector i of lane `lane` in warp `wig` of a row's RW warps: the warps of a
// row take turns at 32-vector (512-byte) spans
__device__ __forceinline__ int vec_index(int i, int RW, int wig, int lane) {
  return (i * RW + wig) * 32 + lane;
}

// elements of a nvec-vector row that warp `wig` of the row's RW warps holds
template <int VPL>
__device__ __forceinline__ int warp_share(int nvec, int RW, int wig) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) n += max(0, min(32, nvec - (i * RW + wig) * 32));
  return 8 * n;
}

// this lane's vectors of the row at xr (zeros past the row)
template <int VPL>
__device__ __forceinline__ void load_row(uint4 (&v)[VPL], const uint4* xr, int nvec, int RW,
                                         int wig, int lane) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = vec_index(i, RW, wig, lane);
    v[i] = vi < nvec ? load_vec(xr + vi) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The next row in flight while a warp works on this one (K12): each
// lane copies its vectors of the row into its own 16-byte slots of a
// shared-memory buffer by cp.async (L2 only, 256-byte L2 blocks), vector i
// at slot[i * 32 + lane], so no register holds the row before it is used
// and no other lane reads the slot (cp.async.wait_group is the only wait).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's latest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int VPL>
__device__ __forceinline__ void prefetch_row(uint4* slot, const uint4* xr, int nvec, int RW,
                                             int wig, int lane) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = vec_index(i, RW, wig, lane);
    if (vi < nvec) cp_async16(slot + i * 32 + lane, xr + vi);
  }
}

// the vectors prefetch_row brought (zeros past the row)
template <int VPL>
__device__ __forceinline__ void slot_row(uint4 (&v)[VPL], const uint4* slot, int nvec, int RW,
                                         int wig, int lane) {
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    v[i] = vec_index(i, RW, wig, lane) < nvec ? slot[i * 32 + lane] : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the warp's (or each half-warp's) max of v >= 0, not NaN: the order of
// such floats is their bits', so one redux.sync where shuffles take five
// (or four) dependent steps
__device__ __forceinline__ float warp_max_nonneg(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}
__device__ __forceinline__ float half_warp_max(float v, int lane) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t lo = __reduce_max_sync(0xffffffffu, lane < 16 ? u : 0u);
  const uint32_t hi = __reduce_max_sync(0xffffffffu, lane < 16 ? 0u : u);
  return __uint_as_float(lane < 16 ? lo : hi);
}

// s / n rounded to nearest (the division of the TPU kernel and of the
// block-per-row kernels) for an integer n, from inv = 1/n rounded on the
// host: the product corrected by one FMA residual step. A `/` would bring
// the division's slow path, a call whose ABI costs the row's registers a
// stack frame.
__device__ __forceinline__ float div_n(float s, float n, float inv) {
  const float q = s * inv;
  return fmaf(fmaf(-q, n, s), inv, q);
}

// 1/s rounded to nearest, as `1.f / s` gives it, for a positive normal s,
// without the division's slow-path call: the SFU's estimate refined by two
// FMA Newton steps in fp64 (error ~2^-53 of 1/s), then rounded to fp32. No
// fp32 midpoint m lies within 2^-49 / s of 1/s (1 - s m is a nonzero
// multiple of 2^-49 or coarser), so that rounding is the one 1/s takes.
__device__ __forceinline__ float rcp_rn(float s) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  const double d = s;
  double y = r;
  y = fma(fma(-d, y, 1.0), y, y);
  y = fma(fma(-d, y, 1.0), y, y);
  return __double2float_rn(y);
}

// the RW warps of one row meet at named barrier 1 + group (barrier 0 is
// __syncthreads)
__device__ __forceinline__ void row_sync(int group, int RW) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * RW) : "memory");
}

// a packed bf16 pair as fp32 (element 0 in the low half), and back, rounded
// to nearest even
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 8 fp32 values -> 8 int8, K8's rule: q = round-half-even(y * inv)
// saturated to +-127, inv = 1/scale rounded to nearest. The saturation is a
// clamp before the rounding (the same q for every finite y; NaN gives
// -127), and the rounding the FADD of 1.5 * 2^23: the sum's ulp is 1, so
// the FADD rounds to an integer, half to even, and the float's low byte is
// q's two's complement. 4 full-rate instructions a value and 3 byte
// permutes a word, where cvt.rni to an integer runs at a quarter of the
// rate.
__device__ __forceinline__ uint2 quant8_rn(const float* f, float inv) {
  uint32_t b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    b[k] = __float_as_uint(
        __fadd_rn(fminf(fmaxf(__fmul_rn(f[k], inv), -127.f), 127.f), 12582912.f));
  return make_uint2(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040), 0x5410));
}

// the product of two packed bf16 pairs rounded to bf16, as the fp32 product
// of two bf16 values (exact) rounds: one fma with -0 as the addend
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }   // null too

// Blocks of `kernel` that fit on the card at once (at least 1).
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, smem);
  return std::max(1, n_sm * per_sm);
}

// a row's vectors a lane holds: ceil(nvec / (32 * row warps))
int lane_vectors(int nvec) {
  const int lanes = 32 * row_warps(nvec);
  return (nvec + lanes - 1) / lanes;
}

}  // namespace
