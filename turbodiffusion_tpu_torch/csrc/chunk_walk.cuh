// The walk over key chunks that the warp-specialised attention kernels share
// (K3 / K4 / K20 / K30 in flash_attention.cu, K25 / K26 in flash_jvp.cu):
// the chunks one query tile attends to, in order. The producer thread and
// the tile's consumer warpgroups each walk the same list, so they agree on
// every chunk without exchanging indices.

#pragma once

namespace {

// Dense: every KEYS-key chunk of [0, kv_len). Sparse (K7's rule): the LUT
// entries of the tile's Q block in order, an id outside [0, nK) skipped, and
// of each K block the chunks that start before kv_len (a chunk's tail past
// kv_len is masked before the row max). A tile is ROWS query rows inside one
// Q block (block_q a multiple of ROWS); block_k is a multiple of KEYS. The
// parameters `p` name lut (B, H, nQ, sel), H, nQ, sel, block_q, block_k,
// nK = ceil(kv_len / block_k) and kv_len.
template <bool SPARSE, int ROWS, int KEYS>
struct ChunkWalk {
  const int* ids;   // the tile's LUT row (sparse)
  int j, kb, off, end;   // next entry; the block, its next chunk's offset, its keys

  template <class Prm>
  __device__ __forceinline__ ChunkWalk(const Prm& p, int b, int h, int tile)
      : ids(nullptr), j(0), kb(0), off(0), end(SPARSE ? 0 : p.kv_len) {
    if constexpr (SPARSE)
      ids = p.lut + (((long long)b * p.H + h) * p.nQ + tile * ROWS / p.block_q) * p.sel;
  }

  // the next chunk's first key, or -1 past the last
  template <class Prm>
  __device__ __forceinline__ int next(const Prm& p) {
    if constexpr (SPARSE) {
#pragma unroll 1
      while (off >= end) {
        if (j >= p.sel) return -1;
        kb = __ldg(ids + j++);
        off = 0;
        end = kb >= 0 && kb < p.nK ? min(p.block_k, p.kv_len - kb * p.block_k) : 0;
      }
      const int key0 = kb * p.block_k + off;
      off += KEYS;
      return key0;
    }
    if (off >= end) return -1;
    off += KEYS;
    return off - KEYS;
  }
};

}  // namespace
