"""Fused SageSLA front-end: kernels K5 (head_planes), K6 (subquant_pack_kvt),
K13 and K16 (unfold_quant), K15 (row_rms_inv), K18 and K27
(subquant_pack_kv) and K29 (subquant_planes).

The counterpart of `turbodiffusion_tpu/ops/sla_fused.py`, for the
single-chip path that `ops/attention.sla_attention_fused` takes:
  * `row_rms_inv` — K15 `_row_rms_inv_cuda` replaces the TPU kernel
    `row_rms_inv` (launch :62, body `_row_rms_kernel` :45-47): the full-row
    RMS inverse of a wide model's projection (14B: 5120 columns), which K17
    reads (and K5's external-RMS mode takes);
  * `head_planes` — K5 `_head_planes_cuda` replaces the TPU kernel
    `head_planes` (launch :228, body `_head_planes_kernel` :76-137): one pass
    over a (B, L, H*Dh) projection output (read through a row stride, so a
    column group of the fused QKV output needs no copy) giving any of the
    bf16 head planes
    (B, H, Lp, Dh), per-(head, token) int8 + fp32 scales, and per-block
    pooled means, with the full-row RMSNorm and rotate-half RoPE fused in,
    up to 64 heads (rows of 8,192) with the row's RMS taken in the row;
    with `rms_inv` (K15's output, the TPU kernel's external-RMS mode,
    :93-94) the row's statistic is read, not reduced;
  * `block_map_from_pooled` (:281-298) — plain torch: the smooth-k mean
    recovered from pooled K, the block scores and the top-k LUT;
  * `subquant_pack_kvt` — K6 `_subquant_pack_kvt_cuda` replaces
    `subquant_pack_kvt` (launch :455, body `_subquant_pack_kvt_kernel`
    :351-409): smooth-k subtract + per-block int8 K, the per-block
    transposed V panel, and (linear_kv) the SLA linear branch's kv / ksum
    sums, in one walk over K and V (the kv product on the tensor cores; a
    block's runs of K blocks are `kvt_runs`, their partials added in run
    order by a second, small launch);
  * `subquant_pack_kv` — K18 `_subquant_pack_kv_cuda` replaces
    `subquant_pack_kv` in its per-row mode (launch :501, body
    `_subquant_pack_kernel` :313-348 with block_k 0), the `v_quant="row"`
    producer: smooth-k subtract + per-row int8 K written beside the
    per-row int8 V in packed K|V rows, the layout K19 reads. The TPU's
    trailing poison block and (TL/128, 128) scale relayout have no
    counterpart: K19 masks by column; with `block_k`, K27
    `_subquant_pack_kv_blocks_cuda` replaces its block-scale mode (the
    block_k branch of the same body): K6's block statistic over the rows
    < kv_len, into the same packed layout, the producer of K28 (fused
    sagesla at v_quant "channel" above sel * block_k 8,192);
  * `subquant_planes` — K29 `_subquant_planes_cuda` replaces the TPU kernel
    of the same name (launch :533, body `_subquant_kernel` :305-310): K18's
    per-row rule into unpacked int8 planes (no model path calls it, as in
    JAX);
  * `unfold_quant` — K13 `_unfold_quant_cuda` replaces the TPU kernel
    `unfold_quant`, narrow form (launch :633, body `_unfold_quant_kernel`
    :551-562): K7's planes to the W8A8 O projection's int8 feed, one fp32
    scale per token across all heads, K8's rule (so it equals K8 on
    `unfold_planes`' rows bit for bit); above H*Dh 4096, K16
    `_unfold_quant_wide_cuda` replaces its wide form (launches :608 and
    :619, bodies `_unfold_scale_kernel` / `_unfold_write_kernel` :565-592)
    in one launch, with that form's rule `y / scale` (kept bit for bit
    without a division: the product with 1/scale and one FMA residual
    step);
  * `unfold_planes` (:646-649) — plain torch.

Rows in [L, Lp) of the outputs: the JAX kernels leave them unwritten; here
they are the planes of a zero input row (0, int8 0, scale 1e-8/127) and never
enter a pooled mean. Consumers still mask them (K6's block statistic and
linear sums, K7's row max).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (csrc/sla_fused.cu) or raises. Each launcher counts its launches in
`.launches`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import _cdiv, _require
from turbodiffusion_tpu_torch.ops.fused_norm import _row_stride
from turbodiffusion_tpu_torch.ops.linear_attention import _softmax_d
from turbodiffusion_tpu_torch.ops.quant import quantize_rows_int8_plain

INT8_MAX = 127.0
# rows of a K5 tile: the grain of its pooled partial sums
_HP_ROWS = 64
# K5's heads of 128: rows up to 8,192 wide (csrc/sla_fused.cu kMaxHeads)
_HP_MAX_HEADS = 64
# widest row of the narrow unfold_quant (K13); K16 takes up to 5120
_UNFOLD_NARROW_MAX, _UNFOLD_WIDE_MAX = 4096, 5120
# K6 (csrc/sla_fused.cu k6::): the largest block_k, the floats of a run's
# partial sums of one head (128 kv rows of 128, then ksum), the most K
# blocks a run sums with the linear branch
_KVT_MAX_BLOCK = 256
_KVT_SLOT = (128 + 1) * 128
_KVT_MAX_RUN = 24


def _quant_rows(yf):
    """Symmetric int8 over the last dim, as the JAX kernels round it:
    scale = max(amax, 1e-8) * (1/127), q = round(y * (1/scale)) half to even
    (saturated, which only matters for rows of garbage)."""
    scale = yf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / INT8_MAX)
    q = torch.round(yf * (1.0 / scale)).clamp_(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale[..., 0]


# ---------------------------------------------------------------------------
# K15: row_rms_inv
# ---------------------------------------------------------------------------

def _column_block(x, width: Optional[int], col_block: int):
    """Columns [col_block*width, (col_block+1)*width) of x, as a view."""
    W = x.shape[-1] if width is None else width
    return x[..., col_block * W:(col_block + 1) * W]


def row_rms_inv_plain(x, eps: float = 1e-6, width: Optional[int] = None,
                      col_block: int = 0):
    """Plain version of K15 (sla_fused.py:45-69): (B, L, W) -> (B, L, 1)
    fp32 rsqrt(mean(x^2) + eps) over the column block."""
    xf = _column_block(x, width, col_block).float()
    return torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)


def _row_rms_inv_cuda(x, eps: float, width: Optional[int], col_block: int):
    """Launch K15. x (B, L, >= W) bf16 with 16-byte aligned rows
    `_row_stride` apart."""
    xs = _column_block(x, width, col_block)
    B, L, W = xs.shape
    _require(xs.dtype == torch.bfloat16, "K15 takes a bf16 x")
    ld = _row_stride(xs, "K15")
    _require(W % 8 == 0 and ld % 8 == 0 and xs.data_ptr() % 16 == 0,
             "K15 takes 16-byte aligned rows of a multiple of 8 columns")
    out = torch.empty((B, L, 1), dtype=torch.float32, device=x.device)
    rc = _build.load().tdx_row_rms_inv(xs.data_ptr(), out.data_ptr(), ld,
                                       B * L, W, float(eps),
                                       _build.stream_ptr(x))
    _build.check(rc, "tdx_row_rms_inv")
    _row_rms_inv_cuda.launches += 1
    return out


_row_rms_inv_cuda.launches = 0


def row_rms_inv(x, eps: float = 1e-6, width: Optional[int] = None,
                col_block: int = 0):
    """(B, L, W) -> (B, L, 1) fp32 full-row RMS inverse over columns
    [col_block*width, (col_block+1)*width) (sla_fused.row_rms_inv): the
    plain version on a CPU tensor, kernel K15 on a CUDA tensor."""
    if x.device.type == "cpu":
        return row_rms_inv_plain(x, eps, width, col_block)
    _require(x.device.type == "cuda", f"no kernel for device {x.device}")
    return _row_rms_inv_cuda(x, eps, width, col_block)


# ---------------------------------------------------------------------------
# K5: head_planes
# ---------------------------------------------------------------------------

def head_planes_plain(x, weight=None, cos_full=None, sin_full=None, *,
                      num_heads: int, eps: float = 1e-6, pool: int = 0,
                      quant: bool = False, bf16_out: bool = True,
                      pad_to: Optional[int] = None, rms_inv=None) -> dict:
    """Plain version of K5 (sla_fused.py:76-137).

    x: (B, L, H*Dh). weight => RMSNorm over the whole row in fp32, cast to
    x's dtype, times the weight in x's dtype, the row's RMS inverse taken
    from `rms_inv` (B, >= L, 1) where given; cos/sin (>= L, Dh) => rotate-
    half RoPE in fp32. The int8 plane and the pooled means come from that
    fp32 value (`yf`), before the final rounding to x's dtype. Returns a dict
    with keys among bf16 (B, H, Lp, Dh), i8 (B, H, Lp, Dh) int8, scale
    (B, H, Lp) fp32, pooled (B, H, ceil(L/pool), Dh) fp32."""
    B, L, HD = x.shape
    H = num_heads
    Dh = HD // H
    Lp = L if pad_to is None else pad_to
    xf = x.float()
    if weight is not None:
        rms = (row_rms_inv_plain(x, eps) if rms_inv is None
               else rms_inv[:, :L].float())
        y16 = (xf * rms).to(x.dtype) * weight.to(x.dtype)
    else:
        y16 = x
    y16 = y16.reshape(B, L, H, Dh)
    yf = y16.float()
    if cos_full is not None:
        half = torch.cat([yf[..., Dh // 2:], yf[..., :Dh // 2]], -1)
        yf = (yf * cos_full[:L, None].float()
              + half * sin_full[:L, None].float())
    planes = torch.nn.functional.pad(yf.transpose(1, 2),
                                     (0, 0, 0, Lp - L))    # (B, H, Lp, Dh)
    out = {}
    if bf16_out:
        out["bf16"] = planes.to(x.dtype)
    if quant:
        out["i8"], out["scale"] = _quant_rows(planes)
    if pool:
        nP = _cdiv(L, pool)
        yp = torch.nn.functional.pad(planes[:, :, :L], (0, 0, 0, nP * pool - L))
        counts = torch.clamp(L - torch.arange(nP, device=x.device) * pool,
                             max=pool).float()
        out["pooled"] = (yp.reshape(B, H, nP, pool, Dh).sum(3)
                         / counts[:, None])
    return out


def head_planes_form(num_heads: int, ld: int, *ptrs) -> str:
    """The kernel a K5 launch takes (csrc/sla_fused.cu
    `head_planes_vector`): "vector", the warp-per-row kernel, for 1-64 heads
    of 128, a row stride `ld` that is a multiple of 8 and at least the row,
    and every pointer (x, weight, cos, sin, bf16 planes, int8 planes,
    partials; None for an absent one) 16-byte aligned; else "refused": the
    C entry launches nothing."""
    ok = (1 <= num_heads <= _HP_MAX_HEADS and ld % 8 == 0
          and ld >= num_heads * 128 and ptrs[0] is not None
          and all(p is None or p % 16 == 0 for p in ptrs))
    return "vector" if ok else "refused"


def _head_planes_cuda(x, weight, cos_full, sin_full, num_heads: int,
                      eps: float, pool: int, quant: bool, bf16_out: bool,
                      Lp: int, rms_inv=None, rms_out: bool = False) -> dict:
    """Launch K5. x (B, L, H*128) bf16 with 16-byte aligned rows
    `_row_stride` apart; weight (H*128,); rms_inv (B, >= L, 1) fp32 or
    None (the row's own RMS); cos/sin (>= L, 128) fp32 or both None.
    rms_out (with a weight): the output also holds "rms_inv" (B, L, 1), the
    statistic each row took, for a check of the transform against the plain
    version fed it."""
    B, L, HD = x.shape
    H = num_heads
    _require(x.dtype == torch.bfloat16, "K5 takes a bf16 x")
    ld = _row_stride(x, "K5")
    _require(ld % 8 == 0 and x.data_ptr() % 16 == 0,
             "K5 takes 16-byte aligned rows")
    _require(HD == H * 128 and 1 <= H <= _HP_MAX_HEADS,
             f"K5 takes 1-{_HP_MAX_HEADS} heads of 128, got width {HD} for "
             f"{H} heads")
    _require(0 < L <= Lp and Lp % _HP_ROWS == 0,
             f"K5 pads to a multiple of {_HP_ROWS} >= L, got {Lp}")
    _require(not pool or (pool % _HP_ROWS == 0 and Lp % pool == 0),
             f"K5 pools over a multiple of {_HP_ROWS} rows dividing Lp, "
             f"got {pool}")
    _require(quant or bf16_out or pool, "K5 asked for no output")
    dev = x.device
    w = ri = None
    if weight is not None:
        w = weight.to(torch.bfloat16).contiguous()
        _require(w.device == dev and w.numel() == HD,
                 "K5 weight must lie on x's device with H*Dh entries")
    if rms_inv is not None:
        _require(weight is not None, "K5 takes rms_inv with a norm weight")
        ri = rms_inv[:, :L].reshape(B, L).float().contiguous()
        _require(ri.device == dev, "K5 rms_inv must lie on x's device")
    rope = cos_full is not None
    _require(rope == (sin_full is not None), "K5 takes cos and sin together")
    if rope:
        cos_full = cos_full.float().contiguous()
        sin_full = sin_full.float().contiguous()
        _require(cos_full.shape == sin_full.shape and cos_full.shape[0] >= L
                 and cos_full.shape[1] == 128 and cos_full.device == dev,
                 "K5 tables must be (>= L, 128) on x's device")
    out = {}
    if bf16_out:
        out["bf16"] = torch.empty((B, H, Lp, 128), dtype=x.dtype, device=dev)
    if quant:
        out["i8"] = torch.empty((B, H, Lp, 128), dtype=torch.int8, device=dev)
        out["scale"] = torch.empty((B, H, Lp), dtype=torch.float32, device=dev)
    if rms_out:
        _require(weight is not None, "K5 reports the RMS of a norm")
        out["rms_inv"] = torch.empty((B, L, 1), dtype=torch.float32, device=dev)
    n_tiles = Lp // _HP_ROWS
    partial = counters = None
    nP = 0
    if pool:
        nP = _cdiv(L, pool)
        out["pooled"] = torch.empty((B, H, nP, 128), dtype=torch.float32,
                                    device=dev)
        partial = torch.empty((B, n_tiles, HD), dtype=torch.float32, device=dev)
        counters = torch.zeros((B, Lp // pool), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _require(head_planes_form(H, ld, x.data_ptr(), ptr(w), ptr(cos_full),
                              ptr(sin_full), ptr(out.get("bf16")),
                              ptr(out.get("i8")), ptr(partial)) == "vector",
             "K5 takes 16-byte aligned weight and tables")
    lib = _build.load()
    rc = lib.tdx_head_planes(
        x.data_ptr(), ptr(w), ptr(ri), ptr(cos_full), ptr(sin_full),
        ptr(out.get("bf16")), ptr(out.get("i8")), ptr(out.get("scale")),
        ptr(partial), ptr(out.get("pooled")), ptr(counters),
        ptr(out.get("rms_inv")), ld, B, L, Lp, H, pool, nP, float(eps),
        _build.stream_ptr(x))
    _build.check(rc, "tdx_head_planes")
    _head_planes_cuda.launches += 1
    return out


_head_planes_cuda.launches = 0


def head_planes(x, weight=None, cos_full=None, sin_full=None, *,
                num_heads: int, eps: float = 1e-6, pool: int = 0,
                quant: bool = False, bf16_out: bool = True,
                pad_to: Optional[int] = None, rms_inv=None) -> dict:
    """One-pass head-plane transform of a (B, L, H*Dh) projection output
    (sla_fused.head_planes; `rms_inv` its external-RMS mode): the plain
    version on a CPU tensor, kernel K5 on a CUDA tensor. See
    `head_planes_plain` for the outputs."""
    Lp = x.shape[1] if pad_to is None else pad_to
    if x.device.type == "cpu":
        return head_planes_plain(x, weight, cos_full, sin_full,
                                 num_heads=num_heads, eps=eps, pool=pool,
                                 quant=quant, bf16_out=bf16_out, pad_to=Lp,
                                 rms_inv=rms_inv)
    _require(x.device.type == "cuda", f"no kernel for device {x.device}")
    return _head_planes_cuda(x, weight, cos_full, sin_full, num_heads, eps,
                             pool, quant, bf16_out, Lp, rms_inv)


# ---------------------------------------------------------------------------
# smooth-k block map from pooled means (plain torch)
# ---------------------------------------------------------------------------

def block_map_from_pooled(pooled_q, pooled_k, L: int, pool: int,
                          topk_ratio: float):
    """Top-k K-block LUT from pooled means (sla_fused.py:281-298): pooling is
    linear, so smooth-k before pooling equals subtracting the count-weighted
    mean of the pooled K blocks. `pool` is the K-side block. Returns (lut
    (B, H, nQ, topk) int32, topk, k_mean (B, H, 1, Dh) fp32). Ties may be
    ordered differently from `jax.lax.top_k`: compare LUT rows as sets."""
    nK = pooled_k.shape[2]
    counts = torch.clamp(L - torch.arange(nK, device=pooled_k.device) * pool,
                         max=pool).float()
    k_mean = (pooled_k * counts[:, None]).sum(2, keepdim=True) / float(L)
    score = torch.matmul(pooled_q.float(), (pooled_k - k_mean).transpose(-1, -2))
    topk = max(1, min(nK, int(topk_ratio * nK)))
    lut = torch.topk(score, topk, dim=-1).indices
    return lut.to(torch.int32), topk, k_mean


# ---------------------------------------------------------------------------
# K6: subquant_pack_kvt
# ---------------------------------------------------------------------------

def _quant_k_blocks(k_planes, mu, block_k: int, kv_len: int):
    """Smooth-k int8 K with one scale per block_k rows (K6's and K27's
    rule): xf = f32(k) - mu, s_blk = max(max over the block's rows < kv_len
    of |xf|, 1e-8) * (1/127) (rows past kv_len, NaN or not, stay out), every
    row k_i8 = round(xf * (1/s_blk)) half to even. Returns (int8
    (B, H, Lp, D), fp32 (B, H, nK))."""
    B, H, Lp, D = k_planes.shape
    nK = Lp // block_k
    xf = k_planes.float() - mu.float()
    valid = (torch.arange(Lp, device=xf.device) < kv_len)[:, None]
    rowmax = torch.where(valid, xf.abs(), 0.0).amax(-1)
    scale = (rowmax.reshape(B, H, nK, block_k).amax(-1).clamp_min(1e-8)
             * (1.0 / INT8_MAX))
    rows = scale.repeat_interleave(block_k, -1)[..., None]
    kp = torch.round(xf * (1.0 / rows)).clamp_(-INT8_MAX, INT8_MAX)
    return kp.to(torch.int8), scale


def subquant_pack_kvt_plain(k_planes, mu, v_i8, block_k: int,
                            kv_len: Optional[int] = None,
                            linear_kv: bool = False):
    """Plain version of K6 (sla_fused.py:351-409).

    k_planes (B, H, Lp, D); mu (B, H, 1, D); v_i8 (B, H, Lp, D) int8.
    Returns (kp (B, H, Lp, D) int8 = round((k - mu) / s_blk), vtp
    (B, H, nK, D, block_k) int8, ks (B, H, nK) fp32) where s_blk =
    max(max over rows < kv_len of |k - mu|, 1e-8) / 127; linear_kv adds
    kv (B, H, D, D) = sum over rows < kv_len of softmax_D(k)^T v_i8 and
    ksum (B, H, 1, D) = sum of softmax_D(k), both fp32, over the raw k."""
    B, H, Lp, D = k_planes.shape
    kv_len = Lp if kv_len is None else kv_len
    nK = Lp // block_k
    kp, scale = _quant_k_blocks(k_planes, mu, block_k, kv_len)
    vtp = v_i8.reshape(B, H, nK, block_k, D).transpose(-1, -2).contiguous()
    res = (kp, vtp, scale)
    if linear_kv:
        valid = (torch.arange(Lp, device=k_planes.device) < kv_len)[:, None]
        pk = torch.where(valid, _softmax_d(k_planes.float()), 0.0)
        kv = torch.matmul(pk.transpose(-1, -2), v_i8.float())
        res += (kv, pk.sum(2, keepdim=True))
    return res


def kvt_grid(B: int, H: int, Lp: int, block_k: int, resident: int,
             linear_kv: bool = True) -> int:
    """Blocks of a K6 launch (csrc/sla_fused.cu `k6::grid_size`): one a
    resident block (`resident`: SMs x blocks an SM; with linear_kv, as many
    waves of them as keep each run to `_KVT_MAX_RUN` K blocks), at least
    one a (b, h), so that no run spans more than two heads, at most one a
    K block."""
    total = B * H * (Lp // block_k)
    resident = max(1, resident)
    waves = -(-total // (resident * _KVT_MAX_RUN)) if linear_kv else 1
    return min(total, max(resident * waves, B * H))


def kvt_runs(total: int, grid: int) -> list:
    """[(first, end)) of the flat K blocks (b, h, K block in order) each of
    K6's `grid` blocks walks (`k6::run_start`): floor(i total / grid)."""
    return [(i * total // grid, (i + 1) * total // grid) for i in range(grid)]


def kvt_partials(B: int, H: int, nK: int, grid: int) -> list:
    """For each (b, h), the (block, slot) of its partial sums in run order,
    as `k6::kv_reduce_kernel` adds them: slot 0 for a run's first head, 1
    for a second."""
    runs = kvt_runs(B * H * nK, grid)
    out = [[] for _ in range(B * H)]
    for i, (a, e) in enumerate(runs):
        for bh in range(a // nK, (e - 1) // nK + 1):
            out[bh].append((i, 0 if bh == a // nK else 1))
    return out


@functools.lru_cache(maxsize=None)
def _kvt_grid_on_card(device: int, B: int, H: int, Lp: int, block_k: int,
                      linear_kv: bool) -> int:
    with torch.cuda.device(device):
        return _build.load().tdx_subquant_pack_kvt_grid(B, H, Lp, block_k,
                                                         int(linear_kv))


def _subquant_pack_kvt_cuda(k_planes, mu, v_i8, block_k: int, kv_len: int,
                            linear_kv: bool):
    """Launch K6: one walk over K and V, and with linear_kv the reduce of
    its runs' partial kv / ksum sums."""
    B, H, Lp, D = k_planes.shape
    dev = k_planes.device
    _require(k_planes.dtype == torch.bfloat16 and k_planes.is_contiguous(),
             "K6 takes contiguous bf16 K planes")
    _require(D == 128, f"K6 takes head dim 128, got {D}")
    _require(v_i8.dtype == torch.int8 and v_i8.is_contiguous()
             and v_i8.shape == k_planes.shape and v_i8.device == dev,
             "K6 takes contiguous int8 V planes shaped like K")
    _require(block_k % 64 == 0 and 64 <= block_k <= _KVT_MAX_BLOCK
             and Lp % block_k == 0,
             f"K6 takes a block of 64-{_KVT_MAX_BLOCK} rows dividing Lp, got "
             f"{block_k}")
    _require(0 < kv_len <= Lp, f"kv_len {kv_len} out of range")
    mu = mu.float().contiguous()
    _require(mu.numel() == B * H * D and mu.device == dev,
             "K6 mu must be (B, H, 1, D) on K's device")
    nK = Lp // block_k
    grid = _kvt_grid_on_card(dev.index if dev.index is not None
                             else torch.cuda.current_device(), B, H, Lp, block_k,
                             linear_kv)
    _require(grid > 0, f"K6 refuses planes {tuple(k_planes.shape)}")
    kp = torch.empty_like(v_i8)
    vtp = torch.empty((B, H, nK, D, block_k), dtype=torch.int8, device=dev)
    ks = torch.empty((B, H, nK), dtype=torch.float32, device=dev)
    part = kv = ksum = None
    if linear_kv:
        part = torch.empty((2 * grid, _KVT_SLOT), dtype=torch.float32, device=dev)
        kv = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
        ksum = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _build.load().tdx_subquant_pack_kvt(
        k_planes.data_ptr(), mu.data_ptr(), v_i8.data_ptr(), kp.data_ptr(),
        vtp.data_ptr(), ks.data_ptr(), ptr(part), ptr(kv), ptr(ksum), B, H, Lp,
        block_k, kv_len, grid, _build.stream_ptr(k_planes))
    _build.check(rc, "tdx_subquant_pack_kvt")
    _subquant_pack_kvt_cuda.launches += 1
    return (kp, vtp, ks) + ((kv, ksum) if linear_kv else ())


_subquant_pack_kvt_cuda.launches = 0


def subquant_pack_kvt(k_planes, mu, v_i8, block_k: int,
                      kv_len: Optional[int] = None, linear_kv: bool = False):
    """Smooth-k int8 K panel, per-block transposed V panel and K block
    scales in one pass (sla_fused.subquant_pack_kvt): the plain version on a
    CPU tensor, kernel K6 on a CUDA tensor."""
    kv_len = k_planes.shape[2] if kv_len is None else kv_len
    if k_planes.device.type == "cpu":
        return subquant_pack_kvt_plain(k_planes, mu, v_i8, block_k, kv_len,
                                       linear_kv)
    _require(k_planes.device.type == "cuda",
             f"no kernel for device {k_planes.device}")
    return _subquant_pack_kvt_cuda(k_planes, mu, v_i8, block_k, kv_len,
                                   linear_kv)


# ---------------------------------------------------------------------------
# K18 / K27: subquant_pack_kv, per-row and block-scale modes; K29:
# subquant_planes
# ---------------------------------------------------------------------------

def subquant_pack_kv_plain(k_planes, mu, v_i8, block_k: Optional[int] = None,
                           kv_len: Optional[int] = None):
    """Plain version of K18 (block_k None) and K27 (sla_fused.py:313-348).

    k_planes (B, H, Lp, D); mu (B, H, 1, D); v_i8 (B, H, Lp, D) int8.
    xf = f32(k) - mu. Per-row mode: scale = max(max |xf|, 1e-8) * (1/127)
    a row; block-scale mode: one scale per block_k rows, the max over the
    block's rows < kv_len (`_quant_k_blocks`); k_i8 = round(xf * (1/scale))
    half to even. Returns (kvi (B, H, Lp, 2D) int8, K in [..., :D] and V
    beside it; ks (B, H, Lp) fp32 a row, or (B, H, Lp // block_k) a block).
    Every row is written, rows past the sequence too: K19 / K28 mask them."""
    if block_k is None:
        kq, ks = _quant_rows(k_planes.float() - mu.float())
    else:
        Lp = k_planes.shape[2]
        kq, ks = _quant_k_blocks(k_planes, mu, block_k,
                                 Lp if kv_len is None else kv_len)
    return torch.cat([kq, v_i8], dim=-1), ks


def _check_kv_planes(name: str, k_planes, mu, v_i8=None):
    """K18 / K27 / K29's operands; returns mu as contiguous fp32."""
    B, H, Lp, D = k_planes.shape
    dev = k_planes.device
    _require(k_planes.dtype == torch.bfloat16 and k_planes.is_contiguous(),
             f"{name} takes contiguous bf16 K planes")
    _require(D == 128, f"{name} takes head dim 128, got {D}")
    if v_i8 is not None:
        _require(v_i8.dtype == torch.int8 and v_i8.is_contiguous()
                 and v_i8.shape == k_planes.shape and v_i8.device == dev,
                 f"{name} takes contiguous int8 V planes shaped like K")
    mu = mu.float().contiguous()
    _require(mu.numel() == B * H * D and mu.device == dev,
             f"{name} mu must be (B, H, 1, D) on K's device")
    return mu


def _subquant_pack_kv_cuda(k_planes, mu, v_i8):
    """Launch K18."""
    B, H, Lp, D = k_planes.shape
    mu = _check_kv_planes("K18", k_planes, mu, v_i8)
    kvi = torch.empty((B, H, Lp, 2 * D), dtype=torch.int8, device=k_planes.device)
    ks = torch.empty((B, H, Lp), dtype=torch.float32, device=k_planes.device)
    rc = _build.load().tdx_subquant_pack_kv(
        k_planes.data_ptr(), mu.data_ptr(), v_i8.data_ptr(), kvi.data_ptr(),
        ks.data_ptr(), B * H, Lp, _build.stream_ptr(k_planes))
    _build.check(rc, "tdx_subquant_pack_kv")
    _subquant_pack_kv_cuda.launches += 1
    return kvi, ks


_subquant_pack_kv_cuda.launches = 0


def _subquant_pack_kv_blocks_cuda(k_planes, mu, v_i8, block_k: int,
                                  kv_len: int):
    """Launch K27."""
    B, H, Lp, D = k_planes.shape
    mu = _check_kv_planes("K27", k_planes, mu, v_i8)
    _require(block_k % 64 == 0 and Lp % block_k == 0,
             f"K27 takes a block of a multiple of 64 rows dividing Lp, got "
             f"{block_k}")
    _require(0 < kv_len <= Lp, f"kv_len {kv_len} out of range")
    kvi = torch.empty((B, H, Lp, 2 * D), dtype=torch.int8, device=k_planes.device)
    ks = torch.empty((B, H, Lp // block_k), dtype=torch.float32,
                     device=k_planes.device)
    rc = _build.load().tdx_subquant_pack_kv_blocks(
        k_planes.data_ptr(), mu.data_ptr(), v_i8.data_ptr(), kvi.data_ptr(),
        ks.data_ptr(), B, H, Lp, block_k, kv_len, _build.stream_ptr(k_planes))
    _build.check(rc, "tdx_subquant_pack_kv_blocks")
    _subquant_pack_kv_blocks_cuda.launches += 1
    return kvi, ks


_subquant_pack_kv_blocks_cuda.launches = 0


def subquant_pack_kv(k_planes, mu, v_i8, block_k: Optional[int] = None,
                     kv_len: Optional[int] = None):
    """Smooth-k int8 K packed beside the int8 V (sla_fused.subquant_pack_kv):
    per-row scales when block_k is None (block_scales=False; kernel K18),
    one scale per block_k rows over the rows < kv_len otherwise
    (block_scales=True; kernel K27). The plain version on a CPU tensor, the
    kernel on a CUDA tensor. See `subquant_pack_kv_plain` for the outputs."""
    if k_planes.device.type == "cpu":
        return subquant_pack_kv_plain(k_planes, mu, v_i8, block_k, kv_len)
    _require(k_planes.device.type == "cuda",
             f"no kernel for device {k_planes.device}")
    if block_k is None:
        return _subquant_pack_kv_cuda(k_planes, mu, v_i8)
    kv_len = k_planes.shape[2] if kv_len is None else kv_len
    return _subquant_pack_kv_blocks_cuda(k_planes, mu, v_i8, block_k, kv_len)


def subquant_planes_plain(planes, mu):
    """Plain version of K29 (sla_fused.py:305-310): (B, H, Lp, Dh) planes
    minus mu (B, H, 1, Dh) in fp32, per-row int8 with scale = max(amax,
    1e-8) * (1/127), q = round(x * (1/scale)) half to even. Returns (int8
    (B, H, Lp, Dh), fp32 (B, H, Lp, 1))."""
    q, scale = _quant_rows(planes.float() - mu.float())
    return q, scale[..., None]


def _subquant_planes_cuda(planes, mu):
    """Launch K29."""
    B, H, Lp, D = planes.shape
    mu = _check_kv_planes("K29", planes, mu)
    out = torch.empty((B, H, Lp, D), dtype=torch.int8, device=planes.device)
    ks = torch.empty((B, H, Lp, 1), dtype=torch.float32, device=planes.device)
    rc = _build.load().tdx_subquant_planes(
        planes.data_ptr(), mu.data_ptr(), out.data_ptr(), ks.data_ptr(), B * H,
        Lp, _build.stream_ptr(planes))
    _build.check(rc, "tdx_subquant_planes")
    _subquant_planes_cuda.launches += 1
    return out, ks


_subquant_planes_cuda.launches = 0


def subquant_planes(planes, mu):
    """Smooth-k per-row int8 quantisation of (B, H, Lp, Dh) planes
    (sla_fused.subquant_planes): the plain version on a CPU tensor, kernel
    K29 on a CUDA tensor. No model path calls it, as in JAX."""
    if planes.device.type == "cpu":
        return subquant_planes_plain(planes, mu)
    _require(planes.device.type == "cuda", f"no kernel for device {planes.device}")
    return _subquant_planes_cuda(planes, mu)


def unfold_planes(planes, out_len: int):
    """(B, H, Lp, Dh) planes -> (B, out_len, H*Dh) for the O projection
    (sla_fused.py:646-649)."""
    B, H, Lp, Dh = planes.shape
    return planes.transpose(1, 2).reshape(B, Lp, H * Dh)[:, :out_len]


# ---------------------------------------------------------------------------
# K13 and K16: unfold_quant, narrow and wide
# ---------------------------------------------------------------------------

def unfold_quant_plain(planes, out_len: int):
    """Plain version of K13 (sla_fused.py:551-562): K8's plain version over
    the unfolded rows. Returns (int8 (B, out_len, H*Dh), fp32
    (B, out_len, 1))."""
    return quantize_rows_int8_plain(unfold_planes(planes, out_len))


def unfold_quant_wide_plain(planes, out_len: int):
    """Plain version of K16 (sla_fused.py:565-592): the same scale, and
    q = round(y / scale) half to even in fp32 (the wide TPU kernel divides
    where the narrow one multiplies by 1/scale)."""
    x = unfold_planes(planes, out_len).float()
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / INT8_MAX)
    return torch.round(x / scale).to(torch.int8), scale


def _unfold_launch(name: str, fn: str, planes, out_len: int, max_width: int):
    """Launch K13 or K16: planes (B, H, Lp, Dh) bf16 contiguous, H*Dh <=
    max_width."""
    B, H, Lp, Dh = planes.shape
    _require(planes.dtype == torch.bfloat16 and planes.is_contiguous(),
             f"{name} takes contiguous bf16 planes")
    _require(Dh % 8 == 0 and H * Dh <= max_width,
             f"{name} takes H*Dh <= {max_width} with Dh a multiple of 8, got "
             f"{H}x{Dh}")
    _require(0 < out_len <= Lp, f"out_len {out_len} out of range")
    xq = torch.empty((B, out_len, H * Dh), dtype=torch.int8,
                     device=planes.device)
    rs = torch.empty((B, out_len, 1), dtype=torch.float32,
                     device=planes.device)
    rc = getattr(_build.load(), fn)(
        planes.data_ptr(), xq.data_ptr(), rs.data_ptr(), B, out_len, Lp, H,
        Dh, _build.stream_ptr(planes))
    _build.check(rc, fn)
    return xq, rs


def _unfold_quant_cuda(planes, out_len: int):
    """Launch K13 (H*Dh <= 4096)."""
    out = _unfold_launch("K13", "tdx_unfold_quant", planes, out_len,
                         _UNFOLD_NARROW_MAX)
    _unfold_quant_cuda.launches += 1
    return out


_unfold_quant_cuda.launches = 0


def _unfold_quant_wide_cuda(planes, out_len: int):
    """Launch K16 (H*Dh <= 5120)."""
    out = _unfold_launch("K16", "tdx_unfold_quant_wide", planes, out_len,
                         _UNFOLD_WIDE_MAX)
    _unfold_quant_wide_cuda.launches += 1
    return out


_unfold_quant_wide_cuda.launches = 0


def unfold_quant(planes, out_len: int):
    """(B, H, Lp, Dh) planes -> (int8 (B, out_len, H*Dh), fp32
    (B, out_len, 1)) per-token quantised for the W8A8 O projection
    (sla_fused.unfold_quant): the narrow form (K13) up to H*Dh 4096, the
    wide form (K16) above, as the JAX function splits them; the plain
    version on a CPU tensor, the kernel on a CUDA tensor."""
    B, H, Lp, Dh = planes.shape
    wide = H * Dh > _UNFOLD_NARROW_MAX
    if planes.device.type == "cpu":
        return (unfold_quant_wide_plain if wide else unfold_quant_plain)(
            planes, out_len)
    _require(planes.device.type == "cuda", f"no kernel for device {planes.device}")
    return (_unfold_quant_wide_cuda if wide else _unfold_quant_cuda)(
        planes, out_len)
