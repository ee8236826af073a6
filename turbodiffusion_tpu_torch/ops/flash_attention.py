"""Flash attention forward: kernels K3 (block-sparse), K4 (dense), K14 and
K17 (cross attention with the int8 O feed, narrow and wide), K20 (block-
sparse with int8 QK, blocks < 128).

The counterpart of `turbodiffusion_tpu/ops/flash_pallas.py`. Its TPU
function `_flash_fwd_impl` (:1085-1269) runs the kernels that this
module replaces with hand-written CUDA (csrc/flash_attention.cu):
  * K3 `_sparse_flash_cuda` ← the bf16 sparse branch (launch :1254, body
    `_sparse_attn_kernel` :429-557): LUT-gather block-sparse flash;
  * K4 `_flash_cuda` ← the dense branches (`_attn_kernel_onepass`
    :128-144, launch :1121; `_attn_kernel` without int8 QK :64-121, launch
    :1139).
  * K14 `_cross_qout_cuda` ← `cross_attention_qout`, fused-norm mode
    (:329-401, launch :384, body `_cross_attn_qout_kernel` :147-193): the
    raw cross-Q rows, their full-row RMSNorm, every head's attention over
    the text K/V and the per-token int8 feed of the W8A8 O projection in one
    launch;
  * K17 `_cross_qout_wide_cuda` ← `_cross_attention_qout_wide`, fused-norm
    mode (launch :310, body `_cross_attn_qout_wide_kernel` :196-255), which
    `cross_attention_qout` takes above H*Dh 2048 (:353, the 14B's 5120):
    K14's function with the row's RMS inverse from `sla_fused.row_rms_inv`
    (K15), as the TPU kernel takes it. The planes mode (LTX-2) is not
    ported;
  * K20 `_sparse_flash_i8qk_cuda` ← the int8-QK sparse branch for blocks
    < 128 (launch :1200, body `_sparse_attn_kernel` with int8_qk :429-557),
    which `flash_attention(..., int8_qk=True)` takes for sagesla at
    `--sla_block 64`: K3's gather with Q quantised per row once
    (qq = round(q * (127 / max(amax, 1e-6)))) and each gathered K row the
    same way; s = ((s32 * (qa / 127)) * (ka / 127)) * Dh^-0.5, natural exp,
    P in bf16 against bf16 V. A K row quantises the same whichever Q block
    gathers it, so the kernel's first launch quantises every K row once and
    the gather reads int8 K. The smooth-k subtraction before it
    (`flash_attention`, :2028-2031) is plain torch
    (`sparse_flash_attention_i8qk`). JAX pads LUT entries to a group with
    block nK, past K's end; the port pads nothing and masks by column.

Semantics (every kernel and its plain version): logits in fp32 times
`Dh^-0.5`; columns >= kv_len get -1e30 before the row max; softmax with
`p.astype(bf16) @ v` accumulated in fp32 and divided by the fp32 row sum;
output in q's dtype (K14: int8 from the fp32 output, K8's rule, one scale
per token across all heads). Layout (B, L, H, Dh) in and out, read through
strides; K14 reads the raw (B, L, H*Dh) rows and (B, Lk, H, Dh) K/V, where
the TPU kernel folds and pads them to (B*H, Lkp, Dh).

The plain versions scale to the main path: the dense one chunks over query
rows, the sparse one gathers each Q-block's selected K/V blocks — neither
builds the (B, H, L, L) logits.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each launcher counts its launches in `.launches`. The
dense int8-QK form waits for a later slice.

Gradients (the custom VJP of `flash_attention`, :1982-2011): K3 and K4 run
inside `torch.autograd.Function`s. K3's backward is the two-pass sparse
backward, K23 + the inverse LUT + K24 (`ops/sparse_attention_bwd.py`); K4's
is `flash_attention_bwd_plain`, the port of `_attention_bwd_ref`
(:1938-1967), plain torch as JAX leaves it to XLA, chunked over query rows.
The LUT gets no gradient. K14, K17 and K20 are inference-only, as in JAX
(no path trains through them).
"""

from __future__ import annotations

from typing import Optional

import torch

from turbodiffusion_tpu_torch.models.layers import rms_norm
from turbodiffusion_tpu_torch.ops import _build

NEG_INF = -1e30
# elements of fp32 logits a plain version materialises at once (1 GiB)
_PLAIN_LOGITS_BUDGET = 1 << 28
# K14 / K17: heads of one thread block times its (64 x 136) fp32 output rows
# stay within the 227 KB of shared memory; blocks of one cluster at most 8
_QOUT_MAX_GROUP, _QOUT_MAX_CLUSTER = 5, 8
# widest q row of the narrow cross_attention_qout; K17 above it
_QOUT_NARROW_MAX = 2048


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _softmax_pv(s, v):
    """s: (..., M) fp32 masked logits; v: (..., M, D). The kernels' epilogue:
    unnormalised bf16 probabilities times v in fp32, over the fp32 row sum."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    return torch.matmul(p.to(v.dtype).float(), v.float()) / l


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _flash_plain_f32(q, k, v, scale: float, kv_len: int):
    """Dense attention in fp32 out, chunked over query rows."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kh = k.permute(0, 2, 3, 1).float()              # (B, H, D, Lk)
    vh = v.permute(0, 2, 1, 3)                      # (B, H, Lk, D)
    valid = torch.arange(Lk, device=q.device) < kv_len
    rows = max(1, _PLAIN_LOGITS_BUDGET // (B * H * Lk))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, Lq, rows):
        qh = q[:, r0:r0 + rows].permute(0, 2, 1, 3).float()
        s = torch.matmul(qh, kh) * scale            # (B, H, r, Lk)
        s = torch.where(valid, s, NEG_INF)
        out[:, r0:r0 + rows] = _softmax_pv(s, vh).permute(0, 2, 1, 3)
    return out


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          kv_len: Optional[int] = None):
    """Plain version of K4: dense attention, chunked over query rows.
    q: (B, Lq, H, D); k, v: (B, Lk, H, D); keys >= kv_len are masked."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _flash_plain_f32(q, k, v, scale, kv_len).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, do, scale: Optional[float] = None,
                              kv_len: Optional[int] = None):
    """(dq, dk, dv) of dense attention given dO, in fp32 from the saved q,
    k, v (flash_pallas.py:1938-1967 `_attention_bwd_ref` with no LUT),
    chunked over query rows; keys >= kv_len get no gradient. Outputs in the
    inputs' dtypes."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    kh = k.permute(0, 2, 1, 3).float()              # (B, H, Lk, D)
    vh = v.permute(0, 2, 1, 3).float()
    valid = torch.arange(Lk, device=q.device) < kv_len
    rows = max(1, _PLAIN_LOGITS_BUDGET // (B * H * Lk))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for r0 in range(0, Lq, rows):
        qh = q[:, r0:r0 + rows].permute(0, 2, 1, 3).float()
        gh = do[:, r0:r0 + rows].permute(0, 2, 1, 3).float()
        s = torch.where(valid, torch.matmul(qh, kh.transpose(-1, -2)) * scale,
                        NEG_INF)
        p = torch.softmax(s, -1)
        dv += torch.matmul(p.transpose(-1, -2), gh)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
        dq[:, r0:r0 + rows] = torch.matmul(ds, kh).permute(0, 2, 1, 3)
        dk += torch.matmul(ds.transpose(-1, -2), qh)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def cross_attention_qout_plain(q, k, v, norm_w, scale: Optional[float] = None,
                               eps: float = 1e-6):
    """Plain version of K14 (flash_pallas.py:147-193, fused-norm mode).
    q: (B, Lq, H*Dh) raw cross-Q projection rows; norm_w (H*Dh,); k, v:
    (B, Lk, H, Dh). WanRMSNorm of q over the full row, attention over all
    Lk keys in fp32, then (int8 (B, Lq, H*Dh), fp32 (B, Lq, 1)) from the
    fp32 output with one scale per token across all heads."""
    from turbodiffusion_tpu_torch.ops.quant import (  # quant imports this
        quantize_rows_int8_plain)
    B, Lq, HD = q.shape
    H, Dh = k.shape[2], k.shape[3]
    _require(H * Dh == HD, f"q width {HD} != {H} heads x {Dh}")
    scale = Dh ** -0.5 if scale is None else scale
    qn = rms_norm(q, norm_w, eps=eps).reshape(B, Lq, H, Dh)
    o = _flash_plain_f32(qn, k, v, scale, k.shape[1])
    return quantize_rows_int8_plain(o.reshape(B, Lq, HD))


def cross_attention_qout_wide_plain(q, rms_inv, k, v, norm_w,
                                    scale: Optional[float] = None):
    """Plain version of K17 (flash_pallas.py:196-255, fused-norm mode): K14's
    with the row's RMS inverse given, rms_inv (B, Lq, 1) fp32: the normed q
    is bf16(q * rms_inv) * norm_w in bf16."""
    from turbodiffusion_tpu_torch.ops.quant import (  # quant imports this
        quantize_rows_int8_plain)
    B, Lq, HD = q.shape
    H, Dh = k.shape[2], k.shape[3]
    _require(H * Dh == HD, f"q width {HD} != {H} heads x {Dh}")
    scale = Dh ** -0.5 if scale is None else scale
    qn = (q.float() * rms_inv.float()).to(q.dtype) * norm_w.to(q.dtype)
    o = _flash_plain_f32(qn.reshape(B, Lq, H, Dh), k, v, scale, k.shape[1])
    return quantize_rows_int8_plain(o.reshape(B, Lq, HD))


def _quant_rows_i8qk(x):
    """The int8-QK kernel's per-row quantisation (flash_pallas.py:503-505,
    :524-527): amax = max(max |x|, 1e-6), q = round(x * (127 / amax)) half
    to even. Returns (q as fp32 integers, amax / 127)."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    return torch.round(xf * (127.0 / amax)), amax / 127.0


def _sparse_gather_plain(q, k, v, lut, block_q: int, block_k: int,
                         scale: Optional[float], kv_len: Optional[int],
                         int8_qk: bool):
    """Each Q-block attends to the K-blocks its LUT row names, by gathering
    them: the plain versions of K3 and (int8_qk) K20."""
    B, L, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    nQ, nK = _cdiv(L, block_q), _cdiv(Lk, block_k)
    sel = lut.shape[-1]
    _require(tuple(lut.shape) == (B, H, nQ, sel),
             f"lut must be (B, H, nQ={nQ}, sel), got {tuple(lut.shape)}")

    def blocks(x, n, blk):                          # -> (B, H, n, blk, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * blk - x.shape[1]))
        return x.reshape(B, n, blk, H, D).permute(0, 3, 1, 2, 4)

    qb, kb, vb = blocks(q, nQ, block_q), blocks(k, nK, block_k), \
        blocks(v, nK, block_k)
    if int8_qk:
        (qb, qa), (kb, ka) = _quant_rows_i8qk(qb), _quant_rows_i8qk(kb)
    lut = lut.long()
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, :, None, None]
    cols = lut[..., None] * block_k + torch.arange(block_k, device=q.device)
    step = max(1, _PLAIN_LOGITS_BUDGET // (B * H * block_q * sel * block_k))
    out = torch.empty((B, H, nQ, block_q, D), dtype=q.dtype, device=q.device)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        ids = lut[:, :, sl]
        n = ids.shape[2]
        kg = kb[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
        vg = vb[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
        s = torch.matmul(qb[:, :, sl].float(), kg.float().transpose(-1, -2))
        if int8_qk:
            # exact: |qq . kq| <= 127^2 * D < 2^24 for D <= 1024
            kag = ka[bi, hi, ids].reshape(B, H, n, 1, sel * block_k)
            s = s * qa[:, :, sl] * kag * scale
        else:
            s = s * scale
        valid = (cols[:, :, sl] < kv_len).reshape(B, H, n, 1, sel * block_k)
        s = torch.where(valid, s, NEG_INF)
        out[:, :, sl] = _softmax_pv(s, vg).to(q.dtype)
    out = out.reshape(B, H, nQ * block_q, D)[:, :, :L]
    return out.permute(0, 2, 1, 3).contiguous()


def sparse_flash_attention_plain(q, k, v, lut, block_q: int, block_k: int,
                                 scale: Optional[float] = None,
                                 kv_len: Optional[int] = None):
    """Plain version of K3: each Q-block attends to the K-blocks its LUT row
    names, by gathering them. q: (B, L, H, D); k, v: (B, Lk, H, D);
    lut: (B, H, nQ, sel) int K-block ids; keys >= kv_len are masked."""
    return _sparse_gather_plain(q, k, v, lut, block_q, block_k, scale, kv_len,
                                int8_qk=False)


def sparse_flash_attention_i8qk_plain(q, k, v, lut, block_q: int,
                                      block_k: int,
                                      scale: Optional[float] = None,
                                      kv_len: Optional[int] = None):
    """Plain version of K20: K3's gather with int8 QK. q: (B, L, H, D); k
    (already smooth-k subtracted), v: (B, Lk, H, D); lut: (B, H, nQ, sel)
    int K-block ids; keys >= kv_len are masked. Output in q's dtype."""
    return _sparse_gather_plain(q, k, v, lut, block_q, block_k, scale, kv_len,
                                int8_qk=True)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check_qkv(q, k, v, kv_len):
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             "q, k, v must lie on one CUDA device")
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             "the kernel takes bf16 q, k, v")
    _require(q.dim() == 4 and k.shape == v.shape and k.shape[0] == q.shape[0]
             and k.shape[2:] == q.shape[2:],
             "q (B, Lq, H, D) and k, v (B, Lk, H, D) must agree")
    _require(q.shape[-1] == 128, f"the kernel takes head dim 128, got {q.shape[-1]}")
    for t in (q, k, v):
        _require(t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
                 and t.data_ptr() % 16 == 0,
                 "q, k, v need a unit last stride, 16-byte aligned rows")
    _require(0 < kv_len <= k.shape[1], f"kv_len {kv_len} out of range")


def _strides(*ts):
    out = []
    for t in ts:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _sparse_flash_cuda(q, k, v, lut, block_q: int, block_k: int,
                       scale: float, kv_len: int):
    """Launch K3."""
    B, L, H, D = q.shape
    _check_qkv(q, k, v, kv_len)
    _require(block_q % 64 == 0 and block_k % 64 == 0,
             f"K3 takes blocks that are multiples of 64, got {block_q}/{block_k}")
    nQ = _cdiv(L, block_q)
    _require(lut.dim() == 4 and tuple(lut.shape[:3]) == (B, H, nQ)
             and lut.device == q.device,
             f"lut must be (B, H, {nQ}, sel) on q's device")
    lut = lut.to(torch.int32).contiguous()
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    rc = lib.tdx_sparse_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lut.data_ptr(), B, H, L, kv_len, nQ, lut.shape[-1], block_q, block_k,
        *_strides(q, k, v, out), float(scale), _build.stream_ptr(q))
    _build.check(rc, "tdx_sparse_flash_attention")
    _sparse_flash_cuda.launches += 1
    return out


_sparse_flash_cuda.launches = 0


def _sparse_flash_i8qk_cuda(q, k, v, lut, block_q: int, block_k: int,
                            scale: float, kv_len: int):
    """Launch K20: K's rows quantised once into scratch, then the gather."""
    B, L, H, D = q.shape
    _check_qkv(q, k, v, kv_len)
    _require(block_q % 64 == 0 and block_k % 64 == 0,
             f"K20 takes blocks that are multiples of 64, got {block_q}/{block_k}")
    nQ = _cdiv(L, block_q)
    _require(lut.dim() == 4 and tuple(lut.shape[:3]) == (B, H, nQ)
             and lut.device == q.device,
             f"lut must be (B, H, {nQ}, sel) on q's device")
    lut = lut.to(torch.int32).contiguous()
    Lk = k.shape[1]
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    kq = torch.empty((B, H, Lk, D), dtype=torch.int8, device=q.device)
    ksc = torch.empty((B, H, Lk), dtype=torch.float32, device=q.device)
    rc = _build.load().tdx_sparse_flash_attention_i8qk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lut.data_ptr(), kq.data_ptr(), ksc.data_ptr(), B, H, L, Lk, kv_len, nQ,
        lut.shape[-1], block_q, block_k, *_strides(q, k, v, out), float(scale),
        _build.stream_ptr(q))
    _build.check(rc, "tdx_sparse_flash_attention_i8qk")
    _sparse_flash_i8qk_cuda.launches += 1
    return out


_sparse_flash_i8qk_cuda.launches = 0


def _flash_cuda(q, k, v, scale: float, kv_len: int):
    """Launch K4."""
    B, L, H, D = q.shape
    _check_qkv(q, k, v, kv_len)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    rc = lib.tdx_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, L, kv_len, *_strides(q, k, v, out), float(scale),
        _build.stream_ptr(q))
    _build.check(rc, "tdx_flash_attention")
    _flash_cuda.launches += 1
    return out


_flash_cuda.launches = 0


def _qout_group(H: int) -> int:
    """K14's and K17's heads per thread block: the least G dividing H with
    H / G <= 8 blocks a cluster."""
    return next(g for g in range(1, H + 1)
                if H % g == 0 and H // g <= _QOUT_MAX_CLUSTER)


def _qout_operands(name: str, q, k, v, norm_w):
    """Check K14 / K17's operands; returns (row stride of q, heads a block,
    the bf16 norm weight)."""
    from turbodiffusion_tpu_torch.ops.fused_norm import _row_stride  # cycle
    B, Lq, HD = q.shape
    Lk, H = k.shape[1], k.shape[2]
    _require(HD % H == 0, f"q width {HD} is no multiple of {H} heads")
    ldq = _row_stride(q, name)
    _check_qkv(q.unflatten(-1, (H, HD // H)), k, v, Lk)
    G = _qout_group(H)
    _require(HD == H * 128 and G <= _QOUT_MAX_GROUP,
             f"{name} takes heads of 128, at most {_QOUT_MAX_GROUP} a block in "
             f"clusters of <= {_QOUT_MAX_CLUSTER}, got {H} heads, width {HD}")
    w = norm_w.to(torch.bfloat16).contiguous()
    _require(w.device == q.device and w.numel() == HD,
             f"{name} norm_w must lie on q's device with H*Dh entries")
    return ldq, G, w


def _qout_outputs(q):
    B, Lq, HD = q.shape
    return (torch.empty((B, Lq, HD), dtype=torch.int8, device=q.device),
            torch.empty((B, Lq, 1), dtype=torch.float32, device=q.device))


def _cross_qout_cuda(q, k, v, norm_w, scale: float, eps: float):
    """Launch K14. q (B, Lq, H*128) bf16 with 16-byte aligned rows
    `_row_stride` apart; norm_w (H*128,); k, v (B, Lk, H, 128) bf16."""
    ldq, G, w = _qout_operands("K14", q, k, v, norm_w)
    B, Lq, _ = q.shape
    xq, rs = _qout_outputs(q)
    rc = _build.load().tdx_cross_attention_qout(
        q.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(), xq.data_ptr(),
        rs.data_ptr(), ldq, B, k.shape[2], G, Lq, k.shape[1], *_strides(k, v),
        float(scale), float(eps), _build.stream_ptr(q))
    _build.check(rc, "tdx_cross_attention_qout")
    _cross_qout_cuda.launches += 1
    return xq, rs


_cross_qout_cuda.launches = 0


def _cross_qout_wide_cuda(q, rms_inv, k, v, norm_w, scale: float):
    """Launch K17: K14's operands plus rms_inv (B, Lq, 1) fp32, K15's."""
    ldq, G, w = _qout_operands("K17", q, k, v, norm_w)
    B, Lq, _ = q.shape
    ri = rms_inv.reshape(B, Lq).float().contiguous()
    _require(ri.device == q.device, "K17 rms_inv must lie on q's device")
    xq, rs = _qout_outputs(q)
    rc = _build.load().tdx_cross_attention_qout_wide(
        q.data_ptr(), w.data_ptr(), ri.data_ptr(), k.data_ptr(), v.data_ptr(),
        xq.data_ptr(), rs.data_ptr(), ldq, B, k.shape[2], G, Lq, k.shape[1],
        *_strides(k, v), float(scale), _build.stream_ptr(q))
    _build.check(rc, "tdx_cross_attention_qout_wide")
    _cross_qout_wide_cuda.launches += 1
    return xq, rs


_cross_qout_wide_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class _FlashFn(torch.autograd.Function):
    """K4 forward, `flash_attention_bwd_plain` backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_len: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, kv_len)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale, kv_len)
        _require(q.device.type == "cuda", f"no kernel for device {q.device}")
        return _flash_cuda(q, k, v, scale, kv_len)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, do, *ctx.args), None,
                None)


class _SparseFlashFn(torch.autograd.Function):
    """K3 forward, K23 + K24 backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lut, block_q: int, block_k: int, scale: float,
                kv_len: int):
        ctx.save_for_backward(q, k, v, lut)
        ctx.args = (block_q, block_k, scale, kv_len)
        if q.device.type == "cpu":
            return sparse_flash_attention_plain(q, k, v, lut, block_q,
                                                block_k, scale, kv_len)
        _require(q.device.type == "cuda", f"no kernel for device {q.device}")
        return _sparse_flash_cuda(q, k, v, lut, block_q, block_k, scale,
                                  kv_len)

    @staticmethod
    def backward(ctx, do):
        from turbodiffusion_tpu_torch.ops.sparse_attention_bwd import (  # cycle
            sparse_flash_attention_bwd)
        q, k, v, lut = ctx.saved_tensors
        dq, dk, dv = sparse_flash_attention_bwd(q, k, v, do, lut, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    kv_len: Optional[int] = None):
    """Dense softmax attention (K4) over (B, L, H, D) tensors;
    differentiable in q, k and v."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    return _FlashFn.apply(q, k, v, scale, kv_len)


def sparse_flash_attention(q, k, v, lut, block_q: int, block_k: int,
                           scale: Optional[float] = None,
                           kv_len: Optional[int] = None):
    """Block-sparse attention (K3): Q-block i attends to the K-blocks
    lut[b, h, i, :] (flash_pallas.flash_attention with a `lut`);
    differentiable in q, k and v (K23 + K24)."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    return _SparseFlashFn.apply(q, k, v, lut, block_q, block_k, scale, kv_len)


def sparse_flash_attention_i8qk(q, k, v, lut, block_q: int, block_k: int,
                                scale: Optional[float] = None):
    """Block-sparse SageSLA attention with int8 QK at blocks < 128
    (flash_pallas.flash_attention with a `lut` and int8_qk=True): smooth-k
    (k minus its mean over the sequence, in k's dtype) in plain torch, then
    the plain version of K20 on a CPU tensor, K20 on a CUDA tensor."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1]
    k = k - k.mean(dim=1, keepdim=True)
    if q.device.type == "cpu":
        return sparse_flash_attention_i8qk_plain(q, k, v, lut, block_q,
                                                 block_k, scale, kv_len)
    _require(q.device.type == "cuda", f"no kernel for device {q.device}")
    return _sparse_flash_i8qk_cuda(q, k, v, lut, block_q, block_k, scale,
                                   kv_len)


def cross_attention_qout(q, k, v, norm_w, scale: Optional[float] = None,
                         eps: float = 1e-6):
    """q-RMSNorm + dense cross attention + the per-token int8 O feed
    (flash_pallas.cross_attention_qout with norm_w): q (B, Lq, H*Dh) raw
    projection rows, k, v (B, Lk, H, Dh). Returns (int8 (B, Lq, H*Dh), fp32
    (B, Lq, 1)) for `int8_linear_prequant`. Up to H*Dh 2048 the narrow form
    (K14); above it, as the JAX function splits them, the row's RMS inverse
    (`row_rms_inv`, K15) then the wide form (K17). The plain versions on a
    CPU tensor, the kernels on a CUDA tensor."""
    from turbodiffusion_tpu_torch.ops.sla_fused import row_rms_inv  # cycle
    scale = float(k.shape[-1] ** -0.5) if scale is None else float(scale)
    cpu = q.device.type == "cpu"
    _require(cpu or q.device.type == "cuda", f"no kernel for device {q.device}")
    if q.shape[-1] <= _QOUT_NARROW_MAX:
        if cpu:
            return cross_attention_qout_plain(q, k, v, norm_w, scale, eps)
        return _cross_qout_cuda(q, k, v, norm_w, scale, eps)
    ri = row_rms_inv(q, eps)
    if cpu:
        return cross_attention_qout_wide_plain(q, ri, k, v, norm_w, scale)
    return _cross_qout_wide_cuda(q, ri, k, v, norm_w, scale)
