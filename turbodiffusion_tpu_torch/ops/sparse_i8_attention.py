"""Block-sparse INT8 attention of the fused SageSLA path: kernels K7, K19,
K28.

The counterpart of three functions of `turbodiffusion_tpu/ops/flash_pallas.py`:
  * `quantize_v_per_channel` (:1068-1082) — plain torch: per-(head, channel)
    symmetric int8 V, the channel absmax taken over rows < kv_len;
  * `sparse_attention_i8_vt` — K7 `_sparse_i8_vt_cuda` replaces the TPU
    kernel of the same name (launch :1032, body `_sparse_attn_kernel_i8b_vt`
    :809-951), with its fused SLA linear-branch epilogue;
  * `sparse_attention_i8_planes` — K19 `_sparse_i8_planes_cuda` replaces its
    per-row form (launch :1432, body `_sparse_attn_kernel_i8` :560-680,
    metadata :1391-1421), the `v_quant="row"` path: int8 Q, K and V with
    per-row fp32 scales, K and V packed in rows (K18's layout), in one of
    two forms by its blocks (`sparse_i8_planes_form`): K7's wgmma + TMA
    kernel on the packed rows with a K and a V scale a key at multiples of
    128 (every `--v_quant row` call: 512/256), K3's mma.sync walk at the
    other multiples of 64; K28
    `_sparse_i8_planes_bs_cuda` replaces its block-scale form (launch
    :1363, body `_sparse_attn_kernel_i8b` :683-806, wrapper :1345-1390):
    K7's scoring (one K scale a block, the softmax scale and log2 e folded
    into it, exp2, -1e9 past kv_len, per-channel V at the finalize) over
    K27's packed rows, which fused sagesla takes at v_quant "channel" once
    sel * block_k exceeds 8,192; in one of two forms by its blocks
    (`sparse_i8_planes_bs_form`): K7's wgmma + TMA kernel reading the
    packed rows at multiples of 128, K19's mma.sync walk at the other
    multiples of 64.

K19's semantics (kernel and plain version), per query row r over the keys c
of the selected K-blocks:
  s = (int32(qi[r] . k[c]) * (qs[r] * Dh^-0.5)) * ks[c], keys >= kv_len set
  to -1e30 before the row max; p = exp(s - max) (natural exp); l = sum p;
  o = (bf16(p * vs[c]) @ bf16(v_i8)) / max(l, 1e-20), bf16 out. A LUT id
outside [0, nK) names no key, and a row with no key before kv_len is zero.
The TPU's poison block (LUT padding pointing at a zero block with a -1e30
bias, and zero scales past kv_len) has no counterpart: the port pads no LUT
entries and masks by column, as K3 and K7 do.

K7's semantics (kernel and plain version), per (b, h) and query row r of
Q-block i, over the keys of the K-blocks lut[b, h, i, :]:
  s = int32(qi[r] . kp[c]) * qs[r] * (ks[blk(c)] * Dh^-0.5 * log2 e), keys
  >= kv_len set to -1e9 before the row max; p = exp2(s - max); l = sum p;
  o = (bf16(p) @ bf16(v_i8)) / max(l, 1e-20) * vch.
With the linear epilogue (lin_kvw, lin_ks_bias):
  phi(q) = softmax_D(f32(qi[r]) * qs[r]);
  o += phi(q) @ kvw / (1e-5 + phi(q) . ksum) + bias.
Output bf16 planes (B, H, Lp, Dh).

K28's semantics are K7's, with K and V read from packed (B, H, Lk, 2D)
rows.

The kernels stream the LUT blocks with an online softmax, where K7's TPU
kernel holds all sel*block_k scores at once (and K19's and K28's stream
groups of blocks); that changes only where p is rounded to bf16. The
TPU's 8,192-key bound on sel*block_k is its resident-tile budget and does
not bind here: K7 gathers any sel. JAX takes K7's TPU kernel below the
bound and K28's above it; the port keeps that dispatch
(`ops/attention.sla_attention_fused`) to compute JAX's function, though
K7 is the faster of the two on the card.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (csrc/sparse_i8_attention.cu) or raises. `.launches` counts launches.
K7 (wgmma fed by TMA, 128 query rows a block, 128-key chunks) takes block_q
and block_k in multiples of 128 and 16-byte aligned q and panels, as do
K19's and K28's wgmma forms (K19's row scales too: each chunk's come by a
bulk copy); their mma.sync forms the other multiples of 64. The wrappers
check these before anything is built or launched.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import (
    _PLAIN_LOGITS_BUDGET, NEG_INF, _require)

LOG2E = math.log2(math.e)
MASKED = -1e9                 # score of a key >= kv_len (flash_pallas.py:933)
_K7_TILE = 128                # K7's query rows a block and keys a chunk


def quantize_v_per_channel(v_planes, kv_len: int, eps: float = 1e-8):
    """(B, H, Lp, D) V planes -> (int8 (B, H, Lp, D), fp32 scales
    (B, H, 1, D)): per-(head, channel) absmax over rows < kv_len,
    q = clip(round(v / scale), -127, 127) (flash_pallas.py:1068-1082)."""
    vf = v_planes.float()
    valid = (torch.arange(vf.shape[2], device=vf.device) < kv_len)[:, None]
    amax = torch.where(valid, vf.abs(), 0.0).amax(2, keepdim=True)
    scale = amax.clamp_min(eps) / 127.0
    vi = torch.round(vf / scale).clamp_(-127, 127).to(torch.int8)
    return vi, scale


def _pad_lut(lut, nQ: int):
    """LUT rows for every Q-block of the padded length: the rows past the
    block map's last are block 0's id list of zeros, as the JAX wrapper pads
    them (flash_pallas.py:1000-1003)."""
    n = lut.shape[2]
    if n < nQ:
        lut = torch.nn.functional.pad(lut, (0, 0, 0, nQ - n))
    return lut[:, :, :nQ]


def sparse_attention_i8_vt_plain(qi, qs, k_panel, vt_panel, k_block_scale,
                                 v_channel_scale, lut, *,
                                 scale: Optional[float] = None,
                                 block_q: int = 256, block_k: int = 256,
                                 kv_len: Optional[int] = None,
                                 lin_kvw=None, lin_ks_bias=None):
    """Plain version of K7: the one-pass softmax of the TPU kernel over the
    gathered blocks, chunked over Q-blocks. qi (B, H, Lp, D) int8; qs
    (B, H, Lp) fp32; k_panel (B, H, Lkp, D) int8; vt_panel
    (B, H, nK, D, block_k) int8; k_block_scale (B, H, nK); v_channel_scale
    (B, H, 1, D); lut (B, H, nQr, sel) int. An id outside [0, nK) names no
    key, and a row with no key before kv_len is zero, as the kernel gives
    it."""
    B, H, Lp, D = qi.shape
    Lkp = k_panel.shape[2]
    kv_len = Lkp if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    nQ, nK = Lp // block_q, Lkp // block_k
    lut = _pad_lut(lut.long(), nQ)
    sel = lut.shape[-1]
    dev = qi.device
    ksc = k_block_scale.reshape(B, H, nK).float() * (scale * LOG2E)
    qb = qi.reshape(B, H, nQ, block_q, D)
    qsb = qs.reshape(B, H, nQ, block_q, 1).float()
    kb = k_panel.reshape(B, H, nK, block_k, D)
    vch = v_channel_scale.reshape(B, H, 1, 1, D).float()
    bi = torch.arange(B, device=dev)[:, None, None, None]
    hi = torch.arange(H, device=dev)[None, :, None, None]
    named = (lut >= 0) & (lut < nK)
    cols = torch.where(named[..., None],
                       lut[..., None] * block_k + torch.arange(block_k, device=dev),
                       kv_len)
    lut = torch.where(named, lut, 0)
    lin = lin_kvw is not None
    if lin:
        kvw = lin_kvw.reshape(B, H, 1, D, D).float()
        lsb = lin_ks_bias.reshape(B, H, 2, D).float()
        ksum = lsb[:, :, None, None, 0]                     # (B, H, 1, 1, D)
        bias = lsb[:, :, None, None, 1]
    step = max(1, _PLAIN_LOGITS_BUDGET // (B * H * block_q * sel * block_k))
    out = torch.empty((B, H, nQ, block_q, D), dtype=torch.bfloat16, device=dev)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        ids = lut[:, :, sl]
        n = ids.shape[2]
        kg = kb[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
        vg = vt_panel[bi, hi, ids].transpose(-1, -2).reshape(
            B, H, n, sel * block_k, D)
        krow = ksc[bi, hi, ids].repeat_interleave(block_k, -1)[:, :, :, None]
        # exact: |qi . kp| <= 127^2 * 128 < 2^24
        s32 = torch.matmul(qb[:, :, sl].float(), kg.float().transpose(-1, -2))
        s = s32 * qsb[:, :, sl] * krow
        valid = (cols[:, :, sl] < kv_len).reshape(B, H, n, 1, sel * block_k)
        s = torch.where(valid, s, MASKED)
        p = torch.where(valid, torch.exp2(s - s.amax(-1, keepdim=True)), 0.0)
        l = p.sum(-1, keepdim=True)
        pv = torch.matmul(p.bfloat16().float(), vg.float())
        o = pv / l.clamp_min(1e-20) * vch
        if lin:
            pq = qb[:, :, sl].float() * qsb[:, :, sl]
            pq = torch.exp(pq - pq.amax(-1, keepdim=True))
            pq = pq / pq.sum(-1, keepdim=True)
            num = torch.matmul(pq, kvw)
            den = 1e-5 + (pq * ksum).sum(-1, keepdim=True)
            o = o + num / den + bias
        out[:, :, sl] = o.to(torch.bfloat16)
    return out.reshape(B, H, Lp, D)


def _sparse_i8_vt_cuda(qi, qs, k_panel, vt_panel, k_block_scale,
                       v_channel_scale, lut, scale: float, block_q: int,
                       block_k: int, kv_len: int, lin_kvw, lin_ks_bias):
    """Launch K7."""
    B, H, Lp, D = qi.shape
    Lkp = k_panel.shape[2]
    dev = qi.device
    _require(D == 128, f"K7 takes head dim 128, got {D}")
    _require(qi.dtype == k_panel.dtype == vt_panel.dtype == torch.int8,
             "K7 takes int8 q, K panel and V panel")
    nQ, nK = Lp // block_q, Lkp // block_k
    _require(block_q % _K7_TILE == 0 and Lp % block_q == 0,
             f"K7 takes a Q block of a multiple of {_K7_TILE} rows dividing "
             f"Lp, got {block_q}")
    _require(block_k % _K7_TILE == 0 and Lkp % block_k == 0,
             f"K7 takes a K block of a multiple of {_K7_TILE} rows dividing "
             f"Lk, got {block_k}")
    _require(tuple(vt_panel.shape) == (B, H, nK, D, block_k)
             and tuple(k_panel.shape) == (B, H, Lkp, D),
             "K7 panels must be (B, H, Lk, D) and (B, H, nK, D, block_k)")
    _require(0 < kv_len <= Lkp, f"kv_len {kv_len} out of range")
    ts = [qi, k_panel, vt_panel]
    _require(all(t.is_contiguous() and t.device == dev for t in ts),
             "K7 takes contiguous tensors on one CUDA device")
    _require(all(t.data_ptr() % 16 == 0 for t in ts),
             "K7 takes 16-byte aligned q and panels (TMA)")
    qs = qs.float().reshape(B, H, Lp).contiguous()
    ks = k_block_scale.float().reshape(B, H, nK).contiguous()
    vch = v_channel_scale.float().reshape(B, H, D).contiguous()
    lut = _pad_lut(lut.to(device=dev, dtype=torch.int32), nQ).contiguous()
    _require(lut.shape[:2] == (B, H), "K7 lut must be (B, H, nQ, sel)")
    lin = lin_kvw is not None
    if lin:
        lin_kvw = lin_kvw.float().reshape(B, H, D, D).contiguous()
        lin_ks_bias = lin_ks_bias.float().reshape(B, H, 2, D).contiguous()
    for t in (qs, ks, vch, lut) + ((lin_kvw, lin_ks_bias) if lin else ()):
        _require(t.device == dev, "K7 operands must lie on q's device")
    out = torch.empty((B, H, Lp, D), dtype=torch.bfloat16, device=dev)
    lib = _build.load()
    rc = lib.tdx_sparse_attention_i8_vt(
        qi.data_ptr(), qs.data_ptr(), k_panel.data_ptr(), vt_panel.data_ptr(),
        ks.data_ptr(), vch.data_ptr(), lut.data_ptr(),
        lin_kvw.data_ptr() if lin else None,
        lin_ks_bias.data_ptr() if lin else None, out.data_ptr(),
        B, H, Lp, Lkp, kv_len, nQ, lut.shape[-1], block_q, block_k,
        float(scale * LOG2E), _build.stream_ptr(qi))
    _build.check(rc, "tdx_sparse_attention_i8_vt")
    _sparse_i8_vt_cuda.launches += 1
    return out


_sparse_i8_vt_cuda.launches = 0


def sparse_attention_i8_vt(qi, qs, k_panel, vt_panel, k_block_scale,
                           v_channel_scale, lut, *,
                           scale: Optional[float] = None,
                           block_q: int = 256, block_k: int = 256,
                           kv_len: Optional[int] = None,
                           lin_kvw=None, lin_ks_bias=None):
    """Block-sparse SageSLA attention over int8 planes
    (flash_pallas.sparse_attention_i8_vt): the plain version on a CPU tensor,
    kernel K7 on a CUDA tensor. lin_kvw (B, H, D, D) and lin_ks_bias
    (B, H, 2, D) (row 0 ksum, row 1 proj_l bias) fuse the SLA linear branch
    into the epilogue."""
    scale = float(qi.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k_panel.shape[2] if kv_len is None else kv_len
    _require((lin_kvw is None) == (lin_ks_bias is None),
             "lin_kvw and lin_ks_bias go together")
    if qi.device.type == "cpu":
        return sparse_attention_i8_vt_plain(
            qi, qs, k_panel, vt_panel, k_block_scale, v_channel_scale, lut,
            scale=scale, block_q=block_q, block_k=block_k, kv_len=kv_len,
            lin_kvw=lin_kvw, lin_ks_bias=lin_ks_bias)
    _require(qi.device.type == "cuda", f"no kernel for device {qi.device}")
    return _sparse_i8_vt_cuda(qi, qs, k_panel, vt_panel, k_block_scale,
                              v_channel_scale, lut, scale, block_q, block_k,
                              kv_len, lin_kvw, lin_ks_bias)


# ---------------------------------------------------------------------------
# K19: sparse_attention_i8_planes, per-row form
# ---------------------------------------------------------------------------

def sparse_attention_i8_planes_plain(qi, qs, kvi, ks, vs, lut, *,
                                     scale: Optional[float] = None,
                                     block_q: int = 256, block_k: int = 256,
                                     kv_len: Optional[int] = None):
    """Plain version of K19: the one-pass softmax over the gathered blocks,
    chunked over Q-blocks. qi (B, H, Lp, D) int8; qs (B, H, Lp) fp32; kvi
    (B, H, Lkp, 2D) int8, K in [..., :D] and V beside it (K18's layout); ks,
    vs (B, H, Lkp) fp32 row scales; lut (B, H, nQr, sel) int. Scales past
    kv_len never reach an output (the TPU wrapper zeroes them, :1406-1408).
    An id outside [0, nK) names no key, and a row with no key before kv_len
    is zero, as the kernels give it."""
    B, H, Lp, D = qi.shape
    Lkp = kvi.shape[2]
    kv_len = Lkp if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    nQ, nK = Lp // block_q, Lkp // block_k
    lut = _pad_lut(lut.long(), nQ)
    sel = lut.shape[-1]
    dev = qi.device
    valid = torch.arange(Lkp, device=dev) < kv_len
    ksb = torch.where(valid, ks.reshape(B, H, Lkp).float(), 0.0).reshape(
        B, H, nK, block_k)
    vsb = torch.where(valid, vs.reshape(B, H, Lkp).float(), 0.0).reshape(
        B, H, nK, block_k)
    qb = qi.reshape(B, H, nQ, block_q, D)
    qsb = qs.reshape(B, H, nQ, block_q, 1).float() * scale
    kb = kvi[..., :D].reshape(B, H, nK, block_k, D)
    vb = kvi[..., D:].reshape(B, H, nK, block_k, D)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    hi = torch.arange(H, device=dev)[None, :, None, None]
    named = (lut >= 0) & (lut < nK)
    cols = torch.where(named[..., None],
                       lut[..., None] * block_k + torch.arange(block_k, device=dev),
                       kv_len)
    lut = torch.where(named, lut, 0)
    step = max(1, _PLAIN_LOGITS_BUDGET // (B * H * block_q * sel * block_k))
    out = torch.empty((B, H, nQ, block_q, D), dtype=torch.bfloat16, device=dev)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        ids = lut[:, :, sl]
        n = ids.shape[2]
        kg = kb[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
        vg = vb[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
        krow = ksb[bi, hi, ids].reshape(B, H, n, 1, sel * block_k)
        vrow = vsb[bi, hi, ids].reshape(B, H, n, 1, sel * block_k)
        # exact: |qi . k| <= 127^2 * 128 < 2^24
        s32 = torch.matmul(qb[:, :, sl].float(), kg.float().transpose(-1, -2))
        s = s32 * qsb[:, :, sl] * krow
        ok = (cols[:, :, sl] < kv_len).reshape(B, H, n, 1, sel * block_k)
        s = torch.where(ok, s, NEG_INF)
        p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        l = p.sum(-1, keepdim=True)
        pv = torch.matmul((p * vrow).bfloat16().float(), vg.float())
        out[:, :, sl] = (pv / l.clamp_min(1e-20)).to(torch.bfloat16)
    return out.reshape(B, H, Lp, D)


def _planes_form(name: str, Lp: int, Lkp: int, kv_len: int, block_q: int,
                 block_k: int) -> str:
    _require(block_q > 0 and block_q % 64 == 0 and Lp > 0 and Lp % block_q == 0,
             f"{name} takes a Q block of a multiple of 64 rows dividing Lp, "
             f"got {block_q}")
    _require(block_k > 0 and block_k % 64 == 0 and Lkp > 0 and Lkp % block_k == 0,
             f"{name} takes a K block of a multiple of 64 rows dividing Lk, "
             f"got {block_k}")
    _require(0 < kv_len <= Lkp, f"kv_len {kv_len} out of range")
    return "wgmma" if block_q % _K7_TILE == 0 and block_k % _K7_TILE == 0 else "mma"


def sparse_i8_planes_form(Lp: int, Lkp: int, kv_len: int, block_q: int,
                          block_k: int) -> str:
    """The kernel a K19 launch takes (csrc/sparse_i8_attention.cu
    `planes_form`): "wgmma", K7's warp-specialised kernel on K18's packed
    K|V rows with a K and a V scale a key (`k7::sparse_i8_vt_kernel<2>`),
    for blocks that are multiples of 128 (every `--v_quant row` call:
    512/256); "mma", the mma.sync loop (`sparse_i8_planes_kernel<false>`),
    for the other multiples of 64. Raises where neither computes: other
    blocks, blocks that do not divide the padded lengths Lp / Lkp, kv_len
    outside (0, Lkp]."""
    return _planes_form("K19", Lp, Lkp, kv_len, block_q, block_k)


def _sparse_i8_planes_cuda(qi, qs, kvi, ks, vs, lut, scale: float,
                           block_q: int, block_k: int, kv_len: int):
    """Launch K19 in its form (`sparse_i8_planes_form`)."""
    B, H, Lp, D = qi.shape
    Lkp = kvi.shape[2]
    dev = qi.device
    _require(D == 128, f"K19 takes head dim 128, got {D}")
    _require(qi.dtype == kvi.dtype == torch.int8, "K19 takes int8 q and K|V")
    _require(tuple(kvi.shape) == (B, H, Lkp, 2 * D),
             "K19 takes packed K|V rows (B, H, Lk, 2D)")
    form = sparse_i8_planes_form(Lp, Lkp, kv_len, block_q, block_k)
    _require(all(t.is_contiguous() and t.device == dev for t in (qi, kvi)),
             "K19 takes contiguous tensors on one CUDA device")
    qs = qs.float().reshape(B, H, Lp).contiguous()
    ks = ks.float().reshape(B, H, Lkp).contiguous()
    vs = vs.float().reshape(B, H, Lkp).contiguous()
    nQ = Lp // block_q
    lut = _pad_lut(lut.to(device=dev, dtype=torch.int32), nQ).contiguous()
    _require(lut.shape[:2] == (B, H), "K19 lut must be (B, H, nQ, sel)")
    for t in (qs, ks, vs):
        _require(t.device == dev, "K19 operands must lie on q's device")
    if form == "wgmma":
        _require(all(t.data_ptr() % 16 == 0 for t in (qi, kvi, ks, vs)),
                 "K19 takes 16-byte aligned q, K|V rows and row scales (TMA, "
                 "bulk copies)")
    out = torch.empty((B, H, Lp, D), dtype=torch.bfloat16, device=dev)
    rc = _build.load().tdx_sparse_attention_i8_planes(
        qi.data_ptr(), qs.data_ptr(), kvi.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), lut.data_ptr(), out.data_ptr(), B, H, Lp, Lkp, kv_len,
        nQ, lut.shape[-1], block_q, block_k, float(scale),
        _build.stream_ptr(qi))
    _build.check(rc, "tdx_sparse_attention_i8_planes")
    _sparse_i8_planes_cuda.launches += 1
    return out


_sparse_i8_planes_cuda.launches = 0


def sparse_attention_i8_planes_bs_plain(qi, qs, kvi, k_block_scale,
                                        v_channel_scale, lut, *,
                                        scale: Optional[float] = None,
                                        block_q: int = 256, block_k: int = 256,
                                        kv_len: Optional[int] = None):
    """Plain version of K28: K7's plain version (its scoring is K28's) on
    the K and V halves of K27's packed rows. qi (B, H, Lp, D) int8; qs
    (B, H, Lp) fp32; kvi (B, H, Lkp, 2D) int8; k_block_scale (B, H, nK);
    v_channel_scale (B, H, 1, D); lut (B, H, nQr, sel) int."""
    B, H, Lp, D = qi.shape
    Lkp = kvi.shape[2]
    vtp = kvi[..., D:].reshape(B, H, Lkp // block_k, block_k, D).transpose(-1, -2)
    return sparse_attention_i8_vt_plain(
        qi, qs, kvi[..., :D], vtp, k_block_scale, v_channel_scale, lut,
        scale=scale, block_q=block_q, block_k=block_k, kv_len=kv_len)


def sparse_i8_planes_bs_form(Lp: int, Lkp: int, kv_len: int, block_q: int,
                             block_k: int) -> str:
    """The kernel a K28 launch takes (csrc/sparse_i8_attention.cu
    `planes_form`): "wgmma", K7's warp-specialised kernel on the packed K|V
    rows (`k7::sparse_i8_vt_kernel<1>`), for blocks that are multiples
    of 128 (fused sagesla's always are); "mma", the mma.sync loop
    (`sparse_i8_planes_kernel<true>`), for the other multiples of 64.
    Raises where neither computes: other blocks, blocks that do not divide
    the padded lengths Lp / Lkp, kv_len outside (0, Lkp]."""
    return _planes_form("K28", Lp, Lkp, kv_len, block_q, block_k)


def _sparse_i8_planes_bs_cuda(qi, qs, kvi, k_block_scale, v_channel_scale,
                              lut, scale: float, block_q: int, block_k: int,
                              kv_len: int):
    """Launch K28 in its form (`sparse_i8_planes_bs_form`)."""
    B, H, Lp, D = qi.shape
    Lkp = kvi.shape[2]
    dev = qi.device
    _require(D == 128, f"K28 takes head dim 128, got {D}")
    _require(qi.dtype == kvi.dtype == torch.int8, "K28 takes int8 q and K|V")
    _require(tuple(kvi.shape) == (B, H, Lkp, 2 * D),
             "K28 takes packed K|V rows (B, H, Lk, 2D)")
    sparse_i8_planes_bs_form(Lp, Lkp, kv_len, block_q, block_k)
    _require(all(t.is_contiguous() and t.device == dev for t in (qi, kvi)),
             "K28 takes contiguous tensors on one CUDA device")
    _require(qi.data_ptr() % 16 == 0 and kvi.data_ptr() % 16 == 0,
             "K28 takes 16-byte aligned q and K|V rows (TMA)")
    nQ, nK = Lp // block_q, Lkp // block_k
    qs = qs.float().reshape(B, H, Lp).contiguous()
    ks = k_block_scale.float().reshape(B, H, nK).contiguous()
    vch = v_channel_scale.float().reshape(B, H, D).contiguous()
    lut = _pad_lut(lut.to(device=dev, dtype=torch.int32), nQ).contiguous()
    _require(lut.shape[:2] == (B, H), "K28 lut must be (B, H, nQ, sel)")
    for t in (qs, ks, vch):
        _require(t.device == dev, "K28 operands must lie on q's device")
    out = torch.empty((B, H, Lp, D), dtype=torch.bfloat16, device=dev)
    rc = _build.load().tdx_sparse_attention_i8_planes_bs(
        qi.data_ptr(), qs.data_ptr(), kvi.data_ptr(), ks.data_ptr(),
        vch.data_ptr(), lut.data_ptr(), out.data_ptr(), B, H, Lp, Lkp, kv_len,
        nQ, lut.shape[-1], block_q, block_k, float(scale * LOG2E),
        _build.stream_ptr(qi))
    _build.check(rc, "tdx_sparse_attention_i8_planes_bs")
    _sparse_i8_planes_bs_cuda.launches += 1
    return out


_sparse_i8_planes_bs_cuda.launches = 0


def sparse_attention_i8_planes(qi, qs, kvi, ks, vs, lut, *,
                               scale: Optional[float] = None,
                               block_q: int = 256, block_k: int = 256,
                               kv_len: Optional[int] = None,
                               k_block_scale=None, v_channel_scale=None):
    """Block-sparse SageSLA attention over int8 planes and packed K|V rows
    (flash_pallas.sparse_attention_i8_planes with `kvi_packed`): per-row
    scales ks, vs (K19), or, with k_block_scale (B, H, nK) and
    v_channel_scale (B, H, 1, D), the block-scale form (K28; ks and vs are
    then unused, as JAX ignores them). The plain version on a CPU tensor,
    the kernel on a CUDA tensor. See the plain versions for the operands."""
    scale = float(qi.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = kvi.shape[2] if kv_len is None else kv_len
    blockscale = k_block_scale is not None
    _require(blockscale == (v_channel_scale is not None),
             "k_block_scale and v_channel_scale go together")
    cpu = qi.device.type == "cpu"
    _require(cpu or qi.device.type == "cuda", f"no kernel for device {qi.device}")
    kw = dict(block_q=block_q, block_k=block_k, kv_len=kv_len)
    if blockscale:
        args = (qi, qs, kvi, k_block_scale, v_channel_scale, lut)
        if cpu:
            return sparse_attention_i8_planes_bs_plain(*args, scale=scale, **kw)
        return _sparse_i8_planes_bs_cuda(*args, scale, **kw)
    if cpu:
        return sparse_attention_i8_planes_plain(qi, qs, kvi, ks, vs, lut,
                                                scale=scale, **kw)
    return _sparse_i8_planes_cuda(qi, qs, kvi, ks, vs, lut, scale, **kw)
