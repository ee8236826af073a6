"""Backward of the bf16 block-sparse attention (K3): kernels K23 and K24.

The counterpart of `turbodiffusion_tpu/ops/flash_pallas.py:_flash_bwd_fused`
(:1749-1862), the backward of `flash_attention(..., lut=...)`'s custom VJP
(:1982-2011), in its two passes:
  * K23 `_sparse_bwd_dq_cuda` replaces the dq pass (launch :1796, body
    `_sparse_bwd_dq_kernel` :1488-1608): each Q-block walks its forward LUT
    row with an online max and three accumulators, so that
    dq = scale * (acc1 - delta * acc2) / l needs no saved forward output;
    it also emits each row's (lse, delta), (B*H, Lp, 2) fp32;
  * `inverse_lut` (`_inverse_lut` :1726-1746, jnp there, plain torch here):
    for each K-block, the Q-blocks that selected it, rows
    [count, q ids ascending, 0-pad] of width 1 + nQ;
  * K24 `_sparse_bwd_dkv_cuda` replaces the dk/dv pass (launch :1836, body
    `_sparse_bwd_dkv_kernel` :1611-1723): each K-block walks its inverse-LUT
    row with the exact P = exp(s - lse) and writes its rows once (no
    atomics: the gradients are the same bits from run to run; a K-block no
    Q-block selected gets dk = dv = 0).

Semantics (kernels and plain versions): s = q k^T * scale in fp32, columns
>= kv_len and query rows >= Lq take no part; P and P * dp (K23), P and
P * (dp - delta) * scale (K24) are rounded to q's dtype before their
products with k, q or dO, which accumulate in fp32, as the TPU kernel's
`.astype(k.dtype)` dots do; l is clamped at 1e-20. Outputs in q's dtype.
The TPU's LUT padding to a gather group and its (B*H) fold with head-dim
padding have no counterpart: the kernels loop over exactly `sel` / `count`
entries and read (B, L, H, 128) through strides.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises (head dim 128 only). Each launcher counts its launches in
`.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import (
    NEG_INF, _PLAIN_LOGITS_BUDGET, _cdiv, _check_qkv, _require, _strides)


def _blocks(x, n: int, blk: int):
    """(B, L, H, D) -> (B*H, n, blk, D), zero rows past L."""
    B, L, H, D = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * blk - L))
    return x.reshape(B, n, blk, H, D).permute(0, 3, 1, 2, 4).reshape(
        B * H, n, blk, D)


def _unblocks(x, B: int, H: int, L: int):
    """(B*H, n, blk, D) -> (B, L, H, D)."""
    D = x.shape[-1]
    return x.reshape(B, H, -1, D)[:, :, :L].permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sparse_bwd_dq_plain(q, k, v, do, lut, block_q: int, block_k: int,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None):
    """Plain version of K23. q, do: (B, L, H, D); k, v: (B, Lk, H, D); lut
    (B, H, nQ, sel). Returns (dq (B, L, H, D) in q's dtype, (lse, delta)
    (B*H, Lp, 2) fp32 with Lp = nQ * block_q)."""
    B, L, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    nQ, nK = _cdiv(L, block_q), _cdiv(Lk, block_k)
    sel = lut.shape[-1]
    _require(tuple(lut.shape) == (B, H, nQ, sel),
             f"lut must be (B, H, nQ={nQ}, sel), got {tuple(lut.shape)}")
    BH = B * H
    qb, dob = _blocks(q, nQ, block_q), _blocks(do, nQ, block_q)
    kb, vb = _blocks(k, nK, block_k), _blocks(v, nK, block_k)
    lut = lut.reshape(BH, nQ, sel).long()
    bi = torch.arange(BH, device=q.device)[:, None, None]
    cols = lut[..., None] * block_k + torch.arange(block_k, device=q.device)
    dt = q.dtype
    step = max(1, _PLAIN_LOGITS_BUDGET // (BH * block_q * sel * block_k))
    dq = torch.empty((BH, nQ, block_q, D), dtype=dt, device=q.device)
    ld = torch.empty((BH, nQ, block_q, 2), dtype=torch.float32,
                     device=q.device)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        ids = lut[:, sl]
        n = ids.shape[1]
        kg = kb[bi, ids].reshape(BH, n, sel * block_k, D).float()
        vg = vb[bi, ids].reshape(BH, n, sel * block_k, D).float()
        s = torch.matmul(qb[:, sl].float(), kg.transpose(-1, -2)) * scale
        valid = (cols[:, sl] < kv_len).reshape(BH, n, 1, sel * block_k)
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True).clamp_min(1e-20)
        dp = torch.matmul(dob[:, sl].float(), vg.transpose(-1, -2))
        pdp = p * dp
        delta = pdp.sum(-1, keepdim=True) / l
        acc1 = torch.matmul(pdp.to(dt).float(), kg)
        acc2 = torch.matmul(p.to(dt).float(), kg)
        dq[:, sl] = (scale * (acc1 - delta * acc2) / l).to(dt)
        ld[:, sl] = torch.cat([m + torch.log(l), delta], -1)
    return _unblocks(dq, B, H, L), ld.reshape(BH, nQ * block_q, 2)


def inverse_lut(lut, nK: int):
    """For each K-block, the Q-blocks whose LUT row names it
    (flash_pallas.py:1726-1746). lut (B, H, nQ, sel), entries unique per
    row -> (B*H, nK, 1 + nQ) int32 rows [count, q ids ascending, 0-pad]."""
    B, H, nQ, sel = lut.shape
    BH, N = B * H, nQ * sel
    fk = lut.reshape(BH, N).long()
    qid = (torch.arange(N, device=lut.device) // sel).expand(BH, N)
    sk, order = torch.sort(fk, dim=1, stable=True)
    sq = torch.gather(qid, 1, order)
    pos = torch.arange(N, device=lut.device) - torch.searchsorted(
        sk, sk, right=False)
    counts = torch.zeros((BH, nK), dtype=torch.long, device=lut.device)
    counts.scatter_add_(1, fk, torch.ones_like(fk))
    inv = torch.zeros((BH, nK, 1 + nQ), dtype=torch.long, device=lut.device)
    inv[:, :, 0] = counts
    bi = torch.arange(BH, device=lut.device)[:, None].expand(BH, N)
    inv[bi, sk, 1 + pos] = sq
    return inv.to(torch.int32)


def sparse_bwd_dkv_plain(q, k, v, do, ld, inv, block_q: int, block_k: int,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None):
    """Plain version of K24: each K-block gathers the Q-blocks of its
    inverse-LUT row. ld: K23's (B*H, Lp, 2); inv: `inverse_lut`'s
    (B*H, nK, 1 + nQ). Returns (dk, dv), (B, Lk, H, D) in k's dtype."""
    B, L, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    nQ, nK = _cdiv(L, block_q), _cdiv(Lk, block_k)
    BH = B * H
    _require(tuple(inv.shape) == (BH, nK, 1 + nQ),
             f"inverse lut must be ({BH}, {nK}, {1 + nQ}), got "
             f"{tuple(inv.shape)}")
    dt = q.dtype
    qb, dob = _blocks(q, nQ, block_q), _blocks(do, nQ, block_q)
    kb, vb = _blocks(k, nK, block_k), _blocks(v, nK, block_k)
    lse = ld[:, :nQ * block_q, 0].reshape(BH, nQ, block_q)
    dl = ld[:, :nQ * block_q, 1].reshape(BH, nQ, block_q)
    inv = inv.long()
    counts = inv[:, :, 0]
    cmax = max(1, int(counts.max()))
    ids = inv[:, :, 1:1 + cmax]                           # (BH, nK, cmax)
    live_entry = torch.arange(cmax, device=q.device) < counts[..., None]
    rows = ids[..., None] * block_q + torch.arange(block_q, device=q.device)
    live = (live_entry[..., None] & (rows < L)).reshape(BH, nK, 1, -1)
    key_live = (torch.arange(nK * block_k, device=q.device) < kv_len).reshape(
        1, nK, block_k, 1)
    bi = torch.arange(BH, device=q.device)[:, None, None]
    step = max(1, _PLAIN_LOGITS_BUDGET // (BH * block_k * cmax * block_q))
    dk = torch.empty((BH, nK, block_k, D), dtype=dt, device=q.device)
    dv = torch.empty_like(dk)
    for j0 in range(0, nK, step):
        sl = slice(j0, j0 + step)
        g = ids[:, sl]
        n = g.shape[1]
        qg = qb[bi, g].reshape(BH, n, cmax * block_q, D).float()
        dog = dob[bi, g].reshape(BH, n, cmax * block_q, D).float()
        lse_g = lse[bi, g].reshape(BH, n, 1, cmax * block_q)
        dl_g = dl[bi, g].reshape(BH, n, 1, cmax * block_q)
        valid = live[:, sl] & key_live[:, sl]
        st = torch.matmul(kb[:, sl].float(), qg.transpose(-1, -2)) * scale
        pt = torch.where(valid, torch.exp(st - lse_g), 0.0)
        dpt = torch.matmul(vb[:, sl].float(), dog.transpose(-1, -2))
        dst = pt * (dpt - dl_g) * scale
        dk[:, sl] = torch.matmul(dst.to(dt).float(), qg).to(dt)
        dv[:, sl] = torch.matmul(pt.to(dt).float(), dog).to(dt)
    return _unblocks(dk, B, H, Lk), _unblocks(dv, B, H, Lk)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check_bwd(q, k, v, do, block_q: int, block_k: int, kv_len: int):
    _check_qkv(q, k, v, kv_len)
    _check_qkv(do, k, v, kv_len)
    _require(do.shape == q.shape, "dO must be shaped like q")
    _require(block_q % 64 == 0 and block_k % 64 == 0,
             f"K23 / K24 take blocks that are multiples of 64, got "
             f"{block_q}/{block_k}")


def _sparse_bwd_dq_cuda(q, k, v, do, lut, block_q: int, block_k: int,
                        scale: float, kv_len: int):
    """Launch K23: (dq (B, L, H, 128) bf16, (lse, delta) (B*H, Lp, 2))."""
    B, L, H, D = q.shape
    _check_bwd(q, k, v, do, block_q, block_k, kv_len)
    nQ = _cdiv(L, block_q)
    _require(lut.dim() == 4 and tuple(lut.shape[:3]) == (B, H, nQ)
             and lut.device == q.device,
             f"lut must be (B, H, {nQ}, sel) on q's device")
    lut = lut.to(torch.int32).contiguous()
    dq = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    ld = torch.empty((B * H, nQ * block_q, 2), dtype=torch.float32,
                     device=q.device)
    rc = _build.load().tdx_sparse_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), ld.data_ptr(), lut.data_ptr(), B, H, L, kv_len, nQ,
        lut.shape[-1], block_q, block_k, *_strides(q, k, v, do, dq),
        float(scale), _build.stream_ptr(q))
    _build.check(rc, "tdx_sparse_attention_bwd_dq")
    _sparse_bwd_dq_cuda.launches += 1
    return dq, ld


_sparse_bwd_dq_cuda.launches = 0


def _sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, block_q: int, block_k: int,
                         scale: float, kv_len: int):
    """Launch K24: (dk, dv), (B, Lk, H, 128) bf16."""
    B, L, H, D = q.shape
    Lk = k.shape[1]
    _check_bwd(q, k, v, do, block_q, block_k, kv_len)
    nQ, nK = _cdiv(L, block_q), _cdiv(Lk, block_k)
    _require(tuple(ld.shape) == (B * H, nQ * block_q, 2)
             and ld.dtype == torch.float32 and ld.is_contiguous()
             and ld.device == q.device,
             f"K24 takes K23's (lse, delta), ({B * H}, {nQ * block_q}, 2) fp32")
    _require(tuple(inv.shape) == (B * H, nK, 1 + nQ) and inv.device == q.device,
             f"K24 takes the inverse lut ({B * H}, {nK}, {1 + nQ})")
    inv = inv.to(torch.int32).contiguous()
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    rc = _build.load().tdx_sparse_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        ld.data_ptr(), inv.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, L,
        Lk, kv_len, nQ, nK, block_q, block_k, *_strides(q, k, v, do, dk, dv),
        float(scale), _build.stream_ptr(q))
    _build.check(rc, "tdx_sparse_attention_bwd_dkv")
    _sparse_bwd_dkv_cuda.launches += 1
    return dk, dv


_sparse_bwd_dkv_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def sparse_flash_attention_bwd(q, k, v, do, lut, block_q: int, block_k: int,
                               scale: Optional[float] = None,
                               kv_len: Optional[int] = None):
    """(dq, dk, dv) of K3's block-sparse attention given dO
    (flash_pallas._flash_bwd_fused): the dq pass (K23), the inverse LUT,
    the dk/dv pass (K24). The plain versions on a CPU tensor, the kernels
    on a CUDA tensor. dO is made contiguous here and held through both
    launches."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    nK = _cdiv(k.shape[1], block_k)
    do = do.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        dq, ld = sparse_bwd_dq_plain(q, k, v, do, lut, block_q, block_k,
                                     scale, kv_len)
        dk, dv = sparse_bwd_dkv_plain(q, k, v, do, ld, inverse_lut(lut, nK),
                                      block_q, block_k, scale, kv_len)
        return dq, dk, dv
    _require(q.device.type == "cuda", f"no kernel for device {q.device}")
    dq, ld = _sparse_bwd_dq_cuda(q, k, v, do, lut, block_q, block_k, scale,
                                 kv_len)
    dk, dv = _sparse_bwd_dkv_cuda(q, k, v, do, ld, inverse_lut(lut, nK),
                                  block_q, block_k, scale, kv_len)
    return dq, dk, dv
