"""Flash attention forward: kernels K3 (block-sparse) and K4 (dense).

The counterpart of `turbodiffusion_tpu/ops/flash_pallas.py`. Its TPU
function `_flash_fwd_impl` (:1085-1269) runs three bf16 kernels that this
module replaces with hand-written CUDA (csrc/flash_attention.cu):
  * K3 `_sparse_flash_cuda` ← the bf16 sparse branch (launch :1254, body
    `_sparse_attn_kernel` :429-557): LUT-gather block-sparse flash;
  * K4 `_flash_cuda` ← the dense branches (`_attn_kernel_onepass`
    :128-144, launch :1121; `_attn_kernel` without int8 QK :64-121, launch
    :1139).

Semantics (both kernels and their plain versions): logits in fp32 times
`Dh^-0.5`; columns >= kv_len get -1e30 before the row max; softmax with
`p.astype(bf16) @ v` accumulated in fp32 and divided by the fp32 row sum;
output in q's dtype. Layout (B, L, H, Dh) in and out, read through strides.

The plain versions scale to the main path: the dense one chunks over query
rows, the sparse one gathers each Q-block's selected K/V blocks — neither
builds the (B, H, L, L) logits.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each launcher counts its launches in `.launches`. The int8
forms (sagesla) and the backward kernels wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from turbodiffusion_tpu_torch.ops import _build

NEG_INF = -1e30
# elements of fp32 logits a plain version materialises at once (1 GiB)
_PLAIN_LOGITS_BUDGET = 1 << 28


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

def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          kv_len: Optional[int] = None):
    """Plain version of K4: dense attention, chunked over query rows.
    q: (B, Lq, H, D); k, v: (B, Lk, H, D); keys >= kv_len are masked."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    kh = k.permute(0, 2, 3, 1).float()              # (B, H, D, Lk)
    vh = v.permute(0, 2, 1, 3)                      # (B, H, Lk, D)
    valid = torch.arange(Lk, device=q.device) < kv_len
    rows = max(1, _PLAIN_LOGITS_BUDGET // (B * H * Lk))
    out = torch.empty_like(q)
    for r0 in range(0, Lq, rows):
        qh = q[:, r0:r0 + rows].permute(0, 2, 1, 3).float()
        s = torch.matmul(qh, kh) * scale            # (B, H, r, Lk)
        s = torch.where(valid, s, NEG_INF)
        out[:, r0:r0 + rows] = _softmax_pv(s, vh).permute(0, 2, 1, 3).to(q.dtype)
    return out


def sparse_flash_attention_plain(q, k, v, lut, block_q: int, block_k: int,
                                 scale: Optional[float] = None,
                                 kv_len: Optional[int] = None):
    """Plain version of K3: each Q-block attends to the K-blocks its LUT row
    names, by gathering them. q: (B, L, H, D); k, v: (B, Lk, H, D);
    lut: (B, H, nQ, sel) int K-block ids; keys >= kv_len are masked."""
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
    lut = lut.long()
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, :, None, None]
    cols = lut[..., None] * block_k + torch.arange(block_k, device=q.device)
    step = max(1, _PLAIN_LOGITS_BUDGET // (B * H * block_q * sel * block_k))
    out = torch.empty((B, H, nQ, block_q, D), dtype=q.dtype, device=q.device)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        n = lut[:, :, sl].shape[2]
        kg = kb[bi, hi, lut[:, :, sl]].reshape(B, H, n, sel * block_k, D)
        vg = vb[bi, hi, lut[:, :, sl]].reshape(B, H, n, sel * block_k, D)
        s = torch.matmul(qb[:, :, sl].float(), kg.float().transpose(-1, -2))
        valid = (cols[:, :, sl] < kv_len).reshape(B, H, n, 1, sel * block_k)
        s = torch.where(valid, s * scale, NEG_INF)
        out[:, :, sl] = _softmax_pv(s, vg).to(q.dtype)
    out = out.reshape(B, H, nQ * block_q, D)[:, :, :L]
    return out.permute(0, 2, 1, 3).contiguous()


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


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale: Optional[float] = None,
                    kv_len: Optional[int] = None):
    """Dense softmax attention (K4) over (B, L, H, D) tensors."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, kv_len)
    _require(q.device.type == "cuda", f"no kernel for device {q.device}")
    return _flash_cuda(q, k, v, scale, kv_len)


def sparse_flash_attention(q, k, v, lut, block_q: int, block_k: int,
                           scale: Optional[float] = None,
                           kv_len: Optional[int] = None):
    """Block-sparse attention (K3): Q-block i attends to the K-blocks
    lut[b, h, i, :] (flash_pallas.flash_attention with a `lut`)."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q.device.type == "cpu":
        return sparse_flash_attention_plain(q, k, v, lut, block_q, block_k,
                                            scale, kv_len)
    _require(q.device.type == "cuda", f"no kernel for device {q.device}")
    return _sparse_flash_cuda(q, k, v, lut, block_q, block_k, scale, kv_len)
