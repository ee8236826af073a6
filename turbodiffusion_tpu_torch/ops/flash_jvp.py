"""Forward-mode (JVP) flash attention: kernels K25 (dense) and K26
(block-sparse), for the sCM tangent of rCM distillation.

The counterpart of `turbodiffusion_tpu/ops/flash_jvp_pallas.py`:
  * K25 `_flash_jvp_cuda` replaces `_flash_jvp_dense_pallas` (launch :170,
    body `_jvp_kernel` :85-142);
  * K26 `_sparse_flash_jvp_cuda` replaces `_flash_jvp_sparse_pallas`
    (launch :367, body `_sparse_jvp_kernel` :198-317). The TPU packs
    K|V|dK|dV into one stream for one DMA a block and pads LUT entries to a
    gather group (`_pick_group_jvp`); the kernel reads the four tensors
    through their strides and loops over exactly `sel` entries.

Semantics (kernels and plain versions), with S = scale q k^T and
dS = scale (dq k^T + q dk^T), columns >= kv_len at S = -1e30 and dS = 0,
P = exp(S - rowmax S), l = rowsum P, mu = rowsum P dS:
    o = (bf16(P) v) / l,   do = (bf16(P dS) v + bf16(P) dv) / l - (mu / l) o
products accumulated in fp32, l clamped at 1e-20, outputs in q's dtype.
This is `_jvp_kernel`'s order (P and P dS rounded before their dots);
`flash_jvp_ref` (:56-82), which takes P (dS - mu) in fp32, is the looser
yardstick. Layout (B, L, H, D) in and out; lut (B, H, nQ, sel).

The plain versions scale to the training shape: the dense one chunks over
query rows, the sparse one gathers each Q-block's selected K / V / dK / dV
blocks (`_sparse_jvp_gather`, :400-453) — neither builds (B, H, L, L).

Forward mode: the port takes `torch.autograd.forward_ad` (dual tensors),
not `torch.func.jvp`. `flash_attention_jvp` and `sparse_attention_jvp` are
JAX's custom_jvp wrappers (:456-541): on inputs that carry no tangent they
are K4 / K3 (`flash_attention`, `sparse_flash_attention`, differentiable in
reverse); when q, k or v carries one they apply `_FlashJvpFn` /
`_SparseJvpFn`, autograd Functions whose forward only allocates the output
and whose `jvp` rule launches ONE K25 / K26, which writes o into that
output and returns do. JAX's rule likewise returns (o, do) from one kernel
and never calls its primal function: the tangent pass launches no K4 / K3.
(A Function's forward cannot see the tangents, so the rule writes o.) The
LUT is an integer input without a tangent. Reverse mode through the
Functions is not defined: the tangent pass runs under `torch.no_grad()`.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises (head dim 128 only). Each launcher counts its launches in
`.launches` and the form of its last launch in `.last_form`. The kernel
takes one of two forms (`jvp_form`): the warp-specialised wgmma + TMA
kernel for K25 and for K26 at block_q a multiple of 128 (every path's
512/256), the mma.sync loop for K26 at block_q an odd multiple of 64.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import (
    NEG_INF, _PLAIN_LOGITS_BUDGET, _cdiv, _check_qkv, _require, _strides,
    flash_attention, sparse_flash_attention)


def _jvp_epilogue(s, ds, v, dv):
    """s, ds: (..., M) fp32 masked logits and their tangents; v, dv:
    (..., M, D). (o, do) in fp32, the kernels' epilogue."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    pds = p * ds
    mu = pds.sum(-1, keepdim=True)
    pb = p.to(v.dtype).float()
    acc_o = torch.matmul(pb, v.float())
    acc_t = (torch.matmul(pds.to(v.dtype).float(), v.float())
             + torch.matmul(pb, dv.float()))
    o = acc_o / l
    return o, acc_t / l - (mu / l) * o


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_jvp_plain(q, k, v, dq, dk, dv,
                              scale: Optional[float] = None,
                              kv_len: Optional[int] = None):
    """Plain version of K25: (o, do) of dense attention under the tangents
    (dq, dk, dv), chunked over query rows. q, dq: (B, Lq, H, D); k, v, dk,
    dv: (B, Lk, H, D); keys >= kv_len are masked."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5 if scale is None else scale
    kh, dkh = (t.permute(0, 2, 3, 1).float() for t in (k, dk))  # (B, H, D, Lk)
    vh, dvh = (t.permute(0, 2, 1, 3) for t in (v, dv))          # (B, H, Lk, D)
    valid = torch.arange(Lk, device=q.device) < kv_len
    rows = max(1, _PLAIN_LOGITS_BUDGET // (B * H * Lk))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    do = torch.empty_like(o)
    for r0 in range(0, Lq, rows):
        qh, dqh = (t[:, r0:r0 + rows].permute(0, 2, 1, 3).float()
                   for t in (q, dq))
        s = torch.where(valid, torch.matmul(qh, kh) * scale, NEG_INF)
        ds = torch.where(valid, (torch.matmul(dqh, kh)
                                 + torch.matmul(qh, dkh)) * scale, 0.0)
        oc, dc = _jvp_epilogue(s, ds, vh, dvh)
        o[:, r0:r0 + rows] = oc.permute(0, 2, 1, 3)
        do[:, r0:r0 + rows] = dc.permute(0, 2, 1, 3)
    return o, do


def sparse_flash_attention_jvp_plain(q, k, v, dq, dk, dv, lut, block_q: int,
                                     block_k: int,
                                     scale: Optional[float] = None,
                                     kv_len: Optional[int] = None):
    """Plain version of K26: each Q-block gathers the K / V / dK / dV blocks
    its LUT row names. lut (B, H, nQ, sel) int K-block ids; keys >= kv_len
    are masked."""
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

    qb, dqb = blocks(q, nQ, block_q), blocks(dq, nQ, block_q)
    kb, vb, dkb, dvb = (blocks(t, nK, block_k) for t in (k, v, dk, dv))
    lut = lut.long()
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, :, None, None]
    cols = lut[..., None] * block_k + torch.arange(block_k, device=q.device)
    step = max(1, _PLAIN_LOGITS_BUDGET // (B * H * block_q * sel * block_k))
    o = torch.empty((B, H, nQ, block_q, D), dtype=q.dtype, device=q.device)
    do = torch.empty_like(o)
    for i0 in range(0, nQ, step):
        sl = slice(i0, i0 + step)
        ids = lut[:, :, sl]
        n = ids.shape[2]
        kg, vg, dkg, dvg = (t[bi, hi, ids].reshape(B, H, n, sel * block_k, D)
                            for t in (kb, vb, dkb, dvb))
        qs, dqs = qb[:, :, sl].float(), dqb[:, :, sl].float()
        kgt = kg.float().transpose(-1, -2)
        valid = (cols[:, :, sl] < kv_len).reshape(B, H, n, 1, sel * block_k)
        s = torch.where(valid, torch.matmul(qs, kgt) * scale, NEG_INF)
        ds = torch.where(valid, (torch.matmul(dqs, kgt) + torch.matmul(
            qs, dkg.float().transpose(-1, -2))) * scale, 0.0)
        oc, dc = _jvp_epilogue(s, ds, vg, dvg)
        o[:, :, sl], do[:, :, sl] = oc, dc

    def unblock(x):
        x = x.reshape(B, H, nQ * block_q, D)[:, :, :L]
        return x.permute(0, 2, 1, 3).contiguous()
    return unblock(o), unblock(do)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def jvp_form(block_q: int, block_k: int, kv_len: int, *strides: int) -> str:
    """The kernel a K25 / K26 launch takes (csrc/flash_jvp.cu `jvp_form`):
    "wgmma", the warp-specialised kernel (`k25::jvp_fwd_kernel`), for the
    dense launch (block_q = block_k = 0) and for blocks with block_q a
    multiple of 128 and block_k of 64 (a 128-row tile lies in one Q block, a
    K block is whole 64-key chunks); "mma", the mma.sync loop
    (`sparse_jvp_mma_kernel`), for block_q an odd multiple of 64. kv_len and
    the strides (elements; q, k, v, dq, dk, dv, o, do by batch, token, head)
    do not change the form; raises where neither form computes: no key, a
    stride off 16 bytes, other blocks."""
    _require(kv_len > 0, f"K25 / K26 take kv_len > 0, got {kv_len}")
    _require(all(s % 8 == 0 for s in strides),
             "K25 / K26 take strides of 16-byte multiples")
    if block_q == 0 and block_k == 0:
        return "wgmma"
    _require(block_q > 0 and block_k > 0 and block_q % 64 == 0
             and block_k % 64 == 0,
             f"K26 takes blocks that are multiples of 64, got {block_q}/{block_k}")
    return "wgmma" if block_q % 128 == 0 else "mma"


def _jvp_operands(q, k, v, dq, dk, dv, kv_len, out):
    """Check K25 / K26's operands; returns (o, do) to write."""
    _check_qkv(q, k, v, kv_len)
    _check_qkv(dq, dk, dv, kv_len)
    _require(dq.shape == q.shape and dk.shape == k.shape
             and dv.shape == v.shape and dq.device == q.device
             and dk.device == q.device,
             "the tangents must be shaped like q, k, v on their device")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device) if out is None \
        else out
    _require(o.shape == q.shape and o.dtype == q.dtype and o.device == q.device
             and o.is_contiguous(), "out must be a contiguous tensor like q")
    return o, torch.empty_like(o)


def _stride_array(st):
    """The (batch, token, head) strides as the C int64 array."""
    return (ctypes.c_int64 * len(st))(*st)


def _flash_jvp_cuda(q, k, v, dq, dk, dv, scale: float, kv_len: int,
                    out=None):
    """Launch K25: (o, do), (B, Lq, H, 128) bf16; o written into `out` when
    given."""
    B, L, H, _ = q.shape
    o, do = _jvp_operands(q, k, v, dq, dk, dv, kv_len, out)
    st = _strides(q, k, v, dq, dk, dv, o, do)
    form = jvp_form(0, 0, kv_len, *st)
    rc = _build.load().tdx_flash_attention_jvp(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), o.data_ptr(), do.data_ptr(), B, H, L,
        kv_len, _stride_array(st), float(scale), _build.stream_ptr(q))
    _build.check(rc, "tdx_flash_attention_jvp")
    _flash_jvp_cuda.launches += 1
    _flash_jvp_cuda.last_form = form
    return o, do


_flash_jvp_cuda.launches = 0
_flash_jvp_cuda.last_form = None


def _sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut, block_q: int,
                           block_k: int, scale: float, kv_len: int, out=None):
    """Launch K26 in its form (`jvp_form`): (o, do), (B, L, H, 128) bf16; o
    written into `out` when given."""
    B, L, H, _ = q.shape
    # the blocks are refused before the operands; o and do, contiguous, do
    # not change the form
    form = jvp_form(block_q, block_k, kv_len, *_strides(q, k, v, dq, dk, dv))
    nQ = _cdiv(L, block_q)
    _require(lut.dim() == 4 and tuple(lut.shape[:3]) == (B, H, nQ)
             and lut.device == q.device,
             f"lut must be (B, H, {nQ}, sel) on q's device")
    o, do = _jvp_operands(q, k, v, dq, dk, dv, kv_len, out)
    lut = lut.to(torch.int32).contiguous()
    rc = _build.load().tdx_sparse_flash_attention_jvp(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), o.data_ptr(), do.data_ptr(),
        lut.data_ptr(), B, H, L, kv_len, nQ, lut.shape[-1], block_q, block_k,
        _stride_array(_strides(q, k, v, dq, dk, dv, o, do)), float(scale),
        _build.stream_ptr(q))
    _build.check(rc, "tdx_sparse_flash_attention_jvp")
    _sparse_flash_jvp_cuda.launches += 1
    _sparse_flash_jvp_cuda.last_form = form
    return o, do


_sparse_flash_jvp_cuda.launches = 0
_sparse_flash_jvp_cuda.last_form = None


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _cpu_or_cuda(q) -> bool:
    """True for a CPU tensor; raises for a device without the kernels."""
    _require(q.device.type in ("cpu", "cuda"), f"no kernel for device {q.device}")
    return q.device.type == "cpu"


def _into(out, o):
    if out is None:
        return o
    out.copy_(o)
    return out


def dense_jvp_pair(q, k, v, dq, dk, dv, scale: float, kv_len: int, out=None):
    """(o, do) of dense attention: K25 on a CUDA tensor, its plain version on
    a CPU tensor; o written into `out` when given."""
    if _cpu_or_cuda(q):
        o, do = flash_attention_jvp_plain(q, k, v, dq, dk, dv, scale, kv_len)
        return _into(out, o), do
    return _flash_jvp_cuda(q, k, v, dq, dk, dv, scale, kv_len, out)


def sparse_jvp_pair(q, k, v, dq, dk, dv, lut, block_q: int, block_k: int,
                    scale: float, kv_len: int, out=None):
    """(o, do) of block-sparse attention: K26 on a CUDA tensor, its plain
    version on a CPU tensor; o written into `out` when given."""
    if _cpu_or_cuda(q):
        o, do = sparse_flash_attention_jvp_plain(q, k, v, dq, dk, dv, lut,
                                                 block_q, block_k, scale,
                                                 kv_len)
        return _into(out, o), do
    return _sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut, block_q, block_k,
                                  scale, kv_len, out)


def _has_tangent(*ts) -> bool:
    return any(fwAD.unpack_dual(t).tangent is not None for t in ts)


def _tangents(primals, tangents):
    """The tangents as the kernels read them: a missing one is zero, each in
    its primal's dtype with a unit last stride."""
    return [torch.zeros_like(p) if t is None else t.to(p.dtype).contiguous()
            for p, t in zip(primals, tangents)]


class _FlashJvpFn(torch.autograd.Function):
    """Dense attention under forward AD: the jvp rule is one K25."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_len: int):
        ctx.save_for_forward(q, k, v)
        ctx.args = (scale, kv_len)
        ctx.out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return ctx.out

    @staticmethod
    def jvp(ctx, dq, dk, dv, *_):
        primals = ctx.saved_tensors
        out, ctx.out = ctx.out, None
        return dense_jvp_pair(*primals, *_tangents(primals, (dq, dk, dv)),
                             *ctx.args, out=out)[1]


class _SparseJvpFn(torch.autograd.Function):
    """Block-sparse attention under forward AD: the jvp rule is one K26."""

    @staticmethod
    def forward(ctx, q, k, v, lut, block_q: int, block_k: int, scale: float,
                kv_len: int):
        ctx.save_for_forward(q, k, v, lut)
        ctx.args = (block_q, block_k, scale, kv_len)
        ctx.out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return ctx.out

    @staticmethod
    def jvp(ctx, dq, dk, dv, *_):
        q, k, v, lut = ctx.saved_tensors
        out, ctx.out = ctx.out, None
        return sparse_jvp_pair(
            q, k, v, *_tangents((q, k, v), (dq, dk, dv)), lut, *ctx.args,
            out=out)[1]


def flash_attention_jvp(q, k, v, scale: Optional[float] = None,
                        kv_len: Optional[int] = None):
    """Dense softmax attention, forward-mode differentiable
    (flash_jvp_pallas.flash_attention_jvp): K4 without a tangent, one K25
    under `torch.autograd.forward_ad` when q, k or v carries one."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    if not _has_tangent(q, k, v):
        return flash_attention(q, k, v, scale, kv_len)
    return _FlashJvpFn.apply(q, k, v, scale, kv_len)


def sparse_attention_jvp(q, k, v, lut, block_q: int, block_k: int,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None):
    """Block-sparse attention over `lut`, forward-mode differentiable
    (flash_jvp_pallas.sparse_attention_jvp): K3 without a tangent, one K26
    when q, k or v carries one (the tangent gathers only the selected
    blocks, so its memory is the forward's)."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    kv_len = k.shape[1] if kv_len is None else kv_len
    if not _has_tangent(q, k, v):
        return sparse_flash_attention(q, k, v, lut, block_q, block_k, scale,
                                      kv_len)
    return _SparseJvpFn.apply(q, k, v, lut, int(block_q), int(block_k),
                              scale, kv_len)
